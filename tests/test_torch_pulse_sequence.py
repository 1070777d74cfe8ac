"""The PyTorch port's object API (filter_functions_tpu_torch.pulse_sequence
and the numeric functions it calls) against the JAX package's, on random
pulses from tests/testutil.rand_pulse_arrays with seeded generators:
d in {2, 3, 4}, 3-10 segments, 50-200 frequencies.

The semantics are the ones tests/test_core.py pins for the JAX package:
construction and its errors, equality, slicing, copies, the cache
aliases, invalidation when omega changes, the cleanup tiers and explicit
cache seeding.  The numbers run the native complex128 route on both
sides (the CPU default of both packages); they differ only by the order
of the sums.
"""
import copy

import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu_torch import convert, functional, numeric
from testutil import make_pulse, rand_pulse_arrays, sigma
from torch_testutil import fft_cpu

#: (d, n_dt, n_omega) of the random pulses held against JAX.
SIZES = [(2, 5, 50), (3, 7, 120), (4, 10, 200)]


def _np(x):
    """numpy of a port tensor or a JAX value."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _pair(d, n_dt, seed, **kw):
    """The same random pulse in (JAX, port)."""
    arrays = rand_pulse_arrays(d, n_dt, local_rng=np.random.default_rng(seed),
                               **kw)
    return make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


def _close(got, want, rel=1e-12):
    """|got - want| <= rel * max|want| elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _omega(n):
    return np.geomspace(0.1, 50, n)


# -----------------------------------------------------------------------------
# construction
# -----------------------------------------------------------------------------
def test_identifiers_sorted_and_named_like_jax():
    """Sorting by identifier, automatic names and their interleaving with
    given ones match the JAX package; the device is explicit."""
    X, Y, Z = sigma[1:]
    for H_c, H_n in (([[X, [1.0], 'b'], [Z, [2.0], 'a']],
                      [[Z, [1.0], 'z'], [X, [1.0], 'y']]),
                     ([[X, [1], 'X'], [Y, [1]]], [[X, [1]], [Y, [1], 'Y']])):
        want = ff.PulseSequence(H_c, H_n, [1.0])
        got = fft.PulseSequence(H_c, H_n, [1.0], device='cpu')
        for name in ('c_opers', 'c_oper_identifiers', 'c_coeffs',
                     'n_opers', 'n_oper_identifiers', 'n_coeffs', 'dt'):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.device == torch.device('cpu')
    tensor_ops = fft.PulseSequence([[torch.tensor(X), torch.tensor([1.0])]],
                                   [[Z, [1.0]]], torch.tensor([1.0]),
                                   device='cpu')
    np.testing.assert_array_equal(tensor_ops.c_opers[0], X)


def _bad_constructor_args():
    """The failure matrix of the reference constructor
    (tests/test_core.py::test_constructor_validation_matrix)."""
    arrays = rand_pulse_arrays(2, 5, local_rng=np.random.default_rng(1))
    c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt = arrays
    H_c = [list(x) for x in zip(c_opers, c_coeffs, c_ids)]
    H_n = [list(x) for x in zip(n_opers, n_coeffs, n_ids)]

    def hc(i, j, value):
        h = copy.deepcopy(H_c)
        h[i][j] = value
        return h

    negative, imaginary = dt.copy(), dt.astype(complex)
    negative[2] *= -1
    imaginary[2] += 1j
    mapping = copy.deepcopy(H_c)
    mapping[1] = dict(enumerate(mapping[1]))
    wide = [[np.kron(h[0], np.eye(2)), h[1], h[2]] for h in H_n]
    return {
        'missing dt': (H_c, H_n),
        'scalar dt': (H_c, H_n, dt[0]),
        'negative dt': (H_c, H_n, negative),
        'imaginary dt': (H_c, H_n, imaginary),
        'raw basis': (H_c, H_n, dt, np.asarray(ff.Basis.pauli(1))),
        'wrong basis': (H_c, H_n, dt, 'basis'),
        'basis dimension': (H_c, H_n, dt, 'ggm3'),
        'H_c scalar': (15, H_n, dt),
        'H_n scalar': (H_c, 15, dt),
        'element mapping': (mapping, H_n, dt),
        'element scalar': ([H_c[0], 15], H_n, dt),
        'element short': ([[c_opers[0]]], H_n, dt),
        'oper type': (hc(0, 0, {'no': 'oper'}), H_n, dt),
        'coeff scalar': (hc(1, 1, 1.0), H_n, dt),
        'oper 3d': (hc(1, 0, np.tile(c_opers[1], (3, 1, 1))), H_n, dt),
        'oper not square': (hc(1, 0, c_opers[1].reshape(1, 4)), H_n, dt),
        'dimensions differ': (H_c, wide, dt),
        'duplicate ids': (hc(1, 2, c_ids[0]), H_n, dt),
        'coeff length': (hc(1, 1, c_coeffs[1][:-2]), H_n, dt),
    }


@pytest.mark.parametrize('case', sorted(_bad_constructor_args()))
def test_constructor_raises_like_jax(case):
    """Each bad input raises the JAX package's exception type."""
    args = list(_bad_constructor_args()[case])
    jargs, targs = list(args), list(args)
    if len(args) > 3 and isinstance(args[3], str) and args[3] == 'ggm3':
        jargs[3], targs[3] = ff.Basis.ggm(3), fft.Basis.ggm(3)
    with pytest.raises(Exception) as want:
        ff.PulseSequence(*jargs)
    with pytest.raises(want.type):
        fft.PulseSequence(*targs)


@pytest.mark.parametrize('field', ['c_opers', 'c_coeffs', 'n_opers',
                                   'n_coeffs', 'dt', 'basis'])
def test_from_arrays_validation(field):
    """from_arrays refuses arrays of disagreeing lengths or dimensions,
    as the JAX package does, and takes the arrays unsorted."""
    arrays = dict(zip(convert.PULSE_FIELDS, rand_pulse_arrays(
        2, 3, local_rng=np.random.default_rng(2))))
    good = fft.PulseSequence.from_arrays(**arrays, device='cpu')
    np.testing.assert_array_equal(good.c_oper_identifiers,
                                  arrays['c_oper_identifiers'])
    bad = dict(arrays)
    if field == 'basis':
        bad['basis'] = fft.Basis.ggm(3)
    elif field in ('c_opers', 'n_opers'):
        bad[field] = np.kron(arrays[field], np.eye(2))[:, :3, :3] \
            if field == 'n_opers' else arrays[field][:1]
    elif field == 'dt':
        bad['dt'] = arrays['dt'][:2]
    else:
        bad[field] = arrays[field][:, :2]
    with pytest.raises(ValueError):
        fft.PulseSequence.from_arrays(**bad, device='cpu')


def test_attributes_and_unsupported_operations():
    """len, d, t, tau, duration and the string forms; numpy keeps a
    pulse whole; the second-order filter function and the filter-function
    derivative match JAX's within 1e-12 of their largest entry; p @ p
    is the concatenation (equal to JAX's, filter function within 1e-12
    of its largest entry), @ with another type and @= raise as JAX's."""
    jp, p = _pair(2, 5, 3)
    assert len(p) == 5 and p.d == 2
    np.testing.assert_array_equal(p.t, jp.t)
    assert p.tau == jp.tau == p.duration
    assert 'dimension 2' in str(p) and repr(p)
    arr = np.asarray([p, p])
    assert arr.shape == (2,) and arr.dtype == object
    pp, jpp = p @ p, jp @ jp
    assert len(pp) == 10 and pp == fft.concatenate((p, p))
    for name in convert.PULSE_FIELDS:
        np.testing.assert_array_equal(getattr(pp, name), getattr(jpp, name))
    _close(pp.get_filter_function(_omega(5)),
           jpp.get_filter_function(_omega(5)))
    with pytest.raises(TypeError, match='Incompatible type'):
        p @ 3
    with pytest.raises(NotImplementedError):
        p @= p
    _close(p.get_filter_function(_omega(5), order=2),
           jp.get_filter_function(_omega(5), order=2))
    _close(p.get_filter_function_derivative(_omega(5)),
           jp.get_filter_function_derivative(_omega(5)))
    with pytest.raises(ValueError, match='Invalid value for order'):
        p.get_filter_function(_omega(5), order=3)


# -----------------------------------------------------------------------------
# equality, slicing, copies
# -----------------------------------------------------------------------------
def test_equality_matrix():
    """Pulses differing in any single ingredient compare unequal, a
    physically identical one equal, and consecutive equal segments join
    (tests/test_core.py::test_equality_matrix, ::test_equality_segment_
    joining)."""
    X, Y, Z = sigma[1:]
    rng = np.random.default_rng(4)
    cc, nc = rng.standard_normal(4), rng.random(4)
    dt = np.abs(rng.standard_normal(4)) + 0.1
    pulse = fft_cpu.PulseSequence
    a = pulse([[X, cc, 'X']], [[Z, nc, 'Z']], dt)
    assert not (a == 1) and a != 1
    variants = [
        pulse([[X, np.r_[cc, 1.0], 'X']], [[Z, np.r_[nc, 1.0], 'Z']],
              np.r_[dt, 1.0]),
        pulse([[X, cc, 'X']], [[Z, nc, 'Z']], dt * 2),
        pulse([[Y, cc, 'X']], [[Z, nc, 'Z']], dt),
        pulse([[X, cc + 1, 'X']], [[Z, nc, 'Z']], dt),
        pulse([[X, cc, 'X']], [[Y, nc, 'Z']], dt),
        pulse([[X, cc, 'X']], [[Z, nc + 1, 'Z']], dt),
        pulse([[X, cc, 'foo']], [[Z, nc, 'Z']], dt),
        pulse([[X, cc, 'X']], [[Z, nc, 'foo']], dt),
        pulse([[X, cc, 'X']], [[Z, nc, 'Z']], dt,
              fft.Basis(rand_pulse_arrays(2, 1)[0])),
    ]
    for b in variants:
        assert not (a == b) and a != b
    assert a == pulse([[X, cc.copy(), 'X']], [[Z, nc.copy(), 'Z']],
                      dt.copy())
    joined = pulse([[X, [1.0, 1.0], 'X']], [[Z, [1.0, 1.0], 'Z']],
                   [0.5, 0.5])
    assert joined == pulse([[X, [1.0], 'X']], [[Z, [1.0], 'Z']], [1.0])
    assert joined != 'a string'


def test_slicing_copy_and_prefix_reuse():
    """Slices equal the JAX package's slices; a prefix slice of a pulse
    with cached intermediates starts with the cumulative control matrix
    cached, equal to a fresh computation, and to JAX's slice, within
    1e-12 max|B| (measured 5.9e-16 and 1.2e-15); an empty slice raises
    IndexError; copies have their own caches."""
    jp, p = _pair(3, 6, 5)
    omega = _omega(60)
    for key in (slice(1, 4), slice(None, None, 2), 3, slice(-2, None)):
        want = convert.pulse_sequence_from_numpy(jp[key], device='cpu')
        assert p[key] == want
        assert p[key].device == p.device
    with pytest.raises(IndexError):
        p[4:4]
    p.get_control_matrix(omega, cache_intermediates=True)
    prefix = p[:4]
    assert prefix.is_cached('control matrix')
    fresh = copy.copy(prefix)
    fresh.cleanup('all')
    _close(prefix.get_control_matrix(omega), fresh.get_control_matrix(omega))
    _close(fresh.get_control_matrix(omega),
           jp[:4].get_control_matrix(omega))
    q = copy.copy(p)
    q.cleanup('all')
    assert p.is_cached('control matrix') and not q.is_cached('control matrix')
    assert q.is_cached('c_opers') is False and q.c_opers is p.c_opers


# -----------------------------------------------------------------------------
# caches
# -----------------------------------------------------------------------------
_DATA = {'eigenvalues': 'eigvals', 'eigenvectors': 'eigvecs',
         'propagators': 'propagators',
         'total propagator': 'total_propagator',
         'total propagator liouville': 'total_propagator_liouville'}
_FREQ = {'frequencies': 'omega', 'total phases': 'total_phases',
         'filter function': 'filter_function',
         'fidelity filter function': 'filter_function',
         'generalized filter function': 'filter_function_gen',
         'pulse correlation filter function': 'filter_function_pc',
         'fidelity pulse correlation filter function': 'filter_function_pc',
         'generalized pulse correlation filter function':
             'filter_function_pc_gen',
         'second order filter function': 'filter_function_2',
         'control matrix': 'control_matrix',
         'pulse correlation control matrix': 'control_matrix_pc'}


def test_alias_matrix():
    """Every human-readable alias, with spaces or underscores, maps onto
    its cache slot (tests/test_core.py::TestIsCachedAliasMatrix); raw
    intermediate keys are queryable."""
    _, p = _pair(2, 3, 6)
    for table, store in ((_DATA, p._data), (_FREQ, p._frequency_data)):
        for alias, key in table.items():
            assert not p.is_cached(alias)
            store[key] = torch.zeros(1)
            assert p.is_cached(alias)
            assert p.is_cached(alias.replace(' ', '_'))
            del store[key]
            assert not p.is_cached(alias)
    p._intermediates['n_opers_transformed'] = torch.zeros(1)
    assert p.is_cached('n_opers_transformed')
    assert dict(p.intermediates) == dict(p._intermediates)


def test_lazy_diagonalization_and_aliases_after_caching():
    """Diagonalization is lazy; caching the filter function caches every
    by-product the JAX package caches with it."""
    _, p = _pair(2, 3, 7)
    assert not p.is_cached('eigvals')
    p.eigvals
    assert all(p.is_cached(a) for a in ('eigvecs', 'propagators',
                                        'total propagator'))
    p.cache_filter_function(_omega(7))
    for alias in ('filter function', 'fidelity filter function',
                  'control matrix', 'total phases', 'frequencies',
                  'total propagator', 'total propagator liouville'):
        assert p.is_cached(alias), alias
    assert set(p.data) >= {'eigvals', 'total_propagator_liouville'}
    assert set(p.frequency_data) >= {'omega', 'filter_function'}


def test_omega_change_invalidates():
    """A new grid clears the frequency-dependent caches and keeps the
    time-domain ones; the same grid, as numpy or as a tensor, keeps
    them; the grid is kept as a copy."""
    _, p = _pair(2, 3, 8)
    omega = np.linspace(1, 5, 7)
    p.cache_filter_function(omega)
    p.omega = torch.tensor(omega)
    assert p.is_cached('filter function')
    omega[0] = 0.5
    assert p.omega[0].item() == 1.0
    p.omega = omega
    assert not p.is_cached('filter function') and p.is_cached('eigvals')
    assert p.omega.dtype == torch.float64 and p.omega.device == p.device


def test_cleanup_tiers():
    """conservative, greedy, frequency dependent and all evict what the
    JAX package's tiers evict (tests/test_core.py::test_cleanup_tiers)."""
    _, p = _pair(2, 3, 9)
    omega = np.linspace(1, 5, 7)
    p.get_filter_function(omega, cache_intermediates=True)
    assert p.nbytes > 0
    p.cleanup()
    assert not p.is_cached('eigvals') and p.is_cached('filter function')
    p.diagonalize()
    p.cleanup('greedy')
    assert not p.is_cached('control matrix')
    assert not p.is_cached('total propagator')
    assert p.is_cached('filter function') and not p.intermediates
    p.cleanup('frequency dependent')
    assert not p.is_cached('filter function') and not p.is_cached('omega')
    p.get_control_matrix(omega)
    p.cleanup('all')
    assert p.nbytes == 0 and not p.data
    with pytest.raises(ValueError):
        p.cleanup('foo')


def test_explicit_cache_seeding():
    """A seeded generalized filter function yields the fidelity one by
    trace; a seeded control matrix brings the total phases and the
    Liouville total propagator along and gives the same filter function
    (tests/test_core.py::TestExplicitCacheSeeding): within 1e-14 max|F|
    (measured 0), the phases within 1e-15 of e^{i omega tau} (measured
    0)."""
    _, p1 = _pair(2, 3, 10)
    p2 = copy.copy(p1)
    p2.cleanup('all')
    omega = np.linspace(0.5, 5, 9)
    gen = p1.get_filter_function(omega, which='generalized')
    p2.cache_filter_function(omega, filter_function=gen, which='generalized')
    assert p2.is_cached('generalized filter function')
    _close(p2.get_filter_function(omega), p1.get_filter_function(omega),
           1e-14)
    p3 = copy.copy(p1)
    p3.cleanup('all')
    p3.cache_control_matrix(omega, p1.get_control_matrix(omega).numpy())
    assert p3.is_cached('total phases')
    assert p3.is_cached('total propagator liouville')
    _close(p3.get_filter_function(omega), p1.get_filter_function(omega),
           1e-14)
    _close(p3.get_total_phases(omega), np.exp(1j * omega * p1.tau), 1e-15)


# -----------------------------------------------------------------------------
# numbers against JAX
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('d, n_dt, n_omega', SIZES)
def test_control_matrix_and_filter_functions_match_jax(d, n_dt, n_omega):
    """The control matrix within 1e-12 max|B| of the JAX PulseSequence's
    (measured <= 4.8e-15 max|B|), the fidelity and generalized filter
    functions within 1e-12 max|F| (measured <= 9.3e-15), the total
    propagator's Liouville representation within 1e-12 (measured
    4.7e-15); a pulse converted from JAX's, or from a mapping of its
    arrays, is the same pulse and gives the same control matrix
    (measured 0)."""
    jp, p = _pair(d, n_dt, 20 + d)
    omega = _omega(n_omega)
    ctrl = p.get_control_matrix(omega)
    assert ctrl.shape == (3, d * d, n_omega) and ctrl.dtype == torch.complex128
    _close(ctrl, jp.get_control_matrix(omega))
    for which in ('fidelity', 'generalized'):
        _close(p.get_filter_function(omega, which),
               jp.get_filter_function(omega, which))
    _close(p.total_propagator_liouville, jp.total_propagator_liouville)
    converted = convert.pulse_sequence_from_numpy(jp, device='cpu')
    assert converted == p
    _close(converted.get_control_matrix(omega), ctrl, 1e-15)
    mapping = {f: getattr(jp, f) for f in convert.PULSE_FIELDS}
    assert convert.pulse_sequence_from_numpy(
        {**mapping, 'basis': jp.basis.np}, device='cpu') == p


@pytest.mark.parametrize('d, n_dt, n_omega', SIZES)
def test_cached_intermediates_match_jax(d, n_dt, n_omega):
    """cache_intermediates: the per-step and cumulative control matrices
    within 1e-12 max|B| of JAX's (measured <= 2.9e-15); the result equals
    the accumulated one within 1e-13 max|B| (measured 1.1e-15); the step
    terms are kept under JAX's names."""
    jp, p = _pair(d, n_dt, 30 + d)
    omega = _omega(n_omega)
    ctrl = p.get_control_matrix(omega, cache_intermediates=True)
    jp.get_control_matrix(omega, cache_intermediates=True)
    assert set(p.intermediates) == set(jp._intermediates)
    for key in ('control_matrix_step', 'control_matrix_step_cumulative'):
        _close(p.intermediates[key], jp._intermediates[key].to_numpy())
    plain = numeric.calculate_control_matrix_from_scratch(
        p.eigvals, p.eigvecs, p.propagators, omega, p.basis, p.n_opers_dev,
        p.n_coeffs, p.dt)
    _close(ctrl, plain, 1e-13)


@pytest.mark.parametrize('chunk', [1, 2, 3])
def test_budget_chunking_equals_unchunked(chunk):
    """A budget that fits *chunk* segments (the last chunk padded with
    zero-duration identity segments when it is short) gives the
    unchunked control matrix within 1e-13 relative (measured 3.1e-16),
    on the CPU's native route."""
    d, n_dt, n_omega = 3, 7, 80
    _, p = _pair(d, n_dt, 40)
    omega = _omega(n_omega)
    args = (p.eigvals, p.eigvecs, p.propagators, omega, p.basis,
            p.n_opers_dev, p.n_coeffs, p.dt)
    whole = numeric.calculate_control_matrix_from_scratch(*args)
    per_segment = n_omega * d * d * 16
    assert numeric._pick_chunk(n_dt, per_segment, 1 << 30) == n_dt
    budget = chunk * per_segment
    assert numeric._pick_chunk(n_dt, per_segment, budget) == chunk
    chunked = numeric.calculate_control_matrix_from_scratch(
        *args, budget_bytes=budget)
    _close(chunked, whole, 1e-13)


def _nontraceless_basis():
    elems = np.array([np.eye(2) + sigma[1], sigma[2], sigma[3],
                      np.eye(2) - sigma[1]]) / np.sqrt(2)
    q, _ = np.linalg.qr(elems.reshape(4, 4).T)
    return q.T.reshape(4, 2, 2)


def _spectrum(kind, omega, n_nops, rng):
    s = 1e-2 / omega
    if kind == 'shared':
        return s
    if kind == 'per-operator':
        return s * rng.random((n_nops, 1))
    a = rng.standard_normal((n_nops, n_nops)) \
        + 1j * rng.standard_normal((n_nops, n_nops))
    return (a @ a.conj().T)[..., None] * s


@pytest.mark.parametrize('basis', ['traceless', 'nontraceless'])
@pytest.mark.parametrize('kind', ['shared', 'per-operator', 'cross'])
def test_infidelity_matches_jax(basis, kind):
    """infidelity for spectra of ndim 1, 2 and 3 (complex, Hermitian),
    in a traceless and in a non-traceless basis, for all and for a
    subset of the noise operators, with the smallness parameter: within
    1e-13 absolute of JAX (measured <= 3.5e-17 on infidelities up to
    3e-2), xi within 1e-13 relative (measured 2.1e-16)."""
    rng = np.random.default_rng(50)
    arrays = rand_pulse_arrays(2, 4, local_rng=rng)
    if basis == 'traceless':
        jp, p = make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)
    else:
        elems = _nontraceless_basis()
        jp = make_pulse(arrays)
        jp.basis = ff.Basis(elems)
        p = fft.PulseSequence.from_arrays(
            *(getattr(jp, f) for f in convert.PULSE_FIELDS),
            basis=fft.Basis(elems), device='cpu')
        assert not p.basis.istraceless
    omega = _omega(100)
    spectrum = _spectrum(kind, omega, 3, rng)
    got = fft.infidelity(p, spectrum, omega)
    assert got.shape == ((3, 3) if kind == 'cross' else (3,))
    want = np.asarray(ff.infidelity(jp, spectrum, omega))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    ids = list(p.n_oper_identifiers[[2, 0]])
    sub = spectrum[[2, 0]][:, [2, 0]] if kind == 'cross' else \
        spectrum[[2, 0]] if kind == 'per-operator' else spectrum
    got = fft.infidelity(p, torch.tensor(sub), torch.tensor(omega),
                         n_oper_identifiers=ids)
    want = np.asarray(ff.infidelity(jp, sub, omega, n_oper_identifiers=ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    if kind != 'cross':
        got, xi = fft.infidelity(p, spectrum, omega, return_smallness=True)
        _, want_xi = ff.infidelity(jp, spectrum, omega,
                                   return_smallness=True)
        np.testing.assert_allclose(xi.item(), float(want_xi), rtol=1e-13)
    else:
        with pytest.raises(NotImplementedError):
            fft.infidelity(p, spectrum, omega, return_smallness=True)


def test_infidelity_convergence_and_errors_match_jax():
    """test_convergence sweeps the same grids as JAX (which pads them to
    one size; the port needs no padding) to the same infidelities within
    1e-13 relative (measured 1.7e-15); bad arguments raise as in JAX."""
    jp, p = _pair(2, 4, 60)
    grid = dict(omega_IR=0.2, omega_UV=20.0, n_min=20, n_max=60,
                n_points=3, spacing='log')

    def spectrum(omega):
        return 1e-2 / omega

    n, got = fft.infidelity(p, spectrum, grid, test_convergence=True)
    n_want, want = ff.infidelity(jp, spectrum, grid, test_convergence=True)
    np.testing.assert_array_equal(n, n_want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    bad = [dict(spectrum=spectrum, omega=np.linspace(1, 2, 5),
                test_convergence=True),
           dict(spectrum=1.0, omega={}, test_convergence=True),
           dict(spectrum=spectrum, omega=dict(spacing='foo'),
                test_convergence=True),
           dict(spectrum=np.ones(5), omega=np.linspace(1, 2, 5),
                which='foo'),
           dict(spectrum=np.ones(5), omega=np.linspace(1, 2, 5),
                n_oper_identifiers=['nope'])]
    for kw in bad:
        with pytest.raises(Exception) as err:
            ff.infidelity(jp, **kw)
        with pytest.raises(err.type):
            fft.infidelity(p, **kw)


def test_pulse_correlations_match_jax():
    """which='correlations' on a pulse seeded with a JAX-made 4-d
    (pulse-resolved) control matrix: the pulse-correlation filter
    functions (fidelity and generalized), the total filter function
    summed from them within 1e-13 max|F| (measured <= 2.4e-16), and the
    pulse-resolved infidelities within 1e-13 absolute (measured 3.5e-17
    on values up to 0.18) of JAX's concatenated pulse; another omega
    raises; without a 4-d control matrix CalculationError."""
    omega = np.linspace(0.1, 10, 51)
    rng = np.random.default_rng(70)
    base = rand_pulse_arrays(2, 3, local_rng=rng)
    parts = []
    for _ in range(3):
        arr = rand_pulse_arrays(2, 3, local_rng=rng)
        parts.append(make_pulse((arr[0], arr[1], arr[2], base[3], base[4],
                                 arr[5], arr[6])))
        parts[-1].cache_filter_function(omega)
    jp = ff.concatenate(parts, calc_pulse_correlation_FF=True)
    ctrl_pc = jp.get_pulse_correlation_control_matrix().to_numpy()
    p = convert.pulse_sequence_from_numpy(jp, device='cpu')
    with pytest.raises(fft.util.CalculationError):
        p.get_pulse_correlation_filter_function()
    with pytest.raises(fft.util.CalculationError):
        p.get_pulse_correlation_control_matrix()
    p.cache_filter_function(omega, control_matrix=ctrl_pc)
    assert p.get_pulse_correlation_control_matrix().shape == ctrl_pc.shape
    for which in ('fidelity', 'generalized'):
        _close(p.get_pulse_correlation_filter_function(which),
               jp.get_pulse_correlation_filter_function(which), 1e-13)
    _close(p.get_filter_function(omega), jp.get_filter_function(omega),
           1e-13)
    spectrum = 1 / (1 + omega**2)
    got = fft.infidelity(p, spectrum, omega, which='correlations')
    want = np.asarray(ff.infidelity(jp, spectrum, omega,
                                    which='correlations'))
    assert got.shape == (3, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match='omega not equal'):
        fft.infidelity(p, spectrum[1:], omega[1:], which='correlations')
    q = convert.pulse_sequence_from_numpy(jp, device='cpu')
    q.cache_filter_function(omega, control_matrix=ctrl_pc,
                            which='generalized')
    _close(q.get_pulse_correlation_filter_function('generalized'),
           jp.get_pulse_correlation_filter_function('generalized'), 1e-13)
    _close(q.get_filter_function(omega, 'generalized'),
           jp.get_filter_function(omega, 'generalized'), 1e-13)


def test_propagator_at_arb_t_matches_jax():
    """Q(t) at interior points, segment boundaries, 0 and tau within
    1e-12 of JAX (measured <= 3e-15); Q(0) is the identity and Q(tau) the
    total propagator."""
    jp, p = _pair(3, 5, 80)
    interior = (p.t[:-1] + p.t[1:]) / 2
    tt = np.sort(np.concatenate([[0.0, p.tau], p.t, interior]))
    _close(p.propagator_at_arb_t(tt), jp.propagator_at_arb_t(tt))
    _close(p.propagator_at_arb_t([0.0])[0], np.eye(3), 1e-15)
    _close(p.propagator_at_arb_t(torch.tensor([p.tau], dtype=torch.float64))[0],
           p.total_propagator, 1e-13)


def test_setters_feed_the_pipeline():
    """The eigendecomposition given through the setters (as numpy, from
    JAX) is what the control matrix is computed from: within 1e-12
    max|B| of JAX's (measured 1.4e-15)."""
    jp, p = _pair(2, 4, 90)
    jp.diagonalize()
    for name in ('eigvals', 'eigvecs', 'propagators', 'total_propagator'):
        setattr(p, name, _np(getattr(jp, name)))
        assert isinstance(getattr(p, name), torch.Tensor)
    np.testing.assert_array_equal(p.eigvecs.numpy(), _np(jp.eigvecs))
    omega = _omega(50)
    _close(p.get_control_matrix(omega), jp.get_control_matrix(omega))


def test_functional_entry_points_from_a_pulse():
    """make_pulse_arrays and fidelity_filter_function agree with the
    object path and with JAX's functional API within 1e-12 max|F|
    (measured 0 and 2.1e-15)."""
    jp, p = _pair(3, 4, 95)
    omega = _omega(60)
    arrays = functional.make_pulse_arrays(p)
    assert arrays.basis.shape == (9, 3, 3) and arrays.dt.device == p.device
    got = functional.fidelity_filter_function(arrays, torch.tensor(omega))
    _close(got, p.get_filter_function(omega))
    _close(got, jfunctional.fidelity_filter_function(
        jfunctional.make_pulse_arrays(jp), omega))
