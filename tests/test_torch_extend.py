"""The port's composition in space (filter_functions_tpu_torch.sequencing
``remap`` and ``extend``) against the JAX package's on the same pulses.

The cases mirror tests/test_sequencing.py's TestRemapExtend,
TestRemapCachingAndAccuracy, TestExtendWithIdentity, TestExtendErrors and
TestCompositionKwargs at d <= 8 and <= 50 frequencies.  Pulses are built
from the same numpy arrays in both packages, and the port's pulses adopt
the JAX pulses' cached values (``_adopt``): the eigensolvers of the two
packages pick different eigenvector phases, and remap / extend only
rearrange what is cached.  Then the new pulses must carry the same
identifiers and, bit for bit, the same operators and coefficients; the
same caches must be filled; every cached value must agree within 1e-12
of the largest entry of the JAX value (``_close``); the same calls must
raise and warn.

The one case where the port and the JAX package part ways is pinned on
its own (``test_extend_cross_blocks``): the JAX package caches the
extended filter function block by block and leaves the cross terms
between the parts' noise operators and additional ones at zero; the
port's is that of the complete control matrix.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import convert, util
from testutil import make_pulse, rand_pulse_arrays, sigma
from torch_testutil import fft_cpu

I2, X, Y, Z = sigma

#: Cached values compared between the packages.
DATA_KEYS = ('eigvals', 'eigvecs', 'propagators', 'total_propagator',
             'total_propagator_liouville')
FREQ_KEYS = ('omega', 'total_phases', 'control_matrix', 'filter_function')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _close(got, want, rel=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _cached(pulse, key):
    return (pulse._frequency_data if key in FREQ_KEYS
            else pulse._data)[key]


def _adopt(port, jax_pulse):
    """Give *port* the cached values of *jax_pulse* (same arrays, same
    frequencies) and return it."""
    for key in DATA_KEYS:
        if jax_pulse.is_cached(key):
            setattr(port, key, torch.tensor(_np(_cached(jax_pulse, key))))
    if jax_pulse.is_cached('omega'):
        port.omega = np.asarray(jax_pulse.omega)
        for key in FREQ_KEYS[1:]:
            if jax_pulse.is_cached(key):
                port._frequency_data[key] = torch.tensor(
                    _np(_cached(jax_pulse, key)))
    return port


def _both(arrays, btype='Pauli'):
    """The same pulse in (JAX, port)."""
    return make_pulse(arrays, btype), make_pulse(arrays, btype, cls=fft_cpu)


def _both_from(H_c, H_n, dt, n_qubits=None):
    """(JAX, port) pulses from Hamiltonians, Pauli basis of *n_qubits*
    (GGM if None)."""
    return tuple(mod.PulseSequence(
        H_c, H_n, dt, None if n_qubits is None else mod.Basis.pauli(n_qubits))
        for mod in (ff, fft_cpu))


def _same(port, jax_pulse, skip=()):
    """Same identifiers, operators, coefficients (bit for bit), basis and
    caches; every cached value within 1e-12 of JAX's."""
    for name in convert.PULSE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_pulse, name), err_msg=name)
    np.testing.assert_array_equal(port.basis.np, jax_pulse.basis.np)
    assert port.basis.btype == jax_pulse.basis.btype
    assert port.tau == jax_pulse.tau
    assert port.device == torch.device('cpu')
    for key in DATA_KEYS + FREQ_KEYS:
        assert port.is_cached(key) == jax_pulse.is_cached(key), key
        if port.is_cached(key) and key not in skip:
            _close(_cached(port, key), _cached(jax_pulse, key))


def _random_pair(d, n_dt, seed, n_nops=3):
    rng = np.random.default_rng(seed)
    return _both(rand_pulse_arrays(d, n_dt, n_nops=n_nops, local_rng=rng))


def _two_parts(n_dt=5, seed=0):
    """Two random single-qubit pulses on the same time steps, as
    ((JAX, port), (JAX, port))."""
    rng = np.random.default_rng(seed)
    a1 = rand_pulse_arrays(2, n_dt, local_rng=rng)
    a2 = list(rand_pulse_arrays(2, n_dt, local_rng=rng))
    a2[6] = a1[6]
    return _both(a1), _both(a2)


# -----------------------------------------------------------------------------
# remap
# -----------------------------------------------------------------------------
def test_remap_roundtrip():
    """remap twice with (1, 0) returns the pulse, with its filter
    function; each step equals JAX's."""
    jp, p = _random_pair(4, 3, 1)
    omega = np.linspace(0.5, 10, 11)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    swapped, jswapped = fft.remap(p, (1, 0)), ff.remap(jp, (1, 0))
    _same(swapped, jswapped)
    back = fft.remap(swapped, (1, 0))
    assert back == p
    _same(back, ff.remap(jswapped, (1, 0)))
    _close(back.get_filter_function(omega), p.get_filter_function(omega))


def test_remap_control_matrix_permutation():
    """The remapped cached control matrix equals the remapped pulse's
    from scratch (1e-12 of the largest entry; the bound of
    tests/test_sequencing.py is 1e-11 absolute)."""
    jp, p = _random_pair(4, 3, 2)
    omega = np.linspace(0.5, 10, 11)
    p.cache_filter_function(omega)
    swapped = fft.remap(p, (1, 0))
    fresh = fft.PulseSequence.from_arrays(
        *(getattr(swapped, f) for f in convert.PULSE_FIELDS),
        swapped.basis, device='cpu')
    _close(swapped.get_control_matrix(omega), fresh.get_control_matrix(omega))


def test_remap_cache_retention():
    """The same caches as JAX's remap, with nothing, everything and a
    GGM basis cached (the last warns and drops the control matrix and
    the total Liouville propagator)."""
    arrays = rand_pulse_arrays(4, 1, 1, 4, np.random.default_rng(3))
    jp, p = _both(arrays)
    _same(fft.remap(p, (1, 0)), ff.remap(jp, (1, 0)))
    omega = fft.util.get_sample_frequencies(p, n_samples=30)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    _same(fft.remap(p, (1, 0)), ff.remap(jp, (1, 0)))

    jg, g = _both(arrays, 'GGM')
    jg.cache_filter_function(omega)
    _adopt(g, jg)
    with pytest.warns(UserWarning, match='separable'):
        want = ff.remap(jg, (1, 0))
    with pytest.warns(UserWarning, match='separable'):
        got = fft.remap(g, (1, 0))
    _same(got, want)
    assert not got.is_cached('control_matrix')


@pytest.mark.parametrize('order', [(1, 0, 2), (2, 0, 1), (1, 2, 0)])
def test_remap_three_qubit_accuracy(order):
    """A remapped 3-qubit pulse with an identifier mapping equals JAX's
    and the explicitly reordered pulse (control matrix and filter
    function within 1e-12 of the largest entry)."""
    paulis = np.array(util.paulis)
    amps = np.random.default_rng(17).standard_normal(3)
    ones = np.ones_like(amps)
    ids = ('XII', 'IXI', 'IIX')

    def build(mod, perm):
        return mod.PulseSequence(
            [[util.tensor(*paulis[1:][perm]), amps]],
            [[util.tensor(*paulis[list(sel)][perm]), ones,
              ''.join(name[o] for o in perm)]
             for sel, name in zip(([1, 0, 0], [0, 1, 0], [0, 0, 1]), ids)],
            ones, mod.Basis.pauli(3))

    order = list(order)
    jp, p = build(ff, [0, 1, 2]), build(fft_cpu, [0, 1, 2])
    omega = util.get_sample_frequencies(p, 30)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    mapping = {'A_0': 'A_0', **{i: ''.join(i[o] for o in order)
                                for i in ids}}
    got = fft.remap(p, order, oper_identifier_mapping=mapping)
    _same(got, ff.remap(jp, order, oper_identifier_mapping=mapping))
    reordered = build(fft_cpu, order)
    assert reordered == got and reordered.basis == got.basis
    reordered.cache_filter_function(omega)
    for key in ('propagators', 'total_propagator',
                'total_propagator_liouville'):
        _close(getattr(got, key), getattr(reordered, key))
    _close(got.get_control_matrix(omega), reordered.get_control_matrix(omega))
    _close(got.get_filter_function(omega),
           reordered.get_filter_function(omega))


def test_remap_identifier_mapping():
    """Renamed identifiers, sorted, and the cached filter function kept,
    as in JAX."""
    jp, p = _random_pair(4, 3, 4)
    omega = np.linspace(0.5, 10, 9)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    mapping = {old: f'{old}_sw' for old in
               (*p.c_oper_identifiers, *p.n_oper_identifiers)}
    got = fft.remap(p, (1, 0), oper_identifier_mapping=mapping)
    assert all(i.endswith('_sw') for i in got.n_oper_identifiers)
    _same(got, ff.remap(jp, (1, 0), oper_identifier_mapping=mapping))


# -----------------------------------------------------------------------------
# extend
# -----------------------------------------------------------------------------
def test_extend_single_to_two_qubits():
    """Two copies of a cached single-qubit pulse on qubits 0 and 1:
    JAX's extension, and within 1e-12 of the extended pulse from
    scratch."""
    jp, p = _both_from([[X, [np.pi / 2], 'X']],
                       [[X, [1.0], 'X'], [Z, [1.0], 'Z']], [1], 1)
    omega = np.linspace(0.5, 10, 15)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    got = fft.extend([(p, 0), (p, 1)])
    _same(got, ff.extend([(jp, 0), (jp, 1)]))
    fresh = fft.PulseSequence.from_arrays(
        *(getattr(got, f) for f in convert.PULSE_FIELDS), got.basis,
        device='cpu')
    _close(got.get_filter_function(omega), fresh.get_filter_function(omega))


@pytest.mark.parametrize('N,target', [(2, 0), (2, 1), (3, 1)])
def test_extend_matches_explicit(N, target):
    """One pulse extended into an N-qubit register: the identifiers get
    the target qubit, a mapping renames them; uncached in, uncached out;
    cached in, JAX's caches out, within 1e-12 of the explicitly built
    register pulse."""
    n_dt = 6
    coeffs = np.random.default_rng(5 + N + target).standard_normal((3, n_dt))
    ids = ['X', 'Y', 'Z']
    H = [list(zip((X, Y, Z), c, ids)) for c in (coeffs, np.ones((3, n_dt)))]
    jp, p = _both_from(*H, np.ones(n_dt), 1)
    ext_opers = util.tensor(*np.insert(
        np.tile(I2, (N - 1, 3, 1, 1)), target, (X, Y, Z), axis=0))
    ext_ids = [i + f'_{target}' for i in ids]
    explicit = fft.PulseSequence(
        list(zip(ext_opers, coeffs, ext_ids)),
        list(zip(ext_opers, np.ones((3, n_dt)), ext_ids)),
        np.ones(n_dt), fft.Basis.pauli(N), device='cpu')

    got = fft.extend([(p, target)], N)
    _same(got, ff.extend([(jp, target)], N))
    assert list(got.c_oper_identifiers) == ext_ids and got == explicit
    mapping = {i: 'M' + i for i in ids}
    got = fft.extend([(p, target, mapping)], N)
    _same(got, ff.extend([(jp, target, mapping)], N))

    omega = util.get_sample_frequencies(p, n_samples=30)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    got = fft.extend([(p, target)], N)
    _same(got, ff.extend([(jp, target)], N))
    explicit.cache_filter_function(omega)
    for key in ('propagators', 'total_propagator',
                'total_propagator_liouville'):
        _close(getattr(got, key), getattr(explicit, key))
    for key in ('total_phases', 'control_matrix', 'filter_function'):
        _close(_cached(got, key), _cached(explicit, key))


def test_extend_caching_decision_matrix():
    """cache_diagonalization / cache_filter_function inferred and
    overridden as in JAX, case by case (where a part is diagonalized
    inside extend, its eigenvectors' phases are the solver's)."""
    (j1, p1), (j2, p2) = _two_parts(seed=6)
    omega = util.get_sample_frequencies(p1, 30)

    def check(skip=(), **kw):
        _same(fft.extend([(p1, 0), (p2, 1)], **kw),
              ff.extend([(j1, 0), (j2, 1)], **kw), skip)

    j1.diagonalize()
    _adopt(p1, j1)
    check()
    check(('eigvecs',), cache_diagonalization=True)
    p2.cleanup('all')
    j2.diagonalize()
    _adopt(p2, j2)
    check()
    check(cache_diagonalization=False)
    j1.cache_filter_function(omega)
    _adopt(p1, j1)
    check()
    check(('control_matrix', 'filter_function'),
          cache_filter_function=True, omega=omega)
    p2.cleanup('all')
    j2.cache_filter_function(omega)
    _adopt(p2, j2)
    check()
    check(cache_filter_function=False)
    ext = fft.extend([(p1, 0), (p2, 1)])
    got = ext.get_filter_function(omega)
    ext.cleanup('all')
    _close(got, ext.get_filter_function(omega))


def test_extend_total_propagator_chain_and_ggm_fallback():
    """Without diagonalizations the total propagators are tensored
    together (JAX's); GGM parts warn and are computed from scratch on
    the register (propagators, control matrix and filter function
    within 1e-12 of JAX's; the eigenvectors' phases are the solver's)."""
    (j1, p1), (j2, p2) = _two_parts(seed=7)
    for jp, p in ((j1, p1), (j2, p2)):
        jp.total_propagator = jp.total_propagator
        p.total_propagator = torch.as_tensor(_np(jp.total_propagator))
        jp.cleanup('conservative')
    got = fft.extend([(p1, 1), (p2, 0)], cache_diagonalization=False)
    _same(got, ff.extend([(j1, 1), (j2, 0)], cache_diagonalization=False))

    rng = np.random.default_rng(8)
    arrays = rand_pulse_arrays(2, 4, local_rng=rng)
    jg, g = _both(arrays, 'GGM')
    omega = np.linspace(0.5, 10, 9)
    jg.cache_filter_function(omega)
    g.cache_filter_function(omega)
    with pytest.warns(UserWarning, match='GGM'):
        want = ff.extend([(jg, 0), (jg, 2)])
    with pytest.warns(UserWarning, match='GGM'):
        got = fft.extend([(g, 0), (g, 2)])
    _same(got, want, skip=('eigvecs', 'eigvals'))
    _close(np.sort(_np(got.eigvals), -1), np.sort(_np(want.eigvals), -1))


def test_extend_unsorted_qubits_and_additional_noise():
    """A two-qubit part on qubits (2, 0) is remapped inside extend; with
    a single-qubit part on 1 and an additional Z x Z x Z noise operator
    (no cross terms with the parts' rows by symmetry) the extended pulse
    is JAX's, its control matrix within 1e-12 of the register pulse's
    from scratch."""
    rng = np.random.default_rng(9)
    a2 = rand_pulse_arrays(4, 4, local_rng=rng)
    a1 = list(rand_pulse_arrays(2, 4, local_rng=rng))
    a1[6] = a2[6]
    (j2, p2), (j1, p1) = _both(a2), _both(a1)
    omega = np.linspace(0.5, 10, 9)
    for jp, p in ((j2, p2), (j1, p1)):
        jp.cache_filter_function(omega)
        _adopt(p, jp)
    zzz = [[util.tensor(Z, Z, Z), np.ones(4), 'ZZZ']]
    got = fft.extend([(p2, (2, 0)), (p1, 1)],
                     additional_noise_Hamiltonian=zzz)
    want = ff.extend([(j2, (2, 0)), (j1, 1)],
                     additional_noise_Hamiltonian=zzz)
    _same(got, want)
    fresh = fft.PulseSequence.from_arrays(
        *(getattr(got, f) for f in convert.PULSE_FIELDS), got.basis,
        device='cpu')
    _close(got.get_control_matrix(omega), fresh.get_control_matrix(omega))
    _close(got.get_filter_function(omega), fresh.get_filter_function(omega))


def test_extend_cross_blocks():
    """Two d = 2 parts on qubits 0 and 1 and the additional noise
    operator ZZ = Z x Z / 4 + Z x I / 2, which correlates with the first
    part's Z row.  The port's cached filter function is B^H B of its
    cached control matrix and the explicit register pulse's filter
    function, within 1e-12 of the largest entry; its infidelity under a
    spectrum that correlates ZZ and Z_0 is the explicit pulse's.  The
    JAX package's misses the cross block (ZZ, Z_0) by more than 0.1 of
    its largest entry (pinned; measured 0.816)."""
    n_dt, rng = 5, np.random.default_rng(10)
    parts = []
    for _ in range(2):
        H_c = [[X / 2, rng.standard_normal(n_dt), 'X'],
               [Y / 2, rng.standard_normal(n_dt), 'Y']]
        parts.append(_both_from(H_c, [[Z / 2, np.ones(n_dt), 'Z']],
                                np.full(n_dt, 0.7), 1))
    (j0, p0), (j1, p1) = parts
    omega = np.geomspace(0.1, 50, 50)
    for jp, p in parts:
        jp.cache_filter_function(omega)
        _adopt(p, jp)
    extra = [[util.tensor(Z, Z) / 4 + util.tensor(Z, I2) / 2, np.ones(n_dt),
              'ZZ']]
    got = fft.extend([(p0, 0), (p1, 1)], additional_noise_Hamiltonian=extra)
    want = ff.extend([(j0, 0), (j1, 1)], additional_noise_Hamiltonian=extra)
    assert list(got.n_oper_identifiers) == ['ZZ', 'Z_0', 'Z_1']
    _same(got, want, skip=('eigvecs', 'filter_function'))

    ctrl = got.get_control_matrix(omega)
    cached = got.get_filter_function(omega)
    _close(cached, fft.numeric.calculate_filter_function(ctrl))
    explicit = fft.PulseSequence.from_arrays(
        *(getattr(got, f) for f in convert.PULSE_FIELDS), got.basis,
        device='cpu')
    scratch = explicit.get_filter_function(omega)
    _close(cached, scratch)
    jax_ff = _np(want.get_filter_function(omega))
    miss = np.abs(jax_ff[0, 1] - scratch[0, 1].numpy()).max() \
        / np.abs(scratch.numpy()).max()
    assert miss > 0.1

    spectrum = np.zeros((3, 3, len(omega)))
    spectrum[[0, 1, 2], [0, 1, 2]] = 1e-3 / omega
    spectrum[0, 1] = spectrum[1, 0] = 5e-4 / omega
    _close(fft.infidelity(got, spectrum, omega),
           fft.infidelity(explicit, spectrum, omega))


def test_extend_cache_flags():
    """Explicit opt-outs and forcing with omega, as in JAX."""
    jp, p = _both_from([[X, [np.pi / 2], 'X']], [[Z, [1.0], 'Z']], [1], 1)
    omega = np.linspace(0.5, 10, 9)
    jp.cache_filter_function(omega)
    _adopt(p, jp)
    for kw in (dict(cache_filter_function=False),
               dict(cache_diagonalization=False,
                    cache_filter_function=False)):
        _same(fft.extend([(p, 0), (p, 1)], **kw),
              ff.extend([(jp, 0), (jp, 1)], **kw))
    jf, f = _both_from([[X, [np.pi / 2], 'X']], [[Z, [1.0], 'Z']], [1], 1)
    got = fft.extend([(f, 0), (f, 1)], cache_filter_function=True,
                     omega=omega)
    assert got.is_cached('filter function')
    _same(got, ff.extend([(jf, 0), (jf, 1)], cache_filter_function=True,
                         omega=omega), skip=DATA_KEYS + FREQ_KEYS)


def test_extend_warns_on_dropped_higher_order_caches():
    """A part with a second-order filter function: the same warning as
    JAX's, and no second-order filter function on the result; a clean
    part raises no warning."""
    jp, p = _both_from([[X, [np.pi / 2], 'X']], [[Z, [1.0], 'Z']], [1], 1)
    omega = np.linspace(0.5, 10, 9)
    p.cache_filter_function(omega)
    p.get_filter_function(omega, order=2)
    with pytest.warns(UserWarning, match='second order filter function'):
        ext = fft.extend([(p, 0), (p, 1)])
    assert not ext.is_cached('second order filter function')
    clean = fft.PulseSequence([[X, [np.pi / 2], 'X']], [[Z, [1.0], 'Z']],
                              [1], fft.Basis.pauli(1), device='cpu')
    clean.cache_filter_function(omega)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        fft.extend([(clean, 0), (clean, 1)])


# -----------------------------------------------------------------------------
# errors
# -----------------------------------------------------------------------------
def _error_cases(mod, n_dt=5):
    """(call, exception type, match) of every failure mode of
    tests/test_sequencing.py::TestExtendErrors, on pulses of *mod*."""
    omega = np.linspace(0.1, 1, 20)
    arrays = rand_pulse_arrays(2, n_dt, local_rng=np.random.default_rng(11))
    cls = ff if mod is ff else fft_cpu
    p1 = make_pulse(arrays, 'Pauli', cls=cls)
    p1.cache_filter_function(omega)
    p11 = mod.extend([[p1, 0], [p1, 1]])
    p11.cache_filter_function(omega + 1)
    p_ggm = make_pulse(rand_pulse_arrays(2, n_dt,
                                         local_rng=np.random.default_rng(12)),
                       cls=cls)
    XX, XXX = util.tensor(X, X), util.tensor(X, X, X)
    ones = np.ones(n_dt)
    dup = str(p1.n_oper_identifiers[0]) + '_1'
    return [
        (lambda: mod.extend([(p11, (2, 1, 0))]), ValueError, 'remap'),
        (lambda: mod.extend([(p1, (0, 1))]), ValueError, 'dimension'),
        (lambda: mod.extend([(p1, (0,))], d_per_qubit=3), ValueError,
         'd_per_qubit'),
        (lambda: mod.extend([(p11, (0,))]), ValueError, 'dimension'),
        (lambda: mod.extend([(p1, 0), [p_ggm, 1]]), ValueError,
         'same time steps'),
        (lambda: mod.extend([(p1, 0), [p1, 0]]), ValueError, '[Qq]ubit clash'),
        (lambda: mod.extend([(p1, 2)], N=2), ValueError, 'N smaller'),
        (lambda: mod.extend([(p1, 0), (p11, (1, 2))],
                            cache_filter_function=True, omega=None),
         ValueError, 'omega'),
        (lambda: mod.extend([(p1, 0), (p1, 1)], cache_diagonalization=False,
                            additional_noise_Hamiltonian=[[XX, ones]]),
         ValueError, 'cache_diagonalization'),
        (lambda: mod.extend([(p1, 0), (p1, 1)],
                            additional_noise_Hamiltonian=[[XX, ones, 'foo'],
                                                          [XX, ones, 'foo']]),
         ValueError, 'unique'),
        (lambda: mod.extend([(p1, 1)], additional_noise_Hamiltonian=[
            [XX, ones, dup]]), ValueError, 'duplicate'),
        (lambda: mod.extend([(p1, 0), (p1, 1)],
                            additional_noise_Hamiltonian=[[XXX, ones]]),
         ValueError, 'dimensions'),
    ]


@pytest.mark.parametrize('case', range(12))
def test_extend_errors(case):
    """Each failure mode raises the same exception, with the same
    message (the pulse's repr aside), in both packages."""
    call, exc, match = _error_cases(ff)[case]
    with pytest.raises(exc, match=match) as want:
        call()
    call, _, _ = _error_cases(fft)[case]
    with pytest.raises(exc, match=match) as got:
        call()
    assert re.sub('<.*>', '', str(got.value)) == \
        re.sub('<.*>', '', str(want.value))


def test_extend_warnings_and_single_pulse():
    """GGM parts warn; a single pulse mapped to its own qubits warns
    and comes back unchanged; a qubit clash and an identifier clash with
    an additional operator raise."""
    rng = np.random.default_rng(13)
    p_ggm = make_pulse(rand_pulse_arrays(2, 5, local_rng=rng), cls=fft_cpu)
    p_ggm.cache_filter_function(np.linspace(0.1, 1, 20))
    with pytest.warns(UserWarning, match='GGM'):
        fft.extend([(p_ggm, 0), (p_ggm, 1)])
    p1 = make_pulse(rand_pulse_arrays(2, 3, local_rng=rng), 'Pauli',
                    cls=fft_cpu)
    with pytest.warns(UserWarning, match='same'):
        assert fft.extend([(p1, 0)], N=1) is p1
    q_arrays = list(rand_pulse_arrays(2, 3, local_rng=rng))
    q_arrays[6] = p1.dt
    q = make_pulse(q_arrays, 'Pauli', cls=fft_cpu)
    with pytest.raises(ValueError, match='clash'):
        fft.extend([(p1, 0), (q, 0)])
    p = fft.PulseSequence([[X, [1.0], 'X']], [[Z, [1.0], 'Z']], [1.0],
                          fft.Basis.pauli(1), device='cpu')
    with pytest.raises(ValueError, match='duplicate'):
        fft.extend([(p, 0, {'X': 'X_0', 'Z': 'ZZ'})], N=2,
                   additional_noise_Hamiltonian=[[np.kron(Z, Z), [1.0],
                                                  'ZZ']])


def test_extend_parts_on_different_devices_raise():
    """Parts that live on different devices raise, as concatenate's do."""
    p = fft.PulseSequence([[X, [1.0], 'X']], [[Z, [1.0], 'Z']], [1.0],
                          fft.Basis.pauli(1), device='cpu')
    q = fft.PulseSequence([[X, [1.0], 'X']], [[Z, [1.0], 'Z']], [1.0],
                          fft.Basis.pauli(1), device='cpu')
    q.device = torch.device('meta')
    with pytest.raises(ValueError, match='different devices'):
        fft.extend([(p, 0), (q, 1)])
