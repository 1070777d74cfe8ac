"""The port's concatenation in time (filter_functions_tpu_torch.sequencing,
``PulseSequence.__matmul__``) against the JAX package's on the same
pulses, and against the port's own from-scratch results.

The cases are those tests/test_sequencing.py pins for the JAX package
(concatenation, second-order concatenation, Hamiltonian merging,
pulse-correlation semantics, identifier clashes, the long-train fast
paths), run on pulses built from the same numpy arrays in both packages:
the merged pulses must have the same identifiers and, bit for bit, the
same operators, coefficient grids and durations; the same caches must be
filled after each call; the same calls must raise and warn; control
matrices and filter functions must agree within 1e-12 of the largest
entry of the JAX result (``_close``) unless a test states another bound.

Sizes: d <= 4, <= 64 frequencies, trains <= 200 pulses, and one
10^4-pulse d = 2 train.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from conftest import HAVE_REFERENCE
from filter_functions_tpu_torch import convert, numeric, sequencing, util
from testutil import (generate_dd_hamiltonian, make_pulse, rand_herm_traceless,
                      rand_pulse_arrays, sigma)
from torch_testutil import fft_cpu

X, Y, Z = sigma[1:]

#: Cache keys whose presence must agree between the packages.
CACHE_KEYS = ('total_propagator', 'total_propagator_liouville',
              'total_phases', 'omega', 'control_matrix', 'control_matrix_pc',
              'filter_function', 'filter_function_gen', 'filter_function_pc',
              'filter_function_pc_gen', 'filter_function_2')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _close(got, want, rel=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _both(arrays):
    """The same pulse in (JAX, port)."""
    return make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


def _both_from(H_c, H_n, dt, basis=None):
    return (ff.PulseSequence(H_c, H_n, dt,
                             None if basis is None else ff.Basis(basis)),
            fft.PulseSequence(H_c, H_n, dt,
                              None if basis is None else fft.Basis(basis),
                              device='cpu'))


def _same_pulse(port, jax_pulse):
    """Identifiers equal; operators, coefficients and durations equal
    bit for bit; same duration."""
    for name in convert.PULSE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_pulse, name), err_msg=name)
    assert port.tau == jax_pulse.tau


def _same_caches(port, jax_pulse):
    for key in CACHE_KEYS:
        assert port.is_cached(key) == jax_pulse.is_cached(key), key


def _shared_noise_arrays(n, d, n_dt, seed, constant_sensitivity=False):
    """*n* random pulses' arrays with the noise operators and identifiers
    of the first."""
    rng = np.random.default_rng(seed)
    base = rand_pulse_arrays(d, n_dt, local_rng=rng)
    out = []
    for _ in range(n):
        arr = rand_pulse_arrays(d, n_dt, local_rng=rng)
        n_coeffs = base[5] if constant_sensitivity else arr[5]
        out.append((arr[0], arr[1], arr[2], base[3], base[4], n_coeffs,
                    arr[6]))
    return out


# -----------------------------------------------------------------------------
# concatenation
# -----------------------------------------------------------------------------
def test_matmul_equals_concatenate():
    """a @ b is concatenate((a, b)), and the merged pulse is JAX's."""
    rng = np.random.default_rng(0)
    arrays = rand_pulse_arrays(2, 4, local_rng=rng)
    ja, a = _both(arrays)
    other = (arrays[0], arrays[1], rng.standard_normal((3, 5)), arrays[3],
             arrays[4], rng.random((3, 5)), 1 - rng.random(5))
    jb = ff.PulseSequence.from_arrays(*other, ja.basis)
    b = fft.PulseSequence.from_arrays(*other, a.basis, device='cpu')
    assert (a @ b) == fft.concatenate((a, b))
    _same_pulse(a @ b, ja @ jb)
    assert (a @ b).device == torch.device('cpu')


def test_slice_reconcatenation():
    """concatenate of the single segments computes from scratch (nothing
    is cached) the filter function of the whole pulse: 1e-12 of JAX's
    and of the port's own (measured 1e-15)."""
    jp, p = _both(rand_pulse_arrays(2, 6, local_rng=np.random.default_rng(1)))
    omega = np.linspace(0.5, 20, 31)
    parts = fft.concatenate([p[i] for i in range(len(p))])
    jparts = ff.concatenate([jp[i] for i in range(len(jp))])
    _same_pulse(parts, jparts)
    _same_caches(parts, jparts)
    _close(parts.get_filter_function(omega), jp.get_filter_function(omega))
    _close(parts.get_filter_function(omega), p.get_filter_function(omega))


def test_slice_reconcatenation_with_cached_segments():
    """With each segment's control matrix cached, concatenation goes
    through K5 and still gives the pulse's own filter function (1e-12,
    measured 2e-15)."""
    _, p = _both(rand_pulse_arrays(3, 5, local_rng=np.random.default_rng(2)))
    omega = np.linspace(0.5, 20, 17)
    segments = [p[i] for i in range(len(p))]
    for s in segments:
        s.cache_control_matrix(omega)
    whole = fft.concatenate(segments)
    assert whole.is_cached('control_matrix')
    _close(whole.get_filter_function(omega), p.get_filter_function(omega))


def test_slicing_semantics():
    """Slices, steps and masks of a pulse concatenate back to it, as in
    JAX; empty selections raise IndexError."""
    _, pulse = _both(rand_pulse_arrays(2, 8,
                                       local_rng=np.random.default_rng(3)))
    parts = [p for p in pulse]
    assert len(parts) == 8
    assert fft.concatenate(parts) == pulse
    assert pulse == fft.concatenate([pulse[:3], pulse[3:]])
    assert pulse[::-1] == fft.concatenate(parts[::-1])
    mask = np.array([1, 0, 1, 0, 1, 1, 0, 1], bool)
    assert pulse[mask] == fft.concatenate(
        [p for p, b in zip(parts, mask) if b])
    with pytest.raises(IndexError):
        pulse[np.zeros(8, bool)]


@pytest.mark.parametrize('d,n_dt,n_omega', [(2, 3, 27), (3, 4, 40),
                                            (4, 5, 64)])
def test_cached_vs_scratch(d, n_dt, n_omega):
    """Three pulses with cached filter functions and the same noise
    operators: the concatenated control matrix and filter function are
    JAX's (1e-12, measured <= 6e-15) and the from-scratch ones of the
    merged pulse (1e-12, measured <= 3e-15); same caches as JAX."""
    omega = np.linspace(0.1, 10, n_omega)
    jps, ps = zip(*map(_both, _shared_noise_arrays(3, d, n_dt, 4 + d)))
    for p in jps + ps:
        p.cache_filter_function(omega)
    jc, c = ff.concatenate(jps), fft.concatenate(ps)
    _same_pulse(c, jc)
    _same_caches(c, jc)
    assert c.is_cached('filter function')
    _close(c.get_control_matrix(omega), jc.get_control_matrix(omega))
    _close(c.get_filter_function(omega), jc.get_filter_function(omega))
    _close(c.total_propagator, jc.total_propagator)
    scratch = fft.concatenate_without_filter_function(ps)
    _same_caches(scratch, ff.concatenate_without_filter_function(jps))
    _close(c.get_filter_function(omega), scratch.get_filter_function(omega))


def test_pulse_correlation_ff_sums_to_total():
    """The pulse-correlation filter function is JAX's (1e-12, measured
    4e-15) and sums to the total one (1e-12 absolute); the correlation
    infidelities are JAX's (1e-12 relative to the largest, measured
    2e-15), sum to the total infidelity (rtol 1e-10), and the total
    infidelity of the concatenated pulse is the from-scratch one."""
    omega = np.linspace(0.1, 10, 21)
    jps, ps = zip(*map(_both, _shared_noise_arrays(3, 2, 3, 8)))
    for p in jps + ps:
        p.cache_filter_function(omega)
    jc = ff.concatenate(jps, calc_pulse_correlation_FF=True)
    c = fft.concatenate(ps, calc_pulse_correlation_FF=True)
    _same_caches(c, jc)
    f_pc = c.get_pulse_correlation_filter_function()
    assert f_pc.shape == (3, 3, 3, 3, 21)
    _close(f_pc, jc.get_pulse_correlation_filter_function())
    np.testing.assert_allclose(f_pc.sum((0, 1)).numpy(),
                               c.get_filter_function(omega).numpy(),
                               rtol=0, atol=1e-12)
    spectrum = 1 / (1 + omega**2)
    i_corr = fft.infidelity(c, spectrum, omega, which='correlations')
    i_tot = fft.infidelity(c, spectrum, omega)
    _close(i_corr, ff.infidelity(jc, spectrum, omega, which='correlations'))
    np.testing.assert_allclose(i_corr.sum((0, 1)).numpy(), i_tot.numpy(),
                               rtol=1e-10)
    scratch = fft.concatenate_without_filter_function(ps)
    _close(i_tot, fft.infidelity(scratch, spectrum, omega))


def test_different_n_opers():
    """Two pulses that share one of two noise operators: the rows of the
    operator a pulse lacks are computed from scratch during
    concatenation, with the constant sensitivity inferred.  Merged pulse
    and filter function are JAX's (1e-12, measured 3e-15) and the
    from-scratch ones."""
    omega = np.linspace(0.5, 10, 19)
    local = np.random.default_rng(11)
    a1 = rand_pulse_arrays(2, 3, n_nops=2, local_rng=local)
    a2 = rand_pulse_arrays(2, 4, n_nops=2, local_rng=local)
    a1[4][:] = ['a', 'b']
    a2[4][:] = ['a', 'c']
    a2[3][0] = a1[3][0]
    a1[5][:] = a1[5][:, :1]
    a2[5][:] = a2[5][:, :1]
    a2[5][0] = a1[5][0][0]
    (j1, p1), (j2, p2) = _both(a1), _both(a2)
    for p in (j1, j2, p1, p2):
        p.cache_filter_function(omega)
    jc, c = ff.concatenate([j1, j2]), fft.concatenate([p1, p2])
    _same_pulse(c, jc)
    _same_caches(c, jc)
    assert list(c.n_oper_identifiers) == ['a', 'b', 'c']
    _close(c.get_filter_function(omega), jc.get_filter_function(omega))
    scratch = fft.concatenate_without_filter_function([p1, p2])
    _close(c.get_filter_function(omega), scratch.get_filter_function(omega))


@pytest.mark.parametrize('repeats', [1, 2, 7, 20])
def test_periodic_vs_standard(repeats):
    """concatenate_periodic against concatenate([p] * repeats) (the same
    closed form), against the general path on per-position copies
    (1e-10 absolute as in JAX's test, measured <= 3e-13) and against
    JAX's concatenate_periodic (1e-12 relative, 1e-11 at 20)."""
    omega = np.linspace(0.1, 10, 25)
    jp, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(12)))
    jp.cache_filter_function(omega)
    p.cache_filter_function(omega)
    per = fft.concatenate_periodic(p, repeats)
    jper = ff.concatenate_periodic(jp, repeats)
    _same_pulse(per, jper)
    _same_caches(per, jper)
    _close(per.get_filter_function(omega), jper.get_filter_function(omega),
           1e-11 if repeats == 20 else 1e-12)
    if repeats > 1:
        std = fft.concatenate([p] * repeats)
        assert torch.equal(std.get_filter_function(omega),
                           per.get_filter_function(omega))
        general = fft.concatenate([copy.copy(p) for _ in range(repeats)])
        np.testing.assert_allclose(general.get_filter_function(omega).numpy(),
                                   per.get_filter_function(omega).numpy(),
                                   rtol=0, atol=1e-10)
    flag = fft.concatenate_periodic(p, 5, check_invertible=False)
    assert torch.equal(flag.get_filter_function(omega),
                       fft.concatenate_periodic(p, 5).get_filter_function(
                           omega))


def test_periodic_without_cache_and_type_error():
    """Without a cached control matrix concatenate_periodic only tiles
    the Hamiltonian; anything but a pulse raises TypeError."""
    jp, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(13)))
    per, jper = fft.concatenate_periodic(p, 4), ff.concatenate_periodic(jp, 4)
    _same_pulse(per, jper)
    _same_caches(per, jper)
    assert not per.is_cached('filter_function')
    with pytest.raises(TypeError, match='Can only concatenate'):
        fft.concatenate_periodic('pulse', 3)


def test_concatenate_spin_echo_caching_byproducts():
    """Two spin echos, only the first cached, concatenate to the CPMG
    pulse built directly: equal pulses, the byproducts (total phases,
    total propagator, its Liouville representation) cached on inputs and
    output as in JAX, filter function within rtol 1e-11 of the CPMG
    pulse's; with nothing cached, ``calc_filter_function=True`` and
    *omega* compute it from scratch."""
    tau, tau_pi, omega = 10, 1e-4, np.logspace(-1, 2, 60)
    H_c_SE, dt_SE = generate_dd_hamiltonian(1, tau=tau, tau_pi=tau_pi,
                                            dd_type='cpmg')
    H_n_SE = [[sigma[3], np.ones_like(dt_SE)]]
    H_c_CPMG, dt_CPMG = generate_dd_hamiltonian(2, tau=2 * tau,
                                                tau_pi=tau_pi, dd_type='cpmg')
    H_n_CPMG = [[sigma[3], np.ones_like(dt_CPMG)]]
    jse_1, se_1 = _both_from(H_c_SE, H_n_SE, dt_SE)
    jse_2, se_2 = _both_from(H_c_SE, H_n_SE, dt_SE)
    _, cpmg = _both_from(H_c_CPMG, H_n_CPMG, dt_CPMG)
    se_1.cache_filter_function(omega)
    jse_1.cache_filter_function(omega)
    cpmg.cache_filter_function(omega)
    combined, jcombined = se_1 @ se_2, jse_1 @ jse_2
    _same_caches(combined, jcombined)
    _same_caches(se_2, jse_2)
    for p in (se_1, cpmg, combined):
        assert p.is_cached('total_phases')
        assert p.is_cached('total_propagator')
        assert p.is_cached('total_propagator_liouville')
    assert combined == cpmg
    want = cpmg.get_filter_function(omega).numpy()
    np.testing.assert_allclose(combined.get_filter_function(omega).numpy(),
                               want, rtol=1e-11, atol=1e-16)
    _close(combined.get_filter_function(omega),
           jcombined.get_filter_function(omega), 1e-11)

    _, se_3 = _both_from(H_c_SE, H_n_SE, dt_SE)
    _, se_4 = _both_from(H_c_SE, H_n_SE, dt_SE)
    combined2 = fft.concatenate([se_3, se_4], omega=omega,
                                calc_filter_function=True)
    assert combined2.is_cached('filter function')
    np.testing.assert_allclose(combined2.get_filter_function(omega).numpy(),
                               want, rtol=1e-11, atol=1e-16)


@pytest.mark.parametrize('calc,cache_first,cache_second,give_omega', [
    (None, False, False, False), (None, True, False, False),
    (None, True, True, False), (None, False, False, True),
    (True, True, False, False), (True, False, False, True),
    (False, True, True, False), (False, True, True, True)])
def test_cache_decisions_match_jax(calc, cache_first, cache_second,
                                   give_omega):
    """The decision table of concatenate (is the filter function
    computed, from what, and which byproducts are cached) over
    calc_filter_function, which parts are cached and whether omega is
    given: the same caches as JAX after each call, and the same filter
    function where one is cached."""
    omega = np.linspace(0.1, 10, 15)
    (j1, p1), (j2, p2) = map(_both, _shared_noise_arrays(2, 2, 3, 14))
    for cached, pair in ((cache_first, (j1, p1)), (cache_second, (j2, p2))):
        if cached:
            for p in pair:
                p.cache_filter_function(omega)
    kw = dict(calc_filter_function=calc,
              omega=omega if give_omega else None)
    jc, c = ff.concatenate([j1, j2], **kw), fft.concatenate([p1, p2], **kw)
    _same_caches(c, jc)
    if c.is_cached('filter_function'):
        _close(c.get_filter_function(omega), jc.get_filter_function(omega))


def test_forced_filter_function_without_frequencies_raises():
    """calc_filter_function=True without omega and without cached
    frequencies raises the JAX package's ValueError; so do unequal cached
    frequencies, also for the pulse-correlation filter function."""
    omega = np.linspace(0.1, 10, 15)
    (_, p1), (_, p2) = map(_both, _shared_noise_arrays(2, 2, 3, 15))
    with pytest.raises(ValueError, match='forced'):
        fft.concatenate([p1, p2], calc_filter_function=True)
    p1.cache_filter_function(omega)
    p2.cache_filter_function(omega + 1)
    with pytest.raises(ValueError, match='forced'):
        fft.concatenate([p1, p2], calc_pulse_correlation_FF=True)
    quiet = fft.concatenate([p1, p2])
    assert not quiet.is_cached('filter_function')
    assert quiet.is_cached('total_propagator')
    with pytest.raises(ValueError, match='Invalid value for which'):
        fft.concatenate([p1, p2], which='foo')


def test_non_hermitian_basis_complex_transfer_matrices():
    """With a non-Hermitian basis (normalized matrix units) the total
    propagators' Liouville representations are complex, and so are K5's
    transfer matrices: the concatenated filter function is JAX's (1e-12,
    measured 2e-15), and the periodic closed form agrees with the general
    path (1e-12).  (The concatenation rule assumes a Hermitian basis: in
    both packages the result differs from the from-scratch one here, so
    that comparison is not made.)"""
    d = 2
    units = np.zeros((d * d, d, d), complex)
    for i in range(d):
        for j in range(d):
            units[i * d + j, i, j] = 1.0
    omega = np.linspace(0.1, 10, 15)
    rng = np.random.default_rng(16)
    pairs = []
    for _ in range(3):
        H_c = [[X, rng.standard_normal(3), 'X'],
               [Y, rng.standard_normal(3), 'Y']]
        H_n = [[Z, rng.random(3), 'Z'], [X, rng.random(3), 'Xn']]
        pairs.append(_both_from(H_c, H_n, 1 - rng.random(3), units))
    jps, ps = zip(*pairs)
    assert not ps[0].basis.isherm
    for p in jps + ps:
        p.cache_filter_function(omega)
    assert ps[0].total_propagator_liouville.is_complex()
    jc, c = ff.concatenate(jps), fft.concatenate(ps)
    _same_caches(c, jc)
    _close(c.get_filter_function(omega), jc.get_filter_function(omega))
    per = fft.concatenate_periodic(ps[0], 5)
    general = fft.concatenate([copy.copy(ps[0]) for _ in range(5)])
    _close(per.get_filter_function(omega),
           general.get_filter_function(omega))


def test_parts_on_different_devices_raise():
    """The concatenated pulse lives on the device of its parts; parts on
    different devices raise."""
    _, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(17)))
    elsewhere = fft.PulseSequence.from_arrays(
        *(getattr(p, f) for f in convert.PULSE_FIELDS), basis=p.basis,
        device='meta')
    with pytest.raises(ValueError, match='different devices'):
        fft.concatenate([p, elsewhere])
    with pytest.raises(ValueError, match='different devices'):
        p @ elsewhere


# -----------------------------------------------------------------------------
# second order
# -----------------------------------------------------------------------------
def _second_order_pairs(seg_counts, seed, omega):
    rng = np.random.default_rng(seed)
    base = rand_pulse_arrays(2, 1, local_rng=rng)
    pairs = []
    for n_dt in seg_counts:
        arr = rand_pulse_arrays(2, n_dt, local_rng=rng)
        n_coeffs = np.broadcast_to(base[5][:, :1], arr[5].shape).copy()
        pairs.append(_both((arr[0], arr[1], arr[2], base[3], base[4],
                            n_coeffs, arr[6])))
    for pair in pairs:
        for p in pair:
            p.get_control_matrix(omega, cache_intermediates=True)
            p.get_filter_function(omega, order=2, cache_intermediates=True)
    return zip(*pairs)


@pytest.mark.parametrize('seg_counts,pc', [
    ((2, 2), False), ((2, 2, 2), True),
    (tuple(1 + i % 3 for i in range(16)), False)],
    ids=['two', 'three_pc', 'sixteen_ragged'])
def test_second_order_concatenation(seg_counts, pc):
    """calc_second_order_FF on 2, 3 and 16 (ragged segment counts)
    pulses: the second-order filter function is JAX's (1e-12, measured
    <= 8e-15) and the from-scratch one of the merged pulse (1e-12); the
    first-order one too; with the pulse-correlation flag the control
    matrix keeps its summands; same caches as JAX."""
    omega = np.linspace(0.5, 5, 7)
    jps, ps = _second_order_pairs(seg_counts, 18, omega)
    kw = dict(calc_second_order_FF=True, calc_pulse_correlation_FF=pc)
    jc, c = ff.concatenate(jps, **kw), fft.concatenate(ps, **kw)
    _same_caches(c, jc)
    assert c.is_cached('control_matrix_pc') == pc
    got = c.get_filter_function(omega, order=2)
    _close(got, jc.get_filter_function(omega, order=2))
    _close(c.get_filter_function(omega), jc.get_filter_function(omega))
    scratch = fft.concatenate_without_filter_function(ps)
    _close(got, scratch.get_filter_function(omega, order=2))


def test_second_order_with_different_n_opers_warns():
    """Second order with pulses whose noise operators differ warns and
    falls back to first order, as in JAX."""
    omega = np.linspace(0.5, 5, 7)
    H_c = [[X, [1.0, 0.3], 'X']]
    _, a = _both_from(H_c, [[Z, [1.0, 1.0], 'Z'], [Y, [0.5, 0.5], 'Y']],
                      [1.0, 0.5])
    _, b = _both_from(H_c, [[Z, [1.0, 1.0], 'Z']], [1.0, 0.5])
    for p in (a, b):
        p.cache_filter_function(omega)
    with pytest.warns(UserWarning, match='Second order FF requested'):
        c = fft.concatenate([a, b], calc_second_order_FF=True)
    assert c.is_cached('filter_function')
    assert not c.is_cached('filter_function_2')


# -----------------------------------------------------------------------------
# Hamiltonian merging
# -----------------------------------------------------------------------------
def test_same_oper_different_id_errors():
    _, a = _both_from([[X, [1.0], 'X1']], [[Z, [1.0], 'Z']], [1.0])
    _, b = _both_from([[X, [1.0], 'X2']], [[Z, [1.0], 'Z']], [1.0])
    with pytest.raises(ValueError, match='different identifiers'):
        fft.concatenate_without_filter_function([a, b])


def test_same_id_different_oper_suffixed():
    ja, a = _both_from([[X, [1.0], 'ctrl']], [[Z, [1.0], 'Z']], [1.0])
    jb, b = _both_from([[Y, [1.0], 'ctrl']], [[Z, [1.0], 'Z']], [1.0])
    c, cmap, nmap = fft.concatenate_without_filter_function(
        [a, b], return_identifier_mappings=True)
    jc, jcmap, jnmap = ff.concatenate_without_filter_function(
        [ja, jb], return_identifier_mappings=True)
    assert sorted(c.c_oper_identifiers.tolist()) == ['ctrl_0', 'ctrl_1']
    _same_pulse(c, jc)
    assert cmap == jcmap and nmap == jnmap


def test_sensitivity_inference():
    """A constant sensitivity is inferred for the pulse that lacks the
    operator; a non-constant one raises."""
    ja, a = _both_from([[X, [1.0], 'X']],
                       [[Z, [1.0], 'Z'], [Y, [0.5], 'Y']], [1.0])
    jb, b = _both_from([[X, [2.0], 'X']], [[Z, [1.0], 'Z']], [1.0])
    c = fft.concatenate_without_filter_function([a, b])
    _same_pulse(c, ff.concatenate_without_filter_function([ja, jb]))
    y_row = c.n_coeffs[list(c.n_oper_identifiers).index('Y')]
    np.testing.assert_array_equal(y_row, [0.5, 0.5])
    _, a2 = _both_from([[X, [1.0, 1.0], 'X']],
                       [[Z, [1.0, 1.0], 'Z'], [Y, [0.5, 0.7], 'Y']],
                       [1.0, 1.0])
    with pytest.raises(ValueError, match='cannot infer'):
        fft.concatenate_without_filter_function([a2, b])


def test_concatenate_type_and_shape_errors():
    rng = np.random.default_rng(19)
    _, p = _both(rand_pulse_arrays(2, 2, local_rng=rng))
    _, q = _both(rand_pulse_arrays(3, 2, local_rng=rng))
    with pytest.raises(TypeError, match='iterable'):
        fft.concatenate_without_filter_function(42)
    with pytest.raises(TypeError, match='Can only concatenate'):
        fft.concatenate_without_filter_function([p, 'not a pulse'])
    with pytest.raises(ValueError, match='different dimension'):
        fft.concatenate_without_filter_function([p, q])
    ggm, pauli = (make_pulse(rand_pulse_arrays(4, 2, local_rng=rng),
                             btype=btype, cls=fft_cpu)
                  for btype in ('GGM', 'Pauli'))
    with pytest.raises(ValueError, match='different bases'):
        fft.concatenate_without_filter_function([ggm, pauli])


def test_single_pulse_concatenate_is_copy():
    """concatenate([p]) is a copy: equal, another object, and with caches
    of its own, so clearing or refilling them leaves the source's."""
    _, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(20)))
    omega = np.linspace(0.1, 10, 9)
    p.cache_filter_function(omega)
    c = fft.concatenate([p])
    assert c == p and c is not p
    assert c.is_cached('filter_function')
    for name in ('_data', '_frequency_data', '_intermediates', '_dev'):
        assert getattr(c, name) is not getattr(p, name)
    c.cleanup('all')
    c.c_opers_dev
    assert p.is_cached('filter_function') and p.is_cached('eigvals')
    c.cache_filter_function(omega + 1)
    assert torch.equal(p.omega, torch.tensor(omega))


def test_uniform_train_equals_general_and_scratch():
    """concatenate([p] * 6) takes the closed form; it agrees with the
    general path on distinct copies and with from scratch (1e-10
    absolute as in JAX's test), and with JAX (1e-12 relative)."""
    omega = np.linspace(0.1, 10, 25)
    jp, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(21)))
    jp.cache_filter_function(omega)
    p.cache_filter_function(omega)
    G = 6
    fast, jfast = fft.concatenate([p] * G), ff.concatenate([jp] * G)
    _same_pulse(fast, jfast)
    _same_caches(fast, jfast)
    _close(fast.get_filter_function(omega), jfast.get_filter_function(omega))
    general = fft.concatenate([copy.deepcopy(p) for _ in range(G)])
    scratch = fft.concatenate_without_filter_function([p] * G)
    for other in (general, scratch):
        np.testing.assert_allclose(fast.get_filter_function(omega).numpy(),
                                   other.get_filter_function(omega).numpy(),
                                   rtol=0, atol=1e-10)
    assert fast.dt.shape == (3 * G,)
    assert fast.tau == pytest.approx(G * p.tau)
    np.testing.assert_allclose(fast.total_propagator.numpy(),
                               general.total_propagator.numpy(), atol=1e-12)


def test_uniform_train_decision_semantics():
    """The uniform branch takes the general path's decisions, as in
    JAX: same caches after each call."""
    omega = np.linspace(0.1, 10, 25)
    jp, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(22)))
    _same_caches(fft.concatenate([p] * 4), ff.concatenate([jp] * 4))
    assert not fft.concatenate([p] * 4).is_cached('filter_function')
    with pytest.raises(ValueError, match='forced'):
        fft.concatenate([p] * 4, calc_filter_function=True)
    out = fft.concatenate([p] * 4, calc_filter_function=True, omega=omega)
    assert out.is_cached('filter_function')
    p.cache_filter_function(omega)
    jp.cache_filter_function(omega)
    out = fft.concatenate([p] * 4, calc_filter_function=False)
    _same_caches(out, ff.concatenate([jp] * 4, calc_filter_function=False))
    assert not out.is_cached('filter_function')
    assert out.is_cached('total_propagator')
    out = fft.concatenate([p] * 4)
    _same_caches(out, ff.concatenate([jp] * 4))
    assert out.is_cached('filter_function')


def test_uniform_train_mappings():
    _, p = _both(rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(23)))
    newpulse, cmap, nmap = fft.concatenate_without_filter_function(
        [p] * 5, return_identifier_mappings=True)
    assert set(cmap) == set(range(5)) and set(nmap) == set(range(5))
    for i in range(5):
        assert cmap[i] == {str(s): str(s) for s in p.c_oper_identifiers}
        assert nmap[i] == {str(s): str(s) for s in p.n_oper_identifiers}
    assert newpulse.dt.shape == (15,)


# -----------------------------------------------------------------------------
# pulse correlations
# -----------------------------------------------------------------------------
@pytest.fixture
def px_py():
    omega = np.linspace(-20, 20, 60)
    H_n = [[X, [1]], [Y, [1]], [Z, [1]]]
    jpx, px = _both_from([[X, [np.pi / 2]]], H_n, [1])
    jpy, py = _both_from([[Y, [np.pi / 4]]], H_n, [1])
    for p in (jpx, px, jpy, py):
        p.cache_filter_function(omega)
    return omega, (jpx, jpy), (px, py)


@pytest.mark.parametrize('which', ['fidelity', 'generalized'])
def test_pc_caching_and_consistency(px_py, which):
    """The pulse-correlation caches after concatenate(which=...) are
    JAX's; the filter function has the shape (2, 2, 3, 3[, 4, 4], n_w),
    real diagonal blocks, sums to the total, traces to the fidelity one,
    and is JAX's (1e-12, measured 3e-16)."""
    omega, jpulses, pulses = px_py
    kw = dict(calc_pulse_correlation_FF=True, which=which)
    jc, c = ff.concatenate(jpulses, **kw), fft.concatenate(pulses, **kw)
    _same_caches(c, jc)
    assert c.is_cached('control_matrix_pc')
    assert c == pulses[0] @ pulses[1]
    f_pc = c.get_pulse_correlation_filter_function(which)
    _close(f_pc, jc.get_pulse_correlation_filter_function(which))
    fid = c.get_pulse_correlation_filter_function('fidelity')
    assert fid.shape == (2, 2, 3, 3, len(omega))
    if which == 'generalized':
        assert f_pc.shape == (2, 2, 3, 3, 4, 4, len(omega))
        _close(torch.diagonal(f_pc, 0, 4, 5).sum(-1), fid, 1e-13)
    assert fid[0, 0].diagonal().imag.abs().max() < 1e-14
    np.testing.assert_allclose(
        fid.sum((0, 1)).numpy(),
        (pulses[0] @ pulses[1]).get_filter_function(omega).numpy(),
        rtol=0, atol=1e-12)
    cm_pc = c.get_pulse_correlation_control_matrix()
    _close(numeric.calculate_pulse_correlation_filter_function(cm_pc, which),
           f_pc, 1e-14)


def test_pc_not_computed_raises_and_seeding(px_py):
    """Without the flag the pulse-correlation quantities raise
    CalculationError; a cleaned pulse seeded with the pulse-correlation
    control matrix fills every alias, as in JAX."""
    omega, _, (px, py) = px_py
    plain = px @ py
    with pytest.raises(ValueError):
        numeric.calculate_pulse_correlation_filter_function(
            plain.get_control_matrix(omega))
    with pytest.raises(util.CalculationError):
        plain.get_pulse_correlation_control_matrix()
    with pytest.raises(util.CalculationError):
        fft.infidelity(plain, np.ones_like(omega), omega,
                       which='correlations')
    gen = fft.concatenate([px, py], calc_pulse_correlation_FF=True,
                          which='generalized')
    plain.cleanup('all')
    plain.cache_filter_function(
        omega, control_matrix=gen.get_pulse_correlation_control_matrix(),
        which='generalized')
    for alias in ('pulse correlation control matrix',
                  'generalized pulse correlation filter function',
                  'pulse correlation filter function',
                  'generalized filter function', 'filter function'):
        assert plain.is_cached(alias), alias
    _close(plain.get_filter_function(omega), gen.get_filter_function(omega),
           1e-13)


def test_correlation_infidelities_decompose(px_py):
    """Correlation infidelities for selected identifiers: the diagonal
    blocks are the single pulses' infidelities, everything sums to the
    total (rtol 1e-10), for a flat and for a cross-correlated spectrum;
    values are JAX's (1e-12 of the largest)."""
    omega, jpulses, (px, py) = px_py
    spectrum = 1e-2 * omega**0
    plain = px @ py
    pc = fft.concatenate([px, py], calc_pulse_correlation_FF=True)
    jpc = ff.concatenate(jpulses, calc_pulse_correlation_FF=True)
    ids = ['B_0', 'B_2']
    kw = dict(n_oper_identifiers=ids)
    i_corr = fft.infidelity(pc, spectrum, omega, which='correlations', **kw)
    _close(i_corr, ff.infidelity(jpc, spectrum, omega, which='correlations',
                                 **kw))
    i_tot = fft.infidelity(plain, spectrum, omega, **kw)
    np.testing.assert_allclose(i_corr.sum().item(), i_tot.sum().item(),
                               rtol=1e-10)
    np.testing.assert_allclose(i_corr[0, 0].numpy(), fft.infidelity(
        px, spectrum, omega, **kw).numpy(), rtol=1e-10)
    np.testing.assert_allclose(i_corr[1, 1].numpy(), fft.infidelity(
        py, spectrum, omega, **kw).numpy(), rtol=1e-10)
    with np.errstate(divide='ignore'):
        cross = np.array([[1e-4 / (1 + omega**2), 1e-4 * np.exp(-omega**2)],
                          [1e-4 * np.exp(-omega**2), 1e-4 / (1 + omega**2)]])
    i_corr = fft.infidelity(pc, cross, omega, which='correlations', **kw)
    _close(i_corr, ff.infidelity(jpc, cross, omega, which='correlations',
                                 **kw))
    np.testing.assert_allclose(
        i_corr.sum((0, 1)).numpy(),
        fft.infidelity(plain, cross, omega, **kw).numpy(), rtol=1e-10)


# -----------------------------------------------------------------------------
# identifier clashes
# -----------------------------------------------------------------------------
def test_rename_reorders_rows():
    """Renaming 'a' to 'a_0' / 'a_1' sorts after 'a0', so the merged row
    order differs from the cached pulses': rows are scattered by
    position.  Identifiers and filter function are JAX's and the
    from-scratch ones (1e-12, measured 2e-15)."""
    omega = np.linspace(0.5, 5, 9)
    rng_l = np.random.default_rng(5)
    pairs = []
    for nop, dt in ((X, [0.5, 0.6]), (Z, [0.4, 0.7])):
        pairs.append(_both_from(
            [[X, rng_l.standard_normal(2), 'c']],
            [[nop, [1.0, 1.0], 'a'], [Y, [0.5, 0.5], 'a0']], dt))
    jps, ps = zip(*pairs)
    for p in jps + ps:
        p.cache_filter_function(omega)
    jc, c = ff.concatenate(jps), fft.concatenate(ps)
    _same_pulse(c, jc)
    assert list(c.n_oper_identifiers) == ['a0', 'a_0', 'a_1']
    _close(c.get_filter_function(omega), jc.get_filter_function(omega))
    scratch = fft.concatenate_without_filter_function(ps)
    _close(c.get_filter_function(omega), scratch.get_filter_function(omega))


def test_three_pulse_shared_clash():
    """Pulses 0 and 1 name X 'a', pulse 2 names Z 'a': every pulse's
    mapping is renamed, not only the first's."""
    omega = np.linspace(0.5, 5, 9)
    rng_l = np.random.default_rng(6)
    pairs = []
    for nop in (X, X, Z):
        pairs.append(_both_from(
            [[X, rng_l.standard_normal(2), 'c']],
            [[nop, [1.0, 1.0], 'a'], [Y, [0.5, 0.5], 'b']], [0.5, 0.5]))
    jps, ps = zip(*pairs)
    for p in jps + ps:
        p.cache_filter_function(omega)
    c, _, nmap = fft.concatenate_without_filter_function(
        ps, return_identifier_mappings=True)
    _, _, jnmap = ff.concatenate_without_filter_function(
        jps, return_identifier_mappings=True)
    assert nmap == jnmap
    assert nmap[1]['a'] == 'a_0' and nmap[2]['a'] == 'a_2'
    full = fft.concatenate(ps)
    _same_pulse(full, ff.concatenate(jps))
    _close(full.get_filter_function(omega), c.get_filter_function(omega))


# -----------------------------------------------------------------------------
# golden pulses
# -----------------------------------------------------------------------------
@pytest.mark.skipif(not HAVE_REFERENCE, reason='needs golden data')
def test_hadamard_concatenation_golden():
    """Hadamard = Y2 @ X2 @ X2 from the optimized pi/2 pulses: first-
    and second-order filter functions of the concatenation are JAX's
    (1e-9 of the largest entry)."""
    from testutil import x2y2_single_qubit
    pairs = {gate: _both_from(*x2y2_single_qubit(gate))
             for gate in ('X2ID', 'Y2ID')}
    omega = np.linspace(0, 1e2 / pairs['X2ID'][1].tau, 64)
    for pair in pairs.values():
        for p in pair:
            p.cache_filter_function(omega, cache_intermediates=True, order=1)
            p.cache_filter_function(omega, cache_intermediates=True, order=2)
    order = ('Y2ID', 'X2ID', 'X2ID')
    kw = dict(calc_pulse_correlation_FF=True, calc_second_order_FF=True)
    jc = ff.concatenate([pairs[g][0] for g in order], **kw)
    c = fft.concatenate([pairs[g][1] for g in order], **kw)
    _close(c.get_pulse_correlation_filter_function(),
           jc.get_pulse_correlation_filter_function(), 1e-9)
    _close(c.get_filter_function(omega, order=2),
           jc.get_filter_function(omega, order=2), 1e-9)


# -----------------------------------------------------------------------------
# long trains
# -----------------------------------------------------------------------------
def _mixed_train(mod, n_train=100, seed=11, conflicting=False, **kw):
    """A train drawn from 6 distinct pulses of 1-3 segments that share
    their operator arrays; pulses 2 and 5 lack noise operator 'b', the
    others carry it at the constant 1.0 (inferable) or at conflicting
    constants."""
    rng_l = np.random.default_rng(seed)
    c_opers = rand_herm_traceless(2, 2, rng_l)
    n_opers = rand_herm_traceless(2, 2, rng_l)
    basis = mod.Basis.ggm(2)
    distinct = []
    for k, n_dt in enumerate([1, 2, 3, 2, 1, 3]):
        c_coeffs = rng_l.standard_normal((2, n_dt))
        nops = [[n_opers[0], np.ones(n_dt), 'a']]
        if k not in (2, 5):
            nops.append([n_opers[1],
                         np.full(n_dt, (2.0 + k) if conflicting else 1.0),
                         'b'])
        distinct.append(mod.PulseSequence(
            [[c_opers[0], c_coeffs[0], 'X'], [c_opers[1], c_coeffs[1], 'Y']],
            nops, 1 - rng_l.random(n_dt), basis, **kw))
    idx = rng_l.integers(0, len(distinct), size=n_train)
    idx[:2] = [2, 5]
    return [distinct[i] for i in idx], distinct


def test_few_distinct_union_matches_general():
    """The union over the distinct pulses of a 100-position train equals
    the general path on per-position copies and JAX's: identifiers,
    coefficient grids (the missing sensitivity inferred as 1.0) and
    durations bit for bit, and the identifier mappings."""
    train, _ = _mixed_train(fft, device='cpu')
    jtrain, _ = _mixed_train(ff)
    fast, cmap_f, nmap_f = fft.concatenate_without_filter_function(
        train, return_identifier_mappings=True)
    general, cmap_g, nmap_g = fft.concatenate_without_filter_function(
        [copy.deepcopy(p) for p in train], return_identifier_mappings=True)
    _same_pulse(fast, general)
    _same_pulse(fast, ff.concatenate_without_filter_function(jtrain))
    assert dict(cmap_f) == dict(cmap_g) and dict(nmap_f) == dict(nmap_g)
    b_row = list(fast.n_oper_identifiers).index('b')
    assert np.all(fast.n_coeffs[b_row] == 1.0)
    train, _ = _mixed_train(fft, conflicting=True, device='cpu')
    with pytest.raises(ValueError, match='cannot infer'):
        fft.concatenate_without_filter_function(train)


def test_stack_gathers_distinct_tensors():
    """sequencing._stack of a list that repeats few tensors equals
    torch.stack, bit for bit."""
    rng_l = np.random.default_rng(5)
    base = [torch.tensor(rng_l.standard_normal((3, 3))
                         + 1j * rng_l.standard_normal((3, 3)))
            for _ in range(8)]
    items = [base[i] for i in rng_l.integers(0, 8, size=100)]
    assert torch.equal(sequencing._stack(items), torch.stack(items))
    assert torch.equal(sequencing._stack(base), torch.stack(base))


def test_full_concatenate_mixed_train_at_scale():
    """concatenate with cached filter functions over the 100-position
    mixed train (the union over distinct pulses, the gathered stacks, the
    rows from scratch for the missing operator, the scan of 99 transfer
    matrices, K5) against from scratch on the merged pulse (1e-9 as in
    JAX's test, measured 4e-13) and against JAX (1e-10 of the largest
    entry)."""
    train, distinct = _mixed_train(fft, device='cpu')
    jtrain, jdistinct = _mixed_train(ff)
    omega = np.linspace(0.1, 10, 21)
    for p in distinct + jdistinct:
        p.cache_filter_function(omega)
    fast, jfast = fft.concatenate(train), ff.concatenate(jtrain)
    _same_pulse(fast, jfast)
    _same_caches(fast, jfast)
    _close(fast.get_filter_function(omega), jfast.get_filter_function(omega),
           1e-10)
    scratch = fft.concatenate_without_filter_function(train)
    np.testing.assert_allclose(fast.get_filter_function(omega).numpy(),
                               scratch.get_filter_function(omega).numpy(),
                               rtol=1e-9, atol=1e-9)


def test_long_train_matches_short_train_code_path():
    """A 90-position train of 6 distinct cached pulses goes through the
    long-train code (stacks gathered from the distinct tensors, union
    over distinct pulses); with per-position copies it goes through the
    code a train of 90 distinct pulses takes.  Control matrix, filter
    function, total
    propagator, its Liouville representation and the total phases agree
    within 1e-10 / 1e-12 (JAX holds its fused train to its eager path by
    the same bounds)."""
    rng_l = np.random.default_rng(23)
    omega = np.geomspace(0.1, 10, 17)
    distinct = []
    for n_dt in (1, 2, 3, 2, 1, 3):
        c = np.pi * rng_l.standard_normal((2, n_dt))
        p = fft.PulseSequence(
            [[X / 2, c[0], 'X'], [Y / 2, c[1], 'Y']],
            [[Z / 2, np.ones(n_dt), 'Z']], 0.5 + rng_l.random(n_dt),
            device='cpu')
        p.cache_filter_function(omega)
        distinct.append(p)
    train = [distinct[i] for i in rng_l.integers(0, 6, size=90)]
    long = fft.concatenate(train)
    short = fft.concatenate([copy.deepcopy(p) for p in train])
    for rel, name in ((1e-10, 'control_matrix'), (1e-10, 'filter_function'),
                      (1e-12, 'total_propagator'),
                      (1e-12, 'total_propagator_liouville'),
                      (1e-12, 'total_phases')):
        store = long._data if name in long._data else long._frequency_data
        other = short._data if name in short._data else short._frequency_data
        _close(store[name], other[name], rel)


def test_ten_thousand_pulse_train():
    """10^4 NOT pulses (d = 2, 40 frequencies up to omega = 100): the
    closed form of concatenate([p] * 10^4) is concatenate_periodic's,
    bit for bit; the general path on the alternating train [p, q] * 5000
    of two objects (boundary phases e^{i w cumsum(tau)} at 10^4
    boundaries, scan of 9999 transfer matrices, K5 over (g, k) jointly)
    agrees with it within 1e-8 of the largest entry (measured 3e-11),
    and the Hamiltonian of the merged pulse is the tiled one."""
    omega = np.geomspace(1e-2, 1e2, 40)
    p = fft.PulseSequence([[X / 2, [np.pi], 'X']], [[Z / 2, [1], 'Z']], [1],
                          device='cpu')
    p.cache_filter_function(omega)
    n = 10_000
    per = fft.concatenate_periodic(p, n)
    uniform = fft.concatenate([p] * n)
    assert torch.equal(uniform.get_filter_function(omega),
                       per.get_filter_function(omega))
    q = copy.copy(p)
    general = fft.concatenate([p, q] * (n // 2))
    assert len(general) == n and general.tau == n
    np.testing.assert_array_equal(general.c_coeffs, per.c_coeffs)
    assert torch.isfinite(general.get_filter_function(omega)).all()
    _close(general.get_filter_function(omega),
           per.get_filter_function(omega), 1e-8)
    unitary = per.total_propagator @ per.total_propagator.mH
    np.testing.assert_allclose(unitary.numpy(), np.eye(2), atol=1e-10)


def test_no_warnings_on_the_plain_paths():
    """Concatenation of cached pulses raises no warning."""
    omega = np.linspace(0.1, 10, 9)
    _, ps = zip(*map(_both, _shared_noise_arrays(2, 2, 3, 24)))
    for p in ps:
        p.cache_filter_function(omega)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        fft.concatenate(ps)
        fft.concatenate_periodic(ps[0], 3)
        fft.concatenate(ps, calc_pulse_correlation_FF=True)
