"""The port's composition kernels (filter_functions_tpu_torch.numeric: K5
control matrix from atomic pulses, its uniform form, K6 periodic, K7
noise operators, K11 second-order concatenation rule, and the series
helpers of util) against the JAX package's functions on the same numpy
inputs from seeded generators.

Sizes: d <= 4, <= 12 frequencies, <= 80 pulses.  Both sides are
complex128 products summed in another order; every bound is relative to
the largest entry of the JAX result (``_close``), 1e-12 unless stated,
and the measured value stands in each docstring.
"""
import numpy as np
import pytest
import torch

from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu.cplx import asc
from filter_functions_tpu_torch import basis as tbasis
from filter_functions_tpu_torch import config, numeric, sequencing, util
from testutil import make_pulse, rand_pulse_arrays
from torch_testutil import fft_cpu


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _close(got, want, rel=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _crand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _atomic_inputs(G, complex_props, seed=0, n_nops=2, d2=4, n_w=7):
    rng = np.random.default_rng(seed)
    phases = np.exp(1j * rng.standard_normal((G - 1, n_w)))
    ctrl = _crand(rng, G, n_nops, d2, n_w)
    props = (_crand(rng, G - 1, d2, d2) if complex_props
             else rng.standard_normal((G - 1, d2, d2)))
    return phases, ctrl, props


# -----------------------------------------------------------------------------
# K5
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('which', ['total', 'correlations'])
@pytest.mark.parametrize('complex_props', [False, True])
@pytest.mark.parametrize('G', [5, 80])
def test_control_matrix_from_atomic_matches_jax(G, complex_props, which):
    """K5 below and above the JAX package's 64-pulse switch (the port has
    one form for every G), with real and complex transfer matrices,
    'total' and 'correlations': within 1e-12 of JAX's largest entry
    (measured <= 9.3e-16); numpy and tensor arguments give the same
    bits."""
    phases, ctrl, props = _atomic_inputs(G, complex_props)
    want = jnumeric.calculate_control_matrix_from_atomic(
        asc(phases), asc(ctrl), asc(props) if complex_props else props,
        which=which)
    got = numeric.calculate_control_matrix_from_atomic(
        phases, ctrl, props, which=which)
    assert got.dtype == config.COMPLEX
    assert got.shape == (ctrl.shape[1:] if which == 'total' else ctrl.shape)
    _close(got, want)
    again = numeric.calculate_control_matrix_from_atomic(
        torch.tensor(phases), torch.tensor(ctrl), torch.tensor(props),
        which=which)
    assert torch.equal(got, again)


@pytest.mark.parametrize('complex_props', [False, True])
def test_control_matrix_from_atomic_chunks(complex_props):
    """'total' accumulated in chunks of pulses (a 2 kB budget: 1 pulse
    per chunk, against all 79 at once): within 1e-13 of the largest entry
    (measured 6.4e-16); a wrong *which* raises."""
    phases, ctrl, props = _atomic_inputs(80, complex_props, seed=1)
    whole = numeric.calculate_control_matrix_from_atomic(phases, ctrl, props)
    chunked = numeric.calculate_control_matrix_from_atomic(
        phases, ctrl, props, budget_bytes=2000)
    _close(chunked, whole, 1e-13)
    with pytest.raises(ValueError, match='Invalid value for which'):
        numeric.calculate_control_matrix_from_atomic(phases, ctrl, props,
                                                     which='foo')


def test_correlations_sum_to_total():
    """The 'correlations' summands add up to 'total' (1e-13 of the
    largest entry, measured 2.5e-16)."""
    phases, ctrl, props = _atomic_inputs(12, False, seed=2)
    steps = numeric.calculate_control_matrix_from_atomic(
        phases, ctrl, props, which='correlations')
    total = numeric.calculate_control_matrix_from_atomic(phases, ctrl, props)
    _close(steps.sum(0), total, 1e-13)


@pytest.mark.parametrize('complex_props', [False, True])
def test_control_matrix_from_atomic_uniform_matches_jax(complex_props):
    """K5 for identical atomic pulses: within 1e-12 of JAX's (measured
    4.4e-16) and of the general form on the repeated stack (measured
    5.0e-16)."""
    phases, ctrl, props = _atomic_inputs(9, complex_props, seed=3)
    want = jnumeric.calculate_control_matrix_from_atomic_uniform(
        asc(phases), asc(ctrl[0]), asc(props) if complex_props else props)
    got = numeric.calculate_control_matrix_from_atomic_uniform(
        phases, ctrl[0], props)
    _close(got, want)
    general = numeric.calculate_control_matrix_from_atomic(
        phases, np.broadcast_to(ctrl[0], ctrl.shape).copy(), props)
    _close(got, general)


# -----------------------------------------------------------------------------
# K6 and the series helpers
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('repeats', [1, 2, 7, 1000])
def test_control_matrix_periodic_matches_jax(repeats):
    """K6 with an orthogonal transfer matrix: within 1e-12 of JAX's
    largest entry up to 7 repeats (measured <= 5.2e-16) and 1e-11 at 1000
    (measured 2.6e-14: ten doublings each side); chunked over
    frequencies (a 3 kB budget) it gives the same within 1e-14;
    ``check_invertible`` changes nothing."""
    rng = np.random.default_rng(4)
    n_nops, d2, n_w = 2, 4, 9
    phases = np.exp(1j * rng.standard_normal(n_w))
    ctrl = _crand(rng, n_nops, d2, n_w)
    q, _ = np.linalg.qr(rng.standard_normal((d2, d2)))
    want = jnumeric.calculate_control_matrix_periodic(
        asc(phases), asc(ctrl), q, repeats)
    got = numeric.calculate_control_matrix_periodic(phases, ctrl, q, repeats)
    _close(got, want, 1e-11 if repeats == 1000 else 1e-12)
    chunked = numeric.calculate_control_matrix_periodic(
        phases, ctrl, q, repeats, check_invertible=False, budget_bytes=3000)
    _close(chunked, got, 1e-14)


def test_control_matrix_periodic_complex_transfer_matrix():
    """K6 with a complex (unitary) transfer matrix, as a non-Hermitian
    basis gives: within 1e-12 of JAX's (measured 4.1e-16) and of K5 on the
    explicit powers (measured 6.0e-16)."""
    rng = np.random.default_rng(5)
    n_nops, d2, n_w, G = 2, 4, 6, 7
    phases = np.exp(1j * rng.standard_normal(n_w))
    ctrl = _crand(rng, n_nops, d2, n_w)
    q, _ = np.linalg.qr(_crand(rng, d2, d2))
    want = jnumeric.calculate_control_matrix_periodic(
        asc(phases), asc(ctrl), asc(q), G)
    got = numeric.calculate_control_matrix_periodic(phases, ctrl, q, G)
    _close(got, want)
    powers = np.stack([np.linalg.matrix_power(q, g) for g in range(1, G)])
    boundary = np.stack([phases**g for g in range(1, G)])
    explicit = numeric.calculate_control_matrix_from_atomic(
        boundary, np.broadcast_to(ctrl, (G,) + ctrl.shape).copy(), powers)
    _close(got, explicit)


@pytest.mark.parametrize('repeats', [0, 1, 2, 7, 10])
def test_series_helpers(repeats):
    """util.geometric_series and util.matrix_power of a batch of complex
    matrices against the explicit sum and torch's power: 1e-14
    (measured <= 4.4e-16); 0 repeats give the zero sum and the
    identity."""
    torch.manual_seed(0)
    t = torch.randn(5, 3, 3, dtype=torch.complex128) * 0.3
    powers = [torch.linalg.matrix_power(t, g) for g in range(repeats + 1)]
    want = sum(powers[:-1]) if repeats else torch.zeros_like(t)
    np.testing.assert_allclose(util.geometric_series(t, repeats).numpy(),
                               want.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(util.matrix_power(t, repeats).numpy(),
                               powers[-1].numpy(), rtol=0, atol=1e-14)


def test_adot_scan_matches_sequential():
    """The doubling scan of util.adot equals the sequential product
    (1e-13 of the largest entry on 100 near-unitary matrices, measured
    2.3e-16), along any axis."""
    rng = np.random.default_rng(6)
    h = _crand(rng, 100, 3, 3)
    w, v = np.linalg.eigh(h + h.conj().swapaxes(-1, -2))
    mats = torch.tensor(np.einsum('gij,gj,gkj->gik', v, np.exp(1j * w),
                                  v.conj()))
    want = [mats[0]]
    for m in mats[1:]:
        want.append(m @ want[-1])
    _close(util.adot(mats), torch.stack(want), 1e-13)
    batched = mats.reshape(4, 25, 3, 3)
    np.testing.assert_allclose(util.adot(batched, axis=1)[2].numpy(),
                               util.adot(batched[2]).numpy(), atol=1e-13)


# -----------------------------------------------------------------------------
# K7
# -----------------------------------------------------------------------------
def _pair(d, n_dt, seed, **kw):
    arrays = rand_pulse_arrays(d, n_dt, local_rng=np.random.default_rng(seed),
                               **kw)
    return make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


def _noise_operators(p, omega, **kw):
    p.diagonalize()
    return numeric.calculate_noise_operators_from_scratch(
        p.eigvals, p.eigvecs, p.propagators, omega, p.n_opers_dev,
        p.n_coeffs, p.dt, **kw)


@pytest.mark.parametrize('d', [2, 3, 4])
def test_noise_operators_from_scratch_match_jax(d):
    """K7 from scratch on a random pulse of 4 segments at 9 frequencies:
    (n_w, n_nops, d, d) within 1e-12 of JAX's largest entry (measured
    <= 6e-16); its expansion in the basis is the control matrix (1e-12,
    measured 5e-16); the intermediates carry JAX's four keys and
    shapes."""
    jp, p = _pair(d, 4, 10 + d)
    omega = np.linspace(0.5, 5, 9)
    jp.diagonalize()
    want = jnumeric.calculate_noise_operators_from_scratch(
        jp.eigvals, jp.eigvecs, jp.propagators, omega, jp.n_opers_dev,
        jp.n_coeffs, jp.dt)
    got, inter = _noise_operators(p, omega, cache_intermediates=True)
    assert got.shape == (9, 3, d, d)
    _close(got, want)
    coeffs = tbasis.expand(got, p.basis, normalized=p.basis.isnorm)
    _close(coeffs.permute(1, 2, 0), p.get_control_matrix(omega))
    assert set(inter) == {'n_opers_transformed', 'first_order_integral',
                          'phase_factors', 'noise_operators_step'}
    assert inter['noise_operators_step'].shape == (4, 9, 3, d, d)
    _close(inter['noise_operators_step'].sum(0), got, 1e-14)
    _close(_noise_operators(p, torch.tensor(omega)), got, 1e-15)


@pytest.mark.parametrize('d', [2, 3])
def test_noise_operators_from_atomic(d):
    """K7 from the noise operators of the single segments of a 4-segment
    pulse equals K7 from scratch (1e-12 of the largest entry, measured
    4e-16) and JAX's K7 from atomic on the same stacks (measured
    3e-16)."""
    _, p = _pair(d, 4, 20 + d)
    omega = np.linspace(0.5, 5, 7)
    full = _noise_operators(p, omega)
    atomic = torch.stack([_noise_operators(p[g], omega)
                          for g in range(len(p))])
    phases = util.cexp(torch.tensor(p.t[1:-1])[:, None]
                       * torch.tensor(omega))
    boundary = p.propagators[1:-1]
    got = numeric.calculate_noise_operators_from_atomic(phases, atomic,
                                                        boundary)
    _close(got, full)
    want = jnumeric.calculate_noise_operators_from_atomic(
        asc(phases.numpy()), asc(atomic.numpy()), asc(boundary.numpy()))
    _close(got, want)


# -----------------------------------------------------------------------------
# K11
# -----------------------------------------------------------------------------
def _second_order_parts(seg_counts, seed, omega):
    """JAX and port pulses with shared noise operators and constant
    sensitivities, their second-order intermediates cached."""
    rng = np.random.default_rng(seed)
    base = rand_pulse_arrays(2, 1, local_rng=rng)
    jax_pulses, port_pulses = [], []
    for n_dt in seg_counts:
        arr = rand_pulse_arrays(2, n_dt, local_rng=rng)
        n_coeffs = np.broadcast_to(base[5][:, :1], arr[5].shape).copy()
        arrays = (arr[0], arr[1], arr[2], base[3], base[4], n_coeffs, arr[6])
        jax_pulses.append(make_pulse(arrays))
        port_pulses.append(make_pulse(arrays, cls=fft_cpu))
    for p in jax_pulses + port_pulses:
        p.get_control_matrix(omega, cache_intermediates=True)
        p.get_filter_function(omega, order=2, cache_intermediates=True)
    return jax_pulses, port_pulses


def _k11_arguments(pulses, omega):
    """The arguments concatenate hands K11, rebuilt from the port's
    pulses."""
    atomic = torch.stack([p.get_control_matrix(omega) for p in pulses])
    propagators = util.adot(torch.stack([p.total_propagator
                                         for p in pulses]))[:-1]
    liouville = util.adot(torch.stack(
        [p.total_propagator_liouville for p in pulses[:-1]]))
    t_bound = np.cumsum([p.tau for p in pulses[:-1]])
    phases = util.cexp(torch.tensor(t_bound)[:, None] * torch.tensor(omega))
    step = numeric.calculate_control_matrix_from_atomic(
        phases, atomic, liouville, which='correlations')
    return dict(
        basis=pulses[0].basis,
        filter_function_atomic=pulses[0].get_filter_function(omega, order=2),
        control_matrix_atomic=atomic, control_matrix_atomic_step=step,
        control_matrix_atomic_cumulative=step.cumsum(0),
        propagators=propagators, propagators_liouville=liouville,
        intermediates=[p.intermediates for p in pulses])


@pytest.mark.parametrize('seg_counts', [(2, 2, 2), (1, 2, 3, 1, 2, 3, 1)],
                         ids=['equal', 'ragged'])
def test_second_order_from_atomic_matches_jax(seg_counts):
    """K11 on pulses of equal and of ragged segment counts at 7
    frequencies: the port's function on its own pulses' caches is within
    1e-12 of the largest entry of JAX's function on JAX's caches (measured
    <= 5e-15), and of the port's K10 from scratch on the merged pulse
    (measured <= 3e-15).  The caches carry the keys K11 requires."""
    omega = np.linspace(0.5, 5, 7)
    jax_pulses, pulses = _second_order_parts(seg_counts, 30, omega)
    for key in ('eigvecs_propagated', 'n_opers_transformed',
                'second_order_integral', 'second_order_complete_steps'):
        assert all(key in p.intermediates for p in pulses)
    got = numeric.calculate_second_order_filter_function_from_atomic(
        **_k11_arguments(pulses, omega))

    import filter_functions_tpu as ff
    want = ff.concatenate(jax_pulses, calc_second_order_FF=True) \
        .get_filter_function(omega, order=2)
    _close(got, want)
    scratch = sequencing.concatenate_without_filter_function(pulses)
    _close(got, scratch.get_filter_function(omega, order=2))


def test_second_order_from_atomic_groups_and_errors():
    """K11 in groups of one pulse (a 1-byte budget) equals one group
    (1e-13 of the largest entry, measured 2e-16); one pulse returns its
    own filter function; a missing intermediate raises as in JAX."""
    omega = np.linspace(0.5, 5, 5)
    _, pulses = _second_order_parts((1, 3, 2, 2), 31, omega)
    args = _k11_arguments(pulses, omega)
    whole = numeric.calculate_second_order_filter_function_from_atomic(**args)
    grouped = numeric.calculate_second_order_filter_function_from_atomic(
        **args, budget_bytes=1)
    _close(grouped, whole, 1e-13)

    single = dict(
        args, control_matrix_atomic=args['control_matrix_atomic'][:1])
    assert numeric.calculate_second_order_filter_function_from_atomic(
        **single) is args['filter_function_atomic']
    broken = [dict(im) for im in args['intermediates']]
    del broken[2]['second_order_integral']
    with pytest.raises(ValueError, match='second_order_integral not found'):
        numeric.calculate_second_order_filter_function_from_atomic(
            **dict(args, intermediates=broken))
