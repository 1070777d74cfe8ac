"""The PyTorch port's decay amplitudes (K13), frequency shifts (K14),
integrand (K12) and cumulant function (K15) against the JAX package's,
on the same numpy inputs: random pulses from tests/testutil with seeded
generators (d <= 4, <= 64 frequencies), spectra of ndim 1-3 (real and
complex cross-spectra), and precomputed decay amplitudes and frequency
shifts on every route of the trace contraction: the single-qubit closed
form, the dense traces (n <= 64) and the contraction through the basis
(n = 81, 256).  Tolerance 1e-12 of the largest value unless stated.
"""
import warnings

import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu_torch import numeric
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


def _pair(d, n_dt, seed, n_nops=2, btype='GGM'):
    arrays = rand_pulse_arrays(d, n_dt, n_nops=n_nops,
                               local_rng=np.random.default_rng(seed))
    return make_pulse(arrays, btype), make_pulse(arrays, btype, cls=fft_cpu)


def _spectrum(kind, omega):
    """A spectrum of two noise operators."""
    if kind == 'shared':
        return 1e-3 / omega
    if kind == 'per_operator':
        return np.outer([1e-3, 2e-3], 400 / (omega**2 + 400))
    off = (1e-4 + 1j * 1e-4) / omega if kind == 'complex_cross' \
        else 3e-4 / omega
    return np.array([[1e-3 / omega, off], [np.conj(off), 2e-3 / omega]])


KINDS = ['shared', 'per_operator', 'cross', 'complex_cross']


# -----------------------------------------------------------------------------
# basis traces
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('name,arg', [('ggm', 2), ('pauli', 1), ('ggm', 3),
                                      ('pauli', 2)])
def test_four_element_traces_match_jax(name, arg):
    """T_ijkl and the Gamma/Delta trace combos, within 1e-14 of JAX's."""
    basis = getattr(fft.Basis, name)(arg)
    jbasis = getattr(ff.Basis, name)(arg)
    _close(basis.four_element_traces, jbasis.four_element_traces, 1e-14)
    assert basis.four_element_traces is basis.four_element_traces
    for got, want in zip(numeric._cumulant_trace_combos(basis),
                         jnumeric._cumulant_trace_combos(jbasis)):
        _close(got, want, 1e-14)
    tg, td = numeric._cumulant_trace_combos_dev(basis, 'cpu')
    assert tg.dtype == torch.float64 and tg.shape == (len(basis),) * 4
    assert numeric._cumulant_trace_combos_dev(basis, 'cpu')[1] is td


def test_four_element_traces_refuse_large_bases():
    """n > 64 raises MemoryError, as in the JAX package."""
    with pytest.raises(MemoryError):
        fft.Basis.ggm(9).four_element_traces
    with pytest.raises(MemoryError):
        ff.Basis.ggm(9).four_element_traces


@pytest.mark.parametrize('d', [2, 3, 4])
def test_streamed_trace_contraction_matches_dense(d):
    """The contraction through the basis against an einsum over the
    dense traces, for every pattern the cumulant function uses, within
    1e-13."""
    basis = fft.Basis.ggm(d)
    coeff = np.random.default_rng(d).normal(size=(2, d * d, d * d))
    traces = basis.four_element_traces.real
    for pattern in ('klji', 'kjli', 'kilj', 'kijl', 'lkji', 'klij', 'lkij'):
        _close(numeric._trace_contract_basis(torch.as_tensor(coeff), basis,
                                             pattern),
               np.einsum(f'...kl,{pattern}->...ij', coeff, traces), 1e-13)


# -----------------------------------------------------------------------------
# decay amplitudes and frequency shifts
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('d', [2, 3])
def test_decay_amplitudes_match_jax(d, kind):
    """Gamma from the control matrix (the folded route for real diagonal
    spectra, the integrand otherwise), memory-parsimonious, and from a
    cached generalized filter function."""
    jp, p = _pair(d, 4, 10 * d + KINDS.index(kind))
    omega = np.geomspace(0.1, 20, 40)
    spectrum = _spectrum(kind, omega)
    want = jnumeric.calculate_decay_amplitudes(jp, spectrum, omega)
    got = numeric.calculate_decay_amplitudes(p, spectrum, omega)
    assert got.dtype == torch.float64
    _close(got, want)
    _close(numeric.calculate_decay_amplitudes(p, spectrum, omega,
                                              memory_parsimonious=True),
           want)
    ids = [p.n_oper_identifiers[1]]
    sub = spectrum if kind == 'shared' else (
        spectrum[1:] if kind == 'per_operator' else spectrum[1:, 1:])
    _close(numeric.calculate_decay_amplitudes(p, sub, omega, ids),
           jnumeric.calculate_decay_amplitudes(jp, sub, omega, ids))
    p.cache_filter_function(omega, which='generalized')
    _close(numeric.calculate_decay_amplitudes(p, spectrum, omega), want)


@pytest.mark.parametrize('kind', KINDS)
def test_frequency_shifts_match_jax(kind):
    """Delta from the second-order filter function, within 1e-12."""
    jp, p = _pair(3, 3, 60 + KINDS.index(kind))
    omega = np.geomspace(0.1, 20, 24)
    spectrum = _spectrum(kind, omega)
    want = jnumeric.calculate_frequency_shifts(jp, spectrum, omega)
    got = numeric.calculate_frequency_shifts(p, spectrum, omega)
    _close(got, want)


@pytest.mark.parametrize('which_FF', ['fidelity', 'generalized'])
@pytest.mark.parametrize('kind', KINDS)
def test_integrand_of_control_matrix_matches_jax(kind, which_FF):
    """K12 from a control matrix, a [left, right] pair and a filter
    function, 'total' and 'correlations', against JAX's."""
    rng = np.random.default_rng(KINDS.index(kind))
    omega = np.geomspace(0.1, 20, 12)
    spectrum = _spectrum(kind, omega)
    ctrl = rng.normal(size=(2, 2, 4, 12)) + 1j * rng.normal(size=(2, 2, 4, 12))
    idx = np.arange(2)
    t_ctrl = torch.as_tensor(ctrl)

    def both(*args, **kw):
        jkw = {k: (v if not isinstance(v, list) else
                   [ff.cplx.asc(x) for x in v]) for k, v in kw.items()}
        want = jnumeric._get_integrand(spectrum, omega, idx, *args, **{
            k: ff.cplx.asc(v) if isinstance(v, np.ndarray) else v
            for k, v in jkw.items()})
        got = numeric._get_integrand(spectrum, torch.as_tensor(omega), idx,
                                     *args, **{
                                         k: [torch.as_tensor(x) for x in v]
                                         if isinstance(v, list)
                                         else torch.as_tensor(v)
                                         for k, v in kw.items()})
        _close(got, want)

    both('total', which_FF, control_matrix=ctrl[0])
    both('total', which_FF, control_matrix=[ctrl[0][:, :1], ctrl[0]])
    both('correlations', which_FF, control_matrix=ctrl)
    ff_got = numeric.calculate_filter_function(t_ctrl[0], which_FF).numpy()
    both('total', which_FF, filter_function=ff_got)


def test_pulse_correlation_decay_amplitudes_match_jax():
    """which='correlations' from a seeded pulse-correlation control
    matrix (a concatenated pulse's is only ported with sequencing), and
    its cumulant function; omega must match the cached grid."""
    jp, p = _pair(2, 3, 70)
    omega = np.geomspace(0.1, 20, 16)
    rng = np.random.default_rng(70)
    ctrl = 0.1 * (rng.normal(size=(2, 2, 4, 16))
                  + 1j * rng.normal(size=(2, 2, 4, 16)))
    jp.cache_control_matrix(omega, ff.cplx.asc(ctrl))
    p.cache_control_matrix(omega, ctrl)
    spectrum = 1e-3 / omega
    want = jnumeric.calculate_decay_amplitudes(jp, spectrum, omega,
                                               which='correlations')
    got = numeric.calculate_decay_amplitudes(p, spectrum, omega,
                                             which='correlations')
    assert got.shape == (2, 2, 2, 4, 4)
    _close(got, want)
    _close(numeric.calculate_cumulant_function(p, spectrum, omega,
                                               which='correlations'),
           jnumeric.calculate_cumulant_function(jp, spectrum, omega,
                                                which='correlations'))
    with pytest.raises(ValueError, match='omega not equal'):
        numeric.calculate_decay_amplitudes(p, spectrum, omega[:-1],
                                           which='correlations')


# -----------------------------------------------------------------------------
# cumulant function
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('name,arg,n_nops', [
    ('pauli', 1, 2),       # single-qubit closed form
    ('ggm', 2, 2),         # single-qubit closed form
    ('ggm', 3, 2),         # dense traces
    ('pauli', 2, 2),       # dense traces
    ('ggm', 9, 1),         # through the basis, n = 81
    ('ggm', 16, 1),        # through the basis, n = 256
])
def test_cumulant_from_precomputed_matches_jax(name, arg, n_nops):
    """K from precomputed Gamma and Delta, first and second order, on
    every route of the trace contraction."""
    basis, jbasis = getattr(fft.Basis, name)(arg), getattr(ff.Basis, name)(arg)
    d, n = basis.d, len(basis)
    c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt = \
        rand_pulse_arrays(d, 1, 1, n_nops,
                          local_rng=np.random.default_rng(n))
    arrays = (c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt)
    p = fft.PulseSequence.from_arrays(*arrays, basis=basis,
                                      device='cpu')
    jp = ff.PulseSequence.from_arrays(*arrays, basis=jbasis)
    rng = np.random.default_rng(n + 1)
    a = rng.normal(size=(n_nops, n, n))
    gamma = 1e-3 * (a @ a.transpose(0, 2, 1)) / n
    delta = 1e-3 * rng.normal(size=(n_nops, n, n))
    for second in (False, True):
        kw = dict(decay_amplitudes=gamma, second_order=second,
                  frequency_shifts=delta if second else None)
        want = jnumeric.calculate_cumulant_function(jp, **kw)
        got = numeric.calculate_cumulant_function(p, **kw)
        assert got.shape == (n_nops, n, n) and got.dtype == torch.float64
        _close(got, want)


@pytest.mark.parametrize('d,btype', [(2, 'Pauli'), (3, 'GGM'), (4, 'GGM')])
def test_cumulant_from_spectrum_matches_jax(d, btype):
    """K from a spectrum, first and second order, against JAX's."""
    jp, p = _pair(d, 3, 80 + d, btype=btype)
    omega = np.geomspace(0.1, 20, 20)
    spectrum = _spectrum('per_operator', omega)
    for second in (False, True):
        _close(numeric.calculate_cumulant_function(
            p, spectrum, omega, second_order=second),
            jnumeric.calculate_cumulant_function(
                jp, spectrum, omega, second_order=second))


@pytest.mark.parametrize('kind', ['cross', 'complex_cross'])
@pytest.mark.parametrize('d,btype', [(2, 'Pauli'), (2, 'GGM'), (3, 'GGM')])
def test_cumulant_of_cross_spectrum_per_pair_matches_jax(d, btype, kind):
    """K per noise-operator pair (a, b) of a cross-spectrum against JAX's.
    Each pair's Gamma is not symmetric, so at d = 2 only the closed form
    gives the JAX package's K; the trace combos agree with it on the sum
    over the pairs (the sum the ETM exponentiates) within 1e-12."""
    jp, p = _pair(d, 3, 85 + d, btype=btype)
    omega = np.geomspace(0.1, 20, 20)
    spectrum = _spectrum(kind, omega)
    got = numeric.calculate_cumulant_function(p, spectrum, omega)
    want = jnumeric.calculate_cumulant_function(jp, spectrum, omega)
    assert got.shape == (2, 2, d * d, d * d)
    _close(got, want)
    gamma = numeric.calculate_decay_amplitudes(p, spectrum, omega)
    tg, _ = numeric._cumulant_trace_combos(p.basis)
    _close(numeric._cumulant_contract_core(gamma, torch.as_tensor(tg))
           .sum((0, 1)), _np(want).sum((0, 1)))


def test_precomputed_amplitudes_shifts_and_errors():
    """tests/test_core.py::TestCumulantFunctionSemantics::
    test_precomputed_amplitudes_and_shifts on the port: K from
    precomputed amplitudes and shifts equals K from the spectrum within
    1e-15, and the same bad arguments raise."""
    p = make_pulse(rand_pulse_arrays(2, 2, 1, 1,
                                     local_rng=np.random.default_rng(90)),
                   cls=fft_cpu)
    omega = np.linspace(0.5, 5, 43)
    spectrum = 1e-2 / omega
    gamma = numeric.calculate_decay_amplitudes(p, spectrum, omega)
    delta = numeric.calculate_frequency_shifts(p, spectrum, omega)
    k1 = numeric.calculate_cumulant_function(p, spectrum, omega)
    k2 = numeric.calculate_cumulant_function(p, decay_amplitudes=gamma)
    k3 = numeric.calculate_cumulant_function(p, spectrum, omega,
                                             second_order=True)
    k4 = numeric.calculate_cumulant_function(
        p, decay_amplitudes=gamma, frequency_shifts=delta, second_order=True)
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(k3.numpy(), k4.numpy(), rtol=0, atol=1e-15)

    with pytest.raises(ValueError):
        numeric.calculate_cumulant_function(p, None, None,
                                            decay_amplitudes=None)
    with pytest.raises(ValueError):
        numeric.calculate_cumulant_function(
            p, None, None, decay_amplitudes=gamma, frequency_shifts=None,
            second_order=True)
    with pytest.raises(ValueError):
        numeric.calculate_cumulant_function(
            p, spectrum, omega, second_order=True, which='correlations')
    with pytest.raises(ValueError):
        numeric.calculate_cumulant_function(
            p, spectrum, omega, second_order=True,
            decay_amplitudes=gamma[..., 1:, :])
    with pytest.warns(UserWarning, match='parsimonious'):
        numeric.calculate_cumulant_function(
            p, spectrum, omega, second_order=True, memory_parsimonious=True)


@pytest.mark.parametrize('d', [2, 3, 5])
def test_second_order_contribution_antisymmetric(d):
    """K2 - K1 is antisymmetric within 1e-15 (tests/test_core.py:570-582),
    with the first-order intermediates cached as there."""
    p = make_pulse(rand_pulse_arrays(d, 3, 2, 2,
                                     local_rng=np.random.default_rng(d)),
                   cls=fft_cpu)
    omega = fft.util.get_sample_frequencies(p, n_samples=42)
    spectrum = 4e-3 / np.abs(omega)
    p.cache_control_matrix(omega, cache_intermediates=True)
    k1 = numeric.calculate_cumulant_function(p, spectrum, omega)
    k2 = numeric.calculate_cumulant_function(p, spectrum, omega,
                                             second_order=True)
    second = (k2 - k1).numpy()
    np.testing.assert_allclose(second, -second.transpose(0, 2, 1), rtol=0,
                               atol=1e-15)
    assert k1.shape == k2.shape


def test_decay_amplitude_spectrum_raises():
    """Spectra of the wrong length raise ValueError
    (tests/test_core.py:584-591)."""
    p = make_pulse(rand_pulse_arrays(2, 1, 1, 1,
                                     local_rng=np.random.default_rng(91)),
                   cls=fft_cpu)
    omega = np.linspace(0.5, 5, 43)
    spectrum = np.random.default_rng(92).standard_normal(78)
    for i in range(4):
        with pytest.raises(ValueError):
            numeric.calculate_decay_amplitudes(
                p, np.tile(spectrum, [1] * i), omega)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        numeric.calculate_decay_amplitudes(p, 1 / omega, omega)
