"""The PyTorch port's analytic derivatives (filter_functions_tpu_torch.
gradient and PulseSequence.get_filter_function_derivative) against the
JAX package's, on the same numpy inputs, mirroring tests/test_gradient.py:
the derivative integral K3, the Liouville derivative of the propagators,
the control-matrix, filter-function and infidelity derivatives, the
identifier machinery, central finite differences of the port's
infidelity, and autograd through the port's functional path.

Tolerances are relative to the largest |value| unless marked.
"""
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu import gradient as jgradient
from filter_functions_tpu_torch import functional, gradient
from testutil import make_pulse, rand_pulse_arrays
from torch_testutil import fft_cpu

#: The analytic derivative against the JAX package: the same complex128
#: arithmetic summed in another order.
PARITY = 1e-12


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _close(got, want, rel=PARITY):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


#: Segments and frequencies of the random pulses (2 control, 2 noise
#: operators).  The JAX package compiles its derivative anew for every
#: shape, so the tests share these.
N_DT = 4
OMEGA = np.linspace(0.1, 30, 31)


def _pair(d, seed, n_ops=2):
    """(arrays, JAX pulse, port pulse) of one random pulse."""
    arrays = rand_pulse_arrays(d, N_DT, n_ops, n_ops,
                               local_rng=np.random.default_rng(seed))
    return arrays, make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


def _t(x):
    return torch.tensor(np.asarray(x))


# -----------------------------------------------------------------------------
# K3 and the Liouville derivative
# -----------------------------------------------------------------------------
def test_derivative_integral_matches_jax_at_its_limits():
    """K3 of a segment with a degenerate pair (Omega_pq = 0 off the
    diagonal) at frequencies that make y = omega + Omega_mn vanish
    (omega = 0 on degenerate and diagonal pairs, omega = 0.9 against
    Omega_mn = -0.9), within 1e-12 of JAX; the batched form equals the
    single-segment one."""
    eigvals = np.array([0.3, 0.3, -0.6])
    omega = np.array([0.0, 0.9, 0.45, 3.0, 1e-3])
    got = gradient._derivative_integral(_t(omega), _t(eigvals), _t(0.7))
    want = jgradient._derivative_integral(omega, eigvals, 0.7)
    assert got.shape == (5, 3, 3, 3, 3) and torch.isfinite(got).all()
    _close(got, want)
    other = np.array([1.1, -0.2, -0.9])
    batched = gradient._derivative_integral(
        _t(omega), _t(np.stack([eigvals, other])), _t([0.7, 1.3]))
    assert torch.equal(batched[0], got)
    _close(batched[1], jgradient._derivative_integral(omega, other, 1.3))


def test_liouville_derivative_matches_jax():
    """The derivatives of the cumulative propagators in Liouville
    representation, (n-1, n_ctrl, n, d^2, d^2), within 1e-12 of JAX."""
    _, jp, p = _pair(3, 13)
    v = p.eigvecs[:, None]
    got = gradient._liouville_derivative(
        _t(p.dt), p.propagators, p.basis.tensor(p.device), p.eigvecs,
        p.eigvals, v.mH @ p.c_opers_dev @ v)
    jv = jp.eigvecs
    want = jgradient._liouville_derivative(
        np.asarray(jp.dt), jp.propagators, jp.basis, jv, jp.eigvals,
        ff.cplx.ceinsum('gba,hbc,gcd->ghad', jv.conj(), jp.c_opers_dev, jv))
    assert got.shape == (N_DT - 1, 2, N_DT, 9, 9)
    _close(got, want)


# -----------------------------------------------------------------------------
# control matrix, filter function and infidelity derivatives
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('d, cached, with_ncd', [(2, False, False),
                                                 (2, True, True),
                                                 (3, False, False),
                                                 (3, True, True)])
def test_control_matrix_derivative_matches_jax(d, cached, with_ncd):
    """The control-matrix derivative (n_ctrl, n_w, n_dt, n_nops, d^2) at
    d = 2 and 3, from scratch and from the cached intermediates with
    n_coeffs_deriv, within 1e-12 of JAX."""
    _, jp, p = _pair(d, 20 + d)
    ncd = (np.random.default_rng(d).standard_normal((2, 2, N_DT))
           if with_ncd else None)
    inter, jinter = {}, {}
    if cached:
        p.cache_control_matrix(OMEGA, cache_intermediates=True)
        jp.cache_control_matrix(OMEGA, cache_intermediates=True)
        inter, jinter = dict(p.intermediates), dict(jp.intermediates)
    got = gradient.calculate_derivative_of_control_matrix_from_scratch(
        OMEGA, p.propagators, p.eigvals, p.eigvecs, p.basis, p.t, p.dt,
        p.n_opers_dev, p.n_coeffs, p.c_opers_dev, ncd, inter)
    want = jgradient.calculate_derivative_of_control_matrix_from_scratch(
        OMEGA, jp.propagators, jp.eigvals, jp.eigvecs, jp.basis, jp.t,
        jp.dt, jp.n_opers_dev, jp.n_coeffs, jp.c_opers_dev, ncd, jinter)
    assert got.shape == (2, len(OMEGA), N_DT, 2, d * d)
    assert got.dtype == torch.complex128
    _close(got, want)


def test_chunked_derivative_equals_one_chunk(monkeypatch):
    """Segment chunks of one segment (a budget of one byte) give the same
    derivative, bit for bit, as one chunk of all segments."""
    _, _, p = _pair(3, 31)

    def deriv():
        return gradient.calculate_derivative_of_control_matrix_from_scratch(
            OMEGA, p.propagators, p.eigvals, p.eigvecs, p.basis, p.t, p.dt,
            p.n_opers_dev, p.n_coeffs, p.c_opers_dev)
    whole = deriv()
    monkeypatch.setattr(fft.config, 'memory_budget',
                        lambda device, budget_bytes=None: 1)
    assert torch.equal(deriv(), whole)


def test_filter_function_derivative_matches_jax():
    """get_filter_function_derivative, (n_nops, n_dt, n_ctrl, n_w)
    float64, within 1e-12 of JAX; from the cached intermediates it is
    the same within 1e-13
    (tests/test_gradient.py::test_intermediates_caching_equivalence)."""
    _, jp, p = _pair(3, 43)
    got = p.get_filter_function_derivative(OMEGA)
    assert got.shape == (2, N_DT, 2, len(OMEGA))
    assert got.dtype == torch.float64
    _close(got, jp.get_filter_function_derivative(OMEGA))
    p.cleanup('frequency dependent')
    p.cache_control_matrix(OMEGA, cache_intermediates=True)
    assert p.is_cached('n_opers_transformed')
    _close(p.get_filter_function_derivative(OMEGA), got, 1e-13)


def _finite_diff(arrays, spectrum, omega, delta=1e-6):
    """Central finite differences of the port's infidelity with respect
    to c_coeffs, (n_nops, n_dt, n_ctrl), controls in array order."""
    c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt = arrays
    n_ctrl, n_dt = c_coeffs.shape
    grad = np.zeros((len(n_opers), n_dt, n_ctrl))
    for h in range(n_ctrl):
        for g in range(n_dt):
            for sign in (+1, -1):
                cc = c_coeffs.copy()
                cc[h, g] += sign * delta
                pulse = make_pulse((c_opers, c_ids, cc, n_opers, n_ids,
                                    n_coeffs, dt), cls=fft_cpu)
                infid = fft.infidelity(pulse, spectrum, omega).numpy()
                grad[:, g, h] += sign * infid / (2 * delta)
    return grad


def test_infidelity_derivative_against_jax_and_finite_differences():
    """infidelity_derivative (n_nops, n_dt, n_ctrl) within 1e-12 of JAX
    and within rtol 1e-5 of central finite differences of the port's
    infidelity (tests/test_gradient.py::test_against_finite_differences,
    d = 2)."""
    arrays, jp, p = _pair(2, 50)
    spectrum = 1e-3 / OMEGA
    got = fft.infidelity_derivative(p, spectrum, OMEGA)
    _close(got, ff.infidelity_derivative(jp, spectrum, OMEGA))
    order = np.argsort(arrays[1])
    np.testing.assert_allclose(
        got.numpy(), _finite_diff(arrays, spectrum, OMEGA)[..., order],
        rtol=1e-5, atol=1e-10)


def test_infidelity_derivative_with_n_coeffs_deriv_matches_jax():
    """n_coeffs_deriv adds the noise sensitivities' dependence on the
    controls; with per-operator spectra, within 1e-12 of JAX."""
    _, jp, p = _pair(3, 51)
    for pulse in (p, jp):
        pulse.cache_control_matrix(OMEGA, cache_intermediates=True)
    spectrum = np.stack([1e-3 / OMEGA, 2e-3 / OMEGA**2])
    ncd = np.random.default_rng(4).standard_normal((2, 2, N_DT))
    _close(fft.infidelity_derivative(p, spectrum, OMEGA, n_coeffs_deriv=ncd),
           ff.infidelity_derivative(jp, spectrum, OMEGA, n_coeffs_deriv=ncd))


# -----------------------------------------------------------------------------
# identifiers and errors
# -----------------------------------------------------------------------------
def test_identifier_subset_and_sorting():
    """Selected and permuted identifiers pick the matching entries of the
    full derivative, n_coeffs_deriv following them
    (tests/test_gradient.py::test_identifier_subset,
    ::test_n_coeffs_deriv_sorting)."""
    rng = np.random.default_rng(60)
    _, _, p = _pair(3, 61, n_ops=3)
    n_ids = np.asarray(p.n_oper_identifiers)
    c_ids = np.asarray(p.c_oper_identifiers)
    ncd = rng.standard_normal((3, 3, N_DT))
    n_unsort, c_unsort = rng.permutation(3), rng.permutation(3)
    n_choice = rng.choice(3, 2, replace=False)
    c_choice = rng.choice(3, 2, replace=False)

    full = p.get_filter_function_derivative(OMEGA, n_coeffs_deriv=ncd)
    as_given = p.get_filter_function_derivative(
        OMEGA, n_oper_identifiers=n_ids[n_unsort],
        control_identifiers=c_ids[c_unsort],
        n_coeffs_deriv=ncd[n_unsort[:, None], c_unsort])
    subset = p.get_filter_function_derivative(
        OMEGA, control_identifiers=c_ids[c_choice],
        n_oper_identifiers=n_ids[n_choice],
        n_coeffs_deriv=ncd[n_choice[:, None], c_choice])
    all_dt = np.arange(N_DT)
    _close(as_given, full.numpy()[np.ix_(n_unsort, all_dt, c_unsort)], 1e-13)
    _close(subset, full.numpy()[np.ix_(n_choice, all_dt, c_choice)], 1e-13)
    part = fft.infidelity_derivative(
        p, 1 / OMEGA, OMEGA, control_identifiers=[c_ids[1]],
        n_oper_identifiers=[n_ids[0]])
    whole = fft.infidelity_derivative(p, 1 / OMEGA, OMEGA)
    _close(part[0, :, 0], whole[0, :, 1], 1e-13)


def test_derivative_raises_like_jax():
    """An unknown identifier and an n_coeffs_deriv of the wrong shape
    raise ValueError (tests/test_gradient.py::test_raises)."""
    _, _, p = _pair(2, 62)
    with pytest.raises(ValueError):
        fft.infidelity_derivative(p, 1 / OMEGA, OMEGA,
                                  control_identifiers=['long string'])
    with pytest.raises(ValueError, match='n_coeffs_deriv'):
        p.get_filter_function_derivative(
            OMEGA, n_coeffs_deriv=np.ones((2, 5, 10)))


# -----------------------------------------------------------------------------
# autograd against the analytic derivative
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('d', [2, 3])
def test_autograd_matches_analytic_derivative(d):
    """torch.autograd through functional.infidelity with respect to
    c_coeffs equals the analytic derivative summed over the noise
    operators, within 1e-12 (the JAX package's
    tests/test_gradient.py::test_jax_grad_matches_closed_form)."""
    _, _, p = _pair(d, 70 + d)
    spectrum = 1e-3 / OMEGA
    pa = functional.make_pulse_arrays(p)
    cc = pa.c_coeffs.clone().requires_grad_(True)
    infid = functional.infidelity(pa._replace(c_coeffs=cc), _t(spectrum),
                                  _t(OMEGA))
    grad, = torch.autograd.grad(infid.sum(), cc)
    analytic = fft.infidelity_derivative(p, spectrum, OMEGA).sum(0)
    _close(grad.T, analytic)
