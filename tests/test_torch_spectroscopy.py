"""The port's noise spectroscopy (filter_functions_tpu_torch.spectroscopy)
against the JAX package's, on the CPMG family of tests/test_spectroscopy.py
(CPMG-8 at 16 durations in geomspace(0.3, 30), Z/2 noise, 400
frequencies in geomspace(0.2, 200)).

The hat basis is host numpy and equal bit for bit; the design matrix
from the same filter functions agrees within 1e-12 of its largest entry
(and the port's filter functions with JAX's); the reconstruction, a
FISTA loop of 2000 steps in the JAX package's order of operations from
the minimum-norm least-squares start, agrees with JAX's within 1e-5 of
its largest node value (``S_HAT_PARITY``) and holds the JAX test's own
bounds.
"""
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu import spectroscopy as jspectroscopy
from filter_functions_tpu_torch import spectroscopy
from testutil import generate_dd_hamiltonian, sigma

#: The port's reconstruction against JAX's, relative to the largest
#: node value.  A^T A of the CPMG family at ridge 1e-10 has condition
#: number 1.9e10, so the two SVDs of the least-squares start may differ
#: by cond * eps = 4e-6 along its smallest singular vector (measured up
#: to 2.2e-6), which the FISTA steps, of size 1/L, hardly move.
S_HAT_PARITY = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope='module')
def cpmg():
    """(port pulses, JAX pulses, omega, port filter functions, JAX
    filter functions) of the CPMG-8 family."""
    taus = np.geomspace(0.3, 30, 16)
    omega = np.geomspace(2e-1, 2e2, 400)
    pulses, jpulses = [], []
    for tau in taus:
        H_c, dt = generate_dd_hamiltonian(8, tau=tau, tau_pi=1e-4,
                                          dd_type='cpmg')
        H_n = [[sigma[3] / 2, np.ones_like(dt)]]
        pulses.append(fft.PulseSequence(H_c, H_n, dt, device='cpu'))
        jpulses.append(ff.PulseSequence(H_c, H_n, dt))
    ffs = torch.stack([p.get_filter_function(omega)[0, 0].real
                       for p in pulses])
    jffs = np.stack([np.asarray(p.get_filter_function(omega).to_numpy())
                     [0, 0].real for p in jpulses])
    return pulses, jpulses, omega, ffs, jffs


def test_spectrum_basis_and_interpolation_match_jax():
    """Nodes and hats equal JAX's bit for bit; the hats sum to one; the
    interpolation of a log-linear function is exact (1e-12) and within
    1e-14 of JAX's."""
    omega = np.geomspace(0.1, 100, 57)
    nodes, w = spectroscopy.spectrum_basis(omega, 9)
    jnodes, jw = jspectroscopy.spectrum_basis(omega, 9)
    np.testing.assert_array_equal(nodes, jnodes)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, rtol=0, atol=1e-12)
    s_nodes = 2.0 + np.log(nodes)
    got = spectroscopy.interpolate_spectrum(torch.tensor(s_nodes), nodes,
                                            omega)
    assert got.device == torch.device('cpu')
    np.testing.assert_allclose(got.numpy(), 2.0 + np.log(omega), rtol=0,
                               atol=1e-12)
    _close(got, jspectroscopy.interpolate_spectrum(s_nodes, nodes, omega),
           1e-14)
    _close(spectroscopy.interpolate_spectrum(s_nodes, nodes, omega,
                                             device='cpu'), got, 0)


def test_spectrum_basis_validation():
    omega = np.geomspace(0.1, 100, 17)
    with pytest.raises(ValueError, match='n_nodes'):
        spectroscopy.spectrum_basis(omega, 1)
    with pytest.raises(ValueError, match='[Dd]egenerate'):
        spectroscopy.spectrum_basis(np.full(5, 2.0), 4)
    with pytest.raises(ValueError, match='[Dd]egenerate'):
        spectroscopy.spectrum_basis(omega, 4, omega_min=5.0, omega_max=5.0)


def test_reconstruct_zero_row_guard():
    """An all-zero design row stays unscaled: the solve is finite,
    non-negative and JAX's."""
    a = np.array([[1.0, 0.5, 0.0], [0.0, 0.0, 0.0], [0.2, 1.0, 0.3]])
    y = np.array([1.0, 0.0, 0.8])
    s = spectroscopy.reconstruct(torch.tensor(a), torch.tensor(y),
                                 n_steps=200)
    assert torch.isfinite(s).all() and (s >= 0).all()
    _close(s, jspectroscopy.reconstruct(a, y, n_steps=200), S_HAT_PARITY)


def test_design_matrix_matches_jax(cpmg):
    """The port's filter functions are JAX's (1e-12); from the same
    filter functions the design matrix is JAX's (1e-12 of the largest
    entry), on the filter functions' device, and A @ s equals the
    infidelities of the interpolated spectrum (1e-10 relative, the JAX
    test's bound)."""
    pulses, _, omega, ffs, jffs = cpmg
    _close(ffs, jffs, 1e-12)
    a, nodes = spectroscopy.design_matrix(ffs, omega, n_nodes=10)
    ja, jnodes = jspectroscopy.design_matrix(jffs, omega, n_nodes=10)
    assert isinstance(a, torch.Tensor) and a.device == ffs.device
    np.testing.assert_array_equal(nodes, jnodes)
    _close(a, ja, 1e-12)
    _close(spectroscopy.design_matrix(jffs, omega, n_nodes=10,
                                      device='cpu')[0], ja, 1e-12)
    s_nodes = 1e-3 / nodes**0.7
    spectrum = spectroscopy.interpolate_spectrum(torch.tensor(s_nodes),
                                                 nodes, omega)
    want = torch.stack([fft.infidelity(p, spectrum, omega)[0]
                        for p in pulses])
    np.testing.assert_allclose((a @ torch.tensor(s_nodes)).numpy(),
                               want.numpy(), rtol=1e-10)


@pytest.mark.parametrize('noise', [False, True])
def test_reconstruct_matches_jax(cpmg, noise):
    """ŝ of s_true = 1e-3 / nodes^0.7 from A s_true (ridge 1e-10), and
    from 1 %-noisy measurements (ridge 1e-9, curvature 1e-7): within
    S_HAT_PARITY of JAX's ŝ on the same inputs, non-negative, the
    forward residual within 1e-3 and the interior nodes within 0.15
    (0.5 with noise), the JAX test's bounds."""
    _, _, omega, _, jffs = cpmg
    ja, nodes = jspectroscopy.design_matrix(jffs, omega, n_nodes=10)
    ja = np.asarray(ja)
    s_true = 1e-3 / nodes**0.7
    infids = ja @ s_true
    kw = dict(ridge=1e-10)
    if noise:
        infids = infids * (1 + 0.01 * np.random.default_rng(11)
                           .standard_normal(len(infids)))
        kw = dict(ridge=1e-9, curvature=1e-7)
    got = spectroscopy.reconstruct(torch.tensor(ja), torch.tensor(infids),
                                   **kw)
    want = jspectroscopy.reconstruct(ja, infids, **kw)
    _close(got, want, S_HAT_PARITY)
    s_hat = got.numpy()
    assert (s_hat >= 0).all()
    interior = slice(1, -2)
    np.testing.assert_allclose(s_hat[interior], s_true[interior],
                               rtol=0.5 if noise else 0.15)
    if not noise:
        np.testing.assert_allclose(ja @ s_hat, infids, rtol=1e-3)


def test_numpy_inputs_go_to_the_default_device():
    """Without a tensor argument the functions build on the default
    device, which without a card raises; device='cpu' runs on the CPU."""
    a, y = np.eye(3), np.ones(3)
    assert spectroscopy.reconstruct(a, y, n_steps=5,
                                    device='cpu').device.type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spectroscopy.reconstruct(a, y, n_steps=5)
