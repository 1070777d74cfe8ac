"""The port's second-order error transfer matrix under a cross-spectrum
(``functional.batched_error_transfer_matrix(..., second_order=True)``
with S of shape (n, n, n_w): real profiles and mixing factors) against
the benchmark's plain per-pair reference
(``perfbench/reference/cross_second_order.py``: every pair (a, b) whose
spectrum is not zero on its own, no factorization, no mixing), and that
reference against the JAX package's F^(2) route, which is the oracle
for where the upstream definitions take real parts:

* a d = 4 pulse with one zero-amplitude (fully degenerate) segment, 2
  control and 3 noise operators, the 16-element GGM basis, 48
  frequencies, batch 2, under a complex Hermitian cross-spectrum of two
  profiles;
* the 4-qubit QFT pulse of the benchmark's ``qft4`` arrays, one row, at
  20 frequencies, under the ``qft4_etm2_xcorr`` configuration's
  spectrum: 1/f on every noise operator, correlated 0.5^|j - k| between
  the four single-qubit Z operators.

Each is held on E - I and on the antisymmetric part (E - E^T) / 2, as
the benchmark's cells compare them; the reference without the
correlations fails the same tolerance.

The reference is imported from the benchmark's files, so an edit there
changes what these tests hold the port to: such an edit has to keep
this file passing, and the reference must keep importing nothing of the
port.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu_torch import functional
from filter_functions_tpu_torch.basis import Basis
from perfbench.reference import cross_second_order as plain
from perfbench.reference.qft4_etm2_xcorr import correlation_matrix
from testutil import make_pulse, rand_pulse_arrays

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ROOT / 'perfbench' / 'data' / 'qft4_arrays.npz'
CONFIG = ROOT / 'perfbench' / 'configs' / 'qft4_etm2_xcorr.json'
#: Both sides are float64, and the tolerance is that of the diagonal
#: spectrum's reference test (``test_torch_etm2_reference.TOL``): the
#: rounding of E over |E - I| and the port's separable tables.
TOL = 1e-11


def _gaps(etm, want):
    """(max over rows of the gap of E - I, of (E - E^T) / 2), each over
    the row's largest reference entry, as ``perfbench/lib/check``."""
    eye = torch.eye(want.shape[-1], dtype=want.dtype)

    def rel(x, y):
        return float(((x - y).abs().amax((-1, -2))
                      / y.abs().amax((-1, -2))).max())
    return (rel(etm - eye, want - eye),
            rel((etm - etm.mT) / 2, (want - want.mT) / 2))


def _herm(n, d, rng):
    a = rng.standard_normal((n, d, d)) + 1j * rng.standard_normal((n, d, d))
    h = a + a.conj().transpose(0, 2, 1)
    return h - np.trace(h, axis1=1, axis2=2)[:, None, None] * np.eye(d) / d


def _cross(omega):
    """A complex Hermitian (3, 3, n_w) spectrum of two profiles."""
    c = np.array([[1.0, 0.4 + 0.2j, 0.1], [0.4 - 0.2j, 0.8, -0.3j],
                  [0.1, 0.3j, 1.2]])
    e = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.5], [0.0, 0.5, 0.7]])
    lorentz = 400 / (omega ** 2 + 400)
    return 1e-2 * (c[:, :, None] / omega + e[:, :, None] * lorentz)


def _small():
    rng = np.random.default_rng(1906)
    d, G, batch = 4, 5, 2
    c_coeffs = rng.standard_normal((batch, 2, G))
    c_coeffs[:, :, 2] = 0.0                   # H = 0: one eigenspace
    arrays = [torch.tensor(_herm(2, d, rng)), torch.tensor(c_coeffs),
              torch.tensor(_herm(3, d, rng)),
              torch.tensor(rng.random((batch, 3, G))),
              torch.tensor(1 - rng.random((batch, G)))]
    omega = np.geomspace(1e-1, 1e1, 48)
    return arrays, Basis.ggm(d), torch.tensor(omega), \
        torch.tensor(_cross(omega))


def _qft():
    with np.load(ARRAYS) as z:
        a = {k: torch.as_tensor(z[k]) for k in z.files}
    arrays = [a['c_opers'], a['c_coeffs'][None], a['n_opers'],
              a['n_coeffs'][None], a['dt'][None]]
    omega = np.geomspace(1e-2, 1e2, 20)
    c = correlation_matrix(json.loads(CONFIG.read_text()))
    spectrum = c[:, :, None] * (1e-4 / omega)
    return arrays, Basis(a['basis'].numpy()), torch.tensor(omega), \
        torch.tensor(spectrum)


@pytest.fixture(scope='module', params=['d4_degenerate', 'qft4'])
def case(request):
    arrays, basis, omega, spectrum = (_small() if request.param
                                      == 'd4_degenerate' else _qft())
    b = basis.tensor('cpu')
    p = functional.PulseArrays(*arrays[:5], b)
    port = functional.batched_error_transfer_matrix(p, spectrum, omega,
                                                    basis, second_order=True)
    want = plain.error_transfer_matrices(*arrays, b, omega, spectrum)
    eye = torch.eye(spectrum.shape[0], dtype=torch.bool)[:, :, None]
    uncorrelated = plain.error_transfer_matrices(
        *arrays, b, omega, torch.where(eye, spectrum, 0))
    return port, want, uncorrelated


def test_port_holds_the_reference(case):
    port, want, _ = case
    etm_gap, coherent_gap = _gaps(port, want)
    assert etm_gap < TOL
    assert coherent_gap < TOL


def test_uncorrelated_fails_the_tolerance(case):
    """Without the spectrum's entries off the diagonal the reference moves
    E - I by far more than the tolerance: the correlations are not
    within it."""
    _, want, uncorrelated = case
    etm_gap, coherent_gap = _gaps(uncorrelated, want)
    assert etm_gap > 1e3 * TOL
    assert coherent_gap > 1e3 * TOL


@pytest.mark.parametrize('second_order', [False, True])
def test_reference_holds_the_jax_f2_route(second_order):
    """The per-pair reference against the JAX package's functional error
    transfer matrix (its integrand and F^(2) of every pair, real parts
    as upstream takes them) for a random d = 4 pulse, 3 noise operators,
    under the complex Hermitian spectrum of two profiles: within 1e-13,
    first and second order."""
    jp = make_pulse(rand_pulse_arrays(4, 4, 2, 3,
                                      local_rng=np.random.default_rng(77)))
    jarr = jfunctional.make_pulse_arrays(jp)
    host = [x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)
            for x in jarr]
    omega = np.geomspace(0.1, 10, 24)
    spectrum = _cross(omega)
    want = np.asarray(jfunctional.error_transfer_matrix(
        jarr, spectrum, omega, jp.basis, second_order=second_order))
    c_opers, c_coeffs, n_opers, n_coeffs, dt, basis = (torch.tensor(x)
                                                       for x in host)
    got = plain.error_transfer_matrices(
        c_opers, c_coeffs[None], n_opers, n_coeffs[None], dt[None], basis,
        torch.as_tensor(omega), torch.as_tensor(spectrum),
        second_order=second_order)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
