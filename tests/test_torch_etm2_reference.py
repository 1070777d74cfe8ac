"""The port's second-order error transfer matrix
(``functional.batched_error_transfer_matrix(..., second_order=True)``)
against the benchmark's plain reference
(``perfbench/reference/second_order.py``: per-step control matrices,
each segment's K2 lattice by quadrature of its double integral, the
cumulant through the basis's traces), on seeded inputs:

* a d = 4 pulse with one zero-amplitude (fully degenerate) segment, 2
  control and 3 noise operators, the 16-element GGM basis, 64
  frequencies, batch 2: the trace contraction takes the precombined
  combos (n <= 64);
* the 4-qubit QFT pulse of the benchmark's ``qft4`` arrays, one row, at
  20 frequencies: the contraction runs through the 256-element basis.

Each is held on E - I and on the antisymmetric part (E - E^T) / 2, the
coherent error that only the frequency shifts make, as the benchmark's
``qft4_etm2`` cell compares them; the reference's first-order matrices
fail the same tolerance.

The reference is imported from the benchmark's files, so an edit there
changes what these tests hold the port to: such an edit has to keep
this file passing, and the reference must keep importing nothing of the
port.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional
from filter_functions_tpu_torch.basis import Basis
from perfbench.reference import second_order as plain

ARRAYS = Path(__file__).resolve().parents[1] / 'perfbench' / 'data' \
    / 'qft4_arrays.npz'
#: Both sides are float64.  Their gaps read ~5e-15 (d = 4) and ~4e-14
#: (QFT) of the largest entry: the rounding of E (~1e-16) over
#: |E - I| ~ 1e-2, and the port's separable tables, which keep ~4e-13
#: relative on the entries whose general form cancels (|y dt| near
#: 1e-2, ``numeric._second_order_factored_single``), a small share of
#: the sums.  The float32 reference reads ~1e-6 - 2e-5.
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


def _small():
    rng = np.random.default_rng(1905)
    d, G, batch = 4, 5, 2
    c_coeffs = rng.standard_normal((batch, 2, G))
    c_coeffs[:, :, 2] = 0.0                   # H = 0: one eigenspace
    arrays = [torch.tensor(_herm(2, d, rng)), torch.tensor(c_coeffs),
              torch.tensor(_herm(3, d, rng)),
              torch.tensor(rng.random((batch, 3, G))),
              torch.tensor(1 - rng.random((batch, G)))]
    omega = torch.tensor(np.geomspace(1e-1, 1e1, 64))
    return arrays, Basis.ggm(d), omega, 1e-2 / omega


def _qft():
    with np.load(ARRAYS) as z:
        a = {k: torch.as_tensor(z[k]) for k in z.files}
    arrays = [a['c_opers'], a['c_coeffs'][None], a['n_opers'],
              a['n_coeffs'][None], a['dt'][None]]
    omega = torch.tensor(np.geomspace(1e-2, 1e2, 20))
    return arrays, Basis(a['basis'].numpy()), omega, 1e-4 / omega


@pytest.fixture(scope='module', params=['d4_degenerate', 'qft4'])
def case(request):
    arrays, basis, omega, spectrum = (_small() if request.param
                                      == 'd4_degenerate' else _qft())
    b = basis.tensor('cpu')
    p = functional.PulseArrays(*arrays[:5], b)
    port = functional.batched_error_transfer_matrix(p, spectrum, omega,
                                                    basis, second_order=True)

    def reference(second_order):
        return plain.error_transfer_matrices(*arrays, b, omega, spectrum,
                                             second_order=second_order)
    return port, reference(True), reference(False)


def test_port_holds_the_reference(case):
    port, want, _ = case
    etm_gap, coherent_gap = _gaps(port, want)
    assert etm_gap < TOL
    assert coherent_gap < TOL


def test_first_order_fails_the_tolerance(case):
    """Without the frequency shifts the antisymmetric part vanishes: a
    gap of the whole reference part, far over the tolerance."""
    _, want, first = case
    etm_gap, coherent_gap = _gaps(first, want)
    assert etm_gap > 1e3 * TOL
    assert coherent_gap > 0.5
