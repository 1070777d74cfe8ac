"""Autograd of the port's second-order error transfer matrix
(``functional.batched_error_transfer_matrix(..., second_order=True)``)
against the benchmark's plain reference for robust GRAPE
(``perfbench/reference/qft4_etm2_grape.py``): the derivative of each
row's loss L = ||E - I||_F^2 along seeded orthonormal directions in its
control amplitudes, grad . v, against the reference's five-point central
differences of L, on a d = 4 pulse (2 control and 3 noise operators,
5 segments, the 16-element GGM basis, 48 frequencies, batch 2):

* with one zero-amplitude segment, H = 0 there (one eigenspace of
  dimension d), where the derivative runs through the
  degenerate-eigenspace terms; without them it misses by far;
* with every segment's spectrum distinct.

The reference is imported from the benchmark's files, so an edit there
changes what these tests hold the port to.
"""
import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional, numeric
from filter_functions_tpu_torch.basis import Basis
from perfbench.reference import qft4_etm2_grape as grape

#: The gap of grad . v to the central differences, over the largest of a
#: row's, is the differences' rounding, ~eps L / h with h = 1e-3: it
#: reads 6.8e-12 and 8.1e-12 here, where L ~ 0.2 - 0.5.  The float32
#: reference reads 7.9e-3 and 1.7e-2; without the degenerate terms the
#: degenerate pulse reads 7.8e-2.
TOL = 1e-7


def _herm(n, d, rng):
    a = rng.standard_normal((n, d, d)) + 1j * rng.standard_normal((n, d, d))
    h = a + a.conj().transpose(0, 2, 1)
    return h - np.trace(h, axis1=1, axis2=2)[:, None, None] * np.eye(d) / d


def _pulse(degenerate: bool):
    rng = np.random.default_rng(2025)
    d, G, batch = 4, 5, 2
    c_coeffs = rng.standard_normal((batch, 2, G))
    if degenerate:
        c_coeffs[:, :, 2] = 0.0
    arrays = [torch.tensor(_herm(2, d, rng)), torch.tensor(c_coeffs),
              torch.tensor(_herm(3, d, rng)),
              torch.tensor(rng.random((batch, 3, G))),
              torch.tensor(1 - rng.random((batch, G)))]
    q, _ = np.linalg.qr(rng.standard_normal((batch, 2 * G, 2)))
    directions = torch.tensor(q.transpose(0, 2, 1).reshape(batch, 2, 2, G))
    omega = torch.tensor(np.geomspace(1e-1, 1e1, 48))
    return arrays, Basis.ggm(d), omega, 1e-2 / omega, directions


def _slopes(arrays, basis, omega, spectrum, directions):
    """grad . v of the port's summed loss, (batch, 2)."""
    b = basis.tensor('cpu')
    c = arrays[1].clone().requires_grad_(True)
    p = functional.PulseArrays(arrays[0], c, *arrays[2:], b)
    etm = functional.batched_error_transfer_matrix(p, spectrum, omega,
                                                   basis, second_order=True)
    grad, = torch.autograd.grad(grape.losses(etm).sum(), c)
    return torch.einsum('rkg,rjkg->rj', grad, directions)


def _gap(got, want):
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


@pytest.fixture(scope='module', params=['degenerate', 'distinct'])
def case(request):
    arrays, basis, omega, spectrum, directions = _pulse(
        request.param == 'degenerate')
    want = grape.directional_derivatives(*arrays, basis.tensor('cpu'),
                                         omega, spectrum, directions)
    return request.param, (arrays, basis, omega, spectrum, directions), want


def test_port_gradient_holds_the_central_differences(case):
    _, args, want = case
    assert _gap(_slopes(*args), want) < TOL


def test_without_the_degenerate_terms_it_misses(case, monkeypatch):
    """Dropped, the degenerate-eigenspace terms move the derivative at
    the degenerate pulse far past the tolerance, and nothing at the
    distinct one (they are built only where an eigenspace is
    degenerate)."""
    name, args, want = case
    monkeypatch.setattr(numeric, '_degenerate_control_matrix',
                        lambda *a, **k: None)
    monkeypatch.setattr(numeric, '_degenerate_incomplete_steps',
                        lambda *a, **k: None)
    gap = _gap(_slopes(*args), want)
    if name == 'degenerate':
        assert gap > 1e4 * TOL
    else:
        assert gap < TOL


def test_float32_reference_fails(case):
    _, args, want = case
    arrays, basis, omega, spectrum, directions = args
    low = grape.directional_derivatives(*arrays, basis.tensor('cpu'), omega,
                                        spectrum, directions, 'float32')
    assert _gap(low, want) > 10 * TOL
