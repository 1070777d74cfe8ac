"""The second-order error transfer matrix's gradient of the PyTorch
port: ``torch.autograd`` through ``functional.error_transfer_matrix`` /
``batched_error_transfer_matrix`` with ``second_order=True`` against
``jax.jvp`` of the JAX package's functional ETMs off degeneracy, where
both packages' eigendecomposition backward is exact (JAX's functional
ETM runs forward mode only), for the four spectrum kinds of
tests/test_torch_etm.py; and the flagship (the degenerate 4-qubit QFT
pulse) against central differences, where JAX's ``_eigh_jvp`` masks the
degenerate pairs and there is no JAX oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu_torch import functional, numeric
from filter_functions_tpu_torch.models import qft
from test_torch_etm import (KINDS, _against_central, _arrays, _etm_grad,
                            _etm_loss, _pair, _spectrum)


@pytest.mark.parametrize('entry', ['functional', 'batched'])
@pytest.mark.parametrize('kind', KINDS)
def test_second_order_gradient_matches_jax_jvp(kind, entry):
    """Random d = 3 pulses of 4 segments (tests/test_torch_etm.py's
    seeds), 24 frequencies: the port's autograd directional derivative of
    a seeded weighted sum of the second-order ETM along a seeded direction
    in c_coeffs is within 1e-12 relative of ``jax.jvp`` of the JAX
    package's (measured 1.9e-16 to 2.8e-14); a batch of
    two (controls scaled by 1 and 1.01) through the batched entry
    points.  No segment is degenerate, so no degenerate-eigenspace term
    is built."""
    jp, p = _pair(3, 4, 40 + KINDS.index(kind))
    omega = np.geomspace(0.1, 10, 24)
    spectrum = _spectrum(kind, omega)
    jarr, arr = _arrays(jp)
    jcall = jfunctional.error_transfer_matrix
    if entry == 'batched':
        scales = np.array([1.0, 1.01])[:, None, None]
        arr = arr._replace(c_coeffs=torch.as_tensor(scales) * arr.c_coeffs,
                           n_coeffs=arr.n_coeffs.expand(2, -1, -1),
                           dt=arr.dt.expand(2, -1))
        jarr = jarr._replace(c_coeffs=jnp.asarray(arr.c_coeffs.numpy()),
                             n_coeffs=jnp.asarray(arr.n_coeffs.numpy()),
                             dt=jnp.asarray(arr.dt.numpy()))
        jcall = jfunctional.batched_error_transfer_matrix
    rng = np.random.default_rng(18 + KINDS.index(kind))
    weights = rng.standard_normal((*arr.c_coeffs.shape[:-2], 9, 9))
    direction = rng.standard_normal(arr.c_coeffs.shape)
    eigvals = torch.linalg.eigvalsh(torch.einsum(
        'jmn,...jg->...gmn', arr.c_opers, arr.c_coeffs.to(torch.cdouble)))
    assert not numeric._reaches_degenerate(
        eigvals.requires_grad_(True), eigvals)

    def jloss(c):
        return (jcall(jarr._replace(c_coeffs=c), spectrum, omega, jp.basis,
                      second_order=True) * weights).sum()

    _, want = jax.jvp(jloss, (jarr.c_coeffs,), (jnp.asarray(direction),))
    grad = _etm_grad(_etm_loss(arr, p.basis, spectrum, omega, True,
                               torch.as_tensor(weights)), arr.c_coeffs)
    got = (grad * torch.as_tensor(direction)).sum().item()
    assert abs(got - float(want)) <= 1e-12 * abs(float(want)), (got, want)


def test_flagship_second_order_gradient_against_central_differences():
    """The flagship (4-qubit QFT pulse, d = 16, 256-element basis,
    degenerate on segments 0-2) at 64 frequencies in geomspace(1e-2, 1e2),
    S = 1e-4/omega, batch 1: the autograd directional derivative of its
    second-order ETM weighted by ``default_rng(14)`` normals along a
    direction from the same generator is within 1e-6 relative of central
    differences at h = 1e-6 (measured 5.7e-9)."""
    p = qft.qft_pulse_arrays(4, device='cpu')
    basis = qft.qft_pulse_sequence(4, device='cpu').basis
    omega = np.geomspace(1e-2, 1e2, 64)
    rng = np.random.default_rng(14)
    weights = torch.tensor(rng.standard_normal((256, 256)))
    direction = torch.tensor(rng.standard_normal(tuple(p.c_coeffs.shape)))
    got, central = _against_central(
        _etm_loss(p, basis, torch.as_tensor(1e-4 / omega), omega, True,
                  weights), p.c_coeffs, direction)
    assert abs(got - central) <= 1e-6 * abs(central), (got, central)
