"""Superoperator utilities of the PyTorch port (counterpart of
``filter_functions_tpu.superoperator``).

Every function runs on the device of its tensor argument, with the
basis copied there (:meth:`~.basis.Basis.tensor`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import basis as _b
from . import config

__all__ = ['liouville_representation', 'liouville_to_choi',
           'liouville_is_CP', 'liouville_is_cCP']


def liouville_representation(U: torch.Tensor, basis: _b.Basis
                             ) -> torch.Tensor:
    r"""Liouville (transfer-matrix) representation
    U_ij = tr(C_i U C_j U^dag) of unitaries *U* (..., d, d) w.r.t.
    *basis*: real for a hermitian basis, complex otherwise."""
    U = U.to(config.COMPLEX)
    conjugated = torch.einsum('...ba,ibc,...cd->...iad', U.conj(),
                              basis.tensor(U.device), U)
    return _b.expand(conjugated, basis, normalized=basis.isnorm,
                     hermitian=basis.isherm)


def liouville_to_choi(superoperator: torch.Tensor, basis: _b.Basis
                      ) -> torch.Tensor:
    r"""choi(S) = sum_ij S_ij C_j^T (x) C_i, shape (..., d^2, d^2)."""
    s = superoperator.to(config.COMPLEX)
    b = basis.tensor(s.device)
    choi = torch.einsum('...ij,jba,icd->...acbd', s, b, b)
    d2 = choi.shape[-4] * choi.shape[-3]
    return choi.reshape(*choi.shape[:-4], d2, d2)


def _positive(mat: torch.Tensor, basis: _b.Basis, return_eig: bool,
              atol: Optional[float]):
    """Whether the Hermitian *mat* has no eigenvalue below -atol (the
    basis's tolerance by default): a bool, or a bool tensor for a
    batch."""
    eigvals, eigvecs = torch.linalg.eigh(mat)
    tol = atol if atol is not None else basis._atol
    ok = (eigvals >= -tol).all(-1)
    ok = bool(ok) if ok.ndim == 0 else ok
    if return_eig:
        return ok, (eigvals, eigvecs)
    return ok


def liouville_is_CP(superoperator: torch.Tensor, basis: _b.Basis,
                    return_eig: Optional[bool] = False,
                    atol: Optional[float] = None):
    r"""Complete positivity check: choi(S) >= 0."""
    return _positive(liouville_to_choi(superoperator, basis), basis,
                     return_eig, atol)


def liouville_is_cCP(superoperator: torch.Tensor, basis: _b.Basis,
                     return_eig: Optional[bool] = False,
                     atol: Optional[float] = None):
    r"""Conditional complete positivity: Q choi(S) Q >= 0 with Q the
    projector on the complement of the maximally entangled state."""
    d2 = superoperator.shape[-1]
    d = int(np.sqrt(d2))
    omega_vec = np.zeros(d2)
    omega_vec[::d + 1] = 1 / np.sqrt(d)
    q_proj = torch.as_tensor(np.eye(d2) - np.outer(omega_vec, omega_vec),
                             dtype=config.COMPLEX,
                             device=superoperator.device)
    choi = liouville_to_choi(superoperator, basis)
    return _positive(q_proj @ choi @ q_proj, basis, return_eig, atol)
