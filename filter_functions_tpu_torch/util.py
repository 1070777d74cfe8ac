"""Array utilities of the PyTorch port (counterparts of
``filter_functions_tpu.util``)."""
from __future__ import annotations

import torch


def adot(mats: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Accumulated matrix product along *dim*:
    ``out[g] = mats[g] @ mats[g-1] @ ... @ mats[0]``.

    A plain sequential product: the pulses of this library have tens of
    segments, so the JAX package's log-depth scan buys nothing here.
    """
    mats = mats.movedim(dim, 0)
    out = [mats[0]]
    for g in range(1, mats.shape[0]):
        out.append(mats[g] @ out[-1])
    return torch.stack(out).movedim(0, dim)


def integrate(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Trapezoidal integral of *f* over its last axis at sample points
    *x*."""
    return ((f[..., 1:] + f[..., :-1]) * torch.diff(x)).sum(-1) / 2
