"""Dtypes and contraction settings of the PyTorch port.

The JAX package reads these settings from ``FF_TPU_*`` environment
variables; the port takes them as keyword arguments with the same
defaults.  Everything is computed in ``float64`` / ``complex128``: the
port passes these dtypes explicitly and never changes torch's global
default dtype.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

#: Real working dtype.
REAL = torch.float64
#: Complex working dtype.
COMPLEX = torch.complex128

#: Ozaki truncation level of shallow contractions (JAX:
#: ``FF_TPU_OZAKI_BITS``); the port runs them natively.
PRECISION_BITS = 30
#: Truncation level of the deep factored contraction (JAX:
#: ``FF_TPU_OZAKI_BITS_DEEP``).
DEEP_PRECISION_BITS = 24
#: Relative noise-to-signal level of the fidelity filter function above
#: which the deep factored contraction is recomputed at full precision
#: (JAX: ``FF_TPU_OZAKI_ESCALATE_TOL``; 0 disables escalation).
ESCALATION_TOL = 0.1

#: Where the entry points that build a pulse (``PulseSequence``,
#: ``PulseSequence.from_arrays``, ``models.qft`` and ``convert``'s
#: conversions) put their tensors unless the caller passes ``device=``.
DEFAULT_DEVICE = 'cuda'

_CONTRACT_MODES = ('native', 'ozaki')


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """*device* as a ``torch.device``.  A CUDA device where no CUDA card
    is available raises: the entry points never fall back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested (the default is "
            f"{DEFAULT_DEVICE!r}), but no CUDA card is available: pass "
            f"device='cpu' to run on the CPU")
    return device


def contraction_mode(device: torch.device,
                     contract: Optional[str] = None) -> str:
    """How the control-matrix contraction runs for tensors on *device*.

    'native' -- one complex128 matrix product.
    'ozaki'  -- the deep factored int8 route (ops/ozaki, ops/dword).

    ``contract=None`` resolves to 'ozaki' for CUDA tensors and 'native'
    for CPU tensors, as the JAX package picks 'ozaki' off the CPU.
    """
    if contract is None:
        return 'ozaki' if torch.device(device).type == 'cuda' else 'native'
    if contract not in _CONTRACT_MODES:
        raise ValueError(f'contract must be one of {_CONTRACT_MODES} or '
                         f'None, got {contract!r}')
    return contract


def memory_budget(device: torch.device,
                  budget_bytes: Optional[int] = None) -> int:
    """Working-buffer byte budget of the chunked control-matrix
    accumulation for tensors on *device*.

    *budget_bytes* (JAX: ``FF_TPU_MEMORY_BUDGET``) is taken as given;
    otherwise an eighth of a CUDA device's total memory, or 2 GiB
    elsewhere, clamped to [64 MiB, 4 GiB], as in the JAX package.  The
    chunking follows the budget; the result does not depend on it.
    """
    if budget_bytes is not None:
        return int(budget_bytes)
    device = torch.device(device)
    if device.type == 'cuda':
        budget = torch.cuda.mem_get_info(device)[1] // 8
    else:
        budget = 2 << 30
    return max(64 << 20, min(budget, 4 << 30))
