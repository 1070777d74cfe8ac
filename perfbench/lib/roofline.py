"""Peaks of the card and the operations and bytes of the program's
kernels, against which a kernel's time is held.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
700 W limit): 80 GB of HBM3 at 3.35 TB/s; 1979 TOP/s in int8 and
67 TFLOP/s in FP64 on the tensor cores, dense.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def dword_digits_bytes(K: int, J: int, C: int, n_d: int, batch: int) -> int:
    """Least bytes one ``dword_digits`` call moves: its four int32 factor
    arrays, (batch, K, J) twice and (batch, K, C) twice, read once, and
    its int8 digits (batch, 3, n_d, J C, K) and int32 shifts
    (batch, 3, J C) written once."""
    reads = batch * K * 2 * (J + C) * 4
    writes = batch * 3 * J * C * (n_d * K + 4)
    return reads + writes


def dword_digits_bound_s(K: int, J: int, C: int, n_d: int,
                         batch: int) -> float:
    """The call's memory floor: its bytes at the HBM rate (the kernel
    does integer work only, far under its compute peak)."""
    return dword_digits_bytes(K, J, C, n_d, batch) / HBM_BYTES_PER_S
