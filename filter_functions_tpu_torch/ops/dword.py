r"""Digit slices of the factored D operand of the Ozaki contraction.

For ``D[k, (j c)] = B[k, j] * C[k, c]`` given as 23-bit int32 fixed-point
factors, :func:`dword_digits` forms the three Gauss components Dr, Di
and Dr + Di as 30-bit int32 words, normalizes every column to the digit
budget and peels ``n_d`` int8 digits, high digit first.  All arithmetic
is int32 and identical to the JAX package's (its XLA pipeline in
``ops/ozaki._ozaki_matmul_c_outer_impl`` and its Pallas kernel
``ops/dword_pallas.dword_digits``), so every version here is bit-exact
against both.

* :func:`dword_digits_reference` -- the plain torch version, in the JAX
  layout.
* :func:`dword_digits` -- the wrapper: CPU tensors take the plain
  version; CUDA tensors launch the kernel of ``csrc/dword_digits.cu``
  (or raise).  Its digits come in the layout the int8 GEMM wants.
* :data:`launches` -- how many times the CUDA kernel was launched.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

#: Number of CUDA kernel launches made by :func:`dword_digits`.
launches = 0


def _split12(z):
    hi = (z + (1 << 11)) >> 12
    return hi, z - (hi << 12)


def _outer_word(b1, b0, c1, c0):
    """30-bit int32 word ~ (zB * zC) / 2^18 of the row-wise outer product
    of (..., K, J) and (..., K, C) factors -> (..., K, J, C)."""
    b1, b0 = b1[..., :, None], b0[..., :, None]
    c1, c0 = c1[..., None, :], c0[..., None, :]
    p2 = b1 * c1
    p1 = b1 * c0 + b0 * c1
    p0 = b0 * c0
    return (p2 << 6) + ((p1 + ((p0 + (1 << 11)) >> 12) + (1 << 5)) >> 6)


def dword_digits_reference(zbr: torch.Tensor, zbi: torch.Tensor,
                           zcr: torch.Tensor, zci: torch.Tensor,
                           n_d: int, slice_bits: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch digit pipeline.

    zbr/zbi: (B, K, J) int32; zcr/zci: (B, K, C) int32.  Returns digits
    (B, 3, n_d, K, J*C) int8 -- components Dr, Di, Dr+Di, high digit
    first, the JAX layout -- and shifts (B, 3, J*C) int32.
    """
    B, K, J = zbr.shape
    C = zcr.shape[-1]
    sb1, sb0 = _split12(zbr)
    si1, si0 = _split12(zbi)
    sc1, sc0 = _split12(zcr)
    sd1, sd0 = _split12(zci)
    w_rr = _outer_word(sb1, sb0, sc1, sc0)
    w_ii = _outer_word(si1, si0, sd1, sd0)
    w_ri = _outer_word(sb1, sb0, sd1, sd0)
    w_ir = _outer_word(si1, si0, sc1, sc0)
    dr = w_rr - w_ii
    di = w_ri + w_ir
    nbits = n_d * slice_bits
    digits, shifts = [], []
    for w in (dr, di, dr + di):
        w = w.reshape(B, K, J * C)
        colmax = w.abs().amax(-2)
        # ceil(log2(max(colmax, 1))) is the bit length of
        # max(colmax, 1) - 1; frexp's exponent is that bit length,
        # exactly, for every int32 magnitude
        e_w = torch.frexp((colmax.clamp(min=1) - 1).double()).exponent
        shift = min(nbits, 30) - 1 - e_w
        lshift = shift.clamp(min=0)[..., None, :]
        rshift = (-shift).clamp(min=0)[..., None, :]
        half = (torch.ones_like(rshift) << rshift) >> 1
        z = ((w << lshift) + half) >> rshift
        peeled = []
        for s in range(n_d - 1, 0, -1):
            sh = slice_bits * s
            d = (z + (1 << (sh - 1))) >> sh
            peeled.append(d.to(torch.int8))
            z = z - (d << sh)
        peeled.append(z.to(torch.int8))
        digits.append(torch.stack(peeled, 1))
        shifts.append(shift)
    return torch.stack(digits, 1), torch.stack(shifts, 1)


def _check(zbr, zbi, zcr, zci, n_d, slice_bits):
    if not all(t.dtype == torch.int32 and t.dim() == 3
               for t in (zbr, zbi, zcr, zci)):
        raise TypeError('dword_digits takes (B, K, J) and (B, K, C) int32 '
                        'factors')
    if zbi.shape != zbr.shape or zci.shape != zcr.shape or \
            zcr.shape[:2] != zbr.shape[:2]:
        raise ValueError(f'factor shapes disagree: {tuple(zbr.shape)}, '
                         f'{tuple(zbi.shape)}, {tuple(zcr.shape)}, '
                         f'{tuple(zci.shape)}')
    devices = {t.device for t in (zbr, zbi, zcr, zci)}
    if len(devices) != 1:
        raise ValueError(f'factors on several devices: {devices}')
    if not (1 <= slice_bits <= 8 and 1 <= n_d and
            (n_d - 1) * slice_bits <= 30):
        raise ValueError(f'unsupported digit layout n_d={n_d}, '
                         f'slice_bits={slice_bits}')


def dword_digits(zbr: torch.Tensor, zbi: torch.Tensor,
                 zcr: torch.Tensor, zci: torch.Tensor,
                 n_d: int, slice_bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Digit slices of the factored D operand.

    zbr/zbi: (B, K, J) int32; zcr/zci: (B, K, C) int32, all on one
    device.  Returns digits (B, 3, n_d, J*C, K) int8 -- each (J*C, K)
    plane is the transpose of the JAX layout's (K, J*C) plane, so that
    ``plane.t()`` is the K-contiguous right operand the int8 GEMM
    takes -- and shifts (B, 3, J*C) int32.

    CPU tensors take :func:`dword_digits_reference`; CUDA tensors
    launch the kernel of ``csrc/dword_digits.cu``.  The kernel forms
    each word as one 64-bit product, which equals the plain version's
    12-bit split arithmetic for factors in [-2^23, 2^23]; ``ops.ozaki.
    _fix`` makes factors in that range, and outside it the kernel's
    digits differ.  Up to K = 16384 the kernel keeps the words in
    registers; above that it computes them twice.  Every K is taken.
    """
    global launches
    _check(zbr, zbi, zcr, zci, n_d, slice_bits)
    device = zbr.device
    if device.type == 'cpu':
        digits, shifts = dword_digits_reference(zbr, zbi, zcr, zci, n_d,
                                                slice_bits)
        return digits.transpose(-1, -2).contiguous(), shifts
    if device.type != 'cuda':
        raise ValueError(f'dword_digits runs on CPU or CUDA tensors, got '
                         f'{device}')
    B, K, J = zbr.shape
    C = zcr.shape[-1]
    # the kernel reads each factor column along K: K-contiguous copies
    # of the (tiny) factors make those reads coalesce
    zbr_t, zbi_t, zcr_t, zci_t = (t.transpose(-1, -2).contiguous()
                                  for t in (zbr, zbi, zcr, zci))
    digits = torch.empty((B, 3, n_d, J * C, K), dtype=torch.int8,
                         device=device)
    shifts = torch.empty((B, 3, J * C), dtype=torch.int32, device=device)
    fn = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(zbr_t.data_ptr(), zbi_t.data_ptr(), zcr_t.data_ptr(),
                 zci_t.data_ptr(), digits.data_ptr(), shifts.data_ptr(),
                 B, K, J, C, n_d, slice_bits, stream)
    if err != 0:
        raise RuntimeError(f'dword_digits kernel launch failed with CUDA '
                           f'error {err}')
    launches += 1
    return digits, shifts


def _launcher():
    fn = _build.load('dword_digits').dword_digits_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
