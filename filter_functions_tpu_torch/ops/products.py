r"""The int8 slice products of the factored Ozaki contraction, with their
recombination, in one CUDA kernel.

:func:`.ozaki._outer_contract` hands each call's three Gauss products
here on CUDA tensors: per product, the P slices with their row scale and
the digit planes of D with their column scale.  The kernel of
``csrc/ozaki_products.cu`` sums each level's slice-pair products in
int32, folds the levels into a double-single pair, widens, scales and
combines the three products into (re, im), all in one launch, bit-exact
against the composite :func:`.ozaki._outer_contract_plain`.

* :func:`check` -- what both versions take: raises on a wrong dtype,
  shape, device mix or slice count; returns the number of levels.
* :func:`ozaki_products` -- the launch (CUDA tensors only).
* :data:`launches` -- how many times the kernel was launched.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

#: Number of CUDA kernel launches made by :func:`ozaki_products`.
launches = 0

#: Most levels (digit slices a side) the kernel takes: the route's
#: n_d = ceil(30 / slice_bits) for slice widths 5 to 7.
MAX_SLICES = 6
#: Slice widths the kernel takes: every width the deep route gives keeps
#: a level's int32 sum exact.
SLICE_BITS = (5, 6, 7)
#: Alignment of every operand row and base address (16-byte copies).
_ALIGN = 16

Side = Tuple[Sequence[torch.Tensor], torch.Tensor]


def check(pr: Side, pi: Side, ps: Side, outs: Sequence[Side],
          slice_bits: int) -> int:
    """Checks the arguments of the slice products; returns n, the number
    of levels: ceil(30 / slice_bits), the digits of D's 30-bit words,
    which each side must hold at least (the composite uses the fewer).

    pr, pi, ps: (slices, scale), the slices (B, M, K) int8 and the scale
    (B, M, 1), float32 on all three or float64 on all three.  outs: three
    (slices, scale), the slices (B, K, N) int8 and the scale (B, 1, N)
    float64.  All on one device."""
    sides = (pr, pi, ps)
    if len(outs) != 3:
        raise ValueError(f'three Gauss products take three D sides, got '
                         f'{len(outs)}')
    tensors = [t for sl, sc in (*sides, *outs) for t in (*sl, sc)]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError('slices and scales are tensors')
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'slices and scales on several devices: {devices}')
    device, = devices
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'the slice products run on CPU or CUDA tensors, '
                         f'got {device}')
    if slice_bits not in SLICE_BITS:
        raise ValueError(f'slice_bits must be one of {SLICE_BITS}, got '
                         f'{slice_bits}')
    n = -(-30 // slice_bits)
    counts = [min(len(a), len(d)) for (a, _), (d, _) in zip(sides, outs)]
    if counts != [n] * 3:
        raise ValueError(f'{slice_bits}-bit slices of the 30-bit D words '
                         f'make {n} levels; got {counts} slices')
    a0, d0 = pr[0][0], outs[0][0][0]
    if a0.dim() != 3 or d0.dim() != 3:
        raise ValueError(f'slices are (B, M, K) and (B, K, N), got '
                         f'{tuple(a0.shape)} and {tuple(d0.shape)}')
    B, M, K = a0.shape
    N = d0.shape[-1]
    a_dtype = pr[1].dtype
    if a_dtype not in (torch.float32, torch.float64):
        raise TypeError(f'the P scales are float32 or float64, got '
                        f'{a_dtype}')
    for (a_sl, a_sc), (d_sl, d_sc) in zip(sides, outs):
        for x in a_sl[:n]:
            _want(x, torch.int8, (B, M, K), 'P slice')
        for x in d_sl[:n]:
            _want(x, torch.int8, (B, K, N), 'D slice')
        _want(a_sc, a_dtype, (B, M, 1), 'P scale')
        _want(d_sc, torch.float64, (B, 1, N), 'D scale')
    return n


def _want(x: torch.Tensor, dtype, shape, what: str) -> None:
    if x.dtype != dtype:
        raise TypeError(f'a {what} is {dtype}, got {x.dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'a {what} has shape {tuple(shape)}, got '
                         f'{tuple(x.shape)}')


def _aligned(x: torch.Tensor) -> bool:
    """Whether TMA reads the (B, R, K) operand as it is: K contiguous and
    a multiple of 16 bytes, rows and pulses 16-byte multiples apart and
    not overlapping, the base 16-byte aligned."""
    B, R, K = x.shape
    return (x.stride(-1) == 1 and K % _ALIGN == 0
            and x.stride(1) % _ALIGN == 0 and x.stride(1) >= K
            and x.stride(0) % _ALIGN == 0 and x.stride(0) >= R * x.stride(1)
            and x.data_ptr() % _ALIGN == 0)


def _k_major(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """(B, R, K) operands as the kernel reads them, all with one set of
    strides: the operands themselves where they are so (the port's slices
    and digit planes at K % 16 == 0), else copies with K zero-padded to a
    multiple of 16, which adds nothing to the products."""
    if all(_aligned(x) for x in xs) and len({x.stride() for x in xs}) == 1:
        return xs
    B, R, K = xs[0].shape
    out = xs[0].new_zeros(len(xs), B, R, -(-K // _ALIGN) * _ALIGN)
    for o, x in zip(out, xs):
        o[..., :K] = x
    return list(out)


def ozaki_products(pr: Side, pi: Side, ps: Side, outs: Sequence[Side],
                   slice_bits: int, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) = (p1 - p2, p3 - p1 - p2) of the three Gauss products
    p_t = sum_s 2^(-slice_bits s) sum_i A_{t,i} @ D_{t,s-i}, scaled by the
    sides' scales, in one kernel launch; (B, M, N) float64 each.

    Arguments as :func:`check` has passed them, on a CUDA device, and the
    number of levels *n* it returned."""
    global launches
    device = pr[0][0].device
    if device.type != 'cuda':
        raise ValueError(f'ozaki_products launches a CUDA kernel; got '
                         f'tensors on {device}')
    B, M, K = pr[0][0].shape
    N = outs[0][0][0].shape[-1]
    a = _k_major([x for sl, _ in (pr, pi, ps) for x in sl[:n]])
    d = _k_major([x.transpose(-1, -2) for sl, _ in outs for x in sl[:n]])
    a_sc = [sc.reshape(B, M).contiguous() for _, sc in (pr, pi, ps)]
    d_sc = [sc.reshape(B, N).contiguous() for _, sc in outs]
    re = torch.empty((B, M, N), dtype=torch.float64, device=device)
    im = torch.empty_like(re)

    def slots(xs):
        return [x.data_ptr() for x in xs] + [0] * (MAX_SLICES - len(xs))

    ptrs = [p for xs in (a, d) for t in range(3)
            for p in slots(xs[t * n:(t + 1) * n])] \
        + [x.data_ptr() for x in (*a_sc, *d_sc, re, im)]
    dims = [B, M, N, a[0].shape[-1], n, slice_bits, *a[0].stride()[:2],
            *d[0].stride()[:2], int(a_sc[0].dtype == torch.float64)]
    fn = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn((ctypes.c_uint64 * len(ptrs))(*ptrs),
                 (ctypes.c_int64 * len(dims))(*dims), stream)
    if err != 0:
        raise RuntimeError(f'ozaki_products kernel launch failed with CUDA '
                           f'error {err}')
    launches += 1
    return re, im


def _launcher():
    fn = _build.load('ozaki_products').ozaki_products_launch
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn
