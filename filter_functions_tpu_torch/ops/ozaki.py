r"""Near-f64 complex matrix product from exact int8 products (Ozaki
splitting), the deep factored route of the control-matrix contraction.

Port of ``filter_functions_tpu.ops.ozaki.ozaki_matmul_c_outer`` with
int8 digits and double-single ('ds') recombination -- the route the JAX
package runs on an accelerator -- and its custom backward.  The
operand P is split into int8 digit slices with power-of-two row scales;
the operand ``D[k, (j c)] = B[k, j] * C[k, c]`` is never assembled in
floating point: its digits come from 23-bit fixed-point factors through
:func:`.dword.dword_digits`.  Every slice product is an int8 GEMM that
accumulates exactly in int32; the levels are summed in two-float32
arithmetic and widened to float64 once.  On CUDA tensors one kernel
(:func:`.products.ozaki_products`) does all of that for a call's three
Gauss products; on the CPU the composite :func:`_outer_contract_plain`
(``torch._int_mm`` and elementwise operations) does.

The arithmetic follows the JAX package expression for expression, so on
equal inputs the result is bit-exact against it.  The digit pipeline has
no derivative; the backward applies the product rule to the map
(P, B, C) -> P @ D in complex128 and launches no kernel.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from .. import config, tracing
from . import dword, products

#: int8 digit width: 7-bit digits keep every K <= 2^17 slice product sum
#: exact in the int32 accumulator.
_INT8_SLICE_BITS = 7
#: Fixed-point width of the B and C factors: the int32 headroom limit of
#: the 12-bit-split outer words.
_FACTOR_BITS = 23


def _slice_params(K: int, precision_bits: int) -> Tuple[int, int]:
    """(slice_bits, n_slices) of a K-deep reduction on the int8 route."""
    slice_bits = min(_INT8_SLICE_BITS,
                     (31 - math.ceil(math.log2(max(K, 2)))) // 2)
    max_level = max(1, -(-(precision_bits + 1) // slice_bits) - 1)
    return slice_bits, max_level + 1


def _slice_fixed_point(x: torch.Tensor, n_slices: int, slice_bits: int
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Split x (..., K) into n_slices int8 digit slices with a power-of-two
    scale per row (over the last axis), error-free.

    One headroom bit (the scale is doubled) keeps the top digit, like
    every lower one, within 2^(slice_bits - 1), so all digits fit int8.
    float32 input takes the float cascade; float64 input an exact
    fixed-point integer (int32 up to 30 bits, int64 up to 52) peeled by
    shifts.  Returns the slices, high first, and the (..., 1) scale.
    """
    absmax = x.abs().amax(-1, keepdim=True)
    exp = torch.ceil(torch.log2(torch.where(absmax > 0, absmax, 1.0))) + 1
    scale = torch.exp2(exp - slice_bits)
    total_bits = n_slices * slice_bits
    if x.dtype == torch.float32:
        int_dtype = None
    elif total_bits <= 30:
        int_dtype = torch.int32
    elif total_bits <= 52:
        int_dtype = torch.int64
    else:
        int_dtype = None
    if int_dtype is not None:
        z = torch.round(x * torch.exp2(total_bits - exp)).to(int_dtype)
        slices = []
        for k in range(n_slices - 1, 0, -1):
            shift = slice_bits * k
            d = (z + (1 << (shift - 1))) >> shift     # round-half-up digit
            slices.append(d.to(torch.int8))
            z = z - (d << shift)
        slices.append(z.to(torch.int8))
        return slices, scale
    radix = float(2**slice_bits)
    y = x * torch.exp2(slice_bits - exp)
    slices = []
    for _ in range(n_slices):
        s = torch.round(y)
        slices.append(s.to(torch.int8))
        y = (y - s) * radix
    return slices, scale


def _ds_from_int32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact double-single (hi, lo) float32 pair of an int32 level sum:
    hi is a multiple of 2^16 with <= 15 significant bits, lo lies in
    [0, 2^16), so both convert without rounding."""
    hi_i = (v >> 16) << 16
    return hi_i.to(torch.float32), (v - hi_i).to(torch.float32)


def _ds_add(a, b):
    """Two-float Knuth/Dekker addition (ah, al) + (bh, bl), ~2^-48
    relative error, in float32 operations."""
    ah, al = a
    bh, bl = b
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    e = e + (al + bl)
    hi = s + e
    return hi, e - (hi - s)


def _zero_padded(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """*x* (B, R, C) in the top left corner of zeros (B, rows, cols), laid
    out as *x* is (row- or column-major); *x* itself if it fits."""
    B, R, C = x.shape
    if (R, C) == (rows, cols):
        return x
    if x.stride(-2) == 1 and C > 1:
        out = x.new_zeros(B, cols, rows).transpose(-1, -2)
    else:
        out = x.new_zeros(B, rows, cols)
    out[:, :R, :C] = x
    return out


def _int_mm_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, K) int8 @ (B, K, N) int8 -> (B, M, N) int32, exact.

    ``torch._int_mm`` on CUDA takes M > 16 and K, N multiples of 8 only
    (the CPU takes every shape): the operands are padded with zeros up to
    that, which adds nothing to the product, and the product is cut back
    to (M, N)."""
    M, K = a.shape[-2:]
    N = b.shape[-1]
    depth = -(-K // 8) * 8
    a = _zero_padded(a, max(M, 17), depth)
    b = _zero_padded(b, depth, -(-N // 8) * 8)
    return torch.stack([torch._int_mm(a[i], b[i])
                        for i in range(a.shape[0])])[:, :M, :N]


def _matmul_from_slices(a_sl: Sequence[torch.Tensor],
                        b_sl: Sequence[torch.Tensor],
                        slice_bits: int) -> torch.Tensor:
    """sum_{i+j <= L} 2^(-slice_bits (i+j)) A_i @ B_j in float64.

    Each level sum_{i+j=s} A_i @ B_j is exact in int32; the levels are
    scaled by powers of two and summed in double-single float32, then
    widened to float64 once.  a_sl: (B, M, K) int8; b_sl: (B, K, N) int8.
    """
    out = None
    for s in range(len(a_sl)):
        level = None
        for i in range(s + 1):
            prod = _int_mm_batched(a_sl[i], b_sl[s - i])
            level = prod if level is None else level + prod
        scale = 2.0**(-slice_bits * s)
        hi, lo = _ds_from_int32(level)
        term = (hi * scale, lo * scale)
        out = term if out is None else _ds_add(out, term)
    return out[0].to(torch.float64) + out[1].to(torch.float64)


def _fix(re: torch.Tensor, im: torch.Tensor):
    """23-bit int32 fixed point of (..., K, n) factors, one power-of-two
    scale per column shared by re and im.  Returns (zr, zi, e) with
    x ~= z * 2^(e - 23)."""
    absmax = torch.maximum(re.abs().amax(-2), im.abs().amax(-2))
    e = torch.ceil(torch.log2(torch.where(absmax > 0, absmax, 1.0)))
    factor = torch.exp2(_FACTOR_BITS - e)[..., None, :]
    return (torch.round(re * factor).to(torch.int32),
            torch.round(im * factor).to(torch.int32), e)


def _outer_contract(pr, pi, ps, outs, slice_bits):
    """Slice products and Gauss recombination of the factored route.

    pr, pi, ps: (slices (B, M, K) int8, row scale (B, M, 1)) of P's
    three Gauss components; outs: (slices (B, K, N) int8, column scale
    (B, 1, N) float64) of D's.  CUDA tensors take one launch of the
    kernel of :mod:`.products`, CPU tensors the composite
    :func:`_outer_contract_plain`; both give the same bits.  Counts the
    products' int8 operations, 3 B sum_pairs 2 M K N, in
    ``tracing.counts['ozaki.int8_ops']``."""
    n = products.check(pr, pi, ps, outs, slice_bits)
    B, M, K = pr[0][0].shape
    N = outs[0][0][0].shape[-1]
    tracing.counts['ozaki.int8_ops'] += \
        3 * B * (n * (n + 1) // 2) * 2 * M * K * N
    with tracing.span('ff.ozaki.products'):
        if pr[0][0].device.type == 'cuda':
            return products.ozaki_products(pr, pi, ps, outs, slice_bits,
                                           n)
        return _outer_contract_plain(pr, pi, ps, outs, slice_bits)


def _outer_contract_plain(pr, pi, ps, outs, slice_bits):
    """The plain version of :func:`_outer_contract`: each slice pair's
    int8 GEMM, the level sums, the double-single recombination and the
    Gauss combination as torch operations."""
    def mm(a, d):
        a_sl, a_sc = a
        d_sl, d_sc = d
        n = min(len(a_sl), len(d_sl))
        out = _matmul_from_slices(a_sl[:n], d_sl[:n], slice_bits)
        return out * a_sc * d_sc

    p1 = mm(pr, outs[0])
    p2 = mm(pi, outs[1])
    p3 = mm(ps, outs[2])
    # Gauss: re = Pr Dr - Pi Di; im = (Pr + Pi)(Dr + Di) - p1 - p2
    return p1 - p2, p3 - p1 - p2


def ozaki_matmul_c_outer(p_re: torch.Tensor, p_im: torch.Tensor,
                         b_re: torch.Tensor, b_im: torch.Tensor,
                         c_re: torch.Tensor, c_im: torch.Tensor,
                         precision_bits: int = config.DEEP_PRECISION_BITS
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Complex ``P @ D`` with ``D[k, (j c)] = B[k, j] * C[k, c]``, without
    assembling D.

    P: (..., M, K) split re/im, float32 or float64; B: (..., K, J) and
    C: (..., K, C) float64, with the same leading axes as P.  Returns
    (re, im) of shape (..., M, J * C) in float64.  Requires a deep
    reduction (K > 256, int8 slice width 5 to 7 bits).

    Differentiable (:class:`_OzakiOuter`): the backward assembles D once
    in complex128 and returns each gradient in its input's dtype.
    """
    return _OzakiOuter.apply(p_re, p_im, b_re, b_im, c_re, c_im,
                             precision_bits)


class _OzakiOuter(torch.autograd.Function):
    r"""The factored product with the JAX package's custom VJP
    (``_ozaki_c_outer_bwd``): for the cotangent g of P @ D,

        dP = g D^H,  dD = P^H g,
        dB[k, j] = sum_c dD[k, (j c)] conj C[k, c],
        dC[k, c] = sum_j dD[k, (j c)] conj B[k, j],

    as complex128 ``torch.matmul``; P, B and C are saved, D is not."""

    @staticmethod
    def forward(ctx, p_re, p_im, b_re, b_im, c_re, c_im, precision_bits):
        ctx.save_for_backward(p_re, p_im, b_re, b_im, c_re, c_im)
        return _ozaki_outer_forward(p_re, p_im, b_re, b_im, c_re, c_im,
                                    precision_bits)

    @staticmethod
    def backward(ctx, g_re, g_im):
        p_re, p_im, b_re, b_im, c_re, c_im = ctx.saved_tensors
        cplx = config.COMPLEX
        b = torch.complex(b_re, b_im).to(cplx)
        c = torch.complex(c_re, c_im).to(cplx)
        p = torch.complex(p_re.to(config.REAL), p_im.to(config.REAL))
        g = torch.complex(g_re, g_im).to(cplx)
        J, Cc = b.shape[-1], c.shape[-1]
        d = (b[..., :, None] * c[..., None, :]).reshape(*b.shape[:-1], J * Cc)
        dp = g @ d.mH
        dd = (p.mH @ g).reshape(*d.shape[:-1], J, Cc)
        db = torch.einsum('...kjc,...kc->...kj', dd, c.conj())
        dc = torch.einsum('...kjc,...kj->...kc', dd, b.conj())
        return (dp.real.to(p_re.dtype), dp.imag.to(p_im.dtype),
                db.real.to(b_re.dtype), db.imag.to(b_im.dtype),
                dc.real.to(c_re.dtype), dc.imag.to(c_im.dtype), None)


def _ozaki_outer_forward(p_re, p_im, b_re, b_im, c_re, c_im,
                         precision_bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward pass of :func:`ozaki_matmul_c_outer`."""
    K = p_re.shape[-1]
    slice_bits, n_p = _slice_params(K, precision_bits)
    if slice_bits not in (5, 6, 7) or K <= 256:
        raise ValueError('factored path requires slice_bits in (5..7) '
                         f'and deep K > 256, got slice_bits={slice_bits} '
                         f'for K={K}')
    # D's digits cover the 30-bit word, and the P side slices as deep as
    # D (see the JAX package's ozaki._ozaki_matmul_c_outer_impl)
    n_d = -(-30 // slice_bits)
    n_p = max(n_p, n_d)
    nbits = n_d * slice_bits

    lead = p_re.shape[:-2]
    M = p_re.shape[-2]
    J, Cc = b_re.shape[-1], c_re.shape[-1]
    p_re, p_im = p_re.reshape(-1, M, K), p_im.reshape(-1, M, K)
    b_re, b_im = b_re.reshape(-1, K, J), b_im.reshape(-1, K, J)
    c_re, c_im = c_re.reshape(-1, K, Cc), c_im.reshape(-1, K, Cc)

    pr = _slice_fixed_point(p_re, n_p, slice_bits)
    pi = _slice_fixed_point(p_im, n_p, slice_bits)
    ps = _slice_fixed_point(p_re + p_im, n_p, slice_bits)

    zbr, zbi, eb = _fix(b_re, b_im)
    zcr, zci, ec = _fix(c_re, c_im)
    e_bc = (eb[..., :, None] + ec[..., None, :]).reshape(-1, J * Cc)
    digits, dshifts = dword.dword_digits(zbr, zbi, zcr, zci, n_d,
                                         slice_bits)
    outs = []
    for t in range(3):
        # (J*C, K) planes -> K-contiguous (K, J*C) GEMM operands
        d_sl = [digits[:, t, s].transpose(-1, -2) for s in range(n_d)]
        d_sc = torch.exp2((e_bc - 28 - dshifts[:, t]
                           + (nbits - slice_bits)).to(torch.float64)
                          )[..., None, :]
        outs.append((d_sl, d_sc))
    re, im = _outer_contract(pr, pi, ps, outs, slice_bits)
    return re.reshape(*lead, M, J * Cc), im.reshape(*lead, M, J * Cc)
