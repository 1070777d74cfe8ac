r"""Numerical kernels (counterparts of ``filter_functions_tpu.numeric``):
diagonalization (K0), the second-order integral lattice (K2), the
control matrix from scratch (K4: per-segment step terms and their
contraction), from atomic pulses (K5) and of a periodic train (K6), the
noise operators (K7), the filter functions (K8, K9), the second-order
filter function from scratch (K10) and from atomic pulses (K11), the
integrand (K12), decay amplitudes and
frequency shifts (K13, K14), the cumulant function (K15), the error
transfer matrix (K16) and the infidelity (K17).

Complex values are ``complex128`` tensors and reals ``float64``.  The
K0, K2 and K4 helpers and the second-order contractions take any
number of leading batch axes where the JAX package relied on ``vmap``;
shapes below name only the trailing axes.  Host metadata (coefficients,
durations, the basis master copy) may come as numpy and is moved to the
device of the eigenvalues.
"""
from __future__ import annotations

import functools
import math
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)
from warnings import warn

import numpy as np
import torch

from . import config, tracing, util
from .basis import Basis
from .ops import k2_tables, ozaki


def _perm_tail(x: torch.Tensor, *order: int) -> torch.Tensor:
    """Permute the trailing ``len(order)`` axes of *x* by *order*,
    leaving the leading batch axes in place."""
    n_lead = x.ndim - len(order)
    return x.permute(*range(n_lead), *(n_lead + i for i in order))


# -----------------------------------------------------------------------------
# K0: diagonalization
# -----------------------------------------------------------------------------
#: Relative eigenvalue gap at or below which a pair counts as degenerate
#: in the eigendecomposition's backward (the JAX package's
#: ``cplx._eigh_jvp``).
_DEGENERATE_GAP = 1e-12
#: Matrices per ``torch.linalg.eigh`` call: on a CUDA device cuSOLVER's
#: batched solver refuses a batch above about 27 000 (d = 16) to 32 000
#: (d = 2) matrices with CUSOLVER_STATUS_INVALID_VALUE (torch 2.11,
#: CUDA 12.8, H100).
_EIGH_MAX_BATCH = 16384


def _eig_gaps(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_j - w_i, mask of the pairs with |w_j - w_i| <= _DEGENERATE_GAP
    (1 + |w_j|)) of eigenvalues (..., d); the diagonal is in the mask."""
    gaps = w[..., None, :] - w[..., :, None]
    return gaps, gaps.abs() <= _DEGENERATE_GAP * (1 + w[..., None, :].abs())


class _Eigh(torch.autograd.Function):
    r"""``torch.linalg.eigh`` with the backward of the JAX package's
    eigh: the transpose of first-order perturbation theory
    (``cplx._eigh_jvp``) with the degenerate pairs masked,

        gH = V (diag(gw) + F o (V^H gV - gV^H V)/2) V^H,
        F_ij = 1/(w_j - w_i), 0 on the pairs of :func:`_eig_gaps`.

    Inside a degenerate eigenspace the mask drops the first-order terms
    of the off-diagonal entries of V^H dH V, which a smooth function of
    H still has; :class:`_DegeneratePropagator` and
    :class:`_DegenerateControlMatrix` restore them where the pipeline
    uses the eigendecomposition.
    """

    @staticmethod
    def forward(ctx, h):
        flat = h.reshape(-1, *h.shape[-2:])
        parts = [torch.linalg.eigh(part)
                 for part in flat.split(_EIGH_MAX_BATCH)]
        w = torch.cat([p[0] for p in parts]).reshape(h.shape[:-1])
        v = torch.cat([p[1] for p in parts]).reshape(h.shape)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, gw, gv):
        w, v = ctx.saved_tensors
        gaps, degenerate = _eig_gaps(w)
        f = torch.where(degenerate, 0.0,
                        1.0 / torch.where(degenerate, 1.0, gaps))
        x = v.mH @ gv
        inner = f * (x - x.mH) / 2 + torch.diag_embed(gw.to(v.dtype))
        return v @ inner @ v.mH


def _degenerate_grad(coeff: torch.Tensor, w: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    r"""gH of dL = Re sum_{(p,q) degenerate, p != q} coeff_pq M_pq,
    M = V^H dH V: the Hermitian part of V conj(coeff) V^H on those
    pairs."""
    _, degenerate = _eig_gaps(w)
    degenerate = degenerate & ~torch.eye(w.shape[-1], dtype=torch.bool,
                                         device=w.device)
    g = v @ torch.where(degenerate, coeff.conj(), 0.0) @ v.mH
    return (g + g.mH) / 2


class _DegeneratePropagator(torch.autograd.Function):
    r"""Zero in value; its backward is the part of the derivative of the
    segment propagators V e^{-i w dt} V^H that :class:`_Eigh` drops:
    along the off-diagonal entries M_pq of a degenerate eigenspace, the
    divided difference of e^{-i w dt} is -i dt e^{-i w_p dt}.

    forward(h (..., d, d), w (..., d), v (..., d, d), dt (...)), the
    eigendecomposition of h detached."""

    @staticmethod
    def forward(ctx, h, w, v, dt):
        ctx.save_for_backward(w, v, dt)
        return torch.zeros_like(h)

    @staticmethod
    def backward(ctx, g):
        w, v, dt = ctx.saved_tensors
        slope = -1j * dt[..., None] * util.cexp(-dt[..., None] * w)
        coeff = (v.mH @ g @ v).conj() * slope[..., :, None]
        return _degenerate_grad(coeff, w, v), None, None, None


def diagonalize(hamiltonian: torch.Tensor, dt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a piecewise-constant Hamiltonian (G, d, d)
    with segment durations dt (G,), and its cumulative propagators.

    Returns eigvals (G, d), eigvecs (G, d, d) and propagators
    (G+1, d, d) with Q_0 the identity.  Differentiable in the
    Hamiltonian (:class:`_Eigh`, with the degenerate-eigenspace terms of
    the propagators from :class:`_DegeneratePropagator`).
    """
    h = hamiltonian
    d = h.shape[-1]
    eigvals, eigvecs = _Eigh.apply(h)
    phase = util.cexp(-dt[..., None] * eigvals)                 # e^{-i D dt}
    piecewise = (eigvecs * phase[..., None, :]) @ eigvecs.mH
    if torch.is_grad_enabled() and h.requires_grad:
        piecewise = piecewise + _DegeneratePropagator.apply(
            h, eigvals.detach(), eigvecs.detach(), dt.detach())
    cumulative = util.adot(piecewise, axis=-3)
    ident = torch.eye(d, dtype=h.dtype, device=h.device).expand(
        *h.shape[:-3], 1, d, d)
    return eigvals, eigvecs, torch.cat([ident, cumulative], dim=-3)


def assemble_and_diagonalize(c_opers: torch.Tensor, c_coeffs: torch.Tensor,
                             dt: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Hamiltonian assembly sum_j c_coeffs[j, g] c_opers[j] and K0.

    Returns (eigvals (G, d), eigvecs (G, d, d), propagators (G+1, d, d),
    total propagator (d, d))."""
    ham = torch.einsum('jmn,jg->gmn', c_opers, c_coeffs.to(c_opers.dtype))
    eigvals, eigvecs, propagators = diagonalize(ham, dt)
    return eigvals, eigvecs, propagators, propagators[-1]


# -----------------------------------------------------------------------------
# K4: per-segment ingredients of the control matrix
# -----------------------------------------------------------------------------
def _propagate_eigenvectors(propagators: torch.Tensor,
                            eigvecs: torch.Tensor) -> torch.Tensor:
    """Q_g^dag V_g."""
    return propagators.mH @ eigvecs


def _transform_hamiltonian(eigvecs: torch.Tensor, opers: torch.Tensor,
                           coeffs: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """s_a^(g) V_g^dag B_a V_g for eigvecs (G, d, d) and opers (n, d, d)
    -> (n, G, d, d)."""
    v = eigvecs[..., None, :, :, :]                         # (1, G, d, d)
    transformed = v.mH @ opers[:, None] @ v
    if coeffs is not None:
        transformed = transformed * coeffs[..., None, None]
    return transformed


def _first_order_integral_batched(omega: torch.Tensor,
                                  eigvals: torch.Tensor,
                                  dt: torch.Tensor) -> torch.Tensor:
    r"""I^{(g)}_{mn}(omega) = (e^{i phi dt_g} - 1) / (i phi),
    phi = omega + Omega_mn, with the phi -> 0 limit dt_g.

    omega (n_w,), eigvals (G, d), dt (G,) -> (G, n_w, d, d).  The phase
    comes from the angle addition of e^{i omega dt} and e^{i Omega dt},
    as in the JAX package.
    """
    dE = eigvals[..., :, None] - eigvals[..., None, :]      # (G, d, d)
    dt_b = dt[..., None, None, None]
    phi = omega[:, None, None] + dE[..., None, :, :]

    a = omega * dt[..., None]                               # (G, n_w)
    sa, ca = torch.sin(a), torch.cos(a)
    b = dE * dt[..., None, None]                            # (G, d, d)
    sb, cb = torch.sin(b), torch.cos(b)
    sa, ca = sa[..., :, None, None], ca[..., :, None, None]
    sb, cb = sb[..., None, :, :], cb[..., None, :, :]
    sin_x = sa * cb + ca * sb
    cos_x = ca * cb - sa * sb

    f_re, f_im = _frac_from_trig(phi, sin_x, cos_x, dt_b)
    return torch.complex(f_im, -f_re)


def _frac_from_trig(u, sin_u, cos_u, dt):
    """(re, im) of frac(u) = (e^{iu dt} - 1)/u from sin/cos(u dt); the
    Taylor branch for |u dt| < 0.05 (relative error < 1e-16) covers the
    u -> 0 limit and the cancellation of the angle-addition forms."""
    w = u * dt
    small = torch.abs(w) < 0.05
    inv_u = 1.0 / torch.where(small, 1.0, u)
    w2 = w * w
    re_t = -dt * w * (0.5 + w2 * (-1.0 / 24.0 + w2 * (
        1.0 / 720.0 + w2 * (-1.0 / 40320.0))))
    im_t = dt * (1.0 + w2 * (-1.0 / 6.0 + w2 * (
        1.0 / 120.0 + w2 * (-1.0 / 5040.0))))
    return (torch.where(small, re_t, (cos_u - 1.0) * inv_u),
            torch.where(small, im_t, sin_u * inv_u))


# -----------------------------------------------------------------------------
# K2: the second-order integral lattice
# -----------------------------------------------------------------------------
#: |y dt| below which the K2 lattice takes the divided-difference branch.
_SO_SMALL_Y = 1e-2
#: y-Taylor terms of that branch: truncation ~ (1e-2)^6/7! ~ 2e-16 rel.
_SO_SMALL_K = 6
#: |u dt| below which frac^(k) runs as a Maclaurin series.
_SO_SERIES_W = 0.2
#: Maclaurin terms: 0.2^13/13! ~ 1e-19 relative.
_SO_SERIES_J = 12
#: (n_w, d^2)-size complex128 arrays per segment that the separable
#: tables hold at once, most of them inside :func:`_frac_divdiff_coeffs`
#: (the series and closed-form branches of its _SO_SMALL_K coefficients,
#: their powers and products); chip_smoke.py's phase 7c measures them
#: on a CUDA card.
_SO_FACTORED_TEMPS = 36
#: The same for the tables kernel's route (:mod:`.ops.k2_tables`): the 8
#: terms of the left tables as float64 planes of real and imaginary
#: parts, all it holds of size (n_w, d^2) beside the weighted right
#: table (:func:`_shifts_chunk`).
_K2_KERNEL_TEMPS = 8
#: The same for the plain tables rebuilt under autograd by the backward
#: of :class:`_K2Tables`, beyond their :data:`_SO_FACTORED_TEMPS`: the
#: intermediates that autograd saves and the vector-Jacobian product's
#: (with 13 rather than 8 weighted right-hand tables a row of the
#: weights, :func:`_shifts_chunk`).  At d = 16 and 1000 frequencies the
#: peak of the rebuild and its product reads 64.8 + 12.6 n_s tables a
#: segment in a CPU profiler's allocations (n_s rows of the weights), and
#: 80.8 at n_s = 1 on a CUDA card (the QFT cell's sub-chunks of 3
#: segments at batch 4: 3.696 GiB over their base).
_SO_RECOMPUTE_TEMPS = 32


@functools.lru_cache(maxsize=None)
def _frac_divdiff_static(n: int):
    """Static coefficients of :func:`_frac_divdiff_coeffs` for
    k = 1..n, host numpy: the series and closed-form polynomials in
    w = a + b, split binomially over the two generators,

        M[k, r, s] = i^{r+s} / ((r+s+k+1) r! s!),
        B[k, r, s] = (-i)^{r+s} / (r! s!)   for r+s <= k,

    both complex (n, J+1, J+1), and the scalars (-1)^k k! and -1/k!.
    """
    J = _SO_SERIES_J
    m = np.zeros((n, J + 1, J + 1), dtype=complex)
    b = np.zeros((n, J + 1, J + 1), dtype=complex)
    for k in range(1, n + 1):
        for r in range(J + 1):
            for s in range(J + 1 - r):
                j = r + s
                m[k - 1, r, s] = (1.0, 1j, -1.0, -1j)[j % 4] / (
                    (j + k + 1) * math.factorial(r) * math.factorial(s))
                if j <= k:
                    b[k - 1, r, s] = (1.0, -1j, -1.0, 1j)[j % 4] / (
                        math.factorial(r) * math.factorial(s))
    facts = np.array([math.factorial(k) for k in range(1, n + 1)], float)
    sgn_fact = (-1.0) ** np.arange(1, n + 1) * facts
    return m, b, sgn_fact, -1.0 / facts


def _frac_divdiff_coeffs(a: torch.Tensor, b: torch.Tensor, dt: torch.Tensor,
                         n: int, sin_u: torch.Tensor, cos_u: torch.Tensor
                         ) -> torch.Tensor:
    r"""Coefficients D_k(u) = -frac^{(k+1)}(u)/(k+1)!, k = 0..n-1, of the
    divided difference

        (frac(u) - frac(u + y))/y = sum_k D_k(u) y^k

    of frac(u) = (e^{i u dt} - 1)/u on the lattice u dt = a[o] + b[ij].
    a (..., n_a), b (..., n_b), dt (...); sin_u, cos_u (..., n_a, n_b)
    are sin/cos of u dt.  Returns complex (n, ..., n_a, n_b).

    The derivatives come from the closed form

        frac^{(k)}(u) = (-1)^k k!/u^{k+1} (e^{i u dt} S_k(-i u dt) - 1),
        S_k(v) = sum_{j<=k} v^j/j!,

    for |u dt| > _SO_SERIES_W and from the Maclaurin series
    frac^{(k)} = (i dt)^{k+1} sum_j (i u dt)^j/((j+k+1) j!) below it;
    both are polynomials in u dt evaluated from 1-D power stacks of a
    and b (:func:`_frac_divdiff_static`), as in the JAX package.
    """
    m, bm, sgn_fact, inv_fact = (torch.as_tensor(x, device=a.device)
                                 for x in _frac_divdiff_static(n))
    J = _SO_SERIES_J
    w = a[..., :, None] + b[..., None, :]
    small = torch.abs(w) <= _SO_SERIES_W
    k_shape = (n,) + (1,) * w.ndim

    def powers(v):                                        # (..., len, J+1)
        return torch.cumprod(torch.cat(
            [torch.ones_like(v)[..., None],
             v[..., None].expand(*v.shape, J)], -1), -1).to(config.COMPLEX)
    apow, bpow = powers(a), powers(b)

    def poly(coeffs):
        t = torch.einsum('krs,...or->k...os', coeffs, apow)
        return torch.einsum('k...os,...ms->k...om', t, bpow)

    # series: (i dt)^{k+1} sum_j ..., k = 1..n
    i_cyc = torch.as_tensor([(1.0, 1j, -1.0, -1j)[(k + 1) % 4]
                             for k in range(1, n + 1)],
                            dtype=config.COMPLEX, device=a.device)
    dt_pow = dt[None] ** torch.arange(
        2, n + 2, dtype=dt.dtype, device=dt.device).reshape(
        (n,) + (1,) * dt.ndim)
    series = poly(m) * (i_cyc.reshape((n,) + (1,) * dt.ndim)
                        * dt_pow)[..., None, None]

    # closed form: (e^{iw} S_k - 1) (-1)^k k! (dt/w)^{k+1}
    base = dt[..., None, None] / torch.where(small, 1.0, w)   # 1/u
    u_pow = torch.cumprod(torch.cat(
        [(base * base)[None], base.expand(n - 1, *base.shape)]), 0)
    closed = (torch.complex(cos_u, sin_u) * poly(bm) - 1.0) \
        * (u_pow * sgn_fact.reshape(k_shape))
    return torch.where(small, series, closed) * inv_fact.reshape(k_shape)


def _k2_arguments(omega: torch.Tensor, eigvals: torch.Tensor,
                  dt: torch.Tensor):
    r"""The arguments of the K2 lattice of segments with eigenvalues
    *eigvals* (..., d) and durations *dt* (...), for omega (n_w,), with
    ij and mn flattened row-major: x = Omega_ij - omega (o, ij), y =
    omega + Omega_mn (o, mn), z = Omega_ij + Omega_mn (ij, mn), a =
    -omega dt (o,) and b = Omega dt (ij,), sin/cos(x dt) by the angle
    addition of a and b, frac(x) and frac(z).

    Returns (x, y, z, a, b, sin_x, cos_x, f_x, f_z)."""
    d = eigvals.shape[-1]
    lead = eigvals.shape[:-1]
    dE = (eigvals[..., :, None] - eigvals[..., None, :]).reshape(*lead,
                                                                  d * d)
    dt_o = dt[..., None, None]
    x = dE[..., None, :] - omega[:, None]                 # (o, ij)
    y = omega[:, None] + dE[..., None, :]                 # (o, mn)
    z = dE[..., :, None] + dE[..., None, :]               # (ij, mn)

    # sin/cos(x dt) by angle addition of -omega dt and Omega_ij dt
    a = -omega * dt[..., None]                            # (o,)
    sa, ca = torch.sin(a)[..., :, None], torch.cos(a)[..., :, None]
    b = dE * dt[..., None]                                # (ij,)
    sb, cb = torch.sin(b)[..., None, :], torch.cos(b)[..., None, :]
    sin_x = sb * ca + cb * sa
    cos_x = cb * ca - sb * sa

    f_x = torch.complex(*_frac_from_trig(x, sin_x, cos_x, dt_o))
    zdt = z * dt_o
    f_z = torch.complex(*_frac_from_trig(z, torch.sin(zdt), torch.cos(zdt),
                                         dt_o))
    return x, y, z, a, b, sin_x, cos_x, f_x, f_z


def _second_order_integral_single(omega: torch.Tensor, eigvals: torch.Tensor,
                                  dt: torch.Tensor) -> torch.Tensor:
    r"""K2: the nested second-order integral I_{ijmn}(omega) of segments
    with eigenvalues *eigvals* (..., d) and durations *dt* (...), for
    omega (n_w,).

    With x = Omega_ij - omega, y = omega + Omega_mn, z = x + y::

        y != 0:  ( frac(x) - frac(z) ) / y
        y == 0, x != 0:  ( frac(x) - i dt e^{i x dt} ) / x
        y == 0, x == 0:  dt^2 / 2

    frac(u) = (e^{i u dt} - 1)/u, frac(0) = i dt.  Where
    0 < |y dt| < _SO_SMALL_Y the general form, whose two terms cancel,
    is replaced by the divided-difference series
    sum_{k < _SO_SMALL_K} D_k(x) y^k (:func:`_frac_divdiff_coeffs`):
    at grazing resonances (|y dt| ~ 1e-10) the general form keeps only
    ~eps/|y dt| of relative precision.  The JAX package's f64 lattice
    has no such branch.

    Returns complex (..., n_w, d, d, d, d) indexed (o, i, j, m, n).
    """
    d = eigvals.shape[-1]
    lead = eigvals.shape[:-1]
    n_w = omega.shape[-1]
    dt_o = dt[..., None, None]
    x, y, _, a, b, sin_x, cos_x, f_x, f_z = _k2_arguments(omega, eigvals, dt)
    mask_y = y != 0.0
    r_y = 1.0 / torch.where(mask_y, y, 1.0)
    general = (f_x[..., :, :, None] - f_z[..., None, :, :]) \
        * r_y[..., :, None, :]                            # (o, ij, mn)

    # divided-difference series, Horner in y
    small_y = mask_y & (torch.abs(y * dt_o) < _SO_SMALL_Y)
    dks = _frac_divdiff_coeffs(a, b, dt, _SO_SMALL_K, sin_x, cos_x)
    y_b = y[..., :, None, :]
    taylor = dks[-1][..., None]
    for k in range(_SO_SMALL_K - 2, -1, -1):
        taylor = dks[k][..., None] + y_b * taylor
    general = torch.where(small_y[..., :, None, :], taylor, general)

    # y == 0 limit, the same for every (m, n)
    mask_x = x != 0.0
    r_x = 1.0 / torch.where(mask_x, x, 1.0)
    num = f_x - torch.complex(-sin_x * dt_o, cos_x * dt_o)
    limit = (dt_o * dt_o / 2).expand_as(x).to(config.COMPLEX)
    special = torch.where(mask_x, num * r_x, limit)
    out = torch.where(mask_y[..., :, None, :], general,
                      special[..., :, :, None])
    return out.reshape(*lead, n_w, d, d, d, d)


def _second_order_factored_single(omega: torch.Tensor, eigvals: torch.Tensor,
                                  dt: torch.Tensor):
    r"""Separable tables of the K2 lattice of segments with eigenvalues
    *eigvals* (..., d) and durations *dt* (...), for omega (n_w,).

    Every branch of :func:`_second_order_integral_single` is a sum of
    products of a table over (o, ij) or (ij, mn) and one over (o, mn):

        I[o, ij, mn] = f_x[o, ij] r_big[o, mn] - f_z[ij, mn] r_big[o, mn]
                       + special[o, ij] m0[o, mn]
                       + sum_k dks[k, o, ij] yks[k, o, mn],

    so a contraction of I against an (mn)- or (ij)-indexed operand
    never needs the (n_w, d^4) lattice.  r_big = 1/y where
    |y dt| >= _SO_SMALL_Y (the general form), m0 = 1 where y == 0 (the
    limit ``special``, independent of mn), and the divided-difference
    series D_k(x) y^k of 0 < |y dt| < _SO_SMALL_Y is split
    scale-invariantly as dks_k = D_k(x)/dt^k and yks_k = (y dt)^k, zero
    off that branch.  The general form cancels as ~eps/|y dt|, so the
    factored route keeps ~2 eps/_SO_SMALL_Y ~ 4e-13 relative where the
    lattice subtracts the two nearby values directly.

    Returns (f_x, special, f_z, r_big, m0, dks, yks): complex
    (..., n_w, d^2), complex (..., n_w, d^2), complex (..., d^2, d^2),
    real (..., n_w, d^2), real (..., n_w, d^2), complex
    (..., _SO_SMALL_K, n_w, d^2), real (..., _SO_SMALL_K, n_w, d^2),
    with ij and mn flattened row-major, as the JAX package's
    ``_second_order_factored_single`` under ``vmap``.
    """
    dt_o = dt[..., None, None]
    x, y, _, a, b, sin_x, cos_x, f_x, f_z = _k2_arguments(omega, eigvals, dt)

    ydt = y * dt_o
    mask_y = y != 0.0
    small_y = mask_y & (torch.abs(ydt) < _SO_SMALL_Y)
    big_y = mask_y & ~small_y
    r_big = torch.where(big_y, 1.0 / torch.where(big_y, y, 1.0), 0.0)
    m0 = (~mask_y).to(config.REAL)

    k_shape = (_SO_SMALL_K,) + (1,) * dt.ndim
    dt_pow = dt[None] ** -torch.arange(_SO_SMALL_K, dtype=dt.dtype,
                                       device=dt.device).reshape(k_shape)
    dks = _frac_divdiff_coeffs(a, b, dt, _SO_SMALL_K, sin_x, cos_x) \
        * dt_pow[..., None, None]                         # (k, ..., o, ij)
    yks = torch.cumprod(torch.cat(
        [small_y.to(config.REAL)[None],
         ydt.expand(_SO_SMALL_K - 1, *ydt.shape)]), 0)    # (k, ..., o, mn)

    mask_x = x != 0.0
    r_x = 1.0 / torch.where(mask_x, x, 1.0)
    num = f_x - torch.complex(-sin_x * dt_o, cos_x * dt_o)
    limit = (dt_o * dt_o / 2).expand_as(x).to(config.COMPLEX)
    special = torch.where(mask_x, num * r_x, limit)
    return (f_x, special, f_z, r_big, m0, dks.movedim(0, -3),
            yks.movedim(0, -3))


def _ctrlmat_step_terms(eigvals, eigvecs, propagators, omega, basis,
                        n_opers, n_coeffs, dt, t):
    """Per-segment ingredients of the control matrix.

    eigvals (G, d), eigvecs (G, d, d), propagators (G, d, d) (Q_0 to
    Q_{G-1}), omega (n_w,), basis (n_b, d, d), n_opers (n_nops, d, d),
    n_coeffs (n_nops, G), dt (G,), t (G,) segment start times.

    Returns (eigvecs_propagated (G, d, d), n_opers_transformed
    (n_nops, G, d, d), basis_transformed (G, n_b, d, d), phase_factors
    (G, n_w), integral (G, n_w, d, d)).
    """
    eigvecs_propagated = _propagate_eigenvectors(propagators, eigvecs)
    n_opers_transformed = _transform_hamiltonian(eigvecs, n_opers,
                                                 n_coeffs)
    vp = eigvecs_propagated[..., None, :, :]                # (G, 1, d, d)
    basis_transformed = vp.mH @ basis @ vp
    phase_factors = util.cexp(t[..., :, None] * omega)          # (G, n_w)
    integral = _first_order_integral_batched(omega, eigvals, dt)
    return (eigvecs_propagated, n_opers_transformed, basis_transformed,
            phase_factors, integral)


# -----------------------------------------------------------------------------
# K4: the contraction
# -----------------------------------------------------------------------------
def _deep_quant_ratio(out_re, out_im, p_re, p_im, b_fac, c_fac,
                      n_nops: int, n_basis: int) -> torch.Tensor:
    r"""Bound on the relative operand-quantization noise the deep factored
    contraction leaves on the fidelity filter function
    F_a(w) = sum_k |B_ak(w)|^2: the worst ratio

        max_{o, j} 2 sum_k |out| mag / sum_k |out|^2,
        mag[o, (j k)] = eps_q * sum_K |P[o, :]| * colscale_B[j]
                        * colscale_C[k],

    in float32, as in the JAX package.  Returns one value per leading
    batch index.
    """
    f32 = torch.float32
    n_w = p_re.shape[-2]
    eps_q = 2.0**-21                  # 2^-22 D + 2^-24 P, 2x safety
    rowsum = (p_re.abs() + p_im.abs()).sum(-1).to(f32)      # (o,)
    cb = torch.maximum(b_fac.real.abs(), b_fac.imag.abs()).amax(-2)
    cc = torch.maximum(c_fac.real.abs(), c_fac.imag.abs()).amax(-2)
    colscale = (cb[..., :, None] * cc[..., None, :]).to(f32)   # (J, C)
    mag = (eps_q * rowsum)[..., :, None, None] \
        * colscale[..., None, :, :]                         # (o, J, C)
    o_abs = torch.sqrt(out_re * out_re + out_im * out_im).to(f32).reshape(
        *out_re.shape[:-2], n_w, n_nops, n_basis)
    noise = 2.0 * (o_abs * mag).sum(-1)                     # (o, J)
    signal = (o_abs * o_abs).sum(-1)
    ratio = torch.where(signal > 0,
                        noise / torch.where(signal > 0, signal, 1.0), 0.0)
    return ratio.flatten(-2).amax(-1)


def _escalates(ratios: torch.Tensor, escalation_tol: float,
               ratio_max: Optional[Callable] = None) -> bool:
    """Whether the largest quantization ratio (:func:`_deep_quant_ratio`)
    exceeds *escalation_tol* (0 disables the check), read on the host.
    *ratio_max* maps the local largest ratio to the one the decision
    reads: the sharded entry points take its maximum over the mesh, so
    that every rank decides as the unsharded call does."""
    if escalation_tol <= 0:
        return False
    worst = ratios.max()
    if ratio_max is not None:
        worst = ratio_max(worst)
    escalated = bool(worst > escalation_tol)
    tracing.counts['sync.escalation'] += 1
    return tracing.decision(escalated)


def _is_deep(K: int) -> bool:
    """Whether a K-deep contraction is in the deep regime, 1024 < K <=
    16384: where the JAX package's bf16 slice rule at 30 bits gives 5-
    or 6-bit slices."""
    return 1024 < K <= 16384


def _ctrlmat_contract(n_opers_transformed, integral, basis_transformed,
                      phase_factors, escalation: str = 'stat',
                      contract: str = 'native'):
    """The contraction 'go,jgmn,gomn,gknm->jko' as one matrix product
    P (n_w x G d^2) @ D (G d^2 x n_nops n_b), with P = phase * integral
    and D[(g m n), (j k)] = Bbar_j[g, m, n] * Cbar_k[g, n, m].

    contract 'native': complex128 ``torch.matmul``.  'ozaki': in the deep
    regime, the factored int8 route (:func:`.ops.ozaki.
    ozaki_matmul_c_outer`) with P assembled in split float32; other
    depths run native, which on this hardware replaces the JAX
    package's full-precision Ozaki product.

    escalation 'stat' returns the ratio of :func:`_deep_quant_ratio`
    beside the result (0 off the factored route); 'force' is the
    full-precision recompute, which is the native route.

    Returns (control matrix (n_nops, n_b, n_w), ratio ()).
    """
    G, n_w, d = integral.shape[-4:-1]
    lead = integral.shape[:-4]
    n_nops = n_opers_transformed.shape[-4]
    n_basis = basis_transformed.shape[-3]
    K = G * d * d
    # b_fac[(g m n), j] = Bbar_j[g, m, n]; c_fac[(g m n), k] = Cbar_k[g, n, m]
    b_fac = n_opers_transformed.movedim(-4, -1).reshape(*lead, K, n_nops)
    c_fac = basis_transformed.permute(
        *range(len(lead)), -4, -1, -2, -3).reshape(*lead, K, n_basis)

    if contract == 'ozaki' and escalation != 'force' and _is_deep(K):
        # P in split float32: re = a.re b.re - a.im b.im, as the JAX
        # package's cplx.C product
        i_re, i_im = integral.real.float(), integral.imag.float()
        ph = phase_factors[..., None, None]
        ph_re, ph_im = ph.real.float(), ph.imag.float()
        p_re = i_re * ph_re - i_im * ph_im
        p_im = i_re * ph_im + i_im * ph_re
        p_re, p_im = (x.reshape(*lead, G, n_w, d * d).transpose(-3, -2)
                      .reshape(*lead, n_w, K) for x in (p_re, p_im))
        out_re, out_im = ozaki.ozaki_matmul_c_outer(
            p_re, p_im, b_fac.real, b_fac.imag, c_fac.real, c_fac.imag,
            config.DEEP_PRECISION_BITS)
        with torch.no_grad():                   # a decision, not a value
            ratio = _deep_quant_ratio(out_re, out_im, p_re, p_im, b_fac,
                                      c_fac, n_nops, n_basis)
        out = torch.complex(out_re, out_im)
    else:
        p_mat = (integral * phase_factors[..., None, None]).reshape(
            *lead, G, n_w, d * d).transpose(-3, -2).reshape(*lead, n_w, K)
        d_mat = (b_fac[..., :, None] * c_fac[..., None, :]).reshape(
            -1, K, n_nops * n_basis)
        # one product per pulse: a batched product may block its sums
        # differently per batch size, and chunking must not move a bit
        out = torch.stack([a @ b for a, b in
                           zip(p_mat.reshape(-1, n_w, K), d_mat)]).reshape(
            *lead, n_w, n_nops * n_basis)
        ratio = torch.zeros(lead, dtype=torch.float32,
                            device=integral.device)
    out = out.reshape(*lead, n_w, n_nops, n_basis).movedim(-3, -1)
    return out, ratio


#: |x| below which g'(x), g(x) = (e^{ix} - 1)/(ix), runs as its
#: Maclaurin series, and the series' terms in x^2 per part: truncated at
#: 17 0.3^16/18! < 1e-23.
_DINT_SERIES_X = 0.3
_DINT_TERMS = 8


def _first_order_integral_slope(phi: torch.Tensor, dt: torch.Tensor
                                ) -> torch.Tensor:
    r"""d/dphi of the first-order integral (e^{i phi dt} - 1)/(i phi),
    dt^2 g'(phi dt) with g'(x) = ((x cos x - sin x) + i (x sin x + cos x
    - 1))/x^2, and for small |x| the series sum_{k>=1} k i^k x^{k-1}/(k+1)!
    as one real polynomial in x^2 per part; complex128 of phi's shape, dt
    broadcast against it."""
    x = phi * dt
    small = x.abs() < _DINT_SERIES_X
    xs = torch.where(small, 1.0, x)
    c, s = torch.cos(xs), torch.sin(xs)
    x2 = x * x
    re = torch.zeros_like(x)        # k = 2j + 2: x sum_j re_j x^{2j}
    im = torch.zeros_like(x)        # k = 2j + 1: sum_j im_j x^{2j}
    for j in range(_DINT_TERMS - 1, -1, -1):
        re = re * x2 + (-1)**(j + 1) * (2 * j + 2) / math.factorial(2 * j + 3)
        im = im * x2 + (-1)**j * (2 * j + 1) / math.factorial(2 * j + 2)
    return dt * dt * torch.complex(
        torch.where(small, x * re, (xs * c - s) / (xs * xs)),
        torch.where(small, im, (xs * s + c - 1.0) / (xs * xs)))


class _DegenerateControlMatrix(torch.autograd.Function):
    r"""Zero in value; its backward is the part of the derivative of the
    control matrix that :class:`_Eigh` drops.  Each segment contributes
    sum_mn Bbar_mn I_mn Cbar_nm, a function of H_g whose derivative
    along the off-diagonal entries D_pq of a degenerate eigenspace is

        sum_mn I'_mn [D, Bbar]_mn Cbar_nm,

    I'_mn the slope of the integral at phi = omega + w_m - w_n
    (:func:`_first_order_integral_slope`).  The coefficient of D_pq
    comes from the incoming cotangent G contracted with the phased slopes
    over omega, one (n_nops n_b) x n_w x (G d^2) product the size of the
    native route's D, then with Cbar and Bbar.

    forward(h (..., G, d, d), w, v, n_opers_transformed, basis_transformed,
    phase_factors, omega, dt), all but h detached; returns zeros of the
    control matrix's shape (..., n_nops, n_b, n_w).
    """

    @staticmethod
    def forward(ctx, h, w, v, n_t, b_t, ph, omega, dt):
        ctx.save_for_backward(w, v, n_t, b_t, ph, omega, dt)
        return h.new_zeros(*n_t.shape[:-4], n_t.shape[-4], b_t.shape[-3],
                           omega.shape[-1])

    @staticmethod
    def backward(ctx, g):
        w, v, n_t, b_t, ph, omega, dt = ctx.saved_tensors
        G, d = w.shape[-2:]
        n_nops, n_basis, n_w = g.shape[-3:]
        lead = g.shape[:-3]
        # U[a, k, (g m n)] = sum_o conj(G[a, k, o]) ph[g, o] I'[g, o, m, n]
        u = g.conj().reshape(*lead, n_nops * n_basis, n_w) \
            @ _phased_slopes(w, ph, omega, dt).movedim(-3, -4).reshape(
                *lead, n_w, G * d * d)
        coeff = _slope_coeff(u.reshape(*lead, n_nops, n_basis, G, d, d),
                             n_t, b_t)
        return (_degenerate_grad(coeff, w, v), None, None, None, None, None,
                None, None)


class _DegenerateStepControlMatrix(torch.autograd.Function):
    r"""Per-step variant of :class:`_DegenerateControlMatrix`: zeros of
    the per-step control matrices' shape (..., G, n_nops, n_b, n_w), whose
    backward takes a per-step cotangent, so that each segment's term
    reaches every sum of steps that autograd sees (the complete steps and
    cumulative control matrices of the second order).  The same
    arguments."""

    @staticmethod
    def forward(ctx, h, w, v, n_t, b_t, ph, omega, dt):
        ctx.save_for_backward(w, v, n_t, b_t, ph, omega, dt)
        return h.new_zeros(*n_t.shape[:-4], n_t.shape[-3], n_t.shape[-4],
                           b_t.shape[-3], omega.shape[-1])

    @staticmethod
    def backward(ctx, g):
        w, v, n_t, b_t, ph, omega, dt = ctx.saved_tensors
        G, d = w.shape[-2:]
        n_nops, n_basis, n_w = g.shape[-3:]
        lead = g.shape[:-4]
        # U[g, a, k, (m n)] = sum_o conj(G[g, a, k, o]) ph[g, o] I'[g, o, m, n]
        u = g.conj().reshape(*lead, G, n_nops * n_basis, n_w) \
            @ _phased_slopes(w, ph, omega, dt).reshape(*lead, G, n_w, d * d)
        u = u.reshape(*lead, G, n_nops, n_basis, d, d).movedim(-5, -3)
        coeff = _slope_coeff(u, n_t, b_t)
        return (_degenerate_grad(coeff, w, v), None, None, None, None, None,
                None, None)


def _phased_slopes(w, ph, omega, dt) -> torch.Tensor:
    """ph[g, o] I'[g, o, m, n] (..., G, n_w, d, d): the phased slopes of
    the first-order integral at phi = omega + w_m - w_n."""
    phi = omega[:, None, None] + (w[..., :, None]
                                  - w[..., None, :])[..., None, :, :]
    return _first_order_integral_slope(
        phi, dt[..., None, None, None]) * ph[..., None, None]


def _slope_coeff(u, n_t, b_t) -> torch.Tensor:
    """The coefficient (..., G, d, d) of D_pq (:func:`_degenerate_grad`)
    of sum_{a, k, m, n} U[a, k, g, m, n] [D, Bbar_a]_mn Cbar_k,nm, from
    U (..., n_nops, n_b, G, d, d)."""
    # z[g, a, m, n] = sum_k U[a, k, g, m, n] Cbar_k[g, n, m]
    cbar = b_t.transpose(-1, -2).transpose(-4, -3)          # (k, g, m, n)
    z = (u * cbar[..., None, :, :, :, :]).sum(-4).movedim(-4, -3)
    x = n_t.movedim(-4, -3)                                 # (g, a, m, n)
    return (z @ x.mT - x.mT @ z).sum(-3)


def _reaches_degenerate(h, eigvals) -> bool:
    """Whether a gradient reaches the Hamiltonians *h* and one of them
    has a degenerate eigenspace (eigenvalues *eigvals*)."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return False
    _, degenerate = _eig_gaps(eigvals.detach())
    reached = bool((degenerate.sum((-1, -2)) > eigvals.shape[-1]).any())
    tracing.counts['sync.degenerate'] += 1
    return reached


def _degenerate_control_matrix(h, eigvals, eigvecs, terms, omega, dt,
                               per_step: bool = False):
    """The :class:`_DegenerateControlMatrix` term of the control matrix
    of Hamiltonians *h* with eigendecomposition (eigvals, eigvecs) and
    step terms *terms* (:func:`_ctrlmat_step_terms`), to be added to it,
    or with *per_step* the :class:`_DegenerateStepControlMatrix` term of
    the per-step control matrices; None where no gradient reaches *h* or
    no eigenspace is degenerate."""
    if not _reaches_degenerate(h, eigvals):
        return None
    _, n_t, b_t, ph, _ = terms
    fn = _DegenerateStepControlMatrix if per_step else _DegenerateControlMatrix
    return fn.apply(h, eigvals.detach(), eigvecs.detach(), n_t.detach(),
                    b_t.detach(), ph.detach(), omega.detach(), dt.detach())


def _ctrlmat_step_contract(n_opers_transformed, integral, basis_transformed,
                           phase_factors) -> torch.Tensor:
    """Per-segment variant of :func:`_ctrlmat_contract`,
    'go,jgmn,gomn,gknm->gjko': one complex128 product per segment,
    P[g] (n_w x d^2) @ D[g] (d^2 x n_nops n_b).  This is the JAX
    package's full-precision route for the per-step matrices.

    Returns the per-step control matrices (G, n_nops, n_b, n_w).
    """
    G, n_w, d = integral.shape[-4:-1]
    lead = integral.shape[:-4]
    n_nops = n_opers_transformed.shape[-4]
    n_basis = basis_transformed.shape[-3]
    p_mat = (integral * phase_factors[..., None, None]).reshape(
        *lead, G, n_w, d * d)
    b_fac = n_opers_transformed.movedim(-4, -1).reshape(*lead, G, d * d,
                                                        n_nops)
    c_fac = _perm_tail(basis_transformed, 0, 3, 2, 1).reshape(
        *lead, G, d * d, n_basis)
    d_mat = (b_fac[..., :, None] * c_fac[..., None, :]).reshape(
        *lead, G, d * d, n_nops * n_basis)
    return _perm_tail((p_mat @ d_mat).reshape(*lead, G, n_w, n_nops,
                                              n_basis), 0, 2, 3, 1)


def _pick_chunk(G: int, per_segment: int, budget_bytes: int) -> int:
    """Segments per step of an accumulation over *G* segments whose
    working set is *per_segment* bytes per segment, so that a step stays
    within *budget_bytes*."""
    return max(1, min(G, budget_bytes // max(per_segment, 1)))


def calculate_control_matrix_from_scratch(
        eigvals: torch.Tensor, eigvecs: torch.Tensor,
        propagators: torch.Tensor, omega, basis: Union[Basis, torch.Tensor],
        n_opers: torch.Tensor, n_coeffs, dt, t=None,
        show_progressbar: bool = False, cache_intermediates: bool = False,
        contract: Optional[str] = None,
        budget_bytes: Optional[int] = None):
    r"""K4: the control matrix
    B_{ak}(omega) = sum_g e^{i w t_{g-1}} s_a^g tr([Bbar_a o I(w)] Cbar_k)
    of one pulse, on the device of *eigvals*.

    eigvals (G, d), eigvecs (G, d, d), propagators (G+1, d, d), omega
    (n_w,), n_opers (n_nops, d, d), n_coeffs (n_nops, G), dt (G,), t
    (G+1,) segment boundaries (from dt by default).

    The segments are accumulated in chunks whose integral table fits
    :func:`.config.memory_budget` (*budget_bytes* overrides it); a short
    last chunk is padded with identity segments of zero duration, which
    contribute nothing, so every chunk has the same depth K = chunk d^2.
    Each chunk's contraction takes the route of
    :func:`.config.contraction_mode` (*contract*; 'ozaki' for CUDA
    tensors); on the Ozaki route a chunk is recomputed at full precision
    when its quantization statistic exceeds
    :data:`.config.ESCALATION_TOL` (one host synchronization per
    chunk).

    Returns the control matrix (n_nops, n_b, n_w); with
    ``cache_intermediates`` also a dict of the step terms and the
    per-step and cumulative control matrices, computed per segment at
    full precision.
    """
    device = eigvals.device

    def real(x):
        return torch.as_tensor(x, dtype=config.REAL, device=device)

    omega, n_coeffs, dt = real(omega), real(n_coeffs), real(dt)
    t = real(t) if t is not None else torch.cat(
        [dt.new_zeros(1), torch.cumsum(dt, 0)])
    basis = (basis.tensor(device) if isinstance(basis, Basis)
             else torch.as_tensor(basis, dtype=config.COMPLEX,
                                  device=device))
    n_opers = torch.as_tensor(n_opers, dtype=config.COMPLEX, device=device)
    G, d = eigvals.shape

    if cache_intermediates:
        terms = _ctrlmat_step_terms(eigvals, eigvecs, propagators[:-1],
                                    omega, basis, n_opers, n_coeffs, dt,
                                    t[:-1])
        _, n_t, b_t, ph, integral = terms
        step = _ctrlmat_step_contract(n_t, integral, b_t, ph)
        intermediates = dict(zip(
            ('eigvecs_propagated', 'n_opers_transformed',
             'basis_transformed', 'phase_factors', 'first_order_integral'),
            terms))
        intermediates['control_matrix_step'] = step
        intermediates['control_matrix_step_cumulative'] = \
            step.cumsum(0)[:-1]
        return step.sum(0), intermediates

    mode = config.contraction_mode(device, contract)
    # the (chunk, n_w, d, d) complex128 integral table
    chunk = _pick_chunk(G, len(omega) * d * d * 16, config.memory_budget(
        device, budget_bytes=budget_bytes))
    pad = (-G) % chunk
    if pad:
        eye = torch.eye(d, dtype=eigvecs.dtype, device=device).expand(
            pad, d, d)
        eigvals = torch.cat([eigvals, eigvals.new_zeros(pad, d)])
        eigvecs = torch.cat([eigvecs, eye])
        propagators = torch.cat([propagators, eye])
        n_coeffs = torch.cat([n_coeffs, n_coeffs.new_zeros(len(n_coeffs),
                                                            pad)], 1)
        dt = torch.cat([dt, dt.new_zeros(pad)])
        t = torch.cat([t, t[-1:].expand(pad)])

    result = 0
    for start in util.progressbar_range(0, G + pad, chunk,
                                        show_progressbar=show_progressbar):
        sl = slice(start, start + chunk)
        _, n_t, b_t, ph, integral = _ctrlmat_step_terms(
            eigvals[sl], eigvecs[sl], propagators[sl], omega, basis,
            n_opers, n_coeffs[:, sl], dt[sl], t[sl])
        contrib, ratio = _ctrlmat_contract(n_t, integral, b_t, ph, 'stat',
                                           mode)
        if mode == 'ozaki' and _escalates(ratio, config.ESCALATION_TOL):
            contrib, _ = _ctrlmat_contract(n_t, integral, b_t, ph, 'force',
                                           mode)
        result = result + contrib
    return result


# -----------------------------------------------------------------------------
# K5 / K6: control matrix from atomic pulses / of a periodic train
# -----------------------------------------------------------------------------
#: Series-size complex128 arrays that :func:`geometric_series
#: <.util.geometric_series>` holds at once (result, power, partial sum,
#: T^k and the two operands of a step).
_SERIES_TEMPS = 6


def _apply_transfer(props: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_k props[..., k, l] x[..., k, o] -> (..., l, o) for complex x
    (contiguous) and real or complex props; real transfer matrices act
    on the interleaved (re, im) view of x, half the work of a complex
    product."""
    if props.is_complex():
        return props.mT @ x
    xr = torch.view_as_real(x).flatten(-2)
    return torch.view_as_complex((props.mT @ xr).unflatten(-1, (-1, 2)))


def _atomic_operands(phases, control_matrix_atomic, propagators_liouville):
    """K5's operands as tensors on the device of the atomic control
    matrices: complex128 phases and control matrices, float64 or
    complex128 transfer matrices."""
    ctrl = torch.as_tensor(control_matrix_atomic).to(config.COMPLEX)
    phases = torch.as_tensor(phases, device=ctrl.device).to(config.COMPLEX)
    props = torch.as_tensor(propagators_liouville, device=ctrl.device)
    return phases, ctrl, props.to(config.COMPLEX if props.is_complex()
                                  else config.REAL)


@util.parse_optional_parameters(which=('total', 'correlations'))
def calculate_control_matrix_from_atomic(
        phases, control_matrix_atomic, propagators_liouville,
        show_progressbar: bool = False, which: str = 'total',
        budget_bytes: Optional[int] = None) -> torch.Tensor:
    r"""K5: B(w) = sum_g e^{i w t_{g-1}} B^(g)(w) Q^(g-1) of a sequence
    of pulses with atomic control matrices B^(g).

    phases (G-1, n_w), unity for g = 0 implied; control_matrix_atomic
    (G, n_nops, d^2, n_w); propagators_liouville (G-1, d^2, d^2), the
    cumulative transfer matrices, real (Hermitian, normalized basis) or
    complex.

    'correlations' returns the summands (G, n_nops, d^2, n_w).  'total'
    contracts the joint (g, k) axis in one matrix product per chunk of
    pulses, Q[(g k), l]^T @ X[j, (g k), o] with X the phased atomic
    matrices, so the summands never exist; the chunks keep X within
    :func:`.config.memory_budget` (*budget_bytes* overrides it).  The
    product is native complex128 (float64 for real Q) at every G.
    """
    phases, ctrl, props = _atomic_operands(phases, control_matrix_atomic,
                                           propagators_liouville)
    if which == 'correlations':
        steps = _apply_transfer(props[:, None],
                                ctrl[1:] * phases[:, None, None, :])
        return torch.cat([ctrl[:1], steps])

    g1, n_w = phases.shape
    n_nops, d2 = ctrl.shape[1:3]
    chunk = _pick_chunk(g1, n_nops * d2 * n_w * 16, config.memory_budget(
        ctrl.device, budget_bytes=budget_bytes))
    result = ctrl[0]
    for start in util.progressbar_range(0, g1, chunk,
                                        show_progressbar=show_progressbar):
        sl = slice(start, start + chunk)
        g = phases[sl].shape[0]
        x = torch.empty((n_nops, g, d2, n_w), dtype=config.COMPLEX,
                        device=ctrl.device)
        torch.mul(ctrl[1:][sl].transpose(0, 1), phases[sl][None, :, None, :],
                  out=x)
        result = result + _apply_transfer(props[sl].reshape(g * d2, -1),
                                          x.reshape(n_nops, g * d2, n_w))
    return result


def calculate_control_matrix_from_atomic_uniform(
        phases, control_matrix, propagators_liouville) -> torch.Tensor:
    r"""K5 for a train of identical atomic pulses: with one atomic
    control matrix B the sum factorizes,
    B(w) = B + B . sum_g e^{i w t_{g-1}} Q^(g-1), and no
    (G, n_nops, d^2, n_w) stack exists.

    phases (G-1, n_w); control_matrix (n_nops, d^2, n_w);
    propagators_liouville (G-1, d^2, d^2) real or complex.
    """
    phases, ctrl, props = _atomic_operands(phases, control_matrix,
                                           propagators_liouville)
    g1, d2 = props.shape[:2]
    m = (phases.mT @ props.reshape(g1, -1).to(config.COMPLEX)).reshape(
        -1, d2, d2)                                         # (o, k, l)
    return ctrl + (ctrl.permute(2, 0, 1) @ m).permute(1, 2, 0)


def calculate_control_matrix_periodic(
        phases, control_matrix, total_propagator_liouville, repeats: int,
        check_invertible: bool = True,
        budget_bytes: Optional[int] = None) -> torch.Tensor:
    r"""K6: the control matrix of *repeats* repetitions of one pulse,
    B . S(w) with S = sum_{g<G} (e^{i w T} Q)^g evaluated by binary
    doubling (:func:`.util.geometric_series`), which needs no inverse:
    *check_invertible* is accepted and ignored.

    phases (n_w,), e^{i w T}; control_matrix (n_nops, d^2, n_w);
    total_propagator_liouville (d^2, d^2) real or complex.  The
    (n_w, d^2, d^2) series runs over chunks of frequencies that keep its
    :data:`_SERIES_TEMPS` arrays within :func:`.config.memory_budget`
    (*budget_bytes* overrides it).
    """
    ctrl = torch.as_tensor(control_matrix).to(config.COMPLEX)
    phases = torch.as_tensor(phases, device=ctrl.device).to(config.COMPLEX)
    props = torch.as_tensor(total_propagator_liouville,
                            device=ctrl.device).to(config.COMPLEX)
    d2 = props.shape[-1]
    chunk = _pick_chunk(len(phases), _SERIES_TEMPS * d2 * d2 * 16,
                        config.memory_budget(ctrl.device,
                                             budget_bytes=budget_bytes))
    out = []
    for start in range(0, len(phases), chunk):
        sl = slice(start, start + chunk)
        series = util.geometric_series(phases[sl, None, None] * props,
                                       int(repeats))        # (o, k, l)
        out.append(ctrl[..., sl].permute(2, 0, 1) @ series)
    return torch.cat(out).permute(1, 2, 0)


# -----------------------------------------------------------------------------
# K7: noise operators
# -----------------------------------------------------------------------------
def calculate_noise_operators_from_scratch(
        eigvals: torch.Tensor, eigvecs: torch.Tensor,
        propagators: torch.Tensor, omega, n_opers, n_coeffs, dt, t=None,
        show_progressbar: bool = False, cache_intermediates: bool = False):
    r"""K7: the interaction-picture noise operators
    Btilde_a(w) = sum_g e^{i w t_{g-1}} P_g^dag [Bbar_a o I(w)] P_g with
    P_g = V_g^dag Q_{g-1}, (n_w, n_nops, d, d), on the device of
    *eigvals*: d^2 entries per frequency where the control matrix has
    d^4.

    Arguments as :func:`calculate_control_matrix_from_scratch`.  With
    ``cache_intermediates`` also a dict of the transformed noise
    operators, the first-order integral, the phase factors and the
    per-segment summands (G, n_w, n_nops, d, d).
    """
    device = eigvals.device

    def real(x):
        return torch.as_tensor(x, dtype=config.REAL, device=device)

    omega, n_coeffs, dt = real(omega), real(n_coeffs), real(dt)
    t = real(t) if t is not None else torch.cat(
        [dt.new_zeros(1), torch.cumsum(dt, 0)])
    n_opers = torch.as_tensor(n_opers, dtype=config.COMPLEX, device=device)

    # V^dag Q: the arguments of the control matrix's Q^dag V, swapped
    eigvecs_propagated = _propagate_eigenvectors(eigvecs, propagators[:-1])
    n_opers_transformed = _transform_hamiltonian(eigvecs, n_opers, n_coeffs)
    phase_factors = util.cexp(t[:-1, None] * omega)             # (G, n_w)
    integral = _first_order_integral_batched(omega, eigvals, dt)
    inner = (phase_factors[..., None, None] * integral)[:, :, None] \
        * n_opers_transformed.transpose(0, 1)[:, None]      # (g, o, j, m, n)
    vp = eigvecs_propagated[:, None, None]
    step = vp.mH @ inner @ vp
    noise_operators = step.sum(0)
    if cache_intermediates:
        return noise_operators, dict(
            n_opers_transformed=n_opers_transformed,
            first_order_integral=integral, phase_factors=phase_factors,
            noise_operators_step=step)
    return noise_operators


def calculate_noise_operators_from_atomic(
        phases, noise_operators_atomic, propagators,
        show_progressbar: bool = False) -> torch.Tensor:
    r"""K7 from atomic pulses: Btilde(w) = sum_g e^{i w t_{g-1}}
    Q_{g-1}^dag Btilde^(g)(w) Q_{g-1}.

    phases (G-1, n_w); noise_operators_atomic (G, n_w, n_nops, d, d),
    the layout of :func:`calculate_noise_operators_from_scratch`;
    propagators (G-1, d, d), the cumulative propagators.
    """
    atomic = torch.as_tensor(noise_operators_atomic).to(config.COMPLEX)
    phases = torch.as_tensor(phases, device=atomic.device).to(config.COMPLEX)
    props = torch.as_tensor(propagators, device=atomic.device).to(
        config.COMPLEX)[:, None, None]
    rest = phases[..., None, None, None] * atomic[1:]
    return atomic[0] + (props.mH @ rest @ props).sum(0)


# -----------------------------------------------------------------------------
# K8 / K9: filter functions from the control matrix
# -----------------------------------------------------------------------------
@util.parse_optional_parameters(which=('fidelity', 'generalized'))
def calculate_filter_function(control_matrix: torch.Tensor,
                              which: str = 'fidelity') -> torch.Tensor:
    r"""K8: F_{ab[,kl]}(w) = B*_{ak} B_{b l}(w) of control matrices
    (..., n_nops, n_b, n_w): (..., n_nops, n_nops, n_w) 'fidelity' or
    (..., n_nops, n_nops, n_b, n_b, n_w) 'generalized'."""
    sub = ('...ako,...bko->...abo' if which == 'fidelity'
           else '...ako,...blo->...abklo')
    return torch.einsum(sub, control_matrix.conj(), control_matrix)


@util.parse_optional_parameters(which=('fidelity', 'generalized'))
def calculate_pulse_correlation_filter_function(
        control_matrix: torch.Tensor, which: str = 'fidelity'
        ) -> torch.Tensor:
    r"""K9: F^{(gg')}_{ab[,kl]}(w) of a pulse-resolved control matrix
    (n_pulses, n_nops, n_b, n_w)."""
    if control_matrix.ndim != 4:
        raise ValueError('Expected control_matrix.ndim == 4.')
    sub = 'gako,hbko->ghabo' if which == 'fidelity' else 'gako,hblo->ghabklo'
    return torch.einsum(sub, control_matrix.conj(), control_matrix)


# -----------------------------------------------------------------------------
# K10: second-order filter function
# -----------------------------------------------------------------------------
def _second_order_step_terms(eigvals, eigvecs, propagators, omega, basis,
                             n_opers, n_coeffs, dt, t):
    """K10 prerequisites for pulses whose first-order intermediates are
    not cached: (n_opers_transformed, basis_transformed, per-step
    control matrices (G, n_nops, n_b, n_w), their cumulative sums up to
    segment G-2)."""
    (_, n_t, b_t, ph, integral) = _ctrlmat_step_terms(
        eigvals, eigvecs, propagators[..., :-1, :, :], omega, basis,
        n_opers, n_coeffs, dt, t[..., :-1])
    step = _ctrlmat_step_contract(n_t, integral, b_t, ph)
    return n_t, b_t, step, step.cumsum(-4)[..., :-1, :, :, :]


def _pad_cumulative(step: torch.Tensor, cumulative: torch.Tensor
                    ) -> torch.Tensor:
    """The cumulative control matrices with a zero matrix in front:
    segment 0 has no complete-step term."""
    return torch.cat([torch.zeros_like(step[..., :1, :, :, :]), cumulative],
                     -4)


def _noise_basis_products(n_opers_transformed, basis_transformed
                          ) -> torch.Tensor:
    """nob[g, a, k, (i j)] = n_t[a, g, i, j] * b_t[g, k, j, i]."""
    nob = torch.einsum('...agij,...gkji->...gakij', n_opers_transformed,
                       basis_transformed)
    return nob.reshape(*nob.shape[:-2], -1)


def _second_order_incomplete_contract(int2: torch.Tensor, nob: torch.Tensor
                                      ) -> torch.Tensor:
    r"""The incomplete-step contraction sum_g 'oijmn,akij,blmn->abklo'
    of segment lattices *int2* (..., g, n_w, d, d, d, d) against
    *nob* (..., g, n_nops, n_b, d^2), as two complex128 matmuls::

        T[g, (o ij), B] = I[g, (o ij), (mn)] @ nob^T[g, (mn), B]
        S[A, (o B)]     = nob[A, (g ij)] @ T'[(g ij), (o B)]

    with A = B = (a k).  Returns (..., n_nops, n_nops, n_b, n_b, n_w).
    """
    g, n_nops, n_basis, d2 = nob.shape[-4:]
    lead = nob.shape[:-4]
    n_w = int2.shape[-5]
    A = n_nops * n_basis
    nob = nob.reshape(*lead, g, A, d2)
    t = int2.reshape(*lead, g, n_w * d2, d2) @ nob.mT
    t = t.reshape(*lead, g, n_w, d2, A).transpose(-3, -2).reshape(
        *lead, g * d2, n_w * A)
    s = nob.transpose(-3, -2).reshape(*lead, A, g * d2) @ t
    return _perm_tail(s.reshape(*lead, n_nops, n_basis, n_w, n_nops,
                                n_basis), 0, 3, 1, 4, 2)


def _second_order_complete(ctrlmat_step: torch.Tensor,
                           cumul_padded: torch.Tensor) -> torch.Tensor:
    r"""The complete-step term sum_g conj(B_step^(g))_{ak}
    B_cumul^(g-1)_{bl}(w) as one (A x G) @ (G x B) matmul per
    frequency.  Returns (..., n_nops, n_nops, n_b, n_b, n_w)."""
    G, n_nops, n_basis, n_w = ctrlmat_step.shape[-4:]
    lead = ctrlmat_step.shape[:-4]
    A = n_nops * n_basis
    x = ctrlmat_step.conj().reshape(*lead, G, A, n_w).movedim(-1, -3)
    y = cumul_padded.reshape(*lead, G, A, n_w).movedim(-1, -3)
    comp = (x.mT @ y).reshape(*lead, n_w, n_nops, n_basis, n_nops, n_basis)
    return _perm_tail(comp, 1, 3, 2, 4, 0)


def _factored_chunk(eigvals: torch.Tensor, n_w: int, extra: int,
                    budget_bytes: Optional[int] = None, fixed: int = 0,
                    temps: int = _SO_FACTORED_TEMPS) -> int:
    """Segments per step of a chunked second-order accumulation that fits
    :func:`.config.memory_budget` (*budget_bytes* overrides it): each
    segment, with every leading batch index, costs the *temps*
    table-size arrays of its build (the :data:`_SO_FACTORED_TEMPS` of
    the plain tables by default) plus *extra* complex128 elements per
    frequency of the contraction, and each step *fixed* complex128
    elements per batch index whatever its number of segments (its
    output)."""
    batch = math.prod(eigvals.shape[:-2])
    d2 = eigvals.shape[-1] ** 2
    budget = config.memory_budget(eigvals.device, budget_bytes=budget_bytes)
    return _pick_chunk(eigvals.shape[-2],
                       batch * n_w * (temps * d2 + extra) * 16,
                       budget - batch * fixed * 16)


def _mm_real(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y of one complex128 and one float64 operand, as two float64
    products: half the work of the complex128 product."""
    if x.is_complex():
        return torch.complex(x.real @ y, x.imag @ y)
    return torch.complex(x @ y.real, x @ y.imag)


def _factored_stacks(omega, eigvals, dt):
    """The tables of :func:`_second_order_factored_single` stacked by
    term t, so that I = sum_t left_t[o, ij] right_t[o, mn]
    - f_z[ij, mn] r_big[o, mn]: (left (..., 2 + K, n_w, d^2) complex,
    the ij-indexed f_x, special and dks; right (..., 2 + K, n_w, d^2)
    real, the mn-indexed r_big, m0 and yks; f_z; r_big)."""
    f_x, special, f_z, r_big, m0, dks, yks = _second_order_factored_single(
        omega, eigvals, dt)
    left = torch.cat([f_x[..., None, :, :], special[..., None, :, :], dks],
                     -3)
    right = torch.cat([r_big[..., None, :, :], m0[..., None, :, :], yks],
                      -3)
    return left, right, f_z, r_big


def _second_order_factored_contract(omega, eigvals, dt, nob: torch.Tensor
                                    ) -> torch.Tensor:
    r"""The incomplete-step contraction of
    :func:`_second_order_incomplete_contract` from the separable tables
    of segments *eigvals* (..., g, d), *dt* (..., g), without the K2
    lattice::

        S[o, A, B] = sum_{g, t} (N left_t^T)[g, A, o] (right_t N^T)[g, o, B]
                     - sum_{g, m} (N f_z)[g, A, m] r_big[g, o, m] N[g, B, m]

    with N = *nob* (..., g, n_nops, n_b, d^2) and A = B = (a k): one
    o-batched matmul over (g, t) and one matmul over (g, m).  Returns
    (..., n_nops, n_nops, n_b, n_b, n_w).
    """
    g, n_nops, n_basis, d2 = nob.shape[-4:]
    lead = nob.shape[:-4]
    n_w = omega.shape[-1]
    A = n_nops * n_basis
    nob = nob.reshape(*lead, g, A, d2)
    left, right, f_z, r_big = _factored_stacks(omega, eigvals, dt)
    n_t = left.shape[-3]

    def by_omega(v):                        # (g, (t o), A) -> (o, (g t), A)
        return v.reshape(*lead, g * n_t, n_w, A).transpose(-3, -2)
    n_left = left.reshape(*lead, g, n_t * n_w, d2) @ nob.mT
    n_right = _mm_real(right.reshape(*lead, g, n_t * n_w, d2), nob.mT)
    s = by_omega(n_left).mT @ by_omega(n_right)          # (o, A, B)

    n_z = (nob @ f_z).transpose(-3, -2).reshape(*lead, A, g * d2)
    r_nob = r_big.mT[..., :, :, :, None] * nob.mT[..., :, :, None, :]
    f_z_term = n_z @ r_nob.reshape(*lead, g * d2, n_w * A)  # (A, (o B))
    s = s - f_z_term.reshape(*lead, A, n_w, A).transpose(-3, -2)
    return _perm_tail(s.reshape(*lead, n_w, n_nops, n_basis, n_nops,
                                n_basis), 1, 3, 2, 4, 0)


def _weighted_lattice(left, right, zterms, weights: torch.Tensor
                      ) -> torch.Tensor:
    """sum_o weights[s, o] L[..., o, ij, mn] (..., n_s, d^2, d^2) of a
    lattice given as separable tables, L = sum_t left_t[o, ij]
    right_t[o, mn] + sum_s Z_s[ij, mn] rho_s[o, mn] (*zterms* the pairs
    (Z_s, rho_s)), one for each of the n_s rows of *weights*: the
    weights fold into the real mn-indexed tables, one matmul reduces
    over (t, o), and each Z_s term reduces over o on its own."""
    n_t, n_w, d2 = left.shape[-3:]
    lead = left.shape[:-3]
    n_s = weights.shape[0]
    folded = right[..., :, :, None, :] * weights.mT[:, :, None]
    ell = _mm_real(left.reshape(*lead, n_t * n_w, d2).mT,
                   folded.reshape(*lead, n_t * n_w, n_s * d2))
    ell = ell.reshape(*lead, d2, n_s, d2).transpose(-3, -2)
    for zt, rho in zterms:
        ell = ell + zt[..., None, :, :] * (weights @ rho)[..., :, None, :]
    return ell


def _factored_weighted_lattice(omega, eigvals, dt, weights: torch.Tensor,
                               budget_bytes: Optional[int] = None
                               ) -> torch.Tensor:
    r"""ell[..., g, s, ij, mn] = sum_o weights[s, o] I[..., g, o, ij, mn]
    of segments *eigvals* (..., g, d), *dt* (..., g), from the separable
    tables, without the K2 lattice, in span ``ff.so.tables``.  *weights*
    (n_s, n_w) real.  Returns complex (..., g, n_s, d^2, d^2): weights @
    the K2 lattice of :func:`_second_order_integral_single`.

    The route follows the device.  CUDA tensors take the tables kernel
    (:func:`.ops.k2_tables.weighted_lattice`: one launch that writes the
    weight-folded operands, one DGEMM, one epilogue) through
    :class:`_K2Tables`, whose backward differentiates the plain version
    in chunks of segments that fit :func:`.config.memory_budget`
    (*budget_bytes* overrides it); CPU tensors take the plain version
    (:func:`_factored_weighted_lattice_plain`) under autograd."""
    with tracing.span('ff.so.tables'):
        if eigvals.is_cuda:
            return _K2Tables.apply(omega, eigvals, dt, weights, budget_bytes)
        return _factored_weighted_lattice_plain(omega, eigvals, dt, weights)


def _factored_weighted_lattice_plain(omega, eigvals, dt,
                                     weights: torch.Tensor) -> torch.Tensor:
    """:func:`_factored_weighted_lattice` in PyTorch operations: the
    tables of :func:`_factored_stacks`, the weights folded into the real
    mn-indexed tables, one matmul over (t, o) (:func:`_weighted_lattice`)
    and the general form's f_z term reduced over o on its own."""
    left, right, f_z, r_big = _factored_stacks(omega, eigvals, dt)
    return _weighted_lattice(left, right, [(-f_z, r_big)], weights)


class _K2Tables(torch.autograd.Function):
    """:func:`_factored_weighted_lattice` on the tables kernel's route.
    Its forward launches :func:`.ops.k2_tables.weighted_lattice` on CUDA
    tensors and runs :func:`_factored_weighted_lattice_plain` on CPU
    ones; its backward recomputes the plain version under autograd and
    returns its vector-Jacobian product for each input that requires a
    gradient (the JAX package has no kernel here, so the derivative is
    the plain version's).  Saves only the inputs.

    forward(omega, eigvals (..., G, d), dt (..., G), weights,
    budget_bytes).  The backward rebuilds the tables in sub-chunks of
    the G segments that fit :func:`.config.memory_budget` (*budget_bytes*
    overrides it) with what autograd holds of the rebuild
    (:func:`_shifts_chunk`, *recompute*), each in span
    ``ff.so.tables.backward``; the segments' gradients are joined and
    those of the shared frequencies and weights summed."""

    @staticmethod
    def forward(ctx, omega, eigvals, dt, weights, budget_bytes=None):
        ctx.save_for_backward(omega, eigvals, dt, weights)
        ctx.budget_bytes = budget_bytes
        if eigvals.is_cuda:
            return k2_tables.weighted_lattice(omega, eigvals, dt, weights)
        return _factored_weighted_lattice_plain(omega, eigvals, dt, weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        omega, eigvals, dt, weights = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        G = eigvals.shape[-2]
        chunk = _shifts_chunk(eigvals, omega.shape[-1], weights.shape[0],
                              ctx.budget_bytes, recompute=True)
        parts = [[] for _ in need]
        for start in range(0, G, chunk):
            sl = slice(start, start + chunk)
            with tracing.span('ff.so.tables.backward'), torch.enable_grad():
                args = [x.detach().requires_grad_(n) for x, n in zip(
                    (omega, eigvals[..., sl, :], dt[..., sl], weights), need)]
                grads = iter(torch.autograd.grad(
                    _factored_weighted_lattice_plain(*args),
                    [x for x in args if x.requires_grad],
                    g[..., sl, :, :, :], allow_unused=True))
                for part, n in zip(parts, need):
                    if n:
                        part.append(next(grads))
        # omega, eigvals' segments, dt's segments, weights
        axes = (None, -2, -1, None)
        return tuple(_joined(part, axis) if n else None
                     for part, n, axis in zip(parts, need, axes)) + (None,)


def _joined(parts: Sequence[Optional[torch.Tensor]], axis: Optional[int]
            ) -> Optional[torch.Tensor]:
    """The gradients of the sub-chunks of :meth:`_K2Tables.backward`:
    concatenated along *axis*, or summed where *axis* is None (an input
    every sub-chunk shares); None where the input was unused."""
    if parts[0] is None:
        return None
    if axis is None:
        return functools.reduce(torch.add, parts)
    return torch.cat(parts, axis)


def _factored_slope_stacks(omega, eigvals, dt):
    r"""The derivatives of the K2 lattice I[o, ij, mn] of segments
    *eigvals* (..., g, d), *dt* (..., g) in Omega_ij (slot 1) and in
    Omega_mn (slot 2), Omega_ij = w_i - w_j, as separable tables: for each
    slot (left (..., T, n_w, d^2) complex, right (..., T, n_w, d^2) real,
    [(Z (..., d^2, d^2) complex, rho (..., n_w, d^2) real), ...]) with

        dI[o, ij, mn] = sum_t left_t[o, ij] right_t[o, mn]
                        + sum_s Z_s[ij, mn] rho_s[o, mn].

    Each table entry is a function of one difference, so the slopes are
    elementwise, from D_k(u) = -frac^{(k+1)}(u)/(k+1)!
    (:func:`_frac_divdiff_coeffs`): frac'(u) = -D_0(u) and D_k' =
    (k+2) D_{k+1}.  With r = 1/y off the series branch (|y dt| >=
    _SO_SMALL_Y) and s_k = (y dt)^k on it, y == 0 included::

        slot 1:  frac'(x) r - frac'(z) r + sum_k (k+2) dt dks_{k+1}(x) s_k
        slot 2:  -frac(x) r^2 + frac(z) r^2 - frac'(z) r
                 + sum_{k>=1} dks_k(x) k dt s_{k-1}

    for k < _SO_SMALL_K, dks_k = D_k/dt^k.  On the branch y == 0 the
    forward takes the limit ``special`` = D_0(x), independent of y; the
    series at y = 0 is that limit and carries its slopes, D_1 in y and
    2 D_1 in x, which the limit's constant mask cannot.  At x == 0 the
    Maclaurin branch of D_k holds the limit."""
    K = _SO_SMALL_K
    dt_o = dt[..., None, None]
    _, y, z, a, b, sin_x, cos_x, f_x, f_z = _k2_arguments(omega, eigvals, dt)
    fp_z = 1j * _first_order_integral_slope(z, dt_o)     # frac'(z)

    k_shape = (K + 1,) + (1,) * dt.ndim
    dt_pow = dt[None] ** -torch.arange(K + 1, dtype=dt.dtype,
                                       device=dt.device).reshape(k_shape)
    dks = _frac_divdiff_coeffs(a, b, dt, K + 1, sin_x, cos_x) \
        * dt_pow[..., None, None]                         # (K+1, ..., o, ij)
    ydt = y * dt_o
    small = torch.abs(ydt) < _SO_SMALL_Y
    r = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, y))
    s = torch.cumprod(torch.cat([small.to(config.REAL)[None],
                                 ydt.expand(K - 1, *ydt.shape)]), 0)
    kdt = torch.arange(1, K + 1, dtype=dt.dtype, device=dt.device
                       ).reshape((K,) + (1,) * dt.ndim)[..., None, None] \
        * dt_o                                            # k dt, k = 1..K

    left1 = torch.cat([-dks[:1], (kdt + dt_o) * dks[1:]])
    right1 = torch.cat([r[None], s])
    left2 = torch.cat([f_x[None], dks[1:]])
    right2 = torch.cat([-(r * r)[None], kdt * s])
    return ((left1.movedim(0, -3), right1.movedim(0, -3), [(-fp_z, r)]),
            (left2.movedim(0, -3), right2.movedim(0, -3),
             [(f_z, r * r), (-fp_z, r)]))


def _second_order_total(eigvals, n_opers_transformed, basis_transformed,
                        ctrlmat_step, cumul_padded, omega, dt,
                        budget_bytes: Optional[int] = None) -> torch.Tensor:
    r"""K10 total without per-step caching: the complete steps as one
    batched matmul (:func:`_second_order_complete`), the incomplete
    steps from the separable tables of the K2 lattice
    (:func:`_second_order_factored_contract`) over chunks of segments
    that fit :func:`.config.memory_budget` (*budget_bytes* overrides
    it), without the (n_w, d^4) lattice.

    eigvals (..., G, d), n_opers_transformed (..., n_nops, G, d, d),
    basis_transformed (..., G, n_b, d, d), ctrlmat_step and
    cumul_padded (..., G, n_nops, n_b, n_w), dt (..., G).  Returns
    (..., n_nops, n_nops, n_b, n_b, n_w).
    """
    with tracing.span('ff.so.total'):
        G, d = eigvals.shape[-2:]
        n_w = len(omega)
        nob = _noise_basis_products(n_opers_transformed, basis_transformed)
        n_nops, n_basis = nob.shape[-3:-1]
        A = n_nops * n_basis
        # per segment the f_z term's (ij, o, B) operand, the stacked
        # products and their o-major copies; per step its (n_w, A, A)
        # product, the f_z term, their difference and its permuted copy
        chunk = _factored_chunk(eigvals, n_w,
                                (d * d + 4 * (2 + _SO_SMALL_K)) * A,
                                budget_bytes, fixed=4 * n_w * A * A)
        total = _second_order_complete(ctrlmat_step, cumul_padded)
        for start in range(0, G, chunk):
            sl = slice(start, start + chunk)
            total = total + _second_order_factored_contract(
                omega, eigvals[..., sl, :], dt[..., sl],
                nob[..., sl, :, :, :])
        return total


def _second_order_steps(eigvals, n_opers_transformed, basis_transformed,
                        ctrlmat_step, cumul_padded, omega, dt,
                        cache_cumulative: bool,
                        show_progressbar: bool = False):
    """K10 of one pulse segment by segment, keeping what the caches
    need.  Returns (F^(2), the K2 lattices (G, n_w, d, d, d, d), the
    complete-step term, the cumulative F^(2) after each segment
    (G, ...) or None)."""
    nob = _noise_basis_products(n_opers_transformed, basis_transformed)
    complete = incomplete = 0
    lattices, cumulative = [], []
    for g in util.progressbar_range(len(eigvals),
                                    show_progressbar=show_progressbar):
        int2 = _second_order_integral_single(omega, eigvals[g], dt[g])
        incomplete = incomplete + _second_order_incomplete_contract(
            int2[None], nob[g:g + 1])
        complete = complete + _second_order_complete(
            ctrlmat_step[g:g + 1], cumul_padded[g:g + 1])
        lattices.append(int2)
        if cache_cumulative:
            cumulative.append(incomplete + complete)
    return (incomplete + complete, torch.stack(lattices), complete,
            torch.stack(cumulative) if cache_cumulative else None)


def calculate_second_order_filter_function_from_scratch(
        eigvals: torch.Tensor, eigvecs: torch.Tensor,
        propagators: torch.Tensor, omega, basis: Union[Basis, torch.Tensor],
        n_opers, n_coeffs, dt,
        intermediates: Optional[Dict[str, Any]] = None,
        show_progressbar: bool = False, cache_intermediates: bool = False,
        cache_cumulative: bool = False,
        budget_bytes: Optional[int] = None):
    r"""K10: the second-order filter function F^(2)_{ab,kl}(w)
    (n_nops, n_nops, n_b, n_b, n_w) of one pulse, on the device of
    *eigvals*.

    Per segment g the incomplete step contracts the K2 lattice with the
    noise-operator/basis products of g; the complete steps pair g's
    per-step control matrix with the cumulative one of the segments
    before it.  The per-step control matrices are taken from
    *intermediates* (the first-order cache) where they are there.

    Without ``cache_intermediates`` the segment sum runs as batched
    matmuls in chunks that fit :func:`.config.memory_budget`
    (*budget_bytes* overrides it), on the separable tables of the K2
    lattice (:func:`_second_order_total`), which it never builds.  With
    it, segment by segment, and the result comes with a dict of the
    intermediates: ``second_order_integral`` (G, n_w, d, d, d, d),
    ``second_order_complete_steps`` and, with ``cache_cumulative``,
    ``filter_function_2_step_cumulative`` (G, ...), F^(2) of each
    prefix.  The cache holds the K2 lattice, so caching builds it, as
    the JAX package's segment scan does.
    """
    device = eigvals.device

    def real(x):
        return torch.as_tensor(x, dtype=config.REAL, device=device)

    omega, n_coeffs, dt = real(omega), real(n_coeffs), real(dt)
    t = torch.cat([dt.new_zeros(1), torch.cumsum(dt, 0)])
    basis = (basis.tensor(device) if isinstance(basis, Basis)
             else torch.as_tensor(basis, dtype=config.COMPLEX,
                                  device=device))
    n_opers = torch.as_tensor(n_opers, dtype=config.COMPLEX, device=device)

    keys = ('n_opers_transformed', 'basis_transformed', 'control_matrix_step',
            'control_matrix_step_cumulative')
    have = intermediates is not None and all(k in intermediates
                                             for k in keys)
    if have:
        n_t, b_t, step, cumul = (intermediates[k] for k in keys)
    else:
        n_t, b_t, step, cumul = _second_order_step_terms(
            eigvals, eigvecs, propagators, omega, basis, n_opers, n_coeffs,
            dt, t)
    cumul_padded = _pad_cumulative(step, cumul)

    if not cache_intermediates:
        return _second_order_total(eigvals, n_t, b_t, step, cumul_padded,
                                   omega, dt, budget_bytes)
    result, lattices, complete, cumulative = _second_order_steps(
        eigvals, n_t, b_t, step, cumul_padded, omega, dt, cache_cumulative,
        show_progressbar)
    out = dict(intermediates or {})
    out['second_order_integral'] = lattices
    out['second_order_complete_steps'] = complete
    if cache_cumulative:
        out['filter_function_2_step_cumulative'] = cumulative
    for key, value in zip(keys, (n_t, b_t, step, cumul)):
        out.setdefault(key, value)
    return result, out


# -----------------------------------------------------------------------------
# K11: second-order filter function from atomic pulses
# -----------------------------------------------------------------------------
def calculate_second_order_filter_function_from_atomic(
        basis: Union[Basis, torch.Tensor], filter_function_atomic,
        control_matrix_atomic, control_matrix_atomic_step,
        control_matrix_atomic_cumulative, propagators, propagators_liouville,
        intermediates: Sequence[Mapping[str, Any]],
        show_progressbar: bool = False,
        budget_bytes: Optional[int] = None) -> torch.Tensor:
    r"""K11: the concatenation rule of the second-order filter function.

    To F^(2) of the first pulse (*filter_function_atomic*) every later
    pulse g adds the cross term conj(B_step^(g)) B_cumul^(g-1), its own
    complete steps transformed by the cumulative transfer matrix,
    Q^T N^(g) Q, and its incomplete steps with the eigenvectors
    propagated by the cumulative propagator.

    control_matrix_atomic (G, ...) gives the number of pulses;
    control_matrix_atomic_step and _cumulative (G, n_nops, n_b, n_w) are
    K5's summands and their running sum; propagators (G-1, d, d) and
    propagators_liouville (G-1, d^2, d^2) the cumulative ones;
    *intermediates* the pulses' caches, each with 'eigvecs_propagated',
    'n_opers_transformed', 'second_order_integral' and
    'second_order_complete_steps'.

    The incomplete steps of a group of pulses run over one concatenated
    segment axis (the pulses' segment counts may differ); the groups
    keep the concatenated K2 lattices and the contraction's two
    intermediates within :func:`.config.memory_budget` (*budget_bytes*
    overrides it).  Returns (n_nops, n_nops, n_b, n_b, n_w).
    """
    required = ('eigvecs_propagated', 'n_opers_transformed',
                'second_order_integral', 'second_order_complete_steps')
    for key in required:
        if not all(key in im for im in intermediates):
            raise ValueError(f"Required intermediate term {key} not found "
                             "in all intermediates.")

    result = torch.as_tensor(filter_function_atomic)
    device = result.device
    G = len(control_matrix_atomic)
    if G < 2:
        return result
    basis = (basis.tensor(device) if isinstance(basis, Basis)
             else torch.as_tensor(basis, dtype=config.COMPLEX,
                                  device=device))
    step = torch.as_tensor(control_matrix_atomic_step, device=device)
    cumul = torch.as_tensor(control_matrix_atomic_cumulative, device=device)
    props = torch.as_tensor(propagators, device=device)
    ql = torch.as_tensor(propagators_liouville, device=device).to(
        config.COMPLEX)

    result = result + _second_order_complete(step[1:G], cumul[:G - 1])

    n_nops, n_basis = step.shape[1:3]
    costs = []
    for g in range(1, G):
        h, n_w, d = intermediates[g]['second_order_integral'].shape[:3]
        costs.append(h * n_w * d * d * (d * d + 2 * n_nops * n_basis) * 16)
    budget = config.memory_budget(device, budget_bytes=budget_bytes)
    groups, used = [[]], 0
    for g, cost in zip(range(1, G), costs):
        if groups[-1] and used + cost > budget:
            groups.append([])
            used = 0
        groups[-1].append(g)
        used += cost

    for group in util.progressbar(groups) if show_progressbar else groups:
        idx = torch.as_tensor(group, device=device) - 1
        complete = torch.stack(
            [intermediates[g]['second_order_complete_steps'] for g in group])
        result = result + torch.einsum('gpk,gabpqo,gql->abklo', ql[idx],
                                       complete, ql[idx])

        evs = [intermediates[g]['eigvecs_propagated'] for g in group]
        rep = torch.repeat_interleave(
            idx, torch.as_tensor([len(ev) for ev in evs], device=device))
        eigvecs_propagated = _propagate_eigenvectors(props[rep],
                                                     torch.cat(evs))
        n_t = torch.cat([intermediates[g]['n_opers_transformed']
                         for g in group], 1)                # (a, H, i, j)
        int2 = torch.cat([intermediates[g]['second_order_integral']
                          for g in group])                  # (H, o, ...)
        vp = eigvecs_propagated[:, None]
        nob = _noise_basis_products(n_t, vp.mH @ basis @ vp)
        result = result + _second_order_incomplete_contract(int2, nob)
    return result


def trapezoid_weights(omega: torch.Tensor) -> torch.Tensor:
    """Quadrature weights w with sum_o w_o f_o == trapezoid(f, omega),
    for folding frequency integrals into contractions."""
    d = torch.diff(omega)
    return torch.cat([d[:1] / 2, (d[1:] + d[:-1]) / 2, d[-1:] / 2])


def _spectral_weights(spectrum: torch.Tensor, omega: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """S_a(w) w_trapz(w) / 2 pi (n, n_w) of a real diagonal spectrum
    (ndim 1 or 2, parsed), the weights that fold a frequency integral
    into a contraction."""
    return spectrum.expand(n, -1) * trapezoid_weights(omega) / (2 * math.pi)


def _distinct_rows(spectrum: torch.Tensor) -> int:
    """n_s, the distinct rows of a parsed real diagonal spectrum (ndim 1
    or 2), read from its shape and strides, not its values: 1 where one
    row serves every noise operator (ndim 1, or rows that are one
    stride-0 row), else one for each noise operator."""
    if spectrum.ndim == 1 or spectrum.stride(0) == 0:
        return 1
    return spectrum.shape[0]


#: Distance, per frequency of the grid and relative to a row's 2-norm,
#: within which a row of a spectrum (the real or the imaginary part of
#: one entry S_ab) counts as lying in the span of the profiles found
#: before it (:func:`_row_profiles`): n_w eps, the tolerance of numpy's
#: ``matrix_rank`` (max(m, n) eps of the largest singular value, at
#: least 1 for rows of unit norm).  Closer than that, what separates a
#: row from the span is the rounding of its entries; each row is
#: reproduced within that distance.
_PROFILE_EPS = float(np.finfo(np.float64).eps)


class _Factors(NamedTuple):
    r"""What the factorization of a spectrum, S_ab(w) = sum_r M^(r)_ab
    s_r(w) (:func:`_factor_spectrum`), keeps for the calls that share
    the spectrum.  On the device: *rows* (r, n_w), the real profiles
    s_r; *diag_factors* (n_s, r), the M^(r)_aa of the n_s distinct rows
    of the diagonal (1 where every operator has the same, else n), None
    where *pick* names the one profile that the diagonal is; *corr*
    (n_c,), the correlated operators, those with an entry off the
    diagonal; *mixing* (r_c, n_c, n_c) complex, M^(r) among them with
    its diagonal zeroed, for the r_c profiles *mixed* that have such an
    entry.  On the host: *factors* (r, n, n) complex, every M^(r)
    whole."""
    rows: torch.Tensor
    diag_factors: Optional[torch.Tensor]
    pick: Optional[int]
    corr: torch.Tensor
    mixing: torch.Tensor
    mixed: Tuple[int, ...]
    factors: np.ndarray


class _Profiles(NamedTuple):
    r"""A spectrum as real frequency profiles with mixing factors on a
    frequency grid (:func:`_spectrum_profiles`): *weights* (r, n_w),
    s_r(w) w_trapz(w) / 2 pi; *diagonal* (n_s, n_w), S_aa(w) w_trapz(w)
    / 2 pi = sum_r M^(r)_aa weights[r]; *mix_weights* (r_c, n_w)
    complex, the weights of the profiles that mix; and the fields of
    :class:`_Factors`."""
    weights: torch.Tensor
    diagonal: torch.Tensor
    mix_weights: torch.Tensor
    rows: torch.Tensor
    diag_factors: Optional[torch.Tensor]
    pick: Optional[int]
    corr: torch.Tensor
    mixing: torch.Tensor
    mixed: Tuple[int, ...]
    factors: np.ndarray

    def diagonal_lattice(self, ell: torch.Tensor) -> torch.Tensor:
        """The weighted lattices (..., n_s, d^2, d^2) of the diagonal's
        rows from those of the profiles, *ell* (..., r, d^2, d^2)."""
        if self.pick is not None:
            return ell[..., self.pick:self.pick + 1, :, :]
        return torch.einsum('sr,...rxy->...sxy',
                            self.diag_factors.to(ell.dtype), ell)

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """sum_r mix_weights[r] (mixing[r] @ x) over the correlated
        operators' axis of *x* (..., n_c, k, n_w): the part of the
        cross-spectrum off the diagonal, applied to one side."""
        flat = x.flatten(-2)
        out = None
        for m, w in zip(self.mixing, self.mix_weights):
            term = (m @ flat).unflatten(-1, x.shape[-2:])
            out = term * w if out is None else torch.addcmul(out, term, w)
        return out

    def mix_adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """The adjoint of :meth:`mix`: sum_r conj(mix_weights[r])
        (mixing[r]^H @ y) over the correlated operators' axis of *y*
        (..., n_c, k, n_w), the vector-Jacobian product of :meth:`mix`
        with cotangent *y* in PyTorch's convention."""
        flat = y.flatten(-2)
        out = None
        for m, w in zip(self.mixing, self.mix_weights):
            term = (m.mH @ flat).unflatten(-1, y.shape[-2:])
            out = term * w.conj() if out is None \
                else torch.addcmul(out, term, w.conj())
        return out


def _row_profiles(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(profiles (r, n_w), coefficients (m, r)) of distinct nonzero real
    rows (m, n_w), rows = coefficients @ profiles within
    :data:`_PROFILE_EPS` n_w of each row's 2-norm: the first profile is
    the row of largest norm itself (its coefficients exactly (1, 0, ...)),
    the others are orthogonal to it and to each other, at its norm, found
    by Gram-Schmidt with pivoting on the rows scaled to unit norm."""
    norms = np.linalg.norm(rows, axis=1)
    unit = rows / norms[:, None]
    tol = rows.shape[1] * _PROFILE_EPS
    first = int(np.argmax(norms))
    found = [unit[first]]
    left = unit - np.outer(unit @ found[0], found[0])
    while True:
        left_norms = np.linalg.norm(left, axis=1)
        k = int(np.argmax(left_norms))
        if left_norms[k] <= tol:
            break
        v = left[k] / left_norms[k]
        for _ in range(2):          # twice is enough (Kahan, Parlett)
            basis = np.stack(found)
            v = v - (basis @ v) @ basis
            v = v / np.linalg.norm(v)
        found.append(v)
        left = left - np.outer(left @ v, v)
    scale = norms[first]
    profiles = np.stack([rows[first]] + [v * scale for v in found[1:]])
    coeffs = rows @ profiles.T / scale ** 2
    coeffs[first] = np.eye(len(profiles))[0]
    return profiles, coeffs


#: The attribute under which a spectrum tensor keeps its
#: :class:`_Factors`, with its version counter and the number of noise
#: operators (:func:`_spectrum_profiles`).
_FACTORS_ATTR = '_filter_functions_factors'


def _spectrum_profiles(spectrum: torch.Tensor, omega: torch.Tensor, n: int,
                       given=None) -> _Profiles:
    r"""S_ab(w) = sum_r M^(r)_ab s_r(w) of a parsed spectrum of *n* noise
    operators that is not real and diagonal, on the grid *omega*
    (:class:`_Profiles`): the factorization of :func:`_factor_spectrum`,
    weighted by the trapezoid rule on the device.

    *given* is the spectrum as the caller passed it.  Where that is a
    tensor, it keeps the factorization (an attribute of the tensor,
    which lives and dies with it) with its version counter: a later call
    with the same tensor, not written in place since, reads nothing
    back; a write that bypasses the counter (through ``.data`` or a
    numpy view) is not seen.  Anything else is factored on every call.
    """
    with tracing.span('ff.spectrum.profiles'):
        key = found = None
        if isinstance(given, torch.Tensor) and not given.is_inference():
            key = (given._version, n, tuple(spectrum.shape))
            kept, factors = getattr(given, _FACTORS_ATTR, (None, None))
            if kept == key:
                found = factors
        if found is None:
            found = _factor_spectrum(spectrum, n)
            if key is not None:
                setattr(given, _FACTORS_ATTR, (key, found))
        weights = _spectral_weights(found.rows, omega, len(found.rows))
        if found.pick is None:
            diagonal = found.diag_factors @ weights.to(
                found.diag_factors.dtype)
        else:
            diagonal = weights[found.pick:found.pick + 1]
        return _Profiles(weights, diagonal,
                         weights[list(found.mixed)].to(config.COMPLEX),
                         *found)


def _factor_spectrum(spectrum: torch.Tensor, n: int) -> _Factors:
    r"""S_ab(w) = sum_r M^(r)_ab s_r(w) of a parsed spectrum of *n* noise
    operators that is not real and diagonal: 3-d, Hermitian along its
    first two axes, or a complex diagonal one (ndim 1 or 2), as real
    frequency profiles s_r with mixing factors M^(r) (:class:`_Factors`).

    The spectrum is read to the host once (``sync.spectrum``), with the
    flag of :func:`.util.parse_spectrum`'s check that it is Hermitian,
    evaluated on the device.  The real and imaginary parts of its
    entries are rows over the frequencies; equal rows count once, and
    the profiles are a basis of the rest within
    :data:`_PROFILE_EPS` (:func:`_row_profiles`): a separable spectrum
    C_ab s(w), with C complex and Hermitian, gives r = 1 and s(w) the
    row of its largest entry.  The profiles and factors go to the device
    at once, before any work of the call is queued, so that no later
    upload waits for it.  M^(r) is not assumed Hermitian: every entry is
    reproduced as given."""
    spectrum = spectrum.detach()
    n_w = spectrum.shape[-1]
    # the Hermitian check (torch.allclose's) on the device, its flag read
    # with the values
    hermitian = torch.isclose(spectrum, spectrum.conj().transpose(0, 1)
                              ).all() if spectrum.ndim == 3 \
        else torch.ones((), dtype=torch.bool, device=spectrum.device)
    host = torch.cat([spectrum.flatten(),
                      hermitian.to(spectrum.dtype)[None]]).cpu().numpy()
    tracing.counts['sync.spectrum'] += 1
    if not host[-1]:
        raise ValueError(util.NOT_HERMITIAN)
    host = host[:-1].reshape(spectrum.shape)
    if host.ndim < 3:
        full = np.zeros((n, n, n_w), host.dtype)
        full[np.arange(n), np.arange(n)] = np.broadcast_to(host, (n, n_w))
        host = full
    parts = [host.real] + ([host.imag] if np.iscomplexobj(host) else [])
    rows = np.concatenate([x.reshape(n * n, n_w) for x in parts])
    nonzero = np.flatnonzero((rows != 0).any(1))
    profiles, coeffs = np.zeros((1, n_w)), np.zeros((0, 1))
    if len(nonzero):
        unique, inverse = np.unique(rows[nonzero], axis=0,
                                    return_inverse=True)
        profiles, coeffs = _row_profiles(unique)
        coeffs = coeffs[inverse.reshape(-1)]
    r = len(profiles)
    factors = np.zeros((len(parts) * n * n, r))
    factors[nonzero] = coeffs
    factors = factors.reshape(len(parts), n, n, r).transpose(0, 3, 1, 2)
    factors = factors[0] + 1j * factors[1] if len(parts) == 2 \
        else factors[0] + 0j                                  # (r, n, n)

    diag = factors[:, np.arange(n), np.arange(n)].T           # (n, r)
    if not diag.imag.any():
        diag = diag.real
    if (diag == diag[0]).all():
        diag = diag[:1]
    unit = np.eye(r)
    pick = next((j for j in range(r) if len(diag) == 1
                 and np.array_equal(diag[0], unit[j])), None)
    off = np.ones((n, n), bool)
    np.fill_diagonal(off, False)
    corr = np.flatnonzero(((factors != 0) & off).any(0).any(0)
                          | ((factors != 0) & off).any(0).any(1))
    mixing = factors[:, corr[:, None], corr[None, :]] \
        * off[corr[:, None], corr[None, :]]
    mixed = tuple(int(j) for j in np.flatnonzero(mixing.any((1, 2))))
    device = spectrum.device
    return _Factors(
        torch.as_tensor(profiles, device=device),
        None if pick is not None else torch.as_tensor(diag, device=device),
        pick, torch.as_tensor(corr, device=device),
        torch.as_tensor(mixing[list(mixed)], dtype=config.COMPLEX,
                        device=device),
        mixed, factors)


def _by_row(x: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """x @ ell of x (..., n_nops, k, ij) and ell (..., n_s, ij, mn), row s
    of ell serving n_nops / n_s consecutive operators (n_s = 1 or
    n_nops): one matmul a row, with no broadcast copy of ell.  Returns
    (..., n_nops, k, mn)."""
    *lead, n_nops, k, d2 = x.shape
    n_s = ell.shape[-3]
    return (x.reshape(*lead, n_s, n_nops // n_s * k, d2) @ ell).reshape(
        *lead, n_nops, k, ell.shape[-1])


def _shifts_chunk(eigvals: torch.Tensor, n_w: int, n_s: int,
                  budget_bytes: Optional[int] = None, mixed: int = 0,
                  kernel: bool = False, held: int = 0,
                  recompute: bool = False) -> int:
    """Segments per chunk of :func:`_second_order_diag_shifts`, of its
    degenerate-eigenspace backward and of the sub-chunks of
    :meth:`_K2Tables.backward` (:func:`_factored_chunk`), with *mixed*
    complex elements a segment of a cross-spectrum's mixing (of any
    number of frequencies).

    The plain tables (the CPU's forward, every backward): beside the
    tables, the weighted right-hand tables of the n_s rows of the weights
    and the product's workspace.  Rebuilt under autograd (*recompute*,
    the backward of :class:`_K2Tables`) they hold as well what autograd
    saves and the vector-Jacobian product's arrays
    (:data:`_SO_RECOMPUTE_TEMPS`, and 13 rather than 8 tables a row of
    the weights).  The tables kernel's route (*kernel*,
    the CUDA forward, :func:`.ops.k2_tables.weighted_lattice`) holds
    what the kernel writes and the product makes instead: the left
    planes (:data:`_K2_KERNEL_TEMPS` tables), the weight-folded right
    table (8 float64 planes a row, 4 n_s tables), the product and ell
    (n_s d^4 complex each).  Those no longer outweigh the sandwich, so
    there its *held* complex elements a segment count too (the chunk's
    noise-basis products, the left factor and their product)."""
    d = eigvals.shape[-1]
    d2 = d * d
    if not kernel:
        return _factored_chunk(
            eigvals, n_w, (13 if recompute else 8) * n_s * d2
            + math.ceil(mixed / n_w), budget_bytes,
            temps=_SO_FACTORED_TEMPS
            + (_SO_RECOMPUTE_TEMPS if recompute else 0))
    return _factored_chunk(
        eigvals, n_w, 4 * n_s * d2 + math.ceil(
            (2 * n_s * d2 * d2 + held + mixed) / n_w),
        budget_bytes, temps=_K2_KERNEL_TEMPS)


def _folded_decay_amplitudes(control_matrix: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Gamma[..., a, k, l] = sum_w weights[a, w] B*_{ak}(w) B_{al}(w) of
    control matrices (..., n, n_b, n_w): the decay amplitudes of a real
    diagonal spectrum without the (n, n_b, n_b, n_w) integrand."""
    return torch.einsum('...ako,ao,...alo->...akl', control_matrix.conj(),
                        weights.to(config.COMPLEX), control_matrix).real


def _mixed_decay_amplitudes(control_matrix: torch.Tensor,
                            gamma: torch.Tensor, profiles: _Profiles
                            ) -> torch.Tensor:
    """*gamma*, the folded decay amplitudes of a cross-spectrum's
    diagonal (:func:`_folded_decay_amplitudes`), plus the part off it,
    sum_{b != a} sum_w w_trapz / 2 pi B*_{ak} S_ab B_{bl}, which goes to
    the rows of the correlated operators a: their control matrices mixed
    by :meth:`_Profiles.mix` on one side, one product over w, and no
    (a, b, k, l, w) integrand.  The sum over the noise operators is that
    of the integrand's."""
    if not profiles.mixed:
        return gamma
    with tracing.span('ff.so.mix'):
        b_c = control_matrix.index_select(-3, profiles.corr)
        off = torch.einsum('...ako,...alo->...akl', b_c.conj(),
                           profiles.mix(b_c)).real
        return gamma.index_add(-3, profiles.corr, off)


def _complete_step_shifts(ctrlmat_step: torch.Tensor, weights: torch.Tensor,
                          profiles: Optional[_Profiles] = None
                          ) -> torch.Tensor:
    r"""The complete-step term of the frequency shifts of a diagonal
    spectrum, sum_g conj(B_g) W C_g^T with C_g = sum_{g' < g} B_{g'} and
    W = diag(*weights*), as a running sum over the segments.

    One running buffer Cw = sum_{g' < g} w B_{g'} (..., n_nops, n_b, n_w)
    serves every segment, and per leading index and segment one batched
    product conj(B_g) @ Cw^T accumulates.  Cw takes B_step's layout, so
    its update is one aligned elementwise pass, and both operands of the
    product are views with the frequency axis strided, which cuBLAS
    reads transposed, the conjugate as its op: no cumulative, weighted
    or copied tensor of B_step's size is made.  With *profiles* of a
    cross-spectrum (*weights* its diagonal) the part off the diagonal,
    sum_{b != a} S_ab B_{g', b}, joins the rows of the correlated
    operators a of each update (:meth:`_Profiles.mix`); the sum over the
    noise operators is that of F^(2)'s (a, b) pairs.  Autograd runs
    through :class:`_CompleteStepShifts`, whose backward writes the
    gradient of *ctrlmat_step* once.

    ctrlmat_step (..., G, n_nops, n_b, n_w); *weights* (n_s, n_w) real
    or complex, n_s = 1 or n_nops.  Returns (..., n_nops, n_b, n_b)
    complex.
    """
    mixed = profiles is not None and bool(profiles.mixed)
    if not mixed:
        return _CompleteStepShifts.apply(ctrlmat_step, weights, None, None)
    return _CompleteStepShifts.apply(ctrlmat_step, weights,
                                     profiles.mix_weights, profiles)


def _running_weighted_sum(ctrlmat_step: torch.Tensor, w: torch.Tensor,
                          profiles: Optional[_Profiles]):
    """Yields (g, Cw_g) for g = 1 .. G - 1 of the running buffer Cw_g =
    sum_{g' < g} w B_{g'} (..., n_nops, n_b, n_w) of
    :func:`_complete_step_shifts`, updated in place by one ``addcmul``
    a segment, and with *profiles* the correlated rows' mixing in span
    ``ff.so.mix``.  *w* (n_s, 1, n_w) in B_step's dtype."""
    cw = torch.zeros_like(ctrlmat_step[..., 0, :, :, :])
    for g in range(1, ctrlmat_step.shape[-4]):
        prev = ctrlmat_step[..., g - 1, :, :, :]
        cw.addcmul_(prev, w)
        if profiles is not None:
            with tracing.span('ff.so.mix'):
                cw.index_add_(-3, profiles.corr, profiles.mix(
                    prev.index_select(-3, profiles.corr)))
        yield g, cw


class _CompleteStepShifts(torch.autograd.Function):
    r""":func:`_complete_step_shifts` with a backward of its own, which
    writes the gradient of B_step once, into one tensor, and saves no
    running buffer: the forward saves only its inputs.

    forward(ctrlmat_step (..., G, n_nops, n_b, n_w), weights (n_s, n_w),
    mix_weights, profiles): *profiles* None for a diagonal spectrum, else
    the :class:`_Profiles` of a cross-spectrum and *mix_weights* its
    ``mix_weights`` (an input, so that it keeps its derivative).

    With G the cotangent of the shifts (PyTorch's convention), W =
    diag(w), Cw_h the forward's running buffer and Suf_h = sum_{g > h}
    B_g, each segment's gradient is

        dB_h = conj(G) Cw_h + (G^T Suf_h) conj(W)
               [+ on the correlated rows the adjoint of the mixing,
                :meth:`_Profiles.mix_adjoint`, of G^T Suf_h],

    one batched product a leading index and segment for each term,
    written into dB_h's slice of the one gradient (``torch.bmm`` with
    ``out=`` from the suffix's end, then ``baddbmm_`` from the prefix's
    start); the gradients of *weights* and *mix_weights* reduce G^T
    Suf_h against B_h and the mixed B_h, where asked for.  The forward
    runs in span ``ff.so.steps``, the backward in
    ``ff.so.steps.backward``."""

    @staticmethod
    def forward(ctx, ctrlmat_step, weights, mix_weights, profiles):
        ctx.save_for_backward(ctrlmat_step, weights, mix_weights)
        ctx.profiles = profiles
        lead = ctrlmat_step.shape[:-4]
        n_nops, n_basis = ctrlmat_step.shape[-3:-1]
        # complex, so that the update runs without a cast: exact, w + 0j
        w = weights.to(ctrlmat_step.dtype)[:, None, :]
        acc = ctrlmat_step.new_zeros(*lead, n_nops, n_basis, n_basis)
        rows = list(np.ndindex(*lead))
        with tracing.span('ff.so.steps'):
            for g, cw in _running_weighted_sum(ctrlmat_step, w, profiles):
                for row in rows:
                    acc[row].baddbmm_(ctrlmat_step[row + (g,)].conj(),
                                      cw[row].mT)
        return acc

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        with tracing.span('ff.so.steps.backward'):
            ctrlmat_step, weights, mix_weights = ctx.saved_tensors
            profiles = ctx.profiles
            need_b, need_w, need_m = ctx.needs_input_grad[:3]
            G = ctrlmat_step.shape[-4]
            rows = list(np.ndindex(*ctrlmat_step.shape[:-4]))
            w = weights.to(ctrlmat_step.dtype)[:, None, :]
            d_b = torch.empty_like(ctrlmat_step) if need_b else None
            # the suffix's products, G^T Suf_h, where no gradient of
            # B_step holds them
            spare = None if need_b else \
                torch.empty_like(ctrlmat_step[..., 0, :, :, :])
            d_w = torch.zeros_like(w[:, 0, :]) if need_w else None
            d_m = torch.zeros_like(mix_weights) if need_m else None
            if need_b:
                d_b[..., G - 1, :, :, :].zero_()
            suf = ctrlmat_step[..., G - 1, :, :, :].clone()
            for h in range(G - 2, -1, -1):
                b_h = ctrlmat_step[..., h, :, :, :]
                t = spare if d_b is None else d_b[..., h, :, :, :]
                for row in rows:
                    torch.bmm(grad[row].mT, suf[row], out=t[row])
                if need_w:
                    # summed over the leading indices and the basis, and
                    # over the operators that share a row of the weights
                    prod = (t * b_h.conj()).reshape(-1, *t.shape[-3:]).sum(
                        (0, 2))
                    d_w += prod.sum(0, keepdim=True) if len(d_w) == 1 \
                        else prod
                if profiles is not None:
                    with tracing.span('ff.so.mix'):
                        t_c = t.index_select(-3, profiles.corr)
                        if need_m:
                            b_c = b_h.index_select(-3, profiles.corr)
                            for r, m in enumerate(profiles.mixing):
                                mb = (m @ b_c.flatten(-2)).unflatten(
                                    -1, b_c.shape[-2:])
                                d_m[r] += (t_c * mb.conj()).flatten(
                                    end_dim=-2).sum(0)
                        if need_b:
                            mixed = profiles.mix_adjoint(t_c)
                if need_b:
                    t.mul_(w.conj())
                    if profiles is not None:
                        t.index_add_(-3, profiles.corr, mixed)
                if h:
                    suf.add_(b_h)
            del suf
            if need_b:
                for g, cw in _running_weighted_sum(ctrlmat_step, w,
                                                   profiles):
                    for row in rows:
                        d_b[row + (g,)].baddbmm_(grad[row].conj(), cw[row])
        if d_w is not None and not weights.is_complex():
            d_w = d_w.real
        return d_b, d_w, d_m, None


def _mixed_rows(nob: torch.Tensor, ell: torch.Tensor, x: torch.Tensor,
                profiles: _Profiles) -> torch.Tensor:
    r"""sum_r (M^(r) off the diagonal)^T X_r over the correlated
    operators, X_r[a] = nob[a] @ ell[r]: what the correlations add to
    the left factor x[b] = nob[b] @ ell_diag[b] of row b of the
    incomplete steps, so that x @ nob^T sums sum_ab M_ab nob[a] ell
    nob[b]^T.  *nob* (..., g, n_nops, n_b, d^2), *ell* the profiles'
    lattices (..., g, r, d^2, d^2), *x* (..., g, n_nops, n_b, d^2) the
    diagonal's product, whose rows serve where the diagonal is the
    profile itself.  Returns (..., g, n_c, n_b, d^2)."""
    corr = profiles.corr
    nob_c = None
    out = None
    for m, r in zip(profiles.mixing, profiles.mixed):
        if r == profiles.pick:
            x_r = x.index_select(-3, corr)
        else:
            if nob_c is None:
                nob_c = nob.index_select(-3, corr)
            x_r = _by_row(nob_c, ell[..., r:r + 1, :, :])
        term = (m.mT @ x_r.flatten(-2)).unflatten(-1, x_r.shape[-2:])
        out = term if out is None else out + term
    return out


def _second_order_diag_shifts(eigvals, n_opers_transformed,
                              basis_transformed, ctrlmat_step, omega, dt,
                              weights, budget_bytes: Optional[int] = None,
                              profiles: Optional[_Profiles] = None
                              ) -> torch.Tensor:
    r"""Frequency shifts Delta[a, k, l] without the (a, b, k, l, w)
    second-order filter function: of a diagonal spectrum, and with
    *profiles* (:func:`_spectrum_profiles`) of a cross-spectrum, whose
    (a, b) pairs' sum it returns per row a.

    A diagonal spectrum reads only the a == b diagonal of F^(2).  The
    complete steps accumulate segment by segment on one running
    weighted sum of the per-step control matrices
    (:func:`_complete_step_shifts`), reading *ctrlmat_step* in place:
    this route builds no cumulative control matrix.  The incomplete
    steps reduce each chunk of segments over w first, to ell (g, s, ij,
    mn) from the separable tables of the K2 lattice
    (:func:`_factored_weighted_lattice`), once for each of the n_s rows
    of *weights*, and sandwich the result between the
    noise-operator/basis products (:func:`_by_row`).  On CUDA tensors a
    chunk's ell is one launch of the tables kernel, one DGEMM and one
    epilogue (:mod:`.ops.k2_tables`); on the CPU the plain tables.  The
    chunks fit :func:`.config.memory_budget` (*budget_bytes* overrides
    it) with what the route holds for n_s rows (:func:`_shifts_chunk`).

    A cross-spectrum S_ab = sum_r M^(r)_ab s_r builds one weighted
    lattice per profile s_r instead, the diagonal's from them
    (:meth:`_Profiles.diagonal_lattice`; *weights* is the diagonal's,
    for the complete steps), and mixes the noise operators by M^(r) on
    one side, in span ``ff.so.mix``: the complete steps' running sum
    (:func:`_complete_step_shifts`) and the incomplete steps' left
    factor (:func:`_mixed_rows`).  Neither a lattice per pair nor a
    product per pair is made.

    Spans: the complete steps ``ff.so.steps``, each chunk's lattice
    ``ff.so.tables``, and ``ff.so.sandwich`` around the noise-basis
    products and around each chunk's sandwich with its add into the
    shifts, whose backward runs in ``ff.so.sandwich.backward``
    (:func:`.tracing.backward_span`).

    eigvals (..., G, d), n_opers_transformed (..., n_nops, G, d, d),
    basis_transformed (..., G, n_b, d, d), ctrlmat_step (..., G, n_nops,
    n_b, n_w), dt (..., G); *weights* (n_s, n_w), S(w) w_trapz / 2 pi,
    with n_s = 1 (one spectrum for every noise operator: one lattice
    serves them all) or n_nops.  Returns complex (..., n_nops, n_b,
    n_b); its real part is the physical shift.
    """
    with tracing.span('ff.so.shifts'):
        G, n_w = eigvals.shape[-2], omega.shape[-1]
        shifts = _complete_step_shifts(ctrlmat_step, weights, profiles)
        rows, mixed = weights, 0
        if profiles is not None:
            rows = profiles.weights
            n_basis = basis_transformed.shape[-3]
            mixed = 3 * len(profiles.mixed) * len(profiles.corr) * n_basis \
                * eigvals.shape[-1] ** 2

        with tracing.span('ff.so.sandwich'):
            region = tracing.backward_span('ff.so.sandwich.backward',
                                           n_opers_transformed,
                                           basis_transformed)
            nob = region.outputs(_noise_basis_products(*region.inputs))
        # the sandwich's nob_c, left factor and product, (g, a, k, ij) each
        held = 3 * math.prod(nob.shape[-3:])
        chunk = _shifts_chunk(eigvals, n_w, rows.shape[0], budget_bytes,
                              mixed, kernel=eigvals.is_cuda, held=held)
        for start in range(0, G, chunk):
            sl = slice(start, start + chunk)
            ell = _factored_weighted_lattice(omega, eigvals[..., sl, :],
                                             dt[..., sl], rows, budget_bytes)
            with tracing.span('ff.so.sandwich'):
                region = tracing.backward_span('ff.so.sandwich.backward',
                                               nob, ell)
                nob_k, ell = region.inputs
                # (g, a, k, ij), copied once for both products
                nob_c = nob_k[..., sl, :, :, :].contiguous()
                shifts = region.outputs(shifts + _sandwich(nob_c, ell,
                                                           profiles))
        return shifts


def _sandwich(nob: torch.Tensor, ell: torch.Tensor,
              profiles: Optional[_Profiles]) -> torch.Tensor:
    """sum_g x @ nob^T of a chunk of segments, the left factor x = nob
    ell of :func:`_by_row` (with *profiles*, ell the diagonal's from the
    profiles' and the correlated rows mixed by :func:`_mixed_rows`): the
    incomplete steps of :func:`_second_order_diag_shifts`.  *nob* (...,
    g, n_nops, n_b, d^2), *ell* (..., g, n_s or r, d^2, d^2).  x lives
    only here."""
    if profiles is None:
        return (_by_row(nob, ell) @ nob.mT).sum(-4)
    x = _by_row(nob, profiles.diagonal_lattice(ell))
    if profiles.mixed:
        with tracing.span('ff.so.mix'):
            x.index_add_(-3, profiles.corr, _mixed_rows(nob, ell, x, profiles))
    return (x @ nob.mT).sum(-4)


class _DegenerateIncompleteSteps(torch.autograd.Function):
    r"""Zero in value; its backward is the part of the derivative of the
    incomplete-step term of the frequency shifts that :class:`_Eigh`
    drops.  Each segment contributes to row b

        sum_r sum_a M^(r)_ab sum_{ij, mn} nob_A[ij] I_r[ij, mn] nob_B[mn],
        nob_(a k)[ij] = Bbar_a[ij] Cbar_k[ji],  B = (b l),

    with I_r the K2 lattice weighted by profile r of the spectrum and
    M^(r) its mixing factors (a diagonal spectrum: one profile a
    distinct row, M diagonal), whose derivative along the off-diagonal
    entries D_pq of a degenerate eigenspace puts [D, Bbar_a] in place of
    Bbar_a in either factor, with the slope of I in that factor's
    eigenvalue difference (:func:`_factored_slope_stacks`).  The
    cotangent meets the slopes over the same chunks of segments as the
    forward, from the separable tables: the (n_w, d^4) lattice is never
    built.

    forward(h (..., G, d, d), w, v, n_opers_transformed, basis_transformed,
    omega, dt, weights, factors, budget_bytes), all but h detached:
    *weights* (n_s, n_w) the lattices' rows; *factors* None (a diagonal
    spectrum, row s serving n_nops / n_s operators, :func:`_by_row`) or
    (n_s, n_nops, n_nops) complex, the mixing factors of the profiles of
    a cross-spectrum (:class:`_Profiles`).  Returns zeros (..., n_nops,
    n_b, n_b) complex, the shape of the shifts.
    """

    @staticmethod
    def forward(ctx, h, w, v, n_t, b_t, omega, dt, weights, factors,
                budget_bytes):
        ctx.save_for_backward(w, v, n_t, b_t, omega, dt, weights, factors)
        ctx.budget_bytes = budget_bytes
        n_nops, n_basis = n_t.shape[-4], b_t.shape[-3]
        return h.new_zeros(*n_t.shape[:-4], n_nops, n_basis, n_basis)

    @staticmethod
    def backward(ctx, g):
        with tracing.span('ff.so.degenerate.backward'):
            w, v, n_t, b_t, omega, dt, weights, factors = ctx.saved_tensors
            G, d = w.shape[-2:]
            n_w, n_s = omega.shape[-1], weights.shape[0]
            mixed = 0 if factors is None else \
                2 * n_s * n_t.shape[-4] * b_t.shape[-3] * d * d
            chunk = _shifts_chunk(w, n_w, n_s, ctx.budget_bytes, mixed)
            cg = g.conj()[..., None, :, :, :]             # (1, a, k, l)
            grads = []
            for start in range(0, G, chunk):
                sl = slice(start, start + chunk)
                w_c, v_c, n_c, b_c = (w[..., sl, :], v[..., sl, :, :],
                                      n_t[..., sl, :, :],
                                      b_t[..., sl, :, :, :])
                nob = _noise_basis_products(n_c, b_c)     # (g, a, k, ij)
                dell1, dell2 = (
                    _weighted_lattice(*slot, weights) for slot in
                    _factored_slope_stacks(omega, w_c, dt[..., sl]))
                if factors is None:
                    w_mat = (_by_row(cg @ nob, dell1.mT)
                             + cg.mT @ _by_row(nob, dell2))
                else:
                    # row b holds sum_a M^(r)_ab nob[a] I_r nob[b]^T: the
                    # left factors' coefficients mixed back by M^(r), the
                    # right factor's against the mixed left factors
                    z = (cg @ nob)[..., None, :, :, :] \
                        @ dell1.mT[..., :, None, :, :]
                    y = torch.einsum('rab,...gakx->...grbkx', factors, nob)
                    w_mat = torch.einsum('rab,...grbkx->...gakx', factors,
                                         z) \
                        + (cg.mT[..., None, :, :, :]
                           @ (y @ dell2[..., :, None, :, :])).sum(-4)
                grads.append(_degenerate_grad(
                    _incomplete_coeff(w_mat, n_c, b_c), w_c, v_c))
            return (torch.cat(grads, -3),) + (None,) * 9


def _incomplete_coeff(w_mat, n_t, b_t) -> torch.Tensor:
    """The coefficient (..., g, d, d) of D_pq (:func:`_degenerate_grad`)
    of sum_{a, k, p, q} W[g, a, k, (p q)] [D, Bbar_a]_pq Cbar_k,qp, from
    W (..., g, n_nops, n_b, d^2), n_t (..., n_nops, g, d, d) and b_t
    (..., g, n_b, d, d)."""
    d = n_t.shape[-1]
    z = torch.einsum('...gakpq,...gkqp->...gapq', w_mat.unflatten(-1, (d, d)),
                     b_t)
    x = n_t.movedim(-4, -3)                               # (g, a, p, q)
    return (z @ x.mT - x.mT @ z).sum(-3)


def _degenerate_incomplete_steps(h, eigvals, eigvecs, n_opers_transformed,
                                 basis_transformed, omega, dt,
                                 weights: torch.Tensor,
                                 budget_bytes: Optional[int] = None,
                                 profiles: Optional[_Profiles] = None):
    """The :class:`_DegenerateIncompleteSteps` term of the frequency
    shifts (:func:`_second_order_diag_shifts`) of Hamiltonians *h* with
    eigendecomposition (eigvals, eigvecs), to be added to them: of a
    diagonal spectrum with the distinct rows *weights*, or of the
    cross-spectrum *profiles*.  None where no gradient reaches *h* or no
    eigenspace is degenerate."""
    if not _reaches_degenerate(h, eigvals):
        return None
    factors = None
    if profiles is not None:
        weights = profiles.weights
        factors = torch.as_tensor(profiles.factors, dtype=config.COMPLEX,
                                  device=weights.device)
    return _DegenerateIncompleteSteps.apply(
        h, eigvals.detach(), eigvecs.detach(), n_opers_transformed.detach(),
        basis_transformed.detach(), omega.detach(), dt.detach(),
        weights.detach(), factors, budget_bytes)


# -----------------------------------------------------------------------------
# K12: integrand
# -----------------------------------------------------------------------------
def _get_integrand(spectrum, omega: torch.Tensor, idx: np.ndarray,
                   which_pulse: str, which_FF: str,
                   control_matrix=None,
                   filter_function: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The real integrand S(w) F(w) at the noise indices *idx*, from a
    filter function or from a control matrix (one, or a [left, right]
    pair), for a spectrum of ndim 1 or 2 (diagonal) or 3
    (cross-spectra).

    'fidelity' gives (..., n, n, n_w) for cross-spectra and
    (..., n, n_w) otherwise; 'generalized' adds the basis axes
    (k, l) before the frequency; ``which_pulse='correlations'`` takes a
    pulse-resolved control matrix and gives two leading pulse axes.
    Leading batch axes of the filter function or control matrix are
    kept.
    """
    if filter_function is not None:
        device = filter_function.device
    elif isinstance(control_matrix, (list, tuple)):
        device = control_matrix[0].device
    else:
        device = control_matrix.device
    s = util.parse_spectrum(spectrum, omega, idx, device=device)
    idx = torch.as_tensor(idx, device=device)

    if filter_function is not None:
        f = filter_function
        if which_FF == 'generalized':
            f = f.movedim((-5, -4), (-3, -2))     # noise axes next to w
        if s.ndim in (1, 2):
            f = f[..., idx, idx, :]
        else:
            f = f[..., idx[:, None], idx, :]
        integrand = f.real * s.real
        if s.is_complex():
            integrand = integrand - f.imag * s.imag
        if which_FF == 'generalized':
            if s.ndim in (1, 2):
                integrand = integrand.movedim(-2, -4)
            else:
                integrand = integrand.movedim((-3, -2), (-5, -4))
        return integrand

    if isinstance(control_matrix, (list, tuple)):
        left, right = control_matrix[0].conj(), control_matrix[1]
    else:
        left, right = control_matrix.conj(), control_matrix
    left, right = left[..., idx, :, :], right[..., idx, :, :]
    if s.ndim in (1, 2):
        if which_pulse == 'correlations':
            sub = ('g...ko,...o,h...ko->gh...o' if which_FF == 'fidelity'
                   else 'g...ko,...o,h...lo->gh...klo')
        else:
            sub = ('...ko,...o,...ko->...o' if which_FF == 'fidelity'
                   else '...ko,...o,...lo->...klo')
    elif which_pulse == 'correlations':
        sub = ('gako,abo,hbko->ghabo' if which_FF == 'fidelity'
               else 'gako,abo,hblo->ghabklo')
    else:
        sub = ('...ako,abo,...bko->...abo' if which_FF == 'fidelity'
               else '...ako,abo,...blo->...abklo')
    return torch.einsum(sub, left, s.to(config.COMPLEX), right).real


def _integrate_2pi(integrand: torch.Tensor, omega: torch.Tensor
                   ) -> torch.Tensor:
    """Trapezoid over the last axis / 2 pi."""
    return util.integrate(integrand, omega) / (2 * math.pi)


# -----------------------------------------------------------------------------
# K13 / K14: decay amplitudes and frequency shifts
# -----------------------------------------------------------------------------
@util.parse_optional_parameters(which=('total', 'correlations'))
def calculate_decay_amplitudes(pulse, spectrum, omega,
                               n_oper_identifiers=None, which: str = 'total',
                               show_progressbar: bool = False,
                               cache_intermediates: bool = False,
                               memory_parsimonious: bool = False
                               ) -> torch.Tensor:
    r"""K13: Gamma_{ab,kl} = int dw/2pi B*_{ak} S_{ab} B_{bl} of a
    :class:`~.pulse_sequence.PulseSequence`, on its device:
    (n, n_b, n_b) for a spectrum of ndim 1 or 2, (n, n, n_b, n_b) for
    cross-spectra, with two leading pulse axes for
    ``which='correlations'``.

    From the control matrix and a real diagonal spectrum the trapezoid
    weights and S/2pi fold into one contraction 'ako,ao,alo->akl', so the
    (n, n_b, n_b, n_w) integrand never exists (19 GB at the flagship).
    Every other case integrates the integrand; ``memory_parsimonious``
    then builds it for one basis index k at a time.
    """
    idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                            n_oper_identifiers)
    omega = torch.as_tensor(omega, dtype=config.REAL, device=pulse.device)
    if which == 'total':
        if pulse.is_cached('filter_function_gen'):
            control_matrix = None
            filter_function = pulse.get_filter_function(
                omega, which='generalized')
        else:
            control_matrix = pulse.get_control_matrix(
                omega, show_progressbar, cache_intermediates)
            filter_function = None
    else:
        if pulse.is_cached('omega') and not torch.equal(pulse.omega, omega):
            raise ValueError('Pulse correlation decay amplitudes requested '
                             'but omega not equal to cached frequencies.')
        if pulse.is_cached('filter_function_pc_gen'):
            control_matrix = None
            filter_function = pulse.get_pulse_correlation_filter_function(
                which='generalized')
        else:
            control_matrix = pulse.get_pulse_correlation_control_matrix()
            filter_function = None

    s = util.parse_spectrum(spectrum, omega, idx, device=pulse.device)
    if (which == 'total' and control_matrix is not None and s.ndim <= 2
            and not s.is_complex()):
        return _folded_decay_amplitudes(
            control_matrix[torch.as_tensor(idx, device=pulse.device)],
            _spectral_weights(s, omega, len(idx)))

    if not memory_parsimonious:
        return _integrate_2pi(_get_integrand(
            s, omega, idx, which, 'generalized',
            control_matrix=control_matrix, filter_function=filter_function),
            omega)

    slices = []
    for k in util.progressbar_range(len(pulse.basis),
                                    show_progressbar=show_progressbar,
                                    desc='Integrating'):
        if control_matrix is not None:
            part = _get_integrand(
                s, omega, idx, which, 'generalized',
                control_matrix=[control_matrix[..., k:k + 1, :],
                                control_matrix])
        else:
            part = _get_integrand(
                s, omega, idx, which, 'generalized',
                filter_function=filter_function[..., k:k + 1, :, :])
        slices.append(_integrate_2pi(part, omega))
    return torch.cat(slices, dim=-2)


def calculate_frequency_shifts(pulse, spectrum, omega,
                               n_oper_identifiers=None,
                               show_progressbar: bool = False
                               ) -> torch.Tensor:
    r"""K14: Delta_{ab,kl} = int dw/2pi S_{ab}(w) F^(2)_{ab,kl}(w) of a
    :class:`~.pulse_sequence.PulseSequence`, from its (cached)
    second-order filter function; shapes as
    :func:`calculate_decay_amplitudes`."""
    idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                            n_oper_identifiers)
    omega = torch.as_tensor(omega, dtype=config.REAL, device=pulse.device)
    ff2 = pulse.get_filter_function(omega, order=2,
                                    show_progressbar=show_progressbar)
    return _integrate_2pi(_get_integrand(spectrum, omega, idx, 'total',
                                         'generalized', filter_function=ff2),
                          omega)


# -----------------------------------------------------------------------------
# K15: cumulant function
# -----------------------------------------------------------------------------
#: Index letters of the four basis elements in tr(C_p0 C_p1 C_p2 C_p3).
_TRACE_SLOTS = ('ab', 'bc', 'cd', 'da')


def _trace_contract_basis(coeff: torch.Tensor, basis: Basis, pattern: str
                          ) -> torch.Tensor:
    """sum_kl coeff[..., k, l] tr(C_p0 C_p1 C_p2 C_p3) -> (..., i, j),
    with *pattern* = p0 p1 p2 p3 a permutation of 'ijkl', contracted
    through the basis without the n^4 trace tensor.

    The contraction runs as four pairwise einsums, l, then k, then i,
    then j, each output keeping only the matrix indices a later operand
    needs: O(n^2 d^2 + n d^4) per leading index.  (A five-operand
    ``torch.einsum`` would contract left to right without a path
    optimizer.)
    """
    b = basis.tensor(coeff.device)
    slot = {p: _TRACE_SLOTS[pos] for pos, p in enumerate(pattern)}

    def kept(have, later):
        return ''.join(sorted(set(have) & set(later)))

    y = torch.einsum(f"...kl,l{slot['l']}->...k{slot['l']}",
                     coeff.to(config.COMPLEX), b)
    w_idx = kept(slot['k'] + slot['l'], slot['i'] + slot['j'])
    w = torch.einsum(f"...k{slot['l']},k{slot['k']}->...{w_idx}", y, b)
    z_idx = kept(w_idx + slot['i'], slot['j'])
    z = torch.einsum(f"...{w_idx},i{slot['i']}->...i{z_idx}", w, b)
    return torch.einsum(f"...i{z_idx},j{slot['j']}->...ij", z, b).real


def _cumulant_trace_combos(basis: Basis) -> Tuple[np.ndarray, np.ndarray]:
    """Host precombination of the four trace-tensor transposes that
    Gamma and Delta each contract with: (tg, td) with
    K = Gamma.tg + Delta.td via '...kl,klij->...ij', cached on the
    basis."""
    def compute():
        tr = basis.four_element_traces.real
        x1 = tr.transpose(0, 1, 3, 2)                 # T_klji
        tg = -0.5 * (x1
                     - tr.transpose(0, 2, 3, 1)       # T_kjli
                     - tr.transpose(0, 2, 1, 3)       # T_kilj
                     + tr.transpose(0, 3, 1, 2))      # T_kijl
        td = -0.5 * (x1
                     - tr.transpose(1, 0, 3, 2)       # T_lkji
                     - tr                             # T_klij
                     + tr.transpose(1, 0, 2, 3))      # T_lkij
        return np.ascontiguousarray(tg), np.ascontiguousarray(td)
    return basis._cached('cumulant_trace_combos', compute)


def _cumulant_1q_combos(n_basis: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tg, td) of the single-qubit closed form, in the layout of
    :func:`_cumulant_trace_combos`: K_0i = K_i0 = 0, K_ij = Gamma_ij
    off the diagonal, K_ii = -sum_{k != i, k > 0} Gamma_kk, plus
    Delta_ji - Delta_ij.

    It is the JAX package's K for d = 2, and not the trace combos': the
    two agree for symmetric Gamma only.  The Gamma of one pair (a, b)
    of a cross-spectrum, or of one pulse pair of
    ``which='correlations'``, is not symmetric, and there the trace
    combos are ~2 % off per pair (sums over the pairs agree)."""
    eye = np.eye(n_basis)
    pos = (np.arange(n_basis) > 0).astype(float)
    inner = np.outer(pos, pos)                            # i, j > 0
    tg = (np.einsum('ki,lj,ij->klij', eye, eye, inner * (1 - eye))
          + np.einsum('ij,i,kl,k,ki->klij', eye, pos, eye, pos, eye - 1))
    td = inner * (np.einsum('kj,li->klij', eye, eye)
                  - np.einsum('ki,lj->klij', eye, eye))
    return tg, td


def _cumulant_trace_combos_dev(basis: Basis, device
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (tg, td) that the cumulant function contracts Gamma and Delta
    with, on *device*, cached on the basis per device: the closed form
    of :func:`_cumulant_1q_combos` for single-qubit Pauli and GGM bases,
    :func:`_cumulant_trace_combos` otherwise."""
    device = torch.device(device)

    def upload():
        combos = (_cumulant_1q_combos(len(basis))
                  if basis.d == 2 and basis.btype in ('Pauli', 'GGM')
                  else _cumulant_trace_combos(basis))
        return tuple(torch.as_tensor(x, device=device) for x in combos)
    return basis._cached(('cumulant_trace_combos_dev', device), upload)


def _cumulant_contract_core(coeff: torch.Tensor, combo: torch.Tensor
                            ) -> torch.Tensor:
    """'...kl,klij->...ij' of real coefficients and a trace combo, as one
    float64 matmul."""
    n2 = combo.shape[0] * combo.shape[1]
    out = coeff.reshape(-1, n2) @ combo.reshape(n2, -1)
    return out.reshape(*coeff.shape[:-2], *combo.shape[2:])


@util.parse_optional_parameters(which=('total', 'correlations'))
def calculate_cumulant_function(
        pulse, spectrum=None, omega=None, n_oper_identifiers=None,
        which: str = 'total', second_order: bool = False,
        decay_amplitudes=None, frequency_shifts=None,
        show_progressbar: bool = False, memory_parsimonious: bool = False,
        cache_intermediates: Optional[bool] = None) -> torch.Tensor:
    r"""K15: the cumulant function K_{a,ij}(tau) (per noise operator, or
    per pair for cross-spectra) of a
    :class:`~.pulse_sequence.PulseSequence`, on its device, from the
    decay amplitudes and, for ``second_order``, the frequency shifts
    (computed, or given precomputed).

    K = -1/2 [Gamma.(T_klji - T_kjli - T_kilj + T_kijl)
              + Delta.(T_klji - T_lkji - T_klij + T_lkij)]
    with T the four-element traces of the basis: for n <= 64 one float64
    matmul each with the host-precombined combos
    (:func:`_cumulant_trace_combos_dev`, the single-qubit closed form
    for d = 2 Pauli and GGM bases), a contraction through the basis
    above.  ``cache_intermediates`` defaults to *second_order*.
    """
    if spectrum is None and omega is None:
        if decay_amplitudes is None or (frequency_shifts is None
                                        and second_order):
            raise ValueError('Require either spectrum and frequencies or '
                             'precomputed decay amplitudes (frequency '
                             'shifts)')
    if which == 'correlations' and second_order:
        raise ValueError('Cannot compute correlation cumulant function for '
                         'second order terms')
    if cache_intermediates is None:
        cache_intermediates = second_order

    if decay_amplitudes is None:
        decay_amplitudes = calculate_decay_amplitudes(
            pulse, spectrum, omega, n_oper_identifiers, which,
            show_progressbar, cache_intermediates, memory_parsimonious)
    gamma = torch.as_tensor(decay_amplitudes, dtype=config.REAL,
                            device=pulse.device)
    delta = None
    if second_order:
        if frequency_shifts is None:
            if memory_parsimonious:
                warn('Memory parsimonious calculation not implemented for '
                     'frequency shifts.')
            frequency_shifts = calculate_frequency_shifts(
                pulse, spectrum, omega, n_oper_identifiers,
                show_progressbar)
        delta = torch.as_tensor(frequency_shifts, dtype=config.REAL,
                                device=pulse.device)
        if delta.shape != gamma.shape:
            raise ValueError('Frequency shifts not same shape as decay '
                             'amplitudes')

    return _cumulant_contract(gamma, delta, pulse.basis)


def _cumulant_contract(gamma: torch.Tensor, delta: Optional[torch.Tensor],
                       basis: Basis) -> torch.Tensor:
    """K of :func:`calculate_cumulant_function` from Gamma and Delta (None
    at first order), on Gamma's device: for n <= 64 one float64 matmul
    each with the precombined combos (:func:`_cumulant_trace_combos_dev`),
    a contraction through the basis above (:func:`_trace_contract_basis`:
    the combos would be n^4 float64, 34 GB at n = 256)."""
    if len(basis) <= 64:
        tg, td = _cumulant_trace_combos_dev(basis, gamma.device)
        k_fn = _cumulant_contract_core(gamma, tg)
        if delta is not None:
            k_fn = k_fn + _cumulant_contract_core(delta, td)
        return k_fn

    def contract(coeff, patterns):
        a, b, c, e = (_trace_contract_basis(coeff, basis, p)
                      for p in patterns)
        return -0.5 * (a - b - c + e)
    k_fn = contract(gamma, ('klji', 'kjli', 'kilj', 'kijl'))
    if delta is not None:
        k_fn = k_fn + contract(delta, ('klji', 'lkji', 'klij', 'lkij'))
    return k_fn


# -----------------------------------------------------------------------------
# K16: error transfer matrix
# -----------------------------------------------------------------------------
def _expm(a: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of real square matrices (..., n, n): scaling
    and squaring of the degree-18 Taylor polynomial, with the largest
    1-norm scaled to <= 1 (truncation < 1/19! ~ 8e-18).

    ``torch.linalg.matrix_exp`` is off by up to 1.4e-13 absolute on
    matrices of 1-norm ~0.01-0.03, which is where the cumulant functions
    of weak noise lie; this form keeps ~1e-16 there.  Reading the norm
    synchronizes with the device once.
    """
    norm = a.abs().sum(-2).amax().item()
    tracing.counts['sync.expm'] += 1
    squarings = max(0, math.ceil(math.log2(norm))) if norm > 0 else 0
    a = a / 2.0**squarings
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    result = eye + a / 18
    for k in range(17, 0, -1):
        result = eye + (a @ result) / k
    for _ in range(squarings):
        result = result @ result
    return result


def error_transfer_matrix(pulse=None, spectrum=None, omega=None,
                          n_oper_identifiers=None, second_order: bool = False,
                          cumulant_function=None,
                          show_progressbar: bool = False,
                          memory_parsimonious: bool = False,
                          cache_intermediates: Optional[bool] = None
                          ) -> torch.Tensor:
    r"""K16: the error transfer matrix U_tilde = exp K(tau), K the
    cumulant function summed over its leading (noise-operator) axes
    (exponentiated by :func:`_expm`),
    computed from *pulse*, *spectrum* and *omega*
    (:func:`calculate_cumulant_function`) or given.  Returns real
    (n_b, n_b), on the pulse's device (or the given tensor's)."""
    if cumulant_function is None:
        if pulse is None or spectrum is None or omega is None:
            raise ValueError('Require either precomputed cumulant function '
                             'or pulse, spectrum, and omega as arguments.')
        cumulant_function = calculate_cumulant_function(
            pulse, spectrum, omega, n_oper_identifiers, 'total',
            second_order, show_progressbar=show_progressbar,
            memory_parsimonious=memory_parsimonious,
            cache_intermediates=cache_intermediates)
    if not isinstance(cumulant_function, (torch.Tensor, np.ndarray)):
        raise TypeError('cumulant_function invalid type: '
                        f'{type(cumulant_function)}')
    k_total = torch.as_tensor(cumulant_function, dtype=config.REAL)
    if k_total.ndim > 2:
        k_total = k_total.sum(dim=tuple(range(k_total.ndim - 2)))
    if k_total.ndim != 2 or k_total.shape[0] != k_total.shape[1]:
        raise ValueError('cumulant_function invalid shape: '
                         f'{tuple(cumulant_function.shape)}')
    return _expm(k_total)


# -----------------------------------------------------------------------------
# K17: infidelity
# -----------------------------------------------------------------------------
def _nontraceless_trace_correction(basis: Basis) -> np.ndarray:
    """traces_diag_kl = sum_m [tr(C_k C_l C_m C_m) - tr(C_k C_m C_l C_m)]
    computed through the basis, never materializing the trace tensor."""
    b = basis.np
    m1 = np.einsum('mab,mbc->ac', b, b)                 # sum_m C_m C_m
    term1 = np.einsum('kab,lbc,ca->kl', b, b, m1, optimize=True)
    t2 = np.einsum('mab,lbc,mcd->lad', b, b, b, optimize=True)
    term2 = np.einsum('kab,lba->kl', b, t2, optimize=True)
    return (term1 - term2).real


@util.parse_optional_parameters(which=('total', 'correlations'))
def infidelity(pulse, spectrum, omega, n_oper_identifiers=None,
               which: str = 'total', show_progressbar: bool = False,
               cache_intermediates: bool = False,
               return_smallness: bool = False,
               test_convergence: bool = False):
    r"""K17: leading-order entanglement infidelity
    I = 1/(2 pi d) int dw S(w) F(w) of a
    :class:`~.pulse_sequence.PulseSequence`, per noise operator, on the
    pulse's device.

    *spectrum* has ndim 1 (shared), 2 (per operator) or 3
    (cross-spectra), real or complex; *omega* (n_w,) is moved to the
    pulse's device.  ``which='correlations'`` takes the pulse-correlation
    filter function of a concatenated pulse.  With
    ``return_smallness`` also the smallness parameter xi.  With
    ``test_convergence``, *spectrum* must be a callable and *omega* a
    dict of grid parameters; returns (n_samples, infidelities).
    """
    idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                            n_oper_identifiers)

    if test_convergence:
        if not callable(spectrum):
            raise TypeError('Spectrum should be callable when '
                            'test_convergence == True.')
        try:
            omega_IR = omega.get('omega_IR', 2 * np.pi / pulse.tau * 1e-2)
        except AttributeError:
            raise TypeError('omega should be dictionary with parameters '
                            'when test_convergence == True.')
        omega_UV = omega.get('omega_UV', 2 * np.pi / pulse.tau * 1e+2)
        spacing = omega.get('spacing', 'linear')
        n_min = omega.get('n_min', 100)
        n_max = omega.get('n_max', 500)
        n_points = omega.get('n_points', 10)
        if spacing == 'linear':
            xspace = np.linspace
        elif spacing == 'log':
            xspace = np.geomspace
        else:
            raise ValueError("spacing should be either 'linear' or 'log'.")
        delta_n = (n_max - n_min) // (n_points - 1)
        n_samples = np.arange(n_min, n_max + delta_n, delta_n)
        infids = []
        for n in n_samples:
            freqs = xspace(omega_IR, omega_UV, int(n))
            infids.append(infidelity(pulse, spectrum(freqs), freqs,
                                     n_oper_identifiers=n_oper_identifiers,
                                     which='total'))
        return n_samples, torch.stack(infids)

    omega = torch.as_tensor(omega, dtype=config.REAL, device=pulse.device)
    if which == 'total':
        if not pulse.basis.istraceless:
            traces_diag = torch.as_tensor(
                _nontraceless_trace_correction(pulse.basis),
                dtype=config.COMPLEX, device=pulse.device)
            control_matrix = pulse.get_control_matrix(
                omega, show_progressbar, cache_intermediates)
            filter_function = torch.einsum(
                'ako,blo,kl->abo', control_matrix.conj(), control_matrix,
                traces_diag) / pulse.d
        else:
            filter_function = pulse.get_filter_function(
                omega, which='fidelity', show_progressbar=show_progressbar,
                cache_intermediates=cache_intermediates)
    else:
        if pulse.is_cached('omega') and not torch.equal(pulse.omega, omega):
            raise ValueError('Pulse correlation infidelities requested but '
                             'omega not equal to cached frequencies.')
        filter_function = pulse.get_pulse_correlation_filter_function()

    integrand = _get_integrand(spectrum, omega, idx, which, 'fidelity',
                               filter_function=filter_function)
    infid = util.integrate(integrand, omega) / (2 * math.pi * pulse.d)

    if return_smallness:
        s = spectrum if isinstance(spectrum, torch.Tensor) else \
            torch.as_tensor(np.asarray(spectrum), device=pulse.device)
        if s.ndim > 2:
            raise NotImplementedError('Smallness parameter only implemented '
                                      'for uncorrelated noise sources')
        t1 = util.integrate(s, omega) / (2 * math.pi)
        t2 = (pulse.dt * pulse.n_coeffs[idx]).sum(axis=-1)**2
        t3 = util.abs2(pulse.n_opers[idx]).sum(axis=(1, 2))
        xi = torch.sqrt((t1 * torch.as_tensor(t2 * t3, device=pulse.device)
                         ).sum())
        return infid, xi
    return infid
