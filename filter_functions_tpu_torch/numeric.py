r"""Numerical kernels of the control-matrix pipeline (counterparts of
``filter_functions_tpu.numeric``): diagonalization (K0), the
per-segment step terms of the control matrix (K4) and its contraction.

Complex values are ``complex128`` tensors and reals ``float64``.  Every
function takes any number of leading batch axes where the JAX package
relied on ``vmap``.  Shapes below name only the trailing axes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import config, util
from .ops import ozaki


def _cexp(x: torch.Tensor) -> torch.Tensor:
    """e^{ix} of a real tensor."""
    return torch.complex(torch.cos(x), torch.sin(x))


# -----------------------------------------------------------------------------
# K0: diagonalization
# -----------------------------------------------------------------------------
def diagonalize(h: torch.Tensor, dt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a piecewise-constant Hamiltonian h (G, d, d)
    with segment durations dt (G,), and its cumulative propagators.

    Returns eigvals (G, d), eigvecs (G, d, d) and propagators
    (G+1, d, d) with Q_0 the identity.
    """
    d = h.shape[-1]
    eigvals, eigvecs = torch.linalg.eigh(h)
    phase = _cexp(-dt[..., None] * eigvals)                 # e^{-i D dt}
    piecewise = (eigvecs * phase[..., None, :]) @ eigvecs.mH
    cumulative = util.adot(piecewise, dim=-3)
    ident = torch.eye(d, dtype=h.dtype, device=h.device).expand(
        *h.shape[:-3], 1, d, d)
    return eigvals, eigvecs, torch.cat([ident, cumulative], dim=-3)


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
    phase_factors = _cexp(t[..., :, None] * omega)          # (G, n_w)
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


def _is_deep(K: int) -> bool:
    """Whether a K-deep contraction is in the deep regime (1024 < K <=
    16384), decided by the bf16 slice rule at 30 bits as in the JAX
    package."""
    sb, _ = ozaki._slice_params(K, config.PRECISION_BITS)
    return sb in (5, 6)


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
