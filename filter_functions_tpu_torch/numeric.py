r"""Numerical kernels (counterparts of ``filter_functions_tpu.numeric``):
diagonalization (K0), the control matrix from scratch (K4: per-segment
step terms and their contraction), the filter functions (K8, K9) and
the infidelity (K17).

Complex values are ``complex128`` tensors and reals ``float64``.  The
K0 and K4 helpers take any number of leading batch axes where the JAX
package relied on ``vmap``; shapes below name only the trailing axes.
Host metadata (coefficients, durations, the basis master copy) may come
as numpy and is moved to the device of the eigenvalues.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import config, util
from .basis import Basis
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


def _ctrlmat_step_contract(n_opers_transformed, integral, basis_transformed,
                           phase_factors) -> torch.Tensor:
    """Per-segment variant of :func:`_ctrlmat_contract`,
    'go,jgmn,gomn,gknm->gjko': one complex128 product per segment,
    P[g] (n_w x d^2) @ D[g] (d^2 x n_nops n_b).  This is the JAX
    package's full-precision route for the per-step matrices.

    Returns the per-step control matrices (G, n_nops, n_b, n_w).
    """
    G, n_w, d = integral.shape[-4:-1]
    n_nops = n_opers_transformed.shape[-4]
    n_basis = basis_transformed.shape[-3]
    p_mat = (integral * phase_factors[..., None, None]).reshape(G, n_w,
                                                                d * d)
    b_fac = n_opers_transformed.permute(1, 2, 3, 0).reshape(G, d * d,
                                                            n_nops)
    c_fac = basis_transformed.permute(0, 3, 2, 1).reshape(G, d * d,
                                                          n_basis)
    d_mat = (b_fac[..., :, None] * c_fac[..., None, :]).reshape(
        G, d * d, n_nops * n_basis)
    return (p_mat @ d_mat).reshape(G, n_w, n_nops, n_basis).permute(
        0, 2, 3, 1)


def _pick_chunk(G: int, n_omega: int, d: int, budget_bytes: int) -> int:
    """Segments per accumulation step so that the (chunk, n_omega, d, d)
    complex128 integral table stays within *budget_bytes*."""
    per_seg = max(n_omega * d * d * 16, 1)
    return max(1, min(G, budget_bytes // per_seg))


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
    chunk = _pick_chunk(G, len(omega), d, config.memory_budget(
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
        if mode == 'ozaki' and 0 < config.ESCALATION_TOL < ratio.item():
            contrib, _ = _ctrlmat_contract(n_t, integral, b_t, ph, 'force',
                                           mode)
        result = result + contrib
    return result


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
# K17: infidelity
# -----------------------------------------------------------------------------
def _get_integrand(spectrum, omega: torch.Tensor, idx: np.ndarray,
                   filter_function: torch.Tensor) -> torch.Tensor:
    """Real integrand Re S(w) F(w) of the fidelity filter function
    (..., n_nops, n_nops, n_w) at the noise indices *idx*: the diagonal
    for a spectrum of ndim 1 or 2, the (idx, idx) block for a
    cross-spectrum of ndim 3."""
    s = util.parse_spectrum(spectrum, omega, idx,
                            device=filter_function.device)
    idx = torch.as_tensor(idx, device=filter_function.device)
    if s.ndim in (1, 2):
        f = filter_function[..., idx, idx, :]
    else:
        f = filter_function[..., idx[:, None], idx, :]
    if s.is_complex():
        return f.real * s.real - f.imag * s.imag
    return f.real * s


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

    integrand = _get_integrand(spectrum, omega, idx, filter_function)
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
