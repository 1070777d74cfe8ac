"""Plain filter-function arithmetic of piecewise-constant pulses.

The first-order control matrix and the infidelity written out from the
filter-function formalism (Hangleiter, Cerfontaine and Bluhm, PRR 3,
013024 (2021), eqs. (2.12), (3.7)), segment by segment in plain
``torch``: no kernel, no chunking, no quantized contraction.  It imports
nothing of the program under test.

For segment g with Hamiltonian H_g = V_g diag(E_g) V_g^dag, duration
dt_g and start time t_g, and the propagator Q_g up to its start,

    B_ak(w) = sum_g e^{i w t_g} sum_mn Abar_a[m, n] I_mn(w) Cbar_k[n, m],
    Abar_a = s_a^(g) V_g^dag A_a V_g,
    Cbar_k = V_g^dag Q_g C_k Q_g^dag V_g,
    I_mn(w) = (e^{i x dt_g} - 1) / (i x),   x = w + E_m - E_n,

and the infidelity of noise operator a is
int dw S(w) sum_k |B_ak(w)|^2 / (2 pi d), a trapezoid over the samples.
``I_mn`` is taken as dt e^{i x dt / 2} sinc(x dt / 2 pi), which has no
cancellation as x goes to 0.
"""
from __future__ import annotations

import math

import torch

#: The working dtypes of each precision: the configuration's (float64)
#: and the control's, the nearest precision below it (float32).
DTYPES = {'float64': (torch.float64, torch.complex128),
          'float32': (torch.float32, torch.complex64)}


def control_matrix(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis, omega,
                   precision: str = 'float64') -> torch.Tensor:
    """Control matrices (b, n_nops, n_basis, n_w) of a batch of pulses.

    c_opers (n_ctrl, d, d), n_opers (n_nops, d, d), basis (n_basis, d, d)
    are shared; c_coeffs (b, n_ctrl, G), n_coeffs (b, n_nops, G) and
    dt (b, G) are per pulse.  A segment of zero duration adds nothing.
    """
    real, cplx = DTYPES[precision]
    c_opers, n_opers, basis = (x.to(cplx) for x in (c_opers, n_opers, basis))
    c_coeffs, n_coeffs, dt, omega = (x.to(real) for x in
                                     (c_coeffs, n_coeffs, dt, omega))
    b, _, G = c_coeffs.shape
    d = c_opers.shape[-1]
    n_nops, n_basis, n_w = n_opers.shape[0], basis.shape[0], omega.shape[0]

    ham = torch.einsum('jmn,bjg->bgmn', c_opers, c_coeffs.to(cplx))
    # LAPACK on the host: cuSOLVER's batched solver stops unconverged in
    # float32 on the degenerate segments of the QFT pulse
    energies, vecs = (x.to(omega.device)      # (b, G, d), (b, G, d, d)
                      for x in torch.linalg.eigh(ham.cpu()))
    starts = torch.cumsum(dt, -1) - dt
    q = torch.eye(d, dtype=cplx, device=omega.device).expand(b, d, d)
    out = torch.zeros(b, n_nops, n_w, n_basis, dtype=cplx,
                      device=omega.device)
    for g in range(G):
        v, e, step = vecs[:, g], energies[:, g], dt[:, g]
        a_bar = (v.mH[:, None] @ n_opers @ v[:, None]
                 * n_coeffs[:, :, g, None, None])        # (b, n_nops, d, d)
        u = q.mH @ v
        c_bar = u.mH[:, None] @ basis @ u[:, None]       # (b, n_basis, d, d)
        x = (omega[None, :, None, None]
             + (e[:, :, None] - e[:, None, :])[:, None])  # (b, n_w, d, d)
        half = (x * step[:, None, None, None] / 2)
        integral = (step[:, None, None, None] * torch.sinc(half / math.pi)
                    * torch.polar(torch.ones_like(half), half))
        lhs = (a_bar[:, :, None] * integral[:, None]).reshape(
            b, n_nops * n_w, d * d)
        rhs = c_bar.transpose(-1, -2).reshape(b, n_basis, d * d).mT
        phase = torch.polar(torch.ones_like(omega), omega * starts[:, g, None])
        out += (lhs @ rhs).reshape(b, n_nops, n_w, n_basis) \
            * phase[:, None, :, None]
        prop = v @ (torch.polar(torch.ones_like(e), -e * step[:, None])[
            ..., None] * v.mH)
        q = prop @ q
    return out.transpose(-1, -2)


def infidelity(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis, omega,
               spectrum, precision: str = 'float64') -> torch.Tensor:
    """Infidelities (b, n_nops) of a batch of pulses for a spectrum (n_w,)
    shared by the noise operators."""
    real, _ = DTYPES[precision]
    ctrl = control_matrix(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                          omega, precision)
    omega, spectrum = omega.to(real), spectrum.to(real)
    fidelity_ff = (ctrl.real ** 2 + ctrl.imag ** 2).sum(-2)  # (b, n_nops, w)
    integrand = fidelity_ff * spectrum
    trapezoid = ((integrand[..., 1:] + integrand[..., :-1])
                 * torch.diff(omega)).sum(-1) / 2
    return trapezoid / (2 * math.pi * c_opers.shape[-1])
