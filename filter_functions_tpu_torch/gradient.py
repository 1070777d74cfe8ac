"""Analytic filter-function and infidelity derivatives with respect to
the control amplitudes (counterpart of ``filter_functions_tpu.gradient``;
formalism from Le et al., PRApplied 17, 024006 (2022)).

Only auto-correlated noise (no cross-spectra) is supported, as in the
JAX package.  ``torch.autograd`` through :mod:`.functional` gives the
same derivative of the infidelity; the two check each other
(tests/test_torch_gradient.py).

Every value is complex128 / float64 on the device of the pulse's
tensors.  The segments are processed in chunks whose derivative-integral
lattices fit :func:`.config.memory_budget`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import config, numeric, superoperator, util
from .basis import Basis

__all__ = ['calculate_derivative_of_control_matrix_from_scratch',
           'calculate_filter_function_derivative', 'infidelity_derivative']

#: Lattice-size (n_w d^4) complex128 arrays that one segment's derivative
#: integral holds at once: frac(z), z and its sin/cos, the general form
#: and the result.
_K3_TEMPS = 6


def _derivative_integral(omega: torch.Tensor, eigvals: torch.Tensor,
                         dt: torch.Tensor) -> torch.Tensor:
    r"""K3: the integral in the control-matrix derivative of segments with
    eigenvalues *eigvals* (..., d) and durations *dt* (...), for omega
    (n_w,); complex (..., n_w, d, d, d, d) indexed (o, p, q, m, n).

    With y = omega + Omega_mn, z = y + Omega_pq and
    frac(u) = (e^{i u dt} - 1)/u (frac(0) = i dt)::

        Omega_pq != 0:  (frac(y) - frac(z)) / Omega_pq
        Omega_pq == 0:  (frac(y) - i dt e^{i y dt}) / y   (y != 0)
                        dt^2 / 2                          (y == 0)

    The masks are exact equalities, as in the JAX package: degenerate
    eigenvalues come out of the eigendecomposition exactly equal.
    """
    d = eigvals.shape[-1]
    lead = eigvals.shape[:-1]
    n_w = omega.shape[-1]
    dE = (eigvals[..., :, None] - eigvals[..., None, :]).reshape(*lead,
                                                                  d * d)
    dt_y = dt[..., None, None]
    y = omega[:, None] + dE[..., None, :]                 # (o, mn)

    # sin/cos by angle addition of omega dt and Omega dt
    a = omega * dt[..., None]
    so, co = torch.sin(a)[..., :, None], torch.cos(a)[..., :, None]
    b = dE * dt[..., None]
    sd, cd = torch.sin(b), torch.cos(b)                   # (pq,)
    sy = so * cd[..., None, :] + co * sd[..., None, :]
    cy = co * cd[..., None, :] - so * sd[..., None, :]
    frac_y = torch.complex(*numeric._frac_from_trig(y, sy, cy, dt_y))

    # z[o, pq, mn] = y[o, mn] + Omega_pq
    z = y[..., :, None, :] + dE[..., None, :, None]
    sd_pq, cd_pq = sd[..., None, :, None], cd[..., None, :, None]
    sz = sy[..., :, None, :] * cd_pq + cy[..., :, None, :] * sd_pq
    cz = cy[..., :, None, :] * cd_pq - sy[..., :, None, :] * sd_pq
    frac_z = torch.complex(*numeric._frac_from_trig(z, sz, cz,
                                                    dt_y[..., None]))

    mask_pq = dE != 0.0
    r_pq = 1.0 / torch.where(mask_pq, dE, 1.0)
    general = (frac_y[..., :, None, :] - frac_z) * r_pq[..., None, :, None]

    mask_y = y != 0.0
    r_y = 1.0 / torch.where(mask_y, y, 1.0)
    num = frac_y - torch.complex(-sy * dt_y, cy * dt_y)   # - i dt e^{i y dt}
    limit = (dt_y * dt_y / 2).expand_as(y).to(config.COMPLEX)
    diag_val = torch.where(mask_y, num * r_y, limit)
    out = torch.where(mask_pq[..., None, :, None], general,
                      diag_val[..., :, None, :])
    return out.reshape(*lead, n_w, d, d, d, d)


def _liouville_derivative(dt: torch.Tensor, propagators: torch.Tensor,
                          basis: torch.Tensor, eigvecs: torch.Tensor,
                          eigvals: torch.Tensor,
                          c_opers_transformed: torch.Tensor) -> torch.Tensor:
    r"""Derivatives of the cumulative propagators Q_1 .. Q_{n-1} in
    Liouville representation with respect to u_h(t_s), shape
    (n-1, n_ctrl, n, d^2, d^2) float64 indexed (t, h, s, j, k).

    dt (n,), propagators (n+1, d, d), basis (d^2, d, d), eigvecs (n, d, d),
    eigvals (n, d), c_opers_transformed (n, n_ctrl, d, d) = V^dag H_h V.
    Degenerate off-diagonal eigenvalue pairs get the dt limit, as in the
    JAX package.
    """
    n, d = eigvals.shape
    omega_diff = eigvals[:, :, None] - eigvals[:, None, :]
    mask = omega_diff == 0.0
    od_safe = torch.where(mask, 1.0, omega_diff)
    dt_b = dt[:, None, None]
    # i (1 - e^{i w dt}) / w, w -> 0 limit dt
    e = util.cexp(omega_diff * dt_b)
    a_mat = torch.where(mask, dt_b.expand_as(omega_diff).to(config.COMPLEX),
                        torch.complex(e.imag / od_safe,
                                      (1.0 - e.real) / od_safe))

    pre = propagators[1:] @ propagators[:-1].mH @ eigvecs
    # U_deriv[g, h] = -i pre (A o Hbar_h) V^dag
    u_deriv = -1j * (pre[:, None] @ (a_mat[:, None] * c_opers_transformed)
                     @ eigvecs.mH[:, None])
    # Q_{s+1}^dag U_deriv[s] Q_s for s = 0 .. n-2
    ut = propagators[1:n, None].mH @ u_deriv[:n - 1] \
        @ propagators[:n - 1, None]
    # propagators_deriv[h, t, s] = theta(s <= t) Q_{t+1} UT[s]
    pd = torch.einsum('tab,shbc->htsac', propagators[1:n], ut)
    tri = torch.ones(n - 1, n - 1, dtype=torch.bool,
                     device=dt.device).tril()
    pd = pd * tri[None, :, :, None, None]
    pd = torch.cat([pd, torch.zeros_like(pd[:, :, :1])], 2)   # s = n - 1

    # 2 Re tr(pd^dag C_j Q_{t+1} C_k), one t at a time: the (d^2, d^2,
    # d, d) products C_j Q C_k of all t at once would outweigh the result
    n_b = basis.shape[0]
    out = torch.empty(n - 1, pd.shape[0], n, n_b, n_b, dtype=config.REAL,
                      device=dt.device)
    for t in range(n - 1):
        cqc = torch.einsum('jab,bc,kcd->jkad', basis, propagators[t + 1],
                           basis)
        out[t] = 2.0 * torch.einsum('hsba,jkba->hsjk', pd[:, t].conj(),
                                    cqc).real
    return out


def _step_derivative(omega, eigvals, dt, basis_transformed,
                     c_opers_transformed, n_opers_transformed, phase_factors,
                     ctrlmat_step, ratio=None) -> torch.Tensor:
    r"""Per-segment derivative kernel of segments g (leading axis)::

        M[a,h,o,k,n] = sum_m Hbar_h[k,m] Bbar_a[m,n] I[o,k,m,m,n]
                     - sum_m Bbar_a[k,m] Hbar_h[m,n] I[o,m,n,k,m]
        dB[a,j,h,o]  = i phase[o] sum_{kn} Cbar_j[n,k] M[a,h,o,k,n]
                       (+ ratio[a,h] B_step[a,j,o])

    with I the derivative integral (:func:`_derivative_integral`) and
    *ratio* (g, a, h) = (ds_a/du_h) / s_a.  Returns (g, a, j, h, o).
    """
    di = _derivative_integral(omega, eigvals, dt)      # (g, o, p, q, m, n)
    # j1[g, o, k, n, m] = I[o, k, m, m, n];
    # j2[g, o, n, k, m] = I[o, m, n, k, m]
    j1 = torch.diagonal(di, dim1=-3, dim2=-2)
    j2 = torch.diagonal(di, dim1=-4, dim2=-1)
    hb = c_opers_transformed                            # (g, h, d, d)
    nb = n_opers_transformed                            # (g, a, d, d)
    # x1[g, a, h, k, m, n] = Hbar_h[k, m] Bbar_a[m, n];
    # x2[g, a, h, k, m, n] = Bbar_a[k, m] Hbar_h[m, n]
    x1 = hb[:, None, :, :, :, None] * nb[:, :, None, None, :, :]
    m1 = torch.einsum('gahkmn,goknm->gahokn', x1, j1)
    x2 = nb[:, :, None, :, :, None] * hb[:, None, :, None, :, :]
    m2 = torch.einsum('gahkmn,gonkm->gahokn', x2, j2)
    db = torch.einsum('gjnk,gahokn->gajho', basis_transformed, m1 - m2)
    db = db * (1j * phase_factors[:, None, None, None, :])
    if ratio is not None:
        db = db + ratio[:, :, None, :, None] * ctrlmat_step[:, :, :, None, :]
    return db


def calculate_derivative_of_control_matrix_from_scratch(
        omega, propagators: torch.Tensor, eigvals: torch.Tensor,
        eigvecs: torch.Tensor, basis: Basis, t, dt, n_opers: torch.Tensor,
        n_coeffs, c_opers: torch.Tensor, n_coeffs_deriv=None,
        intermediates: Optional[Dict[str, torch.Tensor]] = None
        ) -> torch.Tensor:
    r"""Derivative of the control matrix with respect to the control
    amplitudes u_h(t_g), shape (n_ctrl, n_omega, n_dt, n_nops, d**2)
    complex128, on the device of *eigvals*.

    omega (n_w,), propagators (n_dt+1, d, d), eigvals (n_dt, d), eigvecs
    (n_dt, d, d), t (n_dt+1,), dt (n_dt,), n_opers (n_nops, d, d), n_coeffs
    (n_nops, n_dt), c_opers (n_ctrl, d, d).  *n_coeffs_deriv* (n_nops,
    n_ctrl, n_dt) adds the dependence of the noise sensitivities on the
    control amplitudes.  *intermediates* may hold the cached
    ``n_opers_transformed`` (n_nops, n_dt, d, d) and
    ``first_order_integral`` (n_dt, n_w, d, d) of the control matrix.
    """
    device = eigvals.device

    def real(x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=float)
        return torch.as_tensor(x, dtype=config.REAL, device=device)

    def cplx(x):
        return torch.as_tensor(x, dtype=config.COMPLEX, device=device)

    omega, t, dt, n_coeffs = real(omega), real(t), real(dt), real(n_coeffs)
    eigvecs, propagators = cplx(eigvecs), cplx(propagators)
    n_opers, c_opers = cplx(n_opers), cplx(c_opers)
    basis_dev = basis.tensor(device)
    intermediates = intermediates or {}

    # (g, j, d, d) V^dag C_j V and (g, h, d, d) V^dag H_h V, unpropagated
    v = eigvecs[:, None]
    basis_transformed = v.mH @ basis_dev @ v
    c_opers_transformed = v.mH @ c_opers @ v
    n_t = intermediates.get('n_opers_transformed')
    if n_t is None:
        n_t = numeric._transform_hamiltonian(eigvecs, n_opers, n_coeffs)
    integral = intermediates.get('first_order_integral')
    if integral is None:
        integral = numeric._first_order_integral_batched(omega, eigvals, dt)

    propagators_liouville = superoperator.liouville_representation(
        propagators[:-1], basis).to(config.COMPLEX)
    pl_deriv = _liouville_derivative(dt, propagators, basis_dev, eigvecs,
                                     eigvals, c_opers_transformed)
    phase_factors = util.cexp(t[:-1, None] * omega)          # (g, o)
    # single-segment control matrices, no Liouville propagator (g, a, j, o)
    ctrlmat_step = numeric._ctrlmat_step_contract(n_t, integral,
                                                  basis_transformed,
                                                  phase_factors)
    ratio = None
    if n_coeffs_deriv is not None:
        ratio = real(n_coeffs_deriv).permute(2, 0, 1) \
            / n_coeffs.T[:, :, None]                          # (g, a, h)

    n_dt, d = eigvals.shape
    n_nops, n_ctrl = len(n_t), len(c_opers)
    n_w, n_b = len(omega), len(basis_dev)
    n_t = n_t.transpose(0, 1)                                 # (g, a, d, d)
    per_segment = 16 * n_w * (_K3_TEMPS * d**4
                              + 4 * n_nops * n_ctrl * max(d * d, n_b))
    chunk = numeric._pick_chunk(n_dt, per_segment,
                                config.memory_budget(device))
    out = torch.empty(n_ctrl, n_w, n_dt, n_nops, n_b, dtype=config.COMPLEX,
                      device=device)
    for start in range(0, n_dt, chunk):
        sl = slice(start, start + chunk)
        step_deriv = _step_derivative(
            omega, eigvals[sl], dt[sl], basis_transformed[sl],
            c_opers_transformed[sl], n_t[sl], phase_factors[sl],
            ctrlmat_step[sl], None if ratio is None else ratio[sl])
        out[:, :, sl] = torch.einsum('gajho,gjk->hogak', step_deriv,
                                     propagators_liouville[sl])
    # + sum over t, s of step[t] d(QL)/du
    step = ctrlmat_step[1:]
    correction = torch.complex(
        torch.einsum('tajo,thsjk->hosak', step.real, pl_deriv),
        torch.einsum('tajo,thsjk->hosak', step.imag, pl_deriv))
    return out + correction


def calculate_filter_function_derivative(ctrlmat: torch.Tensor,
                                         ctrlmat_deriv: torch.Tensor
                                         ) -> torch.Tensor:
    r"""dF_a(w)/du_h(t_g) = 2 Re sum_k B*_{ak} dB_{ak}, from the control
    matrix (n_nops, n_b, n_w) and its derivative; returns (n_nops, n_dt,
    n_ctrl, n_omega) float64."""
    out = torch.einsum('ako,hotak->atho', ctrlmat.conj(), ctrlmat_deriv)
    return 2.0 * out.real


def infidelity_derivative(pulse, spectrum, omega, control_identifiers=None,
                          n_oper_identifiers=None,
                          n_coeffs_deriv=None) -> torch.Tensor:
    r"""dI_a/du_h(t_g) = 1/(2 pi d) int dw S(w) dF_a(w)/du_h(t_g) of a
    :class:`~.pulse_sequence.PulseSequence`, on the pulse's device;
    returns (n_nops, n_dt, n_ctrl) float64 in the order of the selected
    identifiers.  *spectrum* is (n_w,) or (n_nops, n_w); see
    :meth:`~.pulse_sequence.PulseSequence.get_filter_function_derivative`
    for the other arguments."""
    omega = torch.as_tensor(omega, dtype=config.REAL, device=pulse.device)
    spectrum = util.parse_spectrum(spectrum, omega,
                                   range(len(pulse.n_opers)),
                                   device=pulse.device)
    ff_deriv = pulse.get_filter_function_derivative(
        omega, control_identifiers, n_oper_identifiers, n_coeffs_deriv)
    integrand = spectrum.to(pulse.device)[..., None, None, :] * ff_deriv
    return util.integrate(integrand, omega) / (2 * np.pi * pulse.d)
