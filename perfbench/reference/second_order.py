"""Plain error transfer matrix of piecewise-constant pulses, to second
order in the noise, for a diagonal spectrum.

Written out from the published definitions (Cerfontaine, Hangleiter and
Bluhm, PRL 127, 170403 (2021), and its supplement; the upstream
library's ``error_transfer_matrix(second_order=True)``), pulse by pulse
and segment by segment in plain ``torch``: no separable tables, no
chunking by a memory budget, no quantized contraction.  It imports
nothing of the program under test.

With the first-order control matrices B (:mod:`reference.piecewise`),
B^(g) the part of segment g, the trapezoid weights w_o of the
frequencies and a spectrum S(w) shared by the noise operators a::

    Gamma_akl = sum_o w_o S(w_o) / 2 pi Re[B*_ak(w_o) B_al(w_o)],
    Delta_akl = sum_o w_o S(w_o) / 2 pi Re F2_akl(w_o),
    F2_akl(w) = sum_g sum_{g' < g} B^(g)*_ak(w) B^(g')_al(w)
                + sum_g sum_{ijmn} N_ak[ij] I^(g)_ijmn(w) N_al[mn],
    N_ak[ij] = Abar_a[i, j] Cbar_k[j, i],
    I^(g)_ijmn(w) = int_0^dt_g ds e^{i (Omega_ij - w) s}
                    int_0^s ds' e^{i (Omega_mn + w) s'},

F2 the a == b diagonal of the second-order filter function (the only
part a diagonal spectrum reads), Abar and Cbar segment g's noise
operators and basis elements in its eigenbasis as in
:func:`reference.piecewise.control_matrix`, Omega_ij = E_i - E_j of its
eigenvalues.  The cumulant function and the error transfer matrix are

    K_ij = -1/2 sum_a sum_kl [Gamma_akl (T_klji - T_kjli - T_kilj + T_kijl)
                              + Delta_akl (T_klji - T_lkji - T_klij
                                           + T_lkij)],
    T_ijkl = tr(C_i C_j C_k C_l),     E = exp K,

with the real part of K taken, as the upstream library does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import piecewise

#: Frequencies per block of the K2 lattice: (block, d^4) complex at once.
OMEGA_BLOCK = 100


def trapezoid_weights(omega: torch.Tensor) -> torch.Tensor:
    """w with sum_o w_o f(w_o) the trapezoid rule over *omega*."""
    step = torch.diff(omega)
    zero = torch.zeros_like(omega[:1])
    return (torch.cat([step, zero]) + torch.cat([zero, step])) / 2


def segments(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
             precision: str = 'float64'):
    """Per segment of one pulse (c_coeffs (n_ctrl, G), n_coeffs
    (n_nops, G), dt (G,)): eigenvalues E (G, d), and the noise operators
    Abar (G, n_nops, d, d) and basis elements Cbar (G, n_b, d, d) in the
    segment's eigenbasis, with the propagator up to the segment's start,
    as :func:`reference.piecewise.control_matrix` forms them."""
    real, cplx = piecewise.DTYPES[precision]
    c_opers, n_opers, basis = (x.to(cplx) for x in (c_opers, n_opers, basis))
    c_coeffs, n_coeffs, dt = (x.to(real) for x in (c_coeffs, n_coeffs, dt))
    d = c_opers.shape[-1]
    ham = torch.einsum('jmn,jg->gmn', c_opers, c_coeffs.to(cplx))
    # LAPACK on the host, as piecewise.py
    energies, vecs = (x.to(dt.device) for x in torch.linalg.eigh(ham.cpu()))
    q = torch.eye(d, dtype=cplx, device=dt.device)
    a_bar, c_bar = [], []
    for g in range(dt.shape[0]):
        v = vecs[g]
        a_bar.append(v.mH @ n_opers @ v * n_coeffs[:, g, None, None])
        u = q.mH @ v
        c_bar.append(u.mH @ basis @ u)
        q = v @ (torch.polar(torch.ones_like(energies[g]),
                             -energies[g] * dt[g])[:, None] * v.mH) @ q
    return energies, torch.stack(a_bar), torch.stack(c_bar)


def step_control_matrices(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                          omega, precision: str = 'float64') -> torch.Tensor:
    """B^(g) (G, n_nops, n_b, n_w) of one pulse: the control matrix of
    :func:`reference.piecewise.control_matrix` with the noise of segment
    g alone, which is its segment-g term (B is linear in the noise
    coefficients); their sum is B."""
    G = dt.shape[0]
    only = torch.eye(G, dtype=n_coeffs.dtype, device=n_coeffs.device)
    return piecewise.control_matrix(
        c_opers, c_coeffs.expand(G, -1, -1), n_opers,
        n_coeffs[None] * only[:, None, :], dt.expand(G, -1), basis, omega,
        precision)


def k2_lattice(energies: torch.Tensor, step: float, omega: torch.Tensor
               ) -> torch.Tensor:
    """I_ijmn(w) (n_w, d^2, d^2) of one segment (eigenvalues *energies*
    (d,), duration *step*) from its defining double integral.

    Departure from the published closed form, (f(x) - f(x + y)) / y with
    f(u) = (e^{i u dt} - 1) / u, x = Omega_ij - w, y = Omega_mn + w, and
    its limits written out where y, x or x + y is zero (the QFT pulse's
    degenerate segments make Omega_ij = 0 off the diagonal): that form
    cancels as eps / |y dt| near y = 0.  Here the inner integral is
    taken in closed form without cancellation,

        int_0^s ds' e^{i y s'} = s e^{i y s / 2} sinc(y s / 2 pi),

    whose y -> 0 limit, s, the sinc holds, and the outer integral over
    s by Gauss-Legendre quadrature.  Its integrand is e^{i x s} times
    that, an entire function of growth e^{(|x| + |y|) |Im s|}: with
    n >= 0.6 (|x| + |y|) dt + 16 nodes the quadrature's truncation lies
    below 1e-25 of dt^2 (Bernstein ellipse of parameter ~3), and what
    remains is rounding.  At x = 0 and at y = 0 the integrand stays
    finite, so those limits need no branch; perfbench/tests holds the
    result against the closed form with its limits written out.
    """
    real = omega.dtype
    cplx = torch.complex128 if real == torch.float64 else torch.complex64
    d = energies.shape[0]
    gaps = (energies[:, None] - energies[None, :]).reshape(d * d).to(real)
    x = gaps[None, :] - omega[:, None]                      # (o, ij)
    y = omega[:, None] + gaps[None, :]                      # (o, mn)
    n = int(math.ceil(0.6 * float((x.abs().max() + y.abs().max()) * step)))
    nodes, weights = np.polynomial.legendre.leggauss(n + 16)
    s = torch.as_tensor((nodes + 1) * step / 2, dtype=real,
                        device=omega.device)
    ws = torch.as_tensor(weights * step / 2, dtype=real, device=omega.device)
    xs = x[..., None] * s                                   # (o, ij, q)
    outer = torch.complex(torch.cos(xs), torch.sin(xs)) * ws
    ys = y[..., None] * s                                   # (o, mn, q)
    inner = torch.complex(torch.cos(ys / 2), torch.sin(ys / 2)) \
        * (s * torch.sinc(ys / (2 * math.pi)))
    return outer.to(cplx) @ inner.to(cplx).mT               # (o, ij, mn)


def decay_and_shifts(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                     omega, spectrum, precision: str = 'float64',
                     second_order: bool = True):
    """(Gamma, Delta), each (n_nops, n_b, n_b) real, of one pulse; Delta
    is None without *second_order*."""
    real, cplx = piecewise.DTYPES[precision]
    omega = omega.to(real)
    weight = (trapezoid_weights(omega) * spectrum.to(real)
              / (2 * math.pi)).to(cplx)                     # (o,)
    steps = step_control_matrices(c_opers, c_coeffs, n_opers, n_coeffs, dt,
                                  basis, omega, precision)  # (g, a, k, o)
    total = steps.sum(0)
    gamma = torch.einsum('ako,o,alo->akl', total.conj(), weight, total).real
    if not second_order:
        return gamma, None

    # complete steps: B^(g)* against the sum of the earlier segments'
    earlier = torch.cat([torch.zeros_like(steps[:1]),
                         steps[:-1].cumsum(0)])
    delta = torch.einsum('gako,o,galo->akl', steps.conj(), weight, earlier)

    # incomplete steps: each segment's lattice, weighted and summed over
    # the frequencies block by block, between the segment's N_ak
    energies, a_bar, c_bar = segments(c_opers, c_coeffs, n_opers, n_coeffs,
                                      dt, basis, precision)
    d = energies.shape[-1]
    for g in range(dt.shape[0]):
        nk = torch.einsum('aij,kji->akij', a_bar[g], c_bar[g]).reshape(
            a_bar.shape[1], c_bar.shape[1], d * d)          # (a, k, ij)
        lattice = torch.zeros(d * d, d * d, dtype=cplx, device=omega.device)
        for lo in range(0, omega.shape[0], OMEGA_BLOCK):
            block = slice(lo, lo + OMEGA_BLOCK)
            lattice_o = k2_lattice(energies[g], float(dt[g]), omega[block])
            lattice = lattice + torch.einsum('o,oxy->xy', weight[block],
                                             lattice_o)
        delta = delta + nk @ lattice @ nk.mT
    return gamma, delta.real


def _traces(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """P[i, j] = tr(x C_j C_i) of a (d, d) matrix x."""
    return torch.einsum('pq,jqr,irp->ij', x, basis, basis)


def cumulant(gamma: torch.Tensor, delta, basis: torch.Tensor
             ) -> torch.Tensor:
    """K (n_b, n_b) of Gamma and Delta (n_nops, n_b, n_b) summed over
    the noise operators.

    Departure from the published form: K is linear in Gamma and Delta,
    so they are summed over the noise operators first, and the four
    traces T are contracted through the basis, without the n^4 trace
    tensor (34 GB at n = 256): with G = sum_a Gamma_a,
    X = sum_kl G_kl C_k C_l, X' = sum_kl G_kl C_l C_k and
    Y_j = sum_kl G_kl C_k C_j C_l,

        sum_kl G_kl T_klji = tr(X C_j C_i),   T_kijl = tr(X' C_i C_j),
        sum_kl G_kl T_kjli = tr(Y_j C_i),     T_kilj = tr(Y_i C_j),

    and likewise for Delta's T_lkji = tr(X' C_j C_i), T_klij =
    tr(X C_i C_j), T_lkij = tr(X' C_i C_j)."""
    cplx = basis.dtype
    coeff = gamma.sum(0).to(cplx)
    x = torch.einsum('kl,kpq,lqr->pr', coeff, basis, basis)
    x_swap = torch.einsum('kl,lpq,kqr->pr', coeff, basis, basis)
    right = torch.einsum('kl,lrs->krs', coeff, basis)
    y = torch.einsum('kpq,jqr,krs->jps', basis, basis, right)
    y_traces = torch.einsum('jps,isp->ij', y, basis)
    k = (_traces(x, basis) - y_traces - y_traces.mT
         + _traces(x_swap, basis).mT)
    if delta is not None:
        coeff = delta.sum(0).to(cplx)
        x = _traces(torch.einsum('kl,kpq,lqr->pr', coeff, basis, basis),
                    basis)
        x_swap = _traces(torch.einsum('kl,lpq,kqr->pr', coeff, basis, basis),
                         basis)
        k = k + x - x_swap - x.mT + x_swap.mT
    return -0.5 * k.real


def expm(k: torch.Tensor, terms: int = 30) -> torch.Tensor:
    """exp K of a real matrix: its Taylor series, after halving K until
    its 1-norm is at most 1/2, then squared back.  With 30 terms the
    truncation is below 2^-30 / 30! ~ 4e-42 of the norm: the error is
    the rounding of the matrix products, ~eps (torch.linalg.matrix_exp
    is off by up to 1.4e-13 on K of 1-norm ~0.01)."""
    norm = float(k.abs().sum(0).max())
    squarings = max(0, math.ceil(math.log2(norm)) + 1) if norm > 0 else 0
    a = k / 2.0 ** squarings
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    term, out = eye, eye.clone()
    for n in range(1, terms + 1):
        term = term @ a / n
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out


def error_transfer_matrices(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                            omega, spectrum, precision: str = 'float64',
                            second_order: bool = True) -> torch.Tensor:
    """Error transfer matrices (b, n_b, n_b) of a batch of pulses
    (c_coeffs (b, n_ctrl, G), n_coeffs (b, n_nops, G), dt (b, G); shared
    operators, basis, frequencies and spectrum (n_w,)), one pulse at a
    time; without *second_order*, the first-order ones (Delta = 0)."""
    _, cplx = piecewise.DTYPES[precision]
    out = []
    for b in range(c_coeffs.shape[0]):
        gamma, delta = decay_and_shifts(
            c_opers, c_coeffs[b], n_opers, n_coeffs[b], dt[b], basis, omega,
            spectrum, precision, second_order)
        out.append(expm(cumulant(gamma, delta, basis.to(cplx))))
    return torch.stack(out)
