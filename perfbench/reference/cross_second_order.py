"""Plain error transfer matrix of piecewise-constant pulses, to second
order in the noise, for a cross-spectrum S_ab(w) of the noise operators.

The definitions of :mod:`reference.second_order` taken pair by pair, as
the upstream library's ``calculate_decay_amplitudes`` and
``calculate_frequency_shifts`` take a spectrum of shape (n, n, n_w)
(Cerfontaine, Hangleiter and Bluhm, PRL 127, 170403 (2021)), pulse by
pulse and segment by segment in plain ``torch``.  With the trapezoid
weights w_o, the first-order control matrices B and B^(g) the part of
segment g::

    Gamma_kl = sum_ab sum_o w_o / 2 pi Re[S_ab(w_o) B*_ak(w_o) B_bl(w_o)],
    Delta_kl = sum_ab sum_o w_o / 2 pi Re[S_ab(w_o) F2_abkl(w_o)],
    F2_abkl(w) = sum_g sum_{g' < g} B^(g)*_ak(w) B^(g')_bl(w)
                 + sum_g sum_{ijmn} N_ak[ij] I^(g)_ijmn(w) N_bl[mn],

N and the K2 lattice I as in :mod:`reference.second_order`, the real
parts where the upstream integrands take them (each pair's, which sum
to the real part of the sum).  Every pair whose spectrum is not zero
is worked out on its own: its weighted lattice W_ab = sum_o w_o
S_ab(w_o) / 2 pi I(w_o), in blocks of frequencies, and its sandwich
N_a W_ab N_b^T.  No factorization of S and no mixing of the noise
operators: nothing here follows the program's route.  The cumulant
function sums Gamma and Delta over the pairs, as the upstream one
sums its (a, b) axes, and the error transfer matrix is its exponential
(:func:`reference.second_order.cumulant`, :func:`~.expm`).  It imports
nothing of the program under test.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import piecewise
from perfbench.reference import second_order as plain


def pairs(spectrum: torch.Tensor):
    """The pairs (a, b) of noise operators whose spectrum S_ab is not
    zero at some frequency, read on the host."""
    nonzero = (spectrum != 0).any(-1).cpu()
    return [(a, b) for a in range(nonzero.shape[0])
            for b in range(nonzero.shape[1]) if bool(nonzero[a, b])]


def decay_and_shifts(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                     omega, spectrum, precision: str = 'float64',
                     second_order: bool = True):
    """(Gamma, Delta), each (n_b, n_b) real and summed over the pairs, of
    one pulse for the cross-spectrum *spectrum* (n, n, n_w); Delta is
    None without *second_order*."""
    real, cplx = piecewise.DTYPES[precision]
    omega = omega.to(real)
    found = pairs(spectrum)
    weights = torch.stack([
        (plain.trapezoid_weights(omega) / (2 * math.pi)).to(cplx)
        * spectrum[a, b].to(cplx) for a, b in found])       # (p, o)
    steps = plain.step_control_matrices(
        c_opers, c_coeffs, n_opers, n_coeffs, dt, basis, omega,
        precision)                                          # (g, a, k, o)
    total = steps.sum(0)
    gamma = sum(torch.einsum('ko,o,lo->kl', total[a].conj(), w, total[b])
                .real for (a, b), w in zip(found, weights))
    if not second_order:
        return gamma, None

    # complete steps: B^(g)*_a against the sum of the earlier segments'
    # B_b, pair by pair
    earlier = torch.cat([torch.zeros_like(steps[:1]),
                         steps[:-1].cumsum(0)])
    delta = sum(torch.einsum('gko,o,glo->kl', steps[:, a].conj(), w,
                             earlier[:, b])
                for (a, b), w in zip(found, weights))

    # incomplete steps: each segment's lattice, weighted by each pair's
    # spectrum and summed over the frequencies block by block, between
    # that pair's N_a and N_b
    energies, a_bar, c_bar = plain.segments(
        c_opers, c_coeffs, n_opers, n_coeffs, dt, basis, precision)
    d = energies.shape[-1]
    for g in range(dt.shape[0]):
        nk = torch.einsum('aij,kji->akij', a_bar[g], c_bar[g]).reshape(
            a_bar.shape[1], c_bar.shape[1], d * d)          # (a, k, ij)
        lattices = torch.zeros(len(found), d * d, d * d, dtype=cplx,
                               device=omega.device)
        for lo in range(0, omega.shape[0], plain.OMEGA_BLOCK):
            block = slice(lo, lo + plain.OMEGA_BLOCK)
            lattice_o = plain.k2_lattice(energies[g], float(dt[g]),
                                         omega[block])
            lattices = lattices + torch.einsum(
                'po,oxy->pxy', weights[:, block], lattice_o)
        for (a, b), lattice in zip(found, lattices):
            delta = delta + nk[a] @ lattice @ nk[b].mT
    return gamma, delta.real


def error_transfer_matrices(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                            omega, spectrum, precision: str = 'float64',
                            second_order: bool = True) -> torch.Tensor:
    """Error transfer matrices (b, n_b, n_b) of a batch of pulses
    (c_coeffs (b, n_ctrl, G), n_coeffs (b, n_nops, G), dt (b, G); shared
    operators, basis, frequencies and cross-spectrum (n_nops, n_nops,
    n_w)), one pulse at a time; without *second_order*, the first-order
    ones (Delta = 0)."""
    _, cplx = piecewise.DTYPES[precision]
    out = []
    for b in range(c_coeffs.shape[0]):
        gamma, delta = decay_and_shifts(
            c_opers, c_coeffs[b], n_opers, n_coeffs[b], dt[b], basis, omega,
            spectrum, precision, second_order)
        out.append(plain.expm(plain.cumulant(
            gamma[None], None if delta is None else delta[None],
            basis.to(cplx))))
    return torch.stack(out)
