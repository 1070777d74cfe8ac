"""Single-qubit randomized benchmarking pulses.

The 24-element single-qubit Clifford group is generated by breadth-
first closure over pi/2 rotations about X and Y, so every Clifford
comes with a shortest decomposition into primitive pulses (at most 3
generators).  Sequences of random Cliffords plus the recovery gate are
composed with :func:`~..sequencing.concatenate`, reusing each
Clifford's cached control matrix (24 Cliffords x sequence lengths x
samples at a few hundred frequencies), or evaluated many at a time by
:func:`batched_rb_infidelities`.  The constructors take the *device* of the
pulses (:data:`~..config.DEFAULT_DEVICE` unless given).
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, functional, numeric, util
from ..basis import Basis
from ..pulse_sequence import PulseSequence
from ..sequencing import concatenate
from ..superoperator import liouville_representation
from ..types import Device

__all__ = ['clifford_group', 'clifford_pulses', 'sample_sequence',
           'rb_pulse', 'clifford_control_arrays', 'batched_rb_infidelities']

_I, _X, _Y, _Z = util.paulis


def _rot(axis: np.ndarray, angle: float) -> np.ndarray:
    return (np.cos(angle / 2) * _I - 1j * np.sin(angle / 2) * axis)


def _phase_equal(u: np.ndarray, v: np.ndarray) -> bool:
    """True if u == v up to a global phase: |tr(u^dag v)| == d."""
    return abs(abs(np.trace(u.conj().T @ v)) - u.shape[0]) < 1e-9


def _find(group: list, v: np.ndarray) -> int:
    for i, (u, _) in enumerate(group):
        if _phase_equal(u, v):
            return i
    return -1


@functools.lru_cache(maxsize=None)
def clifford_group() -> Tuple[Tuple[np.ndarray, Tuple[str, ...]], ...]:
    """The 24 single-qubit Cliffords with shortest decompositions into
    the generators {X90, Y90, X-90, Y-90} (BFS closure)."""
    gens = {
        'X90': _rot(_X, np.pi / 2),
        'Y90': _rot(_Y, np.pi / 2),
        'X-90': _rot(_X, -np.pi / 2),
        'Y-90': _rot(_Y, -np.pi / 2),
    }
    group = [(_I.astype(complex), ())]
    frontier = list(group)
    while frontier:
        new_frontier = []
        for u, word in frontier:
            for name, g in gens.items():
                v = g @ u
                if _find(group, v) < 0:
                    entry = (v, word + (name,))
                    group.append(entry)
                    new_frontier.append(entry)
        frontier = new_frontier
    assert len(group) == 24, f'Clifford closure gave {len(group)} elements'
    return tuple(group)


def clifford_pulses(tau: float = 1.0, basis: Optional[Basis] = None,
                    omega: Optional[np.ndarray] = None,
                    device: Device = config.DEFAULT_DEVICE
                    ) -> List[PulseSequence]:
    """The 24 Cliffords as PulseSequences (with Z dephasing noise),
    each of equal duration; optionally pre-cache filter functions."""
    pulses = []
    for u, word in clifford_group():
        if not word:
            # identity: idle segment
            H_c = [[_X / 2, [0.0], 'X'], [_Y / 2, [0.0], 'Y']]
            H_n = [[_Z / 2, [1.0], 'Z']]
            pulse = PulseSequence(H_c, H_n, [tau], basis=basis,
                                  device=device)
        else:
            seg_tau = tau / len(word)
            x_coeffs, y_coeffs = [], []
            for name in word:
                angle = np.pi / 2 * (1 if '-' not in name else -1)
                if name.startswith('X'):
                    x_coeffs.append(angle / seg_tau)
                    y_coeffs.append(0.0)
                else:
                    x_coeffs.append(0.0)
                    y_coeffs.append(angle / seg_tau)
            H_c = [[_X / 2, x_coeffs, 'X'], [_Y / 2, y_coeffs, 'Y']]
            H_n = [[_Z / 2, np.ones(len(word)), 'Z']]
            pulse = PulseSequence(H_c, H_n, [seg_tau] * len(word),
                                  basis=basis, device=device)
        if omega is not None:
            pulse.cache_filter_function(omega)
        pulses.append(pulse)
    return pulses


def sample_sequence(length: int, rng: np.random.Generator
                    ) -> Tuple[List[int], int]:
    """Random Clifford indices plus the recovery index undoing their
    product (so the ideal sequence implements the identity)."""
    group = list(clifford_group())
    indices = [int(i) for i in rng.integers(0, 24, length)]
    total = _I.astype(complex)
    for i in indices:
        total = group[i][0] @ total
    recovery = _find(group, total.conj().T)
    assert recovery >= 0
    return indices, recovery


def rb_pulse(indices: Sequence[int], recovery: int,
             pulses: Sequence[PulseSequence],
             calc_filter_function: Optional[bool] = None) -> PulseSequence:
    """Concatenate the sampled Clifford sequence plus recovery gate."""
    seq = [pulses[i] for i in indices] + [pulses[recovery]]
    return concatenate(seq, calc_filter_function=calc_filter_function)


# -----------------------------------------------------------------------------
# Batched randomized benchmarking
# -----------------------------------------------------------------------------
def clifford_control_arrays(tau: float = 1.0):
    """Control coefficient and duration arrays of all 24 Cliffords,
    zero-padded to a common segment count (segments of zero duration
    contribute nothing to the pipeline).

    Returns (c_coeffs (24, 2, G), n_coeffs (24, 1, G), dt (24, G)).
    """
    words = [word for _, word in clifford_group()]
    g_max = max(1, max(len(w) for w in words))
    c_coeffs = np.zeros((24, 2, g_max))
    dt = np.zeros((24, g_max))
    for i, word in enumerate(words):
        if not word:                       # identity: one idle segment
            dt[i, 0] = tau
            continue
        seg_tau = tau / len(word)
        for g, name in enumerate(word):
            angle = np.pi / 2 * (1 if '-' not in name else -1)
            row = 0 if name.startswith('X') else 1
            c_coeffs[i, row, g] = angle / seg_tau
            dt[i, g] = seg_tau
    n_coeffs = np.ones((24, 1, g_max))
    return c_coeffs, n_coeffs, dt


@functools.lru_cache(maxsize=8)
def _atomic_clifford_data(tau: float, omega_key: bytes, device: torch.device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 24 atomic control matrices (24, 1, 4, n_w) and total transfer
    matrices (24, 4, 4, real) in the Pauli basis, on *device*.  They are
    constants of (tau, omega, device), so they are computed once per
    grid, as one batch through :func:`..functional.control_matrix`, and
    kept."""
    basis = Basis.pauli(1)
    omega = torch.tensor(np.frombuffer(omega_key).copy(), device=device)
    c_coeffs, n_coeffs, dt = (torch.as_tensor(x, device=device)
                              for x in clifford_control_arrays(tau))
    p = functional.PulseArrays(
        torch.as_tensor(np.stack([_X, _Y]) / 2, device=device), c_coeffs,
        torch.as_tensor((_Z / 2)[None], device=device), n_coeffs, dt,
        basis.tensor(device))
    ctrl = functional.control_matrix(p, omega)
    ham = torch.einsum('jmn,bjg->bgmn', p.c_opers,
                       c_coeffs.to(config.COMPLEX))
    _, _, propagators = numeric.diagonalize(ham, dt)
    return ctrl, liouville_representation(propagators[:, -1], basis)


def batched_rb_infidelities(indices, omega, spectrum, tau: float = 1.0,
                            device: Device = config.DEFAULT_DEVICE
                            ) -> torch.Tensor:
    """Dephasing infidelities (n_seq,) of many Clifford sequences in one
    batched evaluation on *device*, in place of one ``concatenate`` per
    sequence.

    indices: (n_seq, n_cliffords) Clifford indices (append the recovery
    index of :func:`sample_sequence` yourself); omega (n_w,); spectrum
    broadcastable to (n_w,).

    The 24 atomic control matrices and total transfer matrices are
    cached per (tau, omega, device).  Per sequence the cumulative
    transfer matrices are an accumulated product, and the sum
    B = sum_g e^{i w t_{g-1}} B^(g) Q^(g-1) over its Cliffords is one
    float64 matrix product with the joint (position, basis element)
    axis contracted: the transfer matrices of unitaries in a Hermitian
    basis are real.
    """
    device = config.resolve_device(device)
    omega_host = np.ascontiguousarray(util._host(omega), dtype=float)
    ctrl, liou = _atomic_clifford_data(float(tau), omega_host.tobytes(),
                                       device)
    indices = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=device)
    omega = torch.as_tensor(omega_host, device=device)
    spectrum = torch.as_tensor(spectrum, dtype=config.REAL, device=device)

    n_seq, n_cliff = indices.shape
    q_cum = util.adot(liou[indices[:, :-1]], axis=1)   # (S, L-1, d2, d2)
    # equal pulse durations: boundary phases e^{i w g tau}
    steps = torch.arange(1, n_cliff, dtype=config.REAL, device=device)
    phases = util.cexp(steps[:, None] * tau * omega)        # (L-1, n_w)
    b_seq = ctrl[indices]                        # (S, L, n_nops, d2, n_w)
    n_nops, d2, n_w = b_seq.shape[2:]
    # X[s, j, (g k), o] and Q[s, (g k), l]
    x = (b_seq[:, 1:] * phases[:, None, None, :]).transpose(1, 2).reshape(
        n_seq, n_nops, (n_cliff - 1) * d2, n_w)
    q = q_cum.reshape(n_seq, 1, (n_cliff - 1) * d2, d2)
    b_total = b_seq[:, 0] + numeric._apply_transfer(q, x)   # (S, j, l, o)
    ff_diag = util.abs2(b_total).sum(-2)
    infid = util.integrate(ff_diag * spectrum, omega) / (2 * math.pi * 2)
    return infid[:, 0]
