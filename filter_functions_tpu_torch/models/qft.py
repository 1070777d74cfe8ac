"""Quantum Fourier transform with Ising-type Hamiltonians: the
simplified QFT of Ivanov, Johanning & Wunderlich, arXiv:1503.08806,
built from plain Pauli tensor products and composed in time with
:func:`~..sequencing.concatenate`.

The 4-qubit instance (d = 16, 13 segments, 18 control and 18 noise
operators, 256-element GGM basis) at 1000 frequencies is the flagship
workload; :func:`qft_pulse_arrays` and :func:`qft_pulse_sequence` give
it as :class:`~..functional.PulseArrays` or as a
:class:`~..pulse_sequence.PulseSequence` with generic operator names.
Every constructor takes the *device* of the pulse
(:data:`~..config.DEFAULT_DEVICE` unless given).
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from .. import config, util
from ..basis import Basis
from ..convert import pulse_arrays_from_numpy
from ..functional import PulseArrays
from ..pulse_sequence import PulseSequence
from ..sequencing import concatenate
from ..types import Device

__all__ = ['qft_pulse', 'r_k_pulse', 'h_k_pulse',
           't_i_pulse', 't_f_pulse', 'p_n_pulse', 'qft_propagator',
           'swap_all', 'qft_pulse_arrays', 'qft_pulse_sequence']

_I, _X, _Y, _Z = util.paulis


def _embed(op: np.ndarray, k: int, n_qubits: int) -> np.ndarray:
    """op acting on qubit k of n."""
    factors = [_I] * n_qubits
    factors[k] = op
    return util.tensor(*factors) if n_qubits > 1 else op


def _pauli_string_label(op_char: str, k: int, n_qubits: int) -> str:
    return 'I' * k + op_char + 'I' * (n_qubits - k - 1)


def r_k_pulse(k: int, theta: float, phi: float, n_qubits: int = 4,
              tau: float = 1.0,
              basis: Optional[Basis] = None,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """Single-qubit rotation R_k(theta, phi) on qubit k, with X and Y
    noise on that qubit."""
    x = _embed(_X, k, n_qubits)
    y = _embed(_Y, k, n_qubits)
    d = x.shape[0]
    H_c = [[x, [theta / 2 / tau * np.cos(phi)],
            _pauli_string_label('X', k, n_qubits)],
           [y, [theta / 2 / tau * np.sin(phi)],
            _pauli_string_label('Y', k, n_qubits)]]
    H_n = [[x / np.sqrt(d), [1.0], _pauli_string_label('X', k, n_qubits)],
           [y / np.sqrt(d), [1.0], _pauli_string_label('Y', k, n_qubits)]]
    return PulseSequence(H_c, H_n, [tau], basis=basis, device=device)


def _cyclic_z_chain(k: int, n_qubits: int) -> np.ndarray:
    """Z acting on qubit k-1 (the T-pulse terms are single-qubit Z's)."""
    return _embed(_Z, k - 1, n_qubits)


def t_i_pulse(n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """Initial phase gate T_I."""
    if n_qubits == 1:
        H_c = [[_I, [0.0], 'I']]
        H_n = [[_I / np.sqrt(2), [1.0], 'I']]
        return PulseSequence(H_c, H_n, [tau], basis=basis, device=device)
    H_c, H_n = [], []
    for k in range(1, n_qubits + 1):
        z = _cyclic_z_chain(k, n_qubits)
        label = 'I' * (k - 1) + 'Z' + 'I' * (n_qubits - k)
        H_c.append([z, [np.pi / 4 * (1 - 2**(1 - k)) / tau], label])
        H_n.append([z / np.sqrt(z.shape[0]), [1.0], label])
    return PulseSequence(H_c, H_n, [tau], basis=basis, device=device)


def t_f_pulse(n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """Final phase gate T_F."""
    if n_qubits == 1:
        H_c = [[_I, [0.0], 'I']]
        H_n = [[_I / np.sqrt(2), [1.0], 'I']]
        return PulseSequence(H_c, H_n, [tau], basis=basis, device=device)
    H_c, H_n = [], []
    for k in range(1, n_qubits + 1):
        z = _cyclic_z_chain(k, n_qubits)
        label = 'I' * (k - 1) + 'Z' + 'I' * (n_qubits - k)
        H_c.append([z, [np.pi / 4 * (1 - 2**(k - n_qubits)) / tau], label])
        H_n.append([z / np.sqrt(z.shape[0]), [1.0], label])
    return PulseSequence(H_c, H_n, [tau], basis=basis, device=device)


def p_n_pulse(n: int, n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """Pairwise conditional-phase gate P_n."""
    H_c, H_n = [], []
    for m in range(n + 1, n_qubits + 1):
        factors = [_I] * n_qubits
        factors[n - 1] = _Z
        factors[m - 1] = _Z
        zz = util.tensor(*factors)
        label = ('I' * (n - 1) + 'Z' + 'I' * (m - n - 1) + 'Z'
                 + 'I' * (n_qubits - m))
        H_c.append([zz, [-np.pi / 4 * 2**(n - m) / tau], label])
        H_n.append([zz / np.sqrt(zz.shape[0]), [1.0], label])
    return PulseSequence(H_c, H_n, [tau], basis=basis, device=device)


def h_k_pulse(k: int, n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """Hadamard on qubit k as R(pi, 0) then R(pi/2, -pi/2)."""
    return concatenate([r_k_pulse(k, np.pi, 0, n_qubits, tau, basis, device),
                        r_k_pulse(k, np.pi / 2, -np.pi / 2, n_qubits, tau,
                                  basis, device)])


def _qft_atomic_pulses(n_qubits: int = 4, tau: float = 1.0,
                       basis: Optional[Basis] = None,
                       device: Device = config.DEFAULT_DEVICE
                       ) -> List[PulseSequence]:
    """The 2 n_qubits + 1 gates that :func:`qft_pulse` concatenates, in
    order: T_I, a Hadamard and the conditional phases per qubit, T_F."""
    pulses = [t_i_pulse(n_qubits, tau, basis, device)]
    for n in range(n_qubits - 1):
        pulses.append(h_k_pulse(n, n_qubits, tau, basis, device))
        pulses.append(p_n_pulse(n + 1, n_qubits, tau, basis, device))
    pulses.append(h_k_pulse(n_qubits - 1, n_qubits, tau, basis, device))
    pulses.append(t_f_pulse(n_qubits, tau, basis, device))
    return pulses


def qft_pulse(n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """The full QFT pulse sequence: T_I, then for each qubit a Hadamard
    followed by conditional phases, and a final T_F
    (:func:`_qft_atomic_pulses`).  Total 3 n_qubits + 1 segments."""
    return concatenate(_qft_atomic_pulses(n_qubits, tau, basis, device))


def qft_propagator(n_qubits: int) -> np.ndarray:
    """The ideal QFT unitary (bit-reversed output order), for
    verification: F_{jk} = exp(2 pi i j k / d) / sqrt(d)."""
    d = 2**n_qubits
    j, k = np.meshgrid(np.arange(d), np.arange(d), indexing='ij')
    return np.exp(2j * np.pi * j * k / d) / np.sqrt(d)


def swap_all(n_qubits: int) -> np.ndarray:
    """Unitary reversing the qubit order (QFT output bit reversal)."""
    d = 2**n_qubits
    perm = np.zeros(d, dtype=int)
    for i in range(d):
        bits = format(i, f'0{n_qubits}b')
        perm[i] = int(bits[::-1], 2)
    u = np.zeros((d, d))
    u[perm, np.arange(d)] = 1.0
    return u


@functools.lru_cache(maxsize=None)
def _load(n_qubits: int) -> dict:
    """The host arrays of the n-qubit QFT pulse, built by
    :func:`qft_pulse` on the CPU (no filter function is computed): the
    operators in the order of their Pauli-string identifiers, and the
    default GGM basis."""
    pulse = qft_pulse(n_qubits, device='cpu')
    return dict(c_opers=pulse.c_opers, c_coeffs=pulse.c_coeffs,
                n_opers=pulse.n_opers, n_coeffs=pulse.n_coeffs, dt=pulse.dt,
                basis=pulse.basis.np)


def _arrays(n_qubits: int) -> dict:
    """A copy of :func:`_load`'s arrays: ``from_arrays`` and a CPU tensor
    keep the memory they are given, so a pulse that shared the cache's
    would pass an in-place edit on to every later one."""
    return {name: arr.copy() for name, arr in _load(n_qubits).items()}


def qft_pulse_arrays(n_qubits: int = 4,
                     device: Device = config.DEFAULT_DEVICE) -> PulseArrays:
    """:class:`~..functional.PulseArrays` of the n-qubit QFT pulse on
    *device*."""
    return pulse_arrays_from_numpy(_arrays(n_qubits), device=device)


def qft_pulse_sequence(n_qubits: int = 4,
                       device: Device = config.DEFAULT_DEVICE
                       ) -> PulseSequence:
    """The n-qubit QFT pulse as a :class:`~..pulse_sequence.
    PulseSequence` on *device*, built with ``from_arrays`` from the
    arrays of :func:`qft_pulse` and the default GGM basis, with generic
    operator names in the arrays' order: ``A_00``, ``A_01``, ... for the
    control operators, ``B_00``, ... for the noise operators."""
    z = _arrays(n_qubits)
    return PulseSequence.from_arrays(
        z['c_opers'], [f'A_{i:02d}' for i in range(len(z['c_opers']))],
        z['c_coeffs'],
        z['n_opers'], [f'B_{i:02d}' for i in range(len(z['n_opers']))],
        z['n_coeffs'], z['dt'], device=device)
