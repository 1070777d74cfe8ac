"""Exchange-coupled spin-qubit model family.

A chain of N spins with nearest-neighbour Heisenberg exchange
J_i(t) = e^{eps_i(t)} and a magnetic-field gradient, reduced to its
computational subspace: the system of the published optimized 4-spin
CNOT pulse (``CNOT.mat``), and the Dial et al. 1/f^alpha charge-noise
spectrum it is evaluated under.  The operators are host numpy arrays;
:func:`cnot_pulse` builds its pulse on *device*
(:data:`~..config.DEFAULT_DEVICE` unless given).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import config
from ..basis import Basis
from ..pulse_sequence import PulseSequence
from ..types import Device
from ..util import paulis, tensor

__all__ = ['heisenberg_operators', 'dial_spectrum', 'cnot_pulse',
           'qubit_subspace_basis', 'CNOT_SUBSPACE']

#: Indices of the S_z = 0 6-dimensional subspace of 4 spins hosting the
#: two singlet-triplet qubits (computational levels of the CNOT).
CNOT_SUBSPACE = (3, 5, 6, 9, 10, 12)

#: Where :func:`cnot_pulse` looks for the published pulse by default: the
#: repository's ``examples/data/CNOT.mat``.
CNOT_DATA = Path(__file__).resolve().parents[2] / 'examples' / 'data' \
    / 'CNOT.mat'


def _kron_chain(ops: Sequence[np.ndarray]) -> np.ndarray:
    return np.asarray(tensor(*ops))


def heisenberg_operators(n_spins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Operators of the exchange-coupled spin chain.

    Returns ``(exchange, gradient)``:

    * ``exchange[i]`` = (1/4) vec(S_i) . vec(S_{i+1}), the
      nearest-neighbour Heisenberg coupling controlled by J_i(t),
      shape (n_spins - 1, 2^n, 2^n);
    * ``gradient[i]`` the magnetic-field-gradient operator of bond i,
      the field difference across it, shape (n_spins - 1, 2^n, 2^n).
    """
    Id, X, Y, Z = paulis
    exchange = []
    for i in range(n_spins - 1):
        term = sum(
            _kron_chain([P if k in (i, i + 1) else Id
                         for k in range(n_spins)])
            for P in (X, Y, Z))
        exchange.append(term.real / 4)
    gradient = []
    for i in range(n_spins - 1):
        coeffs = np.zeros(n_spins)
        coeffs[:i + 1] = -(n_spins - 1 - i)
        coeffs[i + 1:] = i + 1
        term = sum(c * _kron_chain([Z if k == j else Id
                                    for k in range(n_spins)])
                   for j, c in enumerate(coeffs))
        gradient.append(term.real / (2 * n_spins))
    return np.array(exchange), np.array(gradient)


def dial_spectrum(omega, alpha: float = 0.7,
                  s0: float = 4e-11 / 2.7241e-4**2) -> np.ndarray:
    """Dial et al. 1/f^alpha charge-noise PSD (PRL 110, 146804 (2013)),
    in the units of the CNOT example: S(omega) = A / omega^alpha with
    A = s0 (2 pi x 1e-3)^alpha."""
    amp = s0 * (2 * np.pi * 1e-3)**alpha
    return amp / np.asarray(omega)**alpha


def cnot_pulse(data_path: Optional[str] = None,
               device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """The optimized exchange-coupled 4-spin CNOT pulse on its 6-level
    subspace, built from a MATLAB file with the published optimization
    result's fields: ``eps`` (3, n_dt), ``t`` (n_dt,) and ``B`` (3,)
    (read with scipy; :data:`CNOT_DATA` by default).

    The noise operators are the exchange couplings themselves
    (multiplicative charge noise dJ/deps = J) plus the additive field
    gradients.  The pulse lives on *device*.
    """
    from scipy import io
    if data_path is None:
        data_path = CNOT_DATA
    if not Path(data_path).exists():
        raise FileNotFoundError(
            f'CNOT pulse data not found at {data_path}; pass data_path=')
    struct = io.loadmat(str(data_path))
    eps = np.asarray(struct['eps'], order='C')
    dt = np.asarray(struct['t'].ravel(), order='C')
    b_field = np.asarray(struct['B'].ravel(), order='C')
    j_exch = np.exp(eps)
    n_dt = len(dt)

    exchange, _ = heisenberg_operators(4)
    Id, Z = paulis[0], paulis[3]
    # the four single-spin Z terms; the three independent gradient
    # channels of the CNOT parameterization
    z_ops = [_kron_chain([Z if k == j else Id for k in range(4)]).real
             for j in range(4)]
    grads = [(-3 * z_ops[0] + z_ops[1] + z_ops[2] + z_ops[3]) / 8,
             (-z_ops[0] - z_ops[1] + z_ops[2] + z_ops[3]) / 4,
             (-z_ops[0] - z_ops[1] - z_ops[2] + 3 * z_ops[3]) / 8]

    idx = np.ix_(CNOT_SUBSPACE, CNOT_SUBSPACE)
    d_sub = len(CNOT_SUBSPACE)

    def project(op):
        sub = op[idx]
        return sub - np.trace(sub) / d_sub * np.eye(d_sub)

    opers = [project(op) for op in (*exchange, *grads)]
    c_coeffs = [j_exch[0], j_exch[1], j_exch[2],
                b_field[0] * np.ones(n_dt), b_field[1] * np.ones(n_dt),
                b_field[2] * np.ones(n_dt)]
    n_coeffs = [j_exch[0], j_exch[1], j_exch[2],
                np.ones(n_dt), np.ones(n_dt), np.ones(n_dt)]
    identifiers = ['eps_12', 'eps_23', 'eps_34', 'b_12', 'b_23', 'b_34']

    return PulseSequence(
        list(zip(opers, c_coeffs, identifiers)),
        list(zip(opers, n_coeffs, identifiers)),
        dt, basis=Basis.ggm(d_sub), device=device)


def qubit_subspace_basis() -> Basis:
    """The two-qubit Pauli basis padded into the 6-level space: the
    basis in which the published CNOT infidelities are evaluated (the
    two extra levels are leakage states outside the computational
    subspace).  Use with ``pulse.d = 4`` to normalize infidelities to
    the computational subspace.

    btype is 'Custom': the padded set is neither complete nor a 4^n
    Pauli basis of dimension 2^n, so the Pauli index machinery
    (``pauli_mult_table``, the separability of ``extend`` / ``remap``)
    must not dispatch on it."""
    return Basis([np.pad(b, 1, 'constant')
                  for b in Basis.pauli(2)[1:]], btype='Custom')
