"""The 4-qubit quantum Fourier transform pulse (d = 16, 13 segments,
18 control and 18 noise operators, 256-element GGM basis): the flagship
workload, as :class:`~..functional.PulseArrays` or as a
:class:`~..pulse_sequence.PulseSequence`.

The arrays are the ones the JAX package ships precomputed in
``filter_functions_tpu/models/qft4_arrays.npz``; they are read with
numpy, so this module needs no JAX.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import config
from ..convert import pulse_arrays_from_numpy
from ..functional import PulseArrays
from ..pulse_sequence import PulseSequence
from ..types import Device

_ARRAYS_DIR = (Path(__file__).resolve().parents[2] / 'filter_functions_tpu'
               / 'models')


def _load(n_qubits: int) -> dict:
    path = _ARRAYS_DIR / f'qft{n_qubits}_arrays.npz'
    if not path.exists():
        raise FileNotFoundError(f'no precomputed QFT arrays for '
                                f'{n_qubits} qubits at {path}')
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def qft_pulse_arrays(n_qubits: int = 4,
                     device: Device = config.DEFAULT_DEVICE) -> PulseArrays:
    """:class:`~..functional.PulseArrays` of the n-qubit QFT pulse on
    *device*.  Only the precomputed 4-qubit instance exists."""
    return pulse_arrays_from_numpy(_load(n_qubits), device=device)


def qft_pulse_sequence(n_qubits: int = 4,
                       device: Device = config.DEFAULT_DEVICE
                       ) -> PulseSequence:
    """The n-qubit QFT pulse as a :class:`~..pulse_sequence.
    PulseSequence` on *device*, built with ``from_arrays`` from the
    precomputed arrays and the default GGM basis (equal, bit for bit,
    to the arrays' basis).  The arrays carry no operator identifiers:
    the control operators are named ``A_00``, ``A_01``, ..., the noise
    operators ``B_00``, ..., in the arrays' order."""
    z = _load(n_qubits)
    c_opers = z['c_opers_re'] + 1j * z['c_opers_im']
    n_opers = z['n_opers_re'] + 1j * z['n_opers_im']
    return PulseSequence.from_arrays(
        c_opers, [f'A_{i:02d}' for i in range(len(c_opers))], z['c_coeffs'],
        n_opers, [f'B_{i:02d}' for i in range(len(n_opers))], z['n_coeffs'],
        z['dt'], device=device)
