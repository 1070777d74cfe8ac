"""The 4-qubit quantum Fourier transform pulse (d = 16, 13 segments,
18 control and 18 noise operators, 256-element GGM basis): the flagship
workload.

The arrays are the ones the JAX package ships precomputed in
``filter_functions_tpu/models/qft4_arrays.npz``; they are read with
numpy, so this module needs no JAX.
"""
from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..convert import pulse_arrays_from_numpy
from ..functional import PulseArrays

_ARRAYS_DIR = (Path(__file__).resolve().parents[2] / 'filter_functions_tpu'
               / 'models')


def qft_pulse_arrays(n_qubits: int = 4,
                     device: Union[str, torch.device] = 'cpu'
                     ) -> PulseArrays:
    """:class:`~..functional.PulseArrays` of the n-qubit QFT pulse on
    *device*.  Only the precomputed 4-qubit instance exists."""
    path = _ARRAYS_DIR / f'qft{n_qubits}_arrays.npz'
    if not path.exists():
        raise FileNotFoundError(f'no precomputed QFT arrays for '
                                f'{n_qubits} qubits at {path}')
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return pulse_arrays_from_numpy(arrays, device=device)
