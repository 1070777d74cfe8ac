"""PyTorch port of :mod:`filter_functions_tpu` for CUDA GPUs.

The first slice of the port: the batched infidelity of the 4-qubit QFT
pulse, through the same pipeline the JAX package runs -- diagonalize,
per-segment step terms, the control-matrix contraction (native
complex128, or the factored int8 Ozaki route with the hand-written CUDA
kernel of :mod:`.ops.dword`) and the spectral integral.

Complex values are ``torch.complex128`` and reals ``torch.float64``;
every function runs on the device of its inputs.  The package imports
``torch`` and never ``jax``.
"""
from . import config, convert, functional, numeric, util
from .functional import (PulseArrays, batched_infidelity, control_matrix,
                         infidelity)
from .models.qft import qft_pulse_arrays

__all__ = ['PulseArrays', 'batched_infidelity', 'config', 'control_matrix',
           'convert', 'functional', 'infidelity', 'numeric',
           'qft_pulse_arrays', 'util']
