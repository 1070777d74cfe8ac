"""PyTorch port of :mod:`filter_functions_tpu` for CUDA GPUs.

The object API -- :class:`PulseSequence`, :class:`Basis`, control
matrices, first- and second-order filter functions, :func:`infidelity`,
:func:`error_transfer_matrix`, and the composition of pulses in time
with reuse of their cached control matrices (:func:`concatenate`,
:func:`concatenate_periodic`, ``a @ b``) and in space (:func:`remap`,
:func:`extend`) -- and the functional path
(:mod:`.functional`: the batched infidelity of the 4-qubit QFT pulse,
the batched error transfer matrix) run through the same pipeline as the
JAX package: diagonalize, per-segment step terms, the control-matrix
contraction (native complex128, or the factored int8 Ozaki route with
the hand-written CUDA kernel of :mod:`.ops.dword`), the second-order
integral lattice, the spectral integrals and the cumulant function.
Derivatives with respect to the control amplitudes come from
``torch.autograd`` through :mod:`.functional` on either contraction
route, or in closed form from :mod:`.gradient`
(:func:`infidelity_derivative`).  :mod:`.spectroscopy` reconstructs a
noise spectrum from measured infidelities; :mod:`.plotting` (imported on
its own, it needs matplotlib) draws pulses and filter functions.
:mod:`.parallel` splits the frequency grid and the pulse batch over a
``torch.distributed`` device mesh and runs GRAPE on it.  :mod:`.tracing`
holds the spans a profiler records and the counters of the host's reads
of the device.

Complex values are ``torch.complex128`` and reals ``torch.float64``;
every computed value lives on an explicit device.  The package imports
``torch`` and never ``jax``.
"""
from . import (analytic, basis, config, convert, functional, gradient,
               models, numeric, parallel, pulse_sequence, sequencing,
               spectroscopy, superoperator, tracing, types, util)
from .basis import Basis
from .functional import PulseArrays, batched_infidelity, control_matrix
from .gradient import infidelity_derivative
from .models.qft import qft_pulse_arrays, qft_pulse_sequence
from .numeric import error_transfer_matrix, infidelity
from .pulse_sequence import (PulseSequence, concatenate,
                             concatenate_periodic,
                             concatenate_without_filter_function, extend,
                             remap)
from .superoperator import liouville_representation

__all__ = ['Basis', 'PulseArrays', 'PulseSequence', 'batched_infidelity',
           'concatenate', 'concatenate_periodic',
           'concatenate_without_filter_function', 'control_matrix',
           'error_transfer_matrix', 'extend', 'infidelity',
           'infidelity_derivative', 'liouville_representation',
           'qft_pulse_arrays', 'qft_pulse_sequence', 'remap', 'analytic',
           'basis', 'config', 'convert', 'functional', 'gradient', 'models',
           'numeric', 'parallel', 'pulse_sequence', 'sequencing',
           'spectroscopy', 'superoperator', 'tracing', 'types', 'util']
