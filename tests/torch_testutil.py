"""Test helpers of the PyTorch port.

testutil's pulse factories build a pulse without a device argument, and
the port's default device is the card.  :data:`fft_cpu` is the ``cls``
they take to build the port's pulse on the CPU.
"""
import functools
import types
from pathlib import Path

import filter_functions_tpu_torch as fft

#: The JAX package's precomputed flagship arrays.  The port reads no
#: file; the tests hold its live QFT pulse against these.
QFT_NPZ = (Path(__file__).resolve().parents[1] / 'filter_functions_tpu'
           / 'models' / 'qft4_arrays.npz')

#: The port's Basis, and its PulseSequence bound to ``device='cpu'``.
fft_cpu = types.SimpleNamespace(
    Basis=fft.Basis,
    PulseSequence=functools.partial(fft.PulseSequence, device='cpu'))
