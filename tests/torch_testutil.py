"""Test helpers of the PyTorch port.

testutil's pulse factories build a pulse without a device argument, and
the port's default device is the card.  :data:`fft_cpu` is the ``cls``
they take to build the port's pulse on the CPU.
"""
import functools
import types

import filter_functions_tpu_torch as fft

#: The port's Basis, and its PulseSequence bound to ``device='cpu'``.
fft_cpu = types.SimpleNamespace(
    Basis=fft.Basis,
    PulseSequence=functools.partial(fft.PulseSequence, device='cpu'))
