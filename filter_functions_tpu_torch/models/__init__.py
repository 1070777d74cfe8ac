"""Predefined pulse families of the PyTorch port.

* :mod:`.dd` -- dynamical-decoupling sequences (FID, SE, CPMG, UDD, PDD,
  CDD) with closed forms in :mod:`..analytic`.
* :mod:`.qft` -- the Ising-type quantum Fourier transform pulse; its
  4-qubit instance is the flagship workload.
* :mod:`.rb` -- single-qubit Clifford pulses and randomized-benchmarking
  sequences.
* :mod:`.exchange` -- exchange-coupled spin-qubit chains, the Dial
  1/f^alpha charge-noise spectrum, and the 4-spin CNOT pulse built from
  a ``CNOT.mat`` file.
"""
from . import dd, exchange, qft, rb
from .qft import qft_pulse_arrays, qft_pulse_sequence

__all__ = ['dd', 'exchange', 'qft', 'rb', 'qft_pulse_arrays',
           'qft_pulse_sequence']
