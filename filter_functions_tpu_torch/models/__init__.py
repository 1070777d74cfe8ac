"""Predefined pulse families of the PyTorch port.

* :mod:`.dd` -- dynamical-decoupling sequences (FID, SE, CPMG, UDD, PDD,
  CDD) with closed forms in :mod:`..analytic`.
* :mod:`.qft` -- the Ising-type quantum Fourier transform pulse; its
  4-qubit instance is the flagship workload.
* :mod:`.rb` -- single-qubit Clifford pulses and randomized-benchmarking
  sequences.
"""
from . import dd, qft, rb
from .qft import qft_pulse_arrays, qft_pulse_sequence

__all__ = ['dd', 'qft', 'rb', 'qft_pulse_arrays', 'qft_pulse_sequence']
