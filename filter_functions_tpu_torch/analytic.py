r"""Closed-form dephasing filter functions of canonical dynamical
decoupling sequences (formulas from Cywinski et al., PRB 77, 174509
(2008)); the port's own copy of ``filter_functions_tpu.analytic``.

Conventions: these differ from the numerically computed fidelity filter
functions of this package by a factor 1/omega^2 and assume the noise
coupling B = sigma_z / 2.  ``z = omega * tau`` is the dimensionless
frequency, a numpy array (host side).
"""
import numpy as np

__all__ = ['FID', 'SE', 'PDD', 'CPMG', 'CDD', 'UDD']


def FID(z):
    """Free induction decay (Ramsey)."""
    return 2 * np.sin(z / 2)**2


def SE(z):
    """Hahn spin echo."""
    return 8 * np.sin(z / 4)**4


def PDD(z, n):
    """Periodic dynamical decoupling with n pulses."""
    envelope = 2 * np.tan(z / (2 * n + 2))**2
    if n % 2 == 0:
        return envelope * np.cos(z / 2)**2
    return envelope * np.sin(z / 2)**2


def CPMG(z, n):
    """Carr-Purcell-Meiboom-Gill with n pulses."""
    envelope = 8 * np.sin(z / 4 / n)**4 / np.cos(z / 2 / n)**2
    if n % 2 == 0:
        return envelope * np.sin(z / 2)**2
    return envelope * np.cos(z / 2)**2


def CDD(z, g):
    """Concatenated dynamical decoupling of order g."""
    product = np.prod([np.sin(z / 2**(k + 1))**2 for k in range(1, g + 1)],
                      axis=0)
    return 2**(2 * g + 1) * np.sin(z / 2**(g + 1))**2 * product


def UDD(z, n):
    """Uhrig dynamical decoupling with n pulses."""
    phases = [(-1)**k * np.exp(1j * z / 2 * np.cos(np.pi * k / (n + 1)))
              for k in range(-n - 1, n + 1)]
    return np.abs(np.sum(phases, axis=0))**2 / 2
