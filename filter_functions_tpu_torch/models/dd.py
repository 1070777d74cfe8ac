"""Dynamical-decoupling pulse factories.

Builds piecewise-constant X-pi-pulse trains subject to sigma_z/2
dephasing whose fidelity filter functions have the closed forms in
:mod:`..analytic` (up to the 1/omega^2 convention factor).  Every
constructor takes the *device* of the pulse (:data:`~..config.DEFAULT_DEVICE`
unless given).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import config, util
from ..basis import Basis
from ..pulse_sequence import PulseSequence
from ..types import Device

__all__ = ['fid_pulse', 'spin_echo_pulse', 'dd_pulse']


def fid_pulse(tau: float = 1.0,
              device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """Free induction decay: a single idle segment of duration tau."""
    return PulseSequence([[util.paulis[3] / 2, [0.0], 'Z0']],
                         [[util.paulis[3] / 2, [1.0], 'Z']], [tau],
                         device=device)


def _pulse_timings(n: int, tau: float, tau_pi: float, dd_type: str,
                   pulse_type: str = 'primitive'):
    """Pi-pulse centers delta*tau and the resulting segment grid."""
    def cdd_odd(g, t):
        return np.array([*cdd_even(g - 1, t / 2), t / 2,
                         *cdd_even(g - 1, t / 2) + t / 2])

    def cdd_even(g, t):
        if g == 0:
            return np.array([])
        return np.array([*cdd_odd(g - 1, t / 2),
                         *cdd_odd(g - 1, t / 2) + t / 2])

    if dd_type == 'cpmg':
        delta = np.array([(g - 0.5) / n for g in range(1, n + 1)])
    elif dd_type == 'udd':
        delta = np.array([np.sin(np.pi * g / (2 * n + 2))**2
                          for g in range(1, n + 1)])
    elif dd_type == 'pdd':
        delta = np.array([g / (n + 1) for g in range(1, n + 1)])
    elif dd_type == 'cdd':
        delta = cdd_odd(n, 1) if n % 2 else cdd_even(n, 1)
    else:
        raise ValueError(f"Unknown dd_type '{dd_type}'")

    if pulse_type == 'primitive':
        tau_p = tau_pi
        amps = np.pi / tau_pi * np.array([1.0])
        offsets = tau_pi * np.array([0.0, 1.0])
    elif pulse_type == 'dcg':
        tau_p = 4 * tau_pi
        amps = np.pi / tau_pi * np.array([1.0, 0.5, 1.0])
        offsets = np.array([0, tau_pi, 3 * tau_pi, 4 * tau_pi])
    else:
        raise ValueError(f"Unknown pulse_type '{pulse_type}'")

    times = [0.0]
    coeffs = []
    for center in delta * tau:
        start = center - tau_p / 2
        coeffs.append(0.0)                 # idle up to the pulse
        times.append(start)
        for amp, off_lo, off_hi in zip(amps, offsets[:-1], offsets[1:]):
            coeffs.append(amp)
            times.append(start + off_hi)
    coeffs.append(0.0)                     # final idle
    times.append(tau)
    return np.asarray(coeffs), np.diff(np.asarray(times))


def dd_pulse(n: int, tau: float = 1.0, tau_pi: float = 1e-9,
             dd_type: str = 'cpmg', pulse_type: str = 'primitive',
             basis: Optional[Basis] = None,
             device: Device = config.DEFAULT_DEVICE) -> PulseSequence:
    """A CPMG/UDD/PDD/CDD sequence of *n* (or order-n for CDD) X pi
    pulses over duration *tau*, each pulse of width *tau_pi*."""
    coeffs, dt = _pulse_timings(n, tau, tau_pi, dd_type, pulse_type)
    H_c = [[util.paulis[1] / 2, coeffs, 'X']]
    H_n = [[util.paulis[3] / 2, np.ones(len(dt)), 'Z']]
    return PulseSequence(H_c, H_n, dt, basis=basis, device=device)


def spin_echo_pulse(tau: float = 1.0, tau_pi: float = 1e-9,
                    **kwargs) -> PulseSequence:
    """Hahn spin echo: a single central pi pulse."""
    return dd_pulse(1, tau, tau_pi, dd_type='cpmg', **kwargs)
