"""Plain reference of the ``qft4_etm2`` configuration: the error transfer
matrix to second order of the 4-qubit QFT pulse (d = 16, 13 segments,
18 control and 18 noise operators, 256-element GGM basis) under a
robustness batch, each row's control amplitudes scaled, for the
configuration's diagonal spectrum.

Each row's matrix is worked out from scratch by
:mod:`reference.second_order`, pulse by pulse.
"""
from __future__ import annotations

import torch

from perfbench.reference import second_order as plain
from perfbench.reference.qft4 import Reference as _Pulses


class Reference(_Pulses):
    """The inputs of both sides (host arrays from the harness) on
    *device*, and the reference's error transfer matrices for a call's
    inputs."""

    def error_transfer_matrices(self, inputs: dict,
                                precision: str = 'float64',
                                second_order: bool = True) -> torch.Tensor:
        """(b, n_b, n_b) of a call; without *second_order* the
        first-order matrices."""
        c_coeffs = self.coefficients(inputs['scales'])
        b = c_coeffs.shape[0]
        s = self.static
        return plain.error_transfer_matrices(
            s['c_opers'], c_coeffs, s['n_opers'],
            self.n_coeffs.expand(b, -1, -1), self.dt.expand(b, -1),
            s['basis'], self.omega, self.spectrum, precision, second_order)
