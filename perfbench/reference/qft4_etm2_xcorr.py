"""Plain reference of the ``qft4_etm2_xcorr`` configuration: the error
transfer matrix to second order of the 4-qubit QFT pulse (d = 16, 13
segments, 18 control and 18 noise operators, 256-element GGM basis)
under a robustness batch, each row's control amplitudes scaled, for
the configuration's cross-spectrum S_ab(w) = C_ab A / w^p, whose
correlation matrix C (:func:`correlation_matrix`) is the identity but
among the operators of ``correlations``, where it is rho^|j - k| of
their chain positions.

Each row's matrix is worked out from scratch by
:mod:`reference.cross_second_order`, pulse by pulse and pair by pair.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import cross_second_order as plain
from perfbench.reference.qft4 import Reference as _Pulses


def correlation_matrix(config: dict) -> np.ndarray:
    """C (n_nops, n_nops): 1 on the diagonal, rho^|j - k| between the
    correlated operators at chain positions j and k, 0 elsewhere."""
    corr = config['correlations']
    c = np.eye(config['n_nops'])
    for a, j in zip(corr['indices'], corr['positions']):
        for b, k in zip(corr['indices'], corr['positions']):
            c[a, b] = corr['rho'] ** abs(j - k)
    return c


class Reference(_Pulses):
    """The inputs of both sides (host arrays from the harness) on
    *device*, the cross-spectrum, and the reference's error transfer
    matrices for a call's inputs."""

    def __init__(self, data: dict, device):
        super().__init__(data, device)
        c = torch.as_tensor(correlation_matrix(data['config']),
                            device=self.device)
        self.cross = c[:, :, None] * self.spectrum[None, None, :]

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
            s['basis'], self.omega, self.cross, precision, second_order)
