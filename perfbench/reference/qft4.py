"""Plain reference of the ``qft4`` configuration: the 4-qubit QFT pulse
(d = 16, 13 segments, 18 control and 18 noise operators, 256-element GGM
basis) under a robustness batch, each row's control amplitudes scaled.

Infidelities from :mod:`reference.piecewise`; the gradient of each row's
summed infidelity in its control amplitudes by a five-point central
difference of those infidelities, which needs no derivative of an
eigendecomposition: the pulse has degenerate segments, where the
eigenvectors' derivative does not exist but the infidelity's does.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import piecewise

#: Step of the central differences, in the units of the control
#: amplitudes (at most pi/2 in this pulse): the five-point formula's
#: truncation, h^4 f^(5) / 30, and its rounding, eps |f| / h, stay near
#: 1e-11 of the gradient.
STEP = 1e-3


class Reference:
    """The inputs of both sides (host arrays from the harness) on
    *device*, and the reference's answers for a call's inputs."""

    def __init__(self, data: dict, device):
        self.device = torch.device(device)
        arrays = data['arrays']
        self.static = {name: torch.as_tensor(arrays[name], device=device)
                       for name in ('c_opers', 'n_opers', 'basis')}
        self.c_coeffs = torch.as_tensor(arrays['c_coeffs'], device=device)
        self.n_coeffs = torch.as_tensor(arrays['n_coeffs'], device=device)
        self.dt = torch.as_tensor(arrays['dt'], device=device)
        self.omega = torch.as_tensor(data['omega'], device=device)
        self.spectrum = torch.as_tensor(data['spectrum'], device=device)

    def coefficients(self, scales: np.ndarray) -> torch.Tensor:
        """Control amplitudes (b, n_ctrl, G) of rows scaled by *scales*
        (b, 1, 1)."""
        return self.c_coeffs[None] * torch.as_tensor(scales,
                                                     device=self.device)

    def _infid(self, c_coeffs: torch.Tensor, precision: str) -> torch.Tensor:
        b = c_coeffs.shape[0]
        s = self.static
        return piecewise.infidelity(
            s['c_opers'], c_coeffs, s['n_opers'],
            self.n_coeffs.expand(b, -1, -1), self.dt.expand(b, -1),
            s['basis'], self.omega, self.spectrum, precision)

    def infidelities(self, inputs: dict, precision: str = 'float64'
                     ) -> torch.Tensor:
        """(b, n_nops) infidelities of a call."""
        return self._infid(self.coefficients(inputs['scales']), precision)

    def gradient(self, inputs: dict, rows, precision: str = 'float64',
                 block: int = 64) -> torch.Tensor:
        """(len(rows), n_ctrl, G): the derivative of each row's summed
        infidelity in its control amplitudes, by central differences
        f' = (f(-2h) - 8 f(-h) + 8 f(h) - f(2h)) / 12 h, evaluated in
        blocks of *block* pulses."""
        base = self.coefficients(inputs['scales'])[list(rows)]
        n_rows, n_ctrl, G = base.shape
        n_coord = n_ctrl * G
        weights = {-2: 1.0, -1: -8.0, 1: 8.0, 2: -1.0}
        shifted = []
        for k in weights:
            bumps = torch.eye(n_coord, dtype=base.dtype,
                              device=self.device).reshape(
                n_coord, n_ctrl, G) * (k * STEP)
            shifted.append((base[:, None] + bumps[None]).reshape(
                -1, n_ctrl, G))
        stack = torch.cat(shifted)
        values = torch.cat([self._infid(stack[i:i + block], precision)
                            .sum(-1).double()
                            for i in range(0, stack.shape[0], block)])
        values = values.reshape(len(weights), n_rows, n_ctrl, G)
        grad = sum(w * v for w, v in zip(weights.values(), values))
        return grad / (12 * STEP)
