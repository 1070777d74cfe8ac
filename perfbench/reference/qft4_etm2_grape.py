"""Plain reference of the ``qft4_etm2_grape`` configuration: the
objective of a robust GRAPE step on the second-order process of the
4-qubit QFT pulse (d = 16, 13 segments, 18 control and 18 noise
operators, 256-element GGM basis) under a robustness batch, each row's
control amplitudes scaled, for the configuration's diagonal spectrum.

Each row's loss is L = ||E - I||_F^2 of its error transfer matrix E to
second order (:mod:`reference.second_order`, as :mod:`reference.qft4_etm2`
computes it); its derivative along a direction v in the row's control
amplitudes is the five-point central difference

    dL/ds = (L(c - 2hv) - 8 L(c - hv) + 8 L(c + hv) - L(c + 2hv)) / 12 h

of those losses.  No eigendecomposition is differentiated: the pulse is
degenerate on segments 0-2 (and the jitter keeps that), where the
eigenvectors' derivative does not exist but the loss's does.
"""
from __future__ import annotations

import torch

from perfbench.reference import second_order as plain
from perfbench.reference.qft4_etm2 import Reference as _Etm2

#: Step h of the central differences, in the units of the control
#: amplitudes (at most pi/2 in this pulse, where a unit step turns a
#: segment's propagator by about its duration).  The rounding of the
#: reference's losses, ~1e-13 of L (its E - I holds ~1e-14), enters the
#: difference as ~1.5e-13 L / h ~ 1.5e-10 L, and the five-point formula's
#: truncation, h^4 L^(5) / 30, as ~3e-14 L at derivatives of order one:
#: the step keeps both far below the limit of the comparison.
STEP = 1e-3
#: The five-point stencil: offset k (in steps) and its weight.
STENCIL = {-2: 1.0, -1: -8.0, 1: 8.0, 2: -1.0}


def losses(etm: torch.Tensor) -> torch.Tensor:
    """(b,) ||E - I||_F^2 of error transfer matrices (b, n, n)."""
    eye = torch.eye(etm.shape[-1], dtype=etm.dtype, device=etm.device)
    return ((etm - eye) ** 2).sum((-2, -1))


def directional_derivatives(c_opers, c_coeffs, n_opers, n_coeffs, dt, basis,
                            omega, spectrum, directions: torch.Tensor,
                            precision: str = 'float64') -> torch.Tensor:
    """(b, m): the derivative of each row's loss along each of its m
    *directions* (b, m, n_ctrl, G) in its control amplitudes c_coeffs
    (b, n_ctrl, G), by the five-point central difference of
    :data:`STEP`; the losses in *precision* (n_coeffs (b, n_nops, G),
    dt (b, G); shared operators, basis, frequencies and spectrum)."""
    b, m = directions.shape[:2]

    def rows(x):                       # (b, ...) -> (b m, ...)
        return x[:, None].expand(b, m, *x.shape[1:]).reshape(
            b * m, *x.shape[1:])
    shifted = torch.cat([rows(c_coeffs) + k * STEP * directions.reshape(
        b * m, *directions.shape[2:]) for k in STENCIL])
    n = len(STENCIL)
    etm = plain.error_transfer_matrices(
        c_opers, shifted, n_opers, rows(n_coeffs).repeat(n, 1, 1),
        rows(dt).repeat(n, 1), basis, omega, spectrum, precision)
    values = losses(etm).reshape(n, b, m)
    weights = torch.as_tensor(list(STENCIL.values()), dtype=values.dtype,
                              device=values.device)
    return ((weights[:, None, None] * values).sum(0)
            / (12 * STEP)).double()


class Reference(_Etm2):
    """The inputs of both sides (host arrays from the harness) on
    *device*; the reference's error transfer matrices
    (:meth:`error_transfer_matrices`), losses and directional
    derivatives for a call's inputs."""

    def losses(self, inputs: dict, precision: str = 'float64'
               ) -> torch.Tensor:
        """(b,) ||E - I||_F^2 of a call's rows."""
        return losses(self.error_transfer_matrices(inputs, precision))

    def directional_derivatives(self, inputs: dict, directions: torch.Tensor,
                                precision: str = 'float64') -> torch.Tensor:
        """(b, m): each row's loss differentiated along its *directions*
        (b, m, n_ctrl, G) by central differences."""
        c_coeffs = self.coefficients(inputs['scales'])
        b = c_coeffs.shape[0]
        s = self.static
        return directional_derivatives(
            s['c_opers'], c_coeffs, s['n_opers'],
            self.n_coeffs.expand(b, -1, -1), self.dt.expand(b, -1),
            s['basis'], self.omega, self.spectrum,
            directions.to(self.device), precision)
