r"""Noise spectroscopy of the PyTorch port (counterpart of
``filter_functions_tpu.spectroscopy``): reconstruct a noise spectral
density from measured infidelities.

Each pulse p with fidelity filter function F_p(omega) measures the
linear functional

    I_p = 1/(2 pi d) \int d omega  F_p(omega) S(omega),

so a family of pulses (CPMG trains of varying period, say) turns
spectrum estimation into a linear inverse problem.  The spectrum is
parameterized by hat functions, linear in log(omega), on a coarse grid
of nodes (:func:`spectrum_basis`, host numpy); the design matrix is one
trapezoid integral over a stack of filter functions on their device
(:func:`design_matrix`), and the non-negative least-squares solve is a
FISTA loop with projection onto S >= 0 over device tensors
(:func:`reconstruct`).

Typical use::

    A, nodes = design_matrix(filter_functions, omega, n_nodes=12)
    s_nodes = reconstruct(A, measured_infidelities, ridge=1e-4)
    S = interpolate_spectrum(s_nodes, nodes, omega)

The functions follow the device of a tensor argument; numpy arguments
go to *device*, :data:`~.config.DEFAULT_DEVICE` unless given.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import config, util
from .types import Device

__all__ = ['design_matrix', 'reconstruct', 'interpolate_spectrum',
           'spectrum_basis']


def _device_of(*args, device: Optional[Device] = None) -> torch.device:
    """The device of the first tensor among *args*, else *device* (the
    default device if None)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return config.resolve_device(config.DEFAULT_DEVICE if device is None
                                 else device)


def _real(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=config.REAL, device=device)


def spectrum_basis(omega, n_nodes: int,
                   omega_min: Optional[float] = None,
                   omega_max: Optional[float] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Log-spaced hat-function interpolation basis (host numpy).

    Returns ``(nodes (n_nodes,), W (n_nodes, n_omega))`` with
    ``S(omega) = sum_k s_k W[k]`` piecewise-linear in log(omega).
    """
    if n_nodes < 2:
        raise ValueError(f'Need n_nodes >= 2 for interpolation, got '
                         f'{n_nodes}')
    omega = util._host(omega)
    lo = np.log(omega_min if omega_min is not None else omega.min())
    hi = np.log(omega_max if omega_max is not None else omega.max())
    if not hi > lo:
        raise ValueError('Degenerate frequency range: need '
                         f'omega_max > omega_min > 0, got [{np.exp(lo)}, '
                         f'{np.exp(hi)}]')
    node_logs = np.linspace(lo, hi, n_nodes)
    nodes = np.exp(node_logs)
    x = np.log(np.clip(omega, nodes[0], nodes[-1]))
    w = np.zeros((n_nodes, len(omega)))
    idx = np.clip(np.searchsorted(node_logs, x) - 1, 0, n_nodes - 2)
    frac = (x - node_logs[idx]) / (node_logs[idx + 1] - node_logs[idx])
    cols = np.arange(len(omega))
    w[idx, cols] = 1 - frac
    w[idx + 1, cols] = frac
    return nodes, w


def interpolate_spectrum(s_nodes, nodes, omega,
                         device: Optional[Device] = None) -> torch.Tensor:
    """The reconstructed spectrum on an arbitrary grid *omega*, on the
    device of *s_nodes*."""
    nodes = util._host(nodes)
    _, w = spectrum_basis(omega, len(nodes), omega_min=float(nodes[0]),
                          omega_max=float(nodes[-1]))
    dev = _device_of(s_nodes, device=device)
    return _real(s_nodes, dev) @ _real(w, dev)


def design_matrix(filter_functions, omega, n_nodes: int = 12, d: int = 2,
                  omega_min: Optional[float] = None,
                  omega_max: Optional[float] = None,
                  device: Optional[Device] = None
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    r"""``A[p, k] = 1/(2 pi d) \int F_p phi_k`` (trapezoid) from a stack
    of real fidelity filter functions ``(n_pulses, n_omega)`` (e.g. the
    diagonal of :func:`.functional.fidelity_filter_function` for the
    probed noise operator), on their device.

    Returns ``(A (n_pulses, n_nodes), nodes (n_nodes,))``.
    """
    dev = _device_of(filter_functions, omega, device=device)
    nodes, w = spectrum_basis(util._host(omega), n_nodes, omega_min,
                              omega_max)
    ff = _real(filter_functions, dev)
    # integrand[p, k, o] = F_p(o) phi_k(o)
    integrand = ff[:, None, :] * _real(w, dev)[None, :, :]
    return util.integrate(integrand, _real(omega, dev)) / (2 * np.pi * d), \
        nodes


def reconstruct(a, infidelities, ridge: float = 0.0,
                curvature: float = 0.0, n_steps: int = 2000,
                device: Optional[Device] = None) -> torch.Tensor:
    r"""Non-negative least squares
    ``min_{s >= 0} ||A s - I||^2 + ridge ||s||^2 + curvature ||D2 s||^2``
    by FISTA with projection, on the device of *a*.

    The rows of A are rescaled to unit norm, so the measurements count
    alike whatever the pulse duration; an all-zero row (a pulse whose
    filter function misses every hat) stays unscaled.
    """
    dev = _device_of(a, infidelities, device=device)
    a = _real(a, dev)
    y = _real(infidelities, dev)
    norms = torch.linalg.norm(a, dim=1)
    row_scale = 1.0 / torch.where(norms > 0, norms, 1.0)
    return _fista_nnls(a * row_scale[:, None], y * row_scale,
                       float(ridge), float(curvature), int(n_steps))


def _fista_nnls(a: torch.Tensor, y: torch.Tensor, ridge: float,
                curvature: float, n_steps: int) -> torch.Tensor:
    """FISTA on the normal equations, step 1/L with L from 50 power
    iterations, from the projected minimum-norm least-squares solution;
    the JAX package's order of operations."""
    n = a.shape[1]
    ata = a.T @ a + ridge * torch.eye(n, dtype=a.dtype, device=a.device)
    if curvature:
        d2 = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
              + np.diag(np.ones(n - 1), -1))[1:-1]
        ata = ata + curvature * _real(d2.T @ d2, a.device)
    aty = a.T @ y
    # Lipschitz constant by power iteration (ata is PSD)
    v = torch.ones(n, dtype=a.dtype, device=a.device) / np.sqrt(n)
    for _ in range(50):
        v = ata @ v
        v = v / torch.linalg.norm(v)
    eta = 1.0 / torch.clamp(v @ (ata @ v), min=1e-30)

    # the minimum-norm solution of the SVD least squares (singular values
    # below eps * n of the largest dropped), as jnp.linalg.lstsq takes it:
    # on CUDA torch.linalg.lstsq assumes full rank, and ata need not be
    s = torch.clamp(torch.linalg.pinv(
        ata, rtol=torch.finfo(a.dtype).eps * n) @ aty, min=0.0)
    z, t = s, 1.0
    for _ in range(n_steps):
        grad = ata @ z - aty
        s_new = torch.clamp(z - eta * grad, min=0.0)
        t_new = 0.5 * (1 + math.sqrt(1 + 4 * t * t))
        z = s_new + (t - 1) / t_new * (s_new - s)
        s, t = s_new, t_new
    return s
