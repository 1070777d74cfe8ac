"""Pulse optimization (GRAPE) on a device mesh (counterpart of
``filter_functions_tpu.parallel.optimize``).

The optimization loop runs on the device: a ``torch.optim`` optimizer
stepped in a Python loop, gradients from ``torch.autograd`` through the
whole pipeline (diagonalization, propagators, frequency-lattice
contraction) on either contraction route.  With a mesh, the pulse batch
is split over its ``'batch'`` dimension and the frequency integral over
``'omega'`` (:mod:`.sharding`).

``optimizer`` keeps the JAX package's name with a torch meaning: it is a
callable ``params -> torch.optim.Optimizer`` where the JAX package takes
an optax transformation.  The default, ``torch.optim.Adam(params,
lr=learning_rate)``, is optax's ``adam(learning_rate)`` update with the
same defaults (b1 0.9, b2 0.999, eps 1e-8) in another order of
floating-point operations.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import config, functional
from .sharding import (_block, _collective, _dim, _dtensor, _dtensor_module,
                       _frequency_share, _gather, _local_value_and_grad,
                       _partial_infidelity, _real, _sum_over_omega)

__all__ = ['OptimizationResult', 'optimize_pulse']


class OptimizationResult(NamedTuple):
    """Outcome of :func:`optimize_pulse`."""
    c_coeffs: torch.Tensor    # optimized controls, (batch?, n_ctrl, n_dt)
    infidelity: torch.Tensor  # final per-pulse total infidelity
    history: torch.Tensor     # loss per iteration, (n_steps,)


def optimize_pulse(p: functional.PulseArrays, spectrum, omega,
                   n_steps: int = 100, optimizer: Optional[Callable] = None,
                   learning_rate: float = 1e-2,
                   regularizer: Optional[Callable] = None,
                   mesh=None, chunk_size: Optional[int] = None,
                   contract: Optional[str] = None,
                   escalation_tol: float = config.ESCALATION_TOL
                   ) -> OptimizationResult:
    """Minimize the total leading-order infidelity over the control
    coefficients, on the device of the pulse.

    Parameters
    ----------
    p : PulseArrays
        Initial pulse; ``c_coeffs`` may carry a leading batch axis
        (independent candidates optimized together, the standard
        multi-start strategy for non-convex control landscapes); shared
        ``n_coeffs`` / ``dt`` are broadcast to it.
    spectrum, omega : tensors
        Noise PSD sampled on the frequency grid.
    n_steps : int
        Optimizer iterations.
    optimizer : callable, optional
        ``params -> torch.optim.Optimizer``; defaults to
        ``torch.optim.Adam(params, lr=learning_rate)``.
    regularizer : callable, optional
        Extra loss term ``f(c_coeffs) -> scalar`` of the full
        ``c_coeffs`` (power or slew penalties).
    mesh : DeviceMesh, optional
        (batch, omega) mesh (:func:`.sharding.make_mesh`).  Each rank
        keeps the optimizer state of its rows, which equals the
        unsharded run for an elementwise optimizer such as Adam.  Per
        step, one SUM over ``'omega'`` completes [gradient rows, partial
        loss]; with a regularizer and a batch split over ``'batch'``, one
        'gather' over ``'batch'`` gives it the full ``c_coeffs``, and its
        value and gradient enter on ``'omega'`` coordinate 0 only (its
        value on ``'batch'`` coordinate 0 only).  At the end, one SUM over
        ``'omega'`` completes the final infidelity and, for a batch, one
        SUM over ``'batch'`` the history.  The 'ozaki' route adds one MAX
        per evaluation (:mod:`.sharding`).
    chunk_size, contract, escalation_tol
        As in :func:`.functional.batched_infidelity`.

    Returns
    -------
    OptimizationResult
        ``history[i]`` is the loss, regularizer included, before update
        ``i``; ``infidelity`` is the total per pulse at the final
        ``c_coeffs`` (a scalar for one pulse, (batch,) for a batch).
        With a mesh, DTensors: ``c_coeffs`` and ``infidelity`` placed
        ``[Shard(0), Replicate()]`` for a batch, ``history`` replicated.
    """
    device = p.c_opers.device
    mode = config.contraction_mode(device, contract)
    c0 = _real(p.c_coeffs, device)
    batched = c0.ndim == 3
    if batched:
        n_batch = c0.shape[0]
        n_coeffs = _real(p.n_coeffs, device)
        dt = _real(p.dt, device)
        if n_coeffs.ndim == 2:
            n_coeffs = n_coeffs.expand(n_batch, *n_coeffs.shape)
        if dt.ndim == 1:
            dt = dt.expand(n_batch, *dt.shape)
        p = p._replace(n_coeffs=n_coeffs, dt=dt)
    else:
        p = p._replace(n_coeffs=_real(p.n_coeffs, device)[None],
                       dt=_real(p.dt, device)[None])
        c0 = c0[None]

    if mesh is None:
        spectrum, omega = _real(spectrum, device), _real(omega, device)
        weights = None
        first = True        # the regularizer's value and gradient enter
        counted = True      # here, and its value counts in the history
    else:
        spectrum, omega, weights = _frequency_share(spectrum, omega, mesh,
                                                    device)
        if batched:
            p = p._replace(n_coeffs=_block(p.n_coeffs, mesh, 'batch', 0),
                           dt=_block(p.dt, mesh, 'batch', 0))
            c0 = _block(c0, mesh, 'batch', 0)
        first = _dim(mesh, 'omega')[1] == 0
        counted = first and (not batched or _dim(mesh, 'batch')[1] == 0)
    # the escalation decision spans every pulse of the loss
    max_dim = None if batched else 'omega'

    def value_and_grad(c):
        loss, grad = _local_value_and_grad(c, p, spectrum, omega, weights,
                                           mesh, chunk_size, mode,
                                           escalation_tol, max_dim)
        if regularizer is not None and first:
            value, reg_grad = _regularizer(regularizer, c, batched, mesh)
            grad = grad + reg_grad
            if counted:
                loss = loss + value
        if mesh is not None:
            loss, grad = _sum_over_omega(loss, grad, mesh)
        return loss, grad

    c = c0.detach().clone().requires_grad_(True)
    if optimizer is None:
        opt = torch.optim.Adam([c], lr=learning_rate)
    else:
        opt = optimizer([c])
    history = []
    for _ in range(n_steps):
        loss, grad = value_and_grad(c)
        history.append(loss)
        c.grad = grad
        opt.step()
    c = c.detach()
    history = torch.stack(history) if history else c.new_zeros(0)
    with torch.no_grad():
        final = _partial_infidelity(p._replace(c_coeffs=c), spectrum, omega,
                                    weights, mesh, chunk_size, mode,
                                    escalation_tol, max_dim).sum(-1)
    if not batched:
        c, final = c[0], final[0]
    if mesh is None:
        return OptimizationResult(c, final, history)

    dtensor = _dtensor_module()
    final = _collective(final.clone(), mesh, 'omega', 'sum')
    rows = [dtensor.Shard(0), dtensor.Replicate()]
    if batched:
        history = _collective(history, mesh, 'batch', 'sum')
    else:
        rows = [dtensor.Replicate(), dtensor.Replicate()]
    return OptimizationResult(
        _dtensor(c, mesh, rows), _dtensor(final, mesh, rows),
        _dtensor(history, mesh, [dtensor.Replicate(), dtensor.Replicate()]))


def _regularizer(regularizer: Callable, c: torch.Tensor, batched: bool,
                 mesh):
    """(value, gradient on the rows *c*) of the regularizer of the full
    c_coeffs: a batch split over ``'batch'`` is gathered first."""
    full = c.detach()
    if mesh is not None and batched:
        full = _gather(full, mesh, 'batch', 0)
    full = full.requires_grad_(True)
    value = regularizer(full if batched else full[0])
    grad, = torch.autograd.grad(value, full)
    if mesh is not None and batched:
        coord = _dim(mesh, 'batch')[1]
        grad = grad.narrow(0, coord * c.shape[0], c.shape[0])
    return value.detach(), grad
