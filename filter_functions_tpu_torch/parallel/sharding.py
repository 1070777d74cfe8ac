"""Sharding of the functional pipeline over a (batch, omega) device mesh
(counterpart of ``filter_functions_tpu.parallel.sharding``).

The port runs one process per device (SPMD over ``torch.distributed``):
every rank calls the same entry point with the full, replicated inputs
and computes its own share of the work.

* ``omega`` -- the frequency grid.  A rank evaluates the control matrix
  and the filter function at its slice of the frequencies only.  A
  frequency integral is a sum over every rank's slice: each rank weighs
  its points with its slice of the whole grid's trapezoid weights
  (:func:`.numeric.trapezoid_weights`), so that no pair of neighbouring
  points that straddles two slices is lost, and one SUM all-reduce over
  ``'omega'`` completes the integral.
* ``batch`` -- a batch of pulses (multi-start optimal-control candidates,
  randomized-benchmarking sequences): a rank takes its rows of
  ``c_coeffs``, ``n_coeffs`` and ``dt``, with no communication.

A rank takes its slice of the inputs locally, from ``mesh.
get_coordinate()``; a sharded axis that its mesh dimension does not
divide raises ``ValueError``.  The results are ``torch.distributed.
tensor.DTensor``\\ s whose placements state how they are split, built
from each rank's share without communication; ``.full_tensor()`` is the
unsharded result.

On the deep factored contraction route ('ozaki') the escalation to full
precision is decided on the largest quantization statistic of the whole
call, as :func:`.functional.batched_infidelity` decides it: one MAX
all-reduce before the decision, so that every rank reruns or none does.

Every collective goes through :func:`_collective`, which appends ``(op,
mesh dimension)`` to :data:`collectives` (dimension None: the whole
mesh) and sends nothing over a mesh dimension of size 1.  Per call, with
the inputs given as plain tensors:

================================  =======================  ===============
entry point                       native route             'ozaki' adds
================================  =======================  ===============
sharded_filter_function           none                     MAX over omega
sharded_infidelity                SUM over omega           MAX over omega
sharded_batched_infidelity        SUM over omega           MAX, whole mesh
sharded_error_transfer_matrix     none                     none
grape_step                        SUM over omega,          MAX, whole mesh
                                  SUM over batch
================================  =======================  ===============

A frequency grid passed as a DTensor (:func:`shard_omega`) adds one
'gather' over ``'omega'`` to the infidelity entry points, which need the
whole grid for the trapezoid weights.

``sharded_infidelity`` and ``sharded_batched_infidelity`` are
differentiable (``torch.autograd``) in the tensors of the pulse, as the
JAX package's are under ``jax.grad``: each rank backpropagates its share
of the frequency integral, and one SUM over ``'omega'`` in the backward
pass completes the gradient (:class:`_ReplicatedOverOmega`), none over a
one-rank ``'omega'`` and none when nothing requires grad.  A rank's
gradient is that of its own rows: rows of other ``'batch'`` blocks get
zero, as does the spectrum outside the rank's frequency slice.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import config, functional, numeric
from ..basis import Basis
from ..types import Device

__all__ = ['make_mesh', 'shard_omega', 'sharded_filter_function',
           'sharded_infidelity', 'sharded_batched_infidelity',
           'sharded_error_transfer_matrix', 'grape_step',
           'make_grape_step']

#: The collectives this package has made, in order, as (op, mesh
#: dimension): op 'sum', 'max' or 'gather', dimension 'batch', 'omega'
#: or None for the whole mesh.  Callers set it to [] and read it, as
#: ``ops.dword.launches`` counts kernel launches.
collectives: List[Tuple[str, Optional[str]]] = []

_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
        'gather': dist.ReduceOp.SUM}


def _dtensor_module():
    """``torch.distributed.tensor``, imported on first use: it takes a
    second to import, and only the sharded entry points need it."""
    import torch.distributed.tensor as dtensor
    return dtensor


def make_mesh(n_devices: Optional[int] = None, batch: int = 1,
              device: Device = config.DEFAULT_DEVICE):
    """A (batch, omega) ``DeviceMesh`` over the ranks of the default
    process group, of shape ``(batch, n // batch)``.

    In SPMD every process is one device, so *n_devices* defaults to the
    world size and must equal it.  With no process group initialized and
    *n_devices* None or 1, a group of one is created ('nccl' for a CUDA
    *device*, 'gloo' otherwise); a larger mesh needs the caller's group
    (``torchrun``, or ``torch.distributed.init_process_group``: 'gloo'
    for the CPU, 'nccl' for one card per rank).  The mesh's device type
    is that of *device*, which must exist (:func:`.config.
    resolve_device`).
    """
    from torch.distributed.device_mesh import init_device_mesh
    device = config.resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f'a mesh of {n_devices} devices needs an '
                               f'initialized process group of {n_devices} '
                               'ranks, one per device')
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f'n_devices {n_devices} is not the world size {n}: '
                         'every rank is one device')
    if n % batch:
        raise ValueError(f'batch axis {batch} does not divide device '
                         f'count {n}')
    return init_device_mesh(device.type, (batch, n // batch),
                            mesh_dim_names=('batch', 'omega'))


def _dim(mesh, name: str) -> Tuple[int, int]:
    """(size, this rank's coordinate) of mesh dimension *name*."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.shape[i], mesh.get_coordinate()[i]


def _collective(buf: torch.Tensor, mesh, dim: Optional[str], op: str
                ) -> torch.Tensor:
    """All-reduce *buf* (float64) in place over mesh dimension *dim*
    (None: the whole mesh, which must span the default group) and record
    it in :data:`collectives`; nothing is sent or recorded over a
    single rank.  *op* 'gather' is a SUM of buffers that are zero
    outside each rank's block (:func:`_gather`)."""
    if buf.dtype != torch.float64:
        raise TypeError(f'collectives run on float64 buffers, got '
                        f'{buf.dtype}')
    if dim is None:
        if mesh.size() == 1:
            return buf
        if mesh.size() != dist.get_world_size():
            raise ValueError('a reduction over the whole mesh needs a mesh '
                             'of every rank (make_mesh)')
        group = dist.group.WORLD
    else:
        if _dim(mesh, dim)[0] == 1:
            return buf
        group = mesh.get_group(dim)
    collectives.append((op, dim))
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf


class _SumOverOmega(torch.autograd.Function):
    """The frequency integral's SUM over ``'omega'`` (:func:`_collective`
    on a copy: autograd's saved tensors are never reduced in place).
    Every rank holds the whole sum, so its cotangent is the whole
    cotangent: the backward pass is the identity."""

    @staticmethod
    def forward(ctx, partial, mesh):
        return _collective(partial.clone(), mesh, 'omega', 'sum')

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReplicatedOverOmega(torch.autograd.Function):
    """The identity on the pulse's tensors, which every rank of an
    ``'omega'`` group holds whole; its backward pass is one SUM over
    ``'omega'`` of their gradients, each rank's being that of its share of
    the frequency integral.  The gradients travel in one float64 buffer,
    complex ones as ``view_as_real``, as :func:`_sum_over_omega` packs
    the GRAPE step's."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in tensors)

    @staticmethod
    def backward(ctx, *grads):
        parts = [torch.view_as_real(g) if g.is_complex() else g
                 for g in grads]
        buf = _collective(torch.cat([x.reshape(-1).to(torch.float64)
                                     for x in parts]), ctx.mesh, 'omega',
                          'sum')
        out, start = [], 0
        for grad, part in zip(grads, parts):
            value = buf[start:start + part.numel()].view_as(part)
            start += part.numel()
            out.append(torch.complex(value[..., 0], value[..., 1])
                       if grad.is_complex() else value.to(grad.dtype))
        return (None, *out)


def _replicated(p: functional.PulseArrays, mesh) -> functional.PulseArrays:
    """*p* with the tensors that require grad passed through
    :class:`_ReplicatedOverOmega`, so that the backward pass completes
    their gradients over ``'omega'``."""
    names = [name for name in p._fields if getattr(p, name).requires_grad]
    if not (names and torch.is_grad_enabled()):
        return p
    tensors = _ReplicatedOverOmega.apply(mesh,
                                         *(getattr(p, n) for n in names))
    return p._replace(**dict(zip(names, tensors)))


def _max_over(mesh, dim: Optional[str]):
    """The escalation hook of :func:`.numeric._escalates`: the largest
    ratio over mesh dimension *dim*, in the ratio's dtype."""
    def ratio_max(worst: torch.Tensor) -> torch.Tensor:
        buf = worst.detach().to(torch.float64).reshape(1).clone()
        return _collective(buf, mesh, dim, 'max')[0].to(worst.dtype)
    return ratio_max


def _block(x: torch.Tensor, mesh, dim: str, axis: int) -> torch.Tensor:
    """This rank's block of *x* along *axis* for mesh dimension *dim*; a
    DTensor is taken as its local block."""
    if isinstance(x, _dtensor_module().DTensor):
        return x.to_local()
    n, c = _dim(mesh, dim)
    length = x.shape[axis]
    if length % n:
        raise ValueError(f'axis {axis} of length {length} does not divide '
                         f'over the {n} ranks of mesh dimension {dim!r}')
    step = length // n
    return x.narrow(axis, c * step, step).contiguous()


def _gather(x: torch.Tensor, mesh, dim: str, axis: int) -> torch.Tensor:
    """The blocks of *x* of every rank along mesh dimension *dim*,
    concatenated on *axis* (float64; one 'gather' collective)."""
    n, c = _dim(mesh, dim)
    if n == 1:
        return x
    shape = list(x.shape)
    length = shape[axis]
    shape[axis] = n * length
    full = x.new_zeros(shape, dtype=torch.float64)
    full.narrow(axis, c * length, length).copy_(x)
    return _collective(full, mesh, dim, 'gather')


def _dtensor(local: torch.Tensor, mesh, placements: Sequence):
    """A DTensor from this rank's share, without communication."""
    return _dtensor_module().DTensor.from_local(local, mesh, list(placements),
                                                run_check=False)


def _real(x, device: torch.device) -> torch.Tensor:
    """*x* as a float64 tensor on *device*; a DTensor stays one."""
    if isinstance(x, _dtensor_module().DTensor):
        return x
    return torch.as_tensor(x, dtype=config.REAL, device=device)


def shard_omega(x, mesh):
    """*x* (its full value on every rank) as a DTensor whose trailing axis
    is split over the mesh's ``'omega'`` dimension, built from this
    rank's slice."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=config.REAL, device=mesh.device_type)
    Shard, Replicate = _dtensor_module().Shard, _dtensor_module().Replicate
    return _dtensor(_block(x, mesh, 'omega', -1), mesh,
                    [Replicate(), Shard(x.ndim - 1)])


def _frequency_share(spectrum, omega, mesh, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """(spectrum, omega, weights) of this rank's slice of the frequency
    grid.  The weights are the slice of the whole grid's trapezoid
    weights, or None when the grid is not split: the integral is then
    the trapezoid itself, as in the unsharded call."""
    omega = _real(omega, device)
    spectrum = _real(spectrum, device)
    if _dim(mesh, 'omega')[0] == 1:
        return (_block(spectrum, mesh, 'omega', -1),
                _block(omega, mesh, 'omega', -1), None)
    if isinstance(omega, _dtensor_module().DTensor):
        omega = _gather(omega.to_local(), mesh, 'omega', -1)
    weights = numeric.trapezoid_weights(omega)
    return (_block(spectrum, mesh, 'omega', -1),
            _block(omega, mesh, 'omega', -1),
            _block(weights, mesh, 'omega', -1))


def _batch_rows(p: functional.PulseArrays, mesh) -> functional.PulseArrays:
    """*p* with this rank's rows of c_coeffs, n_coeffs and dt."""
    return p._replace(c_coeffs=_block(p.c_coeffs, mesh, 'batch', 0),
                      n_coeffs=_block(p.n_coeffs, mesh, 'batch', 0),
                      dt=_block(p.dt, mesh, 'batch', 0))


def _partial_infidelity(p: functional.PulseArrays, spectrum, omega,
                        weights, mesh, chunk_size: Optional[int],
                        mode: str, escalation_tol: float,
                        max_dim: Optional[str]) -> torch.Tensor:
    """This rank's share (batch, n_nops) of the infidelities of the pulses
    *p*: the integral over its frequencies, escalated on the MAX of the
    quantization statistic over *max_dim* on the 'ozaki' route (without
    a mesh, the unsharded :func:`.functional.batched_infidelity`)."""
    ratio_max = (_max_over(mesh, max_dim)
                 if mode == 'ozaki' and mesh is not None else None)
    return functional._batched_infidelity(p, spectrum, omega, chunk_size,
                                          mode, escalation_tol, weights,
                                          ratio_max)


def sharded_filter_function(p: functional.PulseArrays, omega, mesh,
                            contract: Optional[str] = None,
                            escalation_tol: float = config.ESCALATION_TOL):
    """Fidelity filter function (..., n_nops, n_nops, n_omega) with the
    frequency axis split over the mesh's ``'omega'`` dimension: a DTensor
    placed ``[Replicate(), Shard(ndim - 1)]``.  No collective on the
    native route; *contract* and *escalation_tol* as in
    :func:`.functional.control_matrix`."""
    Shard, Replicate = _dtensor_module().Shard, _dtensor_module().Replicate
    device = p.c_opers.device
    mode = config.contraction_mode(device, contract)
    omega = _block(_real(omega, device), mesh, 'omega', -1)
    ratio_max = _max_over(mesh, 'omega') if mode == 'ozaki' else None
    ctrl = functional._control_matrix(p, omega, mode, escalation_tol,
                                      ratio_max)
    filter_function = numeric.calculate_filter_function(ctrl, 'fidelity')
    return _dtensor(filter_function, mesh,
                    [Replicate(), Shard(filter_function.ndim - 1)])


def sharded_infidelity(p: functional.PulseArrays, spectrum, omega, mesh,
                       contract: Optional[str] = None,
                       escalation_tol: float = config.ESCALATION_TOL):
    """Infidelity (n_nops,) of one pulse with the frequency integral split
    over the mesh's ``'omega'`` dimension and completed by one SUM
    all-reduce: a DTensor placed ``[Replicate(), Replicate()]``,
    differentiable in the tensors of *p* (the module docstring)."""
    Replicate = _dtensor_module().Replicate
    device = p.c_opers.device
    mode = config.contraction_mode(device, contract)
    spectrum, omega, weights = _frequency_share(spectrum, omega, mesh,
                                                device)
    p = _replicated(p, mesh)
    one = p._replace(c_coeffs=p.c_coeffs[None], n_coeffs=p.n_coeffs[None],
                     dt=p.dt[None])
    partial = _partial_infidelity(one, spectrum, omega, weights, mesh, None,
                                  mode, escalation_tol, 'omega')[0]
    infid = _SumOverOmega.apply(partial, mesh)
    return _dtensor(infid, mesh, [Replicate(), Replicate()])


def sharded_batched_infidelity(p: functional.PulseArrays, spectrum, omega,
                               mesh, chunk_size: Optional[int] = None,
                               contract: Optional[str] = None,
                               escalation_tol: float = config.ESCALATION_TOL):
    """The production batched entry point (:func:`.functional.
    batched_infidelity`, the flagship's path) over the whole (batch,
    omega) mesh: the pulse batch splits over ``'batch'``, the frequency
    grid over ``'omega'``, and the only collective of the native route is
    the frequency integral's SUM over ``'omega'``.  On the 'ozaki' route
    one MAX over the whole mesh decides the escalation for the whole
    batch, as the unsharded call decides it.

    The leading batch axis of c_coeffs / n_coeffs / dt must divide over
    the mesh's ``'batch'`` dimension, and *chunk_size* must divide each
    rank's rows.  Returns (batch, n_nops) as a DTensor placed
    ``[Shard(0), Replicate()]``, differentiable in the tensors of *p*: a
    rank's gradient is that of its rows (the module docstring)."""
    Shard, Replicate = _dtensor_module().Shard, _dtensor_module().Replicate
    device = p.c_opers.device
    mode = config.contraction_mode(device, contract)
    spectrum, omega, weights = _frequency_share(spectrum, omega, mesh,
                                                device)
    partial = _partial_infidelity(_replicated(_batch_rows(p, mesh), mesh),
                                  spectrum, omega, weights, mesh, chunk_size,
                                  mode, escalation_tol, None)
    infid = _SumOverOmega.apply(partial, mesh)
    return _dtensor(infid, mesh, [Shard(0), Replicate()])


def sharded_error_transfer_matrix(p: functional.PulseArrays, spectrum, omega,
                                  basis: Basis, mesh,
                                  second_order: bool = False):
    """Batched error transfer matrices (batch, n_b, n_b) with the pulse
    batch split over the mesh's ``'batch'`` dimension; the operators,
    spectrum and frequencies stay whole, and the ranks of one ``'batch'``
    coordinate repeat the same work, as the JAX package's replicated
    frequencies do.  No collective: a DTensor placed ``[Shard(0),
    Replicate()]``.  *basis* is the :class:`~.basis.Basis` of
    ``p.basis``."""
    dtensor = _dtensor_module()
    device = p.c_opers.device
    if isinstance(omega, dtensor.DTensor):
        omega = _gather(omega.to_local(), mesh, 'omega', -1)
    if isinstance(spectrum, dtensor.DTensor):
        spectrum = _gather(spectrum.to_local(), mesh, 'omega', -1)
    etm = functional.batched_error_transfer_matrix(
        _batch_rows(p, mesh), spectrum, _real(omega, device), basis,
        second_order)
    return _dtensor(etm, mesh, [dtensor.Shard(0), dtensor.Replicate()])


# -----------------------------------------------------------------------------
# GRAPE-style optimal-control training step (batch + omega sharded)
# -----------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def make_grape_step(learning_rate: float = 1e-2,
                    chunk_size: Optional[int] = None,
                    contract: Optional[str] = None,
                    escalation_tol: float = config.ESCALATION_TOL):
    """A gradient-descent step on a batch of pulses: the loss is the summed
    leading-order infidelity (:func:`.functional.batched_infidelity`),
    its gradient comes from ``torch.autograd`` through the
    diagonalization, the propagators and the frequency-lattice
    contraction.

    Returns ``step(c_coeffs, p: PulseArrays, spectrum, omega)`` ->
    (updated c_coeffs, loss), on plain tensors; batch axis on c_coeffs /
    n_coeffs / dt.
    """
    def step(c_coeffs, p, spectrum, omega):
        device = p.c_opers.device
        c = _real(c_coeffs, device).detach().requires_grad_(True)
        loss = functional.batched_infidelity(
            p._replace(c_coeffs=c), _real(spectrum, device),
            _real(omega, device), chunk_size, contract,
            escalation_tol).sum()
        grad, = torch.autograd.grad(loss, c)
        return (c - learning_rate * grad).detach(), loss.detach()

    return step


def _local_value_and_grad(c: torch.Tensor, p, spectrum, omega, weights,
                          mesh, chunk_size, mode, escalation_tol,
                          max_dim) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this rank's partial loss, its gradient) for the rows *c*: the sum
    of :func:`_partial_infidelity` over the rows and noise operators."""
    c = c.detach().requires_grad_(True)
    partial = _partial_infidelity(p._replace(c_coeffs=c), spectrum, omega,
                                  weights, mesh, chunk_size, mode,
                                  escalation_tol, max_dim).sum()
    grad, = torch.autograd.grad(partial, c)
    return partial.detach(), grad


def _sum_over_omega(loss: torch.Tensor, grad: torch.Tensor, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial loss and gradient summed over ``'omega'`` in one
    buffer: the partial losses of one row add up to its loss."""
    buf = _collective(torch.cat([grad.flatten(), loss.reshape(1)]), mesh,
                      'omega', 'sum')
    return buf[-1], buf[:-1].view_as(grad)


def grape_step(c_coeffs, p: functional.PulseArrays, spectrum, omega,
               mesh=None, learning_rate: float = 1e-2,
               chunk_size: Optional[int] = None,
               contract: Optional[str] = None,
               escalation_tol: float = config.ESCALATION_TOL):
    """One GRAPE step (:func:`make_grape_step`), with *mesh* sharded: the
    pulse batch over ``'batch'``, the frequencies over ``'omega'``.

    Each rank backpropagates the loss of its rows at its frequencies;
    one SUM over ``'omega'`` of [gradient rows, partial loss] completes
    both, and one SUM over ``'batch'`` the loss.  Returns the new
    c_coeffs as a DTensor placed ``[Shard(0), Replicate()]`` and the loss
    replicated; without a mesh, plain tensors."""
    if mesh is None:
        return make_grape_step(learning_rate, chunk_size, contract,
                               escalation_tol)(c_coeffs, p, spectrum, omega)
    dtensor = _dtensor_module()
    device = p.c_opers.device
    mode = config.contraction_mode(device, contract)
    spectrum, omega, weights = _frequency_share(spectrum, omega, mesh,
                                                device)
    c = _block(_real(c_coeffs, device), mesh, 'batch', 0)
    loss, grad = _local_value_and_grad(c, _batch_rows(p, mesh), spectrum,
                                       omega, weights, mesh, chunk_size,
                                       mode, escalation_tol, None)
    loss, grad = _sum_over_omega(loss, grad, mesh)
    loss = _collective(loss.reshape(1).clone(), mesh, 'batch', 'sum')[0]
    return (_dtensor(c - learning_rate * grad, mesh,
                     [dtensor.Shard(0), dtensor.Replicate()]),
            _dtensor(loss, mesh, [dtensor.Replicate(), dtensor.Replicate()]))
