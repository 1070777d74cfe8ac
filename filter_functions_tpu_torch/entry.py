"""Entry points of the PyTorch port, the counterparts of the
repository's ``__graft_entry__.py`` (which starts the JAX package), with
the same names and the same problems.

* :func:`entry` -- the flagship forward step: ``functional.infidelity``
  of the 4-qubit QFT pulse at 1000 frequencies on one device.  On CUDA
  it takes the default contraction route ('ozaki') and launches the
  ``dword_digits`` kernel once per call.
* :func:`dryrun_multichip` -- one sharded GRAPE step and
  ``sharded_batched_infidelity`` on an n-device (batch, omega) mesh at
  tiny shapes (:func:`dryrun_problem`), one spawned rank per device
  (:func:`.parallel.ranks.run_ranks`).

Both run on the card unless the caller passes ``device='cpu'``; without a
card the default raises (:func:`.config.resolve_device`).  On the card::

    python -m filter_functions_tpu_torch.entry

runs the flagship step and the dry run on every card of the host.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import config, convert, functional, parallel
from .basis import Basis
from .models import qft
from .ops import dword
from .parallel import ranks
from .types import Device

__all__ = ['entry', 'dryrun_problem', 'dryrun_multichip']

#: Frequencies of the flagship step.
N_OMEGA = 1000


def entry(device: Device = config.DEFAULT_DEVICE):
    """Returns (fn, example_args): ``fn(*example_args)`` is the fidelity
    filter function and infidelity (18,) of the 4-qubit QFT pulse at 1000
    frequencies in geomspace(1e-2, 1e2) under S = 1e-4/omega, with the
    pulse, spectrum and frequencies on *device*."""
    device = config.resolve_device(device)
    p = qft.qft_pulse_arrays(4, device=device)
    omega = np.geomspace(1e-2, 1e2, N_OMEGA)
    return functional.infidelity, (p, torch.tensor(1e-4 / omega,
                                                   device=device),
                                   torch.tensor(omega, device=device))


def dryrun_problem(n_devices: int) -> Tuple[int, dict, np.ndarray,
                                            np.ndarray]:
    """The tiny one-qubit optimal-control problem of the dry run for
    *n_devices* devices, as numpy arrays: (batch axis of the mesh, the
    PulseArrays fields by name, omega, spectrum).

    d = 2, 3 segments of unit duration, X/2 and Y/2 controls with
    ``default_rng(0)`` normal coefficients, Z/2 noise of unit
    coefficients, a GGM basis; a batch of 2 pulses per mesh row, the mesh
    split (2, n/2) for an even n > 1, else (1, n); 4 frequencies per
    ``'omega'`` rank in linspace(0.5, 10), S = 1e-2/omega."""
    batch_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    rng = np.random.default_rng(0)
    d, n_dt, n_ctrl, n_nops = 2, 3, 2, 1
    batch = batch_axis * 2
    n_omega = (n_devices // batch_axis) * 4
    x = np.array([[0, 1], [1, 0]], complex) / 2
    y = np.array([[0, -1j], [1j, 0]]) / 2
    z = np.diag([1., -1.]).astype(complex) / 2
    arrays = dict(c_opers=np.stack([x, y]),
                  c_coeffs=rng.standard_normal((batch, n_ctrl, n_dt)),
                  n_opers=z[None], n_coeffs=np.ones((batch, n_nops, n_dt)),
                  dt=np.ones((batch, n_dt)), basis=Basis.ggm(d).np)
    omega = np.linspace(0.5, 10, n_omega)
    return batch_axis, arrays, omega, 1e-2 / omega


def dryrun_multichip(n_devices: int,
                     device: Device = config.DEFAULT_DEVICE) -> List[dict]:
    """One sharded GRAPE step (learning rate 1e-3) and
    ``sharded_batched_infidelity`` of :func:`dryrun_problem` on an
    *n_devices* (batch, omega) mesh, in *n_devices* spawned ranks.

    On CUDA the ranks take one card each over 'nccl' when the host has
    *n_devices* cards, and share the cards over 'gloo' when it has fewer;
    ``device='cpu'`` runs them over 'gloo' on the CPU.  Raises on a
    non-finite loss or infidelity and on a rank that fails; prints one
    line when every rank has finished.  Returns the ranks' results of
    :func:`_dryrun_rank` in rank order."""
    device = config.resolve_device(device)
    backend = ('nccl' if device.type == 'cuda'
               and torch.cuda.device_count() >= n_devices else 'gloo')
    results = ranks.run_ranks(_dryrun_rank, n_devices, n_devices,
                              device.type, backend=backend)
    print('dryrun: sharded GRAPE step + batched_infidelity over '
          f'{results[0]["mesh"]} (batch, omega) mesh ok')
    return results


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    """One rank of the dry run, in a process group of *n_devices* ranks:
    its mesh shape and coordinate, its block of the new control
    coefficients, the loss, its block of the infidelities and the
    ``dword_digits`` launches of the two calls."""
    device = torch.device('cpu')
    if device_type == 'cuda':
        device = torch.device('cuda',
                              dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    batch_axis, arrays, omega, spectrum = dryrun_problem(n_devices)
    mesh = parallel.make_mesh(n_devices, batch=batch_axis, device=device)
    p = convert.pulse_arrays_from_numpy(arrays, device=device)
    omega = torch.tensor(omega, device=device)
    spectrum = torch.tensor(spectrum, device=device)
    dword.launches = 0
    new, loss = parallel.grape_step(p.c_coeffs, p, spectrum, omega, mesh,
                                    learning_rate=1e-3)
    infids = parallel.sharded_batched_infidelity(p, spectrum, omega, mesh)
    launches = dword.launches
    new, loss, infids = (x.to_local().cpu() for x in (new, loss, infids))
    if not torch.isfinite(loss).all():
        raise RuntimeError('training step produced non-finite loss')
    if not torch.isfinite(infids).all():
        raise RuntimeError('sharded batched infidelity produced non-finite '
                           'values')
    return dict(mesh=tuple(mesh.shape),
                coordinate=tuple(mesh.get_coordinate()),
                c_coeffs=new.numpy(), loss=loss.item(),
                infidelity=infids.numpy(), launches=launches)


if __name__ == '__main__':
    fn, args = entry()
    out = fn(*args)
    print('entry() ok:', out.cpu().numpy())
    dryrun_multichip(torch.cuda.device_count())
    print('dryrun_multichip ok')
