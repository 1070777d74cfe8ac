"""Spawned ranks on one host: ``run_ranks(fn, n, *args)`` runs ``fn(*args)``
in *n* fresh processes, each a rank of one ``torch.distributed`` process
group, and returns their results in rank order.

The port runs one process per device (:mod:`.sharding`); a launcher such
as ``torchrun`` starts them for a user's program.  This module starts
them from inside one: the entry module's dry run
(:func:`..entry.dryrun_multichip`), the tests of :mod:`.sharding` and
the smoke run on the card use it.

* The group is initialized from a file in a working directory (no TCP
  port, which would collide between concurrent callers), with the
  backend the caller names: 'gloo' on the CPU or for several ranks on
  one card, 'nccl' for one card per rank.
* Arguments and results travel through files in that directory
  (``torch.save``): a large pickle written into a child's start-up pipe
  would wait until that child has imported its modules, one child after
  the other.
* Every rank runs on one CPU thread, so that a rank's reductions sum in
  the same order as a one-thread reference.
* A rank's exception, a non-zero exit or a world still running after
  *deadline* seconds (its ranks are then killed: a collective that some
  rank never joins would hang forever) raises ``RuntimeError`` with the
  ranks' tracebacks.
"""
from __future__ import annotations

import multiprocessing
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ['run_ranks']


def run_ranks(fn: Callable, world_size: int, *args, backend: str = 'gloo',
              init: bool = True, deadline: float = 600.0,
              workdir: Optional[str] = None) -> list:
    """``fn(*args)`` on each of *world_size* spawned ranks; returns their
    return values in rank order.

    *fn* must be importable by name (a function at the top level of a
    module), since a spawned process imports it afresh.  With *init*,
    each rank first joins a *backend* process group of *world_size*
    ranks, which it leaves when *fn* returns; ``torch.distributed.
    get_rank()`` then tells *fn* its rank.  Files go to *workdir*, or to
    a temporary directory that is removed afterwards.  The group's own
    operations time out after half of *deadline*.
    """
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_ranks(fn, world_size, *args, backend=backend,
                             init=init, deadline=deadline, workdir=tmp)
    work = Path(workdir)
    torch.save(args, work / 'args.pt')
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, str(work), backend,
                               init, deadline / 2))
             for rank in range(world_size)]
    for proc in procs:
        proc.start()
    end = time.monotonic() + deadline
    for proc in procs:
        proc.join(max(0.0, end - time.monotonic()))
    hung = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
        proc.join()
    errors = [f'rank {rank}:\n{(work / f"rank{rank}.err").read_text()}'
              for rank in range(world_size)
              if (work / f'rank{rank}.err').exists()]
    codes = [proc.exitcode for proc in procs]
    if hung or errors or any(codes):
        late = (f', ranks {hung} killed after {deadline} s' if hung
                else '')
        raise RuntimeError(f'{fn.__name__} on {world_size} ranks: exit '
                           f'codes {codes}{late}\n' + '\n'.join(errors))
    return [torch.load(work / f'rank{rank}.pt', weights_only=False)
            for rank in range(world_size)]


def _rank_main(fn, rank, world_size, workdir, backend, init, timeout):
    work = Path(workdir)
    try:
        args = torch.load(work / 'args.pt', weights_only=False)
        torch.set_num_threads(1)
        if init:
            dist.init_process_group(
                backend, init_method=f'file://{work / "group"}', rank=rank,
                world_size=world_size, timeout=timedelta(seconds=timeout))
        torch.save(fn(*args), work / f'rank{rank}.pt')
    except BaseException:
        (work / f'rank{rank}.err').write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
