"""Sharding over a (batch, omega) device mesh (counterpart of
``filter_functions_tpu.parallel``).

The JAX package shards over a ``jax.sharding.Mesh`` and GSPMD inserts
the collectives; the port runs one process per device over
``torch.distributed`` (``torch.distributed.device_mesh.DeviceMesh``),
splits the frequency grid and the pulse batch by each rank's mesh
coordinate, and places every collective itself (:mod:`.sharding`).
"""
from .optimize import OptimizationResult, optimize_pulse
from .sharding import (make_mesh, shard_omega, sharded_filter_function,
                       sharded_infidelity, sharded_batched_infidelity,
                       sharded_error_transfer_matrix, grape_step,
                       make_grape_step)

__all__ = ['make_mesh', 'shard_omega', 'sharded_filter_function',
           'sharded_infidelity', 'sharded_batched_infidelity',
           'sharded_error_transfer_matrix', 'grape_step',
           'make_grape_step', 'OptimizationResult', 'optimize_pulse']
