"""Placements of the distributed LOOPS operator over a device mesh.

Port of the LOOPS half of ``repro/dist/sharding.py``
(``loops_axis_spec``, ``loops_in_specs``, ``loops_out_spec``,
``loops_shardings``).  A ``PartitionSpec`` becomes a
``torch.distributed.tensor`` placement on the operator's *worker mesh*,
the 1-D mesh of its worker axis (:func:`worker_mesh`): ``P(axis)`` is
``Shard(0)`` there and ``P()`` is ``Replicate()``.  The model half
(``param_specs``, the batch and cache specs, ``flat_grad_specs``,
``constrain``) is ROADMAP A.13.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

__all__ = ["loops_axis_spec", "worker_mesh", "loops_in_specs",
           "loops_out_spec", "loops_shardings", "LoopsSharding"]


def loops_axis_spec(axis):
    """Normalise a SpMM worker axis (name or tuple of names) to one name
    or a tuple of two or more."""
    if isinstance(axis, str):
        return axis
    axes = tuple(axis)
    if not axes:
        raise ValueError("the worker axis names no mesh axis")
    return axes[0] if len(axes) == 1 else axes


def worker_mesh(mesh: DeviceMesh, axis) -> DeviceMesh:
    """The 1-D mesh of the worker ``axis``: the axis itself, or the named
    axes flattened in mesh order (rank ``d`` along the flattened axis is the
    reference's device ``d`` of ``P(("data", "model"))``).  Its group,
    size and local rank are the operator's collective group, ``D`` and
    worker index."""
    a = loops_axis_spec(axis)
    if isinstance(a, str):
        return mesh[a]
    return mesh[a]._flatten()


def loops_in_specs(axis):
    """Placements on the worker mesh of ``distributed_spmm``'s operands, in
    :class:`~repro_torch.core.distributed.ShardedLoops` field order

        (row_ids, col_idx, vals, tile_rows, tile_cols, tile_vals, B)

    -- the six stacked workload arrays shard their leading (worker) dim, one
    CSR or BCSR chunk a rank; the dense ``B`` is replicated (the paper's
    broadcast)."""
    loops_axis_spec(axis)
    return (Shard(0),) * 6 + (Replicate(),)


def loops_out_spec(axis) -> Placement:
    """Each rank's output rows stay row-sharded; assembly (when asked for)
    concatenates the exclusively owned row slices -- paper §3.4's
    conflict-free row ownership, scaled out."""
    loops_axis_spec(axis)
    return Shard(0)


@dataclasses.dataclass(frozen=True)
class LoopsSharding:
    """A placement on a worker mesh: the port's ``NamedSharding``."""

    mesh: DeviceMesh
    placement: Placement

    def put(self, stacked: np.ndarray) -> DTensor:
        """``stacked`` (leading dim = worker) as a ``DTensor``: this rank's
        row copied to its device once, the global shape ``stacked``'s."""
        d = self.mesh.get_local_rank()
        local = torch.as_tensor(np.ascontiguousarray(stacked[d:d + 1]),
                                device=self.mesh.device_type)
        return DTensor.from_local(local, self.mesh, [self.placement],
                                  run_check=False,
                                  shape=torch.Size(stacked.shape),
                                  stride=local.stride())


def loops_shardings(mesh: DeviceMesh, axis) -> tuple:
    """:class:`LoopsSharding` s to put a ``ShardedLoops``' six stacked
    arrays on the ranks before repeated SpMM calls (each rank holds its own
    row, transferred once)."""
    wm = worker_mesh(mesh, axis)
    return tuple(LoopsSharding(wm, p) for p in loops_in_specs(axis)[:-1])
