"""Device meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``: the axis names ``data`` (data
parallelism) and ``model`` (tensor parallelism, and the distributed LOOPS
operator's worker axis) on a ``torch.distributed.device_mesh.DeviceMesh``.
Building a mesh touches no device state until it is called.

A mesh rides on the process group that the launcher initialised, one
process per rank.  Its backend is the launcher's choice, made with
:func:`backend_for` and never switched here:

  * ``gloo`` on the CPU;
  * ``nccl`` on CUDA when every rank has a GPU of its own (NCCL refuses two
    ranks on one device);
  * otherwise ``gloo`` with CUDA tensors, which stages each collective
    through host memory: the case of several ranks sharing one card.

A 1 x 1 mesh needs no launcher: :func:`make_test_mesh` then initialises a
single-rank group on a ``HashStore``.  ``make_production_mesh`` comes with
the dry-run (ROADMAP A.13's item on ``launch/dryrun.py``).

:class:`P` is the port's ``PartitionSpec`` and :func:`abstract_mesh` its
``AbstractMesh``: the sharding rules of :mod:`repro_torch.dist.sharding`
read only a mesh's axis names and sizes, so they run without a process
group on either.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.engine import resolve_device

__all__ = ["P", "AbstractMesh", "abstract_mesh", "axis_sizes",
           "backend_for", "make_test_mesh", "dp_axes", "flat_axes",
           "all_gather_cat"]


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``
    (whole), a mesh axis name, or a tuple of names (their devices in mesh
    order, flattened); missing trailing entries are ``None``, so ``P()``
    is replicated.  Equal to the reference's ``PartitionSpec`` entry for
    entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group, read as a
    ``DeviceMesh`` is (``mesh_dim_names``, ``shape``)."""

    shape: tuple
    mesh_dim_names: tuple


def abstract_mesh(axis_shapes, axis_names) -> AbstractMesh:
    """A device-free mesh for the sharding rules (the reference's
    ``compat.abstract_mesh``)."""
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} sizes for {len(axis_names)} "
                         "axis names")
    return AbstractMesh(tuple(int(n) for n in axis_shapes),
                        tuple(axis_names))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`,
    in mesh order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def backend_for(device, world_size: int) -> str:
    """The process-group backend for ``world_size`` ranks on one host's
    ``device`` type (module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_test_mesh(data: int = 2, model: int = 2, *,
                   device=None) -> DeviceMesh:
    """A ``data x model`` mesh with dim names ``("data", "model")`` over
    the initialised process group, whose world size must be ``data *
    model``; ranks are laid out row-major (rank = d * model + m).  A 1 x 1
    mesh initialises its own single-rank group when there is none.
    ``device=None`` means CUDA and raises without a GPU."""
    dev = resolve_device(device)
    world = data * model
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(
                f"a {data}x{model} mesh needs {world} processes: initialise "
                "torch.distributed in each rank first, with the backend "
                "backend_for(device, world_size) names")
        dist.init_process_group(backend_for(dev, 1), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != world:
        raise ValueError(f"a {data}x{model} mesh needs a world of {world} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(world).view(data, model),
                      mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axis name(s): ('pod', 'data') on multi-pod
    meshes."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def flat_axes(mesh) -> tuple:
    """All axes, for fully-flat (ZeRO) sharding."""
    return tuple(mesh.mesh_dim_names)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in
    rank order (one tensor-form all-gather, which gloo takes for CUDA
    tensors too)."""
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]))
    # (not torch 2.13's all_gather_single, after which two-rank gloo
    # groups now and then aborted in their teardown)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim).contiguous()
