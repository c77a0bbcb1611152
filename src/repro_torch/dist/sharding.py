"""Mesh-axis conventions of the port: where the LM's parameters, batches,
caches and optimizer state, and the distributed LOOPS operator's operands,
sit on a device mesh.

Port of ``repro/dist/sharding.py``.  A spec is a :class:`P` (the port's
``PartitionSpec``, from :mod:`repro_torch.launch.mesh`); the rules read only
a mesh's axis names and sizes, so they run on an ``AbstractMesh`` too.

Model half:

* **params** (:func:`param_specs`): Megatron-style tensor parallelism over
  ``model``: column-split ``wq``/``wk``/``wv`` and the MLP's ``wi``/``wg``,
  row-split the ``wo`` s, vocab-split ``embed``/``unembed``.  The
  ``kv_aligned`` rule replicates a projection whose head count does not
  divide ``model``; ``tp_rule="naive"`` shards blindly.  The rules read the
  port's own structure: per-layer ``(d_in, d_out)`` leaves named
  ``layers.<i>.attn.wq`` and so on, where the reference's stacked leaves
  carry a leading ``L`` (its spec is this one with ``None`` in front).
  MoE layers are expert-parallel: the ``(E, d_in, d_out)`` expert stacks
  split on ``E`` over ``model``, the shared MLP column/row as the dense
  MLP, the router and the shared gate whole.
* **batches** (:func:`train_batch_specs`, :func:`prefill_batch_specs`):
  the batch dim over the data axes (``('pod', 'data')`` on multi-pod
  meshes).
* **KV cache** (:func:`cache_specs`): ``(L, B, S, KV, hd)`` with the batch
  on the data axes and the KV heads on ``model`` when aligned.
* **optimizer**: flat ZeRO-1 rows over *all* axes
  (:func:`repro_torch.optim.adamw.opt_specs`, re-exported here);
  :func:`flat_grad_specs` is the gradient's layout at the reduce-scatter.

Eager PyTorch has no sharding propagation, so a spec becomes a
:class:`Sharding` on the mesh (:func:`spec_to_sharding`): its
``Shard``/``Replicate`` placements, and the rank's slice of a full tensor
(:meth:`Sharding.local`) and the full tensor gathered back from the slices
(:meth:`Sharding.gather`).  Tensors are already local, so :func:`constrain`
checks each rank's shard against its spec and raises on a mismatch.

LOOPS half (``loops_axis_spec``, ``loops_in_specs``, ``loops_out_spec``,
``loops_shardings``): a ``PartitionSpec`` becomes a placement on the
operator's *worker mesh*, the 1-D mesh of its worker axis
(:func:`worker_mesh`): ``P(axis)`` is ``Shard(0)`` there and ``P()`` is
``Replicate()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..configs.base import ModelConfig
from ..launch.mesh import P, all_gather_cat, axis_sizes, dp_axes, flat_axes
from ..optim.adamw import opt_specs  # noqa: F401  (re-export: one spec home)

__all__ = [
    "P", "model_axis", "model_size", "data_axis", "dp_size",
    "param_specs", "train_batch_specs", "prefill_batch_specs", "cache_specs",
    "logits_spec", "flat_grad_specs", "opt_specs",
    "Sharding", "spec_to_sharding", "constrain", "model_layout",
    "loops_axis_spec", "worker_mesh", "loops_in_specs",
    "loops_out_spec", "loops_shardings", "LoopsSharding"]


# ---------------------------------------------------------------------------
# axis helpers
# ---------------------------------------------------------------------------

def model_axis(mesh) -> str | None:
    """The tensor-parallel axis name, or None on a mesh without one."""
    return "model" if "model" in mesh.mesh_dim_names else None


def model_size(mesh) -> int:
    m = model_axis(mesh)
    return axis_sizes(mesh)[m] if m else 1


def data_axis(mesh):
    """The data-parallel spec entry: one name, or a tuple of names
    (``('pod', 'data')``) that flattens all replica axes into one dim."""
    axes = dp_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def _shapes(tree) -> dict:
    """``{name: shape}`` of an ``nn.Module``'s parameters or of a mapping
    of names to tensors or shapes."""
    items = (tree.named_parameters() if hasattr(tree, "named_parameters")
             else tree.items())
    return {name: tuple(getattr(x, "shape", x)) for name, x in items}


def _nones(k: int) -> tuple:
    return (None,) * max(k, 0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(params, mesh, cfg: ModelConfig) -> dict:
    """``{name: P}`` for an LM's parameters (an ``nn.Module`` or a
    mapping of names to tensors or shapes, at their full shapes).

    Rules key off the leaf's name (``wq``/``wk``/``wv``/``wo``, ``wi``/
    ``wg``, ``embed``/``unembed``) and rank: a layer's projections are 2-D
    ``(d_in, d_out)``, a MoE layer's expert stacks 3-D ``(E, d_in,
    d_out)``: ``P(m, None, None)`` when ``model`` divides ``E``, its
    shared MLP as the dense MLP, its ``router`` and ``shared_gate``
    replicated.  An RWKV block's leaves fall under the same name rules,
    as the reference's do: the time mix's ``wg`` splits its columns and
    its ``wo`` its rows, and everything else (``wr``/``wk``/``wv``, the
    channel mix's ``wk``/``wv``/``wr``, the mixing vectors and adapters)
    is replicated.  Anything unmatched (norm scales) is replicated.  The
    reference's ``patch_proj`` rule comes with its family (ROADMAP A.13,
    item 7f)."""
    shapes = _shapes(params)
    m = model_axis(mesh)
    if m is None:
        return {name: P() for name in shapes}
    msize = model_size(mesh)
    naive = cfg.tp_rule == "naive"
    heads_ok = naive or (cfg.num_heads and cfg.num_heads % msize == 0)
    kv_ok = naive or (cfg.num_kv_heads and cfg.num_kv_heads % msize == 0)

    def div(n: int) -> bool:
        return naive or n % msize == 0

    def rule(name: str, shape: tuple):
        names = name.split(".")
        leaf, nd = names[-1], len(shape)
        if leaf in ("embed", "unembed") and nd == 2:
            return P(m, None) if div(shape[0]) else P()
        if "attn" in names:
            if leaf == "wq" and nd == 2:
                return P(None, m) if heads_ok else P()
            if leaf in ("wk", "wv") and nd == 2:
                return P(None, m) if kv_ok else P()
            if leaf == "wo" and nd == 2:
                return P(m, None) if heads_ok else P()
            return P()
        if "moe" in names:
            if nd == 3 and leaf in ("wi", "wg", "wo"):
                return P(m, None, None) if div(shape[0]) else P()
            if nd == 2 and leaf in ("wi", "wg"):    # the shared MLP
                return P(None, m) if div(shape[1]) else P()
            if nd == 2 and leaf == "wo":
                return P(m, None) if div(shape[0]) else P()
            return P()   # router, shared_gate
        if leaf in ("wi", "wg") and nd == 2:
            return P(None, m) if div(shape[1]) else P()
        if leaf == "wo" and nd == 2:
            return P(m, None) if div(shape[0]) else P()
        return P()

    return {name: rule(name, shape) for name, shape in shapes.items()}


# ---------------------------------------------------------------------------
# batches / activations / caches
# ---------------------------------------------------------------------------

def train_batch_specs(batch, mesh) -> dict:
    """Microbatched train batch ``(n_mb, mb, ...)``: the microbatch axis
    stays whole, each microbatch's batch dim shards over the data axes."""
    d = data_axis(mesh)
    return {k: P(None, d, *_nones(len(s) - 2))
            for k, s in _shapes(batch).items()}


def prefill_batch_specs(batch, mesh) -> dict:
    """Serving batch ``(B, ...)``: batch dim over the data axes."""
    d = data_axis(mesh)
    return {k: P(d, *_nones(len(s) - 1)) for k, s in _shapes(batch).items()}


def cache_specs(cache, mesh, cfg: ModelConfig) -> dict:
    """Decode cache ``{"k", "v"}``, each ``(L, B, S, KV, hd)``: the batch
    on the data axes, and the KV heads on ``model`` when the head count is
    aligned (the rule of ``wk``/``wv``, including the naive ablation: a
    cache is sharded as the projection that writes it).  Any other leaf
    (the ssm family's state ``{"x_tm", "s", "x_cm"}``) has its batch on
    the data axes and is whole on ``model``."""
    m = model_axis(mesh)
    d = data_axis(mesh)
    kv_ok = (m is not None and cfg.num_kv_heads
             and (cfg.tp_rule == "naive"
                  or cfg.num_kv_heads % model_size(mesh) == 0))

    def rule(name, shape):
        if name in ("k", "v") and len(shape) == 5 and kv_ok:
            return P(None, d, None, m, None)
        return P(None, d, *_nones(len(shape) - 2))

    return {k: rule(k, s) for k, s in _shapes(cache).items()}


def logits_spec(mesh) -> P:
    """(B, vocab) logits: batch over the data axes, vocab gathered."""
    return P(data_axis(mesh), None)


def flat_grad_specs(params, mesh) -> dict:
    """The flat fp32 gradient layout ``(n_devices, cols)`` sharded over ALL
    axes: a microbatch's gradient reduce-scattered into it is the
    reduce-scatter half of the ZeRO-1 schedule (``optim/adamw.py``)."""
    spec = P(flat_axes(mesh), None)
    return {name: spec for name in _shapes(params)}


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A :class:`P` on a ``DeviceMesh``: the port's ``NamedSharding``.
    ``placements`` holds one ``Shard(dim)`` / ``Replicate()`` per mesh
    dim."""

    mesh: Any
    spec: P
    placements: tuple

    def _split(self, ndim: int):
        """``(dim, axes)`` for each sharded tensor dim."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"{ndim}-d tensor has dims")
        return [(d, _entry_axes(e)) for d, e in enumerate(self.spec)
                if _entry_axes(e)]

    def _index(self, axes) -> tuple:
        """This rank's index among ``axes``' devices (mesh order), and
        their count."""
        sizes = axis_sizes(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        return idx, math.prod(sizes[a] for a in axes)

    def local_shape(self, shape) -> tuple:
        """The shard's shape of a tensor of global ``shape``; a sharded dim
        must divide evenly."""
        out = list(shape)
        sizes = axis_sizes(self.mesh)
        for d, axes in self._split(len(shape)):
            n = math.prod(sizes[a] for a in axes)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{n} ways ({self.spec})")
            out[d] = shape[d] // n
        return tuple(out)

    def global_shape(self, local_shape) -> tuple:
        out = list(local_shape)
        sizes = axis_sizes(self.mesh)
        for d, axes in self._split(len(local_shape)):
            out[d] *= math.prod(sizes[a] for a in axes)
        return tuple(out)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``: a view of it."""
        shape = self.local_shape(full.shape)
        for d, axes in self._split(full.ndim):
            idx, _ = self._index(axes)
            full = full.narrow(d, idx * shape[d], shape[d])
        return full

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (an all-gather over the
        mesh dims of each sharded dim); ``local`` itself when replicated."""
        for d, axes in self._split(local.ndim):
            local = all_gather_cat(local, worker_mesh(self.mesh, axes)
                                   .get_group(), dim=d)
        return local

    def gather_first(self, local: torch.Tensor):
        """The full tensor on the mesh's first rank (coordinate 0 on every
        axis), ``None`` on the others: one ``gather`` over the sharded
        dim's axes, in which only the ranks at coordinate 0 off those axes
        take part (the others hold copies).  One sharded dim at most."""
        split = self._split(local.ndim)
        if len(split) > 1:
            raise ValueError(f"gather_first takes one sharded dim, not "
                             f"{self.spec}")
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        on = {a for _, axes in split for a in axes}
        if any(c for a, c in coord.items() if a not in on):
            return None
        if not split:
            return local
        (d, axes), = split
        wm = worker_mesh(self.mesh, axes)
        group, first = wm.get_group(), wm.get_local_rank() == 0
        parts = ([torch.empty_like(local) for _ in range(wm.size())]
                 if first else None)
        dist.gather(local.contiguous(), parts,
                    dst=dist.get_global_rank(group, 0), group=group)
        return torch.cat(parts, dim=d) if first else None


def _map_specs(tree, fn):
    if isinstance(tree, P):
        return fn(tree)
    return {k: _map_specs(v, fn) for k, v in tree.items()}


def spec_to_sharding(spec_tree, mesh):
    """A tree (nested dicts) of :class:`P` -> the same tree of
    :class:`Sharding` on ``mesh``."""
    names = tuple(mesh.mesh_dim_names)

    def one(spec: P) -> Sharding:
        placements = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            for a in _entry_axes(entry):
                placements[names.index(a)] = Shard(d)
        return Sharding(mesh, spec, tuple(placements))
    return _map_specs(spec_tree, one)


def constrain(tree: Mapping, mesh, spec_tree: Mapping,
              shapes: Mapping) -> Mapping:
    """Check that each of this rank's tensors in ``tree`` (nested dicts) is
    its shard of a tensor of the global shape in ``shapes`` under its spec
    in ``spec_tree``; raise ``ValueError`` on the first that is not, and
    return ``tree``.  The reference's ``with_sharding_constraint``: eager
    tensors are already placed, so a wrong placement is a bug to report,
    not a reshard to run."""
    shardings = spec_to_sharding(spec_tree, mesh)

    def walk(t, sh, shape, path):
        if isinstance(t, Mapping):
            for k, v in t.items():
                walk(v, sh[k], shape[k], path + (str(k),))
            return
        want = sh.local_shape(tuple(shape))
        if tuple(t.shape) != want:
            raise ValueError(f"{'/'.join(path)}: local shape "
                             f"{tuple(t.shape)}, but {sh.spec} of "
                             f"{tuple(shape)} on this mesh gives {want}")
    walk(tree, shardings, shapes, ())
    return tree


def model_layout(mesh, cfg: ModelConfig, specs: Mapping, shapes: Mapping):
    """The :class:`repro_torch.models.layers.MeshLayout` of an LM whose
    parameters (global ``shapes``) are sharded by ``specs``
    (:func:`param_specs`) on ``mesh``: the model and data groups and this
    rank's heads, kv heads, FFN (a MoE layer's: its shared MLP's),
    experts, RWKV gate columns and vocabulary slices.  A split that would
    cut a head (``tp_rule="naive"`` on a count that ``model`` does not
    divide) raises ``NotImplementedError``: the eager layers compute whole
    heads on each rank."""
    from ..models.layers import MeshLayout
    m = model_axis(mesh)
    msize = model_size(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    mrank = coord[m] if m else 0
    dp = dp_axes(mesh)

    def split(name: str, dim: int) -> bool:   # (a size-1 axis splits nothing)
        spec = specs[name]
        return (msize > 1 and len(spec) > dim
                and m in _entry_axes(spec[dim]))

    def heads_of(count: int, what: str) -> tuple:
        if count % msize:
            raise NotImplementedError(
                f"{what}: {count} heads do not split {msize} ways; the "
                "eager layers need whole heads on each rank (tp_rule "
                f"{cfg.tp_rule!r})")
        per = count // msize
        return (mrank * per, (mrank + 1) * per)

    heads = kv_take = None
    if "layers.0.attn.wq" in specs and split("layers.0.attn.wq", 1):
        heads = heads_of(cfg.num_heads, "wq")
        if split("layers.0.attn.wk", 1):
            heads_of(cfg.num_kv_heads, "wk")
        else:   # each local q head reads its own kv head (GQA h // rep)
            rep = cfg.num_heads // cfg.num_kv_heads
            kv_take = tuple(h // rep for h in range(*heads))
    experts = gate = None
    if "layers.0.moe.wi" in specs:
        if split("layers.0.moe.wi", 0):
            per = shapes["layers.0.moe.wi"][0] // msize
            experts = (mrank * per, (mrank + 1) * per)
        ff = ("layers.0.moe.shared.wi" in specs
              and split("layers.0.moe.shared.wi", 1))
    elif "layers.0.time_mix.wg" in specs:     # the ssm family
        ff = False
        if split("layers.0.time_mix.wg", 1):
            per = shapes["layers.0.time_mix.wg"][1] // msize
            gate = (mrank * per, (mrank + 1) * per)
    else:
        ff = split("layers.0.mlp.wi", 1)
    vocab = None
    if split("embed", 0):
        per = shapes["embed"][0] // msize
        vocab = (mrank * per, (mrank + 1) * per)
    return MeshLayout(
        mesh=mesh, specs=dict(specs), shapes=dict(shapes),
        model_group=mesh.get_group(m) if msize > 1 else None,
        model_rank=mrank, heads=heads, kv_take=kv_take,
        ff=ff, vocab=vocab, experts=experts, gate=gate,
        data_group=(worker_mesh(mesh, dp).get_group()
                    if dp and dp_size(mesh) > 1 else None))


# ---------------------------------------------------------------------------
# LOOPS row-shard specs (paper §3.5 coarse level x mesh sharding)
# ---------------------------------------------------------------------------


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
