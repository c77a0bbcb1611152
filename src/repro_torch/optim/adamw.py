"""AdamW on the flat ZeRO-1 layout (port of ``repro/optim/adamw.py``).

Every parameter's optimizer triple (fp32 master copy, first and second
moments) lives in the reference's *flat* representation: ravel -> pad ->
reshape ``(n_shards, cols)``.  On one device ``n_shards`` is 1.  On a mesh
of D ranks (fully-flat ZeRO-1, :func:`opt_specs`) the *full* parameter is
flattened to ``(D, cols)`` and rank ``r`` (its index over all mesh axes,
in mesh order) holds row ``r`` of master, m and v as a ``(1, cols)``
tensor, whatever the parameter's own tensor-parallel split; so a
checkpoint of the gathered rows is the reference's unsharded layout, the
same at every mesh shape of D ranks.  The data flow of a step on a mesh:

  gradients (each rank's tensor-parallel shard, its data rows' sum)
    -> reduce-scatter over all D ranks into the flat rows
       (``dist/step.py``, once per microbatch)
    -> the Adam update on the rows (elementwise, no collective; the
       clipping norm is one all-reduce of the rows' sums of squares)
    -> all-gather of the master rows, then each rank slices out its
       tensor-parallel shard and rounds it to the parameter's dtype.

The update is elementwise PyTorch on the flat tensors, as the reference's
is jnp outside any kernel.  The reference's jit donates the parameters and
the state; here the update runs in place: the moments, the master copy and
the gradient accumulator are updated where they lie, and the master is
written back into the (bf16) parameters.

The state is ``{"flat": {name: {"master", "m", "v"}}, "count": int32
0-d}``, keyed by the parameters' names (``nn.Module.named_parameters``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn

from ..launch.mesh import P, all_gather_cat, flat_axes

__all__ = ["OptConfig", "init_opt_state", "opt_specs", "apply_updates",
           "to_flat", "from_flat", "lr_at", "global_norm_flat"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(opt: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32 (a 0-d tensor on ``step``'s
    device when ``step`` is a tensor)."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0.0,
                       1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = opt.min_lr_frac + (1 - opt.min_lr_frac) * cos
    return opt.lr * warm * frac


def _flat_cols(size: int, n_shards: int) -> int:
    return math.ceil(size / n_shards)


def to_flat(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(…shape…) -> a new fp32 (n_shards, cols), zero-padded."""
    cols = _flat_cols(x.numel(), n_shards)
    flat = torch.zeros(n_shards * cols, dtype=F32, device=x.device)
    flat[:x.numel()] = x.detach().reshape(-1)
    return flat.reshape(n_shards, cols)


def from_flat(flat: torch.Tensor, shape, dtype) -> torch.Tensor:
    size = math.prod(shape) if shape else 1
    return flat.reshape(-1)[:size].reshape(shape).to(dtype, copy=True)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _zero_group(mesh, param_specs):
    """``(param shardings, flat group, rank, D)`` of a mesh: the rows'
    all-axes group and this rank's row.  (Imported here: the sharding
    module re-exports :func:`opt_specs` from this one.)"""
    from ..dist.sharding import spec_to_sharding, worker_mesh
    flat = worker_mesh(mesh, flat_axes(mesh))
    return (spec_to_sharding(dict(param_specs), mesh), flat.get_group(),
            flat.get_local_rank(), flat.size())


def init_opt_state(params, n_shards: int, *, param_specs=None,
                   mesh=None) -> Dict:
    """Flat ZeRO state of ``params`` (an ``nn.Module`` or a mapping of
    names to tensors): master fp32 + m + v per parameter, on the
    parameter's device, plus the step count.  On a ``mesh`` of
    ``n_shards`` ranks, ``params`` are this rank's shards under
    ``param_specs``: each full parameter is gathered (one at a time) and
    the rank keeps its row of the flat layout."""
    named = _named(params)
    row = None
    if mesh is not None:
        shardings, _, r, d = _zero_group(mesh, param_specs)
        if d != n_shards:
            raise ValueError(f"{n_shards} shards on a mesh of {d} ranks")

        def row(name, x):
            full = shardings[name].gather(x.detach())
            return to_flat(full, n_shards)[r:r + 1].clone()

    def triple(name, x):
        master = to_flat(x, n_shards) if row is None else row(name, x)
        return {"master": master, "m": torch.zeros_like(master),
                "v": torch.zeros_like(master)}
    dev = next(iter(named.values())).device if named else None
    return {"flat": {name: triple(name, x) for name, x in named.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_specs(params, mesh) -> Dict:
    """Specs of the optimizer state: every flat leaf over ALL mesh axes
    (one row a rank), the count replicated."""
    spec = P(flat_axes(mesh), None)
    names = (dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else params)
    return {"flat": {name: {"master": spec, "m": spec, "v": spec}
                     for name in names},
            "count": P()}


def global_norm_flat(flat_tree: Mapping[str, torch.Tensor],
                     group=None) -> torch.Tensor:
    """The global norm of the flat gradients; with ``group`` (a mesh's
    all-axes group) the rows' sums of squares are summed over its ranks
    first."""
    total = None
    for g in flat_tree.values():
        sq = torch.sum(torch.square(g))
        total = sq if total is None else total + sq
    if group is not None:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, opt_state: Dict,
                  grads_flat: Mapping[str, torch.Tensor], opt: OptConfig,
                  param_specs=None, mesh=None):
    """One AdamW step on the flat state, in place; returns ``(params,
    opt_state, grad_norm)`` (the same objects, updated).  ``grads_flat``
    maps each parameter's name to its gradient in the flat fp32 layout
    (the train step's accumulator, which this scales in place); each
    parameter takes its new master copy, rounded to its dtype.  On a
    ``mesh`` the state and gradients are this rank's rows and ``params``
    its shards under ``param_specs`` (module docstring's data flow)."""
    named = _named(params)
    group = shardings = None
    if mesh is not None:
        shardings, group, _, _ = _zero_group(mesh, param_specs)
    opt_state["count"] += 1
    count = opt_state["count"].to(F32)
    lr = lr_at(opt, opt_state["count"])
    gnorm = global_norm_flat(grads_flat, group)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = opt.beta1, opt.beta2
    bc1 = 1 - torch.pow(b1, count)
    bc2 = 1 - torch.pow(b2, count)
    for name, x in named.items():
        tr = opt_state["flat"][name]
        g = grads_flat[name].mul_(scale)
        m = tr["m"].mul_(b1).add_(g * (1 - b1))
        v = tr["v"].mul_(b2).add_(g.square_().mul_(1 - b2))
        step_ = (m / bc1).div_((v / bc2).sqrt_().add_(opt.eps))
        step_.add_(opt.weight_decay * tr["master"])
        tr["master"].sub_(step_.mul_(lr))
        if mesh is None:
            x.view(-1).copy_(tr["master"].view(-1)[:x.numel()])
            continue
        sh = shardings[name]
        shape = sh.global_shape(x.shape)
        full = all_gather_cat(tr["master"], group)
        x.copy_(sh.local(full.view(-1)[:math.prod(shape)].view(shape)))
        del full
    return params, opt_state, gnorm
