"""Mixture-of-Experts layer (Qwen-MoE style: routed top-k + optional shared
experts) with a sort-based, capacity-bounded dispatch.

Port of ``repro/models/moe.py``.  Its two dispatch paths, as the
reference's code has them:

  * ``dispatch="gather"`` (the default): a 1-D integer scatter says which
    assignment fills each buffer slot, and the buffer fill and the token
    combine are gathers;
  * any other value (``"scatter"``): the buffer is filled by a wide
    ``index_put`` and the combine ``index_add`` s each contribution to its
    token (the reference's ablation).

The expert products are batched GEMMs with the experts on the leading
dim (:func:`repro_torch.models.layers._bmm_f32`: fp32 out of bf16
operands on the card, without widening the expert stacks).  Expert counts
are padded (:func:`pad_experts`; the LM pads to a multiple of 16):
padded experts get a -1e30 router logit and zero weights, so they are
inert.

Nothing here reads a tensor on the host or makes a shape from data (the
capacity is a Python expression of the token count), so a decode or
prefill step captures into a CUDA graph; dropped assignments go to one
extra slot past the buffer, sliced off after.

Expert parallelism (a :class:`~repro_torch.models.layers.MeshLayout`
whose ``experts`` is set: the stacks split over ``model``) is explicit,
as the port's other mesh layers: every model rank routes every token (the
router is whole) and dispatches them alike, runs its own experts' slots
of the buffer, and adds the contributions of those slots in fp32; the
ranks' sums are added over ``model`` in fp32 and rounded once, as
:func:`~repro_torch.models.layers.row_parallel` does.  On a mesh with
data ranks the layer first gathers every data rank's tokens: the
capacity and each token's place in its expert are the global batch's, as
the reference's jit computes them, so the tokens dropped are the ones one
device drops.  The zero rows that pad a batch the data ranks do not
divide (``rows``; they come last) are routed but take no slot and no
share of the capacity.  Each rank then combines its own tokens only.
The shared MLP is column/row split like the dense MLP (``layout.ff``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..launch.mesh import all_gather_cat
from . import layers
from .layers import F32, MeshLayout, _bmm_f32

__all__ = ["MoE", "moe_init", "moe_apply", "pad_experts"]


def pad_experts(num_experts: int, shards: int) -> int:
    return ((num_experts + shards - 1) // shards) * shards


class MoE(nn.Module):
    """``router (d, E)`` (always fp32), the expert stacks ``wi``/``wg (E,
    d, f)`` and ``wo (E, f, d)``, and with shared experts ``shared`` (an
    :class:`~repro_torch.models.layers.MLP` of width ``shared_d_ff``) and
    ``shared_gate (d, 1)``; ``E`` is the padded expert count
    (uninitialised; :func:`moe_init` draws them)."""

    def __init__(self, d_model: int, moe_d_ff: int, num_experts_padded: int,
                 dtype, device, num_shared: int = 0, shared_d_ff: int = 0):
        super().__init__()

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))
        e = num_experts_padded
        self.router = empty(d_model, e, dt=F32)
        self.wi = empty(e, d_model, moe_d_ff)
        self.wg = empty(e, d_model, moe_d_ff)
        self.wo = empty(e, moe_d_ff, d_model)
        if num_shared > 0:
            self.shared = layers.MLP(d_model, shared_d_ff, dtype, device)
            self.shared_gate = empty(d_model, 1)


@torch.no_grad()
def moe_init(gen: torch.Generator, d_model: int, moe_d_ff: int,
             num_experts: int, num_experts_padded: int, top_k: int, dtype,
             device, num_shared: int = 0, shared_d_ff: int = 0) -> MoE:
    """The reference's distributions: the router N(0, 1/d) in fp32, each
    expert stack N(0, 1/d_in) drawn in fp32 with its padded experts
    zeroed before the cast (one stack in fp32 at a time), the shared MLP
    and gate as ``layers.dense_init``."""
    del top_k   # the reference's signature; routing reads it at apply
    p = MoE(d_model, moe_d_ff, num_experts_padded, dtype, device,
            num_shared, shared_d_ff)
    p.router.copy_(layers.dense_init(gen, d_model, num_experts_padded, F32,
                                     device))
    for name in ("wi", "wg", "wo"):
        w = getattr(p, name)
        e, d_in, d_out = w.shape
        full = torch.randn((e, d_in, d_out), generator=gen, dtype=F32,
                           device=device) / math.sqrt(d_in)
        full[num_experts:] = 0.0
        w.copy_(full)
        del full
    if num_shared > 0:
        p.shared = layers.mlp_init(gen, d_model, shared_d_ff, dtype, device)
        p.shared_gate.copy_(layers.dense_init(gen, d_model, 1, dtype,
                                              device))
    return p


def _route(router_w: torch.Tensor, x2d: torch.Tensor, num_experts: int,
           top_k: int):
    """Top-k routing with softmax weights renormalised over the selected
    k.  Returns ``(weights (T, k) fp32, idx (T, k) int64)``."""
    logits = x2d.to(F32) @ router_w.to(F32)
    e_pad = router_w.shape[1]
    neg = torch.where(torch.arange(e_pad, device=x2d.device) < num_experts,
                      0.0, -1e30).to(F32)
    logits = logits + neg[None, :]
    weights, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx


def _sort_dispatch(idx: torch.Tensor, T: int, k: int, e_pad: int,
                   capacity: int):
    """Sort-based capacity dispatch: ``(slot, keep)`` per assignment (the
    ``(T, k)`` ids flattened).  ``slot = expert * capacity + position in
    expert`` for a kept assignment (tokens in order within an expert);
    one past the buffer, ``e_pad * capacity``, for a dropped one."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ar = torch.arange(T * k, device=idx.device)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=idx.device),
                          sorted_e[1:] != sorted_e[:-1]])
    start_marker = torch.where(is_start, ar, 0)
    seg_start = torch.cummax(start_marker, dim=0).values
    pos = torch.zeros_like(ar).index_put_((order,), ar - seg_start)
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, e_pad * capacity)
    return slot, keep


def capacity_of(T: int, top_k: int, e_pad: int,
                capacity_factor: float) -> int:
    """Slots an expert, the reference's expression in its order of
    operations, rounded up to a multiple of 4."""
    capacity = max(int(T * top_k / e_pad * capacity_factor), 4)
    return (capacity + 3) // 4 * 4


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows (dim 0), in rank order, gathered in fp32 (an
    exact copy); backward: this rank's rows of the gradient, since a
    token's output depends on its own row alone."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.lo = dist.get_rank(group) * x.shape[0]
        ctx.n = x.shape[0]
        return all_gather_cat(x.to(F32), group, dim=0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.n], None


def moe_apply(p: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, act: str = "swiglu",
              dispatch: str = "gather",
              layout: MeshLayout | None = None,
              rows: int | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``layout``: the model's mesh layout
    (module docstring), None on one device.  ``rows``: the global batch's
    real rows when the data ranks hold zero pad rows past them (None:
    every row is real)."""
    bsz, seq, d = x.shape
    x2d = x.reshape(bsz * seq, d)
    experts = layout.experts if layout is not None else None
    data = layout.data_group if layout is not None else None
    xr, router = x2d, p.router
    if experts is not None:   # each rank's experts: sum the gradients
        xr = layers.copy_to_model(xr, layout)
        router = layers.copy_to_model(router, layout)
    if data is not None:
        xr = _GatherRows.apply(xr, data)
    T = xr.shape[0]
    real = T if rows is None else rows * seq
    e_pad = router.shape[1]
    weights, idx = _route(router, xr, num_experts, top_k)
    capacity = capacity_of(real, top_k, e_pad, capacity_factor)
    slot, keep = _sort_dispatch(idx, T, top_k, e_pad, capacity)
    if real < T:   # the pad rows sort last in every expert: drop them
        keep = keep & (torch.arange(T * top_k, device=x.device)
                       < real * top_k)
        slot = torch.where(keep, slot, e_pad * capacity)

    e0, e1 = experts or (0, e_pad)
    lo, n_loc = e0 * capacity, (e1 - e0) * capacity
    local = slot - lo                     # slots of this rank's experts
    mine = keep & (local >= 0) & (local < n_loc)
    tk = T * top_k
    token_of = torch.arange(T, device=x.device).repeat_interleave(top_k)
    if dispatch == "gather":
        # 1-D int scatter: which assignment fills each slot (the drops
        # land in the extra last one)
        filler = torch.full((e_pad * capacity + 1,), tk, dtype=torch.long,
                            device=x.device)
        filler.index_put_((slot,), torch.arange(tk, device=x.device))
        filler = filler[lo:lo + n_loc]
        valid = filler < tk
        tok = token_of[filler.clamp_max(tk - 1)]
        buf = torch.where(valid[:, None], xr[tok], 0)
    else:
        buf = xr.new_zeros((n_loc + 1, d)).index_put(
            (torch.where(mine, local, n_loc),), xr[token_of])[:n_loc]
    buf = buf.reshape(e1 - e0, capacity, d)

    # the batched expert FFN, fp32 out of the GEMMs
    if act == "swiglu":
        g = _bmm_f32(buf, p.wg)
        h = _bmm_f32(buf, p.wi)
        inner = (F.silu(g) * h).to(x.dtype)
    else:
        inner = F.gelu(_bmm_f32(buf, p.wi), approximate="tanh").to(x.dtype)
    y = _bmm_f32(inner, p.wo).to(x.dtype).reshape(n_loc, d)

    # combine this rank's tokens: each kept assignment's slot output times
    # its weight, fp32
    n = x2d.shape[0]
    t0 = dist.get_rank(data) * n if data is not None else 0
    own = slice(t0 * top_k, (t0 + n) * top_k)
    mine, local = mine[own], local[own]
    w_flat = torch.where(mine, weights.reshape(-1)[own], 0.0)
    contrib = y[local.clamp(0, n_loc - 1)].to(F32) * w_flat[:, None]
    contrib = torch.where(mine[:, None], contrib, 0.0)
    if dispatch == "gather":
        out = contrib.reshape(n, top_k, d).sum(dim=1)
    else:
        out = torch.zeros((n, d), dtype=F32, device=x.device).index_add(
            0, token_of[:n * top_k], contrib)
    if experts is not None:
        out = layers.reduce_from_model(out, layout)
    out = out.to(x.dtype)

    if hasattr(p, "shared"):
        gate = torch.sigmoid(x2d.to(F32) @ p.shared_gate.to(F32))
        shared = layers.mlp_apply(p.shared, x2d, layout, act=act)
        out = out + (shared.to(F32) * gate).to(x.dtype)
    return out.reshape(bsz, seq, d)
