"""Shared neural-net layers of the dense LM path.

Port of the parts of ``repro/models/layers.py`` that the dense family
uses.  Conventions kept from the reference:

* weights keep the reference's ``(d_in, d_out)`` layout (``x @ w``), so
  the reference's parameters carry over without a transpose;
* :func:`matmul` accumulates in fp32 and returns ``x.dtype`` (for bf16 the
  library GEMM accumulates in fp32 and rounds its output once, as
  ``preferred_element_type=F32`` followed by the cast does);
* norms and rotary angles run in fp32 and cast back at the same points as
  the reference;
* prefill and training attention is :func:`flash_attention` over ``(B, S,
  H, hd)``, which runs the CUDA kernel B5 (``kernels/flash_attention.py``;
  in training through its autograd Function); ``backend="torch"`` runs its
  plain PyTorch version instead (the reference path of the checks).  Decode attention is a one-query einsum
  and softmax over the cache, plain PyTorch as in the reference (where it
  is XLA-level, not a Pallas kernel).

Parameters live in small ``nn.Module`` s (:class:`Norm`,
:class:`Attention`, :class:`MLP`) whose attribute names are the
reference's pytree keys.

Tensor parallelism (a model sharded over a mesh's ``model`` axis,
:class:`MeshLayout`) is explicit collectives on each rank's local shards,
Megatron's pair: :func:`copy_to_model` (identity forward, all-reduce of the
gradient backward) in front of the column-split projections, and
:func:`row_parallel` behind the row-split ``wo``, whose partial products
leave the GEMM in fp32, are summed over ``model`` in fp32 and rounded once
(the reference's jit sums the same fp32 partials before its cast).  Every
collective runs in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..kernels import flash_attention as _b5
from ..kernels.engine import resolve_backend

__all__ = ["F32", "Norm", "Attention", "MLP", "dense_init", "embed_init",
           "matmul", "rmsnorm", "layernorm", "norm_init", "norm_apply",
           "rope", "attention_init", "flash_attention", "decode_attention",
           "mlp_init", "mlp_apply", "MeshLayout", "copy_to_model",
           "reduce_from_model", "row_parallel", "take_kv"]

F32 = torch.float32


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Where a rank's shards of a model sharded over a mesh sit
    (``dist/sharding.py::model_layout``; ``transformer.shard_params`` sets
    it on the model as ``layout``).

    ``specs`` / ``shapes``: each parameter's spec and global shape.
    ``model_group`` / ``model_rank``: the ``model`` axis's group (None
    when it splits nothing) and this rank's index on it.  ``heads``: this
    rank's ``[first, end)`` q heads when ``wq``/``wo`` are split over
    ``model`` (None: whole attention); ``kv_take``: the kv head each of
    them reads when ``wk``/``wv`` stay whole (None: split alike);
    ``ff``: the MLP's ``d_ff`` is split; ``vocab``: this rank's rows of
    the embedding table (None: whole).  ``data_group``: the data-parallel
    axes' group (None for one data rank), over which the loss's token
    count is summed (the loss is the global batch's mean)."""

    mesh: Any
    specs: Mapping
    shapes: Mapping
    model_group: Any
    model_rank: int
    heads: Optional[Tuple[int, int]]
    kv_take: Optional[Tuple[int, ...]]
    ff: bool
    vocab: Optional[Tuple[int, int]]
    data_group: Any


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, taken in fp32, in ``x``'s dtype (a
    new tensor)."""
    y = x.to(F32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward (every rank
    goes on with the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """``x`` whole on every rank of ``model`` (an activation in front of a
    column-split projection, or a whole weight whose ranks use different
    parts of it): its gradient is summed over ``model``."""
    return _CopyToModel.apply(x, layout.model_group)


def reduce_from_model(x: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``model``, in fp32, in ``x``'s
    dtype."""
    return _ReduceFromModel.apply(x, layout.model_group)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (2-D) written out in fp32: on the card a half-precision
    GEMM hands over its fp32 accumulator unrounded (``out_dtype``);
    elsewhere the operands are upcast, whose products are exact in fp32
    all the same."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x, w, out_dtype=F32)
    return torch.mm(x.to(F32), w.to(F32))


class _PartialF32(torch.autograd.Function):
    """``x @ w`` in fp32 (:func:`_mm_f32`).  Backward, the two GEMMs run in
    ``x``'s dtype, as :func:`matmul`'s do on one device: the incoming
    gradient is the fp32 copy of one in ``x``'s dtype (the rounding after
    the sum), so nothing is lost casting it back."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
        return out.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dw = torch.mm(x.reshape(-1, x.shape[-1]).t(),
                      g.reshape(-1, g.shape[-1]))
        return torch.matmul(g, w.t()), dw


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 layout: MeshLayout) -> torch.Tensor:
    """``x @ w`` for ``w`` split on its rows (``x`` on its columns): the
    partial products leave the GEMM in fp32 (:class:`_PartialF32`), are
    summed over ``model`` in fp32 and rounded once to ``x.dtype``."""
    partial = _PartialF32.apply(x, w)
    return reduce_from_model(partial, layout).to(x.dtype)


def take_kv(t: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """The kv head (dim 2 of ``(B, S, KV, hd)``) of each of this rank's q
    heads, when ``wk``/``wv`` are whole and ``wq`` is split."""
    idx = torch.as_tensor(layout.kv_take, device=t.device)
    return t.index_select(2, idx)


def _param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter; the serving entry points run under
    ``torch.no_grad``, so they record no graph over it."""
    return nn.Parameter(t)


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, dtype=F32,
                        device=device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=F32,
                        device=device) * 0.02).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, result in x.dtype."""
    return torch.matmul(x, w).to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm (``scale``) or layernorm (``scale``, ``bias``) parameters."""

    def __init__(self, kind: str, d: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.ones((d,), dtype=dtype, device=device))
        if kind == "layernorm":
            self.bias = _param(torch.zeros((d,), dtype=dtype, device=device))


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6, *,
            layout: MeshLayout | None = None) -> torch.Tensor:
    """rmsnorm over the last dim.  With a ``layout``, ``p`` is a scale
    that the model ranks share over heads they split (qk-norm on a rank's
    heads): its gradient is summed over ``model`` (:func:`copy_to_model`)."""
    scale = p.scale if layout is None else copy_to_model(p.scale, layout)
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(F32)).to(x.dtype)


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * p.scale.to(F32) + p.bias.to(F32)).to(x.dtype)


def norm_init(kind: str, d: int, dtype, device) -> Norm:
    return Norm(kind, d, dtype, device)


def norm_apply(kind: str, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    frequencies and angles are fp32, computed in the reference's order."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=F32, device=x.device) / half)
    angles = positions.to(F32)[..., None] * freqs      # (..., S, half)
    cos = torch.cos(angles)[..., None, :]              # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq (d, H*hd)``, ``wk``/``wv (d, KV*hd)``, ``wo (H*hd, d)``
    (uninitialised; :func:`attention_init` draws them), and with
    ``qk_norm`` the rmsnorm scales ``q_norm``/``k_norm (hd,)`` (ones)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype, device, qk_norm: bool = False):
        super().__init__()

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))
        self.wq = empty(d_model, n_heads * head_dim)
        self.wk = empty(d_model, n_kv * head_dim)
        self.wv = empty(d_model, n_kv * head_dim)
        self.wo = empty(n_heads * head_dim, d_model)
        if qk_norm:
            self.q_norm = Norm("rmsnorm", head_dim, dtype, device)
            self.k_norm = Norm("rmsnorm", head_dim, dtype, device)


def _fill(module: nn.Module, names, gen: torch.Generator) -> None:
    """Draw ``module``'s ``(d_in, d_out)`` weights ``names`` in order."""
    for name in names:
        w = getattr(module, name)
        w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype, w.device))


def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, dtype, device,
                   qk_norm: bool = False) -> Attention:
    p = Attention(d_model, n_heads, n_kv, head_dim, dtype, device, qk_norm)
    _fill(p, ("wq", "wk", "wv", "wo"), gen)
    return p


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    backend: str | None = None) -> torch.Tensor:
    """Prefill and training attention over ``(B, S, H, hd)``; O(S) memory.

    ``backend="cuda"`` (default) runs B5, which launches the CUDA kernel
    on CUDA tensors and its plain version on CPU tensors; ``"torch"`` runs
    the plain version on any device, differentiated by autograd.  When
    grad is enabled and q, k or v requires it (training), B5 runs through
    its autograd Function
    (``kernels/flash_attention.py::flash_attention_train``), whose backward
    recomputes P from the saved log-sum-exp; serving runs under
    ``no_grad`` and never takes it.  Sliding windows and a prefix offset
    (Sq != Sk) raise: B5 takes neither (ROADMAP A.13)."""
    _b5.check_inputs(q, k, v, window)
    if resolve_backend(backend) == "torch":
        return _b5.flash_attention_plain(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _b5.flash_attention_train(q, k, v, causal=causal)
    return _b5.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, length: int) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); length: number of valid
    cache entries (the new token's k/v already written at length - 1), an
    ``int`` or a 0-d integer tensor on q's device.
    """
    bsz, _, heads, hd = q.shape
    seq, kv = k_cache.shape[1], k_cache.shape[2]
    rep = heads // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(bsz, kv, rep, hd)
    s = torch.einsum("bgrh,bsgh->bgrs", qg.to(F32), k_cache.to(F32)) * scale
    valid = torch.arange(seq, device=q.device) < length
    s = torch.where(valid, s, torch.full((), -1e30, dtype=F32,
                                         device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgh->bgrh", p, v_cache.to(F32))
    return out.reshape(bsz, 1, heads, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The swiglu MLP: ``wi``, ``wg (d, d_ff)``, ``wo (d_ff, d)``
    (uninitialised; :func:`mlp_init` draws them)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))
        self.wi = empty(d_model, d_ff)
        self.wg = empty(d_model, d_ff)
        self.wo = empty(d_ff, d_model)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> MLP:
    p = MLP(d_model, d_ff, dtype, device)
    _fill(p, ("wi", "wg", "wo"), gen)
    return p


def mlp_apply(p: MLP, x: torch.Tensor,
              layout: MeshLayout | None = None) -> torch.Tensor:
    """swiglu: ``(silu(x wg) * (x wi)) wo``, silu in fp32.  With a
    ``layout`` whose ``ff`` is split, ``wi``/``wg`` are column shards and
    ``wo`` a row shard (:func:`row_parallel`)."""
    split = layout is not None and layout.ff
    if split:
        x = copy_to_model(x, layout)
    h = F.silu(matmul(x, p.wg).to(F32)).to(x.dtype)
    h = h * matmul(x, p.wi)
    return row_parallel(h, p.wo, layout) if split else matmul(h, p.wo)
