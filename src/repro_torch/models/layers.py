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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import flash_attention as _b5
from ..kernels.engine import resolve_backend

__all__ = ["F32", "Norm", "Attention", "MLP", "dense_init", "embed_init",
           "matmul", "rmsnorm", "layernorm", "norm_init", "norm_apply",
           "rope", "attention_init", "flash_attention", "decode_attention",
           "mlp_init", "mlp_apply"]

F32 = torch.float32


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


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.to(F32)).to(x.dtype)


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
    (uninitialised; :func:`attention_init` draws them)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype, device):
        super().__init__()

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))
        self.wq = empty(d_model, n_heads * head_dim)
        self.wk = empty(d_model, n_kv * head_dim)
        self.wv = empty(d_model, n_kv * head_dim)
        self.wo = empty(n_heads * head_dim, d_model)


def _fill(module: nn.Module, names, gen: torch.Generator) -> None:
    """Draw ``module``'s ``(d_in, d_out)`` weights ``names`` in order."""
    for name in names:
        w = getattr(module, name)
        w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype, w.device))


def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, dtype, device) -> Attention:
    p = Attention(d_model, n_heads, n_kv, head_dim, dtype, device)
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


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """swiglu: ``(silu(x wg) * (x wi)) wo``, silu in fp32."""
    h = F.silu(matmul(x, p.wg).to(F32)).to(x.dtype)
    return matmul(h * matmul(x, p.wi), p.wo)
