"""RWKV-6 "Finch" block: the time mix and the channel mix of the ssm
family (rwkv6-3b).

Port of ``repro/models/rwkv6.py``.  The time mix is the reference's:
token-shift ddlerp mixing (five data-dependent interpolations of x and
the previous token through a shared low-rank adapter), the r, k, v and g
projections, the data-dependent decay ``w = exp(-exp(w0 + lora))`` in
fp32, the recurrence, one layernorm over the whole ``d`` (``ln_out``; the
reference's docstring says groupnorm, its code is a layernorm, and the
port follows the code), the silu gate and ``wo``.  The casts stand where
the reference's do: :func:`~.layers.matmul` rounds to ``x.dtype``; r, k, v,
g and w are fp32; y goes back to ``x.dtype`` before the layernorm, and
``y * g`` is cast before ``wo``.

The recurrence runs through ``kernels/wkv6.py`` (the CUDA kernel on the
card, its plain time loop on the CPU; ``backend="torch"`` runs the plain
loop on any device, differentiated by autograd in training), which writes
the final state into ``out_state`` in place: the serving cache's layer
slice.  When grad is enabled and an input of the recurrence requires it
(training), it runs through ``wkv6_train``, whose backward is the
hand-written ``wkv6_bwd`` (its plain version on the CPU); serving runs
under ``no_grad`` and never takes it.

On a mesh (a :class:`~.layers.MeshLayout` whose ``gate`` is set) ``wg``
is a column shard and ``wo`` the matching row shard, by
``dist/sharding.py::param_specs``; everything else is whole on every rank
of ``model``, so each rank runs the recurrence for all heads, takes its
``gate`` columns of y, and ``wo``'s partial products are summed over
``model`` in fp32 (:func:`~.layers.row_parallel`).  In training y passes
through :func:`~.layers.copy_to_model` before the slice, so the gradient
of everything whole on the ranks is summed over ``model``: each rank's
columns carry a part of it.

Parameters live in :class:`TimeMix` and :class:`ChannelMix`, whose
attribute names are the reference's pytree keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import wkv6 as _wkv
from ..kernels.engine import resolve_backend
from . import layers
from .layers import F32, MeshLayout, matmul

__all__ = ["TimeMix", "ChannelMix", "rwkv6_init", "channel_mix_init",
           "rwkv6_forward", "rwkv6_decode_step", "channel_mix", "MIXES"]

MIXES = ("r", "k", "v", "w", "g")


def _empty(dtype, device, *shape):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class TimeMix(nn.Module):
    """The time mix's parameters (uninitialised; :func:`rwkv6_init` draws
    them): ``mu_x (d,)``, ``mix_a (d, 5r)``, ``mix_b (5, r, d)``, ``mu (5,
    d)``, ``wr``/``wk``/``wv``/``wg``/``wo (d, d)``, ``w0 (d,)``,
    ``decay_a (d, rd)``, ``decay_b (rd, d)``, ``u (H, N)`` and the
    layernorm ``ln_out``."""

    def __init__(self, d_model: int, n_heads: int, dtype, device,
                 lora_rank: int = 32, decay_rank: int = 64):
        super().__init__()
        hd = d_model // n_heads
        e = lambda *shape: _empty(dtype, device, *shape)  # noqa: E731
        self.mu_x = e(d_model)
        self.mix_a = e(d_model, lora_rank * len(MIXES))
        self.mix_b = e(len(MIXES), lora_rank, d_model)
        self.mu = e(len(MIXES), d_model)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, e(d_model, d_model))
        self.w0 = e(d_model)
        self.decay_a = e(d_model, decay_rank)
        self.decay_b = e(decay_rank, d_model)
        self.u = e(n_heads, hd)
        self.ln_out = layers.norm_init("layernorm", d_model, dtype, device)


class ChannelMix(nn.Module):
    """The channel mix's parameters: ``mu_k``/``mu_r (d,)``, ``wk (d,
    d_ff)``, ``wv (d_ff, d)``, ``wr (d, d)``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.mu_k = _empty(dtype, device, d_model)
        self.mu_r = _empty(dtype, device, d_model)
        self.wk = _empty(dtype, device, d_model, d_ff)
        self.wv = _empty(dtype, device, d_ff, d_model)
        self.wr = _empty(dtype, device, d_model, d_model)


def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=F32, device=device)
            * scale).to(dtype)


@torch.no_grad()
def rwkv6_init(gen: torch.Generator, d_model: int, n_heads: int, dtype,
               device, lora_rank: int = 32, decay_rank: int = 64) -> TimeMix:
    """The reference's distributions, drawn from ``gen``: ``mu_x`` 0.5,
    ``mix_a``/``decay_a`` and the projections N(0, 1/d_in), ``mix_b`` and
    ``decay_b`` N(0, 0.01²), ``mu`` the rows linspace(0.3, 0.7, 5), ``w0``
    -2, ``u`` N(0, 0.1²), ``ln_out`` ones and zeros."""
    p = TimeMix(d_model, n_heads, dtype, device, lora_rank, decay_rank)
    p.mu_x.fill_(0.5)
    layers._fill(p, ("mix_a",), gen)
    p.mix_b.copy_(_normal(gen, tuple(p.mix_b.shape), 0.01, dtype, device))
    p.mu.copy_(torch.linspace(0.3, 0.7, len(MIXES), dtype=F32,
                              device=device)[:, None].expand(-1, d_model))
    layers._fill(p, ("wr", "wk", "wv", "wg", "wo"), gen)
    p.w0.fill_(-2.0)
    layers._fill(p, ("decay_a",), gen)
    p.decay_b.copy_(_normal(gen, tuple(p.decay_b.shape), 0.01, dtype,
                            device))
    p.u.copy_(_normal(gen, tuple(p.u.shape), 0.1, dtype, device))
    return p


@torch.no_grad()
def channel_mix_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                     device) -> ChannelMix:
    p = ChannelMix(d_model, d_ff, dtype, device)
    p.mu_k.fill_(0.5)
    p.mu_r.fill_(0.5)
    layers._fill(p, ("wk", "wv", "wr"), gen)
    return p


def _mixed_inputs(p: TimeMix, x: torch.Tensor, x_prev: torch.Tensor):
    """ddlerp token shift: five data-dependent interpolations of (x,
    x_prev), each (B, T, d) in x's dtype, by name."""
    dx = x_prev - x
    xx = x + dx * p.mu_x.to(x.dtype)
    lora = torch.tanh(matmul(xx, p.mix_a))              # (B, T, 5r)
    bsz, seq, _ = lora.shape
    r5 = lora.reshape(bsz, seq, len(MIXES), -1)
    adj = torch.einsum("btfr,frd->btfd", r5.to(F32),
                       p.mix_b.to(F32)).to(x.dtype)
    return {name: x + dx * (p.mu[i].to(x.dtype) + adj[:, :, i])
            for i, name in enumerate(MIXES)}


def _decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    """``exp(-exp(w0 + lora))`` in fp32, (B, T, d) in (0, 1)."""
    lora = matmul(torch.tanh(matmul(xw, p.decay_a)), p.decay_b)
    return torch.exp(-torch.exp(p.w0.to(F32) + lora.to(F32)))


def rwkv6_forward(p: TimeMix, x: torch.Tensor, n_heads: int, state=None, *,
                  out_state: torch.Tensor | None = None,
                  backend: str | None = None,
                  layout: MeshLayout | None = None):
    """x: (B, T, d) -> (out, (x_last, S)).  ``state`` = (x_last (B, d), S
    (B, H, N, N) fp32), or None for the zero state.  ``out_state``: the
    buffer the final S is written into in place (it may be ``state``'s S;
    default: a new one), which is the S returned.  ``backend="torch"``
    runs the recurrence's plain loop on any device."""
    bsz, seq, d = x.shape
    hd = d // n_heads
    if state is None:
        x_last = torch.zeros((bsz, 1, d), dtype=x.dtype, device=x.device)
        s0 = None
    else:
        x_last, s0 = state
        x_last = x_last.reshape(bsz, 1, d).to(x.dtype)
    x_prev = torch.cat([x_last, x[:, :-1]], dim=1)
    mixed = _mixed_inputs(p, x, x_prev)

    def heads(name, w):
        return matmul(mixed[name], w).reshape(bsz, seq, n_heads, hd).to(F32)
    r, k, v = heads("r", p.wr), heads("k", p.wk), heads("v", p.wv)
    split = layout is not None and layout.gate is not None
    xg = layers.copy_to_model(mixed["g"], layout) if split else mixed["g"]
    g = F.silu(matmul(xg, p.wg).to(F32))
    w = _decay(p, mixed["w"]).reshape(bsz, seq, n_heads, hd)
    u = p.u.to(F32)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u))
    if resolve_backend(backend) == "torch":
        y, s_t = _wkv.wkv6_plain(r, k, v, w, u, s0)
        if out_state is not None:
            s_t = out_state.copy_(s_t)
    elif train:
        if out_state is not None:
            raise ValueError("a recurrence with a gradient writes no "
                             "caller's state buffer (out_state)")
        y, s_t = _wkv.wkv6_train(r, k, v, w, u, s0)
    else:
        y, s_t = _wkv.wkv6(r, k, v, w, u, s0, state=out_state)
    y = layers.layernorm(p.ln_out, y.reshape(bsz, seq, d).to(x.dtype))
    if split:     # this rank's gate columns; wo's rows summed over model
        y = layers.copy_to_model(y, layout)
        c0, c1 = layout.gate
        yg = (y[..., c0:c1].to(F32) * g).to(x.dtype)
        out = layers.row_parallel(yg, p.wo, layout)
    else:
        out = matmul((y.to(F32) * g).to(x.dtype), p.wo)
    return out, (x[:, -1], s_t)


def rwkv6_decode_step(p: TimeMix, x: torch.Tensor, n_heads: int, state, *,
                      out_state=None, backend=None, layout=None):
    """Single token: x (B, 1, d)."""
    return rwkv6_forward(p, x, n_heads, state, out_state=out_state,
                         backend=backend, layout=layout)


# ---------------------------------------------------------------------------
# channel mix (RWKV's FFN: token-shifted, relu², receptance-gated)
# ---------------------------------------------------------------------------

def channel_mix(p: ChannelMix, x: torch.Tensor,
                x_last: torch.Tensor | None):
    """x: (B, T, d); x_last: (B, d) carry from the previous segment (None:
    zeros).  Returns (out, x[:, -1])."""
    bsz, _, d = x.shape
    if x_last is None:
        x_last = torch.zeros((bsz, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p.mu_k.to(x.dtype)
    xr = x + (x_prev - x) * p.mu_r.to(x.dtype)
    k = torch.square(F.relu(matmul(xk, p.wk).to(F32))).to(x.dtype)
    r = torch.sigmoid(matmul(xr, p.wr).to(F32)).to(x.dtype)
    return r * matmul(k, p.wv), x[:, -1]
