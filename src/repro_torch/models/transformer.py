"""Decoder-only LM, dense family: parameters, training loss, prefill and
decode.

Port of the dense-family parts of ``repro/models/transformer.py``.  Where
the reference scans one stacked-parameter layer body, the port keeps an
``nn.Module`` stack: :class:`LM` holds ``embed``, a ``ModuleList`` of
:class:`Block` s and ``final_norm`` (and ``unembed`` when the embeddings
are not tied), with the reference's pytree keys as attribute names.
PyTorch runs eagerly, so the layer loop is a Python loop.

* :func:`prefill` runs every layer's attention through B5 (the CUDA
  flash-attention kernel) and returns the cache in the reference's layout,
  ``{"k", "v"}`` each ``(L, B, S, KV, hd)``, and the last position's
  logits in fp32.
* :func:`decode_step` writes the new token's k/v into the cache **in
  place** (the reference donates the cache buffer to the same effect) and
  returns the same dict with the fp32 logits.  Its ``length`` may be a
  0-d tensor on the device, so one captured CUDA graph serves every
  position (:mod:`repro_torch.dist.step`); :func:`prefill` can write into
  a given cache (the serving pool's static one).
* The tied-embedding logits are fp32 (the reference's
  ``preferred_element_type=F32``): the table is widened to fp32 in chunks
  of :data:`LOGIT_CHUNK_ELEMS` elements, so no fp32 copy of the whole
  table is made per call (1 GB at llama3.2-1b's vocabulary).
* :func:`train_loss` is the reference's: embed, the layer stack with each
  block rematerialised (``torch.utils.checkpoint``, as the reference's
  ``jax.checkpoint``), the final norm and :func:`chunked_ce`, whose
  gradient is written by hand so no ``(T, vocab)`` fp32 buffer outlives a
  chunk.  Attention runs through B5's autograd Function, so each block's
  forward and its recompute launch B5 once each.  The parameters are
  trainable; :func:`prefill` and :func:`decode_step` run under
  ``torch.no_grad`` and record no graph.

Families other than dense, and within it sliding-window attention,
qk-norm, activations other than swiglu and frontends, raise
``NotImplementedError``: they come with ROADMAP A.13.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.engine import resolve_device
from . import layers
from .layers import F32

__all__ = ["LM", "Block", "init_params", "train_loss", "chunked_ce",
           "prefill", "decode_step", "init_cache", "num_params",
           "params_from_numpy", "LOGIT_CHUNK_ELEMS"]

# Unembedding table elements widened to fp32 at a time (64 MB in fp32).
LOGIT_CHUNK_ELEMS = 1 << 24


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            "port runs the dense family (ROADMAP A.13)")
    unported = {"sliding_window": bool(cfg.sliding_window),
                "qk_norm": cfg.qk_norm, "act": cfg.act != "swiglu",
                "frontend": cfg.frontend != "none"}
    for field, hit in unported.items():
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                "yet (ROADMAP A.13)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One dense layer: ``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = layers.norm_init(cfg.norm, cfg.d_model, cfg.dtype,
                                      device)
        self.norm2 = layers.norm_init(cfg.norm, cfg.d_model, cfg.dtype,
                                      device)
        self.attn = layers.Attention(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.resolved_head_dim,
                                     cfg.dtype, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device)


class LM(nn.Module):
    """The parameter tree of a dense LM (weights uninitialised until
    :func:`init_params` or :func:`params_from_numpy` fills them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        shape = (cfg.vocab_padded(), cfg.d_model)
        self.embed = nn.Parameter(torch.empty(shape, dtype=cfg.dtype,
                                              device=device))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = layers.norm_init(cfg.norm, cfg.d_model, cfg.dtype,
                                           device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(shape, dtype=cfg.dtype,
                                                    device=device))


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> LM:
    """Random parameters with the reference's distributions
    (``layers.dense_init``: N(0, 1/d_in); ``embed_init``: N(0, 0.02²);
    norms at one), drawn from ``generator``, which must live on
    ``device`` (default: the current CUDA device).  The skeleton is built
    on the meta device and each part is drawn in place of its slot, so no
    weight is allocated twice."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {dev}")
    lm = LM(cfg, torch.device("meta"))
    with torch.no_grad():
        for blk in lm.layers:
            blk.norm1 = layers.norm_init(cfg.norm, cfg.d_model, cfg.dtype,
                                         dev)
            blk.norm2 = layers.norm_init(cfg.norm, cfg.d_model, cfg.dtype,
                                         dev)
            blk.attn = layers.attention_init(
                generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, cfg.dtype, dev)
            blk.mlp = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                      cfg.dtype, dev)
        shape = (cfg.vocab_padded(), cfg.d_model)
        lm.embed = nn.Parameter(layers.embed_init(generator, *shape,
                                                  cfg.dtype, dev))
        lm.final_norm = layers.norm_init(cfg.norm, cfg.d_model, cfg.dtype,
                                         dev)
        if not cfg.tie_embeddings:
            lm.unembed = nn.Parameter(layers.embed_init(generator, *shape,
                                                        cfg.dtype, dev))
    return lm


def num_params(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


def _host_array(a) -> np.ndarray:
    """A numpy array of ``a``; ml_dtypes' bfloat16 goes through float32
    (exact), which ``torch.from_numpy`` would refuse."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *,
                      device=None) -> LM:
    """The reference's parameter pytree (``jax.tree.map(np.asarray,
    api.init_params(...))``) as the port's :class:`LM`: the stacked
    ``layers`` arrays are split per block; every weight keeps its
    ``(d_in, d_out)`` layout; values are copied (never shared with the
    caller's arrays) in ``cfg.dtype``."""
    dev = resolve_device(device)
    lm = LM(cfg, dev)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                node = tree["layers"]
                for key in parts[2:]:
                    node = node[key]
                arr = _host_array(node)[int(parts[1])]
            else:
                node = tree
                for key in parts:
                    node = node[key]
                arr = _host_array(node)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {arr.shape} vs "
                                 f"port shape {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=cfg.dtype))
    return lm


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, lp: Block, x, positions, *, mode,
                cache=None, length=None, backend=None):
    """Returns (attn_out, cache_out); cache_out is (k, v) for prefill and
    the updated cache views for decode."""
    hd = cfg.resolved_head_dim
    bsz, seq, _ = x.shape
    ap = lp.attn
    q = layers.matmul(x, ap.wq).reshape(bsz, seq, cfg.num_heads, hd)
    k = layers.matmul(x, ap.wk).reshape(bsz, seq, cfg.num_kv_heads, hd)
    v = layers.matmul(x, ap.wv).reshape(bsz, seq, cfg.num_kv_heads, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        k_cache, v_cache = cache
        # in place, at the position the 0-d tensor ``length`` holds (the
        # reference donates the cache to the same effect)
        idx = length.reshape(1)
        k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        out = layers.decode_attention(q, k_cache, v_cache, length + 1)
        cache_out = (k_cache, v_cache)
    else:
        out = layers.flash_attention(q, k, v, causal=True, backend=backend)
        cache_out = (k, v)
    out = out.reshape(bsz, seq, cfg.num_heads * hd)
    return layers.matmul(out, ap.wo), cache_out


def _layer_apply(cfg: ModelConfig, lp: Block, x, positions, *, mode,
                 cache=None, length=None, backend=None):
    """One block.  Returns (x, (k, v))."""
    h = layers.norm_apply(cfg.norm, lp.norm1, x)
    attn_out, kv = _attn_block(cfg, lp, h, positions, mode=mode,
                               cache=cache, length=length, backend=backend)
    x = x + attn_out
    h2 = layers.norm_apply(cfg.norm, lp.norm2, x)
    x = x + layers.mlp_apply(lp.mlp, h2)
    return x, kv


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params: LM,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> embeddings (B, S, d) (no frontend prefix): the
    table's rows, as ``embed[tokens]``; ``F.embedding``'s gradient sums
    repeated tokens in a fixed order on the card."""
    return F.embedding(tokens, params.embed)


def _unembed_w(cfg: ModelConfig, params: LM) -> torch.Tensor:
    return params.embed if cfg.tie_embeddings else params.unembed


def _logits(cfg: ModelConfig, params: LM, h: torch.Tensor) -> torch.Tensor:
    """(B, d) hidden -> (B, vocab_padded) fp32 logits, the table widened
    to fp32 one chunk of rows at a time (each product of two bf16 values
    is exact in fp32; the sums run in fp32)."""
    w = _unembed_w(cfg, params)
    out = torch.empty((h.shape[0], w.shape[0]), dtype=F32, device=h.device)
    hf = h.to(F32)
    step = max(1, LOGIT_CHUNK_ELEMS // w.shape[1])
    for r0 in range(0, w.shape[0], step):
        out[:, r0:r0 + step] = hf @ w[r0:r0 + step].to(F32).T
    return out


def _tokens(params: LM, tokens) -> torch.Tensor:
    dev = params.embed.device
    if isinstance(tokens, torch.Tensor):
        if tokens.device != dev:
            raise ValueError(f"tokens are on {tokens.device}, the model on "
                             f"{dev}")
        return tokens.long()
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class _ChunkedCE(torch.autograd.Function):
    """Summed cross-entropy of ``h (T, d)`` against the table ``w (V, d)``
    over the labels ``(T,)`` (-1 masked), ``chunk`` tokens at a time.  The
    logits of a chunk are fp32 (the products of the two operands, summed
    in fp32, as the reference's ``preferred_element_type=F32``); the
    forward keeps only each token's log-sum-exp, and the backward
    recomputes a chunk's logits to form ``softmax - onehot`` and its two
    products, accumulating the table's gradient in fp32 across chunks and
    rounding it once."""

    @staticmethod
    def forward(h, w, labels, chunk):
        wf = w.to(F32)
        logz = torch.empty(h.shape[0], dtype=F32, device=h.device)
        loss = torch.zeros((), dtype=F32, device=h.device)
        for t0 in range(0, h.shape[0], chunk):
            lc = labels[t0:t0 + chunk]
            logits = h[t0:t0 + chunk].to(F32) @ wf.T
            lz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, lc.clamp_min(0)[:, None])[:, 0]
            loss = loss + torch.sum((lz - gold) * (lc >= 0).to(F32))
            logz[t0:t0 + chunk] = lz
        return loss, logz

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, w, labels, chunk = inputs
        ctx.save_for_backward(h, w, labels, output[1])
        ctx.chunk = chunk
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _glogz):
        h, w, labels, logz = ctx.saved_tensors
        wf = w.to(F32)
        dh = torch.empty_like(h)
        dw = torch.zeros_like(wf)
        for t0 in range(0, h.shape[0], ctx.chunk):
            lc = labels[t0:t0 + ctx.chunk]
            hc = h[t0:t0 + ctx.chunk].to(F32)
            p = torch.exp(hc @ wf.T - logz[t0:t0 + ctx.chunk, None])
            rows = torch.arange(lc.shape[0], device=h.device)
            p[rows, lc.clamp_min(0)] -= 1.0
            p *= ((lc >= 0).to(F32) * g)[:, None]
            dh[t0:t0 + ctx.chunk] = (p @ wf).to(h.dtype)
            dw.addmm_(p.T, hc)
        return dh, dw.to(w.dtype), None, None


def chunked_ce(cfg: ModelConfig, params: LM, hidden: torch.Tensor,
               labels: torch.Tensor):
    """Cross-entropy without a kept ``(T, vocab)`` buffer.

    hidden: (B, S, d); labels: (B, S) with -1 = masked.  Returns
    (loss_mean, n_tokens), both fp32 0-d tensors.  Chunks hold
    ``cfg.ce_chunk`` tokens and the last may be shorter (the reference
    picks a chunk that divides T; the sum is the same)."""
    bsz, seq, d = hidden.shape
    h2 = hidden.reshape(bsz * seq, d)
    l2 = labels.reshape(bsz * seq).long()
    loss_sum, _ = _ChunkedCE.apply(h2, _unembed_w(cfg, params), l2,
                                   max(1, cfg.ce_chunk))
    count = (l2 >= 0).sum().to(F32)
    return loss_sum / count.clamp_min(1.0), count


def _train_block(cfg: ModelConfig, lp: Block, x, positions, backend):
    return _layer_apply(cfg, lp, x, positions, mode="train",
                        backend=backend)[0]


def _run_stack(cfg: ModelConfig, params: LM, x, positions, *,
               backend=None):
    """The layer loop of training: each block under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scanned body), so only the blocks' inputs are kept and the backward
    recomputes one block at a time."""
    for lp in params.layers:
        x = checkpoint(_train_block, cfg, lp, x, positions, backend,
                       use_reentrant=False, preserve_rng_state=False)
    return x


def train_loss(cfg: ModelConfig, params: LM, batch: Dict[str, Any], *,
               backend: str | None = None):
    """batch: tokens (B, S), labels (B, S) (-1 masked).  Returns (loss,
    {"tokens": n_tokens}).  ``backend="torch"`` runs attention's plain
    version instead of B5 (forward and recompute)."""
    check_supported(cfg)
    tokens = _tokens(params, batch["tokens"])
    labels = _tokens(params, batch["labels"])
    x = _embed_inputs(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _run_stack(cfg, params, x, positions, backend=backend)
    x = layers.norm_apply(cfg.norm, params.final_norm, x)
    loss, count = chunked_ce(cfg, params, x, labels)
    return loss, {"tokens": count}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, batch: Dict[str, Any], *,
            backend: str | None = None, cache=None):
    """Build the serving cache.  ``batch["tokens"]``: (B, S) token ids.
    Returns (cache, last_token_logits (B, vocab_padded) fp32).
    ``backend="torch"`` runs attention's plain version instead of B5.
    ``cache`` (optional): a cache of :func:`init_cache`'s layout with
    ``max_len >= S`` on the model's device, whose first S positions take
    the k/v (in place) and which is returned in place of a new S-long one;
    the serving pool's static caches take the prefill this way."""
    check_supported(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed_inputs(cfg, params, tokens)
    bsz, seq = tokens.shape
    positions = torch.arange(seq, device=tokens.device)[None, :]
    shape = (cfg.num_layers, bsz, seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    if cache is None:
        cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                 "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    else:
        for name in ("k", "v"):
            c = cache[name]
            if (c.shape[:2] != shape[:2] or c.shape[3:] != shape[3:]
                    or c.shape[2] < seq or c.dtype != x.dtype
                    or c.device != x.device):
                raise ValueError(
                    f"cache[{name!r}] is {tuple(c.shape)} {c.dtype} on "
                    f"{c.device}; the prefill needs {shape[:2]} x >= {seq} "
                    f"x {shape[3:]} {x.dtype} on {x.device}")
    for i, lp in enumerate(params.layers):
        x, (k, v) = _layer_apply(cfg, lp, x, positions, mode="prefill",
                                 backend=backend)
        cache["k"][i, :, :seq] = k
        cache["v"][i, :, :seq] = v
    x = layers.norm_apply(cfg.norm, params.final_norm, x)
    return cache, _logits(cfg, params, x[:, -1])


def _position(length, cache, device) -> torch.Tensor:
    """``decode_step``'s ``length`` as a 0-d int64 tensor on ``device``.
    An ``int`` is checked against the cache's slots on the host; a 0-d
    int32/int64 tensor on ``device`` is taken as it is, unread (its caller
    checks its range: a captured graph replays it with new values)."""
    if isinstance(length, torch.Tensor):
        if length.ndim or length.device != device \
                or length.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"length must be a 0-d int32/int64 tensor on "
                             f"{device}, not {length.dtype} "
                             f"{tuple(length.shape)} on {length.device}")
        return length.long()
    length = int(length)
    if not 0 <= length < cache["k"].shape[2]:
        raise ValueError(f"length {length} outside the cache's "
                         f"{cache['k'].shape[2]} slots")
    return torch.full((), length, dtype=torch.long, device=device)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, cache, tokens, length):
    """One serving step: tokens (B, 1) + cache + current length -> logits.

    ``length`` is the number of tokens already in the cache: an ``int``
    (range-checked on the host) or a 0-d int32/int64 tensor on the model's
    device (the reference's traced ``int32``; never read on the host, so a
    captured CUDA graph serves every position).  The new token's k/v are
    written at slot ``length`` of ``cache`` in place.  Both forms run the
    same operations.  Returns (cache, logits (B, vocab_padded) fp32)."""
    check_supported(cfg)
    tokens = _tokens(params, tokens)
    pos = _position(length, cache, tokens.device)
    x = _embed_inputs(cfg, params, tokens)
    positions = pos.reshape(1, 1)
    for i, lp in enumerate(params.layers):
        x, _ = _layer_apply(cfg, lp, x, positions, mode="decode",
                            cache=(cache["k"][i], cache["v"][i]),
                            length=pos)
    x = layers.norm_apply(cfg.norm, params.final_norm, x)
    return cache, _logits(cfg, params, x[:, 0])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Allocate the decode cache: ``{"k", "v"}`` each
    ``(L, batch, max_len, KV, hd)`` zeros."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
