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
* On a mesh (:func:`shard_params`: each rank holds its shards of the
  parameters, by ``dist/sharding.py::param_specs``, and the model's
  ``layout``) every entry point runs on the rank's shards with explicit
  collectives over ``model`` (``layers``' column/row pair): attention on
  the rank's heads (B5 on them), the MLP on its ``d_ff`` slice, and the
  tied embedding vocab-parallel: the lookup zeros the rows another rank
  holds and sums over ``model``, the cross-entropy takes its log-sum-exp
  from an all-reduce of each chunk's max and sum of exponentials, and the
  logits are gathered along the vocabulary.  The loss is the mean over the
  global batch: the token count is summed over the data axes.

* qk-norm (qwen3-32b): ``q_norm``/``k_norm`` rmsnorm scales over the
  head dim, applied after the projections and before rope, as the
  reference's; on a mesh they stay whole on every rank, and where the
  heads are split over ``model`` their gradients are summed over it.

Families other than dense, and within it sliding-window attention,
activations other than swiglu and frontends, raise
``NotImplementedError``: they come with ROADMAP A.13.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

import torch.distributed as dist

from ..configs.base import ModelConfig
from ..kernels.engine import resolve_device
from ..launch.mesh import all_gather_cat
from . import layers
from .layers import F32, MeshLayout

__all__ = ["LM", "Block", "init_params", "train_loss", "chunked_ce",
           "prefill", "decode_step", "init_cache", "num_params",
           "params_from_numpy", "shard_params", "LOGIT_CHUNK_ELEMS"]

# Unembedding table elements widened to fp32 at a time (64 MB in fp32).
LOGIT_CHUNK_ELEMS = 1 << 24


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            "port runs the dense family (ROADMAP A.13)")
    unported = {"sliding_window": bool(cfg.sliding_window),
                "act": cfg.act != "swiglu",
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
                                     cfg.dtype, device, cfg.qk_norm)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device)


class LM(nn.Module):
    """The parameter tree of a dense LM (weights uninitialised until
    :func:`init_params` or :func:`params_from_numpy` fills them).
    ``layout`` is None on one device, a :class:`MeshLayout` on a mesh."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        self.layout: MeshLayout | None = None
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
                cfg.resolved_head_dim, cfg.dtype, dev, cfg.qk_norm)
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


def _numpy_leaf(tree: Dict[str, Any], name: str) -> np.ndarray:
    """The reference tree's array of the port's parameter ``name`` (the
    stacked ``layers`` arrays split per block)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return _host_array(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return _host_array(node)


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
            arr = _numpy_leaf(tree, name)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {arr.shape} vs "
                                 f"port shape {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=cfg.dtype))
    return lm


def shard_params(cfg: ModelConfig, full, mesh, *, device=None) -> LM:
    """This rank's :class:`LM` on ``mesh``: its shard of every parameter
    of the full tree ``full`` (the port's own one-device :class:`LM`, on
    any device, or the reference's numpy pytree) by
    ``dist/sharding.py::param_specs``, copied in ``cfg.dtype`` onto
    ``device``, and the :class:`MeshLayout` the entry points run it by.  The
    same full tree gives the same model at every mesh shape."""
    from ..dist import sharding as shr
    dev = resolve_device(device)
    lm = LM(cfg, torch.device("meta"))
    shapes = {name: tuple(p.shape) for name, p in lm.named_parameters()}
    specs = shr.param_specs(shapes, mesh, cfg)
    shardings = shr.spec_to_sharding(specs, mesh)
    source = (dict(full.named_parameters()) if isinstance(full, nn.Module)
              else None)
    with torch.no_grad():
        for name, shape in shapes.items():
            t = (source[name].detach() if source is not None
                 else torch.from_numpy(_numpy_leaf(full, name)))
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: full shape {tuple(t.shape)} vs "
                                 f"{shape}")
            local = shardings[name].local(t).to(dev, cfg.dtype, copy=True)
            module, _, leaf = name.rpartition(".")
            setattr(lm.get_submodule(module) if module else lm, leaf,
                    nn.Parameter(local.contiguous()))
    lm.layout = shr.model_layout(mesh, cfg, specs, shapes)
    return lm


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, lp: Block, x, positions, *, mode,
                cache=None, length=None, backend=None, layout=None):
    """Returns (attn_out, cache_out); cache_out is (k, v) for prefill and
    the updated cache views for decode.  The head counts are the local
    weights' (all of them on one device)."""
    hd = cfg.resolved_head_dim
    bsz, seq, _ = x.shape
    ap = lp.attn
    wk, wv = ap.wk, ap.wv
    split = layout is not None and layout.heads is not None
    take = split and layout.kv_take is not None   # whole wk/wv
    if split:
        x = layers.copy_to_model(x, layout)
        if take:   # each rank reads other kv heads: sum their gradients
            wk = layers.copy_to_model(wk, layout)
            wv = layers.copy_to_model(wv, layout)
    heads = ap.wq.shape[1] // hd
    q = layers.matmul(x, ap.wq).reshape(bsz, seq, heads, hd)
    k = layers.matmul(x, wk).reshape(bsz, seq, wk.shape[1] // hd, hd)
    v = layers.matmul(x, wv).reshape(bsz, seq, wv.shape[1] // hd, hd)
    if cfg.qk_norm:   # the scales are shared by the heads split over model
        q = layers.rmsnorm(ap.q_norm, q, layout=layout if split else None)
        k = layers.rmsnorm(ap.k_norm, k, layout=layout if split else None)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        k_cache, v_cache = cache
        # in place, at the position the 0-d tensor ``length`` holds (the
        # reference donates the cache to the same effect)
        idx = length.reshape(1)
        k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        kc, vc = ((layers.take_kv(k_cache, layout),
                   layers.take_kv(v_cache, layout)) if take
                  else (k_cache, v_cache))
        out = layers.decode_attention(q, kc, vc, length + 1)
        cache_out = (k_cache, v_cache)
    else:
        ka, va = ((layers.take_kv(k, layout), layers.take_kv(v, layout))
                  if take else (k, v))
        out = layers.flash_attention(q, ka, va, causal=True,
                                     backend=backend)
        cache_out = (k, v)
    out = out.reshape(bsz, seq, heads * hd)
    if split:
        return layers.row_parallel(out, ap.wo, layout), cache_out
    return layers.matmul(out, ap.wo), cache_out


def _layer_apply(cfg: ModelConfig, lp: Block, x, positions, *, mode,
                 cache=None, length=None, backend=None, layout=None):
    """One block.  Returns (x, (k, v))."""
    h = layers.norm_apply(cfg.norm, lp.norm1, x)
    attn_out, kv = _attn_block(cfg, lp, h, positions, mode=mode,
                               cache=cache, length=length, backend=backend,
                               layout=layout)
    x = x + attn_out
    h2 = layers.norm_apply(cfg.norm, lp.norm2, x)
    x = x + layers.mlp_apply(lp.mlp, h2, layout)
    return x, kv


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _vocab(params: LM):
    """This rank's ``[first, end)`` rows of a vocab-split table, or
    None."""
    return params.layout.vocab if params.layout is not None else None


def _embed_inputs(cfg: ModelConfig, params: LM,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> embeddings (B, S, d) (no frontend prefix): the
    table's rows, as ``embed[tokens]``; ``F.embedding``'s gradient sums
    repeated tokens in a fixed order on the card.  Vocab-split: each rank
    looks up the tokens in its rows, zeros the rest, and the ranks' sum
    (one of them non-zero) is every token's row."""
    vocab = _vocab(params)
    if vocab is None:
        return F.embedding(tokens, params.embed)
    v0, v1 = vocab
    mine = (tokens >= v0) & (tokens < v1)
    x = F.embedding((tokens - v0).clamp(0, v1 - v0 - 1), params.embed)
    return layers.reduce_from_model(x * mine[..., None].to(x.dtype),
                                    params.layout)


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
    if _vocab(params) is not None:       # gathered along the vocabulary
        out = all_gather_cat(out, params.layout.model_group, dim=1)
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
    rounding it once.

    Vocab-parallel (``group`` the model group, ``w`` this rank's rows from
    ``v0``): a chunk's log-sum-exp comes from an all-reduce of the local
    max, then of the local sums of exponentials with the gold logits (each
    taken on the rank that holds the label's row); the backward forms
    ``softmax - onehot`` on the local columns, sums ``dh`` over the group
    in fp32 and keeps ``dw`` local."""

    @staticmethod
    def forward(h, w, labels, chunk, group=None, v0=0):
        wf = w.to(F32)
        logz = torch.empty(h.shape[0], dtype=F32, device=h.device)
        loss = torch.zeros((), dtype=F32, device=h.device)
        for t0 in range(0, h.shape[0], chunk):
            lc = labels[t0:t0 + chunk]
            logits = h[t0:t0 + chunk].to(F32) @ wf.T
            if group is None:
                lz = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(1, lc.clamp_min(0)[:, None])[:, 0]
            else:
                mx = logits.amax(dim=-1)
                dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
                mine = (lc >= v0) & (lc < v0 + w.shape[0])
                local = (lc - v0).clamp(0, w.shape[0] - 1)
                sums = torch.stack([
                    torch.exp(logits - mx[:, None]).sum(dim=-1),
                    logits.gather(1, local[:, None])[:, 0]
                    * mine.to(F32)])
                dist.all_reduce(sums, group=group)
                lz, gold = mx + torch.log(sums[0]), sums[1]
            loss = loss + torch.sum((lz - gold) * (lc >= 0).to(F32))
            logz[t0:t0 + chunk] = lz
        return loss, logz

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, w, labels, chunk, group, v0 = inputs
        ctx.save_for_backward(h, w, labels, output[1])
        ctx.chunk, ctx.group, ctx.v0 = chunk, group, v0
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
            if ctx.group is None:
                p[rows, lc.clamp_min(0)] -= 1.0
            else:
                mine = (lc >= ctx.v0) & (lc < ctx.v0 + w.shape[0])
                local = (lc - ctx.v0).clamp(0, w.shape[0] - 1)
                p[rows, local] -= mine.to(F32)
            p *= ((lc >= 0).to(F32) * g)[:, None]
            dhc = p @ wf
            if ctx.group is not None:
                dist.all_reduce(dhc, group=ctx.group)
            dh[t0:t0 + ctx.chunk] = dhc.to(h.dtype)
            dw.addmm_(p.T, hc)
        return dh, dw.to(w.dtype), None, None, None, None


def chunked_ce(cfg: ModelConfig, params: LM, hidden: torch.Tensor,
               labels: torch.Tensor):
    """Cross-entropy without a kept ``(T, vocab)`` buffer.

    hidden: (B, S, d); labels: (B, S) with -1 = masked.  Returns
    (loss_mean, n_tokens), both fp32 0-d tensors.  Chunks hold
    ``cfg.ce_chunk`` tokens and the last may be shorter (the reference
    picks a chunk that divides T; the sum is the same).  On a mesh
    ``n_tokens`` is the global batch's count (summed over the data axes)
    and ``loss_mean`` this rank's tokens' share of the global mean: the
    ranks' losses sum to it."""
    bsz, seq, d = hidden.shape
    h2 = hidden.reshape(bsz * seq, d)
    l2 = labels.reshape(bsz * seq).long()
    layout, vocab = params.layout, _vocab(params)
    loss_sum, _ = _ChunkedCE.apply(
        h2, _unembed_w(cfg, params), l2, max(1, cfg.ce_chunk),
        layout.model_group if vocab else None, vocab[0] if vocab else 0)
    count = (l2 >= 0).sum().to(F32)
    if layout is not None and layout.data_group is not None:
        dist.all_reduce(count, group=layout.data_group)
    return loss_sum / count.clamp_min(1.0), count


def _train_block(cfg: ModelConfig, lp: Block, x, positions, backend,
                 layout):
    return _layer_apply(cfg, lp, x, positions, mode="train",
                        backend=backend, layout=layout)[0]


def _run_stack(cfg: ModelConfig, params: LM, x, positions, *,
               backend=None):
    """The layer loop of training: each block under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scanned body), so only the blocks' inputs are kept and the backward
    recomputes one block at a time."""
    for lp in params.layers:
        x = checkpoint(_train_block, cfg, lp, x, positions, backend,
                       params.layout, use_reentrant=False,
                       preserve_rng_state=False)
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
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, bsz, seq, params.layers[0].attn.wk.shape[1]
             // hd, hd)
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
                                 backend=backend, layout=params.layout)
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
                            length=pos, layout=params.layout)
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
