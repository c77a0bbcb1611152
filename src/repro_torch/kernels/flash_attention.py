"""B5: fused causal / windowed / full GQA flash attention (prefill).

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  For
``q (B, Sq, H, hd)`` and ``k, v (B, Sk, KV, hd)`` with ``H % KV == 0`` it
computes ``softmax(q kᵀ / sqrt(hd) + mask) v`` per head, q-head ``h``
reading kv-head ``h // (H // KV)``, with the online-softmax statistics and
the accumulator in fp32 and the output in q's dtype.  The layout at this
boundary is the reference's ``(B, S, H, hd)``.  The mask is the
reference attention's (``repro/models/layers.py::flash_attention``): with
the prefix offset ``off = Sk - Sq``, query ``s`` sees key ``t`` when ``t <=
s + off`` (causal) and ``t > s + off - window`` (``window > 0``).  A row
that no key may see (causal, ``s + off < 0``) gets what the reference's
-1e30 fill gives it, the mean of v over every key, and the log-sum-exp
:data:`NEG_INF`.

On a CUDA tensor the wrapper launches the kernel or raises.  For bf16 /
f16 one CTA serves a 64-query block of up to 2 q-heads that share a
kv-head (GQA sharing): its thread 0 issues the TMA loads that stage each
K / V tile once for those heads into a ring of 3 shared-memory stages, and
one warpgroup per q-head runs QKᵀ and P·V as ``wgmma`` on the tensor
cores; fp32 runs an FFMA body (one CTA of 4 warps per (batch*head,
64-query block)).  See the source's note.  On a CPU tensor it runs
:func:`flash_attention_plain`, chunked online softmax in plain PyTorch
mirroring ``repro/models/layers.py::_flash_body``, which the tests and
``chip_smoke.py`` hold the kernel against.  The kernel takes what the
reference's attention takes: Sq != Sk (the prefix offset, causal or
not), a sliding window, hd in {16, 32, 64, 96, 128}, fp32 / bf16 / f16.

``flash_attention.launches`` counts kernel launches (never the plain
version's calls).  The launch is the operator
``torch.ops.repro_torch.flash_attention`` (``kernels/_ops.py``), so a
``meta`` or fake (``FakeTensorMode``) trace passes through B5 and its
flops count the (query, key) pairs the mask keeps (S(S+1)/2 of a causal
Sq == Sk call).

Training.  The reference has no backward kernel for B5: its train path
differentiates a jnp attention with XLA.  Here ``return_lse=True`` makes
B5 (and the plain version) also return each row's log-sum-exp ``(B, H,
S)`` in fp32, and :func:`flash_attention_train` is a
``torch.autograd.Function`` whose forward is B5 on ``cuda`` (the plain
version on ``cpu``) and whose backward,
:func:`flash_attention_bwd`, is one chunked PyTorch code path on both
devices: per query chunk it recomputes ``P = exp(QKᵀ·scale - lse)`` under
the mask and forms dV, dP, dS, dQ and dK in fp32, each kv-head's gradient
summed over the q-heads that read it; a row no key may see adds its dO /
Sk to every key's dV, as the reference's derivative of its uniform row
does, and nothing to dQ or dK.  A hand-written
backward kernel is later work (ROADMAP queue B).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build, _ops

__all__ = ["flash_attention", "flash_attention_plain", "check_inputs",
           "flash_attention_train", "flash_attention_bwd", "kept_pairs",
           "HEAD_DIMS", "NEG_INF", "BWD_CHUNK_ELEMS"]

HEAD_DIMS = (16, 32, 64, 96, 128)
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_F32 = torch.float32
# Score elements (queries x keys x heads x batch) the backward holds per
# query chunk, in fp32: 2^26 is 256 MB a buffer.
BWD_CHUNK_ELEMS = 1 << 26


def _span(q0: int, q1: int, seq_k: int, causal: bool, window: int,
          off: int) -> tuple:
    """The keys ``[lo, hi)`` that query rows ``[q0, q1)`` may see (every
    key when one of them can see none: the reference's uniform row)."""
    if causal and q0 + off < 0:
        return 0, seq_k
    hi = min(seq_k, q1 + off) if causal else seq_k
    lo = max(0, q0 + off - window + 1) if window else 0
    return lo, hi


def _allowed(qpos, kpos, causal: bool, window: int, off: int):
    """The reference's mask of (qpos, kpos) pairs (broadcast tensors)."""
    allow = torch.ones((), dtype=torch.bool, device=qpos.device)
    if causal:
        allow = allow & (kpos <= qpos + off)
    if window:
        allow = allow & (kpos > qpos + off - window)
    return allow


def flash_attention_plain(q, k, v, *, causal: bool, window: int = 0,
                          q_chunk: int = 512, k_chunk: int = 512,
                          return_lse: bool = False):
    """Plain PyTorch version: online softmax over ``k_chunk``-key chunks
    for each ``q_chunk``-query chunk, in fp32, O(S) memory, masked as the
    reference's ``_flash_body`` (-1e30 where the mask drops a pair).
    Chunks wholly outside a query chunk's keys (past the causal frontier,
    before the window) are skipped, unless a row of the chunk may see no
    key; a ragged last chunk is a shorter one.  Returns ``(B, Sq, H, hd)``
    in q's dtype, and with ``return_lse`` also each row's log-sum-exp ``m +
    log(l)`` of the scaled, masked scores, fp32 ``(B, H, Sq)``."""
    bsz, seq, heads, hd = q.shape
    seq_k, kv = k.shape[1], k.shape[2]
    off = seq_k - seq
    rep = heads // kv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lse = (torch.empty((bsz, heads, seq), dtype=_F32, device=q.device)
           if return_lse else None)
    for q0 in range(0, seq, q_chunk):
        qc = q[:, q0:q0 + q_chunk].to(_F32)
        nq = qc.shape[1]
        qg = qc.reshape(bsz, nq, kv, rep, hd)
        qpos = torch.arange(q0, q0 + nq, device=q.device)[:, None]
        acc = torch.zeros((bsz, kv, rep, nq, hd), dtype=_F32, device=q.device)
        m = torch.full((bsz, kv, rep, nq), NEG_INF, dtype=_F32,
                       device=q.device)
        den = torch.zeros((bsz, kv, rep, nq), dtype=_F32, device=q.device)
        lo, hi = _span(q0, q0 + nq, seq_k, causal, window, off)
        for k0 in range(lo, hi, k_chunk):
            k1 = min(hi, k0 + k_chunk)
            kc = k[:, k0:k1].to(_F32)
            vc = v[:, k0:k1].to(_F32)
            s = torch.einsum("bqgrh,bkgh->bgrqk", qg, kc) * scale
            if causal or window:
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                s = torch.where(_allowed(qpos, kpos, causal, window, off), s,
                                torch.full((), NEG_INF, dtype=_F32,
                                           device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgh->bgrqh",
                                                       p, vc)
            m = m_new
        o = acc / den.clamp_min(1e-30)[..., None]
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4).reshape(
            bsz, nq, heads, hd).to(q.dtype)
        if lse is not None:
            lse[:, :, q0:q0 + nq] = (m + torch.log(den.clamp_min(1e-30))
                                     ).reshape(bsz, heads, nq)
    return (out, lse) if return_lse else out


def check_inputs(q, k, v, window: int = 0) -> None:
    """What the kernel (and the reference's attention) takes; raise on the
    rest."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, S, H, hd); got ranks "
                         f"{q.ndim}, {k.ndim}, {v.ndim}")
    bsz, seq, heads, hd = q.shape
    if k.shape != v.shape or k.shape[0] != bsz or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Sk, KV, hd) matching q {tuple(q.shape)}")
    if k.shape[1] < 1:
        raise ValueError("k and v hold no key (Sk = 0)")
    if int(window) != window or window < 0:
        raise ValueError(f"window must be an int >= 0 (0: none); got "
                         f"{window!r}")
    kv = k.shape[2]
    if kv == 0 or heads % kv:
        raise ValueError(f"H={heads} must be a multiple of KV={kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; the kernel is built "
                         f"for {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64])


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    return_lse: bool = False):
    """B5 on q's device.

    Args:
      q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0, all
         contiguous, one dtype of fp32 / bf16 / f16, hd in
         :data:`HEAD_DIMS`.
      causal: mask keys after the query's position plus Sk - Sq.
      window: 0, or mask keys at or before the query's position plus Sk -
         Sq - window (the reference's sliding window).
      return_lse: also return each row's log-sum-exp, fp32 (B, H, Sq),
         which the kernel writes from its softmax statistics.
    Returns a new (B, Sq, H, hd) tensor in q's dtype (and the lse).
    """
    check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors (or "
                         f"meta ones), not {q.device}")
    bsz, seq, heads, hd = q.shape
    if bsz * heads > 65535:
        raise ValueError(f"batch*heads {bsz * heads} exceeds the grid's y "
                         "limit 65535")
    if seq > 64 * 65535:
        raise ValueError(f"S={seq} exceeds the grid's {64 * 65535} query "
                         "rows")
    out, lse = _ops.dispatch(_OP, _launch_b5, q, q, k, v, causal,
                             return_lse, int(window))
    return (out, lse) if return_lse else out


def _outputs(q, return_lse: bool):
    """B5's output and its lse, ``(0,)`` when not asked for."""
    bsz, seq, heads, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((bsz, heads, seq) if return_lse else (0,), dtype=_F32,
                      device=q.device)
    return out, lse


def _launch_b5(q, k, v, causal: bool, return_lse: bool, window: int):
    """The CUDA kernel of ``repro_torch::flash_attention``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out, lse = _outputs(q, return_lse)
    if out.numel() == 0:
        return out, lse
    bsz, seq, heads, hd = q.shape
    fn = _build.kernel_fn("flash_attention", "flash_attention_fwd",
                          _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bsz, seq, heads, k.shape[2], hd, 1.0 / math.sqrt(hd),
                int(causal), _build.DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream,
                lse.data_ptr() if return_lse else None, k.shape[1], window)
    _build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out, lse


def kept_pairs(seq: int, seq_k: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the mask keeps, per batch row and q-head:
    S(S+1)/2 causal at Sq == Sk, Sq·Sk full; a row that may see no key
    counts Sk (its softmax runs over every key, the reference's uniform
    row)."""
    off = seq_k - seq
    rows = np.arange(seq, dtype=np.int64)
    hi = np.minimum(rows + off + 1, seq_k) if causal else np.full(
        seq, seq_k, np.int64)
    lo = np.maximum(rows + off - window + 1, 0) if window else np.zeros(
        seq, np.int64)
    count = np.clip(hi - lo, 0, None)
    if causal:
        count[rows + off < 0] = seq_k
    return int(count.sum())


def _flops_b5(q, k, v, causal: bool, return_lse: bool, window: int, *,
              out_shape=None, **kwargs) -> int:
    """QKᵀ and P·V, 2 flops a multiply-add each, over the (query, key)
    pairs the mask keeps (:func:`kept_pairs`), per batch and q-head."""
    bsz, seq, heads, hd = q
    return 4 * bsz * heads * hd * kept_pairs(seq, k[1], causal, window)


def _fake_b5(q, k, v, causal: bool, return_lse: bool, window: int):
    """The shape function of ``repro_torch::flash_attention``."""
    return _outputs(q, return_lse)


_OP = _ops.define(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, bool return_lse, "
    "int window) -> (Tensor, Tensor)",
    _launch_b5, _fake_b5, _flops_b5, _ops.io_bytes)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# training: the backward and the autograd Function
# ---------------------------------------------------------------------------

def flash_attention_bwd(q, k, v, lse, dout, *, causal: bool, window: int = 0,
                        chunk_elems: int = BWD_CHUNK_ELEMS):
    """Gradients of :func:`flash_attention` at ``(q, k, v)``, from its
    log-sum-exp ``lse`` (B, H, Sq) and the output's cotangent ``dout``.
    Plain PyTorch on any device, in fp32 (half inputs are widened; no
    TF32), one query chunk at a time so no (Sq, Sk) buffer is held: for
    the chunk's rows and the keys ``[lo, hi)`` they may see,

        P  = exp(Q Kᵀ scale - lse)         (0 where the mask drops a pair)
        dV += Pᵀ dO        dP = dO Vᵀ       D = rowsum(P ∘ dP)
        dS = P ∘ (dP - D)  dQ = dS K scale  dK += dSᵀ Q scale

    with the ``rep`` q-heads of a kv-head stacked as rows of one product,
    so each kv-head's dK and dV sum over the heads that read it.  ``D`` is
    the usual ``rowsum(dO ∘ O)`` (O = P V), taken from the fp32 P and dP
    that a chunk holds for all of its rows' keys, so the output's rounding
    to a half dtype does not enter the gradient.  A row no key may see
    (causal, row + Sk - Sq < 0) is the mean of v in the forward, so it
    adds dO / Sk to every key's dV and nothing to dQ or dK.  Returns (dq,
    dk, dv) in the inputs' dtype and layout."""
    bsz, seq, heads, hd = q.shape
    seq_k, kv = k.shape[1], k.shape[2]
    off = seq_k - seq
    rep = heads // kv
    scale = 1.0 / math.sqrt(hd)

    def grouped(t):   # (B, Sq, H, hd) -> fp32 (B, KV, rep, Sq, hd)
        return t.to(_F32).reshape(bsz, seq, kv, rep, hd).permute(0, 2, 3, 1,
                                                                  4)
    qg, dog = grouped(q), grouped(dout)
    kh = k.to(_F32).permute(0, 2, 1, 3)     # (B, KV, Sk, hd)
    vh = v.to(_F32).permute(0, 2, 1, 3)
    lg = lse.reshape(bsz, kv, rep, seq)
    dq = torch.zeros((bsz, kv, rep, seq, hd), dtype=_F32, device=q.device)
    dk = torch.zeros((bsz, kv, seq_k, hd), dtype=_F32, device=q.device)
    dv = torch.zeros((bsz, kv, seq_k, hd), dtype=_F32, device=q.device)
    dead = min(seq, max(0, -off)) if causal else 0   # rows 0 .. dead - 1
    q_chunk = max(1, min(seq, chunk_elems // max(1, bsz * heads * seq_k)))
    for q0 in range(dead, seq, q_chunk):
        q1 = min(seq, q0 + q_chunk)
        nq = q1 - q0
        lo, hi = _span(q0, q1, seq_k, causal, window, off)
        span = hi - lo
        rows = (bsz, kv, rep * nq)
        qc = qg[:, :, :, q0:q1].reshape(*rows, hd)
        doc = dog[:, :, :, q0:q1].reshape(*rows, hd)
        kc, vc = kh[:, :, lo:hi], vh[:, :, lo:hi]
        s = (qc @ kc.transpose(-1, -2)).view(bsz, kv, rep, nq, span)
        p = torch.exp(s * scale - lg[:, :, :, q0:q1, None])
        if causal or window:
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            kpos = torch.arange(lo, hi, device=q.device)[None, :]
            p = p.masked_fill(~_allowed(qpos, kpos, causal, window, off),
                              0.0)
        del s
        p2 = p.view(*rows, span)
        dv[:, :, lo:hi] += p2.transpose(-1, -2) @ doc
        dp = (doc @ vc.transpose(-1, -2)).view(bsz, kv, rep, nq, span)
        delta = (p * dp).sum(-1, keepdim=True)
        ds = (p * (dp - delta)).view(*rows, span)
        del p, p2, dp, delta
        dq[:, :, :, q0:q1] = (ds @ kc).view(bsz, kv, rep, nq, hd) * scale
        dk[:, :, lo:hi] += (ds.transpose(-1, -2) @ qc) * scale
    if dead:   # the uniform rows: dV += their dO / Sk at every key
        dv += dog[:, :, :, :dead].sum(dim=(2, 3))[:, :, None] / seq_k
    dq = dq.permute(0, 3, 1, 2, 4).reshape(bsz, seq, heads, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


class _FlashAttention(torch.autograd.Function):
    """B5 with a gradient: the forward is B5 (its plain version on a CPU
    tensor), which also returns the log-sum-exp; the backward is
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v, output[1])
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal: bool, window: int = 0):
    """Differentiable B5: as :func:`flash_attention`, recording
    :func:`flash_attention_bwd` as the gradient."""
    check_inputs(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window)[0]
