"""B5: fused causal / full GQA flash attention (prefill).

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  For
``q (B, S, H, hd)`` and ``k, v (B, S, KV, hd)`` with ``H % KV == 0`` it
computes ``softmax(q kᵀ / sqrt(hd) + mask) v`` per head, q-head ``h``
reading kv-head ``h // (H // KV)``, with the online-softmax statistics and
the accumulator in fp32 and the output in q's dtype.  The layout at this
boundary is the reference's ``(B, S, H, hd)``.

On a CUDA tensor the wrapper launches the kernel or raises.  For bf16 /
f16 one CTA serves a 64-query block of up to 2 q-heads that share a
kv-head (GQA sharing): its thread 0 issues the TMA loads that stage each
K / V tile once for those heads into a ring of 3 shared-memory stages, and
one warpgroup per q-head runs QKᵀ and P·V as ``wgmma`` on the tensor
cores; fp32 runs an FFMA body (one CTA of 4 warps per (batch*head,
64-query block)).  See the source's note.  On a CPU tensor it runs
:func:`flash_attention_plain`, chunked online softmax in plain PyTorch
mirroring ``repro/models/layers.py::_flash_body``, which the tests and
``chip_smoke.py`` hold the kernel against.  The kernel takes what
the reference kernel takes: Sq == Sk (no prefix offset), no sliding window,
hd in {16, 32, 64, 128}, fp32 / bf16 / f16.

``flash_attention.launches`` counts kernel launches (never the plain
version's calls).

Training.  The reference has no backward kernel for B5: its train path
differentiates a jnp attention with XLA.  Here ``return_lse=True`` makes
B5 (and the plain version) also return each row's log-sum-exp ``(B, H,
S)`` in fp32, and :func:`flash_attention_train` is a
``torch.autograd.Function`` whose forward is B5 on ``cuda`` (the plain
version on ``cpu``) and whose backward,
:func:`flash_attention_bwd`, is one chunked PyTorch code path on both
devices: per query chunk it recomputes ``P = exp(QKᵀ·scale - lse)`` under
the mask and forms dV, dP, dS, dQ and dK in fp32, each kv-head's gradient
summed over the q-heads that read it.  A hand-written
backward kernel is later work (ROADMAP queue B).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "check_inputs",
           "flash_attention_train", "flash_attention_bwd", "HEAD_DIMS",
           "NEG_INF", "BWD_CHUNK_ELEMS"]

HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_F32 = torch.float32
# Score elements (queries x keys x heads x batch) the backward holds per
# query chunk, in fp32: 2^26 is 256 MB a buffer.
BWD_CHUNK_ELEMS = 1 << 26


def flash_attention_plain(q, k, v, *, causal: bool, q_chunk: int = 512,
                          k_chunk: int = 512, return_lse: bool = False):
    """Plain PyTorch version: online softmax over ``k_chunk``-key chunks
    for each ``q_chunk``-query chunk, in fp32, O(S) memory.  Chunks past the
    causal frontier are skipped; a ragged last chunk is a shorter one.
    Returns ``(B, S, H, hd)`` in q's dtype, and with ``return_lse`` also
    each row's log-sum-exp ``m + log(l)`` of the scaled, masked scores,
    fp32 ``(B, H, S)``."""
    bsz, seq, heads, hd = q.shape
    kv = k.shape[2]
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
        hi = min(q0 + nq, seq) if causal else seq
        for k0 in range(0, hi, k_chunk):
            kc = k[:, k0:k0 + k_chunk].to(_F32)
            vc = v[:, k0:k0 + k_chunk].to(_F32)
            s = torch.einsum("bqgrh,bkgh->bgrqk", qg, kc) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kc.shape[1],
                                    device=q.device)[None, :]
                s = torch.where(kpos <= qpos, s,
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
    """What the kernel (and the reference kernel) takes; raise on the
    rest."""
    if window:
        raise NotImplementedError(
            "flash_attention (B5) takes no sliding window; windowed "
            "attention comes with the families that use it (ROADMAP A.13)")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, S, H, hd); got ranks "
                         f"{q.ndim}, {k.ndim}, {v.ndim}")
    bsz, seq, heads, hd = q.shape
    if k.shape != v.shape or k.shape[0] != bsz or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, S, KV, hd) matching q {tuple(q.shape)}")
    if k.shape[1] != seq:
        raise NotImplementedError(
            f"flash_attention (B5) needs Sq == Sk (no prefix offset); got "
            f"Sq={seq}, Sk={k.shape[1]}")
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
                ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    return_lse: bool = False):
    """B5 on q's device.

    Args:
      q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0, all
         contiguous, one dtype of fp32 / bf16 / f16, hd in
         :data:`HEAD_DIMS`.
      causal: mask keys after the query's position.
      window: must be 0 (the kernel takes no sliding window).
      return_lse: also return each row's log-sum-exp, fp32 (B, H, S),
         which the kernel writes from its softmax statistics.
    Returns a new (B, S, H, hd) tensor in q's dtype (and the lse).
    """
    check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    bsz, seq, heads, hd = q.shape
    if bsz * heads > 65535:
        raise ValueError(f"batch*heads {bsz * heads} exceeds the grid's y "
                         "limit 65535")
    if seq > 64 * 65535:
        raise ValueError(f"S={seq} exceeds the grid's {64 * 65535} query "
                         "rows")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((bsz, heads, seq), dtype=_F32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _build.kernel_fn("flash_attention", "flash_attention_fwd",
                          _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bsz, seq, heads, k.shape[2], hd, 1.0 / math.sqrt(hd),
                int(causal), _build.DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream,
                None if lse is None else lse.data_ptr())
    _build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# training: the backward and the autograd Function
# ---------------------------------------------------------------------------

def flash_attention_bwd(q, k, v, lse, dout, *, causal: bool,
                        chunk_elems: int = BWD_CHUNK_ELEMS):
    """Gradients of :func:`flash_attention` at ``(q, k, v)``, from its
    log-sum-exp ``lse`` (B, H, S) and the output's cotangent ``dout``.
    Plain PyTorch on any device, in fp32 (half inputs are widened; no
    TF32), one query chunk at a time so no (S, S) buffer is held: for the
    chunk's rows and the keys they see,

        P  = exp(Q Kᵀ scale - lse)         (0 past the causal frontier)
        dV += Pᵀ dO        dP = dO Vᵀ       D = rowsum(P ∘ dP)
        dS = P ∘ (dP - D)  dQ = dS K scale  dK += dSᵀ Q scale

    with the ``rep`` q-heads of a kv-head stacked as rows of one product,
    so each kv-head's dK and dV sum over the heads that read it.  ``D`` is
    the usual ``rowsum(dO ∘ O)`` (O = P V), taken from the fp32 P and dP
    that a chunk holds for all of its rows' keys, so the output's rounding
    to a half dtype does not enter the gradient.  Returns (dq, dk, dv) in
    the inputs' dtype and layout."""
    bsz, seq, heads, hd = q.shape
    kv = k.shape[2]
    rep = heads // kv
    scale = 1.0 / math.sqrt(hd)

    def grouped(t):   # (B, S, H, hd) -> fp32 (B, KV, rep, S, hd)
        return t.to(_F32).reshape(bsz, seq, kv, rep, hd).permute(0, 2, 3, 1,
                                                                  4)
    qg, dog = grouped(q), grouped(dout)
    kh = k.to(_F32).permute(0, 2, 1, 3)     # (B, KV, S, hd)
    vh = v.to(_F32).permute(0, 2, 1, 3)
    lg = lse.reshape(bsz, kv, rep, seq)
    dq = torch.empty((bsz, kv, rep, seq, hd), dtype=_F32, device=q.device)
    dk = torch.zeros((bsz, kv, seq, hd), dtype=_F32, device=q.device)
    dv = torch.zeros((bsz, kv, seq, hd), dtype=_F32, device=q.device)
    q_chunk = max(1, min(seq, chunk_elems // max(1, bsz * heads * seq)))
    for q0 in range(0, seq, q_chunk):
        q1 = min(seq, q0 + q_chunk)
        nq = q1 - q0
        kend = q1 if causal else seq
        rows = (bsz, kv, rep * nq)
        qc = qg[:, :, :, q0:q1].reshape(*rows, hd)
        doc = dog[:, :, :, q0:q1].reshape(*rows, hd)
        kc, vc = kh[:, :, :kend], vh[:, :, :kend]
        s = (qc @ kc.transpose(-1, -2)).view(bsz, kv, rep, nq, kend)
        p = torch.exp(s * scale - lg[:, :, :, q0:q1, None])
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            kpos = torch.arange(kend, device=q.device)[None, :]
            p = p.masked_fill(kpos > qpos, 0.0)
        del s
        p2 = p.view(*rows, kend)
        dv[:, :, :kend] += p2.transpose(-1, -2) @ doc
        dp = (doc @ vc.transpose(-1, -2)).view(bsz, kv, rep, nq, kend)
        delta = (p * dp).sum(-1, keepdim=True)
        ds = (p * (dp - delta)).view(*rows, kend)
        del p, p2, dp, delta
        dq[:, :, :, q0:q1] = (ds @ kc).view(bsz, kv, rep, nq, hd) * scale
        dk[:, :, :kend] += (ds.transpose(-1, -2) @ qc) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(bsz, seq, heads, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


class _FlashAttention(torch.autograd.Function):
    """B5 with a gradient: the forward is B5 (its plain version on a CPU
    tensor), which also returns the log-sum-exp; the backward is
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal, return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.save_for_backward(q, k, v, output[1])
        ctx.causal = causal
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, *, causal: bool):
    """Differentiable B5: as :func:`flash_attention`, recording
    :func:`flash_attention_bwd` as the gradient."""
    check_inputs(q, k, v)
    return _FlashAttention.apply(q, k, v, causal)[0]
