"""B5: fused causal / full GQA flash attention (prefill).

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  For
``q (B, S, H, hd)`` and ``k, v (B, S, KV, hd)`` with ``H % KV == 0`` it
computes ``softmax(q kᵀ / sqrt(hd) + mask) v`` per head, q-head ``h``
reading kv-head ``h // (H // KV)``, with the online-softmax statistics and
the accumulator in fp32 and the output in q's dtype.  The layout at this
boundary is the reference's ``(B, S, H, hd)``.

On a CUDA tensor the wrapper launches the kernel (one CTA of 4 warps per
(batch*head, 64-query block); QKᵀ and P·V on the tensor cores with
``mma.sync`` for bf16 / f16, FFMA for fp32; see the source's note) or
raises; on a CPU
tensor it runs :func:`flash_attention_plain`, chunked online softmax in
plain PyTorch mirroring ``repro/models/layers.py::_flash_body``, which the
tests and ``chip_smoke.py`` hold the kernel against.  The kernel takes what
the reference kernel takes: Sq == Sk (no prefix offset), no sliding window,
hd in {16, 32, 64, 128}, fp32 / bf16 / f16.

``flash_attention.launches`` counts kernel launches (never the plain
version's calls).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "check_inputs",
           "HEAD_DIMS", "NEG_INF"]

HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_F32 = torch.float32


def flash_attention_plain(q, k, v, *, causal: bool, q_chunk: int = 512,
                          k_chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version: online softmax over ``k_chunk``-key chunks
    for each ``q_chunk``-query chunk, in fp32, O(S) memory.  Chunks past the
    causal frontier are skipped; a ragged last chunk is a shorter one.
    Returns ``(B, S, H, hd)`` in q's dtype."""
    bsz, seq, heads, hd = q.shape
    kv = k.shape[2]
    rep = heads // kv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
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
    return out


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
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool,
                    window: int = 0) -> torch.Tensor:
    """B5 on q's device.

    Args:
      q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0, all
         contiguous, one dtype of fp32 / bf16 / f16, hd in
         :data:`HEAD_DIMS`.
      causal: mask keys after the query's position.
      window: must be 0 (the kernel takes no sliding window).
    Returns a new (B, S, H, hd) tensor in q's dtype.
    """
    check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    bsz, seq, heads, hd = q.shape
    if bsz * heads > 65535:
        raise ValueError(f"batch*heads {bsz * heads} exceeds the grid's y "
                         "limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("flash_attention", "flash_attention_fwd",
                          _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bsz, seq, heads, k.shape[2], hd, 1.0 / math.sqrt(hd),
                int(causal), _build.DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
