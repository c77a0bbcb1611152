"""wkv6: the RWKV-6 time-mix recurrence (the ssm family's prefill and
decode).

``wkv6`` is the wrapper of the hand-written CUDA kernel ``csrc/wkv6.cu``.
It replaces no Pallas kernel: the reference runs the recurrence as a
``lax.scan`` over time (``repro/models/rwkv6.py::_wkv_scan``), which in
eager PyTorch would be a Python loop of small launches a time step.  For
``r, k, v, w (B, T, H, N)`` fp32, ``u (H, N)`` fp32 and a state ``S0 (B, H,
N, N)`` fp32 it computes, per step,

    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

and returns ``y (B, T, H, N)`` and ``S_T``, all in fp32 as the reference
streams them.  The state is written **in place** into the caller's
``state`` buffer (the serving pool's slot cache): ``state`` may be ``s0``
itself (a decode step continues a slot's state), and ``s0=None`` starts
from zeros without reading it (a prefill).

On a CUDA tensor the wrapper launches the kernel or raises; the kernel is
built for N = 64 only (rwkv6-3b's head size) and other head sizes raise
``NotImplementedError``.  On a CPU tensor it runs :func:`wkv6_plain`, the
reference's time loop, which the tests and ``chip_smoke.py`` hold the
kernel against (and which takes any N).  ``wkv6.launches`` counts kernel
launches.  The launch is the operator ``torch.ops.repro_torch.wkv6``
(``kernels/_ops.py``), so a ``meta`` or fake trace passes through it as
one operator a layer, with its flop and byte formulas.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _ops

__all__ = ["wkv6", "wkv6_plain", "check_inputs", "HEAD_SIZE"]

HEAD_SIZE = 64
_F32 = torch.float32


def wkv6_plain(r, k, v, w, u, s0=None):
    """Plain PyTorch version: the reference's ``_wkv_scan``, a loop over
    time in fp32.  ``s0=None`` is the zero state.  Returns ``(y, sT)``,
    new tensors."""
    bsz, seq, heads, n = r.shape
    s = (torch.zeros((bsz, heads, n, n), dtype=_F32, device=r.device)
         if s0 is None else s0.to(_F32, copy=True))
    y = torch.empty((bsz, seq, heads, n), dtype=_F32, device=r.device)
    uu = u[None, :, :, None].to(_F32)
    for t in range(seq):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B, H, N, N)
        y[:, t] = torch.einsum("bhn,bhnm->bhm", r[:, t], s + uu * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


def check_inputs(r, k, v, w, u, s0=None, state=None) -> None:
    """What the wrapper takes; raise on the rest."""
    if r.ndim != 4:
        raise ValueError(f"r must be (B, T, H, N); got {tuple(r.shape)}")
    bsz, _, heads, n = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (heads, n):
        raise ValueError(f"u {tuple(u.shape)} must be (H, N) = "
                         f"{(heads, n)}")
    want = (bsz, heads, n, n)
    for name, t in (("s0", s0), ("state", state)):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be (B, H, N, N) "
                             f"= {want}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0), ("state", state)):
        if t is None:
            continue
        if t.dtype != _F32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if state is not None and not state.is_contiguous():
        raise ValueError("state must be contiguous (it is written in place)")


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [ctypes.c_int,
                                                            ctypes.c_void_p]


def wkv6(r, k, v, w, u, s0=None, *, state=None):
    """The recurrence on r's device.

    Args:
      r, k, v, w: (B, T, H, N) fp32.
      u: (H, N) fp32.
      s0: (B, H, N, N) fp32 initial state, or None for zeros.
      state: (B, H, N, N) fp32 contiguous buffer that receives the final
         state in place (default: a new one); may be ``s0`` itself.
    Returns ``(y, state)``: a new (B, T, H, N) fp32 tensor and the buffer.
    """
    check_inputs(r, k, v, w, u, s0, state)
    if r.device.type == "cpu":
        y, s = wkv6_plain(r, k, v, w, u, s0)
        if state is None:
            return y, s
        state.copy_(s)
        return y, state
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6 runs on cuda or cpu tensors (or meta ones), "
                         f"not {r.device}")
    bsz, _, heads, n = r.shape
    if n != HEAD_SIZE:
        raise NotImplementedError(
            f"wkv6: head size {n} is not built; the kernel takes N = "
            f"{HEAD_SIZE} (rwkv6-3b's)")
    if bsz * heads > 65535:
        raise ValueError(f"batch*heads {bsz * heads} exceeds the grid's y "
                         "limit 65535")
    if state is None:
        state = torch.empty((bsz, heads, n, n), dtype=_F32, device=r.device)
    if s0 is not None and s0 is not state:
        state.copy_(s0)
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    y = _ops.dispatch(_OP, _launch, r, r, k, v, w, u, state, s0 is None)
    return y, state


def _launch(r, k, v, w, u, state, zero_init: bool):
    """The CUDA kernel of ``repro_torch::wkv6``."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty(r.shape, dtype=_F32, device=r.device)
    bsz, seq, heads, n = r.shape
    fn = _build.kernel_fn("wkv6", "wkv6_fwd", _ARGTYPES)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(), bsz, seq,
                heads, n, int(zero_init),
                torch.cuda.current_stream(r.device).cuda_stream)
    _build.check_launch("wkv6", rc)
    wkv6.launches += 1
    return y


def _fake(r, k, v, w, u, state, zero_init: bool):
    """The shape function of ``repro_torch::wkv6``."""
    return torch.empty(r.shape, dtype=_F32, device=r.device)


def _flops(r, k, v, w, u, state, zero_init: bool, *, out_shape=None,
           **kwargs) -> int:
    """The kernel's arithmetic: a state element and step take one
    multiply-add for y and a multiply and a multiply-add for its update (5
    flops); the bonus scalar r·(u∘k) 3 flops an element of a step's row,
    and adding it into y 2 a column."""
    bsz, seq, heads, n = r
    return bsz * seq * heads * (5 * n * n + 3 * n + 2 * n)


def _bytes(r, k, v, w, u, state, zero_init: bool, *, out=None) -> int:
    """r, k, v, w and u read once; the state read once (not under
    ``zero_init``) and written once; y written once."""
    reads = sum(_ops.nbytes(t) for t in (r, k, v, w, u))
    return (reads + _ops.nbytes(state) * (1 if zero_init else 2)
            + _ops.nbytes(out))


_OP = _ops.define(
    "wkv6",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor(a!) state, "
    "bool zero_init) -> Tensor",
    _launch, _fake, _flops, _bytes)


wkv6.launches = 0
