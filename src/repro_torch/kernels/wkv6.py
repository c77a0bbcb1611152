"""wkv6: the RWKV-6 time-mix recurrence (the ssm family's prefill,
decode and training).

``wkv6`` and ``wkv6_bwd`` are the wrappers of the hand-written CUDA
kernels in ``csrc/wkv6.cu``.  They replace no Pallas kernel: the
reference runs the recurrence as a ``lax.scan`` over time
(``repro/models/rwkv6.py::_wkv_scan``), which XLA compiles and, in
training, differentiates; in eager PyTorch that would be a Python loop of
small launches a time step.  For ``r, k, v, w (B, T, H, N)`` fp32, ``u (H,
N)`` fp32 and a state ``S0 (B, H, N, N)`` fp32 the forward computes, per
step,

    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

and returns ``y (B, T, H, N)`` and ``S_T``, all in fp32 as the reference
streams them.  The state is written **in place** into the caller's
``state`` buffer (the serving pool's slot cache): ``state`` may be ``s0``
itself (a decode step continues a slot's state), and ``s0=None`` starts
from zeros without reading it (a prefill).  With ``snapshots=True`` (the
training forward) it also returns the state before every
:data:`SNAP_EVERY`-th step, ``(ceil(T / 8), B, H, N, N)``, which
``wkv6_bwd`` reads; the serving launch writes none.

``wkv6_bwd`` takes the output's gradient ``dy`` (and the final state's,
``dsT``) and returns ``dr, dk, dv, dw`` (B, T, H, N), ``du`` (H, N) and
``ds0`` (B, H, N, N), recomputing the states a window of 8 steps at a time
from the snapshots (see the source's note); two calls give the same bits.
:func:`wkv6_train` is the ``torch.autograd.Function`` of the pair: the
kernels on ``cuda``; on ``cpu`` the plain versions, which keep ``s0`` in
place of the snapshots; it writes no buffer of its caller.

On a CUDA tensor each wrapper launches its kernel or raises; the kernels
are built for N = 64 only (rwkv6-3b's head size) and other head sizes
raise ``NotImplementedError``.  On a CPU tensor they run
:func:`wkv6_plain` and :func:`wkv6_bwd_plain`, the reference's time loop
and its reverse-time derivative, which the tests and ``chip_smoke.py``
hold the kernels against (and which take any N).  ``wkv6.launches`` and
``wkv6_bwd.launches`` count kernel launches.  The launches are the
operators ``torch.ops.repro_torch.wkv6`` and ``repro_torch.wkv6_bwd``
(``kernels/_ops.py``), so a ``meta`` or fake trace passes through each as
one operator a layer, with its flop and byte formulas.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _ops

__all__ = ["wkv6", "wkv6_plain", "wkv6_bwd", "wkv6_bwd_plain",
           "wkv6_train", "check_inputs", "HEAD_SIZE", "SNAP_EVERY"]

HEAD_SIZE = 64
# Steps between the training forward's state snapshots (csrc/wkv6.cu's
# kSnap).
SNAP_EVERY = 8
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


def _plain_snapshots(r, k, v, w, u, s0):
    """:func:`wkv6_plain` a :data:`SNAP_EVERY`-step window at a time:
    ``(y, sT, snap)``, ``snap`` the state before each window (the CUDA
    forward's snapshots)."""
    bsz, seq, heads, n = r.shape
    s = (torch.zeros((bsz, heads, n, n), dtype=_F32, device=r.device)
         if s0 is None else s0.to(_F32, copy=True))
    ys, snaps = [], []
    for t0 in range(0, seq, SNAP_EVERY):
        snaps.append(s)
        y, s = wkv6_plain(*(x[:, t0:t0 + SNAP_EVERY] for x in (r, k, v, w)),
                          u, s)
        ys.append(y)
    y = (torch.cat(ys, 1) if ys else
         torch.empty((bsz, 0, heads, n), dtype=_F32, device=r.device))
    snap = (torch.stack(snaps) if snaps else
            torch.empty((0, bsz, heads, n, n), dtype=_F32, device=r.device))
    return y, s, snap


def wkv6_bwd_plain(r, k, v, w, u, dy, s0=None, dsT=None):
    """Plain PyTorch version of the backward: the states by the forward
    loop, then the state's gradient ``G`` back in time, in fp32 (the
    source's note has the formulas).  ``s0`` / ``dsT`` None are zeros.
    Returns ``(dr, dk, dv, dw, du, ds0)``, new tensors."""
    bsz, seq, heads, n = r.shape
    dev = r.device
    s = (torch.zeros((bsz, heads, n, n), dtype=_F32, device=dev)
         if s0 is None else s0.to(_F32))
    states = []
    for t in range(seq):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    g = (torch.zeros((bsz, heads, n, n), dtype=_F32, device=dev)
         if dsT is None else dsT.to(_F32, copy=True))
    dr, dk, dv, dw = (torch.empty((bsz, seq, heads, n), dtype=_F32,
                                  device=dev) for _ in range(4))
    du = torch.zeros((heads, n), dtype=_F32, device=dev)
    uu = u.to(_F32)[None]                                   # (1, H, N)
    for t in reversed(range(seq)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (r, k, v, w, dy))
        sp = states[t]
        dr[:, t] = torch.einsum(
            "bhnm,bhm->bhn", sp + (uu * kt)[..., None] * vt[..., None, :], dyt)
        gb = g + (rt * uu)[..., None] * dyt[..., None, :]
        dk[:, t] = torch.einsum("bhnm,bhm->bhn", gb, vt)
        dv[:, t] = torch.einsum("bhnm,bhn->bhm", gb, kt)
        dw[:, t] = (sp * g).sum(-1)
        du += (rt * kt * (dyt * vt).sum(-1, keepdim=True)).sum(0)
        g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, g


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


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _kernel_shape(r) -> None:
    """Raise for what the CUDA kernels are not built for."""
    bsz, _, heads, n = r.shape
    if n != HEAD_SIZE:
        raise NotImplementedError(
            f"wkv6: head size {n} is not built; the kernel takes N = "
            f"{HEAD_SIZE} (rwkv6-3b's)")
    if bsz * heads > 65535:
        raise ValueError(f"batch*heads {bsz * heads} exceeds the grid's y "
                         "limit 65535")


def _on_card(r, what: str) -> bool:
    """False for a CPU tensor (the plain version's), True for a CUDA or
    ``meta`` one; raise for any other device."""
    if r.device.type == "cpu":
        return False
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what} runs on cuda or cpu tensors (or meta "
                         f"ones), not {r.device}")
    return True


def wkv6(r, k, v, w, u, s0=None, *, state=None, snapshots: bool = False):
    """The recurrence on r's device.

    Args:
      r, k, v, w: (B, T, H, N) fp32.
      u: (H, N) fp32.
      s0: (B, H, N, N) fp32 initial state, or None for zeros.
      state: (B, H, N, N) fp32 contiguous buffer that receives the final
         state in place (default: a new one); may be ``s0`` itself.
      snapshots: also return the state before every :data:`SNAP_EVERY`-th
         step (the training forward; :func:`wkv6_bwd`'s input).
    Returns ``(y, state)``: a new (B, T, H, N) fp32 tensor and the buffer;
    with ``snapshots`` also ``(ceil(T / 8), B, H, N, N)`` fp32.
    """
    check_inputs(r, k, v, w, u, s0, state)
    if not _on_card(r, "wkv6"):
        y, s, *snap = (_plain_snapshots(r, k, v, w, u, s0) if snapshots
                       else wkv6_plain(r, k, v, w, u, s0))
        if state is not None:
            s = state.copy_(s)
        return (y, s, *snap)
    _kernel_shape(r)
    bsz, _, heads, n = r.shape
    if state is None:
        state = torch.empty((bsz, heads, n, n), dtype=_F32, device=r.device)
    if s0 is not None and s0 is not state:
        state.copy_(s0)
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    y, snap = _ops.dispatch(_OP, _launch, r, r, k, v, w, u, state,
                            s0 is None, snapshots)
    return (y, state, snap) if snapshots else (y, state)


def _outputs(r, snapshots: bool):
    """y, and the snapshots' buffer (``(0,)`` when not asked for)."""
    bsz, seq, heads, n = r.shape
    snap_shape = ((-(-seq // SNAP_EVERY), bsz, heads, n, n) if snapshots
                  else (0,))
    return (torch.empty(r.shape, dtype=_F32, device=r.device),
            torch.empty(snap_shape, dtype=_F32, device=r.device))


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(r, k, v, w, u, state, zero_init: bool, snapshots: bool):
    """The CUDA kernel of ``repro_torch::wkv6``."""
    _aligned(r=r, k=k, v=v, w=w)
    y, snap = _outputs(r, snapshots)
    bsz, seq, heads, n = r.shape
    fn = _build.kernel_fn("wkv6", "wkv6_fwd", _ARGTYPES)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(), bsz, seq,
                heads, n, int(zero_init),
                torch.cuda.current_stream(r.device).cuda_stream,
                snap.data_ptr() if snapshots else None)
    _build.check_launch("wkv6", rc)
    wkv6.launches += 1
    return y, snap


def _fake(r, k, v, w, u, state, zero_init: bool, snapshots: bool):
    """The shape function of ``repro_torch::wkv6``."""
    return _outputs(r, snapshots)


def _flops(r, k, v, w, u, state, zero_init: bool, snapshots: bool, *,
           out_shape=None, **kwargs) -> int:
    """The kernel's arithmetic: a state element and step take one
    multiply-add for y and a multiply and a multiply-add for its update (5
    flops); the bonus scalar r·(u∘k) 3 flops an element of a step's row,
    and adding it into y 2 a column."""
    bsz, seq, heads, n = r
    return bsz * seq * heads * (5 * n * n + 3 * n + 2 * n)


def _bytes(r, k, v, w, u, state, zero_init: bool, snapshots: bool, *,
           out=None) -> int:
    """r, k, v, w and u read once; the state read once (not under
    ``zero_init``) and written once; y written once.  The snapshots are
    the pair's workspace, not the function's output, and are not
    counted."""
    reads = sum(_ops.nbytes(t) for t in (r, k, v, w, u))
    return (reads + _ops.nbytes(state) * (1 if zero_init else 2)
            + _ops.nbytes(out[0]))


_OP = _ops.define(
    "wkv6",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor(a!) state, "
    "bool zero_init, bool snapshots) -> (Tensor, Tensor)",
    _launch, _fake, _flops, _bytes)


wkv6.launches = 0


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 4 + [
    ctypes.c_void_p]


def wkv6_bwd(r, k, v, w, u, dy, snap, dsT=None):
    """Gradients of :func:`wkv6` on r's device, from the forward's
    snapshots ``snap`` (``wkv6(..., snapshots=True)``; its first is the
    initial state) and the cotangents ``dy (B, T, H, N)`` and ``dsT (B, H,
    N, N)`` (None: zeros), all fp32.  Returns ``(dr, dk, dv, dw, du,
    ds0)``, new fp32 tensors of the inputs' shapes."""
    check_inputs(r, k, v, w, u, dsT)
    bsz, seq, heads, n = r.shape
    if tuple(dy.shape) != tuple(r.shape) or dy.dtype != _F32:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must be fp32 "
                         f"{tuple(r.shape)}")
    want = (-(-seq // SNAP_EVERY), bsz, heads, n, n)
    if tuple(snap.shape) != want or snap.dtype != _F32:
        raise ValueError(f"snap {tuple(snap.shape)} {snap.dtype} must be "
                         f"fp32 {want} (wkv6(..., snapshots=True))")
    if not _on_card(r, "wkv6_bwd"):
        return wkv6_bwd_plain(r, k, v, w, u, dy, snap[0] if seq else None,
                              dsT)
    _kernel_shape(r)
    args = [t.contiguous() for t in (r, k, v, w, u, dy, snap)]
    return _ops.dispatch(_BWD_OP, _launch_bwd, r, *args,
                         None if dsT is None else dsT.contiguous())


def _bwd_outputs(r):
    bsz, _, heads, n = r.shape
    return tuple(torch.empty(shape, dtype=_F32, device=r.device)
                 for shape in (r.shape, r.shape, r.shape, r.shape,
                               (heads, n), (bsz, heads, n, n)))


def _launch_bwd(r, k, v, w, u, dy, snap, dsT):
    """The CUDA kernel of ``repro_torch::wkv6_bwd``: one CTA a (b, h),
    each writing its batch row's share of du, summed here in batch
    order."""
    _aligned(r=r, k=k, v=v, w=w, dy=dy)
    dr, dk, dv, dw, _, ds0 = _bwd_outputs(r)
    bsz, seq, heads, n = r.shape
    du_part = torch.empty((bsz, heads, n), dtype=_F32, device=r.device)
    fn = _build.kernel_fn("wkv6", "wkv6_bwd", _BWD_ARGTYPES)
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, dy, snap)]
    ptrs.append(None if dsT is None else dsT.data_ptr())
    ptrs += [t.data_ptr() for t in (dr, dk, dv, dw, du_part, ds0)]
    with torch.cuda.device(r.device):
        rc = fn(*ptrs, bsz, seq, heads, n,
                torch.cuda.current_stream(r.device).cuda_stream)
    _build.check_launch("wkv6_bwd", rc)
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du_part.sum(0), ds0


def _fake_bwd(r, k, v, w, u, dy, snap, dsT):
    """The shape function of ``repro_torch::wkv6_bwd``."""
    return _bwd_outputs(r)


def _flops_bwd(r, k, v, w, u, dy, snap, dsT, *, out_shape=None,
               **kwargs) -> int:
    """The function's arithmetic: a state element and step take 14 flops
    (the recomputed update 3; dr's, dk's, dw's and dv's products and sums
    2 each; G's update 3); a step's row 15, the bonus terms as row
    scalars (sum r∘u∘k 3, dy·v 2, dv's bonus 2, dr's u∘k and its bonus 3,
    dk's 2 on r∘u, du's r∘k and its sum 3)."""
    bsz, seq, heads, n = r
    return bsz * seq * heads * (14 * n * n + 15 * n)


def _bytes_bwd(r, k, v, w, u, dy, snap, dsT, *, out=None) -> int:
    """r, k, v, w, u, dy (and dsT) read once, the six gradients written
    once; the snapshots (the pair's workspace) and du's per-batch shares
    are not counted."""
    reads = sum(_ops.nbytes(t) for t in (r, k, v, w, u, dy, dsT)
                if t is not None)
    return reads + sum(_ops.nbytes(t) for t in out)


_BWD_OP = _ops.define(
    "wkv6_bwd",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor dy, "
    "Tensor snap, Tensor? dsT) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor)",
    _launch_bwd, _fake_bwd, _flops_bwd, _bytes_bwd)


wkv6_bwd.launches = 0


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

class _WKV6(torch.autograd.Function):
    """The recurrence with a gradient: on the card the forward is
    :func:`wkv6` with snapshots and the backward :func:`wkv6_bwd` on
    them; on the CPU :func:`wkv6_plain` and :func:`wkv6_bwd_plain`, which
    keeps ``s0`` instead (its third output is empty)."""

    @staticmethod
    def forward(r, k, v, w, u, s0):
        if _on_card(r, "wkv6_train"):
            return wkv6(r, k, v, w, u, s0, snapshots=True)
        return (*wkv6_plain(r, k, v, w, u, s0), r.new_empty((0,)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, w, u, s0 = inputs
        ctx.on_card = r.device.type != "cpu"
        ctx.save_for_backward(r, k, v, w, u,
                              output[2] if ctx.on_card else s0)
        ctx.has_s0 = s0 is not None
        ctx.mark_non_differentiable(output[2])

    @staticmethod
    def backward(ctx, dy, dsT, _dsnap):
        r, k, v, w, u, saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        bwd = wkv6_bwd if ctx.on_card else wkv6_bwd_plain
        dr, dk, dv, dw, du, ds0 = bwd(r, k, v, w, u, dy.contiguous(), saved,
                                      dsT)
        return dr, dk, dv, dw, du, ds0 if ctx.has_s0 else None


def wkv6_train(r, k, v, w, u, s0=None):
    """Differentiable :func:`wkv6`: ``(y, sT)``, new tensors (no buffer of
    the caller's is written), recording :func:`wkv6_bwd` as the
    gradient."""
    check_inputs(r, k, v, w, u, s0)
    y, s_t, _ = _WKV6.apply(r, k, v, w, u, s0)
    return y, s_t
