"""SpMM execution engine: the one dispatch layer over the kernels.

Port of ``repro/kernels/engine.py``.  It holds the decisions every entry
point shares:

  * **device** -- :func:`resolve_device`: ``None`` means CUDA, and a call
    without a GPU raises instead of running elsewhere;
  * **backend** -- :func:`resolve_backend`: ``"cuda"`` (default) runs the
    panel path through the kernel wrappers, which launch the hand-written
    CUDA kernels on CUDA tensors and run their plain PyTorch panel versions
    on CPU tensors; ``"torch"`` runs the flat PyTorch references of
    ``kernels/ref.py`` (the reference's ``jnp`` backend) on any device;
  * **precision** -- :func:`acc_dtype_for` / :func:`resolve_dtypes`:
    {bf16, f16} accumulate in fp32, fp32 and fp64 accumulate in their own
    type;
  * **shape contract** -- :func:`check_rhs`: the dense operand is
    ``(..., K, N)``; leading dims fold into the kernels' batch dimension
    (:func:`flatten_batch`), which is the CUDA grid's z axis;
  * the ``(part, op)`` kernel registry and the structural tracer hook
    (:func:`set_tracer`), with the reference's fields;
  * live values -- :func:`panel_values`: trainable stored values are
    scattered into the uploaded panel structure on every call
    (``csr_vals=``/``bcsr_vals=`` on the entry points), and
    :func:`loops_sdd` returns the gradient at the stored values.

The four entry points (:func:`csr_spmm`, :func:`bcsr_spmm`,
:func:`loops_spmm_fused`, :func:`loops_sdd`) run their backend through
:func:`repro_torch.resilience.fallback.run_chain`: each attempt passes the
fault point ``engine.{part}.{op}.{link}``.  The chains (``cuda → torch``)
are off unless a caller installs ``set_policy(FallbackPolicy())``, so by
default a kernel that fails to build or launch raises; opted in, a failure
that raises synchronously degrades to the flat references with an
``engine.fallback`` counter (``resilience/fallback.py`` says what a chain
cannot catch).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..resilience import fallback as _fallback
from .panel_common import default_bn

__all__ = [
    "acc_dtype_for", "resolve_dtypes", "torch_dtype", "resolve_device",
    "resolve_backend", "as_operand", "check_rhs", "flatten_batch",
    "unflatten_batch", "batch_block", "padded_batch", "MAX_BATCH_BLOCK",
    "register_kernel", "get_kernel", "panel_values", "csr_spmm",
    "bcsr_spmm", "loops_spmm_fused", "loops_sdd", "set_tracer",
    "get_tracer", "BACKENDS",
]

# Batch slices per grid step of the reference's TPU kernels.  The CUDA
# kernels take the whole batch on grid.z; the value stays for the
# structural step counts (``core.spmm.loops_batched_grid_steps``) and the
# serve layer's mirror of them.
MAX_BATCH_BLOCK = 8

BACKENDS = ("cuda", "torch")

_HALF = (torch.float16, torch.bfloat16)


# ---------------------------------------------------------------------------
# precision promotion
# ---------------------------------------------------------------------------

def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or numpy type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def acc_dtype_for(dtype) -> torch.dtype:
    """fp32 accumulation for half precision, else the input precision
    (fp64 stays fp64)."""
    dtype = torch_dtype(dtype)
    return torch.float32 if dtype in _HALF else dtype


def resolve_dtypes(value_dtype, out_dtype) -> Tuple[torch.dtype, torch.dtype]:
    """``(accumulation dtype, output dtype)`` for stored values of
    ``value_dtype``; ``out_dtype`` overrides the output only."""
    acc = acc_dtype_for(value_dtype)
    return acc, (torch_dtype(out_dtype) if out_dtype is not None else acc)


# ---------------------------------------------------------------------------
# device and backend pick
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """``None`` -> the current CUDA device.  Raises when CUDA is asked for
    and absent: the port never moves work to the CPU on its own.

    ``meta`` is accepted (shapes only), and so is a ``cuda`` device that
    the process lacks while a ``FakeTensorMode`` is active: a fake trace
    (``launch/dryrun.py``) launches nothing, so it needs no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or "
                         "meta")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            if _fake_mode_active():
                return torch.device("cuda", dev.index or 0)
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch mode stack."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def resolve_backend(backend: str | None) -> str:
    """Normalise a caller's backend choice (``None`` -> ``"cuda"``)."""
    backend = backend or "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def as_operand(b, device: torch.device) -> torch.Tensor:
    """``b`` as a tensor on ``device``: arrays are copied there; a tensor on
    another device raises (no silent transfer)."""
    if not isinstance(b, torch.Tensor):
        return torch.as_tensor(np.asarray(b), device=device)
    if b.device != device:
        raise ValueError(f"dense operand is on {b.device} but the call runs "
                         f"on {device}; pass device= or move the operand")
    return b


# ---------------------------------------------------------------------------
# the (..., K, N) shape contract
# ---------------------------------------------------------------------------

def check_rhs(ncols: int, b, *, what: str = "B") -> None:
    """Validate the dense operand's shape ``(..., K, N)`` against A's column
    count, raising a clear ValueError on a rank or contraction mismatch."""
    if b.ndim < 2:
        raise ValueError(
            f"dense operand {what} must have shape (..., K, N); got rank "
            f"{b.ndim} with shape {tuple(b.shape)}")
    if b.shape[-2] != ncols:
        raise ValueError(
            f"dense operand {what} has K={b.shape[-2]} rows but A has "
            f"ncols={ncols}; shapes must contract as (M, K) @ (..., K, N)")


def flatten_batch(b: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``(..., K, N)`` -> ``((B, K, N), leading batch shape)``; a rank-2
    operand becomes one slice.  The result is contiguous, as the kernels
    take it (a no-op for a contiguous operand)."""
    batch = tuple(b.shape[:-2])
    return b.reshape((-1,) + tuple(b.shape[-2:])).contiguous(), batch


def unflatten_batch(out: torch.Tensor, batch: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`flatten_batch` on the output's leading dim."""
    return out.reshape(batch + tuple(out.shape[-2:]))


def batch_block(batch: int) -> int:
    """The reference's batch slices per grid step: the largest divisor of
    ``batch`` that is <= :data:`MAX_BATCH_BLOCK`."""
    if batch <= 0:
        return 1
    for d in range(min(batch, MAX_BATCH_BLOCK), 0, -1):
        if batch % d == 0:
            return d
    return 1


def padded_batch(batch: int) -> int:
    """The reference's flat batch after zero-padding to the step-minimising
    block (12 stays 12 with bz=6; 11 pads to 16 with bz=8).  The CUDA
    kernels need no padding; this stays for the structural counts."""
    if batch <= 0:
        return batch
    bz_pad = min(batch, MAX_BATCH_BLOCK)
    groups_pad = -(-batch // bz_pad)
    if groups_pad < batch // batch_block(batch):
        return groups_pad * bz_pad
    return batch


def _empty_batch(b) -> bool:
    return any(d == 0 for d in b.shape[:-2])


# ---------------------------------------------------------------------------
# dispatch tracer
# ---------------------------------------------------------------------------

# A single process-wide tracer hook.  The entry points call ``_note`` with
# the reference's STRUCTURAL dispatch facts (which kernel flavour ran, how
# many panels/nonzeros it walks, the flat batch and column extents), once
# per dispatch.  No wall-clock time is recorded here.
_TRACER = None


def set_tracer(tracer):
    """Install ``tracer`` (an object with ``on_dispatch(**fields)``, or
    ``None`` to detach); returns the previous tracer."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def get_tracer():
    return _TRACER


def _note(part: str, op: str, **fields) -> None:
    if _TRACER is None:
        return
    if "steps" not in fields:
        units = int(fields.get("units", 0))
        nb = int(fields.get("batch", 1))
        if fields.get("impl") == "ref":
            fields["steps"] = units
        else:
            fields["steps"] = units * max(-(-nb // batch_block(nb)), 1)
    _TRACER.on_dispatch(part=part, op=op, **fields)


def _panel_note_fields(*, part: str, depth: int, npanels: int, nb: int,
                       n: int, g: int, br: int, b_dtype,
                       value_dtype) -> dict:
    """The reference's pipeline fields for a G-wide panel dispatch, computed
    from the same structure (``steps`` with the ``depth - 1`` ramp,
    ``scratch_bytes`` of the TPU kernel's VMEM scratch, and
    ``prefetch_overlap``), so traces of the two packages compare."""
    groups = max(-(-nb // batch_block(nb)), 1)
    bz = batch_block(nb)
    bn_eff = default_bn(n)
    acc = acc_dtype_for(value_dtype)
    acc_rows = br if part == "bcsr" else 1
    scratch = bz * acc_rows * bn_eff * acc.itemsize
    b_item = torch_dtype(b_dtype).itemsize
    if part == "bcsr":
        bpan_elems = max(depth, 1) * g * bn_eff * bz
    else:
        bpan_elems = depth * g * bn_eff * bz if depth > 1 else 0
    steps = npanels + depth - 1
    overlap = (max(npanels - 1, 0) / steps) if depth > 1 else 0.0
    return {"pipeline_depth": depth,
            "steps": steps * groups,
            "scratch_bytes": int(scratch + bpan_elems * b_item),
            "prefetch_overlap": float(overlap)}


# ---------------------------------------------------------------------------
# kernel registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[Tuple[str, str], Dict[str, Callable]] = {}
_POPULATED = False


def register_kernel(part: str, op: str, impl: str, fn: Callable) -> Callable:
    """Register ``fn`` under ``(part, op)`` with flavour ``impl`` ∈
    {"panels" (kernel wrapper), "ref" (flat torch reference)}; ``op`` is
    "spmm" or "sdd"."""
    _REGISTRY.setdefault((part, op), {})[impl] = fn
    return fn


def get_kernel(part: str, op: str, impl: str = "panels") -> Callable:
    """Resolve a registered kernel, importing the kernel modules (which
    register themselves) on first use."""
    global _POPULATED
    if not _POPULATED:
        from . import bcsr_spmm, csr_spmm, ref, spmm_sdd  # noqa: F401
        _POPULATED = True
    try:
        return _REGISTRY[(part, op)][impl]
    except KeyError:
        raise KeyError(f"no kernel registered for part={part!r} op={op!r} "
                       f"impl={impl!r}; known: {sorted(_REGISTRY)}") from None


# ---------------------------------------------------------------------------
# dispatch entry points
# ---------------------------------------------------------------------------

def _value_tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device)


def panel_values(panels, vals) -> torch.Tensor:
    """The panel values a kernel runs with: the uploaded
    ``panels.vals``, or live item values ``vals`` scattered into the same
    structure (the one copy per call of a trainable layer)."""
    return panels.vals if vals is None else panels.scatter_values(vals)


def csr_spmm(csr, b: torch.Tensor, *, backend: str | None = None,
             out_dtype=None, panels=None, vals=None) -> torch.Tensor:
    """SpMM of a ``repro_torch.core.formats.CSR`` against dense ``b``
    (..., K, N) on ``b``'s device.  The ``"cuda"`` backend needs
    ``panels``, the part's :class:`~repro_torch.core.formats.DevicePanels`
    on that device.  ``vals`` -- optional live ``(nnz,)`` values replacing
    ``csr.vals``."""
    backend = resolve_backend(backend)
    check_rhs(csr.ncols, b)
    _, out = resolve_dtypes(csr.vals.dtype if vals is None else vals.dtype,
                            out_dtype)
    if _empty_batch(b):
        return torch.zeros(b.shape[:-2] + (csr.nrows, b.shape[-1]),
                           dtype=out, device=b.device)
    b3, batch = flatten_batch(b)
    n = int(b.shape[-1])
    if backend == "cuda" and panels is None:
        raise ValueError("the cuda backend needs the part's device panels")

    def attempt(bk: str) -> torch.Tensor:
        if bk == "torch":
            _note("csr", "spmm", backend=bk, impl="ref", units=csr.nnz,
                  batch=1, n=n)
            dev = b.device
            v = _value_tensor(csr.vals, dev) if vals is None else vals
            y = get_kernel("csr", "spmm", "ref")(
                _value_tensor(csr.row_ids, dev),
                _value_tensor(csr.col_idx, dev), v, b3, csr.nrows,
                out_dtype=out)
            return unflatten_batch(y, batch)
        pvals = panel_values(panels, vals)
        nb = padded_batch(int(b3.shape[0]))
        _note("csr", "spmm", backend=bk, impl="panels",
              units=int(panels.rows.shape[0]), batch=nb, n=n,
              **_panel_note_fields(part="csr", depth=1,
                                   npanels=int(panels.rows.shape[0]), nb=nb,
                                   n=n, g=int(panels.cols.shape[1]), br=1,
                                   b_dtype=b.dtype, value_dtype=pvals.dtype))
        y = get_kernel("csr", "spmm", "panels")(
            panels.rows, panels.cols, pvals, panels.mask, b3,
            nrows=csr.nrows, units=panels.units, out_dtype=out,
            live=panels.live)
        return unflatten_batch(y, batch)

    return _fallback.run_chain("csr", "spmm", backend, attempt)


def bcsr_spmm(bcsr, b: torch.Tensor, *, backend: str | None = None,
              out_dtype=None, panels=None, vals=None) -> torch.Tensor:
    """SpMM of a ``repro_torch.core.formats.VectorBCSR`` against dense
    ``b``; returns the logical (..., bcsr.nrows, N) rows (padding rows
    trimmed).  The ``"cuda"`` backend needs the part's ``panels``.
    ``vals`` -- optional live ``(ntiles, Br)`` values replacing
    ``bcsr.tile_vals``."""
    backend = resolve_backend(backend)
    check_rhs(bcsr.ncols, b)
    _, out = resolve_dtypes(
        bcsr.tile_vals.dtype if vals is None else vals.dtype, out_dtype)
    if _empty_batch(b):
        return torch.zeros(b.shape[:-2] + (bcsr.nrows, b.shape[-1]),
                           dtype=out, device=b.device)
    b3, batch = flatten_batch(b)
    n = int(b.shape[-1])
    if backend == "cuda" and panels is None:
        raise ValueError("the cuda backend needs the part's device panels")

    def attempt(bk: str) -> torch.Tensor:
        if bk == "torch":
            _note("bcsr", "spmm", backend=bk, impl="ref",
                  units=int(bcsr.ntiles), batch=1, n=n)
            dev = b.device
            v = _value_tensor(bcsr.tile_vals, dev) if vals is None else vals
            y = get_kernel("bcsr", "spmm", "ref")(
                _value_tensor(bcsr.tile_rows, dev),
                _value_tensor(bcsr.tile_cols, dev), v, b3, bcsr.nblocks,
                out_dtype=out)
            return unflatten_batch(y[:, :bcsr.nrows], batch)
        pvals = panel_values(panels, vals)
        nb = padded_batch(int(b3.shape[0]))
        _note("bcsr", "spmm", backend=bk, impl="panels",
              units=int(panels.rows.shape[0]), batch=nb, n=n,
              **_panel_note_fields(part="bcsr", depth=1,
                                   npanels=int(panels.rows.shape[0]), nb=nb,
                                   n=n, g=int(panels.cols.shape[1]),
                                   br=bcsr.br, b_dtype=b.dtype,
                                   value_dtype=pvals.dtype))
        y = get_kernel("bcsr", "spmm", "panels")(
            panels.rows, panels.cols, pvals, panels.mask, b3,
            nblocks=bcsr.nblocks, units=panels.units, out_dtype=out,
            live=panels.live)
        return unflatten_batch(y[:, :bcsr.nrows], batch)

    return _fallback.run_chain("bcsr", "spmm", backend, attempt)


def loops_spmm_fused(fmt, b: torch.Tensor, *, backend: str | None = None,
                     out_dtype=None, csr_vals=None, bcsr_vals=None
                     ) -> torch.Tensor:
    """Single-pass hybrid SpMM into ONE output buffer.

    On ``"cuda"``: allocates ``(batch, r_boundary + nblocks*Br, N)`` once;
    the CSR-part kernel fills rows ``[0, r_boundary)`` and the BCSR-part
    kernel the rows from ``r_boundary`` on, in the same buffer (a part with
    no rows is not launched).  Every row is written by exactly one kernel,
    so the buffer needs no initialisation and there is no concatenation;
    the final trim to ``nrows`` is a view.  Unlike the reference, the
    boundary need not be a multiple of Br: the BCSR kernel takes a row
    offset, not a block offset.  The format's panels are taken from
    ``fmt.on(b.device)``; ``csr_vals``/``bcsr_vals`` (live ``(nnz,)`` /
    ``(ntiles, Br)`` values) replace their uploaded values.

    On ``"torch"``, the last link of the fused chain: the flat product,
    each part through its flat reference (:func:`csr_spmm` and
    :func:`bcsr_spmm` on ``"torch"``) and the rows concatenated, which
    autograd differentiates natively.  ``core.spmm.loops_spmm(backend=
    "torch")`` runs it too, so a degraded fused call is that product.
    """
    backend = resolve_backend(backend)
    check_rhs(fmt.ncols, b)
    vdt = (csr_vals.dtype if csr_vals is not None
           else torch_dtype(fmt.csr_part.vals.dtype))
    _, out = resolve_dtypes(vdt, out_dtype)
    if _empty_batch(b):
        return torch.zeros(b.shape[:-2] + (fmt.nrows, b.shape[-1]),
                           dtype=out, device=b.device)

    def attempt(bk: str) -> torch.Tensor:
        if bk == "torch":
            return _flat_product(fmt, b, out_dtype, csr_vals, bcsr_vals)
        return _fused_kernels(fmt, b, out, vdt, csr_vals, bcsr_vals)

    return _fallback.run_chain("fused", "spmm", backend, attempt)


def _flat_product(fmt, b, out_dtype, csr_vals, bcsr_vals) -> torch.Tensor:
    """The fused chain's ``"torch"`` link: both parts through the flat
    references, concatenated."""
    parts = []
    if fmt.r_boundary > 0:
        parts.append(csr_spmm(fmt.csr_part, b, backend="torch",
                              out_dtype=out_dtype, vals=csr_vals))
    if fmt.r_boundary < fmt.nrows:
        parts.append(bcsr_spmm(fmt.bcsr_part, b, backend="torch",
                               out_dtype=out_dtype, vals=bcsr_vals))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _fused_kernels(fmt, b, out, vdt, csr_vals, bcsr_vals) -> torch.Tensor:
    """The fused chain's ``"cuda"`` link: B1 and B2 into one buffer."""
    dev = fmt.on(b.device)
    cvals = panel_values(dev.csr, csr_vals)
    bvals = panel_values(dev.bcsr, bcsr_vals)
    b3, batch = flatten_batch(b)
    n = int(b.shape[-1])
    nb = padded_batch(int(b3.shape[0]))
    r_b, br = fmt.r_boundary, fmt.bcsr_part.br
    has_csr, has_bcsr = r_b > 0, r_b < fmt.nrows
    rows = r_b + (fmt.bcsr_part.nblocks * br if has_bcsr else 0)
    y = torch.empty((b3.shape[0], rows, n), dtype=out, device=b.device)
    for part, on, panels, g_br in (("csr", has_csr, dev.csr, 1),
                                   ("bcsr", has_bcsr, dev.bcsr, br)):
        if on:
            npanels = int(panels.rows.shape[0])
            _note(part, "spmm", backend="cuda", impl="panels", fused=True,
                  units=npanels, batch=nb, n=n,
                  **_panel_note_fields(
                      part=part, depth=int(fmt.pipeline_depth),
                      npanels=npanels, nb=nb, n=n,
                      g=int(panels.cols.shape[1]), br=g_br, b_dtype=b.dtype,
                      value_dtype=vdt))
    if has_csr:
        get_kernel("csr", "spmm", "panels")(
            dev.csr.rows, dev.csr.cols, cvals, dev.csr.mask, b3,
            nrows=r_b, units=dev.csr.units, out_dtype=out, out=y,
            live=dev.csr.live)
    if has_bcsr:
        get_kernel("bcsr", "spmm", "panels")(
            dev.bcsr.rows, dev.bcsr.cols, bvals, dev.bcsr.mask, b3,
            nblocks=fmt.bcsr_part.nblocks, units=dev.bcsr.units,
            row_offset=r_b, out_dtype=out, out=y, live=dev.bcsr.live)
    return unflatten_batch(y[:, :fmt.nrows], batch)


def loops_sdd(fmt, dy: torch.Tensor, b: torch.Tensor, *,
              backend: str | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of ``Y = A @ B`` at A's stored values (both parts).

    Args:
      fmt: the forward ``LoopsFormat`` (structure only; its values are not
        read).
      dy:  (..., nrows, N) output cotangent, on ``b``'s device.
      b:   (..., K, N) the forward dense operand (same leading dims).
    Returns ``(d_csr_vals (nnz_csr,), d_bcsr_tile_vals (ntiles, Br))`` in
    the accumulation dtype of ``b``, summed over the batch dims (the
    values are shared across the batch).  ``"cuda"`` runs B3/B4 on the
    panels (:mod:`repro_torch.kernels.spmm_sdd`) and reads the real slots
    back with ``gather_values``; ``"torch"`` runs the flat references.
    Both sample ``dY @ Bᵀ`` only at stored coordinates.
    """
    backend = resolve_backend(backend)
    check_rhs(fmt.ncols, b)
    if dy.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"dy batch dims {tuple(dy.shape[:-2])} do not "
                         f"match b batch dims {tuple(b.shape[:-2])}")
    if dy.ndim < 2 or dy.shape[-2] != fmt.nrows:
        raise ValueError(f"dy must be (..., {fmt.nrows}, N); got "
                         f"{tuple(dy.shape)}")
    acc = acc_dtype_for(b.dtype)

    # A part with no rows, or an empty batch, has a zero gradient.
    d_csr = torch.zeros((fmt.csr_part.nnz,), dtype=acc, device=b.device)
    d_bcsr = torch.zeros(fmt.bcsr_part.tile_vals.shape, dtype=acc,
                         device=b.device)
    if _empty_batch(b):
        return d_csr, d_bcsr

    def attempt(bk: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if bk == "torch":
            return _sdd_refs(fmt, dy, b, d_csr, d_bcsr)
        return _sdd_kernels(fmt, dy, b, d_csr, d_bcsr)

    return _fallback.run_chain("loops", "sdd", backend, attempt)


def _sdd_refs(fmt, dy, b, d_csr, d_bcsr):
    """The ``"torch"`` link of :func:`loops_sdd`: the flat references."""
    csr, bc = fmt.csr_part, fmt.bcsr_part
    dev = b.device
    if fmt.r_boundary > 0:
        d_csr = get_kernel("csr", "sdd", "ref")(
            _value_tensor(csr.row_ids, dev),
            _value_tensor(csr.col_idx, dev), dy, b)
    if fmt.r_boundary < fmt.nrows:
        # The BCSR region of the cotangent, zero-padded to whole
        # blocks: rows the forward pass trims carry zero gradient.
        dy_b = dy[..., fmt.r_boundary:, :]
        pad = bc.nblocks * bc.br - dy_b.shape[-2]
        dy_pad = torch.nn.functional.pad(dy_b, (0, 0, 0, pad))
        d_bcsr = get_kernel("bcsr", "sdd", "ref")(
            _value_tensor(bc.tile_rows, dev),
            _value_tensor(bc.tile_cols, dev), dy_pad, b, bc.nblocks)
    return d_csr, d_bcsr


def _sdd_kernels(fmt, dy, b, d_csr, d_bcsr):
    """The ``"cuda"`` link of :func:`loops_sdd`: B3 and B4 on the panels."""
    bc = fmt.bcsr_part
    acc = acc_dtype_for(b.dtype)
    has_csr, has_bcsr = fmt.r_boundary > 0, fmt.r_boundary < fmt.nrows
    dev = fmt.on(b.device)
    b3, _ = flatten_batch(b)
    dy3, _ = flatten_batch(dy)
    if dy3.dtype != b3.dtype:
        # The reference multiplies in the accumulation dtype of b.
        dy3 = dy3.to(acc)
    nb = padded_batch(int(b3.shape[0]))
    n = int(b.shape[-1])
    for part, on, panels in (("csr", has_csr, dev.csr),
                             ("bcsr", has_bcsr, dev.bcsr)):
        if on:
            _note(part, "sdd", backend="cuda", impl="panels",
                  units=int(panels.rows.shape[0]), batch=nb, n=n,
                  pipeline_depth=int(fmt.pipeline_depth))
    if has_csr:
        # B3 walks the part's block table (built once, kept on the part).
        d_csr = dev.csr.gather_values(get_kernel("csr", "sdd", "panels")(
            dev.csr.rows, dev.csr.cols, dev.csr.mask, dy3, b3,
            blocks=dev.csr.sdd_blocks, live=dev.csr.live))
    if has_bcsr:
        # B4 reads the BCSR rows of dY in place (row offset r_boundary,
        # rows past nrows read as zero): no padded copy of the cotangent;
        # it walks the forward's B2 unit table, one CTA a unit.
        d_bcsr = dev.bcsr.gather_values(get_kernel("bcsr", "sdd", "panels")(
            dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, dy3, b3, br=bc.br,
            row_offset=fmt.r_boundary, nrows=bc.nrows, units=dev.bcsr.units,
            live=dev.bcsr.live))
    return d_csr, d_bcsr
