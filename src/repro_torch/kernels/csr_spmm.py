"""B1: the CSR-part panel SpMM (the vector-pipeline half of LOOPS).

``csr_panels_spmm`` is the wrapper of the hand-written CUDA kernel
``csrc/csr_spmm.cu``, which replaces the TPU kernel
``repro/kernels/csr_spmm.py::csr_panels_spmm_pallas``.  For every panel p
of the ``(P, G)`` layout it computes

    C[panel_rows[p], :] += sum_i mask[p,i] * vals[p,i] * B[panel_cols[p,i], :]

On a CUDA tensor the wrapper launches the kernel (one warp per output row
x 32-column tile, see the source's note) or raises; on a CPU tensor it runs
:func:`csr_panels_spmm_plain`, the same panel function in plain PyTorch,
which the tests and ``chip_smoke.py`` hold the kernel against.

``csr_panels_spmm.launches`` counts kernel launches (never the plain
version's calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .engine import register_kernel, resolve_dtypes

__all__ = ["csr_panels_spmm", "csr_panels_spmm_plain", "panel_ptr_of"]

# Elements of the (batch, panels, G, N) gather the plain versions hold at
# once; larger inputs are processed in panel chunks.
_PLAIN_CHUNK = 1 << 24


def panel_ptr_of(panel_rows: torch.Tensor, ngroups: int) -> torch.Tensor:
    """``ptr[r]`` = first panel of group ``r`` (int64, ``ngroups + 1``)."""
    groups = torch.arange(ngroups + 1, device=panel_rows.device,
                          dtype=panel_rows.dtype)
    return torch.searchsorted(panel_rows.contiguous(), groups).to(torch.int64)


def _as3(b: torch.Tensor) -> torch.Tensor:
    if b.ndim not in (2, 3):
        raise ValueError(f"b must be (K, N) or (batch, K, N); got rank "
                         f"{b.ndim}")
    return b if b.ndim == 3 else b[None]


def _target(out, b3, rows_needed: int, dtype) -> torch.Tensor:
    """The output buffer: ``out`` checked, or a fresh one of
    ``rows_needed`` rows per slice."""
    shape = (b3.shape[0], rows_needed, b3.shape[-1])
    if out is None:
        return torch.empty(shape, dtype=dtype, device=b3.device)
    o3 = out if out.ndim == 3 else out[None]
    if (o3.shape[0] != shape[0] or o3.shape[2] != shape[2]
            or o3.shape[1] < rows_needed or o3.dtype != dtype
            or o3.device != b3.device):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} cannot hold rows [0, {rows_needed}) "
                         f"of {shape} {dtype} on {b3.device}")
    return o3


def csr_panels_spmm_plain(panel_rows, panel_cols, panel_vals, panel_mask, b,
                          *, nrows: int, out_dtype=None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the panel function: masked gather,
    multiply, sum over G, ``index_add_`` over ``panel_rows``.  Writes rows
    ``[0, nrows)`` of ``out`` when given, else returns a new
    ``(..., nrows, N)`` tensor."""
    b3 = _as3(b)
    acc, out_dt = resolve_dtypes(panel_vals.dtype, out_dtype)
    y = torch.zeros((b3.shape[0], nrows, b3.shape[-1]), dtype=acc,
                    device=b3.device)
    npanels, g = panel_cols.shape
    mask = panel_mask != 0
    step = max(1, _PLAIN_CHUNK // max(b3.shape[0] * g * b3.shape[-1], 1))
    for s in range(0, npanels, step):
        rows = b3[:, panel_cols[s:s + step].long()].to(acc)   # (B, p, G, N)
        contrib = panel_vals[s:s + step].to(acc)[None, :, :, None] * rows
        contrib = torch.where(mask[s:s + step][None, :, :, None], contrib,
                              torch.zeros((), dtype=acc, device=b3.device))
        y.index_add_(1, panel_rows[s:s + step].long(), contrib.sum(dim=2))
    if out is None:
        y = y.to(out_dt)
        return y if b.ndim == 3 else y[0]
    o3 = _target(out, b3, nrows, out_dt)
    o3[:, :nrows] = y
    return out


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def csr_panels_spmm(panel_rows, panel_cols, panel_vals, panel_mask, b, *,
                    nrows: int, panel_ptr: torch.Tensor | None = None,
                    out_dtype=None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """B1 on ``b``'s device.

    Args:
      panel_rows: (P,) int32 nondecreasing output row per panel.
      panel_cols: (P, G) int32 gather rows of ``b``.
      panel_vals: (P, G) values, the dtype of ``b``.
      panel_mask: (P, G) lane validity (``bool`` for the kernel).
      b:          (K, N) or (batch, K, N).
      nrows:      output rows this call owns.
      panel_ptr:  (nrows + 1,) int64 first panel per row; derived from
                  ``panel_rows`` when not given.
      out:        optional (batch, R, N) buffer with R >= nrows; rows
                  ``[0, nrows)`` are written, the others are left alone.
    Returns ``out``, or a new (..., nrows, N) tensor in the output dtype
    (the accumulation dtype unless ``out_dtype`` is given).
    """
    if b.device.type == "cpu":
        return csr_panels_spmm_plain(panel_rows, panel_cols, panel_vals,
                                     panel_mask, b, nrows=nrows,
                                     out_dtype=out_dtype, out=out)
    if b.device.type != "cuda":
        raise ValueError(f"csr_panels_spmm runs on cuda or cpu tensors, not "
                         f"{b.device}")
    b3 = _as3(b)
    _, out_dt = resolve_dtypes(panel_vals.dtype, out_dtype)
    if panel_ptr is None:
        panel_ptr = panel_ptr_of(panel_rows, nrows)
    _check(panel_ptr, panel_cols, panel_vals, panel_mask, b3, nrows + 1)
    o3 = _target(out, b3, nrows, out_dt)
    if not o3.is_contiguous():
        raise ValueError("out must be contiguous")
    fn = _build.kernel_fn("csr_spmm", "csr_panels_spmm", _ARGTYPES)
    with torch.cuda.device(b3.device):
        rc = fn(panel_ptr.data_ptr(), panel_cols.data_ptr(),
                panel_vals.data_ptr(), panel_mask.data_ptr(), b3.data_ptr(),
                o3.data_ptr(), nrows, panel_cols.shape[1], b3.shape[1],
                b3.shape[2], b3.shape[0], o3.shape[1],
                _build.DTYPE_CODES[panel_vals.dtype],
                _build.DTYPE_CODES[out_dt],
                torch.cuda.current_stream(b3.device).cuda_stream)
    _build.check_launch("csr_panels_spmm", rc)
    csr_panels_spmm.launches += 1
    if out is not None:
        return out
    return o3 if b.ndim == 3 else o3[0]


csr_panels_spmm.launches = 0


def _check(panel_ptr, cols, vals, mask, b3, nptr: int) -> None:
    """Device, dtype, shape and contiguity checks shared by B1 and B2."""
    dev = b3.device
    for name, t in (("panel_ptr", panel_ptr), ("panel_cols", cols),
                    ("panel_vals", vals), ("panel_mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, b on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not b3.is_contiguous():
        raise ValueError("b must be contiguous")
    if panel_ptr.dtype != torch.int64 or panel_ptr.shape != (nptr,):
        raise ValueError(f"panel_ptr must be ({nptr},) int64, got "
                         f"{tuple(panel_ptr.shape)} {panel_ptr.dtype}")
    if cols.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError(f"panel_cols must be int32 and panel_mask bool, "
                         f"got {cols.dtype} and {mask.dtype}")
    if mask.shape != cols.shape or vals.shape[0] != cols.shape[0] \
            or vals.shape[-1] != cols.shape[1]:
        raise ValueError(f"panel shapes disagree: cols {tuple(cols.shape)}, "
                         f"vals {tuple(vals.shape)}, mask {tuple(mask.shape)}")
    if vals.dtype not in _build.DTYPE_CODES or vals.dtype != b3.dtype:
        raise ValueError(f"panel_vals ({vals.dtype}) and b ({b3.dtype}) must "
                         f"share one of {list(_build.DTYPE_CODES)}")
    if b3.shape[0] > 65535:
        raise ValueError(f"batch {b3.shape[0]} exceeds the grid's z limit "
                         "65535")


register_kernel("csr", "spmm", "panels", csr_panels_spmm)
