"""B2: the BCSR-part panel SpMM (the matrix-pipeline half of LOOPS).

``bcsr_panels_spmm`` is the wrapper of the hand-written CUDA kernel
``csrc/bcsr_spmm.cu``, which replaces the TPU kernel
``repro/kernels/bcsr_spmm.py::bcsr_panels_spmm_pallas``.  For every panel p
of the ``(P, Br, G)`` layout it computes

    C[row_offset + panel_rows[p]*Br : +Br, :] += A_p (Br x G) @ B[cols[p], :]

with masked lanes dropped.  ``row_offset`` lets the fused LOOPS path place
the BCSR part after the CSR part's rows in one buffer.  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs
:func:`bcsr_panels_spmm_plain`, the same panel function in plain PyTorch.

Like B1, the kernel walks the block-rows' bounded work units
(:func:`~repro_torch.kernels.csr_spmm.unit_table_of`), with a second pass
over split block-rows.  ``bcsr_panels_spmm.launches`` counts calls that
launch the kernel, one per call whether or not the second pass runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .csr_spmm import (_PLAIN_CHUNK, UnitTable, _as3, _check, _launch,
                       _target, _units_for, _workspace)
from .engine import register_kernel, resolve_dtypes

__all__ = ["bcsr_panels_spmm", "bcsr_panels_spmm_plain", "KERNEL_BRS",
           "UNIT_PANELS"]

# Tile heights the CUDA kernel is instantiated for.
KERNEL_BRS = (4, 8, 16)
# Most panels one work unit of B2 walks (see csr_spmm.UNIT_PANELS).  Chosen
# on the H100 with spmm_sweep.py (PERF.md): on the GCN's transposed
# adjacency, whose block-rows all hold 64-146 panels, 128 is 16% faster
# than 32 at N=256 with a 127x smaller workspace; on the in-2004-like
# matrix it is 5% slower than 32 or 64.
UNIT_PANELS = 128


def bcsr_panels_spmm_plain(panel_rows, panel_cols, panel_vals, panel_mask, b,
                           *, nblocks: int, row_offset: int = 0,
                           out_dtype=None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the panel function: masked gather of the
    G rows, ``(Br, G) @ (G, N)`` per panel, ``index_add_`` over the
    block-rows.  Writes rows ``[row_offset, row_offset + nblocks*Br)`` of
    ``out`` when given, else returns a new ``(..., nblocks*Br, N)``
    tensor (``row_offset`` must then be 0)."""
    b3 = _as3(b)
    acc, out_dt = resolve_dtypes(panel_vals.dtype, out_dtype)
    npanels, br, g = panel_vals.shape
    n = b3.shape[-1]
    y = torch.zeros((b3.shape[0], nblocks, br, n), dtype=acc,
                    device=b3.device)
    mask = panel_mask != 0
    step = max(1, _PLAIN_CHUNK // max(b3.shape[0] * g * max(br, 1) * n, 1))
    for s in range(0, npanels, step):
        rows = b3[:, panel_cols[s:s + step].long()].to(acc)   # (B, p, G, N)
        rows = torch.where(mask[s:s + step][None, :, :, None], rows,
                           torch.zeros((), dtype=acc, device=b3.device))
        contrib = torch.einsum("pbg,zpgn->zpbn",
                               panel_vals[s:s + step].to(acc), rows)
        y.index_add_(1, panel_rows[s:s + step].long(), contrib)
    y = y.reshape(b3.shape[0], nblocks * br, n)
    if out is None:
        if row_offset:
            raise ValueError("row_offset needs an out buffer")
        y = y.to(out_dt)
        return y if b.ndim == 3 else y[0]
    o3 = _target(out, b3, row_offset + nblocks * br, out_dt)
    o3[:, row_offset:row_offset + nblocks * br] = y
    return out


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 10
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def bcsr_panels_spmm(panel_rows, panel_cols, panel_vals, panel_mask, b, *,
                     nblocks: int, panel_ptr: torch.Tensor | None = None,
                     units: UnitTable | None = None, row_offset: int = 0,
                     out_dtype=None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """B2 on ``b``'s device.

    Args:
      panel_rows: (P,) int32 nondecreasing block-row per panel.
      panel_cols: (P, G) int32 gather rows of ``b``.
      panel_vals: (P, Br, G) tile values, the dtype of ``b``; Br in
                  :data:`KERNEL_BRS` for the kernel.
      panel_mask: (P, G) lane validity (``bool`` for the kernel).
      b:          (K, N) or (batch, K, N).
      nblocks:    block-rows this call owns.
      panel_ptr:  (nblocks + 1,) int64 first panel per block-row; derived
                  from ``panel_rows`` when not given.
      units:      the block-rows' :class:`UnitTable` on ``b``'s device;
                  built from ``panel_ptr`` with :data:`UNIT_PANELS` when
                  not given.
      row_offset: first output row written (needs ``out``).
      out:        optional (batch, R, N) buffer with
                  R >= row_offset + nblocks*Br; other rows are left alone.
    Returns ``out``, or a new (..., nblocks*Br, N) tensor in the output
    dtype (the accumulation dtype unless ``out_dtype`` is given).  Split
    block-rows need a ``(slots, batch, Br, N)`` workspace in the
    accumulation dtype, allocated here; an allocation that fails raises.
    """
    if b.device.type == "cpu":
        return bcsr_panels_spmm_plain(panel_rows, panel_cols, panel_vals,
                                      panel_mask, b, nblocks=nblocks,
                                      row_offset=row_offset,
                                      out_dtype=out_dtype, out=out)
    if b.device.type != "cuda":
        raise ValueError(f"bcsr_panels_spmm runs on cuda or cpu tensors, not "
                         f"{b.device}")
    b3 = _as3(b)
    acc, out_dt = resolve_dtypes(panel_vals.dtype, out_dtype)
    br = int(panel_vals.shape[1]) if panel_vals.ndim == 3 else -1
    if br not in KERNEL_BRS:
        raise ValueError(f"panel_vals must be (P, Br, G) with Br in "
                         f"{KERNEL_BRS}, got {tuple(panel_vals.shape)}")
    if row_offset and out is None:
        raise ValueError("row_offset needs an out buffer")
    units = _units_for(panel_rows, panel_ptr, units, nblocks, UNIT_PANELS)
    _check(units, panel_cols, panel_vals, panel_mask, b3, nblocks)
    o3 = _target(out, b3, row_offset + nblocks * br, out_dt)
    if not o3.is_contiguous():
        raise ValueError("out must be contiguous")
    ws = _workspace(units, b3, br, acc)
    _launch("bcsr_spmm", "bcsr_panels_spmm", _ARGTYPES, b3.device,
            units.units.data_ptr(), units.splits.data_ptr(),
            panel_cols.data_ptr(), panel_vals.data_ptr(),
            panel_mask.data_ptr(), b3.data_ptr(), o3.data_ptr(),
            ws.data_ptr() if ws is not None else None, units.nunits,
            units.nsplit, units.max_slots, br, panel_cols.shape[1],
            b3.shape[1], b3.shape[2], b3.shape[0], o3.shape[1], row_offset,
            _build.DTYPE_CODES[panel_vals.dtype], _build.DTYPE_CODES[out_dt])
    bcsr_panels_spmm.launches += 1
    if out is not None:
        return out
    return o3 if b.ndim == 3 else o3[0]


bcsr_panels_spmm.launches = 0

register_kernel("bcsr", "spmm", "panels", bcsr_panels_spmm)
