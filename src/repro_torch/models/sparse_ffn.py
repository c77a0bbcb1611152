"""Weight-sparse linear layer executed through the LOOPS SpMM.

Port of ``repro/models/sparse_ffn.py``.  A magnitude-pruned weight
``(d_out, d_in)`` is stored in the hybrid LOOPS format: the structure
(row pointers, column indices, tiles, panels) is fixed and uploaded once;
the stored values are the layer's two ``nn.Parameter``s, laid out like
``fmt.csr_part.vals`` and ``fmt.bcsr_part.tile_vals``.  The forward is

    y = (W_loops @ xᵀ)ᵀ

through :func:`repro_torch.core.loops_spmm_values`, so training runs the
CUDA kernels both ways: B1/B2 forward with the live values, B1/B2 on the
cached transposed format for ``dx``, and the SDD kernels B3/B4 for the
value gradients, summed over the activation's batch dims.

numpy has no bfloat16, so a bf16 layer keeps its host values in fp32
(bf16 values are exact there) and plans with the bf16 tile height; its
parameters are bf16.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..core.formats import LoopsFormat, csr_from_dense, loops_format_from_arrays
from ..core.spmm import default_br, loops_spmm_values, plan_and_convert
from ..kernels.engine import resolve_device, torch_dtype

__all__ = ["SparseLinear", "magnitude_prune", "sparse_linear_from_dense",
           "sparse_linear_from_numpy", "sparse_linear_apply"]


class SparseLinear(nn.Module):
    """One pruned linear ``(d_out, d_in)``: the structure in ``fmt`` (which
    also holds the initial values) and the live values as parameters."""

    def __init__(self, fmt: LoopsFormat, d_in: int, d_out: int, *,
                 csr_vals: torch.Tensor, bcsr_vals: torch.Tensor):
        super().__init__()
        self.fmt = fmt
        self.d_in = d_in
        self.d_out = d_out
        self.csr_vals = nn.Parameter(csr_vals)
        self.bcsr_vals = nn.Parameter(bcsr_vals)

    def forward(self, x: torch.Tensor, *,
                backend: str | None = None) -> torch.Tensor:
        return sparse_linear_apply(self, x, backend=backend)


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero out the smallest-|w| fraction ``sparsity`` of entries."""
    flat = np.abs(w).ravel()
    k = int(len(flat) * sparsity)
    if k == 0:
        return w
    thresh = np.partition(flat, k)[k]
    return np.where(np.abs(w) >= thresh, w, 0.0).astype(w.dtype)


def _host_values(w) -> tuple[np.ndarray, torch.dtype]:
    """``w`` (numpy array or tensor) as a numpy array the host format can
    hold, and the dtype the layer runs in."""
    if isinstance(w, torch.Tensor):
        dt = w.dtype
        w = w.detach().cpu()
        w = (w.float() if dt == torch.bfloat16 else w).numpy()
        return w, dt
    w = np.asarray(w)
    return w, torch_dtype(w.dtype)


def _layer(fmt: LoopsFormat, d_in: int, d_out: int, dtype,
           device) -> SparseLinear:
    def put(a):   # a copy: training must not write into the host format
        return torch.tensor(a, device=device, dtype=dtype)
    return SparseLinear(fmt, d_in, d_out, csr_vals=put(fmt.csr_part.vals),
                        bcsr_vals=put(fmt.bcsr_part.tile_vals))


def sparse_linear_from_dense(w, sparsity: float, *, total_workers: int = 8,
                             device=None) -> SparseLinear:
    """Prune a dense ``(d_out, d_in)`` weight (numpy array or tensor; its
    dtype is the layer's) and convert it with ``plan_and_convert`` on
    ``device`` (``None`` -> CUDA)."""
    dev = resolve_device(device)
    host, dt = _host_values(w)
    pruned = magnitude_prune(host, sparsity)
    fmt, _ = plan_and_convert(csr_from_dense(pruned),
                              total_workers=total_workers,
                              br=default_br(dt), device=dev)
    return _layer(fmt, host.shape[1], host.shape[0], dt, dev)


def sparse_linear_from_numpy(arrays: Mapping[str, np.ndarray],
                             values: Mapping[str, np.ndarray], *,
                             dtype=None, device=None) -> SparseLinear:
    """Carry a layer across from the JAX package: ``arrays`` are its
    format's arrays (the keys of
    :func:`~repro_torch.core.formats.loops_format_from_arrays`), taken as
    they are, and ``values`` its ``{"csr_vals", "bcsr_vals"}``.  ``dtype``
    is the layer's (default: the values'; bf16 arrays arrive as fp32)."""
    dev = resolve_device(device)
    fmt = loops_format_from_arrays(arrays)
    d_out, d_in = fmt.shape
    layer = _layer(fmt, d_in, d_out, dtype or torch_dtype(
        np.asarray(values["csr_vals"]).dtype), dev)
    with torch.no_grad():
        for name in ("csr_vals", "bcsr_vals"):
            getattr(layer, name).copy_(torch.as_tensor(
                np.ascontiguousarray(values[name])))
    return layer


def sparse_linear_apply(layer: SparseLinear, x: torch.Tensor, *,
                        backend: str | None = None) -> torch.Tensor:
    """``x`` ``(..., d_in)`` -> ``(..., d_out)`` through the LOOPS SpMM with
    the layer's live values.

    A rank-1 activation runs as one column, a rank-2 ``(T, d_in)`` as one
    SpMM against ``xᵀ``, and higher ranks ``(*batch, T, d_in)`` keep their
    batch dims, which become the kernels' batch axis: one launch per kernel
    whatever the batch.  Differentiable in ``x`` and in both value
    parameters; ``backend="torch"`` is the flat-reference oracle.
    """
    vec = x.ndim == 1
    xm = x[None] if vec else x                  # (..., T, d_in)
    y = loops_spmm_values(layer.fmt, layer.csr_vals, layer.bcsr_vals,
                          xm.transpose(-1, -2), device=x.device,
                          backend=backend)     # (..., d_out, T)
    y = y.transpose(-1, -2)
    return (y[0] if vec else y).to(x.dtype)
