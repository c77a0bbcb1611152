"""Flat PyTorch references for the LOOPS kernels (the reference package's
``jnp`` oracles), on any device.

They execute the flat part arrays (CSR nonzeros, BCSR tiles), never the
panel layout, so they also check the panel packing.  Every reference takes
the ``(..., K, N)`` operand contract; work is chunked so that the gathered
rows never exceed a fixed number of elements at once.
"""
from __future__ import annotations

import torch

from .engine import acc_dtype_for, register_kernel

__all__ = ["csr_spmm_ref", "bcsr_spmm_ref", "dense_spmm"]

_CHUNK_ELEMS = 1 << 24


def csr_spmm_ref(row_ids: torch.Tensor, col_idx: torch.Tensor,
                 vals: torch.Tensor, b: torch.Tensor, nrows: int,
                 out_dtype=None) -> torch.Tensor:
    """Row-wise CSR SpMM: C[r] = sum_{k in row r} vals[k] * B[col[k], :]."""
    acc = acc_dtype_for(vals.dtype)
    out_dtype = out_dtype or acc
    lead, (_, n) = b.shape[:-2], b.shape[-2:]
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    out = torch.zeros((b3.shape[0], nrows, n), dtype=acc, device=b.device)
    step = max(1, _CHUNK_ELEMS // max(b3.shape[0] * n, 1))
    for s in range(0, int(vals.shape[0]), step):
        contrib = (vals[s:s + step].to(acc)[None, :, None]
                   * b3[:, col_idx[s:s + step].long()].to(acc))
        out.index_add_(1, row_ids[s:s + step].long(), contrib)
    return out.reshape(lead + (nrows, n)).to(out_dtype)


def bcsr_spmm_ref(tile_rows: torch.Tensor, tile_cols: torch.Tensor,
                  tile_vals: torch.Tensor, b: torch.Tensor, nblocks: int,
                  out_dtype=None) -> torch.Tensor:
    """Vector-wise BCSR SpMM as a sum of rank-1 (outer-product) updates,
    ``C[block p] = sum_{tile t in p} tile_vals[t] (x) B[tile_cols[t], :]``.
    Returns the padded (..., nblocks * Br, N) result."""
    acc = acc_dtype_for(tile_vals.dtype)
    out_dtype = out_dtype or acc
    br = int(tile_vals.shape[1])
    lead, (_, n) = b.shape[:-2], b.shape[-2:]
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    out = torch.zeros((b3.shape[0], nblocks, br, n), dtype=acc,
                      device=b.device)
    step = max(1, _CHUNK_ELEMS // max(b3.shape[0] * br * n, 1))
    for s in range(0, int(tile_vals.shape[0]), step):
        outer = (tile_vals[s:s + step].to(acc)[None, :, :, None]
                 * b3[:, tile_cols[s:s + step].long()].to(acc)[:, :, None, :])
        out.index_add_(1, tile_rows[s:s + step].long(), outer)
    return out.reshape(lead + (nblocks * br, n)).to(out_dtype)


def dense_spmm(a_dense: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Dense product in the accumulation dtype."""
    acc = acc_dtype_for(a_dense.dtype)
    out_dtype = out_dtype or acc
    return torch.matmul(a_dense.to(acc), b.to(acc)).to(out_dtype)


register_kernel("csr", "spmm", "ref", csr_spmm_ref)
register_kernel("bcsr", "spmm", "ref", bcsr_spmm_ref)
