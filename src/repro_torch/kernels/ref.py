"""Flat PyTorch references for the LOOPS kernels (the reference package's
``jnp`` oracles), on any device.

They execute the flat part arrays (CSR nonzeros, BCSR tiles), never the
panel layout, so they also check the panel packing: the SpMM oracles of
the forward path and the sampled dense-dense (SDD) oracles of the value
gradient.  Every reference takes
the ``(..., K, N)`` operand contract; work is chunked so that the gathered
rows never exceed a fixed number of elements at once.
"""
from __future__ import annotations

import torch

from .engine import acc_dtype_for, register_kernel

__all__ = ["csr_spmm_ref", "bcsr_spmm_ref", "csr_sdd_ref", "bcsr_sdd_ref",
           "dense_spmm"]

_CHUNK_ELEMS = 1 << 24


def _spread(index: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``index`` (along dim 1) broadcast to ``like``'s shape as a view.
    The references accumulate with ``scatter_add_`` on it: unlike
    ``index_add_``, whose backward keeps the whole source alive, its
    backward keeps only this view, so autograd through the references holds
    no per-nonzero product (tens of GB at a sparse layer's full size)."""
    shape = [1] * like.ndim
    shape[1] = -1
    return index.long().view(shape).expand(like.shape)


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
        out.scatter_add_(1, _spread(row_ids[s:s + step], contrib), contrib)
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
        out.scatter_add_(1, _spread(tile_rows[s:s + step], outer), outer)
    return out.reshape(lead + (nblocks * br, n)).to(out_dtype)


def csr_sdd_ref(row_ids: torch.Tensor, col_idx: torch.Tensor,
                dy: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product at the CSR-part coordinates,

        dA[k] = sum_batch dY[row_ids[k], :] . B[col_idx[k], :]

    the gradient of ``Y = A @ B`` at A's stored values, summed over any
    batch dims (the values are shared across the batch).  Returns (nnz,)
    in the accumulation dtype of ``b``."""
    acc = acc_dtype_for(b.dtype)
    dy3 = dy.reshape((-1,) + tuple(dy.shape[-2:]))
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    nnz = int(row_ids.shape[0])
    out = torch.zeros((nnz,), dtype=acc, device=b.device)
    step = max(1, _CHUNK_ELEMS // max(b3.shape[0] * b3.shape[-1], 1))
    for s in range(0, nnz, step):
        prod = (dy3[:, row_ids[s:s + step].long()].to(acc)
                * b3[:, col_idx[s:s + step].long()].to(acc))
        out[s:s + step] = prod.sum(dim=-1).sum(dim=0)
    return out


def bcsr_sdd_ref(tile_rows: torch.Tensor, tile_cols: torch.Tensor,
                 dy_pad: torch.Tensor, b: torch.Tensor,
                 nblocks: int) -> torch.Tensor:
    """Sampled dense-dense product at the BCSR-part tile coordinates,

        dA[t, r] = sum_batch dY[tile_rows[t]*Br + r, :] . B[tile_cols[t], :]

    where ``dy_pad`` is the BCSR region of the cotangent padded to
    ``nblocks * Br`` rows (trimmed rows carry zero).  Returns (ntiles, Br)
    in the accumulation dtype of ``b``, batch dims summed."""
    acc = acc_dtype_for(b.dtype)
    dy3 = dy_pad.reshape((-1,) + tuple(dy_pad.shape[-2:]))
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    z, rows, n = dy3.shape
    br = rows // nblocks
    blocks = dy3.reshape(z, nblocks, br, n)
    ntiles = int(tile_rows.shape[0])
    out = torch.zeros((ntiles, br), dtype=acc, device=b.device)
    step = max(1, _CHUNK_ELEMS // max(z * br * n, 1))
    for s in range(0, ntiles, step):
        prod = (blocks[:, tile_rows[s:s + step].long()].to(acc)
                * b3[:, tile_cols[s:s + step].long()].to(acc)[:, :, None])
        out[s:s + step] = prod.sum(dim=-1).sum(dim=0)
    return out


def dense_spmm(a_dense: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Dense product in the accumulation dtype."""
    acc = acc_dtype_for(a_dense.dtype)
    out_dtype = out_dtype or acc
    return torch.matmul(a_dense.to(acc), b.to(acc)).to(out_dtype)


register_kernel("csr", "spmm", "ref", csr_spmm_ref)
register_kernel("bcsr", "spmm", "ref", bcsr_spmm_ref)
register_kernel("csr", "sdd", "ref", csr_sdd_ref)
register_kernel("bcsr", "sdd", "ref", bcsr_sdd_ref)
