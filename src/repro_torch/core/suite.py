"""Synthetic SuiteSparse-like matrix suite.

The container is offline, so the paper's dataset (the full SuiteSparse
collection + the 20 representative matrices of Table 2) is reproduced as a
family of generators matching the structural features the paper keys on:
per-row nnz mean/std/max (Table 2 columns), banded vs power-law vs
block-dense patterns, and the block-density statistic the paper credits for
its GCN wins (§4.5).

``table2_like(id)`` yields a scaled-down matrix whose per-row nnz statistics
are proportional to the corresponding Table 2 entry, so the benchmark labels
(m1..m20) remain meaningful on CPU-sized problems.

Copied unchanged from ``repro/core/suite.py``: the same seed yields the
same arrays, byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .formats import CSR, csr_from_coo

__all__ = ["banded", "uniform", "powerlaw", "block_dense", "table2_like",
           "TABLE2_STATS", "gcn_graph"]


def _rng(seed):
    return np.random.default_rng(seed)


def uniform(nrows: int, ncols: int, density: float, *, seed=0,
            dtype=np.float32) -> CSR:
    rng = _rng(seed)
    nnz = max(int(nrows * ncols * density), 1)
    rows = rng.integers(0, nrows, nnz)
    cols = rng.integers(0, ncols, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    return csr_from_coo(rows, cols, vals, (nrows, ncols))


def banded(nrows: int, ncols: int, bandwidth: int, *, fill: float = 1.0,
           seed=0, dtype=np.float32) -> CSR:
    """Stencil/FEM-style band — the regular pattern where BCSR shines (pwtk,
    shipsec1, consph, cant in Table 2)."""
    rng = _rng(seed)
    rows_l, cols_l, vals_l = [], [], []
    for i in range(nrows):
        lo = max(i - bandwidth, 0)
        hi = min(i + bandwidth + 1, ncols)
        js = np.arange(lo, hi)
        if fill < 1.0:
            js = js[rng.random(len(js)) < fill]
        rows_l.append(np.full(len(js), i))
        cols_l.append(js)
        vals_l.append(rng.standard_normal(len(js)).astype(dtype))
    return csr_from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(vals_l), (nrows, ncols))


def powerlaw(nrows: int, ncols: int, mean_nnz: float, *, alpha: float = 2.1,
             seed=0, dtype=np.float32) -> CSR:
    """Scale-free web/circuit-style skew (circuit5M, FullChip, in-2004):
    few enormous hub rows + many near-empty rows — the CSR-part's reason to
    exist."""
    rng = _rng(seed)
    raw = rng.pareto(alpha - 1.0, nrows) + 1.0
    counts = np.minimum((raw / raw.mean() * mean_nnz).astype(np.int64), ncols)
    rows = np.repeat(np.arange(nrows), counts)
    cols = rng.integers(0, ncols, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return csr_from_coo(rows, cols, vals, (nrows, ncols))


def block_dense(nrows: int, ncols: int, block: int, block_density: float,
                *, in_block_fill: float = 0.8, seed=0,
                dtype=np.float32) -> CSR:
    """Matrices whose nonzeros cluster in dense blocks (mip1, pdb1HYS,
    TSOPF-style) — highest LOOPS win per the paper (block density drives the
    BCSR-part's efficiency)."""
    rng = _rng(seed)
    nbr, nbc = nrows // block, ncols // block
    rows_l, cols_l = [], []
    picks = rng.random((nbr, nbc)) < block_density
    for bi, bj in zip(*np.nonzero(picks)):
        mask = rng.random((block, block)) < in_block_fill
        ii, jj = np.nonzero(mask)
        rows_l.append(bi * block + ii)
        cols_l.append(bj * block + jj)
    if not rows_l:
        rows_l, cols_l = [np.array([0])], [np.array([0])]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return csr_from_coo(rows, cols, vals, (nrows, ncols))


@dataclasses.dataclass(frozen=True)
class Table2Entry:
    name: str
    nrow: int
    nnz: int
    nnz_mean: float
    nnz_std: float
    kind: str  # generator family


# Paper Table 2, with the generator family inferred from the domain.
TABLE2_STATS: Dict[str, Table2Entry] = {
    "m1": Table2Entry("circuit5M", 5_600_000, 59_500_000, 10.71, 1356.62, "powerlaw"),
    "m2": Table2Entry("Si41Ge41H72", 200_000, 15_000_000, 80.86, 126.97, "banded"),
    "m3": Table2Entry("Ga41As41H72", 300_000, 18_500_000, 68.96, 105.39, "banded"),
    "m4": Table2Entry("in-2004", 1_400_000, 16_900_000, 12.23, 37.23, "powerlaw"),
    "m5": Table2Entry("eu-2005", 900_000, 19_200_000, 22.30, 29.33, "powerlaw"),
    "m6": Table2Entry("pwtk", 200_000, 11_600_000, 53.39, 4.74, "banded"),
    "m7": Table2Entry("FullChip", 3_000_000, 26_600_000, 8.91, 1806.80, "powerlaw"),
    "m8": Table2Entry("mip1", 100_000, 10_400_000, 155.77, 350.74, "block"),
    "m9": Table2Entry("mc2depi", 500_000, 2_100_000, 3.99, 0.08, "banded"),
    "m10": Table2Entry("webbase-1M", 1_000_000, 3_100_000, 3.11, 25.35, "powerlaw"),
    "m11": Table2Entry("shipsec1", 100_000, 7_800_000, 55.46, 11.07, "banded"),
    "m12": Table2Entry("econ_fwd500", 200_000, 1_300_000, 6.17, 4.44, "uniform"),
    "m13": Table2Entry("scircuit", 200_000, 1_000_000, 5.61, 4.39, "powerlaw"),
    "m14": Table2Entry("pdb1HYS", 36_000, 4_300_000, 119.31, 31.86, "block"),
    "m15": Table2Entry("consph", 100_000, 6_000_000, 72.13, 19.08, "banded"),
    "m16": Table2Entry("cant", 100_000, 4_000_000, 64.17, 14.06, "banded"),
    "m17": Table2Entry("cop20k_A", 100_000, 2_600_000, 21.65, 13.79, "uniform"),
    "m18": Table2Entry("dc2", 100_000, 800_000, 6.56, 361.50, "powerlaw"),
    "m19": Table2Entry("rma10", 47_000, 2_400_000, 50.69, 27.78, "block"),
    "m20": Table2Entry("ASIC_680k", 700_000, 3_900_000, 5.67, 659.81, "powerlaw"),
}


def table2_like(mid: str, *, scale_rows: int = 2048, seed=0,
                dtype=np.float32) -> CSR:
    """A matrix with the Table 2 entry's per-row statistics at a CPU-friendly
    row count (``scale_rows``; the published row count reproduces the
    published size)."""
    e = TABLE2_STATS[mid]
    n = scale_rows
    if e.kind == "banded":
        return banded(n, n, max(int(e.nnz_mean) // 2, 1), seed=seed,
                      dtype=dtype)
    if e.kind == "powerlaw":
        return powerlaw(n, n, e.nnz_mean, seed=seed, dtype=dtype)
    if e.kind == "block":
        blk = 16
        bd = min(e.nnz_mean / blk / (n // blk) * (n / blk), 0.25)
        return block_dense(n, n, blk, max(bd, 0.02), seed=seed, dtype=dtype)
    return uniform(n, n, min(e.nnz_mean / n, 0.5), seed=seed, dtype=dtype)


def gcn_graph(num_nodes: int, avg_degree: int, *, seed=0,
              dtype=np.float32) -> CSR:
    """Symmetric normalised adjacency  hat(A) = D^-1/2 (A + I) D^-1/2 for the
    GCN case study (paper §4.5)."""
    rng = _rng(seed)
    nnz = num_nodes * avg_degree
    rows = rng.integers(0, num_nodes, nnz)
    cols = rng.integers(0, num_nodes, nnz)
    rows = np.concatenate([rows, cols, np.arange(num_nodes)])
    cols = np.concatenate([cols, rows[:nnz], np.arange(num_nodes)])
    vals = np.ones(rows.shape[0], dtype)
    deg = np.bincount(rows, weights=vals, minlength=num_nodes)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    vals = (dinv[rows] * dinv[cols]).astype(dtype)
    return csr_from_coo(rows, cols, vals, (num_nodes, num_nodes))
