"""Row-boundary selection for the LOOPS hybrid split (paper §3.1, Eq. 1).

The boundary ``r_boundary`` separates the CSR(vector)-part from the
BCSR(matrix)-part.  The paper balances the two pipelines:

    r_b * TP_neon * t_neon = (r_total - r_b) * TP_sme * t_sme        (Eq. 1)

Note on Eq. 1 as printed: equalising *work x capability* products assigns
FEWER rows to the FASTER pipeline, which is dimensionally inconsistent with
the stated goal ("equalizes the workload and computational capability").  The
physically balanced-time condition is

    r_b / (TP_vpu * t_vpu) = (r_total - r_b) / (TP_mxu * t_mxu)

i.e. each group finishes at the same instant.  We implement balanced-time by
default and keep the literal printed form behind ``paper_literal=True``.

Copied unchanged from ``repro/core/partition.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR

__all__ = ["RowStats", "row_stats", "choose_r_boundary", "regularity_boundary"]


@dataclasses.dataclass(frozen=True)
class RowStats:
    """Per-row nonzero statistics (paper Table 2 feature values)."""

    nrows: int
    nnz: int
    nnz_max: int
    nnz_min: int
    nnz_mean: float
    nnz_std: float


def row_stats(csr: CSR) -> RowStats:
    counts = np.diff(csr.row_ptr)
    return RowStats(
        nrows=csr.nrows, nnz=csr.nnz,
        nnz_max=int(counts.max(initial=0)),
        nnz_min=int(counts.min(initial=0)),
        nnz_mean=float(counts.mean()) if len(counts) else 0.0,
        nnz_std=float(counts.std()) if len(counts) else 0.0)


def choose_r_boundary(nrows: int, tp_vpu: float, tp_mxu: float,
                      t_vpu: int, t_mxu: int, *, br: int = 8,
                      paper_literal: bool = False) -> int:
    """Solve Eq. 1 for ``r_boundary`` and round to a tile-height multiple.

    ``tp_*`` are per-worker row-throughputs (rows/s) of the two kernels,
    ``t_*`` the worker (thread/device) counts chosen by the scheduler.
    Degenerate allocations collapse to pure-CSR (t_mxu == 0) or pure-BCSR
    (t_vpu == 0) — the ablation baselines of paper §4.3.
    """
    cap_v = tp_vpu * t_vpu
    cap_m = tp_mxu * t_mxu
    if cap_v <= 0 and cap_m <= 0:
        raise ValueError("at least one pipeline must have capacity")
    if cap_m <= 0:
        return nrows  # pure vector path: everything CSR
    if cap_v <= 0:
        return 0      # pure matrix path: everything BCSR
    if paper_literal:
        # r_b * cap_v = (r_total - r_b) * cap_m  (printed form)
        frac = cap_m / (cap_v + cap_m)
    else:
        # balanced completion time: r_b / cap_v = (r_total - r_b) / cap_m
        frac = cap_v / (cap_v + cap_m)
    r_b = int(round(frac * nrows))
    # Snap so the BCSR region starts on a tile boundary-friendly offset.
    r_b = min(max((r_b // br) * br, 0), nrows)
    return r_b


def regularity_boundary(csr: CSR, *, br: int = 8,
                        density_threshold: float | None = None) -> int:
    """Beyond-paper heuristic: find the positional boundary that maximises the
    regularity of the BCSR region.

    The paper splits positionally (top rows -> CSR).  Many SuiteSparse
    matrices have their irregular (hub) rows scattered; a cheap improvement
    that keeps the positional-split kernel contract is to scan candidate
    boundaries and pick the one whose suffix has per-row nnz closest to
    uniform (low padding waste in ``Br x 1`` tiles, i.e. high block density).
    """
    counts = np.diff(csr.row_ptr).astype(np.float64)
    n = csr.nrows
    if n == 0:
        return 0
    mean = counts.mean()
    thr = density_threshold if density_threshold is not None else mean
    # Suffix statistics via reverse cumulative sums.
    rev = counts[::-1]
    c1 = np.cumsum(rev)[::-1]                # sum of counts in suffix
    c2 = np.cumsum(rev * rev)[::-1]          # sum of squares in suffix
    sizes = np.arange(n, 0, -1, dtype=np.float64)
    suf_mean = c1 / sizes
    suf_var = np.maximum(c2 / sizes - suf_mean ** 2, 0.0)
    # Score: prefer large, dense, low-variance suffixes.
    score = (suf_mean - thr) * sizes - np.sqrt(suf_var) * sizes * 0.25
    boundaries = np.arange(0, n, max(br, 1))
    best = int(boundaries[np.argmax(score[boundaries])])
    return best
