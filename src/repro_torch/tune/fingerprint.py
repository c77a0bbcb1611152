"""Structural fingerprints of sparse matrices — the plan-cache key.

Port of ``repro/tune/fingerprint.py``: the same features, bitwise, for
the same CSR arrays, and the same key derivation, so a plan cache written
by one package reads in the other.  The key hashes the backend string, so
the port's plans (backends ``"cuda"`` and ``"torch"``) and the
reference's (``"pallas"``, ``"interpret"``, ``"jnp"``) never share a key.

A plan tuned for one matrix transfers to another exactly when the two look
alike *structurally*: same scale (rows/cols/nnz, log-bucketed), same per-row
nonzero distribution (the Table 2 feature columns the paper keys its analysis
on: mean/std/max nnz per row), same block density (what makes the BCSR-part
efficient, §4.4) and same bandwidth (banded vs scattered).  Values are
irrelevant — two magnitude-pruned FFN layers with the same mask statistics
share a plan.

The fingerprint therefore lives in log/ratio space so it is scale-comparable:
``features()`` returns a vector whose Euclidean distance is meaningful across
matrices of different absolute sizes, and ``cache_key`` quantises that vector
(so measurement noise in construction order can never split a bucket) and
hashes it together with the execution context (dtype, ``n_cols`` of the dense
operand, backend) that changes which plan wins.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Tuple

import numpy as np

from ..core.formats import CSR, LoopsFormat

__all__ = ["Fingerprint", "fingerprint", "loops_fingerprint", "cache_key",
           "cache_key_from_features", "feature_distance",
           "effective_n_cols"]

# Block height used for the block-density feature.  Fixed (not the plan's Br)
# so fingerprints are comparable before any plan exists.
_FP_BR = 8


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Structural summary of one sparse matrix (values excluded)."""

    log_nrows: float       # log2(nrows)
    log_ncols: float       # log2(ncols)
    log_nnz: float         # log2(nnz + 1)
    log_row_mean: float    # log2(mean nnz/row + 1)   (Table 2 'mean')
    row_cv: float          # std/mean nnz per row     (Table 2 'std', scaled)
    log_row_max: float     # log2(max nnz/row + 1)    (Table 2 'max')
    block_density: float   # nnz / (nonempty 8x1 tiles * 8)   (paper §4.4)
    bandwidth: float       # mean |col - row*ncols/nrows| / ncols

    def features(self) -> np.ndarray:
        """Vector for distance computation (order is part of the cache
        format; bump ``cache.CACHE_VERSION`` if it changes)."""
        return np.array([
            self.log_nrows, self.log_ncols, self.log_nnz, self.log_row_mean,
            self.row_cv, self.log_row_max, self.block_density * 4.0,
            self.bandwidth * 4.0,
        ], np.float64)

    def quantised(self) -> Tuple[float, ...]:
        """Bucketed features for the exact-match key: 0.5-wide bins in log
        space (a matrix and its ~1.4x-scaled sibling share a bucket)."""
        return tuple(round(float(f) * 2.0) / 2.0 for f in self.features())


def distinct_sorted(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D array by one sort: numpy's hashing
    ``unique`` (2.3 and later) is several times slower than a sort on the
    16M nearly distinct tile keys of an in-2004-sized matrix (PERF.md)."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if a.size else a


def fingerprint(csr: CSR) -> Fingerprint:
    """Fingerprint a CSR matrix in O(nnz)."""
    counts = np.diff(csr.row_ptr).astype(np.float64)
    nrows, ncols = csr.shape
    nnz = max(csr.nnz, 1)
    mean = float(counts.mean()) if counts.size else 0.0
    std = float(counts.std()) if counts.size else 0.0
    rmax = float(counts.max(initial=0.0))
    # Block density over fixed 8x1 tiles: how full would the BCSR-part be?
    lin = (csr.row_ids.astype(np.int64) // _FP_BR) * ncols \
        + csr.col_idx.astype(np.int64)
    ntiles = max(len(distinct_sorted(lin)), 1)
    bdens = min(nnz / (ntiles * _FP_BR), 1.0)
    # Bandwidth: normalised mean distance from the (scaled) diagonal.
    diag = csr.row_ids.astype(np.float64) * (ncols / max(nrows, 1))
    bw = float(np.abs(csr.col_idx - diag).mean() / max(ncols, 1)) \
        if csr.nnz else 0.0
    return Fingerprint(
        log_nrows=math.log2(max(nrows, 1)),
        log_ncols=math.log2(max(ncols, 1)),
        log_nnz=math.log2(nnz + 1),
        log_row_mean=math.log2(mean + 1),
        row_cv=min(std / max(mean, 1e-9), 8.0) if mean > 0 else 0.0,
        log_row_max=math.log2(rmax + 1),
        block_density=bdens,
        bandwidth=bw)


def loops_fingerprint(fmt: LoopsFormat) -> Fingerprint:
    """Fingerprint an already-converted :class:`LoopsFormat` (used by the
    distributed scheduler, which receives the format, not the CSR).

    Reconstructs per-row counts from the two parts; tile padding rows are
    structural zeros and do not perturb the statistics materially.
    """
    csr, bcsr = fmt.csr_part, fmt.bcsr_part
    counts_csr = np.diff(csr.row_ptr).astype(np.float64)
    # Per-row counts of the BCSR region from the tile values' nonzero mask.
    nz = np.count_nonzero(bcsr.tile_vals, axis=1) if bcsr.ntiles else \
        np.zeros(0, np.int64)
    per_block = np.bincount(bcsr.tile_rows,
                            weights=np.asarray(nz, np.float64),
                            minlength=bcsr.nblocks) if bcsr.ntiles else \
        np.zeros(bcsr.nblocks)
    counts_b = np.repeat(per_block / max(bcsr.br, 1), bcsr.br)[:bcsr.nrows]
    counts = np.concatenate([counts_csr, counts_b]) if len(counts_b) else \
        counts_csr
    nrows, ncols = fmt.shape
    nnz = max(fmt.nnz, 1)
    mean = float(counts.mean()) if counts.size else 0.0
    std = float(counts.std()) if counts.size else 0.0
    rmax = float(counts.max(initial=0.0))
    ntiles = max(bcsr.ntiles + csr.nnz, 1)
    return Fingerprint(
        log_nrows=math.log2(max(nrows, 1)),
        log_ncols=math.log2(max(ncols, 1)),
        log_nnz=math.log2(nnz + 1),
        log_row_mean=math.log2(mean + 1),
        row_cv=min(std / max(mean, 1e-9), 8.0) if mean > 0 else 0.0,
        log_row_max=math.log2(rmax + 1),
        block_density=min(nnz / (ntiles * _FP_BR), 1.0),
        bandwidth=0.0)


def effective_n_cols(shape) -> int:
    """Column count the execution engine actually feeds the matrix pipeline
    for a dense operand of shape ``(..., K, N)``: ``prod(batch) * N``.

    The batched kernels reuse A's panel layout across every batch slice, so
    a ``(4, K, 128)`` operand exercises the grid like a ``(K, 512)`` one —
    plans (and therefore cache keys, which hash ``n_cols``) must be keyed on
    this effective count, not the trailing dim alone."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2:
        raise ValueError(f"dense operand shape must be (..., K, N); got "
                         f"{shape}")
    cols = shape[-1]
    for d in shape[:-2]:
        cols *= d
    return cols


def feature_distance(a: np.ndarray, b: np.ndarray) -> float:
    """RMS distance between two feature vectors — the near-match metric."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def cache_key_from_features(features, *, n_cols: int, dtype,
                            backend: str) -> str:
    """Key from a raw feature vector (what cache records store) — the bulk
    ``PlanCache.prewarm`` path rebuilds keys through here, so a record
    round-tripped through the cache rehashes to the key ``cache_key`` would
    have minted for its source matrix."""
    quant = tuple(round(float(f) * 2.0) / 2.0 for f in features)
    payload = ",".join(f"{q:.1f}" for q in quant)
    ctx = f"{np.dtype(dtype).name}|n{int(n_cols)}|{backend}"
    digest = hashlib.sha1(f"{payload}|{ctx}".encode()).hexdigest()[:16]
    return f"v-{digest}"


def cache_key(fp: Fingerprint, *, n_cols: int, dtype, backend: str) -> str:
    """Stable cache key: quantised structure + execution context."""
    return cache_key_from_features(fp.features(), n_cols=n_cols,
                                   dtype=dtype, backend=backend)
