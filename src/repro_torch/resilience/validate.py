"""Validated sparse ingestion: the defect taxonomy, strict and repair modes.

Port of ``repro/resilience/validate.py`` restricted to what the forward
path calls: :func:`validate_coo` (from ``core.formats.csr_from_coo``) and
:func:`validate_csr` (from ``core.spmm.plan_and_convert``), both strict by
default.  A malformed CSR must never reach Algorithm 1 or the kernels,
which index with it.

Repairs are counted in :data:`repair_counts` (defect kind -> entries
fixed) until the observability layer is ported; the reference records them
as ``validate.repaired`` counters on its obs capture.

Taxonomy (``SparseInputError.kind``), checked in this order::

    shape-mismatch        bad shape tuple / row_ptr length != nrows+1
    dtype-mismatch        non-integer index arrays or non-numeric values
    length-mismatch       col_idx and vals lengths disagree
    nonmonotone-indptr    decreasing / negative / wrong head or tail
    negative-index        row or column index < 0
    out-of-range-index    row or column index >= extent
    nonfinite-value       NaN or Inf stored value
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SparseInputError", "ValidationReport", "DEFECT_KINDS",
           "csr_defects", "validate_coo", "validate_csr", "repair_counts"]

DEFECT_KINDS = ("shape-mismatch", "dtype-mismatch", "length-mismatch",
                "nonmonotone-indptr", "negative-index",
                "out-of-range-index", "nonfinite-value")

REPAIR_MODES = ("drop", "clip")

# Entries repaired per defect kind, summed over the process.
repair_counts: Dict[str, int] = collections.Counter()


class SparseInputError(ValueError):
    """A classified ingestion defect (``kind`` ∈ :data:`DEFECT_KINDS`)."""

    def __init__(self, kind: str, message: str):
        if kind not in DEFECT_KINDS:
            raise ValueError(f"unknown defect kind {kind!r}")
        super().__init__(f"[{kind}] {message}")
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """What a validation pass found and (in repair mode) fixed."""

    defects: Tuple[str, ...] = ()          # kinds found, taxonomy order
    repaired: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.defects


def _check_repair(repair: Optional[str]) -> None:
    if repair is not None and repair not in REPAIR_MODES:
        raise ValueError(f"unknown repair mode {repair!r}; expected None, "
                         f"'drop' or 'clip'")


def _numeric_dtype(dt: np.dtype) -> bool:
    """True for any dtype the kernels can store values in: native
    int/uint/float/bool plus extension floats that register as numpy kind
    ``'V'`` yet cast cleanly through float32."""
    if dt.kind in "iufb":
        return True
    if dt.kind == "V" and dt.names is None:
        try:
            np.zeros((), dt).astype(np.float32)
            return True
        except (TypeError, ValueError):
            return False
    return False


def _finite_mask(vals: np.ndarray) -> np.ndarray:
    """Per-entry finiteness, robust to extension float dtypes (promoted
    through float32 where numpy has no native ``isfinite``)."""
    if vals.dtype.kind in "iub":
        return np.ones(vals.shape, bool)
    try:
        return np.isfinite(vals)
    except TypeError:
        return np.isfinite(vals.astype(np.float32))


def _note_repairs(repaired: Dict[str, int]) -> None:
    for kind, n in repaired.items():
        if n:
            repair_counts[kind] += int(n)


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------

def validate_coo(rows, cols, vals, shape, *, repair: Optional[str] = None):
    """Validate (and optionally repair) COO triplets against ``shape``.

    Returns ``(rows, cols, vals, report)``: in strict mode the arrays pass
    through or a :class:`SparseInputError` raises; in repair mode offending
    entries are dropped (``"drop"``) or clipped into range with nonfinite
    values zeroed (``"clip"``).
    """
    _check_repair(repair)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if len(shape) != 2 or shape[0] < 0 or shape[1] < 0:
        raise SparseInputError("shape-mismatch", f"bad matrix shape {shape}")
    if rows.dtype.kind not in "iu" or cols.dtype.kind not in "iu":
        if repair is None:
            raise SparseInputError(
                "dtype-mismatch", "COO coordinates must be integer arrays; "
                f"got rows={rows.dtype} cols={cols.dtype}")
        rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
        raise SparseInputError(
            "length-mismatch", "COO triplet arrays must be equal-length 1-D; "
            f"got rows={rows.shape} cols={cols.shape} vals={vals.shape}")
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)

    neg = (rows < 0) | (cols < 0)
    oob = (rows >= shape[0]) | (cols >= shape[1])
    nonfin = ~_finite_mask(vals)
    if repair is None:
        if neg.any():
            k = int(np.flatnonzero(neg)[0])
            raise SparseInputError(
                "negative-index", f"COO entry {k} has negative coordinate "
                f"({int(rows[k])}, {int(cols[k])})")
        if oob.any():
            k = int(np.flatnonzero(oob)[0])
            raise SparseInputError(
                "out-of-range-index", f"COO entry {k} at "
                f"({int(rows[k])}, {int(cols[k])}) exceeds shape {shape}")
        if nonfin.any():
            k = int(np.flatnonzero(nonfin)[0])
            raise SparseInputError(
                "nonfinite-value", f"COO entry {k} has nonfinite value "
                f"{vals[k]!r}")
        return rows, cols, vals, ValidationReport()

    repaired = {"negative-index": int(neg.sum()),
                "out-of-range-index": int((oob & ~neg).sum()),
                "nonfinite-value": int(nonfin.sum())}
    defects = tuple(k for k in DEFECT_KINDS if repaired.get(k))
    if repair == "drop":
        keep = ~(neg | oob | nonfin)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    else:
        rows = np.clip(rows, 0, max(shape[0] - 1, 0))
        cols = np.clip(cols, 0, max(shape[1] - 1, 0))
        vals = np.where(nonfin, np.zeros((), vals.dtype), vals)
    _note_repairs(repaired)
    return rows, cols, vals, ValidationReport(defects=defects,
                                              repaired=repaired)


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------

def csr_defects(row_ptr, col_idx, vals, shape) -> Tuple[str, ...]:
    """Classify every defect of raw CSR arrays (taxonomy order, no repair,
    no exception): the shared detector behind strict and repair modes."""
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    vals = np.asarray(vals)
    found = []
    if len(shape) != 2 or shape[0] < 0 or shape[1] < 0 \
            or row_ptr.ndim != 1 or row_ptr.shape[0] != shape[0] + 1:
        found.append("shape-mismatch")
    if row_ptr.dtype.kind not in "iu" or col_idx.dtype.kind not in "iu" \
            or not _numeric_dtype(vals.dtype):
        found.append("dtype-mismatch")
    if col_idx.shape != vals.shape or col_idx.ndim != 1:
        found.append("length-mismatch")
    nnz = int(col_idx.shape[0]) if col_idx.ndim == 1 else -1
    if row_ptr.ndim == 1 and row_ptr.shape[0] >= 1 \
            and row_ptr.dtype.kind in "iu":
        ptr = row_ptr.astype(np.int64)
        if (np.diff(ptr) < 0).any() or ptr[0] != 0 \
                or (nnz >= 0 and ptr[-1] != nnz) or (ptr < 0).any():
            found.append("nonmonotone-indptr")
    if col_idx.dtype.kind in "iu" and col_idx.ndim == 1:
        if (col_idx.astype(np.int64) < 0).any():
            found.append("negative-index")
        if (col_idx.astype(np.int64) >= shape[1]).any():
            found.append("out-of-range-index")
    if _numeric_dtype(vals.dtype) and not _finite_mask(vals).all():
        found.append("nonfinite-value")
    return tuple(k for k in DEFECT_KINDS if k in found)


def validate_csr(csr, *, repair: Optional[str] = None):
    """Validate (and optionally repair) a
    :class:`repro_torch.core.formats.CSR`.

    Returns ``(csr, report)``.  Strict mode raises
    :class:`SparseInputError` with the first defect's kind.  Repair mode
    returns a rebuilt CSR: the indptr is made monotone (running maximum,
    clamped to ``[0, nnz]``), then offending entries are dropped
    (``"drop"``) or column-clipped with nonfinite values zeroed
    (``"clip"``).  Structural defects the entry repairs cannot express
    (wrong array lengths, bad shapes, non-integer indices) raise in both
    modes.
    """
    _check_repair(repair)
    defects = csr_defects(csr.row_ptr, csr.col_idx, csr.vals, csr.shape)
    if not defects:
        return csr, ValidationReport()
    unrepairable = [k for k in defects if k in
                    ("shape-mismatch", "dtype-mismatch", "length-mismatch")]
    if repair is None or unrepairable:
        kind = unrepairable[0] if unrepairable else defects[0]
        raise SparseInputError(kind, f"CSR{csr.shape} failed validation: "
                               f"defects={list(defects)}")

    from ..core.formats import _csr_from_arrays
    nnz = int(csr.col_idx.shape[0])
    ptr = csr.row_ptr.astype(np.int64)
    repaired: Dict[str, int] = {}
    if "nonmonotone-indptr" in defects:
        fixed = np.clip(np.maximum.accumulate(np.clip(ptr, 0, nnz)), 0, nnz)
        fixed[0], fixed[-1] = 0, nnz
        fixed = np.maximum.accumulate(fixed)
        repaired["nonmonotone-indptr"] = int((fixed != ptr).sum())
        ptr = fixed
    col = csr.col_idx.astype(np.int64)
    vals = np.asarray(csr.vals)
    neg = col < 0
    oob = col >= csr.shape[1]
    nonfin = ~_finite_mask(vals)
    repaired.update({"negative-index": int(neg.sum()),
                     "out-of-range-index": int(oob.sum()),
                     "nonfinite-value": int(nonfin.sum())})
    if repair == "drop":
        keep = ~(neg | oob | nonfin)
        row_ids = np.repeat(np.arange(csr.shape[0], dtype=np.int64),
                            np.diff(ptr))
        counts = np.bincount(row_ids[keep], minlength=csr.shape[0])
        new_ptr = np.zeros(csr.shape[0] + 1, np.int64)
        np.cumsum(counts, out=new_ptr[1:])
        ptr, col, vals = new_ptr, col[keep], vals[keep]
    else:
        col = np.clip(col, 0, max(csr.shape[1] - 1, 0))
        vals = np.where(nonfin, np.zeros((), vals.dtype), vals)
    _note_repairs(repaired)
    out = _csr_from_arrays(ptr, col, vals, csr.shape)
    return out, ValidationReport(defects=defects,
                                 repaired={k: v for k, v in repaired.items()
                                           if v})
