"""Offline what-if replay: predict a plan's step time before converting.

Port of ``repro/perf/replay.py``.  The expensive part of trying a
candidate plan is the Algorithm 1 conversion (slice + re-tile + panelize,
O(nnz) with real allocation) followed by the upload and timed runs.  The
*cost* of a plan is modelled on its structural grid-step count (panels per
part times column blocks), a pure function of the CSR structure and the
plan knobs, which this module computes without converting:

  * :func:`predict_part_steps` / :func:`predict_grid_steps` — exact
    replicas of ``core.spmm.loops_grid_steps`` semantics from the raw CSR
    (``tests/test_torch_perf_trace.py`` holds them against the conversion
    and the reference); :func:`part_step_counter` is the same count with
    each ``(r_boundary, br)`` pair's tile scan done once, for ranking many
    plans of one matrix;
  * :class:`TraceDB` — a bag of measured trace records
    (``repro_torch.perf.trace``) that fits ``wall_us ≈ c0 + c_csr·steps_csr +
    c_bcsr·steps_bcsr`` per backend (ridge-regularised least squares);
  * :func:`replay` — combine the two: predicted wall seconds of ``plan``
    on ``csr``, **before** paying any conversion.

``tune/search.py`` uses replay as its pre-measurement pruning stage.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..kernels.panel_common import default_bn
from ..tune.fingerprint import distinct_sorted
from .trace import fit_cost_model, load_traces

__all__ = ["predict_grid_steps", "predict_part_steps", "part_step_counter",
           "TraceDB", "replay"]


def part_step_counter(csr, n_cols: int, bn: int | None = None
                      ) -> Callable[[object], Tuple[int, int]]:
    """``steps(plan) -> (s_csr, s_bcsr)``: :func:`predict_part_steps` of
    ``csr`` against an ``(K, n_cols)`` operand, for any number of plans.
    The BCSR part's distinct-tile scan (a sort over the part's entries) is
    done once per tile height for every boundary that is a multiple of it
    (the part's block-rows are then a suffix of the whole matrix's) and
    once per other ``(r_boundary, br)`` pair, and kept: ranking every
    candidate of a search costs a few scans, not one per plan."""
    n = int(csr.nrows)
    bn = bn or default_bn(int(n_cols))
    col_blocks = -(-int(n_cols) // bn)
    counts = np.diff(csr.row_ptr).astype(np.int64)
    tiles: Dict[Tuple[int, int], np.ndarray] = {}

    def tiles_per_block(r_b: int, br: int) -> np.ndarray:
        if r_b % br == 0 and r_b:
            return tiles_per_block(0, br)[r_b // br:]
        key = (r_b, br)
        if key not in tiles:
            s, e = int(csr.row_ptr[r_b]), int(csr.row_ptr[n])
            rows = csr.row_ids[s:e].astype(np.int64) - r_b
            cols = csr.col_idx[s:e].astype(np.int64)
            nzmask = np.asarray(csr.vals[s:e]) != 0
            blocks = rows[nzmask] // br
            nblocks = max(-(-(n - r_b) // br), 1)
            # Distinct (block, col) pairs = tiles; zero-valued pads are
            # dropped.
            lin = distinct_sorted(blocks * int(csr.ncols) + cols[nzmask])
            tiles[key] = np.bincount(
                (lin // int(csr.ncols)).astype(np.int64), minlength=nblocks)
        return tiles[key]

    def steps(plan) -> Tuple[int, int]:
        r_b = int(plan.r_boundary)
        br = int(plan.br)
        g = max(int(plan.panel_g), 1) \
            * max(int(getattr(plan, "macro_m", 1)), 1)
        depth = max(int(getattr(plan, "pipeline_depth", 1)), 1)
        # CSR-part panels over rows [0, r_b).
        p_csr = int(np.maximum(-(-counts[:r_b] // g), 1).sum()) \
            if r_b > 0 else 0
        # BCSR-part panels over rows [r_b, n).
        p_bcsr = int(np.maximum(-(-tiles_per_block(r_b, br) // g),
                                1).sum()) if r_b < n else 0
        ramp = depth - 1
        s_csr = (p_csr + ramp) * col_blocks if p_csr > 0 else 0
        s_bcsr = (p_bcsr + ramp) * col_blocks if p_bcsr > 0 else 0
        return s_csr, s_bcsr

    return steps


def predict_part_steps(csr, plan, n_cols: int,
                       bn: int | None = None) -> Tuple[int, int]:
    """Per-part grid steps of executing ``csr`` under ``plan`` against an
    ``(K, n_cols)`` operand — WITHOUT running the Algorithm 1 conversion.

    Matches ``loops_grid_steps(loops_from_csr(csr, r_b, br, panel_g), n_cols)``
    exactly, part by part:

      * CSR-part: rows ``[0, r_b)`` contribute ``max(ceil(c_i / g), 1)``
        panels each (``csr_slice_rows`` pads empty rows, ``panelize_csr``
        floors at one panel per row);
      * BCSR-part: block-rows of ``br`` rows contribute
        ``max(ceil(u_b / g), 1)`` panels, where ``u_b`` counts distinct
        columns among *nonzero-valued* entries in the block
        (``bcsr_from_csr_rows`` drops zero-valued structural pads and keeps
        ≥ 1 pad tile per empty block-row);
      * a part the executor skips entirely (``r_b == 0`` / ``r_b == nrows``)
        contributes zero;
      * ``macro_m > 1`` panelizes at the effective width ``panel_g·macro_m``
        and ``pipeline_depth = d`` adds ``d - 1`` ramp steps per non-empty
        part, exactly like the conversion;
      * both counts scale by ``ceil(n_cols / bn)`` column blocks
        (``bn`` defaults to ``panel_common.default_bn(n_cols)`` like the
        executor).
    """
    return part_step_counter(csr, n_cols, bn)(plan)


def predict_grid_steps(csr, plan, n_cols: int, bn: int | None = None) -> int:
    """Total predicted grid steps (see :func:`predict_part_steps`)."""
    s_csr, s_bcsr = predict_part_steps(csr, plan, n_cols, bn)
    return s_csr + s_bcsr


@dataclasses.dataclass
class TraceDB:
    """Queryable bag of measured trace records.

    Construct from in-memory records (``TraceDB(records)``), a recorder
    (``TraceDB(rec.records)``) or from disk (:meth:`load` — a JSONL file or
    a whole trace directory).
    """

    records: List[Dict] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path: os.PathLike | str) -> "TraceDB":
        return cls(records=load_traces(path))

    def extend(self, records) -> None:
        self.records.extend(records)

    def _cells(self, backend: Optional[str]) -> List[Dict]:
        cells = [r for r in self.records
                 if r.get("kind") in ("spmm", "search_trial")
                 and "grid_steps" in r and "wall_us" in r]
        if backend is not None:
            matching = [r for r in cells if r.get("backend") == backend]
            if matching:
                return matching
        return cells

    def step_cost(self, backend: Optional[str] = None,
                  ridge: float = 1e-6) -> Optional[np.ndarray]:
        """Fit the per-step cost surface over the measured cells
        (preferring records of ``backend``; falling back to all cells when
        none match)::

            wall_us ≈ c0 + (a_csr + b_csr·G)·steps_csr
                         + (a_bcsr + b_bcsr·G)·steps_bcsr

        The ``·G`` cross terms matter because a G-wide panel step does G×
        the gather/multiply work of a G=1 step — per-step cost is affine in
        the panel width, not constant.  When the cells don't span multiple
        panel widths (or there are too few for 5 coefficients) the fit
        drops to the 3-term form with the ``b`` terms pinned at zero.

        When the cells span more than one ``pipeline_depth`` a sixth
        ``d_pipe·(depth-1)·(steps_csr+steps_bcsr)`` term is fitted — the
        marginal cost (or saving) of running a step under the
        double-buffered pipeline.

        Returns ``[c0, a_csr, a_bcsr, b_csr, b_bcsr]`` (optionally extended
        with ``d_pipe``) or ``None`` when the cells cannot determine a
        positive per-step cost (fewer than two distinct step counts, or a
        degenerate fit).
        """
        cells = self._cells(backend)
        if len(cells) < 2:
            return None
        sc = np.array([r.get("grid_steps_csr",
                             r["grid_steps"]) for r in cells], np.float64)
        sb = np.array([r.get("grid_steps_bcsr", 0) for r in cells],
                      np.float64)
        g = np.array([r.get("panel_g", 1) for r in cells], np.float64)
        d = np.array([r.get("pipeline_depth", 1) for r in cells], np.float64)
        w = np.array([r["wall_us"] for r in cells], np.float64)
        if len(np.unique(sc + sb)) < 2:
            return None
        use_g = len(np.unique(g)) > 1 and len(cells) >= 6
        use_d = len(np.unique(d)) > 1 and len(cells) >= (8 if use_g else 5)
        cols = [np.ones_like(sc), sc, sb]
        if use_g:
            cols += [sc * g, sb * g]
        if use_d:
            cols += [(d - 1.0) * (sc + sb)]
        design = np.stack(cols, axis=1)
        ncoef = design.shape[1]
        ata = design.T @ design
        lam = ridge * max(float(np.trace(ata)) / ncoef, 1.0)
        coef = np.linalg.solve(ata + lam * np.eye(ncoef), design.T @ w)
        if use_d:
            d_pipe = coef[-1:]          # may legitimately be negative
            coef = coef[:-1]
        else:
            d_pipe = np.zeros((0,))
        if not use_g:
            coef = np.concatenate([coef, [0.0, 0.0]])
        # A usable model needs a non-negative floor and at least one
        # positive per-step cost; clamp tiny negatives from noise (the
        # pipeline term is exempt — overlap SHOULD make it negative).
        coef = np.maximum(coef, 0.0)
        if coef[1:].sum() <= 0:
            return None
        return np.concatenate([coef, d_pipe]) if use_d else coef

    def predict_us(self, coef: np.ndarray, s_csr: int, s_bcsr: int,
                   g: int, depth: int = 1) -> float:
        """Evaluate a :meth:`step_cost` coefficient vector at one cell.
        ``g`` is the *effective* panel width (``panel_g × macro_m``)."""
        us = float(coef[0] + (coef[1] + coef[3] * g) * s_csr
                   + (coef[2] + coef[4] * g) * s_bcsr)
        if len(coef) > 5:
            us += float(coef[5]) * (depth - 1) * (s_csr + s_bcsr)
        return max(us, 0.0)

    def cost_model(self, *, ridge: float = 1e-3):
        """Eq. 2 / panel-extended model refit from these records
        (:func:`repro_torch.perf.trace.fit_cost_model`); ``None`` when
        underdetermined."""
        return fit_cost_model(self.records, ridge=ridge)


def replay(plan, trace_db: TraceDB, *, csr, n_cols: int,
           backend: Optional[str] = None,
           bn: int | None = None) -> Optional[float]:
    """Predicted wall seconds of executing ``csr`` under ``plan`` — no
    conversion, no compile, no measurement.

    Combines the structural step count (:func:`predict_part_steps`) with
    the per-step cost fitted from ``trace_db``; returns ``None`` when the
    database cannot support a fit (caller falls back to its prior).
    """
    coef = trace_db.step_cost(backend)
    if coef is None:
        return None
    s_csr, s_bcsr = predict_part_steps(csr, plan, n_cols, bn)
    g_eff = (max(int(plan.panel_g), 1)
             * max(int(getattr(plan, "macro_m", 1)), 1))
    us = trace_db.predict_us(coef, s_csr, s_bcsr, g_eff,
                             depth=int(getattr(plan, "pipeline_depth", 1)))
    return us * 1e-6
