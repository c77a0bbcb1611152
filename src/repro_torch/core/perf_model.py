"""Lightweight quadratic performance model + scheduler (paper §3.5).

The paper models throughput as a quadratic in the two thread-group sizes with
no cross term (Eq. 2) because the NEON and SME pipelines are independent:

    perf(x, y) = a0 + a1*x + a2*y + a3*x^2 + a4*y^2

and schedules by enumerating all (x, y) with x + y <= T (Eq. 3).

Copied unchanged from ``repro/core/perf_model.py`` (numpy only); the
port keeps its own copy so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence, Tuple

import numpy as np

__all__ = ["QuadraticPerfModel", "fit_perf_model", "best_allocation",
           "calibrate"]


@dataclasses.dataclass(frozen=True)
class QuadraticPerfModel:
    """perf(x, y) = a0 + a1 x + a2 y + a3 x**2 + a4 y**2 (paper Eq. 2).

    Panel-extended variant (this repo's kernel layer): when calibrated over
    ``(x, y, g)`` samples — ``g`` the panel width of the G-wide kernels —
    two extra terms model the panelization axis with the same no-cross-term
    independence assumption:

        perf(x, y, g) = Eq.2(x, y) + a5 g + a6 g**2

    (the grid-step reduction saturates once padding dominates, which the
    concave ``a6 < 0`` fit captures).  A 5-coefficient model simply ignores
    ``g``, keeping every pre-panelization caller intact.
    """

    coef: np.ndarray  # (5,) [a0..a4] or (7,) [a0..a4, a5, a6]
    # Provenance: where the coefficients came from ("traces:<n> records",
    # "calibrate:<n> probes", None for hand-set/prior models).  The trace
    # layer (repro.perf.trace.fit_cost_model) stamps this so a schedule can
    # always be traced back to its measurement source.
    calibrated_from: str | None = None

    @property
    def has_panel_terms(self) -> bool:
        return int(self.coef.shape[0]) >= 7

    def predict(self, x, y, g=None):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        a = self.coef
        base = a[0] + a[1] * x + a[2] * y + a[3] * x * x + a[4] * y * y
        if g is not None and self.has_panel_terms:
            g = np.asarray(g, np.float64)
            base = base + a[5] * g + a[6] * g * g
        return base

    def best_allocation(self, total: int,
                        allow_zero: bool = True) -> Tuple[int, int]:
        """Paper Eq. 3: argmax over x + y <= total (exhaustive — core counts
        are small, and so are practical device-group splits)."""
        lo = 0 if allow_zero else 1
        best, best_perf = (lo, lo), -np.inf
        for x in range(lo, total + 1):
            for y in range(lo, total - x + 1):
                if x + y == 0:
                    continue
                p = float(self.predict(x, y))
                if p > best_perf:
                    best, best_perf = (x, y), p
        return best

    def best_allocation_g(self, total: int,
                          g_choices: Sequence[int] = (1, 4, 8),
                          allow_zero: bool = True) -> Tuple[int, int, int]:
        """Eq. 3 extended with the panel-width axis: argmax over
        ``x + y <= total`` and ``g in g_choices``."""
        lo = 0 if allow_zero else 1
        best, best_perf = (lo, lo, min(g_choices)), -np.inf
        for x in range(lo, total + 1):
            for y in range(lo, total - x + 1):
                if x + y == 0:
                    continue
                for g in g_choices:
                    p = float(self.predict(x, y, g))
                    if p > best_perf:
                        best, best_perf = (x, y, g), p
        return best


def _design(samples: np.ndarray) -> np.ndarray:
    """Design matrix for Eq. 2 ((n, 2) samples) or its panel-extended form
    ((n, 3) samples with a trailing g column)."""
    x, y = samples[:, 0], samples[:, 1]
    cols = [np.ones_like(x), x, y, x * x, y * y]
    if samples.shape[1] == 3:
        g = samples[:, 2]
        cols.extend([g, g * g])
    return np.stack(cols, axis=1)


def fit_perf_model(samples: Sequence[Tuple[int, ...]],
                   perfs: Sequence[float], *,
                   ridge: float | None = None,
                   calibrated_from: str | None = None) -> QuadraticPerfModel:
    """Least-squares fit of Eq. 2 over measured (x, y) -> perf samples, or of
    the panel-extended form over (x, y, g) triples.

    Rank-deficient candidate sets (fewer distinct points than coefficients —
    e.g. a caller probing only the axes' endpoints) underdetermine the
    coefficients; plain ``lstsq`` then returns one of infinitely many exact
    fits whose extrapolation ``best_allocation`` would trust blindly.  We
    fall back to a ridge (Tikhonov) solution: minimal-norm coefficients that
    still interpolate the measurements, with the quadratic terms shrunk so
    the argmax cannot run away on unmeasured configurations.

    ``ridge`` — an explicit Tikhonov strength (relative to the mean design
    energy) — forces the regularised solve even on full-rank systems.  The
    trace-calibrated path (:func:`repro.perf.trace.fit_cost_model`) uses
    this: measured samples carry wall-clock noise, and an unregularised
    quadratic happily chases it.  ``calibrated_from`` stamps the returned
    model's provenance field.
    """
    xy = np.asarray(samples, np.float64)
    if xy.ndim != 2 or xy.shape[1] not in (2, 3):
        raise ValueError("samples must be (x, y) pairs or (x, y, g) triples")
    ncoef = 5 if xy.shape[1] == 2 else 7
    if xy.shape[0] < ncoef:
        raise ValueError(f"need >= {ncoef} samples to fit {ncoef} "
                         "coefficients")
    design = _design(xy)
    p = np.asarray(perfs, np.float64)
    deficient = np.linalg.matrix_rank(design) < design.shape[1]
    if ridge is not None or deficient:
        rel = ridge if ridge is not None else 1e-6
        ata = design.T @ design
        lam = rel * max(float(np.trace(ata)) / design.shape[1], 1.0)
        coef = np.linalg.solve(ata + lam * np.eye(design.shape[1]),
                               design.T @ p)
    else:
        coef, *_ = np.linalg.lstsq(design, p, rcond=None)
    return QuadraticPerfModel(coef=coef, calibrated_from=calibrated_from)


def default_candidates(total: int) -> Iterable[Tuple[int, int]]:
    """Representative warm-up configurations (paper §3.1: 'a representative set
    of parameter configurations'): the axes, the diagonal, and the corners."""
    cand = set()
    for t in (1, max(total // 4, 1), max(total // 2, 1), total):
        cand.add((t, 0))
        cand.add((0, t))
        cand.add((t, max(total - t, 0)))
        cand.add((max(total - t, 0), t))
    cand.add((max(total // 2, 1), max(total // 2, 1)))
    return sorted((x, y) for (x, y) in cand if 0 < x + y <= total)


def calibrate(measure: Callable[..., float], total: int,
              candidates: Iterable[Tuple[int, ...]] | None = None,
              g_choices: Sequence[int] | None = None
              ) -> QuadraticPerfModel:
    """Fit the model from warm-up measurements.

    ``measure(x, y)`` returns a performance score (higher is better; e.g.
    GFLOP/s) for ``x`` vector-group and ``y`` matrix-group workers.  With
    ``g_choices``, the warm-up sweep crosses the candidate splits (explicit
    ``candidates`` included, unless they already carry a g column) with each
    panel width and ``measure(x, y, g)`` is expected instead, yielding the
    panel-extended model.
    """
    cand = list(candidates if candidates is not None
                else default_candidates(total))
    if g_choices is not None and (not cand or len(cand[0]) == 2):
        cand = [(x, y, g) for (x, y) in cand for g in g_choices]
    perfs = [measure(*c) for c in cand]
    return fit_perf_model(cand, perfs,
                          calibrated_from=f"calibrate:{len(cand)} probes")


def best_allocation(measure: Callable[[int, int], float], total: int
                    ) -> Tuple[int, int]:
    """Calibrate + schedule in one call (paper §3.5.3)."""
    return calibrate(measure, total).best_allocation(total)
