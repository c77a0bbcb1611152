"""Budgeted empirical plan search, warm-started by the quadratic model.

Port of ``repro/tune/search.py``.  The plan space is the cross product the
paper's pipeline exposes:

  * ``r_boundary`` — candidates from the Eq. 1 solution under each worker
    split, the regularity heuristic, the pure-CSR / pure-BCSR extremes and a
    fraction sweep (the Algorithm 1 conversion is re-run per candidate);
  * ``Br ∈ {2, 4, 8}`` — tile heights;
  * ``G ∈ {1, 4, 8}`` and ``macro_m ∈ {1, 4}`` — panel widths;
  * ``(t_vpu, t_mxu)`` — worker splits with ``t_vpu + t_mxu = T``.

The quadratic model (Eq. 2) only *prunes* to the top-k candidates (or, with
a ``trace_db``, the replayed step time ranks them), and wall-clock
measurement on the device picks the winner among them.

Changes from the reference, each pinned by a test
(``tests/test_torch_tune.py``):

  * **The timed window.** :func:`measure_plan_gflops` uploads the format
    and builds B1/B2's unit tables (``fmt.on(device)``) and counts its
    nonzeros before the clock starts, so a candidate is ranked by its
    kernels' time and not by its host upload (the serving warm-up measures
    with ``warmup=0``).  On a CUDA device a trial is timed with CUDA
    events around a run of :data:`CUDA_RUN_CALLS` back-to-back calls, the
    median of ``budget.repeats`` runs: a host clock around one
    synchronised call also counts the host's share of the call and the
    synchronisation, about half of a call's time at pwtk's size.  On the
    CPU each call is timed alone on the host clock.
  * **The model's plan is a trial.** On a CUDA device the plan that
    :func:`repro_torch.core.spmm.plan_for` gives (what ``plan_and_convert``
    runs without a tuner) is measured after the survivors when no
    survivor converts the same way and ``budget.max_trials`` leaves room,
    so the tuned plan does not lose to the model's by more than the
    timing's spread.  The survivors themselves are the reference's.
  * **Trial isolation.** Only an injected fault (``tune.trial``, or one
    injected inside the measurement) and the ``trial_timeout_s`` overrun
    skip a trial.  Any other exception propagates: on ``"cuda"`` it is a
    kernel that fails to build or launch, which the reference's catch-all
    would hide behind a model-ranked plan (and a CUDA error is sticky).
  * **Pinned axes.** On ``"torch"`` (the flat references, the reference's
    ``"jnp"``) ``G``, ``macro_m`` and depth are pinned as the reference pins
    them on ``"jnp"``.  On ``"cuda"`` ``pipeline_depth`` is pinned to 1: no
    kernel reads it (the engine only notes it), so timing it would rank
    noise; ``G`` and ``macro_m`` are measured.  Tile heights without a B2
    instantiation (``kernels.bcsr_spmm.KERNEL_BRS``: Br 2) are not
    candidates on ``"cuda"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.formats import CSR, LoopsFormat, loops_from_csr
from ..core.partition import choose_r_boundary, regularity_boundary
from ..core.perf_model import QuadraticPerfModel, fit_perf_model
from ..core.spmm import SpmmPlan, loops_spmm, plan_for
from ..kernels import engine
from ..kernels.bcsr_spmm import KERNEL_BRS
from ..resilience.fallback import classify
from ..resilience.inject import InjectedFault, fault_point, note_degraded

__all__ = ["SearchBudget", "SearchResult", "enumerate_plans", "search",
           "prior_model", "measure_plan_gflops"]


@dataclasses.dataclass(frozen=True)
class SearchBudget:
    """Caps on how much the empirical stage may spend."""

    top_k: int = 4        # candidates that survive the model pruning
    repeats: int = 3      # timed repetitions per candidate (median)
    warmup: int = 1       # untimed warm-up calls
    max_trials: int = 12  # hard cap on measured conversions
    trial_timeout_s: Optional[float] = None  # wall-clock cap per trial —
    # an overrunning candidate is treated as a failed trial (skipped,
    # counted), never the winner; None disables the check


@dataclasses.dataclass(frozen=True)
class SearchResult:
    plan: SpmmPlan
    fmt: LoopsFormat                      # the winning conversion, reusable
    gflops: float                         # measured throughput of the winner
    trials: Tuple[Tuple[SpmmPlan, float], ...]  # every measured (plan, gflops)

    @property
    def measured(self) -> int:
        return len(self.trials)


def prior_model(total_workers: int, *, tp_vpu: float = 1.0,
                tp_mxu: float = 4.0) -> QuadraticPerfModel:
    """Warm-start model when no calibrated one is supplied: fit Eq. 2 to the
    linear capacity surface ``tp_vpu*x + tp_mxu*y`` (the same proportional
    prior ``plan_and_convert`` uses), so pruning is deterministic."""
    pts = [(x, y) for x in range(total_workers + 1)
           for y in range(total_workers + 1 - x)]
    perfs = [tp_vpu * x + tp_mxu * y for (x, y) in pts]
    return fit_perf_model(pts, perfs)


def _worker_splits(total: int) -> List[Tuple[int, int]]:
    """All (t_vpu, t_mxu) with t_vpu + t_mxu = total, plus the pure ends."""
    splits = [(x, total - x) for x in range(total + 1)]
    return splits


def _r_candidates(csr: CSR, br: int, splits: Sequence[Tuple[int, int]],
                  *, tp_vpu: float, tp_mxu: float) -> List[int]:
    """r_boundary candidates: Eq. 1 under each split + heuristic + extremes
    + a coarse fraction sweep (Alg. 1 is re-run per surviving candidate)."""
    n = csr.nrows
    cands = {0, n}
    for (x, y) in splits:
        if x + y:
            cands.add(choose_r_boundary(n, tp_vpu, tp_mxu, x, y, br=br))
    cands.add(regularity_boundary(csr, br=br))
    for frac in (0.125, 0.25, 0.5, 0.75):
        cands.add(min(max(int(frac * n) // br * br, 0), n))
    return sorted(cands)


def enumerate_plans(csr: CSR, *, total_workers: int = 8,
                    br_choices: Sequence[int] = (2, 4, 8),
                    g_choices: Sequence[int] = (1, 4, 8),
                    depth_choices: Sequence[int] = (1, 2),
                    macro_choices: Sequence[int] = (1, 4),
                    tp_vpu: float = 1.0, tp_mxu: float = 4.0
                    ) -> List[SpmmPlan]:
    """The full (deduplicated) candidate plan space, including the pipeline
    axes: ``pipeline_depth`` (double-buffered B-panel prefetch) and
    ``macro_m`` (same-row macro-step fusion, panelizing at the effective
    width ``panel_g·macro_m``)."""
    seen, plans = set(), []
    splits = [(x, y) for (x, y) in _worker_splits(total_workers) if x + y > 0]
    for br in br_choices:
        for r_b in _r_candidates(csr, br, splits, tp_vpu=tp_vpu,
                                 tp_mxu=tp_mxu):
            for (t_vpu, t_mxu) in splits:
                # A split must be executable for the regions it implies.
                if r_b > 0 and t_vpu == 0:
                    continue
                if r_b < csr.nrows and t_mxu == 0:
                    continue
                for g in g_choices:
                    for d in depth_choices:
                        for m in macro_choices:
                            key = (r_b, br, t_vpu, t_mxu, g, d, m)
                            if key in seen:
                                continue
                            seen.add(key)
                            plans.append(SpmmPlan(
                                r_boundary=r_b, t_vpu=t_vpu, t_mxu=t_mxu,
                                br=br, panel_g=g, pipeline_depth=d,
                                macro_m=m))
    return plans


# Back-to-back calls in one timed run of a trial on a CUDA device.
CUDA_RUN_CALLS = 5


def _time_fn(fn, *args, repeats: int, warmup: int,
             device: torch.device) -> float:
    """Median seconds per call of ``fn(*args)`` after ``warmup`` calls.  On
    a CUDA device: CUDA events around each of ``repeats`` runs of
    :data:`CUDA_RUN_CALLS` back-to-back calls, read once the run's end
    event has completed, divided by the calls; on the CPU: the host clock
    around each call."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            for _ in range(max(repeats, 1)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CUDA_RUN_CALLS):
                    fn(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3 / CUDA_RUN_CALLS)
    else:
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_plan_gflops(csr: CSR, plan: SpmmPlan, b: torch.Tensor, *,
                        backend: str = "cuda",
                        budget: SearchBudget = SearchBudget()
                        ) -> Tuple[LoopsFormat, float]:
    """Convert (Algorithm 1) under ``plan`` and time the hybrid execution
    on ``b``'s device.

    The format's panels and B1/B2's unit tables are uploaded, and its
    nonzeros counted, before the timed window.  ``b`` may carry leading
    batch dims — the timed call is then the native batched engine call, and
    the FLOP count uses the effective column count ``prod(batch) * N`` the
    engine actually processes."""
    from .fingerprint import effective_n_cols
    fmt = loops_from_csr(csr, plan.r_boundary, plan.br,
                         panel_g=plan.panel_g,
                         macro_m=getattr(plan, "macro_m", 1),
                         pipeline_depth=getattr(plan, "pipeline_depth", 1))
    if backend == "cuda":
        fmt.on(b.device)
    nnz = max(fmt.nnz, 1)

    def call(bb):
        return loops_spmm(fmt, bb, device=bb.device, backend=backend)
    with torch.no_grad():
        secs = _time_fn(call, b, repeats=budget.repeats,
                        warmup=budget.warmup, device=b.device)
    return fmt, 2.0 * nnz * effective_n_cols(b.shape) / secs / 1e9


def _on_card(b: torch.Tensor) -> bool:
    """Whether the search measures on a CUDA device, where the model's own
    plan joins the trials (the module docstring's divergence)."""
    return b.device.type == "cuda"


def _conversion(p: SpmmPlan) -> tuple:
    """The knobs that change a plan's conversion (not its worker split)."""
    return (p.r_boundary, p.br, p.panel_g, p.macro_m, p.pipeline_depth)


def _step_reduction_priors(csr: CSR, g_choices: Sequence[int]
                           ) -> dict[int, float]:
    """Structural grid-step reduction per panel width: nnz over the panel
    count ``sum(max(ceil(c_row / g), 1))`` — the exact factor by which G-wide
    panels shrink the kernel grid for THIS matrix (padding included), used to
    rank the G axis before any wall-clock measurement."""
    counts = np.diff(csr.row_ptr).astype(np.int64)
    nnz = max(int(counts.sum()), 1)
    return {g: nnz / max(int(np.maximum(-(-counts // g), 1).sum()), 1)
            for g in g_choices}


def search(csr: CSR, *, n_cols: int = 32, rhs_shape=None,
           total_workers: int = 8,
           model: Optional[QuadraticPerfModel] = None,
           br_choices: Sequence[int] = (2, 4, 8),
           g_choices: Sequence[int] = (1, 4, 8),
           depth_choices: Sequence[int] = (1, 2),
           macro_choices: Sequence[int] = (1, 4),
           budget: SearchBudget = SearchBudget(), backend: str = "cuda",
           b: Optional[torch.Tensor] = None, seed: int = 0,
           tp_vpu: float = 1.0, tp_mxu: float = 4.0,
           measure: Optional[Callable[[CSR, SpmmPlan, torch.Tensor],
                                      Tuple[LoopsFormat, float]]] = None,
           trace_db=None, recorder=None, device=None
           ) -> SearchResult:
    """Model-pruned, measurement-ranked plan search.

    ``rhs_shape`` — a full ``(..., K, N)`` operand shape — makes the
    measurement operand batched, so candidates are timed on the exact
    batched engine call the workload will issue (``n_cols`` is then ignored
    in favour of the effective column count).  ``measure(csr, plan, b) ->
    (fmt, gflops)`` may be injected for deterministic tests; the default is
    wall-clock :func:`measure_plan_gflops` with ``backend``.  The operand
    ``b`` is drawn from ``seed`` on ``device`` (``None`` -> CUDA; raises
    without a GPU) unless given.

    ``trace_db`` — a :class:`repro_torch.perf.replay.TraceDB` of measured
    cells —
    upgrades the pruning stage: candidates are ranked by their *replayed*
    step time (structural grid steps × fitted per-step cost, no conversion
    paid) instead of the capacity prior; the measurement stage is unchanged.
    ``recorder`` — a :class:`repro_torch.perf.trace.TraceRecorder` — captures
    every measured trial as a ``search_trial`` record, feeding the next
    fit/replay round.
    """
    if rhs_shape is not None and tuple(rhs_shape)[-2] != csr.ncols:
        raise ValueError(f"rhs_shape K={tuple(rhs_shape)[-2]} does not "
                         f"match csr.ncols={csr.ncols}")
    if b is not None and rhs_shape is not None \
            and tuple(b.shape) != tuple(rhs_shape):
        raise ValueError(f"explicit b has shape {tuple(b.shape)} but "
                         f"rhs_shape={tuple(rhs_shape)}; pass one or make "
                         "them agree — candidates are measured on b")
    backend = engine.resolve_backend(backend)
    if b is None:
        rng = np.random.default_rng(seed)
        dt = csr.vals.dtype if np.issubdtype(csr.vals.dtype, np.floating) \
            else np.float32
        shape = tuple(rhs_shape) if rhs_shape is not None \
            else (csr.ncols, n_cols)
        b = torch.as_tensor(rng.standard_normal(shape).astype(dt),
                            device=engine.resolve_device(device))
    elif device is not None or not isinstance(b, torch.Tensor):
        b = engine.as_operand(b, engine.resolve_device(device))
    if backend == "cuda":
        depth_choices = (1,)
        br_choices = tuple(br for br in br_choices if br in KERNEL_BRS)
        if not br_choices:
            raise ValueError(f"no tile height in br_choices has a B2 "
                             f"instantiation {KERNEL_BRS}")
    model = model or prior_model(total_workers)
    plans = enumerate_plans(csr, total_workers=total_workers,
                            br_choices=br_choices, g_choices=g_choices,
                            depth_choices=depth_choices,
                            macro_choices=macro_choices,
                            tp_vpu=tp_vpu, tp_mxu=tp_mxu)

    # Warm start.  The Eq. 2 model only sees the worker split, so by itself
    # it cannot rank *conversions* (all (r_boundary, br) share a split
    # score); couple it with the balanced-time term of Eq. 1 — the bottleneck
    # pipeline's finish time for THIS boundary under THIS split — so the
    # ranking prefers boundary/split pairs that are mutually consistent and
    # the top-k survivors span genuinely different conversions.  The G axis
    # is ranked by its measured panel terms when the model has them, else by
    # the structural grid-step reduction it buys on this matrix.
    n = max(csr.nrows, 1)
    # Priors are computed over *effective* widths (panel_g·macro_m) — the
    # width the conversion actually panelizes at — so the macro axis shares
    # the same structural step-reduction signal as the G axis.
    eff_widths = sorted({max(g, 1) * max(m, 1)
                         for g in g_choices for m in macro_choices}
                        | set(g_choices))
    step_prior = _step_reduction_priors(csr, eff_widths)

    if measure is None and backend == "torch":
        # The flat references execute the flat arrays — wall clock on it is
        # blind to panel_g/macro_m/pipeline_depth, so "measuring" those axes
        # would let timing noise pick the cached knobs.  Pin (G, macro_m) to
        # the structural winner (max grid-step reduction at the effective
        # width; ties prefer the narrower effective panel, whose padding DMA
        # is smaller, and within a width the macro-fused shape, which costs
        # fewer grid dispatches), pin depth to 1 (ramp steps only ever add
        # work the flat path cannot observe), and spend the whole measurement
        # budget on genuinely different (r_boundary, br) conversions.
        g_star, m_star = max(
            ((g, m) for g in g_choices for m in macro_choices),
            key=lambda gm: (step_prior.get(gm[0] * gm[1], 0.0),
                            -(gm[0] * gm[1]), gm[1]))
        plans = [p for p in plans if p.panel_g == g_star
                 and p.macro_m == m_star and p.pipeline_depth == 1]

    def _prior(p: SpmmPlan) -> float:
        t_v = p.r_boundary / (tp_vpu * p.t_vpu) if p.r_boundary else 0.0
        t_m = (n - p.r_boundary) / (tp_mxu * p.t_mxu) \
            if p.r_boundary < n else 0.0
        bottleneck = max(t_v, t_m, 1e-12)
        if model.has_panel_terms:
            capacity = float(model.predict(p.t_vpu, p.t_mxu, p.panel_g))
            g_scale = 1.0
        else:
            capacity = float(model.predict(p.t_vpu, p.t_mxu))
            g_scale = step_prior.get(p.panel_g * p.macro_m, 1.0)
        return max(capacity, 1e-12) * g_scale * n / bottleneck

    # Replay-based pruning: when a trace database can support a per-step
    # cost fit, rank candidates by predicted wall time of THIS matrix under
    # each plan (lower is better) — a measured signal that already folds in
    # boundary, tile height and panel width — instead of the capacity prior.
    replay_rank = None
    if trace_db is not None:
        from ..perf.replay import part_step_counter
        from .fingerprint import effective_n_cols
        coef = trace_db.step_cost(backend)
        if coef is not None:
            eff_cols = effective_n_cols(rhs_shape) if rhs_shape is not None \
                else n_cols
            steps_of = part_step_counter(csr, eff_cols)

            def replay_rank(p: SpmmPlan) -> float:
                s_csr, s_bcsr = steps_of(p)
                return trace_db.predict_us(
                    coef, s_csr, s_bcsr, p.panel_g * p.macro_m,
                    depth=p.pipeline_depth)

    scored = sorted(plans, key=(replay_rank if replay_rank is not None
                                else lambda p: -_prior(p)))
    survivors: List[SpmmPlan] = []
    seen_conv = set()
    seen_base = set()
    k = min(budget.top_k, budget.max_trials)
    # Two-pass slot allocation: a small budget must still span genuinely
    # different (r_boundary, br) conversions — the panel/pipeline axes
    # multiply the space and would otherwise fill every slot with shape
    # variants of the single best boundary.  Each boundary/tile pair is
    # represented by its best-ranked (G, macro_m, depth) shape; leftover
    # slots then explore the remaining variants in rank order.
    for p in scored:
        base = (p.r_boundary, p.br)
        if base in seen_base:
            continue
        seen_base.add(base)
        seen_conv.add(_conversion(p))
        survivors.append(p)
        if len(survivors) >= k:
            break
    if len(survivors) < k:
        for p in scored:
            conv = _conversion(p)
            if conv in seen_conv:
                continue
            seen_conv.add(conv)
            survivors.append(p)
            if len(survivors) >= k:
                break

    meas = measure or (lambda c, p, bb: measure_plan_gflops(
        c, p, bb, backend=backend, budget=budget))
    to_measure = list(survivors)
    if backend == "cuda" and _on_card(b):
        model_plan = plan_for(csr, total_workers=total_workers,
                              tp_vpu=tp_vpu, tp_mxu=tp_mxu)
        if _conversion(model_plan) not in seen_conv \
                and len(to_measure) < budget.max_trials:
            to_measure.append(model_plan)
    trials: List[Tuple[SpmmPlan, float]] = []
    best_plan, best_fmt, best_g = None, None, -1.0
    for p in to_measure:
        # Trial isolation: an injected fault (``tune.trial`` is the chaos
        # injection site) or, under ``trial_timeout_s``, a grossly
        # overrunning candidate must not abort the whole search.  The
        # failed trial is counted and skipped; the surviving measurements
        # still rank.  Any other exception is a real failure (a kernel that
        # does not build or launch) and propagates.
        t0 = time.perf_counter()
        try:
            fault_point("tune.trial")
            fmt, g = meas(csr, p, b)
        except InjectedFault as e:
            note_degraded("tune.search.trial_failed", reason=classify(e))
            continue
        if budget.trial_timeout_s is not None \
                and time.perf_counter() - t0 > budget.trial_timeout_s:
            note_degraded("tune.search.trial_failed", reason="timeout")
            continue
        trials.append((p, g))
        if recorder is not None:
            from .fingerprint import effective_n_cols as _eff
            eff = _eff(b.shape)
            nnz = max(int(np.count_nonzero(csr.vals)), 1)
            wall_s = 2.0 * nnz * eff / (g * 1e9) if g > 0 else 0.0
            recorder.record_spmm(csr, p, wall_s=wall_s, n_cols=eff,
                                 backend=backend, kind="search_trial",
                                 gflops=g)
        if g > best_g:
            best_plan, best_fmt, best_g = p, fmt, g
    if best_plan is None:
        # Every trial failed by injection or timeout: degrade to the
        # model-ranked front-runner (the
        # Eq. 2 prior / replay ranking) rather than raising — the same plan
        # the paper's low-cost scheduler would have picked with no
        # measurement at all.  gflops=0.0 marks the record as unmeasured.
        note_degraded("tune.search.degraded", reason="all-trials-failed")
        best_plan = survivors[0] if survivors else scored[0]
        best_fmt = loops_from_csr(csr, best_plan.r_boundary, best_plan.br,
                                  panel_g=best_plan.panel_g,
                                  macro_m=best_plan.macro_m,
                                  pipeline_depth=best_plan.pipeline_depth)
        best_g = 0.0
    return SearchResult(plan=best_plan, fmt=best_fmt, gflops=best_g,
                        trials=tuple(trials))
