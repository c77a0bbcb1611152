"""Versioned perf traces: record what the engine ran and how long it took.

Port of ``repro/perf/trace.py``, under the reference's
``TRACE_SCHEMA_VERSION`` and record kinds: the port's engine emits the
reference's structural fields (``kernels/engine.py::_panel_note_fields``),
so trace files of the two packages read with either loader.  This is the
measurement half of the trace → fit → replay loop.  A
:class:`TraceRecorder` captures three kinds of records into one
append-only list:

  * ``dispatch`` — structural facts from the execution engine's tracer hook
    (:func:`repro_torch.kernels.engine.set_tracer`): which ``(part, op)``
    kernel flavour ran, its panel/nonzero count, batch and column extents.
    The port's engine notes every call (the reference's, every jit
    compilation); they carry no wall-clock — they attribute a workload to
    pipelines.
  * ``spmm`` / ``search_trial`` — one measured SpMM cell: the plan knobs
    (``r_frac``, ``t_vpu``, ``t_mxu``, ``br``, ``panel_g``), the matrix key,
    per-part and total grid-step counts, and the median wall microseconds of
    the synchronised call.  These are what :func:`fit_cost_model` and
    :class:`repro_torch.perf.replay.TraceDB` consume.
  * ``step`` — per-call wall-clock of a wrapped step function (train /
    prefill / decode), indexed by call number.

Traces serialise to JSONL (one JSON object per line, every line stamped with
``schema = TRACE_SCHEMA_VERSION``) under ``benchmarks/results/traces/`` by
default; :func:`load_traces` refuses a future schema version instead of
silently misreading it.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..core.perf_model import QuadraticPerfModel, fit_perf_model

__all__ = ["TRACE_SCHEMA_VERSION", "TraceRecorder", "default_trace_dir",
           "load_traces", "fit_cost_model", "matrix_key"]

TRACE_SCHEMA_VERSION = 1

# Record kinds a trace file may contain (bench_schema.json mirrors this).
TRACE_KINDS = ("dispatch", "spmm", "search_trial", "step")


def default_trace_dir() -> pathlib.Path:
    """``benchmarks/results/traces/`` at the repo root (the checkout layout
    this project runs from), overridable via ``$REPRO_TRACE_DIR``."""
    env = os.environ.get("REPRO_TRACE_DIR")
    if env:
        return pathlib.Path(env)
    root = pathlib.Path(__file__).resolve().parents[3]
    return root / "benchmarks" / "results" / "traces"


def matrix_key(csr) -> str:
    """Stable identity of a matrix's *row-statistics* structure.

    Uses only the permutation-invariant prefix of the tuner fingerprint
    (shape, nnz, per-row mean/cv/max — the Table-2 statistics), quantised
    into the same 0.5-wide log-space bins as the plan cache.  Two matrices
    that differ only by a row permutation — or by values — share a key, so
    trace records transfer exactly when a measured step time is expected to
    transfer.
    """
    from ..tune.fingerprint import fingerprint
    fp = fingerprint(csr)
    inv = fp.quantised()[:6]   # permutation-invariant row-stat features
    return "mx-" + ",".join(f"{q:.1f}" for q in inv)


def _plan_fields(plan, nrows: int) -> Dict:
    return {
        "r_frac": float(plan.r_boundary) / max(int(nrows), 1),
        "t_vpu": int(plan.t_vpu), "t_mxu": int(plan.t_mxu),
        "br": int(plan.br), "panel_g": int(plan.panel_g),
        "pipeline_depth": int(getattr(plan, "pipeline_depth", 1)),
        "macro_m": int(getattr(plan, "macro_m", 1)),
    }


@dataclasses.dataclass
class TraceRecorder:
    """Collects schema-stamped perf records; attach/save are explicit.

    Typical benchmark usage::

        rec = TraceRecorder(source="fig4")
        with rec.attach_engine():          # dispatch attribution (optional)
            rec.record_spmm(csr, plan, wall_s=secs, n_cols=N, backend="cuda")
        rec.save()                         # -> benchmarks/results/traces/
    """

    source: str = "manual"
    records: List[Dict] = dataclasses.field(default_factory=list)

    # -- raw record entry -------------------------------------------------
    def record(self, kind: str, **fields) -> Dict:
        if kind not in TRACE_KINDS:
            raise ValueError(f"unknown trace record kind {kind!r}; "
                             f"expected one of {TRACE_KINDS}")
        rec = {"schema": TRACE_SCHEMA_VERSION, "kind": kind,
               "source": self.source, **fields}
        self.records.append(rec)
        return rec

    # -- engine dispatch hook --------------------------------------------
    def on_dispatch(self, **fields) -> None:
        """Engine tracer callback (structure only — one per engine call)."""
        self.record("dispatch", **fields)

    def attach_engine(self):
        """Context manager installing this recorder as the engine tracer."""
        from ..kernels import engine
        recorder = self

        class _Attach:
            def __enter__(self):
                self._prev = engine.set_tracer(recorder)
                return recorder

            def __exit__(self, *exc):
                engine.set_tracer(self._prev)
                return False

        return _Attach()

    # -- measured SpMM cells ----------------------------------------------
    def record_spmm(self, csr, plan, *, wall_s: float, n_cols: int,
                    backend: str, kind: str = "spmm",
                    label: Optional[str] = None,
                    gflops: Optional[float] = None) -> Dict:
        """One measured (matrix, plan) cell.

        ``wall_s`` is the synchronised median wall seconds of the call the
        caller timed; grid-step counts are derived structurally from
        ``(csr, plan)`` via :func:`repro_torch.perf.replay.predict_part_steps`
        (no conversion is performed here).
        """
        from .replay import predict_part_steps
        s_csr, s_bcsr = predict_part_steps(csr, plan, n_cols)
        nnz = int(np.count_nonzero(csr.vals))
        if gflops is None and wall_s > 0:
            gflops = 2.0 * nnz * int(n_cols) / wall_s / 1e9
        return self.record(
            kind,
            matrix=label if label is not None else matrix_key(csr),
            backend=str(backend), n_cols=int(n_cols), nnz=nnz,
            nrows=int(csr.nrows), ncols=int(csr.ncols),
            wall_us=float(wall_s) * 1e6,
            gflops=float(gflops) if gflops is not None else 0.0,
            grid_steps=int(s_csr + s_bcsr),
            grid_steps_csr=int(s_csr), grid_steps_bcsr=int(s_bcsr),
            **_plan_fields(plan, csr.nrows))

    # -- step-function wrapping --------------------------------------------
    def wrap_step(self, fn: Callable, *, op: str,
                  part: str = "step") -> Callable:
        """Wrap a step function: each call synchronises the devices of its
        outputs and appends a ``step`` record with the call's wall
        microseconds."""
        from ..obs.spans import synchronize
        counter = [0]

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            synchronize(out)
            dt = time.perf_counter() - t0
            self.record("step", part=part, op=op, step=counter[0],
                        wall_us=dt * 1e6)
            counter[0] += 1
            return out

        return wrapped

    # -- persistence ------------------------------------------------------
    def save(self, path: os.PathLike | str | None = None) -> pathlib.Path:
        """Write all records as JSONL.  Default target:
        ``default_trace_dir()/<source>.jsonl`` (deterministic name, so a
        re-run replaces the previous trace instead of accumulating)."""
        if path is None:
            path = default_trace_dir() / f"{self.source}.jsonl"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path


def load_traces(path: os.PathLike | str) -> List[Dict]:
    """Read one JSONL trace file (or every ``*.jsonl`` in a directory),
    validating the schema stamp on every record."""
    path = pathlib.Path(path)
    files = sorted(path.glob("*.jsonl")) if path.is_dir() else [path]
    records: List[Dict] = []
    for fp in files:
        with open(fp) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                ver = rec.get("schema")
                if ver != TRACE_SCHEMA_VERSION:
                    raise ValueError(
                        f"{fp}:{ln}: trace schema {ver!r} != supported "
                        f"{TRACE_SCHEMA_VERSION}")
                records.append(rec)
    return records


def fit_cost_model(traces: Iterable[Dict], *, ridge: float = 1e-3,
                   g_choices: Sequence[int] | None = None
                   ) -> Optional[QuadraticPerfModel]:
    """Refit the Eq. 2 / panel-extended Eq. 2 coefficients from measured
    trace records, replacing hand-set model inputs.

    Groups ``spmm``/``search_trial`` records by their plan knobs: each
    record is one ``(t_vpu, t_mxu, panel_g) -> gflops`` sample (multiple
    records of the same knobs average).  The fit is ridge-regularised
    (``ridge`` is relative Tikhonov strength — measured perfs are noisy) and
    the returned model carries a ``calibrated_from`` provenance stamp.

    Returns ``None`` when the traces hold too few distinct samples to
    determine even the 5-coefficient Eq. 2 form.
    """
    by_knobs: Dict[tuple, List[float]] = {}
    nused = 0
    for rec in traces:
        if rec.get("kind") not in ("spmm", "search_trial"):
            continue
        if not all(k in rec for k in ("t_vpu", "t_mxu", "panel_g")):
            continue
        perf = rec.get("gflops")
        if perf is None or not np.isfinite(perf) or perf <= 0:
            continue
        nused += 1
        knobs = (int(rec["t_vpu"]), int(rec["t_mxu"]), int(rec["panel_g"]))
        by_knobs.setdefault(knobs, []).append(float(perf))

    samples = [(x, y, g) for (x, y, g) in by_knobs]
    perfs = [float(np.mean(by_knobs[k])) for k in by_knobs]
    gs = {g for (_, _, g) in samples}
    use_g = len(gs) > 1 if g_choices is None else len(g_choices) > 1
    if use_g and len(samples) < 7:
        use_g = False   # not enough knobs for the panel terms; drop to Eq. 2
    if not use_g:
        # Collapse the G axis: re-average over (x, y) alone.
        by_xy: Dict[tuple, List[float]] = {}
        for (x, y, g), p in zip(samples, perfs):
            by_xy.setdefault((x, y), []).append(p)
        samples = list(by_xy)
        perfs = [float(np.mean(by_xy[k])) for k in by_xy]
    ncoef = 7 if use_g else 5
    if len(samples) < ncoef:
        return None
    return fit_perf_model(
        samples, perfs, ridge=ridge,
        calibrated_from=f"traces:{nused} records, "
                        f"{len(samples)} distinct knobs")
