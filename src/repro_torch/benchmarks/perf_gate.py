"""Perf regression gate: diff bench.json against a committed baseline.

Port of the reference's ``tools/perf_gate.py``, with the same identity
key and tolerance bands.  ``python -m repro_torch.benchmarks.run --smoke``
writes ``build/bench/bench.json``; this gate diffs it against the
committed ``src/repro_torch/benchmarks/baselines/BENCH_<PR>.json`` and
exits non-zero on regression, so a change that keeps results right but
inflates the grid (or silently drops a benchmark column) fails.

Both files are first validated against the port's copy of the bench
schema, ``src/repro_torch/benchmarks/bench_schema.json`` (via the
dependency-free subset validator ``repro_torch.perf.schema``).  Records
pair up on the identity key ``(suite, matrix, dtype, batch, n_cols)``;
per-metric tolerance bands then apply:

  * **exact**   — ``steps_*`` / ``grid_steps*`` / ``panel_g`` / ``nnz`` /
    ``pipeline_depth`` / ``macro_m``:
    structural counts, deterministic functions of the seeded matrices and
    the resolved plan; ANY difference fails (an improvement means the
    baseline is stale — refresh it with ``run.py --update-baseline``);
  * **near**    — ``step_reduction*``: derived ratios of exact counts;
    relative tolerance 1e-6 (float formatting slack only);
  * **wall**    — every other numeric column (``*_us*``, ``gflops``,
    ``vs_*``): machine-dependent; a wide worse-than ratio band
    (``--wall-tol``, default 10x) catches order-of-magnitude cliffs while
    tolerating cross-machine variance.  ``--wall-tol inf`` disables wall
    checks entirely (what a cross-machine check uses: the committed
    baseline is recorded on the CPU, and the grid-step columns carry the
    gate between the CPU and the card).

A baseline record missing from the current run, or a baseline column
missing from its paired record, is always a failure.

Run:  python -m repro_torch.benchmarks.perf_gate [--baseline F]
          [--current F] [--wall-tol X]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
from typing import Dict, List, Sequence

from ..perf.schema import load_schema, validate
from .run import DEFAULT_BASELINE, DEFAULT_OUT

HERE = pathlib.Path(__file__).resolve().parent
SCHEMA_PATH = HERE / "bench_schema.json"
DEFAULT_CURRENT = DEFAULT_OUT / "bench.json"

KEY_FIELDS = ("suite", "matrix", "dtype", "batch", "n_cols")
EXACT_PREFIXES = ("steps_", "grid_steps")
EXACT_FIELDS = {"panel_g", "nnz", "pipeline_depth", "macro_m"}
NEAR_PREFIX = "step_reduction"
HIGHER_BETTER_TOKENS = ("gflops", "vs_", "speedup", "reduction")


def record_key(rec: Dict) -> tuple:
    return tuple(rec.get(k) for k in KEY_FIELDS)


def classify(field: str) -> str:
    """Tolerance class of a numeric column: 'key', 'exact', 'near', 'wall'."""
    if field in KEY_FIELDS:
        return "key"
    if field.startswith(EXACT_PREFIXES) or field in EXACT_FIELDS:
        return "exact"
    if field.startswith(NEAR_PREFIX):
        return "near"
    return "wall"


def _higher_better(field: str) -> bool:
    return any(tok in field for tok in HIGHER_BETTER_TOKENS)


def validate_records(records, schema: Dict, label: str) -> List[str]:
    """Schema-validate a bench record list; returns problem strings."""
    probs = validate(records, {"$ref": "#/definitions/bench_file"}, schema)
    return [f"{label}: schema violation at {p}" for p in probs]


def diff_records(baseline: Sequence[Dict], current: Sequence[Dict], *,
                 wall_tol: float = 10.0,
                 near_rtol: float = 1e-6) -> List[str]:
    """Compare current records against the baseline; returns failures.

    Library entry point — the negative self-test
    (tests/test_torch_perf_gate.py) injects synthetic regressions through
    here.
    """
    failures: List[str] = []
    cur_by_key = {record_key(r): r for r in current}
    for brec in baseline:
        if brec.get("skipped"):
            continue
        key = record_key(brec)
        crec = cur_by_key.get(key)
        if crec is None:
            failures.append(f"{key}: baseline record missing from current "
                            "bench.json (suite dropped or renamed?)")
            continue
        for field, bval in brec.items():
            if isinstance(bval, bool) or not isinstance(bval, (int, float)):
                continue
            kind = classify(field)
            if kind == "key":
                continue
            if field not in crec:
                failures.append(f"{key}: column {field!r} dropped from "
                                "current record")
                continue
            cval = crec[field]
            if isinstance(cval, bool) or not isinstance(cval, (int, float)):
                failures.append(f"{key}: column {field!r} is no longer "
                                f"numeric ({cval!r})")
                continue
            if kind == "exact":
                if int(round(cval)) != int(round(bval)):
                    failures.append(
                        f"{key}: {field} changed {int(round(bval))} -> "
                        f"{int(round(cval))} (exact metric; regression, or "
                        "refresh the baseline with --update-baseline)")
            elif kind == "near":
                denom = max(abs(bval), 1e-12)
                if abs(cval - bval) / denom > near_rtol:
                    failures.append(
                        f"{key}: {field} drifted {bval:.6f} -> {cval:.6f} "
                        f"(derived ratio; tolerance {near_rtol:g})")
            else:   # wall-clock class
                if not math.isfinite(wall_tol):
                    continue
                if _higher_better(field):
                    if bval > 0 and cval < bval / wall_tol:
                        failures.append(
                            f"{key}: {field} collapsed {bval:.3g} -> "
                            f"{cval:.3g} (> {wall_tol:g}x worse)")
                else:
                    if bval > 0 and cval > bval * wall_tol:
                        failures.append(
                            f"{key}: {field} inflated {bval:.3g} -> "
                            f"{cval:.3g} (> {wall_tol:g}x worse)")
    return failures


def run_gate(baseline_path, current_path, *, wall_tol: float = 10.0,
             near_rtol: float = 1e-6,
             schema_path=SCHEMA_PATH) -> List[str]:
    """Load + schema-validate + diff; returns the full failure list."""
    failures: List[str] = []
    try:
        with open(baseline_path) as f:
            baseline = json.load(f)
    except (OSError, ValueError) as e:
        return [f"baseline {baseline_path}: unreadable ({e})"]
    try:
        with open(current_path) as f:
            current = json.load(f)
    except (OSError, ValueError) as e:
        return [f"current {current_path}: unreadable ({e})"]
    schema = load_schema(schema_path)
    failures += validate_records(baseline, schema, f"baseline")
    failures += validate_records(current, schema, f"current")
    failures += diff_records(baseline, current, wall_tol=wall_tol,
                             near_rtol=near_rtol)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff bench.json against the committed baseline; "
                    "non-zero exit on regression.")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="committed BENCH_<PR>.json baseline")
    ap.add_argument("--current", default=str(DEFAULT_CURRENT),
                    help="bench.json produced by repro_torch.benchmarks.run")
    ap.add_argument("--wall-tol", type=float, default=10.0,
                    help="worse-than ratio band for wall-clock metrics "
                         "('inf' disables them; exact/near classes are "
                         "unaffected)")
    ap.add_argument("--near-rtol", type=float, default=1e-6,
                    help="relative tolerance for derived-ratio metrics")
    args = ap.parse_args(argv)

    failures = run_gate(args.baseline, args.current, wall_tol=args.wall_tol,
                        near_rtol=args.near_rtol)
    if failures:
        print(f"perf_gate: {len(failures)} failure(s) vs {args.baseline}")
        for f in failures:
            print("  " + f)
        return 1
    print(f"perf_gate: OK ({args.current} vs {args.baseline})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
