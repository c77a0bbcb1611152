"""Benchmark orchestrator of the port: one function per paper table or
figure.

Port of the reference's ``benchmarks/run.py``.  Prints
``name,us_per_call,derived`` CSV rows (and mirrors them to
``<out>/bench.csv``).  Suites that emit structured records (fig4's
throughput and panel columns, the batched suite, the autotune cache, the
serving load) also land in ``<out>/bench.json``, validated against the
port's copy of the bench schema and diffed against a committed baseline
by :mod:`repro_torch.benchmarks.perf_gate`.  ``<out>`` defaults to
``build/bench/`` under the working directory (git-ignored at the
repository root).

  fig4   -- FP32/FP64 SpMM throughput against the flat row-wise path
            (taco-like), dense cuBLAS and cuSPARSE (Fig. 4), plus the
            G=1 against tuned-G panel columns
  fig5   -- bf16 SpMM against block-only / csr-only strategies (Fig. 5)
  sec43  -- adaptive scheduling ablation (§4.3)
  table3 -- energy efficiency (GFLOP/s per W) of LOOPS and cuSPARSE,
            measured with NVML's energy counter on the card (Table 3);
            CSV rows only, no bench.json records
  table4 -- end-to-end GCN training (§4.5 / Table 4)
  autotune -- model-only against measured/cached plans + cache hit rates
  batched  -- per-element loop against unrolled stack against native
              batching and ``torch.vmap`` (fwd and fwd+bwd, grid steps)
  serve_traffic -- closed-loop serving load through the continuous-
              batching queue: p50/p99 latency and goodput, batched
              against no batching

  roofline -- the three-term roofline of every dry-run record
            (``launch/dryrun.py``) against an H100's published peaks
  spmm_dryrun -- the distributed LOOPS SpMM on the 16 x 16 production
            mesh at in-2004's size, two ranks traced on fake tensors
  compress_bytes -- collective bytes of an fp32 all-reduce against
            ``compressed_psum`` (bf16, int8) on a 16-rank axis
  reanalyze -- recount the dry-run's kept traces in place

Every suite runs on ``--device`` (default ``cuda``; without a GPU it
raises: ``--device cpu`` runs the kernels' plain versions).  The four
dry-run suites (:data:`DRYRUN_SUITES`) run only when named with
``--only``: they read or write ``build/dryrun/`` and trace at production
scale, and write CSV rows but no bench.json record.  No suite of the
reference is left unported (:data:`UNPORTED` is empty).

``--smoke`` shrinks the suites that support it.  In smoke mode fig4 plans
deterministically (no calibration), so the grid-step columns are a pure
function of the seeded matrices, equal on the CPU, on the card and in the
reference: what the gate's exact checks rely on.  ``--baseline [F]`` runs
the gate against F after the suites finish (non-zero exit on a
regression); ``--update-baseline`` copies the merged bench.json over F
instead.  ``--trace`` records a perf trace (engine dispatches and the
per-matrix SpMM times) to ``<out>/traces/``; ``--obs-trace`` captures the
run with ``repro_torch.obs`` (a span per suite, dispatch counters) to
``<out>/obs/``.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.perf_gate \\
      --baseline src/repro_torch/benchmarks/baselines/BENCH_019.json \\
      --wall-tol inf
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import pathlib
import shutil
import sys
import traceback

HERE = pathlib.Path(__file__).resolve().parent
DEFAULT_BASELINE = HERE / "baselines" / "BENCH_019.json"
DEFAULT_OUT = pathlib.Path("build") / "bench"

SUITE_NAMES = ["fig4", "fig5", "sec43", "table3", "table4", "autotune",
               "batched", "serve_traffic"]
# Registered, run only when named (module docstring).
DRYRUN_SUITES = ["roofline", "spmm_dryrun", "compress_bytes", "reanalyze"]
# The reference's suites still to be ported (none), with the ROADMAP item.
UNPORTED: dict = {}


def _suite_registry():
    from . import (autotune_suite, batched_spmm, compress_bytes,
                   fig4_throughput, fig5_halfprec, reanalyze, roofline,
                   sec43_scheduling, serve_traffic, spmm_dryrun,
                   table3_energy, table4_gnn)
    suites = {
        "fig4": fig4_throughput.main,
        "fig5": fig5_halfprec.main,
        "sec43": sec43_scheduling.main,
        "table3": table3_energy.main,
        "table4": table4_gnn.main,
        "autotune": autotune_suite.main,
        "batched": batched_spmm.main,
        "serve_traffic": serve_traffic.main,
        "roofline": roofline.main,
        "spmm_dryrun": spmm_dryrun.bench_main,
        "compress_bytes": compress_bytes.main,
        "reanalyze": reanalyze.main,
    }
    return suites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of suites (default: "
                         + ",".join(SUITE_NAMES) + "; also "
                         + ",".join(DRYRUN_SUITES) + ")")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny suites (those that support it)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT,
                    help=f"results directory (default {DEFAULT_OUT})")
    ap.add_argument("--trace", action="store_true",
                    help="record a perf trace to <out>/traces/")
    ap.add_argument("--obs-trace", action="store_true",
                    help="capture the run with repro_torch.obs to "
                         "<out>/obs/")
    ap.add_argument("--baseline", nargs="?", const=str(DEFAULT_BASELINE),
                    default=None, metavar="F",
                    help="after the run, gate the merged bench.json against "
                         f"this baseline (default {DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="copy the merged bench.json over the baseline file "
                         "instead of gating against it")
    args = ap.parse_args(argv)

    suites = _suite_registry()
    chosen = args.only.split(",") if args.only else list(SUITE_NAMES)
    unknown = [n for n in chosen if n not in suites]
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; choose from "
                 + ",".join(SUITE_NAMES + DRYRUN_SUITES))

    args.out.mkdir(parents=True, exist_ok=True)
    rows: list[str] = []
    records: list[dict] = []
    source = "bench-" + "-".join(chosen)
    recorder = obs = None
    if args.trace:
        from ..perf.trace import TraceRecorder
        recorder = TraceRecorder(source=source)
    if args.obs_trace:
        from ..obs import Obs, set_active
        obs = Obs(source=source)
        set_active(obs)

    def emit(line: str):
        print(line, flush=True)
        rows.append(line)

    emit("name,us_per_call,derived")
    failures = 0
    for name in chosen:
        fn = suites[name]
        params = inspect.signature(fn).parameters
        kwargs = {k: v for k, v in (("smoke", args.smoke),
                                    ("record", records.append),
                                    ("recorder", recorder),
                                    ("device", args.device))
                  if k in params}
        try:
            with contextlib.ExitStack() as stack:
                if recorder is not None:
                    stack.enter_context(recorder.attach_engine())
                if obs is not None:
                    # obs chains onto the recorder's tracer, so --trace and
                    # --obs-trace compose (both see every dispatch)
                    stack.enter_context(obs.attach_engine())
                    stack.enter_context(obs.span(f"suite.{name}",
                                                 cat="bench"))
                fn(out=emit, **kwargs)
        except Exception:   # noqa: BLE001 - a failed suite is reported
            failures += 1
            emit(f"{name}_FAILED,0,{traceback.format_exc(limit=1).strip()}")
    (args.out / "bench.csv").write_text("\n".join(rows) + "\n")
    # bench.json merges per suite: records of the suites run now replace
    # theirs (no stale numbers), records of other suites survive.
    json_path = args.out / "bench.json"
    try:
        kept = [r for r in json.loads(json_path.read_text())
                if not any(str(r.get("suite", "")).startswith(name)
                           for name in chosen)]
    except (OSError, ValueError):
        kept = []
    json_path.write_text(json.dumps(kept + records, indent=1,
                                    sort_keys=True))
    if recorder is not None and recorder.records:
        trace = recorder.save(args.out / "traces" / f"{source}.jsonl")
        print(f"trace: {trace}", flush=True)
    if obs is not None:
        from ..obs import set_active
        jsonl, chrome = obs.save(args.out / "obs")
        print(f"obs: {jsonl}", flush=True)
        print(f"obs: {chrome}", flush=True)
        set_active(None)
    if failures:
        return 1
    if args.update_baseline:
        target = pathlib.Path(args.baseline or DEFAULT_BASELINE)
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(json_path, target)
        print(f"baseline updated: {target}", flush=True)
    elif args.baseline:
        from . import perf_gate
        return perf_gate.main(["--baseline", args.baseline,
                               "--current", str(json_path)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
