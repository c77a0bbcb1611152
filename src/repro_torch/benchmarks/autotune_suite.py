"""Autotune suite: model-only planning against measured, cached plans.

Port of the reference's ``benchmarks/autotune_suite.py``, on
``repro_torch.tune``.  For each Table-2-like matrix, plan twice:

  * **model-only** -- ``plan_and_convert`` as every call site did before
    the tuner existed (``total_workers=8``, proportional split, Eq. 1
    boundary);
  * **tuned** -- ``repro_torch.tune.autotune`` (a budgeted search measured
    on the device's kernels on first sight, the fingerprint-keyed cache
    thereafter),

then time ``loops_spmm`` at both plans on the device and report their
throughputs side by side.  A second pass over the same matrices shows the
amortisation: every lookup hits, nothing is measured, and the hit rate is
printed and recorded (the schema's ``autotune_cache_record``).

The cache lives in a temporary directory removed at the end, unless
``$REPRO_TUNE_CACHE`` names one to keep plans across runs.

  PYTHONPATH=src python -m repro_torch.benchmarks.autotune_suite \\
      --device cpu
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

from ..core import loops_spmm, plan_and_convert, suite
from ..kernels import engine
from ..tune import PlanCache, SearchBudget, autotune
from ._util import csv_row, gflops, time_fn
from .fig4_throughput import geomean

N = 32  # paper fixes N=32
MATRICES = ["m6", "m9", "m10", "m12", "m13", "m16", "m17"]


def _throughput(fmt, b, nnz: int) -> float:
    dev = b.device
    return gflops(nnz, N, time_fn(lambda: loops_spmm(fmt, b, device=dev),
                                  device=dev, repeats=5, warmup=1))


def main(out=print, scale_rows: int = 512, record=None,
         device=None) -> dict:
    dev = engine.resolve_device(device)
    with contextlib.ExitStack() as stack:
        cache_dir = os.environ.get("REPRO_TUNE_CACHE") or \
            stack.enter_context(tempfile.TemporaryDirectory(
                prefix="repro-tune-bench-"))
        return _run(PlanCache(cache_dir), scale_rows, out, record, dev)


def _run(cache, scale_rows, out, record, dev) -> dict:
    budget = SearchBudget(top_k=4, repeats=3, warmup=1)
    rng = np.random.default_rng(0)

    mats = {mid: suite.table2_like(mid, scale_rows=scale_rows, seed=3)
            for mid in MATRICES}
    speedups, plans = [], {}
    for mid, csr in mats.items():
        b = torch.as_tensor(rng.standard_normal((csr.shape[1], N))
                            .astype(np.float32)).to(dev)
        fmt_model, plan_model = plan_and_convert(csr, total_workers=8,
                                                 device=dev)
        fmt_tuned, plan_tuned = autotune(csr, n_cols=N, cache=cache,
                                         budget=budget, device=dev)
        g_model = _throughput(fmt_model, b, csr.nnz)
        g_tuned = _throughput(fmt_tuned, b, csr.nnz)
        speedups.append(g_tuned / g_model)
        plans[mid] = {"model": plan_model, "tuned": plan_tuned,
                      "gflops_model": g_model, "gflops_tuned": g_tuned}
        out(csv_row(
            f"autotune_{mid}_{suite.TABLE2_STATS[mid].name}", 0.0,
            f"GFLOPS_model={g_model:.2f};GFLOPS_tuned={g_tuned:.2f};"
            f"speedup={g_tuned / g_model:.2f}x;"
            f"plan_model=r{plan_model.r_boundary}b{plan_model.br};"
            f"plan_tuned=r{plan_tuned.r_boundary}b{plan_tuned.br}"))

    # Second pass: the amortisation claim -- all hits, no measurement.
    before = cache.stats.misses
    for csr in mats.values():
        autotune(csr, n_cols=N, cache=cache, budget=budget, device=dev)
    if cache.stats.misses != before:
        raise AssertionError("the second pass must not search")
    geo = geomean(speedups)
    out(csv_row("autotune_geomean", 0.0, f"tuned_vs_model={geo:.2f}x"))
    out(csv_row("autotune_cache", 0.0,
                f"hits={cache.stats.hits};near={cache.stats.near_hits};"
                f"misses={cache.stats.misses};"
                f"hit_rate={cache.stats.hit_rate:.2f};"
                f"stored={len(cache)}"))
    rec = {"suite": "autotune", "matrix": "cache",
           "hits": cache.stats.hits, "near_hits": cache.stats.near_hits,
           "misses": cache.stats.misses,
           "hit_rate": round(cache.stats.hit_rate, 4),
           "stored": len(cache),
           "tuned_vs_model_geomean": round(geo, 4)}
    if record is not None:
        record(rec)
    return {"cache": rec, "plans": plans}


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    main(device=args.device)
