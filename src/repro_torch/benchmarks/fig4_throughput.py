"""Paper Fig. 4: SpMM throughput (GFLOP/s), FP32 and FP64, LOOPS against
its baselines across the Table-2-like suite.

Port of the reference's ``benchmarks/fig4_throughput.py``.  LOOPS runs on
the port's kernels B1/B2 (``loops_spmm``, backend ``"cuda"``); on CPU
tensors the wrappers run their plain panel versions.  Baselines, each
timed on the same device and operand:

  * **taco** (``vs_taco``) -- the row-wise CSR schedule, the port's flat
    reference (``core/spmm.py::spmm_csr_baseline``), the schedule TACO
    emits for CSR SpMM and the reference's own taco-like column;
  * **dense** (``vs_dense``) -- dense cuBLAS on the densified A, fp32
    without TF32; ``None`` with its reason where A dense exceeds
    ``_util.DENSE_BUDGET_BYTES`` (such a record does not validate against
    the bench schema, which requires ``vs_dense``: only the reference's
    sizes are gated);
  * **cuSPARSE** (``vs_cusparse``, ``cusparse_us``) -- ``torch.sparse``
    CSR @ B, the paper's GPU baseline.

Every matrix's ``loops_spmm`` is checked against the flat path, each
element within ``TOL`` of its own summation bound |A|·|B|.

The panel columns (``panel_comparison``) keep the reference's structure:
grid steps (``steps_*``) at G = 1, the tuned G, the macro-fused layout and
the piped one are structural counts, equal to the reference's on the same
seeded matrices.  No CUDA kernel reads ``pipeline_depth`` (ROADMAP queue
C), so ``wall_us_piped`` times the same kernels as ``wall_us_fused``, at
the macro-fused layout; the bitwise gate between depths 1 and 2 holds
trivially and stays as the reference's contract.

``measure`` is the per-matrix cell, which ``chip_smoke.py`` also drives at
the published sizes (``published_rows``).

  PYTHONPATH=src python -m repro_torch.benchmarks.fig4_throughput \\
      --smoke --device cpu
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..core import (loops_from_csr, loops_grid_steps, loops_spmm,
                    plan_and_convert, spmm_dense_baseline, suite)
from ..core.partition import choose_r_boundary
from ..core.perf_model import calibrate
from ..kernels import engine, ref
from ._util import (bench_rng, csv_row, dense_operand, exact_fp32, gflops,
                    sparse_operand, time_fn)

N = 32  # paper fixes N=32
MATRICES = ["m6", "m8", "m9", "m10", "m12", "m13", "m14", "m16", "m17", "m19"]
SMOKE_MATRICES = ["m6", "m12", "m13"]
G_CHOICES = (4, 8)         # tuned-G candidates (G=1 is the baseline column)
WALL_MATRICES = 3          # matrices that also get the panel wall clocks
PIPE_DEPTH = 2             # piped column's structural pipeline depth
MACRO_M = 4                # piped column: same-row panels fused per panel
# Per-element bound of loops_spmm against the flat path, as a share of
# |A|·|B| (the sums run in another order).
TOL = {"fp32": 1e-5, "fp64": 1e-12}
# table2_like's block family: about 0.2 n^2 nonzeros at n rows (block
# density clamped to 0.25, 16 x 16 blocks filled to 0.8).
BLOCK_NNZ_PER_ROW_SQUARED = 0.2


def published_rows(mid: str) -> tuple[int, str | None]:
    """``(rows, cut)``: Table 2's row count, or for the block family (whose
    nonzeros grow as 0.2 n^2, about 2e9 at mip1's 100,000 rows) the row
    count that gives the published nnz, with the cut's reason."""
    e = suite.TABLE2_STATS[mid]
    if e.kind != "block":
        return e.nrow, None
    rows = int(round(math.sqrt(e.nnz / BLOCK_NNZ_PER_ROW_SQUARED)))
    return rows, (f"rows {rows} of {e.nrow}: table2_like's block family "
                  f"has ~0.2 n^2 nonzeros, so this row count gives the "
                  f"published nnz ({e.nnz})")


def calibrated_plan(csr, b, total: int = 4, deterministic: bool = False,
                    br: int | None = None):
    """Paper §3.5: fit Eq. 2 from warm-up runs of candidate splits on
    ``b``'s device (``loops_spmm`` on the kernels), then argmax (Eq. 3) ->
    boundary (Eq. 1).  Returns ``(fmt, plan)`` uploaded to that device.

    ``deterministic`` skips the calibration and plans from the
    proportional prior alone: smoke mode uses it so the recorded plan, and
    every grid-step column the perf gate diffs exactly, is a pure function
    of the seeded matrix.  A probe converts A once per distinct boundary
    and runs in A's value dtype (``b`` cast to it)."""
    dev = b.device
    if deterministic:
        return plan_and_convert(csr, total_workers=total, br=br, device=dev)
    bm = b.to(engine.torch_dtype(csr.vals.dtype))
    fmts = {}

    def measure(x, y):
        r = choose_r_boundary(csr.nrows, 1.0, 4.0, max(x, 0), max(y, 0),
                              br=8)
        if r not in fmts:
            fmts[r] = loops_from_csr(csr, r, 8)
        return 1.0 / time_fn(lambda: loops_spmm(fmts[r], bm, device=dev),
                             device=dev, repeats=2, warmup=1)

    model = calibrate(measure, total=total)
    return plan_and_convert(csr, total_workers=total, model=model, br=br,
                            device=dev)


def flat_path(csr, device):
    """The taco column: ``spmm_csr_baseline`` with A's arrays uploaded
    once, a function of ``b``."""
    rows, cols, vals = (torch.as_tensor(x).to(device)
                        for x in (csr.row_ids, csr.col_idx, csr.vals))
    return lambda b: ref.csr_spmm_ref(rows, cols, vals, b, csr.nrows)


def measure(csr, fmt, b, *, name_dt: str, repeats: int = 20,
            warmup: int = 3) -> dict:
    """One matrix: ``loops_spmm`` checked against the flat path, then
    timed beside the flat path, cuSPARSE and dense cuBLAS.  Returns the
    times (us), ratios, GFLOP/s, the error and the dense column's
    reason."""
    dev = b.device
    flat = flat_path(csr, dev)
    y = loops_spmm(fmt, b, device=dev)
    want = flat(b)
    absprod = flat_path(dataclasses.replace(csr, vals=np.abs(csr.vals)),
                        dev)(b.abs())
    err = float(((y.double() - want.double()).abs()
                 / absprod.double().clamp_min(1.0)).max()) if y.numel() \
        else 0.0
    if not (y.shape == want.shape and bool(torch.isfinite(y).all())
            and err <= TOL[name_dt]):
        raise AssertionError(f"loops_spmm against the flat path: "
                             f"{err:.3g} of |A||B| > {TOL[name_dt]:g} "
                             f"(shape {tuple(y.shape)})")
    del y, want, absprod
    t = {"loops": time_fn(lambda: loops_spmm(fmt, b, device=dev),
                          device=dev, repeats=repeats, warmup=warmup),
         "taco": time_fn(flat, b, device=dev, repeats=repeats,
                         warmup=warmup)}
    a_sp = sparse_operand(csr, dev)
    t["cusparse"] = time_fn(lambda: a_sp @ b, device=dev, repeats=repeats,
                            warmup=warmup)
    del a_sp
    a_dense, why = dense_operand(csr, dev)
    t["dense"] = None
    if a_dense is not None:
        with exact_fp32():
            t["dense"] = time_fn(spmm_dense_baseline, a_dense, b,
                                 device=dev, repeats=repeats, warmup=warmup)
        del a_dense
    tl = t["loops"]
    return {"us_per_call": tl * 1e6, "gflops": gflops(csr.nnz, N, tl),
            "taco_us": t["taco"] * 1e6, "vs_taco": t["taco"] / tl,
            "cusparse_us": t["cusparse"] * 1e6,
            "vs_cusparse": t["cusparse"] / tl,
            "dense_us": None if t["dense"] is None else t["dense"] * 1e6,
            "vs_dense": None if t["dense"] is None else t["dense"] / tl,
            "dense_note": why, "max_err_of_absprod": err}


def panel_comparison(csr, plan, b, *, mid: str, name_dt: str, out,
                     record=None, wall_clock: bool, smoke: bool):
    """G=1 against tuned G against the macro-fused and piped layouts: the
    grid-step cost proxy for every matrix, plus the kernels' wall clock on
    a subset (see the module docstring).  Correctness gates: depth 2 at
    the tuned conversion bitwise equal to depth 1; the macro-fused results
    within tolerance of it.  Returns the G=8 step reduction."""
    dev = b.device
    fmts = {g: loops_from_csr(csr, plan.r_boundary, plan.br, panel_g=g)
            for g in (1,) + tuple(G_CHOICES)}
    steps = {g: loops_grid_steps(f, N) for g, f in fmts.items()}
    tuned_g = min(G_CHOICES, key=lambda g: steps[g])
    g_ref = max(G_CHOICES)   # the reduction the acceptance tracking pins
    red_tuned = steps[1] / max(steps[tuned_g], 1)
    red_ref = steps[1] / max(steps[g_ref], 1)

    fmt_fused = loops_from_csr(csr, plan.r_boundary, plan.br,
                               panel_g=tuned_g, macro_m=MACRO_M)
    fmt_piped = loops_from_csr(csr, plan.r_boundary, plan.br,
                               panel_g=tuned_g, macro_m=MACRO_M,
                               pipeline_depth=PIPE_DEPTH)
    steps_fused = loops_grid_steps(fmt_fused, N)
    steps_piped = loops_grid_steps(fmt_piped, N)

    wall = {}
    if wall_clock:
        repeats, warmup = (2, 1) if smoke else (3, 1)
        for key, fmt_k in ((1, fmts[1]), (tuned_g, fmts[tuned_g]),
                           ("fused", fmt_fused), ("piped", fmt_piped)):
            wall[key] = time_fn(lambda: loops_spmm(fmt_k, b, device=dev),
                                device=dev,
                                repeats=repeats, warmup=warmup)
        fmt_d2 = loops_from_csr(csr, plan.r_boundary, plan.br,
                                panel_g=tuned_g, pipeline_depth=PIPE_DEPTH)
        y_base = loops_spmm(fmts[tuned_g], b, device=dev)
        if not torch.equal(loops_spmm(fmt_d2, b, device=dev), y_base):
            raise AssertionError(f"{mid}: depth {PIPE_DEPTH} differs from "
                                 "depth 1 at one conversion")
        tol = 1e-10 if name_dt == "fp64" else 1e-4
        for fmt_k in (fmt_fused, fmt_piped):
            torch.testing.assert_close(loops_spmm(fmt_k, b, device=dev),
                                       y_base, rtol=tol, atol=tol)

    wall_note = (f";wall_g1_us={wall[1] * 1e6:.1f}"
                 f";wall_tuned_us={wall[tuned_g] * 1e6:.1f}"
                 f";wall_fused_us={wall['fused'] * 1e6:.1f}"
                 f";wall_piped_us={wall['piped'] * 1e6:.1f}"
                 f";wall_speedup={wall[1] / wall[tuned_g]:.2f}x"
                 f";wall_speedup_fused="
                 f"{wall[tuned_g] / wall['fused']:.2f}x"
                 if wall else "")
    out(csv_row(f"fig4_{name_dt}_{mid}_panelG", steps[tuned_g],
                f"panel_g={tuned_g};steps_g1={steps[1]};"
                f"steps_tuned={steps[tuned_g]};steps_fused={steps_fused};"
                f"steps_piped={steps_piped};"
                f"pipeline_depth={PIPE_DEPTH};macro_m={MACRO_M};"
                f"step_reduction="
                f"{red_tuned:.2f}x;step_reduction_g{g_ref}={red_ref:.2f}x"
                + wall_note))
    if record is not None:
        record({
            "suite": "fig4_panel", "matrix": mid, "dtype": name_dt,
            "panel_g": tuned_g,
            "pipeline_depth": PIPE_DEPTH, "macro_m": MACRO_M,
            "steps_g1": steps[1], f"steps_g{g_ref}": steps[g_ref],
            "steps_tuned": steps[tuned_g],
            "steps_fused": steps_fused,
            "steps_piped": steps_piped,
            "step_reduction_tuned": red_tuned,
            f"step_reduction_g{g_ref}": red_ref,
            "step_reduction_piped": steps[1] / max(steps_piped, 1),
            "wall_us_g1": wall.get(1, 0.0) * 1e6,
            "wall_us_tuned": wall.get(tuned_g, 0.0) * 1e6,
            "wall_us_fused": wall.get("fused", 0.0) * 1e6,
            "wall_us_piped": wall.get("piped", 0.0) * 1e6,
        })
    return red_ref


def run(dtype=np.float32, scale_rows: int = 1024, out=print, record=None,
        smoke: bool = False, recorder=None, device=None):
    """The reference's sweep at ``scale_rows`` rows, one dtype."""
    name_dt = {np.float32: "fp32", np.float64: "fp64"}[dtype]
    dev = engine.resolve_device(device)
    rng = bench_rng()
    matrices = SMOKE_MATRICES if smoke else MATRICES
    rows, g8_reds = [], []
    for i, mid in enumerate(matrices):
        csr = suite.table2_like(mid, scale_rows=scale_rows, seed=3,
                                dtype=dtype)
        b = torch.as_tensor(rng.standard_normal((csr.shape[1], N))
                            .astype(dtype)).to(dev)
        t0 = time.perf_counter()
        fmt, plan = calibrated_plan(csr, b, deterministic=smoke)
        plan_s = time.perf_counter() - t0
        res = measure(csr, fmt, b, name_dt=name_dt)
        vs_dense = res["vs_dense"]
        out(csv_row(f"fig4_{name_dt}_{mid}_{suite.TABLE2_STATS[mid].name}",
                    res["us_per_call"],
                    f"GFLOPS={res['gflops']:.2f};"
                    f"vs_taco={res['vs_taco']:.2f}x;"
                    f"vs_dense={_ratio(vs_dense)};"
                    f"vs_cusparse={res['vs_cusparse']:.2f}x;"
                    f"plan_s={plan_s:.2f}"))
        rows.append((res["vs_taco"], vs_dense, res["vs_cusparse"]))
        if record is not None:
            record({"suite": "fig4", "matrix": mid, "dtype": name_dt,
                    "panel_g": plan.panel_g, "nnz": csr.nnz,
                    "pipeline_depth": plan.pipeline_depth,
                    "macro_m": plan.macro_m,
                    **{k: res[k] for k in ("us_per_call", "gflops",
                                           "vs_taco", "vs_dense",
                                           "vs_cusparse", "cusparse_us")}})
        if recorder is not None:
            recorder.record_spmm(csr, plan, wall_s=res["us_per_call"] / 1e6,
                                 n_cols=N, backend="cuda",
                                 gflops=res["gflops"])
        g8_reds.append(panel_comparison(
            csr, plan, b, mid=mid, name_dt=name_dt, out=out,
            record=record, wall_clock=(i < WALL_MATRICES), smoke=smoke))
    g_ref = max(G_CHOICES)
    ref_geo = geomean(g8_reds)
    out(csv_row(f"fig4_{name_dt}_geomean", 0.0,
                f"speedup_vs_taco={geomean(r[0] for r in rows):.2f}x;"
                f"speedup_vs_dense={geomean(r[1] for r in rows):.2f}x;"
                f"speedup_vs_cusparse={geomean(r[2] for r in rows):.2f}x;"
                f"step_reduction_g{g_ref}={ref_geo:.2f}x"))
    if record is not None:
        record({"suite": "fig4_panel_geomean", "matrix": "geomean",
                "dtype": name_dt, f"step_reduction_g{g_ref}": ref_geo})


def _ratio(x) -> str:
    return "n/a" if x is None else f"{x:.2f}x"


def geomean(xs) -> float:
    """Geometric mean of the values that are not None (nan if none)."""
    v = np.asarray([x for x in xs if x is not None], np.float64)
    return float(np.exp(np.log(np.maximum(v, 1e-9)).mean())) if v.size \
        else float("nan")


def main(out=print, record=None, smoke: bool = False, recorder=None,
         device=None):
    scale = 192 if smoke else 1024
    run(np.float32, scale_rows=scale, out=out, record=record, smoke=smoke,
        recorder=recorder, device=device)
    if not smoke:
        run(np.float64, out=out, record=record, recorder=recorder,
            device=device)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    main(smoke=args.smoke, device=args.device)
