"""The port's perf gate (``repro_torch.benchmarks.perf_gate``) on its
committed smoke baseline, mirroring ``tests/test_perf_gate.py``: it passes
on the baseline, provably fails on injected regressions, and keeps the
reference's tolerance classes.  The baseline's exact columns (grid steps,
``panel_g``, ``nnz``, ``pipeline_depth``, ``macro_m``) equal the
reference's for fig4's smoke matrices and the batched suite, computed
structurally from the reference's own plans; and a live smoke run of the
port on the CPU passes the gate against the baseline."""
import copy
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.benchmarks import perf_gate, run

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import perf_gate as ref_gate  # noqa: E402

BASELINE = run.DEFAULT_BASELINE
INF = float("inf")


def _baseline():
    return json.loads(BASELINE.read_text())


def _by_key(recs):
    return {perf_gate.record_key(r): r for r in recs}


def test_baseline_is_committed_and_nonempty():
    assert BASELINE == (ROOT / "src" / "repro_torch" / "benchmarks"
                        / "baselines" / "BENCH_019.json")
    recs = _baseline()
    assert recs, "BENCH_019.json must hold the smoke-suite records"
    suites = {r.get("suite") for r in recs}
    assert "fig4_panel" in suites and "batched" in suites


def test_gate_passes_on_itself():
    assert perf_gate.run_gate(BASELINE, BASELINE, wall_tol=1.5) == []
    assert perf_gate.diff_records(_baseline(), _baseline()) == []


def test_gate_fails_on_injected_grid_step_regression():
    base = [{"suite": "batched", "batch": 4, "n_cols": 32, "panel_g": 8,
             "grid_steps_loop": 160, "grid_steps_native": 40,
             "step_reduction_vs_loop": 4.0, "fwd_us_loop": 100.0,
             "fwd_us_vmap": 80.0, "fwd_us_native": 60.0,
             "fwdbwd_us_loop": 300.0, "fwdbwd_us_vmap": 200.0,
             "fwdbwd_us_native": 150.0}]
    cur = copy.deepcopy(base)
    cur[0]["grid_steps_native"] *= 2
    fails = perf_gate.diff_records(base, cur)
    assert fails and "grid_steps_native" in fails[0]
    cur2 = copy.deepcopy(base)
    cur2[0]["grid_steps_native"] //= 2
    assert perf_gate.diff_records(base, cur2)


def test_gate_fails_on_committed_baseline_regression():
    cur = _baseline()
    victim = next(r for r in cur if r.get("suite") == "fig4_panel")
    victim["steps_tuned"] *= 2
    fails = perf_gate.diff_records(_baseline(), cur, wall_tol=INF)
    assert any("steps_tuned" in f for f in fails)


def test_gate_fails_on_dropped_record_and_column():
    base = _baseline()
    cur = [r for r in base if r.get("suite") != "batched"]
    assert any("missing" in f for f in perf_gate.diff_records(base, cur))
    cur2 = copy.deepcopy(base)
    rec = next(r for r in cur2 if r.get("suite") == "batched")
    del rec["grid_steps_native"]
    assert any("dropped" in f for f in perf_gate.diff_records(base, cur2))


def test_wall_band_tolerance():
    base = [{"suite": "fig4", "matrix": "m6", "dtype": "fp32", "panel_g": 8,
             "nnz": 100, "us_per_call": 100.0, "gflops": 2.0,
             "vs_taco": 1.5, "vs_dense": 0.5, "vs_cusparse": 1.0}]
    cur = copy.deepcopy(base)
    cur[0]["us_per_call"] = 500.0    # 5x slower: inside the 10x band
    cur[0]["gflops"] = 0.4
    assert perf_gate.diff_records(base, cur, wall_tol=10.0) == []
    cur[0]["us_per_call"] = 2000.0   # 20x slower: outside
    assert perf_gate.diff_records(base, cur, wall_tol=10.0)
    cur[0]["us_per_call"] = 100.0
    cur[0]["vs_cusparse"] = 0.05     # the new column is higher-better
    assert any("vs_cusparse" in f
               for f in perf_gate.diff_records(base, cur, wall_tol=10.0))
    assert perf_gate.diff_records(base, cur, wall_tol=INF) == []


def test_near_class_catches_ratio_drift():
    base = [{"suite": "fig4_panel_geomean", "matrix": "geomean",
             "dtype": "fp32", "step_reduction_g8": 7.21}]
    cur = copy.deepcopy(base)
    cur[0]["step_reduction_g8"] = 6.5
    assert perf_gate.diff_records(base, cur)
    assert perf_gate.diff_records(base, base) == []


def test_skip_records_are_exempt():
    base = [{"suite": "spmm_dryrun", "skipped": True, "reason": "no mesh"}]
    assert perf_gate.diff_records(base, []) == []


def test_schema_validation_is_part_of_the_gate(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"suite": "fig4", "matrix": "m6"}]))
    fails = perf_gate.run_gate(BASELINE, bad, wall_tol=INF)
    assert any("schema violation" in f for f in fails)


@pytest.mark.parametrize("field", [
    "suite", "batch", "steps_g1", "steps_piped", "grid_steps_native",
    "panel_g", "nnz", "pipeline_depth", "macro_m", "step_reduction_g8",
    "us_per_call", "gflops", "vs_cusparse", "cusparse_us", "hits"])
def test_tolerance_classes_equal_reference(field):
    assert perf_gate.classify(field) == ref_gate.classify(field)
    assert perf_gate._higher_better(field) == ref_gate._higher_better(field)


def test_diffs_equal_reference_on_committed_baseline():
    """The same synthetic regressions give the reference gate's failure
    lists."""
    base = _baseline()
    cur = copy.deepcopy(base)
    next(r for r in cur if r["suite"] == "batched")["grid_steps_piped"] += 3
    next(r for r in cur if r["suite"] == "fig4_panel")[
        "step_reduction_tuned"] *= 1.01
    next(r for r in cur if r["suite"] == "fig4")["gflops"] /= 100
    for tol in (10.0, INF):
        assert perf_gate.diff_records(base, cur, wall_tol=tol) == \
            ref_gate.diff_records(base, cur, wall_tol=tol)


def test_cli_exit_codes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.benchmarks.perf_gate",
           "--baseline", str(BASELINE), "--wall-tol", "inf"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    ok = subprocess.run(cmd + ["--current", str(BASELINE)],
                        capture_output=True, text=True, env=env)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    cur = _baseline()
    next(r for r in cur if r.get("suite") == "batched")[
        "grid_steps_native"] += 1
    bad_path = tmp_path / "bench.json"
    bad_path.write_text(json.dumps(cur))
    bad = subprocess.run(cmd + ["--current", str(bad_path)],
                         capture_output=True, text=True, env=env)
    assert bad.returncode == 1
    assert "grid_steps_native" in bad.stdout


# -- the exact columns against the reference's --------------------------

@pytest.mark.parametrize("mid", ["m6", "m12", "m13"])
def test_fig4_exact_columns_equal_reference(mid):
    """fig4's smoke records (matrix at 192 rows, seed 3, deterministic
    plan) hold the reference's exact columns: the plan's and the panel
    comparison's, computed by the reference's own functions."""
    import jax.numpy as jnp
    from benchmarks import fig4_throughput as rf4
    from repro.core import suite as rsuite
    from repro_torch.benchmarks import fig4_throughput as tf4

    assert (tf4.SMOKE_MATRICES, tf4.G_CHOICES, tf4.MACRO_M, tf4.PIPE_DEPTH,
            tf4.N) == (rf4.SMOKE_MATRICES, rf4.G_CHOICES, rf4.MACRO_M,
                       rf4.PIPE_DEPTH, rf4.N)
    csr = rsuite.table2_like(mid, scale_rows=192, seed=3, dtype=np.float32)
    b = jnp.zeros((csr.shape[1], rf4.N), jnp.float32)
    _, plan = rf4.calibrated_plan(csr, b, deterministic=True)
    recs = []
    rf4.panel_comparison(csr, plan, b, mid=mid, name_dt="fp32",
                         out=lambda line: None, record=recs.append,
                         wall_clock=False, smoke=True)
    recs.append({"suite": "fig4", "matrix": mid, "dtype": "fp32",
                 "panel_g": plan.panel_g, "nnz": csr.nnz,
                 "pipeline_depth": plan.pipeline_depth,
                 "macro_m": plan.macro_m})
    got = _by_key(_baseline())
    for want in recs:
        have = got[perf_gate.record_key(want)]
        for field, v in want.items():
            if perf_gate.classify(field) in ("exact", "near"):
                assert have[field] == pytest.approx(v, rel=1e-12), field


def test_batched_exact_columns_equal_reference():
    """The batched smoke record's grid steps and plan columns equal the
    reference's on the same seeded matrix (its plans, its counts)."""
    from repro.core import csr_from_dense, plan_and_convert
    from repro.core.spmm import loops_batched_grid_steps, loops_grid_steps
    from repro_torch.benchmarks import batched_spmm as tb
    from repro_torch.benchmarks._util import bench_rng

    assert tb.SMOKE_BATCHES == [4] and tb.N == 32
    rng = bench_rng()
    scale, density = 96, 0.08
    a = ((rng.random((scale, scale // 2)) < density)
         * rng.standard_normal((scale, scale // 2))).astype(np.float32)
    csr = csr_from_dense(a)
    fmt, plan = plan_and_convert(csr, total_workers=8)
    fmt_p, plan_p = plan_and_convert(csr, total_workers=8, pipeline_depth=2,
                                     macro_m=4)
    batch = 4
    want = {"suite": "batched", "batch": batch, "n_cols": 32,
            "panel_g": plan.panel_g,
            "pipeline_depth": plan_p.pipeline_depth,
            "macro_m": plan_p.macro_m,
            "grid_steps_loop": batch * loops_grid_steps(fmt, 32),
            "grid_steps_native": loops_batched_grid_steps(fmt, batch, 32),
            "grid_steps_piped": loops_batched_grid_steps(fmt_p, batch, 32)}
    have = _by_key(_baseline())[perf_gate.record_key(want)]
    assert {k: have[k] for k in want} == want


# -- a live smoke run ---------------------------------------------------

def test_live_smoke_run_passes_the_gate(tmp_path):
    """``run --smoke --device cpu`` (fig4 and batched) writes records that
    validate and equal the baseline's exact columns."""
    out = tmp_path / "bench"
    assert run.main(["--smoke", "--device", "cpu", "--only", "fig4,batched",
                     "--out", str(out)]) == 0
    mine = [r for r in _baseline()
            if r["suite"].startswith(("fig4", "batched"))]
    subset = tmp_path / "baseline.json"
    subset.write_text(json.dumps(mine))
    assert perf_gate.run_gate(subset, out / "bench.json", wall_tol=INF) == []
    assert (out / "bench.csv").read_text().startswith(
        "name,us_per_call,derived\n")


@pytest.mark.parametrize("name", ["compress_bytes", "roofline",
                                  "spmm_dryrun"])
def test_unported_suite_raises_and_writes_no_record(tmp_path, capsys,
                                                    monkeypatch, name):
    """The three suites this test once held to raising (unported) are
    ported: each runs from the runner by name on the CPU (the dry-run
    suites at their smoke size, records in a scratch directory), writes
    its CSV rows and no bench.json record, and none is left in
    ``UNPORTED`` or in the default set."""
    from repro_torch.benchmarks import roofline, spmm_dryrun
    monkeypatch.setattr(roofline, "RESULTS_DIR", tmp_path / "dryrun")
    monkeypatch.setattr(spmm_dryrun, "RESULTS_DIR", tmp_path / "dryrun")
    assert not run.UNPORTED and name in run.DRYRUN_SUITES
    assert name not in run.SUITE_NAMES
    out = tmp_path / "bench"
    assert run.main(["--only", name, "--smoke", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert json.loads((out / "bench.json").read_text()) == []
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(("compress_psum", "roofline", "spmm_dryrun"))]
    assert rows and not any("FAILED" in ln for ln in rows)
