"""The port's trace → fit → replay loop (``repro_torch.perf``) against the
reference's (``repro.perf``) on the CPU.

* ``predict_part_steps`` equals the reference's and the port's own
  conversion (``loops_grid_steps``), part by part, and
  ``part_step_counter`` (the memoised form the search ranks with) equals
  both.
* ``fit_cost_model`` gives the reference's coefficients to 1e-9 on the
  same records; ``TraceDB.step_cost`` and ``replay`` give its numbers.
* Trace files written by the port read with the reference's
  ``load_traces`` and back; ``matrix_key`` is equal.
* ``search`` with a ``trace_db`` and a ``recorder`` ranks and records as
  the reference does, and the engine's dispatch records carry the
  reference's fields.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import spmm as rspmm
from repro.core import suite as rsuite
from repro.perf import trace as rtrace
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.kernels import engine
from repro_torch.perf import trace as ttrace

# The packages re-export functions named like these modules.
rreplay = importlib.import_module("repro.perf.replay")
treplay = importlib.import_module("repro_torch.perf.replay")
rsearch = importlib.import_module("repro.tune.search")
tsearch = importlib.import_module("repro_torch.tune.search")

MIDS = ["m4", "m6", "m8", "m12", "m13"]
PLANS = [(0.0, 8, 1, 1, 1), (1.0, 4, 8, 1, 1), (0.25, 8, 4, 1, 2),
         (0.5, 4, 1, 4, 1), (0.75, 8, 8, 4, 2), (0.4, 16, 4, 1, 1),
         (0.3, 8, 4, 1, 1), (0.6, 4, 8, 4, 1)]


def pair(mid, rows=256, seed=1):
    return (rsuite.table2_like(mid, scale_rows=rows, seed=seed),
            tsuite.table2_like(mid, scale_rows=rows, seed=seed))


def plans_for(nrows):
    """One plan per ``PLANS`` row; the last two boundaries are no multiple
    of their Br."""
    out = []
    for i, (r_frac, br, g, m, d) in enumerate(PLANS):
        r_b = nrows if r_frac == 1.0 else int(r_frac * nrows) // br * br
        if i >= len(PLANS) - 2:
            r_b += 3
        out.append(tspmm.SpmmPlan(r_boundary=r_b, t_vpu=4, t_mxu=4, br=br,
                                  panel_g=g, macro_m=m, pipeline_depth=d))
    return out


def ref_plan(p):
    return rspmm.SpmmPlan(**dataclasses.asdict(p))


@pytest.mark.parametrize("n_cols", [8, 600])
@pytest.mark.parametrize("mid", MIDS)
def test_predict_part_steps_equal_reference_and_conversion(mid, n_cols):
    cr, cp = pair(mid)
    counter = treplay.part_step_counter(cp, n_cols)
    for p in plans_for(cp.nrows):
        want = rreplay.predict_part_steps(cr, ref_plan(p), n_cols)
        assert treplay.predict_part_steps(cp, p, n_cols) == want
        assert counter(p) == want
        fmt = tf.loops_from_csr(cp, p.r_boundary, p.br, panel_g=p.panel_g,
                                macro_m=p.macro_m,
                                pipeline_depth=p.pipeline_depth)
        assert sum(want) == tspmm.loops_grid_steps(fmt, n_cols)
        assert treplay.predict_grid_steps(cp, p, n_cols) == \
            rreplay.predict_grid_steps(cr, ref_plan(p), n_cols)


def test_predict_part_steps_with_zero_values_and_empty_rows(rng):
    a = ((rng.random((40, 30)) < 0.2) * rng.standard_normal((40, 30)))
    a[5:20] = 0.0
    rows, cols = np.nonzero(a)
    vals = a[rows, cols].astype(np.float32)
    vals[::3] = 0.0          # stored zeros: dropped from BCSR tiles
    cr = rf.csr_from_coo(rows, cols, vals, a.shape)
    cp = tf.csr_from_coo(rows, cols, vals, a.shape)
    for p in plans_for(40):
        assert treplay.predict_part_steps(cp, p, 16) == \
            rreplay.predict_part_steps(cr, ref_plan(p), 16)


def _synth(x, y, g, gflops, **kw):
    return {"schema": 1, "kind": "spmm", "source": "synth", "t_vpu": x,
            "t_mxu": y, "panel_g": g, "gflops": gflops, **kw}


@pytest.mark.parametrize("with_g", [False, True])
def test_fit_cost_model_coefficients_equal_reference(with_g):
    def perf(x, y, g):
        return 10.0 + 2.0 * x + 3.0 * y - 0.05 * x * x - 0.04 * y * y \
            + (0.3 * g - 0.02 * g * g if with_g else 0.0)
    gs = (1, 4, 8) if with_g else (1,)
    recs = [_synth(x, y, g, perf(x, y, g)) for x in (1, 2, 4, 6, 8)
            for y in (1, 3, 5) for g in gs]
    for ridge in (1e-9, 1e-3):
        want = rtrace.fit_cost_model(recs, ridge=ridge)
        got = ttrace.fit_cost_model(recs, ridge=ridge)
        np.testing.assert_allclose(np.asarray(got.coef),
                                   np.asarray(want.coef), rtol=1e-9,
                                   atol=1e-9)
        assert got.calibrated_from == want.calibrated_from
    assert ttrace.fit_cost_model(recs[:2]) is None
    assert ttrace.fit_cost_model([]) is None


def _cells():
    recs = []
    for s_csr, s_bcsr, g, d in [(10, 0, 1, 1), (0, 20, 4, 1), (15, 30, 8, 2),
                                (40, 5, 1, 2), (7, 70, 4, 1), (22, 11, 8, 1),
                                (3, 90, 1, 2), (60, 60, 4, 2)]:
        recs.append({"schema": 1, "kind": "search_trial", "source": "s",
                     "backend": "cuda", "grid_steps": s_csr + s_bcsr,
                     "grid_steps_csr": s_csr, "grid_steps_bcsr": s_bcsr,
                     "panel_g": g, "pipeline_depth": d,
                     "wall_us": 5.0 + 2.0 * s_csr + 1.0 * s_bcsr
                     + 0.1 * g * s_csr + 0.3 * (d - 1) * (s_csr + s_bcsr)})
    return recs


@pytest.mark.parametrize("n", [2, 3, 6, 8])
def test_trace_db_step_cost_and_replay_equal_reference(n):
    recs = _cells()[:n]
    want = rreplay.TraceDB(records=list(recs)).step_cost("cuda")
    got = treplay.TraceDB(records=list(recs)).step_cost("cuda")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    cr, cp = pair("m12")
    for p in plans_for(cp.nrows):
        assert treplay.replay(p, treplay.TraceDB(records=list(recs)),
                              csr=cp, n_cols=8, backend="cuda") == \
            pytest.approx(rreplay.replay(ref_plan(p), rreplay.TraceDB(
                records=list(recs)), csr=cr, n_cols=8, backend="cuda"),
                rel=1e-9)
    assert treplay.replay(plans_for(cp.nrows)[0], treplay.TraceDB(),
                          csr=cp, n_cols=8) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_files_read_in_the_other_package(tmp_path, writer):
    cr, cp = pair("m8")
    p = plans_for(cp.nrows)[2]
    if writer == "port":
        rec = ttrace.TraceRecorder(source="x")
        rec.record_spmm(cp, p, wall_s=2e-4, n_cols=16, backend="cuda")
        rec.record("step", part="step", op="decode", step=0, wall_us=3.0)
        path = rec.save(tmp_path / "x.jsonl")
        assert rtrace.load_traces(path) == rec.records
    else:
        rec = rtrace.TraceRecorder(source="x")
        rec.record_spmm(cr, ref_plan(p), wall_s=2e-4, n_cols=16,
                        backend="jnp")
        path = rec.save(tmp_path / "x.jsonl")
        assert ttrace.load_traces(path) == rec.records
    assert treplay.TraceDB.load(tmp_path).records == rec.records


def test_record_spmm_and_matrix_key_equal_reference():
    cr, cp = pair("m13")
    for p in plans_for(cp.nrows):
        want = rtrace.TraceRecorder(source="x").record_spmm(
            cr, ref_plan(p), wall_s=1e-4, n_cols=8, backend="b")
        got = ttrace.TraceRecorder(source="x").record_spmm(
            cp, p, wall_s=1e-4, n_cols=8, backend="b")
        assert got == want
    assert ttrace.matrix_key(cp) == rtrace.matrix_key(cr)
    assert ttrace.TRACE_KINDS == rtrace.TRACE_KINDS
    assert ttrace.TRACE_SCHEMA_VERSION == rtrace.TRACE_SCHEMA_VERSION


def test_load_traces_rejects_future_schema_and_unknown_kind(tmp_path):
    p = tmp_path / "future.jsonl"
    p.write_text(json.dumps({"schema": 99, "kind": "spmm"}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        ttrace.load_traces(p)
    with pytest.raises(ValueError, match="unknown trace record kind"):
        ttrace.TraceRecorder().record("wat")


def test_recorder_dispatch_records_and_wrap_step(tmp_path, rng):
    cr, cp = pair("m8", rows=96)
    fmt = tf.loops_from_csr(cp, 32, 8, panel_g=4)
    rec = ttrace.TraceRecorder(source="unit")
    with rec.attach_engine():
        assert engine.get_tracer() is rec
        tspmm.loops_spmm(fmt, torch.ones(cp.ncols, 8), device="cpu")
    assert engine.get_tracer() is None
    dispatches = [r for r in rec.records if r["kind"] == "dispatch"]
    assert [r["part"] for r in dispatches] == ["csr", "bcsr"]
    for r in dispatches:
        assert {"steps", "scratch_bytes", "prefetch_overlap",
                "pipeline_depth", "backend", "impl"} <= set(r)
    step = rec.wrap_step(lambda x: x + 1, op="toy")
    for _ in range(3):
        step(torch.zeros(2))
    steps = [r for r in rec.records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert rtrace.load_traces(rec.save(tmp_path / "u.jsonl")) == rec.records


def _measure(formats, log):
    def measure(csr, plan, b):
        log.append(plan)
        g = 1.0 + float((plan.r_boundary * 7 + plan.br * 3
                         + plan.panel_g * 5 + plan.macro_m) % 13)
        return formats.loops_from_csr(csr, plan.r_boundary, plan.br,
                                      panel_g=plan.panel_g,
                                      macro_m=plan.macro_m), g
    return measure


@pytest.mark.parametrize("n_cells", [3, 8])
def test_search_with_trace_db_and_recorder_matches_reference(n_cells):
    """Replay ranking (through the memoised step counter) picks the same
    survivors as the reference's; every measured trial lands in the
    recorder as a ``search_trial`` record equal to the reference's."""
    cr, cp = pair("m12", rows=160)
    recs = [dict(r, backend="cuda") for r in _cells()[:n_cells]]
    logs, recorders = ([], []), (rtrace.TraceRecorder(source="s"),
                                 ttrace.TraceRecorder(source="s"))
    budget = dict(top_k=3, max_trials=3)
    want = rsearch.search(cr, n_cols=8, backend="cuda",
                          depth_choices=(1,), br_choices=(4, 8),
                          budget=rsearch.SearchBudget(**budget),
                          trace_db=rreplay.TraceDB(records=list(recs)),
                          recorder=recorders[0],
                          measure=_measure(rf, logs[0]))
    got = tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                         budget=tsearch.SearchBudget(**budget),
                         trace_db=treplay.TraceDB(records=list(recs)),
                         recorder=recorders[1],
                         measure=_measure(tf, logs[1]))
    assert [dataclasses.astuple(p) for p in logs[1]] == \
        [dataclasses.astuple(p) for p in logs[0]]
    assert dataclasses.astuple(got.plan) == dataclasses.astuple(want.plan)
    trials = [r for r in recorders[1].records if r["kind"] == "search_trial"]
    assert len(trials) == got.measured == 3
    assert trials == recorders[0].records
