"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``) on the CPU.

* Metrics: the same counters, gauges and histogram quantiles from the same
  observations; the same kind-conflict and bucket checks.
* Spans: nesting, exception unwinding, thread-local stacks, the fence, and
  a span under ``torch.compile`` tracing dropped and counted.
* Exporters: a port capture loads with the reference's ``load_obs`` (and
  a reference capture with the port's), its Chrome trace is valid and
  nested, and ``tools/obs_report.py`` renders it.
* Seams: ``attach_engine`` (chaining to a ``TraceRecorder`` and restoring
  the previous tracer), ``watch_cache``, ``wrap_step``, ``set_active``.
* The deliberate divergences: ``engine.dispatch`` counts every call (the
  reference's, every jit compilation), and ``observe_in_jit`` /
  ``count_in_jit`` do not exist.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro_torch import obs as tobs
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.kernels import engine
from repro_torch.perf.trace import TraceRecorder
from repro_torch.tune.cache import PlanCache

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fmt(rng, m=64, k=32, r_b=24):
    a = ((rng.random((m, k)) < 0.3) * rng.standard_normal((m, k))).astype(
        np.float32)
    return tf.loops_from_csr(tf.csr_from_dense(a), r_b, 8, panel_g=4)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

SAMPLES = {
    "single": [42.0],
    "ramp": [float(v) for v in range(1, 1001)],
    "lognormal": list(np.random.default_rng(3).lognormal(6.0, 2.0, 5000)),
    "overflow": [5.0, 3e8, 7e9],
    "zeros": [0.0, 0.0, 1.0],
}


@pytest.mark.parametrize("buckets", [None, (10.0, 20.0, 50.0)])
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_histogram_quantiles_equal_reference(name, buckets):
    hr = robs.Histogram("h", {}, buckets=buckets)
    ht = tobs.Histogram("h", {}, buckets=buckets)
    for v in SAMPLES[name]:
        hr.observe(v)
        ht.observe(v)
    assert ht.counts == hr.counts
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ht.percentile(q) == hr.percentile(q)
    assert ht.summary() == hr.summary()
    assert ht.as_record() == hr.as_record()
    assert tobs.DEFAULT_BUCKETS_US == robs.DEFAULT_BUCKETS_US


def test_registry_matches_reference():
    regs = (robs.MetricsRegistry(), tobs.MetricsRegistry())
    for reg in regs:
        reg.counter("c", part="csr").inc()
        reg.counter("c", part="csr").inc(2)
        reg.counter("c", part="bcsr").inc()
        reg.gauge("g").set(7)
        reg.gauge("g").set(9)
        reg.histogram("h", op="x").observe(3.0)
    assert regs[1].as_records() == regs[0].as_records()
    assert regs[1].find("counter", "c", part="csr").value == 3
    assert regs[1].find("counter", "c", part="nope") is None
    for reg in regs:
        with pytest.raises(ValueError, match="already registered"):
            reg.histogram("c")
    with pytest.raises(ValueError, match="ascending"):
        tobs.Histogram("h", {}, buckets=[2.0, 1.0])


def test_observe_in_jit_is_absent():
    """Divergence: eager PyTorch runs every line on every call, so a plain
    ``observe()`` is already once per execution; the reference's
    jit-callback instruments have no counterpart."""
    assert hasattr(robs.MetricsRegistry, "observe_in_jit")
    assert not hasattr(tobs.MetricsRegistry, "observe_in_jit")
    assert not hasattr(tobs.MetricsRegistry, "count_in_jit")
    reg = tobs.MetricsRegistry()
    f = lambda x: (reg.histogram("h").observe(float(x.sum())), x * 2)[1]
    for _ in range(3):
        f(torch.ones(2))
    assert reg.find("hist", "h").count == 3


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_records_on_host_and_fences():
    obs = tobs.Obs(source="t")
    with obs.span("host.region", cat="test", k=1) as sp:
        sp.fence(torch.ones(4) * 2, {"x": [torch.zeros(1)]})
    (ev,) = obs.sink.events
    assert ev["name"] == "host.region" and ev["cat"] == "test"
    assert ev["args"] == {"k": 1} and ev["dur"] >= 0.0


def test_span_nesting_depth_and_order():
    obs = tobs.Obs(source="t")
    with obs.span("outer"):
        assert tobs.current_span().name == "outer"
        with obs.span("inner"):
            assert tobs.current_span().name == "inner"
    assert tobs.current_span() is None
    inner, outer = obs.sink.events
    assert inner["depth"] == 1 and outer["depth"] == 0
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6


def test_span_exception_unwind_records_error():
    obs = tobs.Obs(source="t")
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    (ev,) = obs.sink.events
    assert ev["args"]["error"] == "RuntimeError"
    assert tobs.current_span() is None


def test_spans_are_thread_local():
    obs = tobs.Obs(source="t")
    seen = []

    def worker():
        with obs.span("thread.region"):
            seen.append(tobs.current_span().name)

    with obs.span("main.region"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert tobs.current_span().name == "main.region"
    names = {e["name"]: e for e in obs.sink.events}
    assert seen == ["thread.region"]
    assert names["thread.region"]["depth"] == 0
    assert names["thread.region"]["tid"] != names["main.region"]["tid"]


def test_span_under_compile_tracing_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    obs = tobs.Obs(source="t")
    with obs.span("traced"):
        pass
    assert obs.sink.events == []
    assert obs.metrics.find("counter", "obs.spans_dropped_traced",
                            span="traced").value == 1


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _capture(pkg):
    obs = pkg.Obs(source="t")
    with obs.span("outer", cat="test"):
        with obs.span("inner", cat="test"):
            pass
    obs.counter("c", part="csr").inc(2)
    obs.gauge("g").set(3.5)
    obs.histogram("h").observe(10.0)
    return obs


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_capture_loads_in_the_other_package(tmp_path, writer):
    pkg, other = (tobs, robs) if writer == "port" else (robs, tobs)
    jsonl, _ = _capture(pkg).save(tmp_path, stem="t")
    recs = other.load_obs(jsonl)
    assert recs == pkg.load_obs(jsonl)
    assert {r["kind"] for r in recs} == set(robs.OBS_KINDS)
    assert all(r["schema"] == robs.OBS_SCHEMA_VERSION for r in recs)
    assert recs[0]["kind"] == "meta" and recs[0]["spans"] == 2
    hist = next(r for r in recs if r["kind"] == "hist")
    assert hist["count"] == 1 and hist["p50"] == 10.0
    assert len(other.load_obs(tmp_path)) == len(recs)


def test_records_match_reference_apart_from_times(tmp_path):
    strip = ("ts", "dur", "tid")

    def norm(recs):
        return [{k: v for k, v in r.items() if k not in strip}
                for r in recs]
    assert norm(_capture(tobs).records()) == norm(_capture(robs).records())
    assert tobs.OBS_KINDS == robs.OBS_KINDS
    assert tobs.OBS_SCHEMA_VERSION == robs.OBS_SCHEMA_VERSION


def test_load_obs_rejects_future_schema_and_unknown_kind(tmp_path):
    p = tmp_path / "future.jsonl"
    p.write_text(json.dumps({"schema": tobs.OBS_SCHEMA_VERSION + 1,
                             "kind": "span"}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        tobs.load_obs(p)
    p2 = tmp_path / "weird.jsonl"
    p2.write_text(json.dumps({"schema": tobs.OBS_SCHEMA_VERSION,
                              "kind": "wat"}) + "\n")
    with pytest.raises(ValueError, match="kind"):
        tobs.load_obs(p2)


def test_chrome_trace_is_valid_and_nested(tmp_path):
    _, chrome_path = _capture(tobs).save(tmp_path, stem="t")
    blob = json.loads(chrome_path.read_text())
    evs = blob["traceEvents"]
    assert blob["otherData"]["schema"] == tobs.OBS_SCHEMA_VERSION
    assert {e["ph"] for e in evs} == {"M", "X", "C"}
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(xs) == {"outer", "inner"}
    assert xs["inner"]["args"]["depth"] == 1
    assert (xs["inner"]["ts"] + xs["inner"]["dur"]
            <= xs["outer"]["ts"] + xs["outer"]["dur"] + 1e-6)
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    assert "c{part=csr}" in counters and "g" in counters


def test_obs_report_renders_a_port_capture(tmp_path, rng):
    fmt = _fmt(rng)
    obs = tobs.Obs(source="cli-test")
    with obs.attach_engine():
        tspmm.loops_spmm(fmt, torch.ones(32, 4), device="cpu")
    obs.histogram("serve.decode_token_us").observe(123.0)
    jsonl, chrome = obs.save(tmp_path, stem="cli-test")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for path, extra in ((jsonl, ["--require-dispatch"]), (chrome, [])):
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "obs_report.py"),
             str(path), *extra], capture_output=True, text=True, cwd=ROOT,
            env=env, timeout=120)
        assert out.returncode == 0, out.stderr
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "obs_report.py"), str(jsonl)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert "engine.dispatch" in out.stdout
    assert "serve.decode_token_us" in out.stdout


# ---------------------------------------------------------------------------
# seams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calls", [1, 3])
def test_engine_dispatch_counts_per_call(rng, calls):
    """Divergence: the port's engine notes every call, so
    ``engine.dispatch`` is one per kernel launch on ``"cuda"`` (the
    reference's fires once per jit compilation)."""
    fmt = _fmt(rng)
    b = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    obs = tobs.Obs(source="t")
    with obs.attach_engine():
        for _ in range(calls):
            tspmm.loops_spmm(fmt, b, device="cpu")
    for part in ("csr", "bcsr"):
        ctr = obs.metrics.find("counter", "engine.dispatch", part=part,
                               op="spmm", backend="cuda", impl="panels")
        assert ctr.value == calls
    steps = obs.metrics.find("counter", "engine.grid_steps_compiled",
                             part="csr", op="spmm")
    assert steps.value == calls * obs.metrics.find(
        "gauge", "engine.grid_steps", part="csr", op="spmm").value
    assert obs.summary()["engine_dispatches"] == 2 * calls


def test_attach_engine_chains_to_trace_recorder(rng):
    fmt = _fmt(rng, 32, 16, 8)
    rec = TraceRecorder(source="t")
    obs = tobs.Obs(source="t")
    with rec.attach_engine():
        with obs.attach_engine():
            tspmm.loops_spmm(fmt, torch.ones(16, 4), device="cpu")
            tspmm.loops_spmm(fmt, torch.ones(16, 4), device="cpu",
                             backend="torch")
    n_obs = sum(inst.value for kind, inst in obs.metrics.instruments()
                if kind == "counter" and inst.name == "engine.dispatch")
    n_rec = sum(1 for r in rec.records if r["kind"] == "dispatch")
    assert n_obs == n_rec == 4


def test_attach_engine_restores_previous_tracer():
    before = engine.get_tracer()
    obs = tobs.Obs(source="t")
    with obs.attach_engine():
        assert engine.get_tracer() is not before
    assert engine.get_tracer() is before


def test_watch_cache_gauges_equal_cache_stats(tmp_path):
    cache = PlanCache(str(tmp_path))
    cache.put("k1", {"plan": 1})
    cache.lookup("k1")
    cache.lookup("k2")
    cache.prewarm({"k3": {"plan": 3}})
    obs = tobs.Obs(source="t")
    obs.watch_cache(cache, name="test")
    gauges = {(r["metric"], r["labels"]["cache"]): r["value"]
              for r in obs.records() if r["kind"] == "gauge"}
    st = cache.stats
    assert gauges[("tune.cache.hits", "test")] == st.hits == 1
    assert gauges[("tune.cache.misses", "test")] == st.misses == 1
    assert gauges[("tune.cache.hit_rate", "test")] == st.hit_rate == 0.5
    assert gauges[("tune.cache.prewarmed", "test")] == st.prewarmed == 1


def test_wrap_step_records_latency_and_spans():
    obs = tobs.Obs(source="t")
    wrapped = obs.wrap_step(lambda x: (x * 2.0, {"y": x}), op="toy")
    for _ in range(3):
        wrapped(torch.ones(4))
    h = obs.metrics.find("hist", "step.wall_us", op="toy")
    assert h.count == 3
    assert [e["name"] for e in obs.sink.events] == ["step.toy"] * 3
    assert [e["args"]["step"] for e in obs.sink.events] == [0, 1, 2]


def test_active_capture_set_and_restore():
    assert tobs.get_active() is None
    obs = tobs.Obs(source="t")
    prev = tobs.set_active(obs)
    assert prev is None and tobs.get_active() is obs
    tobs.set_active(prev)
    assert tobs.get_active() is None


def test_validate_repairs_land_on_the_active_capture():
    from repro_torch.resilience import validate_csr
    csr = tf.csr_from_dense(np.eye(6, dtype=np.float32))
    bad = tf.CSR(row_ptr=csr.row_ptr, col_idx=csr.col_idx,
                 vals=np.where(np.arange(6) == 2, np.nan,
                               csr.vals).astype(np.float32),
                 row_ids=csr.row_ids, shape=csr.shape)
    obs = tobs.Obs(source="t")
    prev = tobs.set_active(obs)
    try:
        validate_csr(bad, repair="drop")
    finally:
        tobs.set_active(prev)
    assert obs.metrics.find("counter", "validate.repaired",
                            defect="nonfinite-value", mode="drop").value == 1
