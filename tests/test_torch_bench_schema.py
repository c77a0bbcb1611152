"""The port's bench-record schema and validator against the reference's
(``tests/test_bench_schema.py``): the schema copy
(``src/repro_torch/benchmarks/bench_schema.json``) is the reference's file
but for the port's two trace backends, ``cuda`` and ``torch``, added to
the two trace ``backend`` enums; ``repro_torch.perf.schema`` gives the
reference validator's answers on the same cases; and the port's records
(the committed smoke baseline, a live obs capture, a live trace file)
validate."""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.perf import schema as rschema
from repro_torch.perf import schema as tschema

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_SCHEMA = ROOT / "benchmarks" / "bench_schema.json"
PORT_SCHEMA = ROOT / "src" / "repro_torch" / "benchmarks" / "bench_schema.json"
BASELINE = (ROOT / "src" / "repro_torch" / "benchmarks" / "baselines"
            / "BENCH_019.json")
SCHEMA = tschema.load_schema(PORT_SCHEMA)
BENCH_REF = {"$ref": "#/definitions/bench_file"}
TRACE_REF = {"$ref": "#/definitions/trace_file"}
OBS_REF = {"$ref": "#/definitions/obs_file"}

FIG4 = {"suite": "fig4", "matrix": "m6", "dtype": "fp32", "panel_g": 8,
        "nnz": 10, "us_per_call": 1.0, "gflops": 1.0, "vs_taco": 1.0,
        "vs_dense": 1.0}
AUTOTUNE = {"suite": "autotune", "matrix": "cache", "hits": 7,
            "near_hits": 1, "misses": 6, "hit_rate": 0.57, "stored": 7,
            "tuned_vs_model_geomean": 1.42}
SKIP = {"suite": "compress_bytes", "skipped": True,
        "reason": "needs 16 devices"}
DISPATCH = {"schema": 1, "kind": "dispatch", "source": "x", "part": "csr",
            "op": "spmm", "backend": "jnp", "impl": "ref", "units": 10,
            "batch": 1, "n": 8, "steps": 10}
HIST = {"schema": 1, "kind": "hist", "source": "x", "metric": "h",
        "labels": {}, "count": 1, "sum": 1.0, "mean": 1.0, "min": 1.0,
        "max": 1.0, "p50": 1.0, "p90": 1.0, "p99": 1.0, "buckets": [1.0],
        "counts": [1]}

# (records, definition): the reference test's cases, valid and not.
CASES = [
    ([FIG4], BENCH_REF),
    ([{**FIG4, "panel_g": "eight"}], BENCH_REF),
    ([{**FIG4, "vs_cusparse": 2.0, "cusparse_us": 3.0}], BENCH_REF),
    ([{k: v for k, v in FIG4.items() if k != "vs_dense"}], BENCH_REF),
    ([{"suite": "fig4", "matrix": "m6"}], BENCH_REF),
    ([AUTOTUNE], BENCH_REF),
    ([{**AUTOTUNE, "hits": -1}], BENCH_REF),
    ([SKIP], BENCH_REF),
    ([{**SKIP, "skipped": False}], BENCH_REF),
    ([DISPATCH], TRACE_REF),
    ([{**DISPATCH, "steps": -1}], TRACE_REF),
    ([{**DISPATCH, "backend": "cuda"}], TRACE_REF),
    ([{"kind": "step", "source": "x", "part": "step", "op": "decode",
       "step": 0, "wall_us": 1.0}], TRACE_REF),
    ([HIST], OBS_REF),
    ([{**HIST, "counts": [0.5, 0.5]}], OBS_REF),
    ([{"schema": 1, "kind": "counter", "source": "x", "metric": "c",
       "labels": {}, "value": -1.0}], OBS_REF),
    ([{"schema": 1, "kind": "counter", "source": "x",
       "metric": "engine.dispatch", "value": 1.0}], OBS_REF),
]


# The port's trace backends, added to the reference's enums of the trace
# records' ``backend``: a trace record names what ran.
PORT_BACKENDS = ["cuda", "torch"]
TRACE_BACKEND_DEFS = ("trace_dispatch", "trace_spmm")


def test_schema_copy_equals_reference():
    """Parsed, the port's schema is the reference's once the two trace
    enums lose ``cuda`` and ``torch``; the text is the reference's with
    those two enum lines changed and nothing else."""
    port = json.loads(PORT_SCHEMA.read_text())
    ref = json.loads(REF_SCHEMA.read_text())
    for name in TRACE_BACKEND_DEFS:
        enum = port["definitions"][name]["properties"]["backend"]["enum"]
        assert enum[-2:] == PORT_BACKENDS
        del enum[-2:]
    assert port == ref
    port_lines = PORT_SCHEMA.read_text().splitlines()
    ref_lines = REF_SCHEMA.read_text().splitlines()
    assert len(port_lines) == len(ref_lines)
    changed = [(a, b) for a, b in zip(port_lines, ref_lines) if a != b]
    assert len(changed) == 2
    for a, b in changed:
        assert a == b.replace('"jnp"]', '"jnp", "cuda", "torch"]')


@pytest.mark.parametrize("recs,ref", CASES)
def test_validator_gives_the_reference_answers(recs, ref):
    """The port's validator on the reference's schema gives the reference
    validator's answers; on the port's schema, the same answers but for a
    trace record naming one of the port's backends, which passes."""
    ref_schema = rschema.load_schema(REF_SCHEMA)
    want = rschema.validate(recs, ref, ref_schema)
    assert tschema.validate(recs, ref, ref_schema) == want
    port_backend = any(r.get("backend") in PORT_BACKENDS for r in recs)
    assert tschema.validate(recs, ref, SCHEMA) == ([] if port_backend
                                                   else want)


def test_committed_baseline_validates():
    recs = json.loads(BASELINE.read_text())
    assert recs
    assert tschema.validate(recs, BENCH_REF, SCHEMA) == []
    suites = {r["suite"] for r in recs}
    assert {"fig4", "fig4_panel", "fig4_panel_geomean", "batched",
            "autotune", "serve_traffic"} <= suites


def test_schema_rejects_missing_required_column():
    recs = json.loads(BASELINE.read_text())
    rec = dict(next(r for r in recs if r.get("suite") == "batched"))
    del rec["grid_steps_native"]
    assert tschema.validate([rec], BENCH_REF, SCHEMA)


def test_live_obs_records_validate(rng, tmp_path):
    """A port Obs capture (spans, every instrument kind, the engine's
    dispatch counters) validates line for line against obs_file."""
    from repro_torch.core import csr_from_dense, loops_spmm, plan_and_convert
    from repro_torch.obs import Obs, load_obs

    a = ((rng.random((48, 32)) < 0.1)
         * rng.standard_normal((48, 32))).astype(np.float32)
    fmt, _ = plan_and_convert(csr_from_dense(a), total_workers=4,
                              device="cpu")
    obs = Obs(source="schema-test")
    with obs.attach_engine():
        with obs.span("outer"):
            with obs.span("inner", k=1):
                loops_spmm(fmt, torch.ones((32, 8)), device="cpu")
    obs.histogram("serve.decode_token_us").observe(42.0)
    obs.gauge("serve.tokens_per_s").set(3.5)
    jsonl, _ = obs.save(tmp_path, stem="schema-test")
    recs = load_obs(jsonl)
    assert {r["kind"] for r in recs} == {"meta", "span", "counter", "gauge",
                                         "hist"}
    assert tschema.validate(recs, OBS_REF, SCHEMA) == []


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_live_trace_records_validate(rng, tmp_path, backend):
    """A trace file written by the port's ``TraceRecorder`` on the CPU
    (engine dispatches of both parts, a measured SpMM cell, a search
    trial and wrapped steps, all naming the port's backend) validates
    line for line against trace_file."""
    from repro_torch.core import csr_from_dense, loops_from_csr, loops_spmm
    from repro_torch.core.spmm import SpmmPlan
    from repro_torch.perf.trace import TraceRecorder, load_traces

    a = ((rng.random((48, 32)) < 0.1)
         * rng.standard_normal((48, 32))).astype(np.float32)
    csr = csr_from_dense(a)
    plan = SpmmPlan(r_boundary=16, t_vpu=2, t_mxu=2, br=8)
    fmt = loops_from_csr(csr, plan.r_boundary, plan.br)
    rec = TraceRecorder(source="schema-test")
    with rec.attach_engine():
        loops_spmm(fmt, torch.ones((32, 8)), device="cpu", backend=backend)
    rec.record_spmm(csr, plan, wall_s=1e-4, n_cols=8, backend=backend)
    rec.record_spmm(csr, plan, wall_s=2e-4, n_cols=8, backend=backend,
                    kind="search_trial", gflops=1.0)
    step = rec.wrap_step(lambda x: x + 1, op="decode")
    step(1)
    step(2)
    recs = load_traces(rec.save(tmp_path / "trace.jsonl"))
    assert {r["kind"] for r in recs} == {"dispatch", "spmm", "search_trial",
                                         "step"}
    assert {r["backend"] for r in recs if "backend" in r} == {backend}
    assert {r["part"] for r in recs if r["kind"] == "dispatch"} == {
        "csr", "bcsr"}
    assert tschema.validate(recs, TRACE_REF, SCHEMA) == []
    # the reference's schema refuses the same file: what the enums add
    assert tschema.validate(recs, TRACE_REF,
                            rschema.load_schema(REF_SCHEMA))
