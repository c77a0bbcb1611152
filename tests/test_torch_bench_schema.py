"""The port's bench-record schema and validator against the reference's
(``tests/test_bench_schema.py``): the schema copy
(``src/repro_torch/benchmarks/bench_schema.json``) is the reference's file
byte for byte, ``repro_torch.perf.schema`` gives the reference
validator's answers on the same cases, and the port's records (the
committed smoke baseline, a live obs capture) validate."""
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


def test_schema_copy_equals_reference():
    assert PORT_SCHEMA.read_bytes() == REF_SCHEMA.read_bytes()


@pytest.mark.parametrize("recs,ref", CASES)
def test_validator_gives_the_reference_answers(recs, ref):
    want = rschema.validate(recs, ref, rschema.load_schema(REF_SCHEMA))
    assert tschema.validate(recs, ref, SCHEMA) == want


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
