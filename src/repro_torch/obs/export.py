"""Obs exporters: versioned JSONL sink + Chrome-trace/Perfetto JSON.

Port of ``repro/obs/export.py``, with the reference's schema version and
record kinds, so a capture of either package loads in the other and
renders with ``tools/obs_report.py``.  Two serialisations of one capture,
following the ``repro_torch.perf.trace`` conventions (every JSONL line
schema-stamped, loaders reject *newer* schemas instead of misreading
them):

  * **JSONL** (``<stem>.jsonl``) — the machine-readable record stream:
    one ``meta`` line, one line per completed span, one line per metric
    instrument (counter / gauge / hist with bucket counts and p50/p90/p99).
    This is what ``tools/obs_report.py`` consumes.
  * **Chrome trace** (``<stem>.trace.json``) — a ``{"traceEvents": [...]}``
    object loadable by Perfetto (ui.perfetto.dev) or ``chrome://tracing``:
    spans as ``"X"`` complete events, counters/gauges as ``"C"`` counter
    events, plus ``"M"`` metadata naming the process after the capture
    source.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Iterable, List

__all__ = ["OBS_SCHEMA_VERSION", "OBS_KINDS", "obs_records", "chrome_trace",
           "write_jsonl", "write_chrome_trace", "load_obs",
           "default_obs_dir"]

OBS_SCHEMA_VERSION = 1

# Record kinds an obs JSONL may contain (bench_schema.json mirrors this).
OBS_KINDS = ("meta", "span", "counter", "gauge", "hist")


def default_obs_dir() -> pathlib.Path:
    """``benchmarks/results/obs/`` at the repo root, overridable via
    ``$REPRO_OBS_DIR`` (sibling of the perf-trace directory)."""
    env = os.environ.get("REPRO_OBS_DIR")
    if env:
        return pathlib.Path(env)
    root = pathlib.Path(__file__).resolve().parents[3]
    return root / "benchmarks" / "results" / "obs"


def _stamp(kind: str, source: str, fields: Dict) -> Dict:
    return {"schema": OBS_SCHEMA_VERSION, "kind": kind, "source": source,
            **fields}


def obs_records(obs) -> List[Dict]:
    """Flatten an :class:`repro_torch.obs.runtime.Obs` capture into schema-stamped
    JSONL records: ``meta`` first, then spans in completion order, then one
    record per metric instrument."""
    src = obs.source
    recs = [_stamp("meta", src, {"spans": len(obs.sink.events),
                                 "metrics": len(obs.metrics.instruments())})]
    for ev in obs.sink.events:
        recs.append(_stamp("span", src, {
            "name": ev["name"], "cat": ev["cat"], "ts": float(ev["ts"]),
            "dur": float(ev["dur"]), "tid": int(ev["tid"]),
            "depth": int(ev["depth"]),
            "args": {k: v for k, v in ev["args"].items()}}))
    for rec in obs.metrics.as_records():
        recs.append(_stamp(rec.pop("kind"), src, rec))
    return recs


def chrome_trace(obs) -> Dict:
    """The capture as a Chrome-trace JSON object (Perfetto-loadable)."""
    src = obs.source
    events: List[Dict] = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": f"repro_torch.obs:{src}"}},
    ]
    tids = sorted({int(ev["tid"]) for ev in obs.sink.events})
    for tid in tids:
        events.append({"ph": "M", "pid": 0, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": f"thread-{tid}"}})
    for ev in obs.sink.events:
        events.append({"ph": "X", "pid": 0, "tid": int(ev["tid"]),
                       "name": ev["name"], "cat": ev["cat"],
                       "ts": float(ev["ts"]), "dur": float(ev["dur"]),
                       "args": {**ev["args"], "depth": ev["depth"]}})
    # Counters/gauges become single-sample counter tracks at the capture
    # end (the registry aggregates; it does not keep a time series).
    end_ts = max([float(ev["ts"]) + float(ev["dur"])
                  for ev in obs.sink.events], default=0.0)
    for kind, inst in obs.metrics.instruments():
        if kind == "hist":
            continue   # distributions render via the report, not a track
        label = ",".join(f"{k}={v}" for k, v in sorted(inst.labels.items()))
        name = f"{inst.name}{{{label}}}" if label else inst.name
        events.append({"ph": "C", "pid": 0, "tid": 0, "name": name,
                       "ts": end_ts, "args": {"value": float(inst.value)}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": src, "schema": OBS_SCHEMA_VERSION}}


def write_jsonl(records: Iterable[Dict], path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return path


def write_chrome_trace(trace: Dict, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True)
    return path


def load_obs(path) -> List[Dict]:
    """Read one obs JSONL file (or every ``*.jsonl`` in a directory),
    validating the schema stamp on every line — a *newer* stamp raises
    instead of being silently misread (same contract as
    ``repro_torch.perf.trace.load_traces``)."""
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
                if ver != OBS_SCHEMA_VERSION:
                    raise ValueError(
                        f"{fp}:{ln}: obs schema {ver!r} != supported "
                        f"{OBS_SCHEMA_VERSION}")
                if rec.get("kind") not in OBS_KINDS:
                    raise ValueError(
                        f"{fp}:{ln}: unknown obs record kind "
                        f"{rec.get('kind')!r}")
                records.append(rec)
    return records
