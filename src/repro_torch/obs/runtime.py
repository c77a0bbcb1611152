"""The ``Obs`` facade — one capture object for a live train/serve run.

Port of ``repro/obs/runtime.py``.  Ties the registry
(``repro_torch.obs.metrics``), the span sink (``repro_torch.obs.spans``)
and the exporters (``repro_torch.obs.export``) together and owns the
built-in instrumentation seams:

  * :meth:`Obs.attach_engine` — hooks the execution engine's dispatch
    tracer (``repro_torch.kernels.engine.set_tracer``) and turns every
    kernel dispatch into ``engine.dispatch`` counters (labeled ``part``/
    ``op``/``backend``/``impl``) plus ``engine.grid_steps`` gauges.  The
    hook **chains**: a previously installed tracer (e.g. a
    ``repro_torch.perf.trace.TraceRecorder``) keeps receiving every
    dispatch.  The port's engine runs eagerly and notes every *call*, so
    ``engine.dispatch`` counts calls: one per kernel launch on the
    ``"cuda"`` backend.  The reference's tracer fires at trace time, once
    per jit compilation, so there it counts compilations.
  * :meth:`Obs.watch_cache` — registers a ``repro_torch.tune.PlanCache``
    whose ``CacheStats`` are exported as ``tune.cache.*`` gauges at
    snapshot time (pull model: the cache is read when records are
    exported, so the hit rate reflects the whole run).
  * :meth:`Obs.wrap_step` — wraps a step function: each call runs under a
    span, synchronises the devices of its outputs and lands one
    observation in the ``step.wall_us`` histogram for its ``op``.

``save()`` writes both serialisations (JSONL + Chrome trace) next to each
other under ``benchmarks/results/obs/`` by default.

:func:`note_collective` is the collective hook: ``dist.compress.
compressed_psum`` reports each call's per-rank wire bytes through it.
"""
from __future__ import annotations

import functools
import pathlib
import time
from typing import Dict, Optional, Tuple

from .export import (chrome_trace, default_obs_dir, obs_records, write_chrome_trace,
                     write_jsonl)
from .metrics import MetricsRegistry
from .spans import SpanSink

__all__ = ["Obs", "set_active", "get_active", "note_collective"]

# Process-wide active capture (the rendezvous of the degradation counters,
# ``resilience.inject.note_degraded``, and of the collective hook; the
# launchers install their Obs here for the duration of a run).
_ACTIVE: Optional["Obs"] = None


def set_active(obs: Optional["Obs"]) -> Optional["Obs"]:
    """Install ``obs`` as the process-wide capture (None detaches);
    returns the previous one so callers can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, obs
    return prev


def get_active() -> Optional["Obs"]:
    return _ACTIVE


def note_collective(nbytes: int, *, kind: str, precision: str) -> None:
    """Report one collective call's per-rank wire bytes to the active
    capture (no-op without one): the ``dist.collective_bytes`` gauge holds
    the last call's bytes and the ``dist.collective_sites`` counter counts
    calls.  The reference fires once per compilation, so there the counter
    counts compiled call sites; eager PyTorch has no such point, and the
    port counts every call."""
    obs = _ACTIVE
    if obs is None:
        return
    obs.metrics.gauge("dist.collective_bytes", kind=kind,
                      precision=precision).set(float(nbytes))
    obs.metrics.counter("dist.collective_sites", kind=kind,
                        precision=precision).inc()


class _EngineTracer:
    """Adapter from the engine's ``on_dispatch`` hook to obs instruments,
    forwarding every event to a previously installed tracer."""

    def __init__(self, obs: "Obs", prev=None):
        self.obs = obs
        self.prev = prev

    def on_dispatch(self, *, part: str, op: str, **fields) -> None:
        m = self.obs.metrics
        m.counter("engine.dispatch", part=part, op=op,
                  backend=fields.get("backend", "?"),
                  impl=fields.get("impl", "?")).inc()
        steps = fields.get("steps")
        if steps is not None:
            m.gauge("engine.grid_steps", part=part, op=op).set(float(steps))
            m.counter("engine.grid_steps_compiled", part=part,
                      op=op).inc(float(steps))
        sb = fields.get("scratch_bytes")
        if sb is not None:
            m.gauge("kernel.scratch_bytes", part=part, op=op).set(float(sb))
        ov = fields.get("prefetch_overlap")
        if ov is not None:
            m.gauge("engine.prefetch_overlap", part=part,
                    op=op).set(float(ov))
        if self.prev is not None:
            self.prev.on_dispatch(part=part, op=op, **fields)


class _Attach:
    def __init__(self, obs: "Obs"):
        self.obs = obs

    def __enter__(self):
        from ..kernels import engine
        self._prev = engine.set_tracer(_EngineTracer(self.obs,
                                                     prev=engine.get_tracer()))
        return self.obs

    def __exit__(self, *exc):
        from ..kernels import engine
        engine.set_tracer(self._prev)
        return False


class Obs:
    """One observability capture: metrics + spans + exporters."""

    def __init__(self, source: str = "run"):
        self.source = source
        self.metrics = MetricsRegistry()
        self.sink = SpanSink(on_drop=self._on_span_drop)
        self.started_at = time.time()   # wall epoch, metadata only — all
        # interval timing inside the capture is perf_counter-based

    # -- spans -------------------------------------------------------------

    def _on_span_drop(self, name: str) -> None:
        self.metrics.counter("obs.spans_dropped_traced", span=name).inc()

    def span(self, name: str, cat: str = "obs", **args):
        """Open a wall-clock span (see :mod:`repro_torch.obs.spans`); under
        ``torch.compile`` tracing this records nothing and counts a drop
        instead."""
        return self.sink.span(name, cat=cat, **args)

    # -- instruments (delegates) ------------------------------------------

    def counter(self, name: str, **labels):
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels):
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, buckets=None, **labels):
        return self.metrics.histogram(name, buckets=buckets, **labels)

    # -- engine seam -------------------------------------------------------

    def attach_engine(self) -> _Attach:
        """Context manager installing the dispatch adapter on the engine
        tracer hook (chains to any tracer already installed)."""
        return _Attach(self)

    # -- tuner seam --------------------------------------------------------

    def watch_cache(self, cache, name: str = "plan") -> None:
        """Export ``cache.stats`` (a ``repro_torch.tune.CacheStats``) as
        ``tune.cache.*`` gauges whenever records are exported."""
        self._caches = getattr(self, "_caches", [])
        self._caches.append((name, cache))

    def _collect_caches(self) -> None:
        for name, cache in getattr(self, "_caches", []):
            st = cache.stats
            self.metrics.gauge("tune.cache.hits", cache=name).set(st.hits)
            self.metrics.gauge("tune.cache.near_hits",
                               cache=name).set(st.near_hits)
            self.metrics.gauge("tune.cache.misses", cache=name).set(st.misses)
            self.metrics.gauge("tune.cache.hit_rate",
                               cache=name).set(st.hit_rate)
            # distinct name from the ``tune.cache.quarantined`` *counter*
            # (note_degraded): the registry forbids one name in two kinds
            self.metrics.gauge("tune.cache.quarantined_files",
                               cache=name).set(st.quarantined)
            self.metrics.gauge("tune.cache.prewarmed",
                               cache=name).set(getattr(st, "prewarmed", 0))

    # -- step seam ---------------------------------------------------------

    def wrap_step(self, fn, *, op: str):
        """Wrap a step function: every call runs under a span, synchronises
        the devices of its outputs (the asynchronous CUDA work lands inside
        the measured interval) and records ``step.wall_us{op=...}``."""
        hist = self.metrics.histogram("step.wall_us", op=op)
        counter = [0]

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with self.span(f"step.{op}", cat="step", step=counter[0]) as sp:
                out = fn(*args, **kwargs)
                sp.fence(out)
            hist.observe((time.perf_counter() - t0) * 1e6)
            counter[0] += 1
            return out

        return wrapped

    # -- readout / persistence --------------------------------------------

    def records(self):
        self._collect_caches()
        return obs_records(self)

    def chrome(self) -> Dict:
        self._collect_caches()
        return chrome_trace(self)

    def summary(self) -> Dict:
        """Small human-oriented digest (the launchers print this)."""
        self._collect_caches()
        out: Dict = {"source": self.source, "spans": len(self.sink.events)}
        dispatches = sum(
            inst.value for kind, inst in self.metrics.instruments()
            if kind == "counter" and inst.name == "engine.dispatch")
        out["engine_dispatches"] = int(dispatches)
        for kind, inst in self.metrics.instruments():
            if kind == "hist" and inst.count:
                label = ",".join(f"{k}={v}"
                                 for k, v in sorted(inst.labels.items()))
                key = f"{inst.name}{{{label}}}" if label else inst.name
                s = inst.summary()
                out[key] = {"count": s["count"],
                            "p50_us": round(s["p50"], 1),
                            "p99_us": round(s["p99"], 1)}
        return out

    def save(self, directory=None, stem: Optional[str] = None
             ) -> Tuple[pathlib.Path, pathlib.Path]:
        """Write ``<stem>.jsonl`` and ``<stem>.trace.json`` (Chrome trace)
        under ``directory`` (default ``benchmarks/results/obs/``); returns
        both paths.  Deterministic names — a re-run replaces the previous
        capture instead of accumulating."""
        directory = pathlib.Path(directory) if directory is not None \
            else default_obs_dir()
        stem = stem or self.source
        jsonl = write_jsonl(self.records(), directory / f"{stem}.jsonl")
        chrome = write_chrome_trace(self.chrome(),
                                    directory / f"{stem}.trace.json")
        return jsonl, chrome
