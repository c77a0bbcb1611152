"""``repro_torch.obs`` — runtime observability for live runs.

Port of ``repro/obs``: labeled metrics (counters / gauges / fixed-bucket
histograms with p50/p90/p99), wall-clock spans with thread-local nesting,
and exporters producing a versioned JSONL stream plus a Perfetto-loadable
Chrome trace, under the reference's schema, so ``tools/obs_report.py``
renders a capture of either package.

Quick start::

    from repro_torch.obs import Obs

    obs = Obs(source="serve")
    with obs.attach_engine():                 # (part, op) dispatch counters
        with obs.span("prefill") as sp:
            cache, logits = api.prefill(cfg, params, batch)
            sp.fence(logits)
    jsonl, chrome = obs.save()                # benchmarks/results/obs/
    print(obs.summary())
"""
from .export import (OBS_KINDS, OBS_SCHEMA_VERSION, chrome_trace,
                     default_obs_dir, load_obs, obs_records,
                     write_chrome_trace, write_jsonl)
from .metrics import (DEFAULT_BUCKETS_US, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .runtime import Obs, get_active, set_active
from .spans import Span, SpanSink, current_span

__all__ = [
    "Obs", "set_active", "get_active",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_BUCKETS_US",
    "Span", "SpanSink", "current_span",
    "OBS_SCHEMA_VERSION", "OBS_KINDS", "obs_records", "chrome_trace",
    "write_jsonl", "write_chrome_trace", "load_obs", "default_obs_dir",
]
