"""Perf tooling: the trace → fit → replay loop.

Port of ``repro/perf``:

  * :mod:`repro_torch.perf.trace` — :class:`TraceRecorder`, JSONL trace
    files, :func:`fit_cost_model` (Eq. 2 refit from measurement,
    provenance stamped);
  * :mod:`repro_torch.perf.replay` — :class:`TraceDB`, structural
    :func:`predict_grid_steps`, and :func:`replay` — a plan's predicted
    step time before any conversion is paid;
  * :mod:`repro_torch.perf.schema` — the dependency-free JSON-Schema subset
    validator of the benchmark records and the perf gate;
  * :mod:`repro_torch.perf.hlo_analysis` — per-device flops, HBM bytes and
    collective bytes of a traced step (the dry-run's count; no HLO: a
    dispatch mode over the step's operators), imported on its own.
"""
from .replay import (TraceDB, part_step_counter, predict_grid_steps,
                     predict_part_steps, replay)
from .schema import load_schema, validate
from .trace import (TRACE_SCHEMA_VERSION, TraceRecorder, fit_cost_model,
                    load_traces, matrix_key)

__all__ = ["TRACE_SCHEMA_VERSION", "TraceRecorder", "fit_cost_model",
           "load_traces", "matrix_key", "TraceDB", "part_step_counter",
           "predict_grid_steps", "predict_part_steps", "replay",
           "load_schema", "validate"]
