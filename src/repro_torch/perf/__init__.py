"""Perf tooling: the trace → fit → replay loop.

Port of ``repro/perf`` without ``hlo_analysis`` (roofline terms from XLA
HLO), which is still to come with its consumers (ROADMAP A.12/A.13):

  * :mod:`repro_torch.perf.trace` — :class:`TraceRecorder`, JSONL trace
    files, :func:`fit_cost_model` (Eq. 2 refit from measurement,
    provenance stamped);
  * :mod:`repro_torch.perf.replay` — :class:`TraceDB`, structural
    :func:`predict_grid_steps`, and :func:`replay` — a plan's predicted
    step time before any conversion is paid;
  * :mod:`repro_torch.perf.schema` — the dependency-free JSON-Schema subset
    validator of the benchmark records and the perf gate.
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
