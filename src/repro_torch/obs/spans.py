"""Wall-clock spans with thread-local nesting — the attribution half of obs.

Port of ``repro/obs/spans.py``.  A span is one timed region of host
execution::

    with obs.span("serve.decode_step", token=i) as sp:
        cache, logits = api.decode_step(cfg, params, cache, toks, pos)
        sp.fence(logits)        # synchronise its device before the clock stops

Completed spans become Chrome-trace ``"X"`` (complete) events: name,
category, start timestamp (µs since the recorder's epoch), duration, thread
id and a free-form ``args`` dict.  Nesting is structural — each thread keeps
its own span stack, a child opened under a parent always closes before it —
so the exported events are properly nested per thread and Perfetto renders
them as a flame graph without any reparenting pass.

Compile-safety: a ``with span(...)`` inside a function that
``torch.compile`` is tracing would time the trace, once, and never an
execution.  Entering a span while ``torch.compiler.is_compiling()`` is true
therefore records **nothing** (the span is dropped and counted in the
sink's ``obs.spans_dropped_traced`` counter); spans belong at blocking host
call sites, with :meth:`Span.fence` pinning the asynchronous CUDA work into
the measured interval.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "SpanSink", "current_span", "synchronize"]

_LOCAL = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def current_span() -> Optional["Span"]:
    """The innermost open span on this thread (None outside any span)."""
    st = _stack()
    return st[-1] if st else None


def _tracing() -> bool:
    """True while ``torch.compile`` is tracing on this thread."""
    import torch
    return torch.compiler.is_compiling()


def synchronize(values) -> None:
    """Wait for the work behind ``values``: every CUDA device that holds a
    tensor in ``values`` (a tensor, or lists, tuples and dicts of them, at
    any depth) is synchronised once.  CPU tensors need no wait."""
    import torch
    devices, todo = set(), [values]
    while todo:
        v = todo.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            todo.extend(v.values())
        elif isinstance(v, (list, tuple)):
            todo.extend(v)
    for dev in devices:
        torch.cuda.synchronize(dev)


class SpanSink:
    """Collects completed span events against one perf_counter epoch.

    ``events`` is append-only; each event is a plain dict with ``name``,
    ``cat``, ``ts`` (µs since epoch), ``dur`` (µs), ``tid``, ``depth`` and
    ``args`` — the exporter's native unit (Chrome traces are µs-based).
    """

    def __init__(self, on_drop=None):
        self.epoch = time.perf_counter()
        self.events: List[Dict] = []
        self._lock = threading.Lock()
        self._on_drop = on_drop

    def now_us(self) -> float:
        return (time.perf_counter() - self.epoch) * 1e6

    def span(self, name: str, cat: str = "obs", **args) -> "Span":
        return Span(self, name, cat=cat, args=args)

    def emit(self, event: Dict) -> None:
        with self._lock:
            self.events.append(event)

    def dropped(self, name: str) -> None:
        if self._on_drop is not None:
            self._on_drop(name)


class Span:
    """Context manager for one timed region (see module docstring)."""

    __slots__ = ("sink", "name", "cat", "args", "_t0", "_fences", "_live")

    def __init__(self, sink: SpanSink, name: str, cat: str = "obs",
                 args: Optional[Dict] = None):
        self.sink = sink
        self.name = name
        self.cat = cat
        self.args = dict(args or {})
        self._fences: list = []
        self._live = False

    def fence(self, *values) -> None:
        """Register tensors whose devices are synchronised before the span
        closes, so asynchronously launched device work lands inside the
        measured interval instead of leaking into the next span."""
        self._fences.extend(values)

    def set(self, **args) -> None:
        """Attach/overwrite args after entry (e.g. a result size)."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        if _tracing():
            # Abstract tracing: recording here would mean once-per-compile
            # semantics.  Drop (counted), keep the context-manager shape.
            self.sink.dropped(self.name)
            self._live = False
            return self
        self._live = True
        _stack().append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._live:
            return False
        if self._fences:
            synchronize(self._fences)
        t1 = time.perf_counter()
        st = _stack()
        # Tolerate exceptions unwinding several spans at once: pop until us.
        while st and st[-1] is not self:
            st.pop()
        if st:
            st.pop()
        depth = len(st)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.sink.emit({
            "name": self.name, "cat": self.cat,
            "ts": (self._t0 - self.sink.epoch) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "tid": threading.get_ident(), "depth": depth,
            "args": self.args,
        })
        return False
