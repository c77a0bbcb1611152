"""Labeled runtime metrics: counters, gauges, fixed-bucket histograms.

Port of ``repro/obs/metrics.py``.  The registry is the *aggregation* half
of ``repro_torch.obs`` (spans are the *attribution* half,
``repro_torch.obs.spans``).  Three instrument kinds, all host-side Python
state:

  * :class:`Counter` -- monotonically increasing totals (engine dispatches,
    tokens served);
  * :class:`Gauge` -- last-written values (grid steps of the most recent
    dispatch, steps/s);
  * :class:`Histogram` -- fixed-bucket latency distributions with
    p50/p90/p99 summaries.  Buckets are *fixed at creation* (default: a
    1-2-5 geometric ladder from 1 us to 100 s), so memory is O(buckets)
    regardless of sample count and two histograms of the same name merge
    bucket-wise; exact ``min``/``max``/``sum``/``count`` ride along and
    quantiles interpolate linearly inside the winning bucket.

The reference's ``observe_in_jit`` / ``count_in_jit`` stage an observation
through ``jax.debug.callback`` so that it fires once per execution of a
compiled function.  Eager PyTorch runs every Python line on every call, so
a plain ``observe()`` or ``inc()`` at the call site already counts once per
execution: the two have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS_US", "label_key"]


def _ladder(lo: float, hi: float) -> Tuple[float, ...]:
    """1-2-5 geometric bucket boundaries covering [lo, hi]."""
    out: List[float] = []
    decade = lo
    while decade <= hi:
        for m in (1.0, 2.0, 5.0):
            v = decade * m
            if lo <= v <= hi:
                out.append(v)
        decade *= 10.0
    return tuple(out)


# Default latency ladder: 1 µs … 100 s in microseconds.  Wide enough for a
# single fused kernel and for a cold-compile prefill in the same histogram.
DEFAULT_BUCKETS_US: Tuple[float, ...] = _ladder(1.0, 1e8)


def label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    """Canonical (sorted, stringified) identity of a label set."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class Counter:
    name: str
    labels: Dict[str, str]
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def as_record(self) -> Dict:
        return {"metric": self.name, "labels": dict(self.labels),
                "value": float(self.value)}


@dataclasses.dataclass
class Gauge:
    name: str
    labels: Dict[str, str]
    value: float = 0.0
    _written: bool = False

    def set(self, v: float) -> None:
        self.value = float(v)
        self._written = True

    def as_record(self) -> Dict:
        return {"metric": self.name, "labels": dict(self.labels),
                "value": float(self.value)}


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    ``buckets`` are ascending upper bounds; an implicit +inf bucket catches
    overflow.  ``percentile(q)`` walks the cumulative counts to the bucket
    holding the q-quantile and interpolates linearly between that bucket's
    bounds (clamped to the exact observed ``min``/``max``, so a
    single-sample histogram reports that sample at every quantile).
    """

    def __init__(self, name: str, labels: Dict[str, str],
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.labels = labels
        bounds = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS_US))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram buckets must be strictly "
                             f"ascending, got {bounds}")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:                           # first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]); 0.0 on an empty histogram."""
        if not self.count:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            lo = self.bounds[i - 1] if i > 0 else min(self.min, 0.0)
            hi = self.bounds[i] if i < len(self.bounds) else self.max
            if cum + c >= rank:
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(0.0, min(frac, 1.0))
                return max(self.min, min(est, self.max))
            cum += c
        return self.max

    def summary(self) -> Dict:
        return {"count": int(self.count), "sum": float(self.sum),
                "mean": float(self.mean),
                "min": float(self.min) if self.count else 0.0,
                "max": float(self.max) if self.count else 0.0,
                "p50": self.percentile(0.50),
                "p90": self.percentile(0.90),
                "p99": self.percentile(0.99)}

    def as_record(self) -> Dict:
        return {"metric": self.name, "labels": dict(self.labels),
                "buckets": list(self.bounds), "counts": list(self.counts),
                **self.summary()}


class MetricsRegistry:
    """Get-or-create store of labeled instruments (thread-safe).

    One instrument per ``(kind, name, labels)``; asking for an existing
    name with a different kind raises (a counter can never silently shadow
    a histogram of the same name).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str, tuple], object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict, **kwargs):
        lk = label_key(labels)
        with self._lock:
            for (k, n, other_lk), inst in self._instruments.items():
                if n == name and k != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {k}, "
                        f"cannot re-register as {kind}")
            key = (kind, name, lk)
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, {str(k): str(v) for k, v in labels.items()},
                           **kwargs)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get("hist", Histogram, name, labels, buckets=buckets)

    # -- readout ----------------------------------------------------------

    def instruments(self) -> List[Tuple[str, object]]:
        with self._lock:
            return [(kind, inst) for (kind, _, _), inst
                    in self._instruments.items()]

    def find(self, kind: str, name: str, /, **labels):
        """The existing instrument, or None (no get-or-create side effect).
        ``kind``/``name`` are positional-only so labels may use those words.
        """
        with self._lock:
            return self._instruments.get((kind, name, label_key(labels)))

    def as_records(self) -> List[Dict]:
        """One plain-dict record per instrument, ``kind`` tagged (the JSONL
        exporter stamps these with the obs schema version)."""
        out = []
        for kind, inst in self.instruments():
            out.append({"kind": kind, **inst.as_record()})
        return out
