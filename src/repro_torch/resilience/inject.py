"""Seeded, site-addressable fault injection — the chaos harness.

Port of ``repro/resilience/inject.py``: the same plan syntax, sites,
per-site counters and seed-chosen corruption, so one ``REPRO_FAULT_PLAN``
steers a run of either package the same way.  Every resilience seam in the codebase calls :func:`fault_point` with a
stable **site name** before doing the real work; with no active
:class:`FaultPlan` the call is a cheap no-op, so production paths pay one
attribute read.  A plan (installed via :func:`set_plan` or parsed from the
``REPRO_FAULT_PLAN`` env var by :func:`install_from_env`) makes selected
sites fail deterministically — the tests and the CI chaos smoke use this to
*prove* each documented fallback actually fires.

Sites the port passes (the reference's registry, docs/robustness.md, also
has ``train.step``, whose seam is not ported yet):

  * ``engine.{part}.{op}.{link}`` — one attempt of an engine fallback
    chain (``resilience/fallback.py``): ``engine.csr.spmm.cuda``,
    ``engine.fused.spmm.torch``, ``engine.loops.sdd.cuda``, ...;
  * ``cache.read`` — plan-cache file parse (payload: the raw bytes);
  * ``tune.trial`` — one tuner measurement trial;
  * ``dist.psum.{precision}`` — one compressed all-reduce
    (``dist/compress.py``; ``int8`` / ``bf16``), agreed on across the
    group before any rank degrades;
  * ``serve.step`` / ``serve.prefill`` — host-level step calls (the
    retry/deadline wrappers cover these);
  * ``ingest.serve.weights`` — serving weight ingestion (payload: the
    dense weight array; ``nan-values`` corrupts it).

Plan syntax (``;``-separated clauses, glob site match)::

    REPRO_FAULT_PLAN='serve.step:raise:0;cache.read:corrupt-bytes:0:0'
    #                 site-glob          kind  nth[:count]

``kind`` ∈ {``raise``, ``timeout``, ``corrupt-bytes``, ``nan-values``}.
``nth`` (default 0) is the first per-site call index that fires; ``count``
(default 1) is how many consecutive calls fire — ``0`` means *every* call
from ``nth`` on (needed when the consumer retries reads).  A leading
``seed=N`` clause seeds the value-corruption kinds; everything else is a
per-site call counter, so a plan is bit-deterministic across runs.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
import threading
import zlib
from typing import Dict, Optional, Tuple

__all__ = ["FaultClause", "FaultPlan", "InjectedFault", "InjectedTimeout",
           "fault_point", "set_plan", "get_plan", "install_from_env",
           "note_degraded"]

KINDS = ("raise", "timeout", "corrupt-bytes", "nan-values")

ENV_VAR = "REPRO_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """An injected failure (the ``raise`` / payload-less kinds)."""

    def __init__(self, site: str, kind: str):
        super().__init__(f"injected fault at {site!r} (kind={kind})")
        self.site = site
        self.kind = kind


class InjectedTimeout(InjectedFault):
    """An injected deadline overrun (classified as ``timeout``)."""


@dataclasses.dataclass(frozen=True)
class FaultClause:
    """One ``site-glob:kind[:nth[:count]]`` clause of a plan."""

    site: str         # fnmatch glob over site names ('*' crosses dots)
    kind: str         # one of KINDS
    nth: int = 0      # first per-site call index that fires
    count: int = 1    # consecutive firing calls; 0 = every call from nth

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    def fires(self, n: int) -> bool:
        if n < self.nth:
            return False
        return self.count == 0 or n < self.nth + self.count


@dataclasses.dataclass
class FaultPlan:
    """A deterministic set of fault clauses plus per-site call counters."""

    clauses: Tuple[FaultClause, ...]
    seed: int = 0
    _calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``REPRO_FAULT_PLAN`` syntax (see module docstring)."""
        clauses, seed = [], 0
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[len("seed="):])
                continue
            parts = raw.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault clause {raw!r}: expected "
                                 "site:kind[:nth[:count]]")
            site, kind = parts[0], parts[1]
            nth = int(parts[2]) if len(parts) > 2 else 0
            count = int(parts[3]) if len(parts) > 3 else 1
            clauses.append(FaultClause(site=site, kind=kind, nth=nth,
                                       count=count))
        return cls(clauses=tuple(clauses), seed=seed)

    def reset(self) -> None:
        """Zero all per-site call counters (fresh run under the same plan)."""
        with self._lock:
            self._calls.clear()

    def match(self, site: str) -> Optional[FaultClause]:
        """Count one call at ``site``; return the clause that fires, if any."""
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
        for c in self.clauses:
            if fnmatch.fnmatchcase(site, c.site) and c.fires(n):
                return c
        return None


# Process-wide active plan (None = injection disabled, the production state).
_ACTIVE_PLAN: Optional[FaultPlan] = None


def set_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-wide fault plan (None disables);
    returns the previous plan so callers (tests) can restore it."""
    global _ACTIVE_PLAN
    prev, _ACTIVE_PLAN = _ACTIVE_PLAN, plan
    return prev


def get_plan() -> Optional[FaultPlan]:
    return _ACTIVE_PLAN


def install_from_env(environ=None) -> Optional[FaultPlan]:
    """Install a plan from ``$REPRO_FAULT_PLAN`` if set (the launchers call
    this at startup so the chaos CI can steer a whole run)."""
    spec = (environ or os.environ).get(ENV_VAR)
    if not spec:
        return None
    plan = FaultPlan.parse(spec)
    set_plan(plan)
    return plan


def _site_seed(plan: FaultPlan, site: str) -> int:
    return plan.seed ^ zlib.crc32(site.encode("utf-8"))


def _corrupt_bytes(payload: bytes, seed: int) -> bytes:
    """Deterministically mangle a byte payload: truncate to ~half and
    overwrite a seed-chosen window — reliably unparseable JSON, never
    accidentally valid."""
    data = bytearray(payload[: max(len(payload) // 2, 1)])
    if data:
        start = seed % len(data)
        for i in range(start, min(start + 8, len(data))):
            data[i] = 0xFF
    return bytes(data)


def _corrupt_nans(payload, seed: int):
    """Seed-chosen positions of an array payload become NaN in a copy
    (numpy arrays and torch tensors; the same positions for both, on the
    tensor's own device)."""
    import numpy as np
    size = 1
    for d in payload.shape:
        size *= int(d)
    if size == 0:
        return payload
    rng = np.random.default_rng(seed)
    idx = rng.choice(size, size=max(size // 16, 1), replace=False)
    if isinstance(payload, np.ndarray):
        flat = payload.astype(payload.dtype, copy=True).reshape(-1)
        flat[idx] = np.nan
        return flat.reshape(payload.shape)
    import torch
    flat = payload.reshape(-1).clone()
    flat[torch.as_tensor(idx, device=flat.device)] = float("nan")
    return flat.reshape(payload.shape)


def fault_point(site: str, payload=None):
    """The injection seam: returns ``payload`` (possibly corrupted), or
    raises :class:`InjectedFault` / :class:`InjectedTimeout` when the active
    plan has a firing clause for ``site``.  No active plan → pure
    pass-through."""
    plan = _ACTIVE_PLAN
    if plan is None:
        return payload
    clause = plan.match(site)
    if clause is None:
        return payload
    note_degraded("inject.fired", site=site, kind=clause.kind)
    if clause.kind == "raise":
        raise InjectedFault(site, "raise")
    if clause.kind == "timeout":
        raise InjectedTimeout(site, "timeout")
    if payload is None:
        # A value-corruption clause on a payload-less site degenerates to a
        # raise — there is nothing to corrupt, but the plan asked for a fault.
        raise InjectedFault(site, clause.kind)
    if clause.kind == "corrupt-bytes":
        return _corrupt_bytes(bytes(payload), _site_seed(plan, site))
    return _corrupt_nans(payload, _site_seed(plan, site))


def note_degraded(metric: str, n: float = 1.0, **labels) -> None:
    """Record a degradation event on the active obs capture (no-op without
    one — the resilience layer must never *require* observability)."""
    from ..obs.runtime import get_active
    obs = get_active()
    if obs is not None:
        obs.counter(metric, **labels).inc(n)
