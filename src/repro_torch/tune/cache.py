"""Persistent, versioned plan cache with an in-memory LRU front.

Port of ``repro/tune/cache.py`` with the reference's ``CACHE_VERSION`` and
record layout: a ``plans.json`` written by either package reads in the
other (the backend in each key keeps their plans apart).

Layout: one JSON file (``plans.json``) under the cache directory —
``$REPRO_TUNE_CACHE`` if set, else ``~/.cache/repro-tune``.  The file carries
a ``version`` stamp; a mismatch (older tuner, changed fingerprint layout)
discards the stored entries rather than mis-applying them.  Writes are
atomic (tmp + rename) so a crashed tuning run can never corrupt the cache.

Lookup is two-tier:

1. **exact** — the quantised-fingerprint key (``fingerprint.cache_key``);
2. **near** — scan entries with the same execution context (dtype, n_cols,
   backend) and accept the closest fingerprint within ``max_distance``
   (RMS over the log/ratio feature vector).  This is what lets an unseen
   matrix reuse the plan of a structurally similar one (same Table-2-style
   statistics) without paying for a measurement sweep.

``stats`` counts hits / near-hits / misses — the amortisation story a
production SpMM service lives on (a repeated ``autotune`` call must be a
pure cache hit; tests assert this).

Resilience:

  * **lock-free read-retry** — writes are atomic (tmp + rename), but a
    reader racing a writer on filesystems without atomic rename visibility
    can observe a partial file; a parse failure re-reads up to
    :data:`READ_RETRIES` times (a racing write completes in well under the
    backoff) before concluding the file is actually corrupt;
  * **quarantine-on-corrupt** — a file that still fails to parse is moved
    aside to ``plans.json.quarantined`` (``stats.quarantined`` counts it,
    ``tune.cache.quarantined`` lands on the active obs capture) and the
    cache rebuilds from empty instead of raising on every lookup;
  * **merge-on-save** — ``put`` folds fresh on-disk entries from concurrent
    writers into the blob before writing, so two processes tuning disjoint
    matrices both keep their work (last writer wins per key).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

from ..resilience.inject import fault_point, note_degraded
from .fingerprint import feature_distance

__all__ = ["PlanCache", "CacheStats", "CACHE_VERSION", "default_cache_dir"]

# Bump when the record schema or the fingerprint feature layout changes;
# it must equal the reference's, whose files this cache reads and writes.
# v2: plans carry ``panel_g`` (G-wide kernel panels) — v1 records predate the
# panelized kernels and must never be replayed as-if G=1 were still the only
# execution shape.
# v3: ``n_cols`` is the *effective* column count ``prod(batch) * N`` of the
# (possibly batched) dense operand (``fingerprint.effective_n_cols``) — the
# batched execution engine amortises A's panels across batch slices, so a
# v2 record keyed on the trailing dim alone would transfer a plan tuned for
# an 8x narrower workload.
# v4: plans carry ``pipeline_depth`` (double-buffered B-panel prefetch) and
# ``macro_m`` (same-row macro-step fusion) — knob-less v3 plans were tuned
# against a strictly serial, unfused search space and must never replay as
# if depth-1/macro-1 were still the only execution shape.
CACHE_VERSION = 4

# Lock-free read-retry: parse attempts before a persistently unparseable
# file is quarantined, and the wait between them (a racing atomic write
# completes in far less).  ``_retry_sleep`` is an indirection point so tests
# can interleave a writer with the retries.
READ_RETRIES = 3
READ_RETRY_DELAY_S = 0.01
_retry_sleep = time.sleep


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-tune")


@dataclasses.dataclass
class CacheStats:
    """Lookup accounting with a counted-exactly-once contract.

    Every *logical* lookup — one :meth:`PlanCache.get` or
    :meth:`PlanCache.lookup` call — lands in exactly one bucket, however it
    resolves internally: an exact-key probe that falls through to the
    near-match scan and then misses is ONE miss, never an exact-miss plus a
    near-miss.  ``peek``/``nearest`` are
    the side-effect-free internals and never count.
    """

    hits: int = 0        # exact fingerprint-key hits
    near_hits: int = 0   # near-match (fingerprint-distance) hits
    misses: int = 0
    quarantined: int = 0  # corrupt files moved to *.quarantined (not a
    # lookup bucket: quarantine happens during _load, the lookup that
    # triggered it still counts its own miss)
    prewarmed: int = 0   # records bulk-installed by :meth:`PlanCache.prewarm`
    # (not a lookup bucket either: counted exactly once per NEWLY installed
    # key — re-prewarming an already-present record counts nothing)

    @property
    def lookups(self) -> int:
        return self.hits + self.near_hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return (self.hits + self.near_hits) / n if n else 0.0

    def reset(self) -> None:
        """Zero all buckets (start of a measurement window — e.g. an obs
        capture that wants per-run rather than per-process rates)."""
        self.hits = self.near_hits = self.misses = self.quarantined = 0
        self.prewarmed = 0

    def __str__(self) -> str:
        q = f" quarantined={self.quarantined}" if self.quarantined else ""
        w = f" prewarmed={self.prewarmed}" if self.prewarmed else ""
        return (f"hits={self.hits} near={self.near_hits} "
                f"misses={self.misses} rate={self.hit_rate:.2f}{q}{w}")


class PlanCache:
    """Fingerprint-keyed plan store: disk JSON + in-memory LRU front."""

    def __init__(self, path: Optional[str] = None, *, lru_size: int = 128):
        self.dir = path or default_cache_dir()
        self.file = os.path.join(self.dir, "plans.json")
        self.lru_size = lru_size
        self._lru: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._entries: Optional[Dict[str, Dict[str, Any]]] = None
        self.stats = CacheStats()

    # -- disk ---------------------------------------------------------------

    def _read_blob(self) -> Dict[str, Any]:
        """One raw read+parse of the cache file (``cache.read`` is the chaos
        injection site — a ``corrupt-bytes`` clause mangles the payload the
        parser sees, never the file itself)."""
        with open(self.file, "rb") as f:
            data = f.read()
        data = fault_point("cache.read", data)
        return json.loads(data.decode("utf-8"))

    def _quarantine(self) -> None:
        """Move the corrupt file aside (``plans.json.quarantined``) so the
        cache rebuilds instead of re-raising on every lookup; the event is
        counted in ``stats`` and on the active obs capture."""
        try:
            os.replace(self.file, self.file + ".quarantined")
        except OSError:
            return   # raced away / unwritable dir: rebuilding in memory only
        self.stats.quarantined += 1
        note_degraded("tune.cache.quarantined", path=self.file)

    def _load(self) -> Dict[str, Dict[str, Any]]:
        """All on-disk entries; {} on absence, corruption or version skew.

        A parse failure is retried (lock-free read-retry: a reader racing
        an atomic writer may glimpse a partial file on non-atomic-visibility
        filesystems); a file that *keeps* failing is genuinely corrupt and
        is quarantined rather than raised on.
        """
        if self._entries is not None:
            return self._entries
        blob = None
        for retry in range(READ_RETRIES + 1):
            try:
                blob = self._read_blob()
                break
            except OSError:
                self._entries = {}   # absent (or vanished mid-race)
                return self._entries
            except ValueError:
                if retry < READ_RETRIES:
                    _retry_sleep(READ_RETRY_DELAY_S)
        if blob is None:
            self._quarantine()
            self._entries = {}
        elif blob.get("version") == CACHE_VERSION:
            self._entries = dict(blob.get("entries", {}))
        else:
            self._entries = {}   # version mismatch: invalidate
        return self._entries

    def _save(self, *, merge: bool = True) -> None:
        os.makedirs(self.dir, exist_ok=True)
        entries = self._load()
        if merge:
            # Fold in fresh same-version entries from concurrent writers —
            # two processes tuning disjoint matrices both keep their work.
            # Best-effort raw read (no retry/quarantine: a transiently
            # unreadable file just skips the merge; our write still lands).
            try:
                with open(self.file) as f:
                    disk = json.load(f)
                if disk.get("version") == CACHE_VERSION:
                    entries = {**dict(disk.get("entries", {})), **entries}
                    self._entries = entries
            except (OSError, ValueError):
                pass
        blob = {"version": CACHE_VERSION, "entries": entries}
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
            os.replace(tmp, self.file)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- LRU front ----------------------------------------------------------

    def _touch(self, key: str, record: Dict[str, Any]) -> None:
        self._lru[key] = record
        self._lru.move_to_end(key)
        while len(self._lru) > self.lru_size:
            self._lru.popitem(last=False)

    # -- API ----------------------------------------------------------------

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Exact-key lookup (counts one hit or miss — routed through the
        same single accounting point as :meth:`lookup`)."""
        return self.lookup(key)

    def peek(self, key: str) -> Optional[Dict[str, Any]]:
        """Exact-key lookup with no stats side effects."""
        if key in self._lru:
            self._lru.move_to_end(key)
            return self._lru[key]
        rec = self._load().get(key)
        if rec is not None:
            self._touch(key, rec)
        return rec

    def put(self, key: str, record: Dict[str, Any]) -> None:
        self._load()[key] = record
        self._touch(key, record)
        self._save()

    def prewarm(self, records) -> int:
        """Bulk-install tuned records ahead of traffic (the warm-pool path:
        ``launch/serve.py`` tunes once, every serving process prewarms).

        ``records`` is either an iterable of ``make_record``-schema dicts —
        keys are rebuilt from each record's stored fingerprint + execution
        context via ``fingerprint.cache_key_from_features`` — or a mapping
        of explicit ``{key: record}``.  Only keys not already present are
        installed, in ONE atomic save (``put`` would pay a disk write per
        record), and ``stats.prewarmed`` counts exactly the newly installed
        keys: re-prewarming the same set is a no-op that counts zero and
        never touches disk.  Returns the number installed.
        """
        from .fingerprint import cache_key_from_features
        if hasattr(records, "items"):
            pairs = list(records.items())
        else:
            pairs = [(cache_key_from_features(
                rec["fingerprint"], n_cols=rec["n_cols"],
                dtype=rec["dtype"], backend=rec["backend"]), rec)
                for rec in records]
        entries = self._load()
        installed = 0
        for key, rec in pairs:
            if key in entries:
                continue
            entries[key] = rec
            self._touch(key, rec)
            installed += 1
        if installed:
            self._save()
        self.stats.prewarmed += installed
        return installed

    def nearest(self, features, *, dtype: str, n_cols: int, backend: str,
                max_distance: float) -> Optional[Dict[str, Any]]:
        """Closest same-context entry within ``max_distance`` (no stats)."""
        best, best_d = None, max_distance
        for rec in self._load().values():
            if (rec.get("dtype") != dtype or rec.get("n_cols") != n_cols
                    or rec.get("backend") != backend):
                continue
            d = feature_distance(features, rec.get("fingerprint", []))
            if d <= best_d:
                best, best_d = rec, d
        return best

    def lookup(self, key: str, *, features=None, dtype: str = "",
               n_cols: int = 0, backend: str = "",
               max_distance: float = 0.0) -> Optional[Dict[str, Any]]:
        """Exact then near lookup — the ONE accounting point.

        One call counts exactly one of {hit, near_hit, miss}, regardless of
        how many internal probes the exact→near fall-through performs.  The
        context arguments (``features``/``dtype``/``n_cols``/``backend``)
        are only consulted when ``max_distance > 0`` enables the near scan.
        """
        rec = self.peek(key)
        if rec is not None:
            self.stats.hits += 1
            return rec
        if max_distance > 0.0 and features is not None:
            rec = self.nearest(features, dtype=dtype, n_cols=n_cols,
                               backend=backend, max_distance=max_distance)
            if rec is not None:
                self.stats.near_hits += 1
                return rec
        self.stats.misses += 1
        return None

    def __len__(self) -> int:
        return len(self._load())

    def clear(self) -> None:
        self._entries = {}
        self._lru.clear()
        self._save(merge=False)   # an explicit clear must not resurrect
        # concurrent writers' entries
