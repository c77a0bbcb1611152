"""Pure continuous-batching scheduler: admission, coalescing, interleave.

A copy of ``repro/serve/scheduler.py`` (the port keeps its own: it never
imports the reference package).  The policy half of the serve queue.
**No arrays, no clocks**: every method takes ``now`` explicitly, so the
whole decision surface is a deterministic function of (submissions,
timestamps, config).  The queue layer (``repro_torch.serve.queue``)
translates the returned actions into engine calls and reports completions
back.

State machine::

    submit(req, now)  --admission-->  FIFO queue        (or REJECTED)
    poll(now)         --coalesce--->  Prefill(group)    prompt-shape-keyed
                      --interleave->  Decode(group)     FIFO over groups
    note_prefill_done(gid, now)       first token landed; gen_len==1 exit
    note_decode_done(gid, now)        one token per active member; early
                                      exits; group drains at max_gen

Coalescing contract: a *group* is a set of same-``shape_key`` requests
(identical prompt length -- batch rows are independent in every model
family, so padding the **batch** axis is exact; padding the **sequence**
axis is not) taken from the queue in FIFO order and padded to the engine's
batch-block grid (:func:`padded_batch`, a pure mirror of
``repro_torch/kernels/engine.py``, pinned by ``tests/test_torch_serve.py``).
Requests with shorter ``gen_len`` finish early and their slot idles; the
group drains when its longest member does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from .session import (ACTIVE, DONE, EVICTED, QUEUED, REJECTED, Request)

__all__ = ["SchedulerConfig", "Scheduler", "Group", "Prefill", "Decode",
           "batch_block", "padded_batch", "MAX_BATCH_BLOCK",
           "POLICIES"]

# Pure mirror of repro_torch.kernels.engine.MAX_BATCH_BLOCK, re-stated here
# so the scheduler imports no array library; tests/test_torch_serve.py
# asserts the two constants (and both grid functions) never drift.
MAX_BATCH_BLOCK = 8

POLICIES = ("prefill-first", "decode-first")

# Group lifecycle.
G_PREFILL = "prefill"
G_DECODE = "decode"
G_DONE = "done"


def batch_block(batch: int) -> int:
    """Batch slices per grid step — the largest divisor of ``batch`` that is
    ≤ :data:`MAX_BATCH_BLOCK` (pure mirror of ``engine.batch_block``)."""
    if batch <= 0:
        return 1
    for d in range(min(batch, MAX_BATCH_BLOCK), 0, -1):
        if batch % d == 0:
            return d
    return 1


def padded_batch(batch: int) -> int:
    """Flat batch size after zero-padding to the step-minimising block
    (pure mirror of ``engine.padded_batch``): keep ``batch`` blocked by its
    largest divisor, or round up to full-width blocks, whichever walks
    fewer grid-step groups; ties keep the unpadded batch."""
    if batch <= 0:
        return batch
    bz_pad = min(batch, MAX_BATCH_BLOCK)
    groups_pad = -(-batch // bz_pad)
    if groups_pad < batch // batch_block(batch):
        return groups_pad * bz_pad
    return batch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission + coalescing + interleave knobs."""

    max_queue_depth: int = 64     # admission control: submits beyond this
    # are shed (REJECTED, counted in ``rejected``)
    max_in_flight: int = 2        # groups admitted to the engine at once
    max_batch: int = 8            # requests coalesced per prefill call
    min_batch: int = 1            # hold a prefill until this many same-
    # shape requests wait (overridden by max_wait_s or an idle engine)
    max_wait_s: float = 0.05      # batch-formation timeout: the oldest
    # compatible request never waits longer than this for co-riders
    policy: str = "prefill-first"   # interleave: which action wins when
    # both a formable batch and a decodable group exist

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.max_batch < 1 or self.min_batch < 1:
            raise ValueError("max_batch and min_batch must be >= 1")
        if self.min_batch > self.max_batch:
            raise ValueError(f"min_batch={self.min_batch} > "
                             f"max_batch={self.max_batch}")


@dataclasses.dataclass
class Group:
    """A coalesced ragged batch: ``len(requests)`` live rows padded to
    ``padded_size`` slots on the engine's batch-block grid."""

    gid: int
    requests: List[Request]
    prompt_len: int
    max_gen: int
    padded_size: int
    formed_s: float
    state: str = G_PREFILL
    steps_done: int = 0           # decode steps completed so far

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def pad_slots(self) -> int:
        return self.padded_size - self.size

    @property
    def remaining_steps(self) -> int:
        """Decode steps still owed (prefill supplies token 1 of max_gen)."""
        return max(self.max_gen - 1 - self.steps_done, 0)

    @property
    def active_requests(self) -> List[Request]:
        return [r for r in self.requests if r.state == ACTIVE]


@dataclasses.dataclass(frozen=True)
class Prefill:
    """Run one coalesced prefill for ``group`` (launch decision already
    taken: the member requests left the queue when this was returned)."""
    group: Group


@dataclasses.dataclass(frozen=True)
class Decode:
    """Run one decode step for ``group`` (every active member advances by
    one token)."""
    group: Group


Action = Union[Prefill, Decode]


class Scheduler:
    """The injectable-clock state machine; all methods take ``now``."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.cfg = config or SchedulerConfig()
        self._queue: List[Request] = []
        self._groups: Dict[int, Group] = {}
        self._next_gid = 0
        self.completed: List[Request] = []
        self.counters: Dict[str, int] = {
            "admitted": 0, "rejected": 0, "evicted": 0, "completed": 0,
            "prefill_batches": 0, "decode_steps": 0, "padded_slots": 0,
        }

    # -- introspection -------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        """Groups occupying the engine (prefilling or decoding)."""
        return sum(1 for g in self._groups.values() if g.state != G_DONE)

    @property
    def active_requests(self) -> int:
        return sum(len(g.active_requests) for g in self._groups.values()
                   if g.state != G_DONE)

    @property
    def pending(self) -> bool:
        """Work left: queued requests or undrained groups."""
        return bool(self._queue) or self.in_flight > 0

    def group(self, gid: int) -> Group:
        return self._groups[gid]

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request, now: float) -> bool:
        """Admit ``req`` or shed it (queue-depth admission control).

        Returns True when admitted.  A shed request transitions straight to
        REJECTED and is counted — the caller surfaces ``serve.rejected``.
        """
        if req.state != QUEUED or req.admitted_s is not None:
            raise ValueError(f"request {req.rid} resubmitted in state "
                             f"{req.state!r}")
        if len(self._queue) >= self.cfg.max_queue_depth:
            req.state = REJECTED
            self.counters["rejected"] += 1
            return False
        req.admitted_s = now
        self.counters["admitted"] += 1
        self._queue.append(req)
        return True

    # -- deadline eviction ---------------------------------------------------

    def _evict_expired(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline passed before they were ever
        scheduled (they would burn a prefill slot to produce a late
        answer); active requests are evicted at the next step boundary in
        :meth:`note_decode_done`."""
        evicted = [r for r in self._queue if r.expired(now)]
        if evicted:
            self._queue = [r for r in self._queue if not r.expired(now)]
            for r in evicted:
                r.state = EVICTED
                r.finish_s = now
                self.counters["evicted"] += 1
        return evicted

    # -- coalescing ----------------------------------------------------------

    def _formable(self, now: float) -> List[Request]:
        """The FIFO-ordered same-shape set a prefill would coalesce now
        (empty when the batch should keep waiting for co-riders).

        Keyed on the *head* request's shape: strict FIFO across shapes
        (the head is never overtaken by a younger, more popular shape),
        shape-keyed FIFO within one (same-shape co-riders may ride the
        head's batch past older incompatible requests — they join its
        call, they do not displace it).
        """
        if not self._queue or self.in_flight >= self.cfg.max_in_flight:
            return []
        key = self._queue[0].shape_key
        ready = [r for r in self._queue if r.shape_key == key]
        ready = ready[:self.cfg.max_batch]
        full = len(ready) >= self.cfg.max_batch
        waited = now - ready[0].admitted_s >= self.cfg.max_wait_s
        idle = not self._decodable()
        if len(ready) >= self.cfg.min_batch or full or waited or idle:
            return ready
        return []

    def _form_group(self, ready: List[Request], now: float) -> Group:
        taken = set(id(r) for r in ready)
        self._queue = [r for r in self._queue if id(r) not in taken]
        gid = self._next_gid
        self._next_gid += 1
        group = Group(gid=gid, requests=list(ready),
                      prompt_len=ready[0].prompt_len,
                      max_gen=max(r.gen_len for r in ready),
                      padded_size=padded_batch(len(ready)),
                      formed_s=now)
        for r in ready:
            r.state = ACTIVE
            r.group_id = gid
            r.prefill_start_s = now
        self._groups[gid] = group
        self.counters["prefill_batches"] += 1
        self.counters["padded_slots"] += group.pad_slots
        return group

    def _decodable(self) -> Optional[Group]:
        """Oldest group with decode work left (FIFO over groups)."""
        for gid in sorted(self._groups):
            g = self._groups[gid]
            if g.state == G_DECODE and g.remaining_steps > 0 \
                    and g.active_requests:
                return g
        return None

    # -- the decision point --------------------------------------------------

    def poll(self, now: float) -> Optional[Action]:
        """Next engine action, or None when idle.

        Deadline-expired queued requests are evicted first.  Then the
        interleave policy arbitrates: ``prefill-first`` admits new work as
        soon as a batch is formable (lower TTFT, decode steps yield),
        ``decode-first`` drains in-flight tokens before growing the working
        set (lower per-token jitter, batches form fatter while waiting).
        Either way a formable batch fires when it is full, when its head
        request has waited ``max_wait_s``, or when the engine would
        otherwise idle — and a decodable group runs when no batch fires.
        """
        self._evict_expired(now)
        ready = self._formable(now)
        dec = self._decodable()
        if self.cfg.policy == "prefill-first":
            if ready:
                return Prefill(self._form_group(ready, now))
            if dec is not None:
                return Decode(dec)
        else:   # decode-first
            if dec is not None:
                return Decode(dec)
            if ready:
                return Prefill(self._form_group(ready, now))
        return None

    # -- completion callbacks ------------------------------------------------

    def _finish(self, req: Request, now: float) -> None:
        req.state = DONE
        req.finish_s = now
        self.completed.append(req)
        self.counters["completed"] += 1

    def note_prefill_done(self, gid: int, now: float) -> List[Request]:
        """Prefill landed: every member has its first token.  Returns the
        requests that finished outright (``gen_len == 1``)."""
        group = self._groups[gid]
        if group.state != G_PREFILL:
            raise ValueError(f"group {gid} not awaiting prefill "
                             f"(state {group.state!r})")
        finished = []
        for r in group.requests:
            r.first_token_s = now
            if r.gen_len <= 1:
                self._finish(r, now)
                finished.append(r)
        group.state = G_DECODE
        if group.remaining_steps == 0 or not group.active_requests:
            group.state = G_DONE
        return finished

    def note_decode_done(self, gid: int, now: float) -> List[Request]:
        """One decode step landed: every active member gained one token.
        Early-exits members whose budget is met, evicts deadline-expired
        ones, and drains the group at ``max_gen``.  Returns the requests
        that finished this step (DONE ones only; evictions are counted but
        not returned — their tokens were already short)."""
        group = self._groups[gid]
        if group.state != G_DECODE:
            raise ValueError(f"group {gid} not decoding "
                             f"(state {group.state!r})")
        group.steps_done += 1
        self.counters["decode_steps"] += 1
        finished = []
        for r in group.active_requests:
            if r.gen_len <= 1 + group.steps_done:
                self._finish(r, now)
                finished.append(r)
            elif r.expired(now):
                r.state = EVICTED
                r.finish_s = now
                self.counters["evicted"] += 1
        if group.remaining_steps == 0 or not group.active_requests:
            group.state = G_DONE
        return finished
