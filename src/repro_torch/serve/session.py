"""Per-request serving state: lifecycle, shape key, latency accounting.

A copy of ``repro/serve/session.py`` (the port keeps its own: it never
imports the reference package).  A :class:`Request` is the unit the
continuous-batching layer schedules.  This module is deliberately
array-free (so is ``scheduler.py``): the whole policy surface --
admission, coalescing, fairness, deadlines -- is plain Python over these
records, unit-testable with a fake clock.  The queue layer
(``repro_torch.serve.queue``) owns everything that touches devices and
fills in the token/wall-clock fields here.

Two time domains, two sets of fields:

  * ``*_s`` -- the **scheduler clock** (whatever ``now`` the caller passes:
    wall seconds in production, a fake or virtual clock in tests).  Every
    scheduling decision -- admission, batch-formation timeouts, deadline
    eviction -- reads only these.
  * ``wall_*_s`` -- the **wall clock**, stamped by the queue layer around
    real engine calls.  Latency *reporting* (request latency,
    time-to-first-token) reads only these.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

__all__ = ["Request", "make_request", "QUEUED", "ACTIVE", "DONE",
           "REJECTED", "EVICTED", "TERMINAL_STATES"]

# Request lifecycle.  QUEUED -> ACTIVE (group formed, prefill launched) ->
# DONE; QUEUED -> REJECTED (admission shed) | EVICTED (deadline passed);
# ACTIVE -> EVICTED (deadline passed mid-decode: the slot idles, the group
# keeps stepping for its remaining members).
QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
REJECTED = "rejected"
EVICTED = "evicted"
TERMINAL_STATES = (DONE, REJECTED, EVICTED)

_RID = itertools.count()


@dataclasses.dataclass(eq=False)   # identity semantics: the scheduler and
# queue track requests by object, never by field equality
class Request:
    """One generation request: a prompt, a token budget, and the lifecycle
    timestamps of the latency-accounting contract."""

    rid: int
    prompt_len: int
    gen_len: int                      # total tokens wanted (>= 1; the first
    # comes out of the coalesced prefill, the rest out of decode steps)
    arrival_s: float                  # scheduler clock at submit()
    deadline_s: Optional[float] = None   # absolute scheduler-clock deadline
    prompt: Optional[Tuple[int, ...]] = None   # token ids; None = metadata-
    # only request (pure scheduler tests never materialise tokens)
    state: str = QUEUED

    # scheduler-clock milestones (set by the scheduler)
    admitted_s: Optional[float] = None
    prefill_start_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None

    # wall-clock milestones (set by the queue around engine calls)
    wall_arrival_s: Optional[float] = None
    wall_first_token_s: Optional[float] = None
    wall_finish_s: Optional[float] = None

    # outputs (filled by the queue layer)
    tokens: List[int] = dataclasses.field(default_factory=list)
    group_id: Optional[int] = None

    # -- shape / scheduling --------------------------------------------------

    @property
    def shape_key(self) -> Tuple[int, ...]:
        """Coalescing key: requests sharing it may ride one ragged batch.

        Only the prompt length participates — batch rows are independent in
        every model family, so ragged *batch* padding is exact, but ragged
        *sequence* padding is not (causal attention sees pad positions), so
        mixed prompt lengths never share a prefill call.  Mixed ``gen_len``
        within a group is fine: short requests exit early and their slot
        idles until the group drains.
        """
        return (self.prompt_len,)

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s

    # -- latency accounting (scheduler clock) --------------------------------

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.prefill_start_s is None or self.admitted_s is None:
            return None
        return self.prefill_start_s - self.admitted_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    # -- latency accounting (wall clock; what the obs histograms carry) ------

    @property
    def wall_ttft_s(self) -> Optional[float]:
        if self.wall_first_token_s is None or self.wall_arrival_s is None:
            return None
        return self.wall_first_token_s - self.wall_arrival_s

    @property
    def wall_e2e_s(self) -> Optional[float]:
        if self.wall_finish_s is None or self.wall_arrival_s is None:
            return None
        return self.wall_finish_s - self.wall_arrival_s

    @property
    def tokens_generated(self) -> int:
        return len(self.tokens)

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL_STATES


def make_request(*, prompt: Optional[Sequence[int]] = None,
                 prompt_len: Optional[int] = None, gen_len: int = 1,
                 now: float = 0.0, deadline_s: Optional[float] = None,
                 rid: Optional[int] = None) -> Request:
    """Build a :class:`Request`; either concrete ``prompt`` token ids or a
    bare ``prompt_len`` (scheduler-only tests).  ``gen_len`` counts the
    total tokens generated, prefill's first token included."""
    if prompt is None and prompt_len is None:
        raise ValueError("need prompt token ids or an explicit prompt_len")
    if prompt is not None:
        prompt = tuple(int(t) for t in prompt)
        if prompt_len is not None and prompt_len != len(prompt):
            raise ValueError(f"prompt_len={prompt_len} contradicts "
                             f"len(prompt)={len(prompt)}")
        prompt_len = len(prompt)
    if prompt_len <= 0:
        raise ValueError(f"prompt_len must be positive, got {prompt_len}")
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    return Request(rid=next(_RID) if rid is None else rid,
                   prompt_len=int(prompt_len), gen_len=int(gen_len),
                   arrival_s=float(now), deadline_s=deadline_s,
                   prompt=prompt)
