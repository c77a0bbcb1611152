"""Continuous-batching serving layer of the port.

Split along the device boundary, as in the reference:

  * :mod:`.session` / :mod:`.scheduler` -- pure Python request lifecycle
    and the injectable-clock scheduling state machine (admission,
    shape-keyed coalescing, prefill/decode interleave), copies of the
    reference's modules; no array library in their import chain.
  * :mod:`.queue` -- the device half: ``ServeQueue`` turns scheduler
    actions into coalesced prefill/decode calls of
    :mod:`repro_torch.models.api`.

``repro_torch.launch.serve`` is the CLI over this package.
"""
from .scheduler import (MAX_BATCH_BLOCK, POLICIES, Decode, Group, Prefill,
                        Scheduler, SchedulerConfig, batch_block,
                        padded_batch)
from .session import (ACTIVE, DONE, EVICTED, QUEUED, REJECTED,
                      TERMINAL_STATES, Request, make_request)

__all__ = [
    "Scheduler", "SchedulerConfig", "Group", "Prefill", "Decode",
    "batch_block", "padded_batch", "MAX_BATCH_BLOCK", "POLICIES",
    "Request", "make_request", "QUEUED", "ACTIVE", "DONE", "REJECTED",
    "EVICTED", "TERMINAL_STATES",
]
