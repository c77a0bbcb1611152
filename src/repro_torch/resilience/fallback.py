"""Failure classification and the host-side retry/deadline helper.

Port of part of ``repro/resilience/fallback.py``: :func:`classify` (the
compact reason label of a degradation counter), :class:`DeadlineExceeded`
and :func:`retry_with_backoff`, which the serve queue wraps around its
prefill and decode calls.

Not ported yet: ``run_chain`` and ``FallbackPolicy``, the reference's
per-``(part, op)`` engine chain ``pallas → interpret → jnp``.  Ported as it
stands, its default chain would hide a kernel that fails to build or launch
behind the plain path; in the port such a kernel raises.
"""
from __future__ import annotations

import time
from typing import Callable

from .inject import InjectedFault, InjectedTimeout

__all__ = ["classify", "retry_with_backoff", "DeadlineExceeded"]


def classify(exc: BaseException) -> str:
    """Compact counter-label reason for a failure."""
    if isinstance(exc, InjectedTimeout):
        return "timeout"
    if isinstance(exc, InjectedFault):
        return "injected"
    if isinstance(exc, TimeoutError):
        return "timeout"
    return type(exc).__name__


class DeadlineExceeded(TimeoutError):
    """A retried call ran out of its deadline budget."""


def retry_with_backoff(fn: Callable, *args, retries: int = 2,
                       backoff_s: float = 0.01, deadline_s: float | None = None,
                       on_retry: Callable[[int, BaseException], None] | None
                       = None, **kwargs):
    """Call ``fn(*args, **kwargs)``; on failure retry up to ``retries``
    times with exponential backoff (``backoff_s`` doubling per attempt).

    ``deadline_s`` bounds the *total* wall clock: a retry that cannot start
    before the deadline raises :class:`DeadlineExceeded` from the last
    failure instead of sleeping past it.  ``on_retry(attempt, exc)`` fires
    before each backoff sleep — the serving launcher counts degradations
    there.
    """
    t0 = time.perf_counter()
    delay = backoff_s
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:        # noqa: BLE001 - retry IS the handler
            attempt += 1
            if attempt > retries:
                raise
            if deadline_s is not None \
                    and time.perf_counter() - t0 + delay > deadline_s:
                raise DeadlineExceeded(
                    f"deadline {deadline_s:.3f}s exhausted after "
                    f"{attempt} attempt(s)") from e
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
            delay *= 2
