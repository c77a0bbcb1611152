"""Engine fallback chains, failure classification and the host-side
retry/deadline helper.

Port of ``repro/resilience/fallback.py``.  The LOOPS design always has a
slower-but-correct way to run any matrix: the flat PyTorch references of
``kernels/ref.py``, the oracle the tests hold the kernels against.  This
module encodes that as a per-``(part, op)`` **fallback chain**

    cuda → torch

walked by :func:`run_chain`: the engine entry points
(``kernels/engine.py``'s ``csr_spmm``, ``bcsr_spmm``, ``loops_spmm_fused``
and ``loops_sdd``) wrap each backend's dispatch in an ``attempt(link)``
closure, and a failing attempt degrades to the next link with an
``engine.fallback{part,op,reason}`` counter.  The fused chain is the same
as the others: its ``torch`` link is the flat product (both parts through
the flat references), so the port needs no two-pass parts path to fall
back on (the reference's fused chain ends at ``interpret``, and its caller
re-runs the parts).

**Off unless asked for.**  Unlike the reference, whose process policy
starts enabled, the port's starts as ``FallbackPolicy(enabled=False)``,
whatever the environment: a kernel that fails to build or launch raises.
The only way to turn the chains on is ``set_policy(FallbackPolicy())``
(the dataclass's own default stays ``enabled=True``, so ``chain_for``
gives the reference's answers); :func:`disabled` turns them off for a
block.

**What a chain can catch.**  Only what raises synchronously, in the
calling thread: an extension that does not build, a wrapper's shape or
dtype check, a launch-configuration error, an injected fault.  CUDA
reports most kernel faults asynchronously, at a later synchronising call,
and a sticky error (an illegal address) poisons the context, so the
``torch`` link on the same device would fail too; the chain adds no
synchronisation per call to catch such errors, which would cost every call
on the hot path.  While the current stream is being captured into a CUDA
graph (the serve executor pool, ``dist/step.py``) :func:`run_chain`
re-raises instead of degrading: a capture that fails keeps raising, and
no plain version is baked into a graph in the kernel's place.

:func:`retry_with_backoff` is the host-side half: transient *step* failures
(serving) retry with exponential backoff under an optional deadline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Tuple

import torch

from .inject import (InjectedFault, InjectedTimeout, fault_point,
                     note_degraded)

__all__ = ["DEFAULT_CHAIN", "CHAIN_OVERRIDES", "FallbackPolicy",
           "get_policy", "set_policy", "disabled", "run_chain", "classify",
           "retry_with_backoff", "DeadlineExceeded"]

# The canonical degradation order: the kernels first, the oracle last.
DEFAULT_CHAIN: Tuple[str, ...] = ("cuda", "torch")

# Per-(part, op) overrides.  The reference overrides the fused chain, which
# has no jnp link; the port's fused chain ends at the flat product, so it
# needs none.
CHAIN_OVERRIDES: Dict[Tuple[str, str], Tuple[str, ...]] = {}


@dataclasses.dataclass
class FallbackPolicy:
    """Which chain each ``(part, op)`` walks, and whether chains are live."""

    enabled: bool = True
    chains: Dict[Tuple[str, str], Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(CHAIN_OVERRIDES))

    def chain_for(self, part: str, op: str, backend: str) -> Tuple[str, ...]:
        """The chain starting at the caller's resolved ``backend`` — a
        caller already on a degraded link never climbs back up."""
        if not self.enabled:
            return (backend,)
        chain = self.chains.get((part, op), DEFAULT_CHAIN)
        if backend in chain:
            return chain[chain.index(backend):]
        return (backend,)


# The process policy: chains off until a caller opts in (module docstring).
_POLICY = FallbackPolicy(enabled=False)


def get_policy() -> FallbackPolicy:
    return _POLICY


def set_policy(policy: FallbackPolicy) -> FallbackPolicy:
    """Install ``policy`` process-wide; returns the previous one."""
    global _POLICY
    prev, _POLICY = _POLICY, policy
    return prev


@contextlib.contextmanager
def disabled():
    """Temporarily make every chain single-link (failures propagate)."""
    prev = set_policy(FallbackPolicy(enabled=False))
    try:
        yield
    finally:
        set_policy(prev)


def classify(exc: BaseException) -> str:
    """Compact counter-label reason for a failure."""
    if isinstance(exc, InjectedTimeout):
        return "timeout"
    if isinstance(exc, InjectedFault):
        return "injected"
    if isinstance(exc, TimeoutError):
        return "timeout"
    return type(exc).__name__


def _capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph
    (never, in a process that has not initialised CUDA)."""
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def run_chain(part: str, op: str, backend: str,
              attempt: Callable[[str], object], *, site: str | None = None):
    """Walk the ``(part, op)`` chain from ``backend``: call
    ``attempt(link)`` per link, degrading on any exception with an
    ``engine.fallback`` counter; re-raise the last failure when the chain
    is exhausted, and at once while a CUDA graph is being captured.  Each
    attempt passes through a ``engine.{part}.{op}.{link}`` fault point
    first (the chaos harness fails *attempts*, so an injected first-link
    fault proves the degradation end to end)."""
    site = site or f"engine.{part}.{op}"
    chain = get_policy().chain_for(part, op, backend)
    last_exc: BaseException | None = None
    for i, link in enumerate(chain):
        if i:
            note_degraded("engine.fallback", part=part, op=op,
                          reason=classify(last_exc))
        try:
            fault_point(f"{site}.{link}")
            return attempt(link)
        except Exception as e:        # noqa: BLE001 - the chain IS the handler
            if _capturing():
                raise
            last_exc = e
    raise last_exc


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
