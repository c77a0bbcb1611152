"""The device half of continuous batching: coalesced engine calls.

Port of ``repro/serve/queue.py``.  ``ServeQueue`` joins the pure scheduler
(:mod:`.scheduler`) to the model's prefill and decode entry points
(:mod:`repro_torch.models.api`):

  * **ragged batching** -- a :class:`~.scheduler.Group`'s live requests
    are stacked on the batch axis and zero-padded to the engine's
    batch-block grid (``scheduler.padded_batch``, the pure mirror of
    ``kernels/engine.py``); batch rows are independent, so padding is
    exact -- the pad rows' outputs are dropped.
  * **two clocks** -- scheduling decisions run on the injectable
    ``clock``; latency accounting always on the wall clock: the request's
    ``wall_*`` fields, :attr:`ServeQueue.engine_s` (the wall seconds of
    every prefill and decode call, each ending in a device-to-host copy of
    its logits, which waits for the device) and, with ``obs=``, the
    reference's per-request ``serve.request_us`` / ``serve.ttft_us`` /
    ``serve.prefill_us`` / ``serve.decode_token_us`` histograms (the
    latter two observe the very intervals ``engine_s`` keeps),
    ``serve.queue_depth`` / ``serve.in_flight`` gauges and
    ``serve.requests`` / ``serve.prefill_calls`` / ``serve.decode_calls`` /
    ``serve.rejected`` / ``serve.evicted`` counters.  With ``obs=`` or
    ``recorder=`` (a :class:`repro_torch.perf.trace.TraceRecorder`) every
    prefill and decode call is also wrapped as the reference's
    ``dist/step.py`` wraps its step functions (a ``step.{op}`` span and
    ``step.wall_us`` histogram; a ``step`` trace record).
  * **resilience** -- every engine call passes the ``serve.prefill`` /
    ``serve.step`` fault points and retries with backoff under
    ``retry_kw`` (:func:`repro_torch.resilience.retry_with_backoff`).

Changes from the reference:

  * The queue holds the model (an ``nn.Module``) and its device instead
    of a mesh and an ``ExecutorPool``: the pool caches ``jax.jit``
    executables per shape bucket, and eager PyTorch has nothing to cache.
    A per-bucket CUDA-graph pool is later work (ROADMAP A.13).
  * Sampling reads only the first ``cfg.vocab_size`` logits of a row, so
    a padded vocabulary id is never returned (llama3.2-1b's vocabulary
    needs no padding, so its streams equal the reference's).

Sampling is host-side and *batch-composition independent*:
:func:`sample_token` is the reference's, verbatim -- greedy argmax, or for
``temperature > 0`` a per-request Gumbel draw seeded by
``(seed, rid, token_index)`` -- so the same request yields the same tokens
whether it rode a coalesced batch or ran alone, and both packages emit
identical streams from identical logits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import api
from ..resilience.fallback import retry_with_backoff
from ..resilience.inject import fault_point
from .scheduler import (G_DONE, Decode, Group, Prefill, Scheduler,
                        SchedulerConfig)
from .session import DONE, Request, make_request

__all__ = ["ServeQueue", "pad_cache", "sample_token", "DEFAULT_LEN_QUANTUM"]

# Decode-capacity quantum: a group's cache length is its prompt plus
# max_gen rounded up to this (the reference's value, which there lets
# nearby generation budgets share one compiled executor).
DEFAULT_LEN_QUANTUM = 8


def pad_cache(cfg, cache: Dict[str, torch.Tensor],
              max_len: int) -> Dict[str, torch.Tensor]:
    """Grow the prefill cache's sequence axis to ``max_len`` (headroom for
    decode) with zeros.  (The reference also caps a sliding-window cache at
    its window; the port runs no windowed model.)"""
    out = {}
    for name, x in cache.items():
        if name in ("k", "v") and x.ndim == 5 and x.shape[2] < max_len:
            grown = x.new_zeros(x.shape[:2] + (max_len,) + x.shape[3:])
            grown[:, :, :x.shape[2]] = x
            x = grown
        out[name] = x
    return out


def sample_token(logits_row: np.ndarray, *, temperature: float, seed: int,
                 rid: int, index: int) -> int:
    """Sample one token from a single request's logits row.

    Greedy at ``temperature <= 0``; otherwise a Gumbel-max draw whose
    randomness is a pure function of ``(seed, rid, index)`` — never of the
    batch the row rode in — so batched and sequential execution of the same
    request emit identical streams (the parity contract)."""
    row = np.asarray(logits_row, np.float64)
    if temperature <= 0:
        return int(np.argmax(row))
    rng = np.random.default_rng([abs(int(seed)), int(rid), int(index)])
    u = rng.random(row.shape[0])
    gumbel = -np.log(-np.log(u + 1e-20) + 1e-20)
    return int(np.argmax(row / temperature + gumbel))


def _maybe_record(fn, recorder, op: str, obs=None):
    """Wrap a step function with the perf-trace recorder and/or a live obs
    capture (no-op without either), as the reference's
    ``dist/step.py::_maybe_record`` does: obs wraps outermost, so its span
    brackets the recorder's timing too."""
    if recorder is not None:
        fn = recorder.wrap_step(fn, op=op)
    if obs is not None:
        fn = obs.wrap_step(fn, op=op)
    return fn


@dataclasses.dataclass
class _GroupRuntime:
    """Device-side state of an in-flight group between engine calls."""

    cache: Dict[str, torch.Tensor]
    toks: np.ndarray        # (padded_batch, 1) int64 — next step's inputs
    pos0: int               # absolute position of the first decode write


class ServeQueue:
    """Continuous-batching front end over the model's prefill and decode.

    ``params`` is the model (:func:`repro_torch.models.api.init_params`);
    every engine call runs on its device.  ``obs`` (a
    :class:`repro_torch.obs.Obs`) and ``recorder`` (a
    :class:`repro_torch.perf.trace.TraceRecorder`) instrument the run;
    ``retry_kw`` are :func:`repro_torch.resilience.retry_with_backoff`'s
    keywords for every engine call (default: no retry)."""

    def __init__(self, cfg, params, *,
                 scheduler: Optional[Scheduler] = None,
                 config: Optional[SchedulerConfig] = None,
                 obs=None, recorder=None,
                 clock: Callable[[], float] = time.perf_counter,
                 temperature: float = 0.0, seed: int = 0,
                 len_quantum: int = DEFAULT_LEN_QUANTUM,
                 retry_kw: Optional[Dict[str, Any]] = None,
                 record_logits: bool = False):
        if scheduler is not None and config is not None:
            raise ValueError("pass scheduler= or config=, not both")
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.sched = scheduler or Scheduler(config)
        self.obs = obs
        self._prefill_fn = _maybe_record(
            lambda p, batch: api.prefill(cfg, p, batch), recorder,
            "prefill", obs)
        self._decode_fn = _maybe_record(
            lambda p, cache, toks, pos: api.decode_step(cfg, p, cache, toks,
                                                        pos),
            recorder, "decode", obs)
        self.clock = clock
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.len_quantum = max(int(len_quantum), 1)
        self.retry_kw = dict(retry_kw) if retry_kw else {"retries": 0}
        self.record_logits = record_logits
        self.logits_log: Dict[int, List[np.ndarray]] = {}
        self.completed: List[Request] = []
        self.engine_s: Dict[str, List[float]] = {"prefill": [],
                                                 "decode": []}
        self._rt: Dict[int, _GroupRuntime] = {}
        self._seen = {k: 0 for k in ("rejected", "evicted")}

    # -- obs plumbing --------------------------------------------------------

    def _observe(self, name: str, us: float, n: int = 1) -> None:
        if self.obs is not None:
            h = self.obs.histogram(name)
            for _ in range(max(n, 1)):
                h.observe(us)

    def _sync_counters(self) -> None:
        """Mirror scheduler-side sheds/evictions into obs counters (delta
        sync: the scheduler is obs-free by design) and refresh gauges."""
        if self.obs is None:
            return
        for key, metric in (("rejected", "serve.rejected"),
                            ("evicted", "serve.evicted")):
            delta = self.sched.counters[key] - self._seen[key]
            if delta > 0:
                self.obs.counter(metric).inc(delta)
                self._seen[key] = self.sched.counters[key]
        self.obs.gauge("serve.queue_depth").set(self.sched.queue_depth)
        self.obs.gauge("serve.in_flight").set(self.sched.in_flight)

    # -- submission ----------------------------------------------------------

    def submit(self, prompt: Sequence[int], gen_len: int, *,
               deadline_s: Optional[float] = None,
               now: Optional[float] = None,
               rid: Optional[int] = None) -> Request:
        """Admit one request (or shed it: ``req.state == REJECTED``).

        ``now`` defaults to the scheduling clock; ``deadline_s`` is
        absolute on that clock.  ``rid`` pins the request id, and with it
        the sampling stream keyed on ``(seed, rid, token_index)``."""
        now = self.clock() if now is None else now
        req = make_request(prompt=prompt, gen_len=gen_len, now=now,
                           deadline_s=deadline_s, rid=rid)
        req.wall_arrival_s = time.perf_counter()
        self.sched.submit(req, now)
        self._sync_counters()
        return req

    # -- group execution -----------------------------------------------------

    def _max_len(self, group: Group) -> int:
        q = self.len_quantum
        return group.prompt_len + -(-group.max_gen // q) * q

    def _sample_rows(self, logits: np.ndarray, group: Group,
                     index_of: Callable[[Request], int]) -> np.ndarray:
        """Next-token column for every slot; live rows sample per-request
        over the real vocabulary, pad rows (whose outputs are discarded)
        take the argmax."""
        logits = logits[:, :self.cfg.vocab_size]
        toks = np.zeros((logits.shape[0], 1), np.int64)
        for i in range(logits.shape[0]):
            if i < group.size:
                r = group.requests[i]
                toks[i, 0] = sample_token(
                    logits[i], temperature=self.temperature, seed=self.seed,
                    rid=r.rid, index=index_of(r))
            else:
                toks[i, 0] = int(np.argmax(logits[i]))
        return toks

    def _run_prefill(self, group: Group, now: float) -> List[Request]:
        tokens = np.zeros((group.padded_size, group.prompt_len), np.int64)
        for i, r in enumerate(group.requests):
            tokens[i] = np.asarray(r.prompt, np.int64)
        batch = {"tokens": torch.as_tensor(tokens, device=self.device)}

        def call():
            fault_point("serve.prefill")
            return self._prefill_fn(self.params, batch)

        t0 = time.perf_counter()
        cache, logits = retry_with_backoff(call, **self.retry_kw)
        logits_np = logits.cpu().numpy()
        dt = time.perf_counter() - t0
        self.engine_s["prefill"].append(dt)
        cache = pad_cache(self.cfg, cache, self._max_len(group))
        wall = time.perf_counter()
        toks = self._sample_rows(logits_np, group, lambda r: 0)
        for i, r in enumerate(group.requests):
            r.tokens.append(int(toks[i, 0]))
            r.wall_first_token_s = wall
            if self.record_logits:
                self.logits_log.setdefault(r.rid, []).append(
                    logits_np[i].copy())
        # Every rider experienced the coalesced call's latency — one
        # observation per request.
        self._observe("serve.prefill_us", dt * 1e6, group.size)
        if self.obs is not None:
            self.obs.counter("serve.requests").inc(group.size)
            self.obs.counter("serve.prefill_calls").inc()
        finished = self.sched.note_prefill_done(group.gid, now)
        self._note_finished(finished, wall)
        if group.state != G_DONE:
            self._rt[group.gid] = _GroupRuntime(cache=cache, toks=toks,
                                                pos0=group.prompt_len)
        return finished

    def _run_decode(self, group: Group, now: float) -> List[Request]:
        rt = self._rt[group.gid]
        pos = rt.pos0 + group.steps_done
        was_active = list(group.active_requests)
        step_toks = torch.as_tensor(rt.toks, device=self.device)

        def call():
            # the fault point fires before the engine call, so a retried
            # step reuses an untouched cache
            fault_point("serve.step")
            return self._decode_fn(self.params, rt.cache, step_toks, pos)

        t0 = time.perf_counter()
        rt.cache, logits = retry_with_backoff(call, **self.retry_kw)
        logits_np = logits.cpu().numpy()
        dt = time.perf_counter() - t0
        self.engine_s["decode"].append(dt)
        wall = time.perf_counter()
        step_index = group.steps_done + 1   # token index this step emits
        toks = self._sample_rows(logits_np, group, lambda r: step_index)
        for i, r in enumerate(group.requests):
            if r in was_active:
                r.tokens.append(int(toks[i, 0]))
                if self.record_logits:
                    self.logits_log.setdefault(r.rid, []).append(
                        logits_np[i].copy())
        rt.toks = toks
        # per-token decode latency: the step's wall clock is what every
        # still-active rider waited for its next token
        self._observe("serve.decode_token_us", dt * 1e6, len(was_active))
        if self.obs is not None:
            self.obs.counter("serve.decode_calls").inc()
        finished = self.sched.note_decode_done(group.gid, now)
        self._note_finished(finished, wall)
        if group.state == G_DONE:
            self._rt.pop(group.gid, None)
        return finished

    def _note_finished(self, finished: List[Request], wall: float) -> None:
        for r in finished:
            r.wall_finish_s = wall
            if r.state == DONE:
                self.completed.append(r)
                if r.wall_e2e_s is not None:
                    self._observe("serve.request_us", r.wall_e2e_s * 1e6)
                if r.wall_ttft_s is not None:
                    self._observe("serve.ttft_us", r.wall_ttft_s * 1e6)

    # -- the drive loop ------------------------------------------------------

    @property
    def pending(self) -> bool:
        return self.sched.pending

    def step(self, now: Optional[float] = None) -> bool:
        """Run the scheduler's next engine action (one coalesced prefill or
        one decode step); returns False when the engine would idle."""
        now = self.clock() if now is None else now
        action = self.sched.poll(now)
        if action is None:
            self._sync_counters()
            return False
        if isinstance(action, Prefill):
            self._run_prefill(action.group, now)
        elif isinstance(action, Decode):
            self._run_decode(action.group, now)
        self._sync_counters()
        return True

    def drain(self, max_steps: int = 1_000_000) -> List[Request]:
        """Step until idle (bounded by ``max_steps``); returns every
        request completed so far, submission order preserved."""
        steps = 0
        while self.pending and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return list(self.completed)
