"""The device half of continuous batching: coalesced engine calls.

Port of ``repro/serve/queue.py``.  ``ServeQueue`` joins the pure scheduler
(:mod:`.scheduler`) to the static-buffer prefill and decode steps of
:mod:`repro_torch.dist.step`, through a warm :class:`ExecutorPool`:

  * **ragged batching** -- a :class:`~.scheduler.Group`'s live requests
    are stacked on the batch axis and zero-padded to the engine's
    batch-block grid (``scheduler.padded_batch``, the pure mirror of
    ``kernels/engine.py``); batch rows are independent, so padding is
    exact -- the pad rows' outputs are dropped.
  * **warm executor pool** -- :class:`ExecutorPool` keeps one bundle per
    ``(padded_batch, prompt_len, max_len)`` shape bucket, as the
    reference's does.  On the card each bucket's prefill and decode step
    are CUDA graphs replayed over static buffers, so a steady-state step
    pays a few copies and one graph launch instead of one launch per
    operation; ``warm()`` pays the captures before traffic.
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
    ``recorder=`` (a :class:`repro_torch.perf.trace.TraceRecorder`) the
    pool's prefill and decode functions are wrapped as the reference's
    ``dist/step.py`` wraps its step functions (a ``step.{op}`` span and
    ``step.wall_us`` histogram; a ``step`` trace record).
  * **resilience** -- every engine call passes the ``serve.prefill`` /
    ``serve.step`` fault points, before the replay, and retries with
    backoff under ``retry_kw``
    (:func:`repro_torch.resilience.retry_with_backoff`); a retried step
    finds its cache untouched.

Changes from the reference:

  * **Decode slots.**  The reference passes a group's cache to its jitted
    step as an argument; a captured graph bakes in the cache's address.
    With ``max_in_flight=2`` two groups of one bucket can be in flight at
    once, so a bucket holds slots: one static cache (KV at ``max_len``, or
    an ssm state; allocated outside the graph pool) and the prefill and
    decode graphs captured over it.  A group takes a free slot (or a new one) for its
    prefill and gives it back when it is done.  The slot's cache is the
    group's only cache: the prefill writes its first ``prompt_len``
    positions, so nothing is padded or copied.  (Copying each group's
    cache into one shared buffer every step would cost more than the
    launches the graph saves.)  ``len(pool)`` and ``pool.builds`` count
    buckets, as the reference's; ``pool.slots`` counts slots.
  * **Launch counts under replay.**  A replay does not call the kernel
    wrappers; each graph adds the launches it captured to B1-B5's
    ``launches`` on every replay (:mod:`repro_torch.dist.step`).
  * **Logits are read before the next replay**: a graph's logits live in
    the graph pool and the next replay of that graph overwrites them, so
    the queue copies them to the host at once.
  * A position past a slot's capacity raises ``ValueError`` on the host
    before any replay (the reference's ``dynamic_update_slice`` clamps).
  * Sampling reads only the first ``cfg.vocab_size`` logits of a row, so
    a padded vocabulary id is never returned (llama3.2-1b's vocabulary
    needs no padding, so its streams equal the reference's).
  * No frontend prefix or stub inputs: the port runs the dense, moe and
    ssm families.  An ssm slot's cache is its state (``{"x_tm", "s",
    "x_cm"}``, one of the bucket's batch): the prefill overwrites it from
    the zero state and each decode step continues it in place, so a slot
    is reused as a KV slot is.
  * **On a mesh, one process a rank.**  The reference is one controller
    over every device; here each rank runs its own process, and ranks
    that scheduled on their own wall clocks (``clock``, ``max_wait_s``)
    would form different groups and pair their collectives wrongly.  So
    rank 0 alone runs the scheduler and sends every engine call to the
    other ranks before it runs it (:class:`ExecutorPool`'s ``call``, one
    broadcast of a small int64 header and one of the payload: the op, the
    bucket, the slot, the position, the fault site, the tokens, and each
    row's request id and token index); the others replay it
    (:meth:`ServeQueue.follow`) until rank 0's :meth:`ServeQueue.stop`.
    Every rank holds the whole ``(batch, vocab)`` logits (the step
    gathers them along the vocabulary and over the data ranks), so every
    rank samples alike with :func:`sample_token`, a pure function of the
    logits and ``(seed, rid, index)``: no second broadcast per step, and
    each rank's ``streams`` are the tokens it would emit.  The next decode
    call carries rank 0's tokens all the same.  At a fault point the ranks
    agree before anyone retries (an all-reduce MAX of a failure flag, the
    rule of ``dist/compress.py``): a fault on any rank makes every rank
    raise, rank 0 retries with backoff under ``retry_kw`` (sending the
    call again) and the others wait for what it sends, so a one-rank
    fault retries on every rank and never hangs.  A slot's steps run
    eagerly under a mesh (a CUDA graph cannot capture a gloo collective),
    which the pool decides when it is built.  A batch that the data ranks
    do not divide is padded to a multiple of them inside the step
    (``dist/step.py``), where the reference's jit raises; the buckets stay
    the reference's.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..dist import sharding as shr
from ..dist import step as step_lib
from ..launch.mesh import flat_axes
from ..models import api
from ..resilience.fallback import retry_with_backoff
from ..resilience.inject import fault_point
from .scheduler import (G_DONE, Decode, Group, Prefill, Scheduler,
                        SchedulerConfig, padded_batch)
from .session import DONE, Request, make_request

__all__ = ["ServeQueue", "ExecutorPool", "RankFault", "pad_cache",
           "sample_token", "DEFAULT_LEN_QUANTUM"]

# Decode-capacity quantum: a group's cache length is its prompt plus
# max_gen rounded up to this, so nearby generation budgets share one
# bucket (the reference's value).
DEFAULT_LEN_QUANTUM = 8


def pad_cache(cfg, cache: Dict[str, torch.Tensor],
              max_len: int) -> Dict[str, torch.Tensor]:
    """Grow the prefill cache's sequence axis to ``max_len`` (headroom for
    decode) with zeros.  State caches (the ssm family's ``{"x_tm", "s",
    "x_cm"}``) are already final-size and pass as they are.  (The
    reference also caps a sliding-window cache at its window; the port
    runs no windowed model.)"""
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


class RankFault(RuntimeError):
    """An engine call's fault point failed on another rank of the mesh."""


# An engine call on the wire: op, then the bucket, the slot, the position,
# the fault site and the payload's length (int64), then the payload: the
# tokens (batch x T), and each batch row's request id and token index for
# sampling (-1: the row emits nothing).
_STOP, _PREFILL, _DECODE = 0, 1, 2
_SITES = (None, "serve.prefill", "serve.step")
_HEADER = 8


class _Wire:
    """Rank 0's engine calls, broadcast to every rank of a mesh (module
    docstring), and the ranks' agreement on a failed fault point.  On gloo
    the wire tensors live on the CPU, on NCCL on the rank's card."""

    def __init__(self, mesh):
        flat = shr.worker_mesh(mesh, flat_axes(mesh))
        self.group = flat.get_group()
        self.leader = flat.get_local_rank() == 0
        self.root = dist.get_global_rank(self.group, 0)
        self.device = (torch.device("cpu")
                       if dist.get_backend(self.group) == "gloo"
                       else torch.device("cuda", torch.cuda.current_device()))

    def send(self, header: Sequence[int], payload: np.ndarray) -> None:
        head = torch.tensor(list(header) + [payload.size], dtype=torch.long)
        dist.broadcast(head.to(self.device), src=self.root, group=self.group)
        if payload.size:
            dist.broadcast(torch.from_numpy(payload).to(self.device),
                           src=self.root, group=self.group)

    def recv(self) -> Tuple[List[int], np.ndarray]:
        head = torch.empty(_HEADER, dtype=torch.long, device=self.device)
        dist.broadcast(head, src=self.root, group=self.group)
        head = head.tolist()
        payload = torch.empty(head[-1], dtype=torch.long, device=self.device)
        if head[-1]:
            dist.broadcast(payload, src=self.root, group=self.group)
        return head[:-1], payload.cpu().numpy()

    def agree(self, failed: bool) -> bool:
        """Whether any rank failed (one all-reduce MAX of a flag)."""
        flag = torch.tensor([int(failed)], dtype=torch.long,
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())


@dataclasses.dataclass(eq=False)
class _Slot:
    """One decode slot of a bucket: its static KV cache and the prefill
    and decode functions built over it (``dist/step.py``)."""

    cache: Dict[str, torch.Tensor]
    prefill_fn: Callable
    serve_fn: Callable


@dataclasses.dataclass
class _Bundle:
    """One shape bucket: ``(padded_batch, prompt_len, max_len)``, with
    its slots (built on first need, reused once free)."""

    batch: int
    prompt_len: int
    max_len: int            # prompt + decode capacity
    slots: List[_Slot] = dataclasses.field(default_factory=list)
    free: List[_Slot] = dataclasses.field(default_factory=list)
    peak_in_use: int = 0

    @property
    def in_use(self) -> int:
        return len(self.slots) - len(self.free)


class ExecutorPool:
    """Build-once cache of static-buffer prefill/decode steps per shape
    bucket, captured as CUDA graphs on the card.

    The serving analogue of the tuner's warm plan cache: a bucket's slot
    is built (its graphs captured) ahead of traffic by :meth:`warm` or on
    first need, after which every group landing in it replays.  ``obs`` /
    ``recorder`` wrap every built function (``dist/step.py``'s
    ``_maybe_record``).  See the module docstring for the slots.

    With a ``mesh`` (``params`` sharded on it, ``shard_params``) a slot
    holds the rank's shard of the cache (``step_lib.local_cache``) and its
    steps are built with ``mesh=``; they run eagerly, so the pool captures
    no graph (:attr:`graphed`), decided here.  Every engine call goes
    through :meth:`call`, which rank 0 sends to the other ranks first
    (module docstring); :meth:`warm` runs on rank 0 while the others
    follow (``ServeQueue.follow``).
    """

    def __init__(self, cfg, params, *, mesh=None, obs=None, recorder=None):
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.obs = obs
        self.recorder = recorder
        self.device = params.embed.device
        self.graphed = self.device.type == "cuda" and mesh is None
        self.wire = (_Wire(mesh) if mesh is not None and mesh.size() > 1
                     else None)
        self._bundles: Dict[Tuple[int, int, int], _Bundle] = {}
        self._graph_pool = None
        self.builds = 0
        self.build_s = 0.0      # wall seconds spent building slots

    @property
    def leader(self) -> bool:
        """Whether this rank schedules (rank 0 of a mesh, or no mesh)."""
        return self.wire is None or self.wire.leader

    def bundle(self, batch: int, prompt_len: int, max_len: int) -> _Bundle:
        key = (batch, prompt_len, max_len)
        hit = self._bundles.get(key)
        if hit is None:
            hit = self._bundles[key] = _Bundle(batch, prompt_len, max_len)
            self.builds += 1
        return hit

    def _build(self, b: _Bundle) -> _Slot:
        """A new slot of ``b``: its cache at ``max_len`` and its prefill
        and decode steps (on the card without a mesh, graphs captured over
        it; capture errors raise)."""
        t0 = time.perf_counter()
        cfg, params = self.cfg, self.params
        kw = dict(recorder=self.recorder, obs=self.obs)
        if self.mesh is not None:
            cache = step_lib.local_cache(cfg, self.mesh, b.batch, b.max_len,
                                         device=self.device)
            kw["mesh"] = self.mesh
        else:
            if self.graphed and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            cache = api.init_cache(cfg, b.batch, b.max_len,
                                   device=self.device)
            kw["graph_pool"] = self._graph_pool
        slot = _Slot(
            cache=cache,
            prefill_fn=step_lib.build_prefill(
                cfg, params, (b.batch, b.prompt_len), cache=cache, **kw),
            serve_fn=step_lib.build_serve_step(cfg, params, cache, **kw))
        b.slots.append(slot)
        self.build_s += time.perf_counter() - t0
        return slot

    def acquire(self, b: _Bundle) -> _Slot:
        """A free slot of ``b``, or a new one."""
        slot = b.free.pop() if b.free else self._build(b)
        b.peak_in_use = max(b.peak_in_use, b.in_use)
        return slot

    def release(self, b: _Bundle, slot: _Slot) -> None:
        b.free.append(slot)

    def _slot_at(self, b: _Bundle, index: int) -> _Slot:
        """Slot ``index`` of ``b`` on a following rank, built in rank 0's
        order."""
        while len(b.slots) <= index:
            self._build(b)
        return b.slots[index]

    def call(self, b: _Bundle, slot: _Slot, op: int, tokens: np.ndarray,
             pos: int = 0, *, site: Optional[str] = None,
             rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """One engine call of ``slot`` (``op``: prefill of ``tokens``
        ``(batch, prompt_len)``, or a decode step of ``(batch, 1)`` at
        ``pos``); returns the batch's logits.  On a mesh, rank 0 sends the
        call (with ``rows``, each row's request id and token index, for the
        other ranks' sampling) before it runs.  With a fault ``site`` the
        call passes it first, and on a mesh the ranks agree on a failure
        (one all-reduce MAX) so that every rank raises together: the
        failing one its fault, the others :class:`RankFault`."""
        tokens = np.ascontiguousarray(tokens, np.int64)
        if self.wire is not None and self.wire.leader:
            if rows is None:
                rows = np.full((2, b.batch), -1, np.int64)
            self.wire.send(
                (op, b.batch, b.prompt_len, b.max_len, b.slots.index(slot),
                 pos, _SITES.index(site)),
                np.concatenate([tokens.ravel(), rows.ravel()]))
        self._agree(site)
        return self._run(slot, op, tokens, pos)

    def _agree(self, site: Optional[str]) -> None:
        if site is None:
            return
        err = None
        try:
            fault_point(site)
        except Exception as e:   # noqa: BLE001 - agreed on below
            err = e
        if self.wire is not None and self.wire.agree(err is not None) \
                and err is None:
            err = RankFault(f"{site} failed on another rank of the mesh")
        if err is not None:
            raise err

    def _run(self, slot: _Slot, op: int, tokens: np.ndarray, pos: int):
        if op == _PREFILL:
            return slot.prefill_fn({"tokens": tokens})[1]
        return slot.serve_fn(tokens, pos)[1]

    def receive(self):
        """A following rank's next engine call from rank 0: ``None`` on
        stop, else ``(bundle, slot, op, tokens, pos, site, rows)``."""
        head, payload = self.wire.recv()
        op, batch, prompt_len, max_len, index, pos, site = head
        if op == _STOP:
            return None
        b = self.bundle(batch, prompt_len, max_len)
        n = batch * (prompt_len if op == _PREFILL else 1)
        return (b, self._slot_at(b, index), op, payload[:n].reshape(batch, -1),
                pos, _SITES[site], payload[n:].reshape(2, batch))

    def stop(self) -> None:
        """On a mesh's rank 0: let the other ranks' ``follow`` return."""
        if self.wire is not None and self.wire.leader:
            self.wire.send((_STOP,) + (0,) * (_HEADER - 2),
                           np.zeros(0, np.int64))

    def warm(self, shapes: Sequence[Tuple[int, int, int]]) -> int:
        """Build each ``(batch, prompt_len, max_len)`` cell's first slot
        and run its prefill and one decode step on dummy tokens, so the
        first real request in the bucket pays replays only.  Returns the
        number of cells warmed.  On a mesh, rank 0 calls it while the
        other ranks follow."""
        n = 0
        for batch, prompt_len, max_len in dict.fromkeys(shapes):
            b = self.bundle(padded_batch(batch), prompt_len, max_len)
            slot = self.acquire(b)
            try:
                self.call(b, slot, _PREFILL,
                          np.zeros((b.batch, prompt_len), np.int64))
                self.call(b, slot, _DECODE, np.zeros((b.batch, 1), np.int64),
                          prompt_len).cpu()
            finally:
                self.release(b, slot)
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._bundles)

    @property
    def slots(self) -> int:
        """Slots built over all buckets."""
        return sum(len(b.slots) for b in self._bundles.values())

    @property
    def peak_in_use(self) -> int:
        """The most slots of one bucket held at once: 2 when two groups of
        one bucket were in flight together (counted on rank 0)."""
        return max((b.peak_in_use for b in self._bundles.values()),
                   default=0)


@dataclasses.dataclass
class _GroupRuntime:
    """Device-side state of an in-flight group between engine calls."""

    bundle: _Bundle
    slot: _Slot             # holds the group's cache
    toks: np.ndarray        # (padded_batch, 1) int64 — next step's inputs
    pos0: int               # absolute position of the first decode write


class ServeQueue:
    """Continuous-batching front end over the pool's prefill and decode.

    ``params`` is the model (:func:`repro_torch.models.api.init_params`);
    every engine call runs on its device, through ``pool`` (default: an
    :class:`ExecutorPool` built with this queue's ``mesh``, ``obs`` and
    ``recorder``).  ``obs`` (a :class:`repro_torch.obs.Obs`) and
    ``recorder`` (a :class:`repro_torch.perf.trace.TraceRecorder`)
    instrument the run; ``retry_kw`` are
    :func:`repro_torch.resilience.retry_with_backoff`'s keywords for every
    engine call (default: no retry).

    With a ``mesh`` (``params`` this rank's shards, ``shard_params``), rank
    0 runs the scheduler (:meth:`submit`, :meth:`step`, :meth:`drain`) and
    ends with :meth:`stop`; every other rank calls :meth:`follow`, which
    replays rank 0's engine calls until then (module docstring).
    ``streams`` holds each request's tokens by id on every rank."""

    def __init__(self, cfg, params, *, mesh=None,
                 scheduler: Optional[Scheduler] = None,
                 config: Optional[SchedulerConfig] = None,
                 pool: Optional[ExecutorPool] = None,
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
        self.sched = scheduler or Scheduler(config)
        # NB: not `pool or ...` — an empty ExecutorPool is falsy (__len__)
        self.pool = pool if pool is not None else \
            ExecutorPool(cfg, params, mesh=mesh, obs=obs, recorder=recorder)
        if self.pool.mesh is not mesh:
            raise ValueError("the pool was built for another mesh")
        self.obs = obs
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
        self.streams: Dict[int, List[int]] = {}
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
        self._lead()
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
        bundle = self.pool.bundle(group.padded_size, group.prompt_len,
                                  self._max_len(group))
        tokens = np.zeros((group.padded_size, group.prompt_len), np.int64)
        for i, r in enumerate(group.requests):
            tokens[i] = np.asarray(r.prompt, np.int64)
        slot = self.pool.acquire(bundle)
        rows = self._rows(group, group.requests, 0)

        def call():
            # the fault point fires before the replay, so a retried
            # prefill never reuses a consumed buffer
            return self.pool.call(bundle, slot, _PREFILL, tokens,
                                  site="serve.prefill", rows=rows)

        t0 = time.perf_counter()
        try:
            logits = retry_with_backoff(call, **self.retry_kw)
            logits_np = logits.cpu().numpy()
        except BaseException:
            self.pool.release(bundle, slot)
            raise
        dt = time.perf_counter() - t0
        self.engine_s["prefill"].append(dt)
        wall = time.perf_counter()
        toks = self._sample_rows(logits_np, group, lambda r: 0)
        for i, r in enumerate(group.requests):
            r.tokens.append(int(toks[i, 0]))
            self.streams.setdefault(r.rid, []).append(int(toks[i, 0]))
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
            self._rt[group.gid] = _GroupRuntime(
                bundle=bundle, slot=slot, toks=toks, pos0=group.prompt_len)
        else:
            self.pool.release(bundle, slot)
        return finished

    def _run_decode(self, group: Group, now: float) -> List[Request]:
        rt = self._rt[group.gid]
        pos = rt.pos0 + group.steps_done
        was_active = list(group.active_requests)
        step_index = group.steps_done + 1   # token index this step emits
        rows = self._rows(group, was_active, step_index)

        def call():
            # the fault point fires before the replay, so a retried step
            # finds an untouched cache
            return self.pool.call(rt.bundle, rt.slot, _DECODE, rt.toks, pos,
                                  site="serve.step", rows=rows)

        t0 = time.perf_counter()
        logits = retry_with_backoff(call, **self.retry_kw)
        logits_np = logits.cpu().numpy()
        dt = time.perf_counter() - t0
        self.engine_s["decode"].append(dt)
        wall = time.perf_counter()
        toks = self._sample_rows(logits_np, group, lambda r: step_index)
        for i, r in enumerate(group.requests):
            if r in was_active:
                r.tokens.append(int(toks[i, 0]))
                self.streams.setdefault(r.rid, []).append(int(toks[i, 0]))
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
            self.pool.release(rt.bundle, rt.slot)
        return finished

    def _rows(self, group: Group, emitting, index: int) -> np.ndarray:
        """``(2, padded_batch)``: each row's request id and the index of
        the token it emits (-1 for rows that emit none), for the other
        ranks' sampling on a mesh."""
        rows = np.full((2, group.padded_size), -1, np.int64)
        for i, r in enumerate(group.requests):
            if r in emitting:
                rows[:, i] = (r.rid, index)
        return rows

    def _lead(self) -> None:
        if not self.pool.leader:
            raise RuntimeError("on a mesh only rank 0 schedules; the other "
                               "ranks call follow()")

    def follow(self) -> Dict[int, List[int]]:
        """On a mesh rank other than 0: replay rank 0's engine calls until
        it calls :meth:`stop`, sampling each call's emitting rows as rank 0
        does (every rank holds the whole logits, and :func:`sample_token`
        is a pure function of them), into :attr:`streams`, which it
        returns.  A call whose fault point failed on some rank is dropped
        here: rank 0 retries it (sending it again) or gives up."""
        if self.pool.leader:
            raise RuntimeError("follow() runs on the ranks other than 0")
        while True:
            cmd = self.pool.receive()
            if cmd is None:
                return self.streams
            b, slot, op, tokens, pos, site, rows = cmd
            try:
                self.pool._agree(site)
            except Exception:    # noqa: BLE001 - rank 0 decides the retry
                continue
            logits = self.pool._run(slot, op, tokens, pos).cpu().numpy()
            logits = logits[:, :self.cfg.vocab_size]
            for i, (rid, index) in enumerate(rows.T):
                if rid >= 0:
                    self.streams.setdefault(int(rid), []).append(sample_token(
                        logits[i], temperature=self.temperature,
                        seed=self.seed, rid=int(rid), index=int(index)))

    def stop(self) -> None:
        """On a mesh's rank 0: end the other ranks' :meth:`follow` (no-op
        without a mesh)."""
        self.pool.stop()

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
        self._lead()
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
