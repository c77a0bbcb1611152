"""Closed-loop serving load: continuous batching vs a no-batching baseline.

Port of the reference's ``benchmarks/serve_traffic.py``.  A fleet of
closed-loop clients drives the port's serve queue: each client submits a
request, waits for its completion, thinks for a seeded-exponential
interval, and submits the next -- the classic closed-loop load shape whose
offered rate adapts to the server.  Request shapes (prompt length,
generation budget) are drawn from a mixed pool, so the shape-keyed
coalescer has work to do.

Two clocks: the *scheduler* runs on a *virtual* clock -- one tick per
engine action, arrivals and think times in tick units -- so batch
formation, admission and interleave decisions are a pure function of
``REPRO_TEST_SEED`` and equal the reference's on the same seed
(``tests/test_torch_executor_pool.py``).  *Latency* is measured on the
wall clock around the real engine calls, so p50/p99 and goodput are real
numbers although the schedule is simulated.

Modes, same seeded trace for both:

  * **batched**    -- the continuous-batching path: shape-keyed groups up
                     to ``max_batch=8``, two groups in flight (two groups
                     of one shape bucket then hold two of its slots);
  * **sequential** -- the no-batching baseline: ``max_batch=1``,
                     ``max_in_flight=1`` -- every request pays its own
                     prefill and its own decode steps.

Each mode runs the trace twice through one shared
:class:`~repro_torch.serve.queue.ExecutorPool`: the first pass pays every
slot's build (on the card, the CUDA-graph captures), the second is the
timed one, so the goodput comparison is steady-state.  The suite asserts
that the batched path never issues more engine calls than the baseline
and, on the canonical load with no fault plan and no rejections, that it
wins goodput.  Records keep the reference's keys.

The model is ``arch``'s reduced config by default, as the reference's;
``reduced=False`` serves it at full width (llama3.2-1b: 16 layers, d 2048).

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_traffic --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.serve_traffic --full-width
"""
from __future__ import annotations

import heapq
import os
import time

import numpy as np

from ._util import bench_rng, csv_row

# (prompt_len, gen_len) pool; weights via seeded draws.  Prompt lengths
# repeat across the pool on purpose -- same-prompt-shape requests are what
# the coalescer can merge.
SHAPES = [(16, 8), (16, 4), (32, 8), (32, 16)]
SMOKE_SHAPES = [(8, 2), (8, 4), (16, 4)]
ARCH = "llama3.2-1b"
MEAN_THINK_TICKS = 3.0


def build_trace(rng, n_clients: int, rounds: int, shapes, vocab: int):
    """Per-client request list: (prompt tokens, gen_len, think_ticks).

    Round 0 arrives at tick 0 for every client (a load-test ramp burst --
    the scheduler coalesces it by shape); later arrivals are closed-loop:
    completion + think.  Everything is drawn up front from the seeded rng,
    so the trace is identical across modes, runs and packages.
    """
    trace = []
    for _ in range(n_clients):
        reqs = []
        for _ in range(rounds):
            p_len, g_len = shapes[rng.integers(len(shapes))]
            prompt = rng.integers(0, vocab, p_len).tolist()
            think = float(rng.exponential(MEAN_THINK_TICKS))
            reqs.append((prompt, int(g_len), think))
        trace.append(reqs)
    return trace


def run_traffic(cfg, params, trace, *, sched_cfg, pool, obs=None,
                seed: int = 0, mesh=None):
    """Drive one full closed-loop pass of ``trace`` through a fresh queue
    over ``pool``.

    Returns the stats dict for the pass.  The virtual clock advances one
    tick per engine action and jumps across idle gaps to the next arrival;
    wall time is measured around the whole pass.

    With a ``mesh`` (``params`` and ``pool`` this rank's, built on it)
    every rank calls this alike: rank 0 drives the load and returns the
    stats, the other ranks follow its engine calls and return
    ``{"streams": ...}``, each request's tokens by id
    (``ServeQueue.follow``).
    """
    from ..serve.queue import ServeQueue

    queue = ServeQueue(cfg, params, mesh=mesh, config=sched_cfg, pool=pool,
                       obs=obs, temperature=0.0, seed=seed,
                       retry_kw={"retries": 2, "backoff_s": 0.01})
    if not queue.pool.leader:
        return {"streams": queue.follow()}
    try:
        return _drive(queue, trace)
    finally:
        queue.stop()


def _drive(queue, trace) -> dict:
    """:func:`run_traffic`'s closed loop on rank 0."""
    # (arrival_tick, client, round) heap; client order breaks tick ties
    # deterministically.
    arrivals = [(0.0, c, 0) for c in range(len(trace))]
    heapq.heapify(arrivals)
    owner = {}           # rid -> (client, round)
    n_done_seen = 0
    vt = 0.0
    wall0 = time.perf_counter()
    while arrivals or queue.pending:
        while arrivals and arrivals[0][0] <= vt:
            _, c, k = heapq.heappop(arrivals)
            prompt, g_len, _think = trace[c][k]
            req = queue.submit(prompt, g_len, now=vt)
            owner[req.rid] = (c, k)
        progressed = queue.step(now=vt)
        if progressed:
            vt += 1.0
        # Closed loop: a finished request re-arms its client after think.
        for r in queue.completed[n_done_seen:]:
            c, k = owner[r.rid]
            if k + 1 < len(trace[c]):
                think = trace[c][k + 1][2]
                heapq.heappush(arrivals, (vt + think, c, k + 1))
        n_done_seen = len(queue.completed)
        if not progressed:
            if arrivals:
                vt = max(vt, arrivals[0][0])
            elif not queue.pending:
                break
    wall = time.perf_counter() - wall0

    done = queue.completed
    e2e = np.array([r.wall_e2e_s for r in done if r.wall_e2e_s is not None])
    ttft = np.array([r.wall_ttft_s for r in done
                     if r.wall_ttft_s is not None])
    ctr = queue.sched.counters
    tokens = sum(r.tokens_generated for r in done)
    n_requests = sum(len(reqs) for reqs in trace)
    return {
        "n_requests": n_requests,
        "completed": len(done),
        "rejected": ctr["rejected"],
        "evicted": ctr["evicted"],
        "prefill_batches": ctr["prefill_batches"],
        "decode_steps": ctr["decode_steps"],
        "engine_calls": ctr["prefill_batches"] + ctr["decode_steps"],
        "padded_slots": ctr["padded_slots"],
        "tokens": tokens,
        "goodput_tok_s": tokens / max(wall, 1e-9),
        "p50_ms": float(np.percentile(e2e, 50) * 1e3) if e2e.size else 0.0,
        "p99_ms": float(np.percentile(e2e, 99) * 1e3) if e2e.size else 0.0,
        "ttft_p50_ms": (float(np.percentile(ttft, 50) * 1e3)
                        if ttft.size else 0.0),
        "ttft_p99_ms": (float(np.percentile(ttft, 99) * 1e3)
                        if ttft.size else 0.0),
        "wall_s": wall,
    }


def main(out=print, record=None, smoke: bool = False,
         max_queue_depth: int = 64, n_clients: int = None,
         rounds: int = None, *, arch: str = ARCH, reduced: bool = True,
         device=None):
    """Run both modes (see the module docstring) on ``device`` (default:
    the card).  Returns ``{"batched": stats, "sequential": stats, "pool":
    {...}}``, the last the shared pool's buckets, slots, the most slots
    of one bucket held at once and the seconds spent building slots."""
    import torch

    from ..configs import REDUCED, get_config
    from ..kernels.engine import resolve_device
    from ..models import api
    from ..obs import get_active
    from ..resilience.inject import install_from_env
    from ..serve.queue import ExecutorPool
    from ..serve.scheduler import SchedulerConfig

    # Chaos harness: honour REPRO_FAULT_PLAN -- injected step faults are
    # retried, rejections counted, and the run still exits 0.
    install_from_env()

    shapes = SMOKE_SHAPES if smoke else SHAPES
    # The goodput assertion is a benchmark-scale claim: it holds for the
    # canonical loads, but a custom-shrunk run (the determinism test uses
    # two clients, one round) can be too small for the batching win to
    # clear wall-clock noise -- such runs keep the structural assert only.
    canonical_load = n_clients is None and rounds is None
    n_clients = n_clients or (4 if smoke else 6)
    rounds = rounds or (2 if smoke else 3)
    seed = int(os.environ.get("REPRO_TEST_SEED", "0"))

    dev = resolve_device(device)
    cfg = REDUCED[arch]() if reduced else get_config(arch)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    obs = get_active()
    pool = ExecutorPool(cfg, params, obs=obs)
    trace = build_trace(bench_rng(), n_clients, rounds, shapes,
                        cfg.vocab_size)

    modes = {
        "batched": SchedulerConfig(max_queue_depth=max_queue_depth,
                                   max_in_flight=2, max_batch=8,
                                   min_batch=1, max_wait_s=2.0),
        "sequential": SchedulerConfig(max_queue_depth=max_queue_depth,
                                      max_in_flight=1, max_batch=1,
                                      min_batch=1, max_wait_s=0.0),
    }
    results = {}
    for mode, sched_cfg in modes.items():
        # pass 1 builds the slots; pass 2 is the timed steady state
        run_traffic(cfg, params, trace, sched_cfg=sched_cfg, pool=pool,
                    obs=None, seed=seed)
        res = run_traffic(cfg, params, trace, sched_cfg=sched_cfg,
                          pool=pool, obs=obs, seed=seed)
        results[mode] = res
        out(csv_row(
            f"serve_traffic_{mode}", res["p50_ms"] * 1e3,
            f"goodput_tok_s={res['goodput_tok_s']:.1f};"
            f"p99_ms={res['p99_ms']:.1f};"
            f"ttft_p50_ms={res['ttft_p50_ms']:.1f};"
            f"engine_calls={res['engine_calls']};"
            f"completed={res['completed']}/{res['n_requests']};"
            f"rejected={res['rejected']}"))
        if record is not None:
            record({"suite": "serve_traffic", "matrix": mode, **res})

    b, s = results["batched"], results["sequential"]
    # Structural win: coalescing can only merge engine calls, never add
    # them (group decode steps = max over members <= sum over members).
    if b["engine_calls"] > s["engine_calls"]:
        raise AssertionError(
            f"batched path issued MORE engine calls than the no-batching "
            f"baseline: {b['engine_calls']} vs {s['engine_calls']}")
    # Goodput win: steady-state batched throughput must beat one-at-a-time.
    # Skipped under an active fault plan (retries distort wall time) or
    # when admission shed requests.
    chaotic = bool(os.environ.get("REPRO_FAULT_PLAN")) \
        or b["rejected"] or s["rejected"]
    if not chaotic and canonical_load \
            and b["goodput_tok_s"] < s["goodput_tok_s"]:
        raise AssertionError(
            f"continuous batching lost goodput to the no-batching "
            f"baseline: {b['goodput_tok_s']:.1f} vs "
            f"{s['goodput_tok_s']:.1f} tok/s")
    results["pool"] = {"buckets": len(pool), "builds": pool.builds,
                       "slots": pool.slots, "peak_in_use": pool.peak_in_use,
                       "build_s": pool.build_s}
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max-queue-depth", type=int, default=64,
                    help="admission depth for BOTH modes; small values "
                         "shed the arrival burst (counted rejections)")
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the architecture at its published widths "
                         "(default: its reduced config, as the reference)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--obs", nargs="?", const="serve_traffic", default=None,
                    metavar="STEM", help="capture the run with "
                                         "repro_torch.obs")
    ap.add_argument("--obs-dir", default=None)
    args = ap.parse_args()
    obs = None
    if args.obs:
        from ..obs import Obs, set_active
        obs = Obs(source=args.obs)
        set_active(obs)
    records = []
    try:
        res = main(smoke=args.smoke, max_queue_depth=args.max_queue_depth,
                   record=records.append, arch=args.arch,
                   reduced=not args.full_width, device=args.device)
    finally:
        if obs is not None:
            from ..obs import set_active
            jsonl, chrome = obs.save(args.obs_dir, stem=args.obs)
            print(f"obs: {jsonl}")
            print(f"obs: {chrome}")
            set_active(None)
    print(f"records: {len(records)}; pool: {res['pool']}")
