"""Serving command line: the continuous-batching queue over the port's LM.

Port of ``repro/launch/serve.py``.  Requests flow through
:mod:`repro_torch.serve`: the pure injectable-clock scheduler coalesces
same-prompt-length requests into ragged batches padded to the engine's
batch-block grid, and ``ServeQueue`` runs the resulting prefill/decode
actions through its :class:`~repro_torch.serve.queue.ExecutorPool`: on
the card, CUDA graphs per shape bucket, replayed over static buffers,
whose every prefill attention is the CUDA kernel B5.  Admission control
sheds overload (counted in the scheduler's ``rejected``).

Weights are random, drawn from ``--seed`` on the device.  On a GPU the
launcher turns off cuBLAS's reduced-precision reductions for bf16 GEMMs
(``allow_bf16_reduced_precision_reduction``) so every matmul accumulates
in fp32, the reference's contract.

Observability (``--obs``): the run is captured by a
:class:`repro_torch.obs.Obs` — engine dispatch counters through the
engine's tracer hook, the queue's per-request histograms and gauges, spans
around every phase, and a LOOPS plan-cache warm-up for the model's FFN
weight shapes (:func:`warm_spmm_plan_cache`: the tuner search is paid
before traffic, then bulk-installed into the serving pool).  The capture
saves a versioned JSONL plus a Perfetto-loadable Chrome trace under
``--obs-dir`` (default ``benchmarks/results/obs/``); render either with
``tools/obs_report.py``.

Resilience: ``REPRO_FAULT_PLAN`` is honoured, every engine call passes the
``serve.prefill`` / ``serve.step`` fault points and retries with backoff
(``--step-retries``, ``--retry-backoff-ms``, ``--step-deadline-ms``), and
retries are counted (``serve.retries``, ``serve.degraded``).

On the card, at llama3.2-1b's full width:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 2048 --gen-len 32

On the CPU, reduced, with a capture:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --device cpu --batch 2 --prompt-len 8 --gen-len 4 --obs

The engine's fallback chains (``repro_torch.resilience.fallback``) stay
off here, as everywhere until a caller installs
``set_policy(FallbackPolicy())``: a kernel that fails raises into the
step's retries, and inside the pool's CUDA graph captures a chain would
re-raise in any case.

Mesh (``--mesh-data D --mesh-model M`` above 1 x 1): one process a rank,
``torch.distributed``, as ``launch/train.py``: under ``torchrun`` (or a
caller that initialised the group) the ranks join it; run plainly, the
command spawns its ``D * M`` ranks on a ``file://`` store in a temporary
directory (:func:`repro_torch.launch.spawn.spawn_ranks`), and
:func:`main`'s ``timeout_s`` kills every spawned rank past it.  Each rank
draws the full model from the seed and keeps its shards
(:func:`repro_torch.models.transformer.shard_params`); rank 0 runs the
queue's scheduler and sends every engine call to the others, which
follow it (:class:`repro_torch.serve.queue.ServeQueue`), and rank 0 alone
prints and saves.  Under ``--obs`` rank 0 alone warms the LOOPS plan
cache, from its full model before sharding, exactly as one device does:
the warm-up runs B1/B2 beside the LM and feeds none of its tokens, and
one rank writing the plan cache keeps the ranks off one another's files.
The slots run eagerly on a mesh (no CUDA graph captures a gloo
collective).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --device cpu --mesh-data 2 --mesh-model 2 --batch 4 \\
      --prompt-len 8 --gen-len 4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import REDUCED, get_config
from ..kernels import flash_attention as b5
from ..kernels import wkv6 as _wkv6
from ..kernels.engine import resolve_device
from ..models import api
from ..resilience.inject import fault_point, install_from_env, note_degraded
from ..serve.queue import ServeQueue
from ..serve.scheduler import POLICIES, SchedulerConfig
from .mesh import make_test_mesh
from .spawn import join_env_group, spawn_ranks

__all__ = ["build_args", "main", "warm_spmm_plan_cache"]


def warm_spmm_plan_cache(cfg, params, obs, *, sparsity: float = 0.9,
                         n_cols: int = 8, on_miss: str = "search",
                         pool=None, device=None):
    """Warm the LOOPS plan pool for this model's FFN weight shapes.

    Port of the reference's warm-up, on the ``"cuda"`` backend: each
    layer's FFN up-projection ``wi`` (``(d_model, d_ff)``, brought to host
    fp32 and transposed to ``(d_ff, d_model)`` as the reference does; a
    model without a dense FFN, the moe and ssm families, warms one synthetic
    ``(4 d_model, d_model)`` standard-normal matrix from seed 0, as the
    reference's other branch) is magnitude-pruned, its plan tuned or fetched through the persistent
    cache (``$REPRO_TUNE_CACHE``), and one SpMM per layer through the
    kernels B1/B2 validates the plan on ``device`` (default: the
    parameters' device).  Same-shaped layers fingerprint alike, so layer 0
    pays the (budgeted) search and every later layer is a cache hit — the
    hit rate lands in the capture's ``tune.cache.*`` gauges, and each
    validation SpMM in the ``engine.dispatch`` counters.

    The tuned records are then bulk-installed into the serving ``pool``
    (default: a ``serve-pool`` cache beside the tuning store) in ONE atomic
    write via :meth:`repro_torch.tune.PlanCache.prewarm`, which counts
    exactly the newly installed keys: a re-warmed pool counts zero.

    Resilience: the weight passes an ``ingest.serve.weights`` fault point
    and the pruned CSR is validated with ``repair="drop"``.
    ``on_miss="model"`` serves the Eq. 2 model-prior plan on a miss (no
    measurement), counting each such miss as
    ``serve.degraded{reason="plan-cache-miss"}``.

    Returns the warmed pool cache.
    """
    from ..core.formats import csr_from_dense
    from ..core.spmm import loops_spmm
    from ..models.sparse_ffn import magnitude_prune
    from ..resilience.validate import validate_csr
    from ..tune import PlanCache, SearchBudget, autotune
    from ..tune.fingerprint import cache_key, fingerprint

    dev = resolve_device(device if device is not None
                         else params.embed.device)
    cache = PlanCache()
    cache.stats.reset()
    obs.watch_cache(cache, name="serve-warm")
    budget = SearchBudget(top_k=2, repeats=1, warmup=0)
    if hasattr(params.layers[0], "mlp"):
        weights = [blk.mlp.wi.detach().float().cpu().numpy().T
                   for blk in params.layers]
    else:   # no dense FFN (the moe and ssm families): one synthetic
        # (4d, d) matrix
        rng = np.random.default_rng(0)
        d = cfg.d_model
        weights = [rng.standard_normal((4 * d, d)).astype(np.float32)]

    keys = []
    for i, w in enumerate(weights):
        with obs.span("serve.warm_plan", cat="warm", layer=i) as sp:
            w = np.asarray(fault_point("ingest.serve.weights", w))
            csr = csr_from_dense(magnitude_prune(w, sparsity))
            csr, _ = validate_csr(csr, repair="drop")
            misses0 = cache.stats.misses
            fmt, _plan = autotune(csr, n_cols=n_cols, cache=cache,
                                  budget=budget, backend="cuda",
                                  on_miss=on_miss, device=dev)
            if on_miss == "model" and cache.stats.misses > misses0:
                note_degraded("serve.degraded", reason="plan-cache-miss")
            keys.append(cache_key(fingerprint(csr), n_cols=n_cols,
                                  dtype=csr.vals.dtype, backend="cuda"))
            x = torch.ones((csr.ncols, n_cols), dtype=torch.float32,
                           device=dev)
            sp.fence(loops_spmm(fmt, x, device=dev))
    # Hand the tuned plans to the serving pool in one bulk write.
    if pool is None:
        pool = PlanCache(os.path.join(cache.dir, "serve-pool"))
    obs.watch_cache(pool, name="serve-pool")
    records = [cache.peek(k) for k in dict.fromkeys(keys)]
    installed = pool.prewarm([r for r in records if r is not None])
    obs.gauge("serve.warm_layers").set(len(weights))
    obs.gauge("serve.prewarmed_plans").set(installed)
    return pool


def build_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="run the config's first N layers only (full "
                         "width; a shorter smoke run of a deep model)")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of concurrent requests to submit")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16,
                    help="tokens generated per request (prefill's first "
                         "token included)")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="the model's dtype (default: the config's)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("REPRO_TEST_SEED", "0")),
                    help="params/prompt/sampling seed (default honours "
                         "REPRO_TEST_SEED)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    # continuous-batching knobs
    ap.add_argument("--max-batch", type=int, default=8,
                    help="requests coalesced per prefill call")
    ap.add_argument("--min-batch", type=int, default=1)
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="batch-formation timeout for the oldest request")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="groups admitted to the engine at once")
    ap.add_argument("--max-queue-depth", type=int, default=64,
                    help="admission control: submits beyond this are shed")
    ap.add_argument("--policy", choices=POLICIES, default="prefill-first",
                    help="prefill/decode interleave policy")
    ap.add_argument("--obs", nargs="?", const="serve", default=None,
                    metavar="STEM",
                    help="capture runtime metrics/spans; writes STEM.jsonl "
                         "+ STEM.trace.json (Chrome/Perfetto) under "
                         "--obs-dir (default benchmarks/results/obs/)")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="override the obs output directory")
    ap.add_argument("--no-warm-spmm-cache", action="store_true",
                    help="skip the LOOPS plan-cache warm-up under --obs")
    ap.add_argument("--plan-on-miss", choices=("search", "model"),
                    default="search",
                    help="plan-cache miss policy for the warm-up: 'search' "
                         "pays the measurement sweep (default); 'model' "
                         "serves the Eq. 2 model-prior plan immediately "
                         "(degraded mode, counted as serve.degraded)")
    ap.add_argument("--step-retries", type=int, default=2,
                    help="host-level retries per prefill/decode step")
    ap.add_argument("--retry-backoff-ms", type=float, default=10.0,
                    help="initial retry backoff (doubles per attempt)")
    ap.add_argument("--step-deadline-ms", type=float, default=None,
                    help="per-request deadline across retries; exceeding it "
                         "raises DeadlineExceeded instead of sleeping past")
    ap.add_argument("--logits-out", default=None, metavar="FILE",
                    help="save every request's logits rows (fp32, the "
                         "real vocabulary) to FILE as .npz, keyed by "
                         "request id")
    return ap.parse_args(argv)


def main(argv=None, *, timeout_s: float | None = None):
    """Run the CLI.  On one device, returns the drained
    :class:`~repro_torch.serve.queue.ServeQueue`; on a mesh, rank 0's
    record (``streams``, ``engine_s``, the scheduler's counters, the
    pool's buckets and slots, and ``per_rank``: every rank's streams, B5
    and wkv6 launches and peak memory).  ``timeout_s`` limits the ranks this call
    spawns: past it every rank is killed and the run fails."""
    args = build_args(argv)
    dev = resolve_device(args.device)
    world = args.mesh_data * args.mesh_model
    if world > 1 and not dist.is_initialized():
        if "RANK" not in os.environ:
            with tempfile.TemporaryDirectory(prefix="repro_serve_") as tmp:
                return spawn_ranks(
                    main, argv, world=world, device=dev, store_dir=tmp,
                    timeout_s=timeout_s,
                    what=f"mesh {args.mesh_data}x{args.mesh_model}")
        join_env_group(dev, world)      # torchrun: the environment's group

    # Chaos harness: honour REPRO_FAULT_PLAN so a stock serving run can be
    # steered into failures.
    install_from_env()

    mesh, rank = None, 0
    if world > 1:
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        mesh = make_test_mesh(args.mesh_data, args.mesh_model, device=dev)
        rank = dist.get_rank()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = REDUCED[args.arch]() if args.reduced else get_config(args.arch)
    if args.layers is not None and args.layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=dev)
    n_params = api.num_params(params)
    init_s = time.perf_counter() - t0

    obs = None
    if args.obs and rank == 0:
        from ..obs import Obs, set_active
        obs = Obs(source=args.obs)
        set_active(obs)

    # Degraded-mode step execution: transient host-level failures retry
    # with exponential backoff under the optional per-request deadline;
    # every retry is a counted degradation, never a silent one.
    retry_kw = dict(
        retries=args.step_retries,
        backoff_s=args.retry_backoff_ms / 1e3,
        deadline_s=(args.step_deadline_ms / 1e3
                    if args.step_deadline_ms is not None else None),
        on_retry=lambda n, e: (
            note_degraded("serve.degraded", reason="retry"),
            note_degraded("serve.retries")),
    )
    sched_cfg = SchedulerConfig(
        max_queue_depth=args.max_queue_depth,
        max_in_flight=args.max_in_flight,
        max_batch=args.max_batch, min_batch=args.min_batch,
        max_wait_s=args.max_wait_ms / 1e3, policy=args.policy)

    launches0 = (b5.flash_attention.launches, _wkv6.wkv6.launches)
    engine_ctx = obs.attach_engine() if obs else contextlib.nullcontext()
    with engine_ctx:
        if obs is not None and not args.no_warm_spmm_cache:
            warm_spmm_plan_cache(cfg, params, obs,
                                 on_miss=args.plan_on_miss, device=dev)
        if mesh is not None:
            params = api.shard_params(cfg, params, mesh, device=dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        queue = ServeQueue(cfg, params, mesh=mesh, config=sched_cfg,
                           obs=obs, temperature=args.temperature,
                           seed=args.seed, retry_kw=retry_kw,
                           record_logits=args.logits_out is not None)
        t0 = time.perf_counter()
        if not queue.pool.leader:
            queue.follow()
            reqs = done = []
        else:
            # Seeded prompt set: one request per row, all through the
            # queue; request i has id i, so its sampling stream (keyed on
            # the id) is the same in every run.
            rng = np.random.default_rng(args.seed + 1)
            prompts = rng.integers(0, cfg.vocab_size,
                                   (args.batch, args.prompt_len))
            try:
                reqs = [queue.submit([int(t) for t in row], args.gen_len,
                                     rid=i)
                        for i, row in enumerate(prompts)]
                done = queue.drain()
            finally:
                queue.stop()
        t_total = time.perf_counter() - t0

    launched = b5.flash_attention.launches - launches0[0]
    launched_wkv6 = _wkv6.wkv6.launches - launches0[1]
    n_tokens = sum(r.tokens_generated for r in done)
    tps = n_tokens / max(t_total, 1e-9)
    record = None
    if mesh is not None:
        blk = params.layers[0]
        mine = {"rank": rank, "streams": queue.streams,
                "launches": {"flash_attention": launched,
                             "wkv6": launched_wkv6},
                "local_heads": (blk.attn.wq.shape[1] // cfg.resolved_head_dim
                                if hasattr(blk, "attn") else None),
                "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if dev.type == "cuda" else None)}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, mine)
        dist.barrier()
        if rank:
            return mine
        record = {"arch": cfg.name, "dtype": str(cfg.dtype).split(".")[-1],
                  "device": str(dev), "mesh": [args.mesh_data,
                                               args.mesh_model],
                  "params": n_params, "init_s": init_s,
                  "streams": queue.streams, "served_s": t_total,
                  "tokens_per_s": tps, "engine_s": queue.engine_s,
                  "counters": dict(queue.sched.counters),
                  "completed": len(done),
                  "ttft_s": [r.wall_ttft_s for r in done],
                  "pool": {"buckets": len(queue.pool),
                           "builds": queue.pool.builds,
                           "slots": queue.pool.slots},
                  "per_rank": per_rank}
    counters = queue.sched.counters
    where = (f"{dev}" if mesh is None
             else f"a {args.mesh_data}x{args.mesh_model} mesh of {dev}")
    print(f"{cfg.name} on {where}: {n_params:,} parameters "
          f"({cfg.dtype}), initialised in {init_s:.2f}s")
    print(f"served {len(done)}/{len(reqs)} requests "
          f"({args.batch}x{args.prompt_len}+{args.gen_len}) in "
          f"{t_total:.2f}s; {n_tokens} tokens at {tps:.1f} tok/s; "
          f"{counters['prefill_batches']} prefill batches, "
          f"{counters['decode_steps']} decode steps, "
          f"{counters['rejected']} rejected; pool: {len(queue.pool)} "
          f"buckets, {queue.pool.slots} slots; flash-attention kernel "
          f"launches: {launched}, wkv6 launches: {launched_wkv6}"
          + ("" if mesh is None else " on rank 0"))
    if done:
        print("generated token ids (first request):",
              np.asarray(done[0].tokens[:16]))
    if args.logits_out is not None:
        np.savez(args.logits_out, **{
            str(rid): np.stack(rows)[:, :cfg.vocab_size]
            for rid, rows in queue.logits_log.items()})
    if obs is not None:
        from ..obs import set_active
        obs.gauge("serve.tokens_per_s").set(tps)
        obs.counter("serve.tokens_generated").inc(n_tokens)
        jsonl, chrome = obs.save(args.obs_dir, stem=args.obs)
        print(f"obs: {jsonl}")
        print(f"obs: {chrome}  (load in ui.perfetto.dev)")
        print(f"obs summary: {obs.summary()}")
        set_active(None)
    return queue if record is None else record


if __name__ == "__main__":
    main()
