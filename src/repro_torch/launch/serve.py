"""Serving command line: the continuous-batching queue over the port's LM.

Port of ``repro/launch/serve.py``.  Requests flow through
:mod:`repro_torch.serve`: the pure injectable-clock scheduler coalesces
same-prompt-length requests into ragged batches padded to the engine's
batch-block grid, and ``ServeQueue`` runs the resulting prefill/decode
actions through :mod:`repro_torch.models.api`, whose every prefill
attention is the CUDA kernel B5.  Admission control sheds overload
(counted in the scheduler's ``rejected``).

Weights are random, drawn from ``--seed`` on the device.  On a GPU the
launcher turns off cuBLAS's reduced-precision reductions for bf16 GEMMs
(``allow_bf16_reduced_precision_reduction``) so every matmul accumulates
in fp32, the reference's contract.

On the card, at llama3.2-1b's full width:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 2048 --gen-len 32

On the CPU, reduced:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --device cpu --batch 2 --prompt-len 8 --gen-len 4

Not ported yet: the LOOPS plan-cache warm-up (``warm_spmm_plan_cache``)
and ``--obs`` (they need the tuner and obs ports, ROADMAP A.9 and A.11),
the fault plan and step retries (A.11), and the mesh flags (A.12/A.13).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import REDUCED, get_config
from ..kernels import flash_attention as b5
from ..kernels.engine import resolve_device
from ..models import api
from ..serve.queue import ServeQueue
from ..serve.scheduler import POLICIES, SchedulerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of concurrent requests to submit")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16,
                    help="tokens generated per request (prefill's first "
                         "token included)")
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = REDUCED[args.arch]() if args.reduced else get_config(args.arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=dev)
    init_s = time.perf_counter() - t0

    sched_cfg = SchedulerConfig(
        max_queue_depth=args.max_queue_depth,
        max_in_flight=args.max_in_flight,
        max_batch=args.max_batch, min_batch=args.min_batch,
        max_wait_s=args.max_wait_ms / 1e3, policy=args.policy)
    queue = ServeQueue(cfg, params, config=sched_cfg,
                       temperature=args.temperature, seed=args.seed)

    # Seeded prompt set: one request per row, all through the queue.
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    launches0 = b5.flash_attention.launches
    t0 = time.perf_counter()
    reqs = [queue.submit([int(t) for t in row], args.gen_len)
            for row in prompts]
    done = queue.drain()
    t_total = time.perf_counter() - t0

    counters = queue.sched.counters
    n_tokens = sum(r.tokens_generated for r in done)
    tps = n_tokens / max(t_total, 1e-9)
    print(f"{cfg.name} on {dev}: {api.num_params(params):,} parameters "
          f"({cfg.dtype}), initialised in {init_s:.2f}s")
    print(f"served {len(done)}/{len(reqs)} requests "
          f"({args.batch}x{args.prompt_len}+{args.gen_len}) in "
          f"{t_total:.2f}s; {n_tokens} tokens at {tps:.1f} tok/s; "
          f"{counters['prefill_batches']} prefill batches, "
          f"{counters['decode_steps']} decode steps, "
          f"{counters['rejected']} rejected; flash-attention kernel "
          f"launches: {b5.flash_attention.launches - launches0}")
    if done:
        print("generated token ids (first request):",
              np.asarray(done[0].tokens[:16]))
    return queue


if __name__ == "__main__":
    main()
