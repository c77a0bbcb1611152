"""End-to-end training command line (port of ``repro/launch/train.py``).

Thin CLI over the step layer: :func:`repro_torch.dist.step.build_train_step`
builds the grad-accumulating AdamW step (flat ZeRO-1 layout), whose
attention runs on the CUDA kernel B5 (forward, and again in each block's
remat recompute); the ssm family's (``--arch rwkv6-3b``) recurrence runs
on wkv6 (forward and recompute) and wkv6_bwd (backward).  This module
owns the loop: data, checkpoints, logging.

Fault tolerance contract (the reference's):
  * checkpoints are step-atomic and async (:mod:`repro_torch.checkpoint`);
    the data "iterator" is the step counter itself (deterministic
    pipeline), so a restart resumes the exact token stream;
  * ``--resume`` restores from the newest checkpoint, whose parameters
    pass :func:`repro_torch.resilience.validate.check_finite_tree` before
    they are loaded;
  * a heartbeat file (``<ckpt-dir>/heartbeat``) is rewritten every step,
    and the ``--max-step-seconds`` watchdog aborts a step that overran;
  * ``REPRO_FAULT_PLAN`` is honoured (``resilience.inject``).

Observability: ``--obs`` captures the run with :class:`repro_torch.obs.Obs`
(the ``step.wall_us{op=train_step}`` histogram through the step builder,
engine dispatch counters, the ``train.steps_per_s`` gauge and the
``train.steps`` counter) and saves JSONL + Chrome trace under ``--obs-dir``
(default ``benchmarks/results/obs/``).

Mesh (``--mesh-data D --mesh-model M`` above 1 x 1): one process a rank,
``torch.distributed``.  Under ``torchrun`` (or whatever initialised the
process group first) the ranks join it; run plainly, the command spawns
the ``D * M`` ranks itself on a ``file://`` store under ``--ckpt-dir``,
with the backend of :func:`repro_torch.launch.mesh.backend_for` (NCCL with
a GPU a rank, else gloo; on one card the ranks share it).  Each rank draws
the full model from the seed and keeps its shards
(:func:`repro_torch.models.transformer.shard_params`) and its ZeRO rows;
rank 0 prints, writes the heartbeat and the (unsharded) checkpoints, and
returns the record, with every rank's step times, peak memory and B5 /
wkv6 / wkv6_bwd launches under ``per_rank``.  A rank that fails fails
the run, and so do spawned ranks past :func:`main`'s ``timeout_s``;
nothing falls back to fewer ranks or to the CPU.
A periodic checkpoint that would fall on the last step is left to the
final one, which the reference writes at the same step as well;
``--no-final-ckpt`` skips the final one (a run whose end state no one
resumes: on a mesh it is a gather of every leaf to rank 0).

On the card, at llama3.2-1b's full width:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 4 --seq-len 2048 --global-batch 8 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 3 --seq-len 2048 --global-batch 4 --mesh-data 2 \\
      --mesh-model 2 --ckpt-dir build/ckpt_mesh
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --layers 16 --steps 3 --seq-len 2048 --global-batch 8 \\
      --ckpt-dir build/ckpt_ssm

On the CPU, reduced:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --device cpu --steps 20 --seq-len 64 --global-batch 8
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer, latest_step, restore
from ..configs import REDUCED, get_config
from ..configs.base import ShapeConfig
from ..data import DataConfig, global_batch_at
from ..dist import step as step_lib
from ..kernels import flash_attention as b5
from ..kernels import wkv6
from ..kernels.engine import resolve_device
from ..models import api
from ..optim import adamw
from ..optim.adamw import OptConfig
from .mesh import make_test_mesh
from .spawn import DIST_TIMEOUT_S, join_env_group, spawn_ranks

__all__ = ["build_args", "main"]


def build_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-scale config of the same family")
    ap.add_argument("--layers", type=int, default=None,
                    help="run the config's first N layers only (full "
                         "width; a shorter smoke run of a deep model)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-final-ckpt", action="store_true",
                    help="skip the checkpoint after the last step (the "
                         "periodic ones are still written)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-step-seconds", type=float, default=0,
                    help="watchdog: abort if one step exceeds this")
    ap.add_argument("--obs", nargs="?", const="train", default=None,
                    metavar="STEM",
                    help="capture runtime metrics/spans; writes STEM.jsonl "
                         "+ STEM.trace.json (Chrome/Perfetto) under "
                         "--obs-dir (default benchmarks/results/obs/)")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="override the obs output directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def _copy_into(dst, src) -> None:
    """Copy nested dicts of restored CPU tensors into the live tensors of
    the same structure, in place (no second copy of the state on the
    device)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    else:
        dst.copy_(src)


def main(argv=None, *, timeout_s: float | None = None) -> dict:
    """Run the CLI; returns the run's record: per-step ``loss``,
    ``grad_norm``, ``lr``, ``tokens`` and ``step_s``, the checkpoint
    timings and the restore's seconds (on a mesh, rank 0's, with
    ``per_rank``).  ``timeout_s`` limits the ranks this call spawns (by
    default ``--max-step-seconds`` a step plus the collective timeout to
    start, else none): past it every rank is killed and the run fails."""
    args = build_args(argv)
    dev = resolve_device(args.device)
    world = args.mesh_data * args.mesh_model
    if world > 1 and not dist.is_initialized():
        if "RANK" not in os.environ:
            if timeout_s is None and args.max_step_seconds:
                timeout_s = (DIST_TIMEOUT_S
                             + args.steps * args.max_step_seconds)
            return spawn_ranks(
                main, argv, world=world, device=dev,
                store_dir=args.ckpt_dir, timeout_s=timeout_s,
                what=f"mesh {args.mesh_data}x{args.mesh_model}")
        join_env_group(dev, world)      # torchrun: the environment's group
    # Chaos harness: honour REPRO_FAULT_PLAN.
    from ..resilience.inject import install_from_env
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
    obs = None
    if args.obs and rank == 0:
        from ..obs import Obs, set_active
        obs = Obs(source=args.obs)
        set_active(obs)
    cfg = REDUCED[args.arch]() if args.reduced else get_config(args.arch)
    if args.layers is not None and args.layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = ShapeConfig("cli_train", args.seq_len, args.global_batch, "train")
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1))
    data_cfg = DataConfig(seed=args.seed)

    n_mb = step_lib.default_microbatches(shape, mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=dev)
    n_params = api.num_params(params)
    gather = None
    if mesh is None:
        opt_state = adamw.init_opt_state(params, step_lib.N_SHARDS)
    else:
        params = api.shard_params(cfg, params, mesh, device=dev)
        opt_state = adamw.init_opt_state(params, world,
                                         param_specs=params.layout.specs,
                                         mesh=mesh)
        gather = step_lib.gather_state(params, mesh)
    train_step = step_lib.build_train_step(cfg, params, opt_cfg, mesh=mesh,
                                           n_microbatches=n_mb, obs=obs)

    record = {"arch": cfg.name, "device": str(dev), "n_microbatches": n_mb,
              "params": n_params, "start_step": 0,
              "restore_s": None, "steps": []}
    if mesh is not None:
        record["mesh"] = [args.mesh_data, args.mesh_model]
    start_step = 0
    ckpt = Checkpointer(args.ckpt_dir, write=rank == 0)
    if args.resume and latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        tmpl = {"params": params.state_dict(), "opt": opt_state}
        start_step, tree, meta = restore(args.ckpt_dir, tmpl)
        # Validated ingestion: a checkpoint that restores NaN/Inf params
        # would train to garbage silently; fail loudly at the boundary.
        from ..resilience.validate import check_finite_tree
        if mesh is None:
            check_finite_tree(tree["params"], what="restored params")
            with torch.no_grad():
                params.load_state_dict(tree["params"])
            _copy_into(opt_state, tree["opt"])
        else:
            step_lib.load_state(params, opt_state, tree, mesh)
            check_finite_tree(params.state_dict(), what="restored params")
        del tree
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record.update(start_step=start_step,
                      restore_s=time.perf_counter() - t0)
        if rank == 0:
            print(f"[resume] step {start_step} from {args.ckpt_dir} "
                  f"(meta={meta})")

    hb_path = os.path.join(args.ckpt_dir, "heartbeat")
    os.makedirs(args.ckpt_dir, exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    b5_before = b5.flash_attention.launches
    wkv6_before = (wkv6.wkv6.launches, wkv6.wkv6_bwd.launches)
    t_start = time.perf_counter()
    metrics = None
    engine_ctx = obs.attach_engine() if obs else contextlib.nullcontext()
    with engine_ctx:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = global_batch_at(data_cfg, cfg, shape, n_mb, step,
                                    device=dev)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            m = {k: float(v) for k, v in metrics.items()}  # waits
            t_step = time.perf_counter() - t0
            record["steps"].append({"step": step, **m, "step_s": t_step})
            if args.max_step_seconds and t_step > args.max_step_seconds:
                raise TimeoutError(
                    f"step {step} exceeded watchdog "
                    f"({t_step:.1f}s > {args.max_step_seconds}s)")
            if rank == 0:
                with open(hb_path, "w") as f:
                    f.write(str(step))
            if rank == 0 and (step % args.log_every == 0
                              or step == args.steps - 1):
                print(f"step {step:6d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                      f"({t_step:.2f}s/step)", flush=True)
            if (args.ckpt_every and (step + 1) % args.ckpt_every == 0
                    and step + 1 < args.steps):
                ckpt.save_async(step + 1,
                                {"params": params.state_dict(),
                                 "opt": opt_state},
                                meta={"arch": cfg.name}, gather=gather)
    if not args.no_final_ckpt:
        ckpt.save_async(args.steps, {"params": params.state_dict(),
                                     "opt": opt_state},
                        meta={"arch": cfg.name, "final": True},
                        gather=gather)
    ckpt.close()
    t_total = time.perf_counter() - t_start
    n_steps = args.steps - start_step
    record.update(train_s=t_total, ckpt=ckpt.timings)
    if mesh is not None:
        mine = {"rank": rank, "step_s": [s["step_s"] for s in
                                         record["steps"]],
                "loss": [s["loss"] for s in record["steps"]],
                "grad_norm": [s["grad_norm"] for s in record["steps"]],
                "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if dev.type == "cuda" else None),
                "local_heads": (params.layers[0].attn.wq.shape[1]
                                // cfg.resolved_head_dim
                                if cfg.family != "ssm" else None),
                "launches": {"flash_attention":
                             b5.flash_attention.launches - b5_before,
                             "wkv6": wkv6.wkv6.launches - wkv6_before[0],
                             "wkv6_bwd": (wkv6.wkv6_bwd.launches
                                          - wkv6_before[1])}}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, mine)
        record["per_rank"] = per_rank
        dist.barrier()
        if rank:
            return record
    final = (f"{record['steps'][-1]['loss']:.4f}" if record["steps"]
             else "n/a")
    print(f"trained {n_steps} steps in {t_total:.1f}s; final loss {final}")
    if obs is not None:
        from ..obs import set_active
        obs.gauge("train.steps_per_s").set(n_steps / max(t_total, 1e-9))
        obs.counter("train.steps").inc(n_steps)
        jsonl, chrome = obs.save(args.obs_dir, stem=args.obs)
        record["obs"] = [str(jsonl), str(chrome)]
        print(f"obs: {jsonl}")
        print(f"obs: {chrome}  (load in ui.perfetto.dev)")
        print(f"obs summary: {obs.summary()}")
        set_active(None)
    return record


if __name__ == "__main__":
    main()
