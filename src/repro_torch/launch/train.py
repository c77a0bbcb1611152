"""End-to-end training command line (port of ``repro/launch/train.py``).

Thin CLI over the step layer: :func:`repro_torch.dist.step.build_train_step`
builds the grad-accumulating AdamW step (flat ZeRO-1 layout, one shard on
one device), whose attention runs on the CUDA kernel B5 (forward, and
again in each block's remat recompute).  This module owns the loop: data,
checkpoints, logging.

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

The port runs on one device: ``--mesh-data`` / ``--mesh-model`` other
than 1 raise (the distributed operator is ROADMAP A.12, sharding A.13).
A periodic checkpoint that would fall on the last step is left to the
final one, which the reference writes at the same step as well.

On the card, at llama3.2-1b's full width:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 4 --seq-len 2048 --global-batch 8 --ckpt-dir build/ckpt

On the CPU, reduced:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --device cpu --steps 20 --seq-len 64 --global-batch 8
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from ..checkpoint import Checkpointer, latest_step, restore
from ..configs import REDUCED, get_config
from ..configs.base import ShapeConfig
from ..data import DataConfig, global_batch_at
from ..dist import step as step_lib
from ..kernels.engine import resolve_device
from ..models import api
from ..optim import adamw
from ..optim.adamw import OptConfig

__all__ = ["build_args", "main"]


def build_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
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


def main(argv=None) -> dict:
    """Run the CLI; returns the run's record: per-step ``loss``,
    ``grad_norm``, ``lr``, ``tokens`` and ``step_s``, the checkpoint
    timings and the restore's seconds."""
    args = build_args(argv)
    if args.mesh_data != 1 or args.mesh_model != 1:
        raise NotImplementedError(
            f"mesh {args.mesh_data}x{args.mesh_model}: the port trains on one "
            "device; the distributed operator is ROADMAP A.12 and sharding "
            "(dist/sharding.py, launch/mesh.py) A.13")
    # Chaos harness: honour REPRO_FAULT_PLAN.
    from ..resilience.inject import install_from_env
    install_from_env()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    obs = None
    if args.obs:
        from ..obs import Obs, set_active
        obs = Obs(source=args.obs)
        set_active(obs)
    cfg = REDUCED[args.arch]() if args.reduced else get_config(args.arch)
    shape = ShapeConfig("cli_train", args.seq_len, args.global_batch, "train")
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1))
    data_cfg = DataConfig(seed=args.seed)

    n_mb = step_lib.default_microbatches(shape)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=dev)
    train_step = step_lib.build_train_step(cfg, params, opt_cfg,
                                           n_microbatches=n_mb, obs=obs)
    opt_state = adamw.init_opt_state(params, step_lib.N_SHARDS)

    record = {"arch": cfg.name, "device": str(dev), "n_microbatches": n_mb,
              "params": api.num_params(params), "start_step": 0,
              "restore_s": None, "steps": []}
    start_step = 0
    ckpt = Checkpointer(args.ckpt_dir)
    if args.resume and latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        tmpl = {"params": params.state_dict(), "opt": opt_state}
        start_step, tree, meta = restore(args.ckpt_dir, tmpl)
        # Validated ingestion: a checkpoint that restores NaN/Inf params
        # would train to garbage silently; fail loudly at the boundary.
        from ..resilience.validate import check_finite_tree
        check_finite_tree(tree["params"], what="restored params")
        with torch.no_grad():
            params.load_state_dict(tree["params"])
        _copy_into(opt_state, tree["opt"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record.update(start_step=start_step,
                      restore_s=time.perf_counter() - t0)
        print(f"[resume] step {start_step} from {args.ckpt_dir} "
              f"(meta={meta})")

    hb_path = os.path.join(args.ckpt_dir, "heartbeat")
    os.makedirs(args.ckpt_dir, exist_ok=True)
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
            with open(hb_path, "w") as f:
                f.write(str(step))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:6d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                      f"({t_step:.2f}s/step)", flush=True)
            if (args.ckpt_every and (step + 1) % args.ckpt_every == 0
                    and step + 1 < args.steps):
                ckpt.save_async(step + 1,
                                {"params": params.state_dict(),
                                 "opt": opt_state},
                                meta={"arch": cfg.name})
    ckpt.save_async(args.steps, {"params": params.state_dict(),
                                 "opt": opt_state},
                    meta={"arch": cfg.name, "final": True})
    ckpt.close()
    t_total = time.perf_counter() - t_start
    n_steps = args.steps - start_step
    record.update(train_s=t_total, ckpt=ckpt.timings)
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
