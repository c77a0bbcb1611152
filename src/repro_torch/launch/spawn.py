"""Spawning a mesh's ranks for a command line (``launch/train.py``,
``launch/serve.py``).

Run plainly with a mesh above 1 x 1, a launcher starts one process a rank
with :func:`spawn_ranks`: ``multiprocessing``'s ``spawn`` context, a
``file://`` store in a directory of the caller's, the backend of
:func:`repro_torch.launch.mesh.backend_for`.  Each rank joins the group and
runs the launcher's ``main(argv)``; rank 0's return value is the run's.  A
rank that fails (or exits without a result) fails the run, and so do ranks
still running past ``timeout_s``: every rank is killed either way, and the
store is removed.  Under ``torchrun`` (or a caller that initialised the
group) a launcher joins that group instead (:func:`join_env_group`).

A script that calls a launcher's ``main`` with a mesh must guard its own
entry with ``if __name__ == "__main__"``: the spawned ranks import it.
"""
from __future__ import annotations

import datetime
import os
import queue
import sys
import time
import traceback
from typing import Callable

import torch.distributed as dist

from ..kernels.engine import resolve_device
from .mesh import backend_for

__all__ = ["DIST_TIMEOUT_S", "spawn_ranks", "join_env_group"]

# The collective timeout of a mesh's process group, s.
DIST_TIMEOUT_S = 600


def _group_kw(device, world: int) -> dict:
    return dict(backend=backend_for(resolve_device(device), world),
                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def join_env_group(device, world: int) -> None:
    """Join the group that ``torchrun`` describes in the environment."""
    dist.init_process_group(init_method="env://", **_group_kw(device, world))


def _rank_main(target: Callable, rank: int, world: int, init_method: str,
               device, argv, results) -> None:
    """One spawned rank: join the group, run ``target(argv)``, and put rank
    0's result (or any rank's traceback) on ``results``.  A rank that
    succeeded leaves with ``os._exit(0)`` once its result is flushed: the
    interpreter's own teardown, after a ``DeviceMesh`` on gloo, aborts now
    and then (``terminate called without an active exception``, about one
    process in 40 on the CPU with torch 2.13) after all work is done."""
    try:
        dist.init_process_group(init_method=init_method, rank=rank,
                                world_size=world, **_group_kw(device, world))
        out = target(argv)
        results.put({"rank": rank, "result": out if rank == 0 else None})
    except BaseException:   # noqa: BLE001 - the parent fails the run on it
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.close()
    results.join_thread()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn_ranks(target: Callable, argv, *, world: int, device,
                store_dir: str, timeout_s: float | None, what: str):
    """Run ``target(argv)`` (a module-level function) in ``world`` spawned
    ranks on a ``file://`` store under ``store_dir``; return rank 0's
    result.  A rank that fails (or exits without a result), or ranks still
    running ``timeout_s`` after the start (None: no limit), kill every rank
    and raise ``RuntimeError`` naming ``what``."""
    import multiprocessing as mp
    deadline = (None if timeout_s is None
                else time.monotonic() + timeout_s)
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(store_dir),
                         f".store.{os.getpid()}.{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        target, r, world, f"file://{store}", device, argv, results))
        for r in range(world)]
    recs, failed = {}, None
    try:
        for p in procs:
            p.start()
        while len(recs) < world and failed is None:
            if deadline is not None and time.monotonic() > deadline:
                failed = f"past the run's limit of {timeout_s:.1f} s"
                break
            try:
                r = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    failed = f"a rank exited {dead} without a result"
                continue
            if "error" in r:
                failed = f"rank {r['rank']} failed:\n{r['error']}"
            recs[r["rank"]] = r
        for p in procs:
            wait = 60.0 if deadline is None else deadline - time.monotonic()
            p.join(timeout=max(min(wait, 60.0), 0.1)
                   if failed is None else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.remove(store)
    if failed is not None:
        raise RuntimeError(f"{what}: {failed}")
    return recs[0]["result"]
