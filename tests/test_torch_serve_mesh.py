"""Serving across devices (ROADMAP A.13, item 5) on the CPU: the port's
``ServeQueue`` and ``ExecutorPool`` on a ``data x model`` mesh of gloo
ranks (processes of their own on a ``file://`` store under the test's
``tmp_path``, every rank killed at ``RANK_LIMIT_S``, as in
``tests/test_torch_mesh.py``), against the reference's one-device queue
from the same numpy parameters (reduced llama3.2-1b, fp32).

* At (1, 2), (2, 1) and (2, 2): rank 0 schedules, the others follow; every
  rank's greedy and ``temperature = 0.7`` streams equal the reference's
  sequential queue's (its coalesced 0.7 case is a known red of the
  reference, ROADMAP §C), and the pool's buckets and builds equal the
  reference's pool's at the same schedule.
* A ``serve.step`` fault planted on the last rank alone: every rank
  retries the step (rank 0 counts one retry), the streams stay the same,
  and the ranks finish inside the limit.
* The data-axis batch rule: a group of 3 at ``data = 2`` pads to 2 rows a
  rank inside the step (the rank's cache holds 2 rows) and serves the
  reference's one-device tokens, where the reference's jit raises for a
  batch its data axis does not divide.
* ``launch/serve.py --mesh-data 2 --mesh-model 2 --reduced`` spawns its
  ranks, prints on rank 0 only, emits the one-device launcher's tokens on
  every rank, and kills its ranks at ``timeout_s``.
* ``benchmarks/serve_traffic.py::run_traffic`` with a mesh: rank 0's
  stats equal the one-device pass's structure and the followers emit
  every token.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TEST_SEED
from repro.configs import REDUCED as REF_REDUCED
from repro.launch.mesh import make_test_mesh as ref_make_test_mesh
from repro.models import api as ref_api
from repro.serve import queue as ref_queue
from repro.serve.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch.benchmarks import serve_traffic
from repro_torch.configs import REDUCED
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api
from repro_torch.serve.queue import ServeQueue
from repro_torch.serve.scheduler import SchedulerConfig
from test_torch_mesh import ROOT, RANK_LIMIT_S, _port_tree, _spawn

# The end of every rank body here: the rank's outputs, then out of the
# process without the interpreter's teardown, in which gloo under a
# DeviceMesh aborts now and then after all work is done (about one process
# in 40 on the CPU; ``repro_torch.launch.spawn._rank_main`` does the same).
EXIT = """
np.savez(work / f"rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
import os as _os
sys.stdout.flush()
sys.stderr.flush()
_os._exit(0)
"""

ARCH = "llama3.2-1b"
# Two prompt lengths: a group of 3 (which data = 2 does not divide) and a
# group of 2; mixed budgets, so rows stop emitting at different steps.
PROMPT_LENS = [8, 8, 8, 5, 5]
GEN_LENS = [3, 2, 4, 4, 2]
RIDS = [700, 701, 702, 703, 704]
TEMPERATURES = (0.0, 0.7)
COALESCED = dict(max_in_flight=2, max_batch=8, min_batch=1, max_wait_s=0.0)
SEQUENTIAL = dict(max_in_flight=1, max_batch=1, min_batch=1, max_wait_s=0.0)


@pytest.fixture(scope="module")
def served():
    """The reference's fp32 parameters, the prompts, and its one-device
    queues' streams: sequential at each temperature, and the coalesced
    greedy run's pool."""
    cfg = dataclasses.replace(REF_REDUCED[ARCH](), dtype=jnp.float32)
    rp = ref_api.init_params(cfg, jax.random.key(TEST_SEED))
    rng = np.random.default_rng(TEST_SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    mesh = ref_make_test_mesh(1, 1)
    streams = {}
    for t in TEMPERATURES:
        q = ref_queue.ServeQueue(cfg, mesh, rp, temperature=t,
                                 seed=TEST_SEED,
                                 config=RefSchedulerConfig(**SEQUENTIAL))
        streams[t] = {r.rid: r.tokens for r in _drive(q, prompts)}
    q = ref_queue.ServeQueue(cfg, mesh, rp, seed=TEST_SEED,
                             config=RefSchedulerConfig(**COALESCED))
    greedy = {r.rid: r.tokens for r in _drive(q, prompts)}
    assert greedy == streams[0.0]
    pool = {"buckets": len(q.pool), "builds": q.pool.builds,
            "keys": sorted(q.pool._bundles)}
    return cfg, rp, prompts, streams, pool


def _drive(q, prompts):
    """Submit everything at t=0 on a virtual clock and run to idle."""
    reqs = [q.submit(p, g, now=0.0, rid=rid)
            for p, g, rid in zip(prompts, GEN_LENS, RIDS)]
    t = 0.0
    while q.pending:
        if not q.step(now=t):
            break
        t += 1.0
    return reqs


def _decode(o: dict, tag: str) -> dict:
    return {int(k.split("/")[1]): [int(t) for t in v]
            for k, v in o.items() if k.startswith(tag + "/")}


_QUEUE_BODY = """
import json
from repro_torch.resilience import inject
from repro_torch.serve.queue import ServeQueue
from repro_torch.serve.scheduler import SchedulerConfig
d, m = (int(x) for x in inp["mesh"])
mesh = make_test_mesh(d, m, device="cpu")
cfg = config()
params = api.shard_params(cfg, full_model(cfg), mesh, device="cpu")
spec = json.loads(str(inp["spec"]))
prompts = spec["prompts"]


def serve(tag, temperature, config, retry_kw=None, fault=None):
    q = ServeQueue(cfg, params, mesh=mesh, temperature=temperature,
                   seed=spec["seed"], config=SchedulerConfig(**config),
                   retry_kw=retry_kw)
    if fault is not None and rank == world - 1:
        inject.set_plan(inject.FaultPlan.parse(fault))
    try:
        if rank == 0:
            try:
                for p, g, rid in zip(prompts, spec["gen"], spec["rids"]):
                    q.submit(p, g, now=0.0, rid=rid)
                t = 0.0
                while q.pending and q.step(now=t):
                    t += 1.0
            finally:
                q.stop()
        else:
            q.follow()
    finally:
        inject.set_plan(None)
    for rid, toks in q.streams.items():
        out[f"{tag}/{rid}"] = np.asarray(toks, np.int64)
    return q


for i, t in enumerate(spec["temperatures"]):
    serve(f"seq{i}", t, spec["sequential"])
q = serve("coal", 0.0, spec["coalesced"])
out["buckets"] = len(q.pool)
out["builds"] = q.pool.builds
out["slots"] = q.pool.slots
out["graphed"] = int(q.pool.graphed)
out["keys"] = np.array(sorted(q.pool._bundles))
b3 = next(b for k, b in q.pool._bundles.items() if k[0] == 3)
out["rows_of_3"] = b3.slots[0].cache["k"].shape[1]
retries = []
serve("fault", 0.0, spec["coalesced"], fault="serve.step:raise:1",
      retry_kw=dict(retries=2, backoff_s=1e-3,
                    on_retry=lambda n, e: retries.append(type(e).__name__)))
out["retries"] = np.array(len(retries))
""" + EXIT


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)],
                         ids=["1x2", "2x1", "2x2"])
def test_queue_on_a_mesh_emits_the_reference_streams(tmp_path, served,
                                                      mesh):
    cfg, rp, prompts, streams, pool = served
    spec = {"prompts": prompts, "gen": GEN_LENS, "rids": RIDS,
            "seed": TEST_SEED, "temperatures": list(TEMPERATURES),
            "sequential": SEQUENTIAL, "coalesced": COALESCED}
    pcfg = dataclasses.replace(REDUCED[ARCH](), dtype=torch.float32)
    outs = _spawn(tmp_path, mesh[0] * mesh[1], _QUEUE_BODY,
                  mesh=np.array(mesh), spec=np.array(json.dumps(spec)),
                  **_port_tree(rp, pcfg))
    for r, o in enumerate(outs):
        for i, t in enumerate(TEMPERATURES):
            assert _decode(o, f"seq{i}") == streams[t], (r, t)
        assert _decode(o, "coal") == streams[0.0], r
        # the pool counts the reference's buckets, on every rank
        assert int(o["buckets"]) == int(o["builds"]) == pool["buckets"]
        assert [tuple(k) for k in o["keys"]] == pool["keys"]
        assert int(o["slots"]) >= pool["buckets"]
        assert not int(o["graphed"])
        # a group of 3: ceil(3 / data) rows a rank
        assert int(o["rows_of_3"]) == -(-3 // mesh[0])
        # the fault on the last rank: one retry on rank 0, same tokens
        assert _decode(o, "fault") == streams[0.0], r
    assert int(outs[0]["retries"]) == 1


_REF_MESH_RAISES = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import REDUCED
from repro.launch.mesh import make_test_mesh
from repro.models import api
from repro.serve.queue import ServeQueue
cfg = dataclasses.replace(REDUCED["llama3.2-1b"](), dtype=jnp.float32)
q = ServeQueue(cfg, make_test_mesh(2, 1), api.init_params(cfg,
                                                         jax.random.key(0)))
for _ in range(3):
    q.submit([1, 2, 3, 4], 2, now=0.0)
try:
    q.drain()
except ValueError as e:
    print("raised:", "divisible by 2" in str(e))
"""


def test_the_reference_raises_where_the_port_pads():
    """The reference's jit refuses a batch of 3 on its data axis of 2
    (``in_shardings`` must divide): the divergence the port documents in
    ``dist/step.py``, whose padding the mesh test above pins."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _REF_MESH_RAISES], env=env,
                         capture_output=True, text=True,
                         timeout=RANK_LIMIT_S)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "raised: True" in res.stdout


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_ARGV = ["--arch", ARCH, "--reduced", "--device", "cpu", "--dtype",
         "float32", "--batch", "3", "--prompt-len", "8", "--gen-len", "4",
         "--max-batch", "2"]


def test_launch_serve_on_a_2x2_mesh(capfd, monkeypatch):
    """Spawned ranks (gloo on the CPU), rank 0 alone printing, every rank
    emitting the one-device launcher's tokens (fp32)."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    one = launch_serve.main(_ARGV)
    capfd.readouterr()
    rec = launch_serve.main(_ARGV + ["--mesh-data", "2", "--mesh-model", "2"],
                            timeout_s=RANK_LIMIT_S)
    out = capfd.readouterr().out
    assert out.count("served 3/3 requests") == 1
    assert "2x2 mesh" in out
    assert rec["mesh"] == [2, 2] and rec["completed"] == 3
    want = {r.rid: r.tokens for r in one.completed}
    assert rec["streams"] == want
    assert [r["rank"] for r in rec["per_rank"]] == [0, 1, 2, 3]
    assert all(r["streams"] == want for r in rec["per_rank"])
    assert all(r["local_heads"] == REDUCED[ARCH]().num_heads // 2
               for r in rec["per_rank"])
    assert rec["pool"]["buckets"] == len(one.pool)


def test_launch_serve_on_a_mesh_under_obs_keeps_the_tokens(tmp_path,
                                                          monkeypatch):
    """``--obs`` on a (1, 2) mesh: rank 0 alone warms the LOOPS plan cache
    (from its full model, every layer's FFN weight) and writes the
    capture; the tokens are the run's without it."""
    from repro.obs.export import load_obs as ref_load_obs
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    mesh = ["--mesh-data", "1", "--mesh-model", "2"]
    plain = launch_serve.main(_ARGV + mesh, timeout_s=RANK_LIMIT_S)
    rec = launch_serve.main(_ARGV + mesh + [
        "--obs", "cap", "--obs-dir", str(tmp_path / "obs")],
        timeout_s=RANK_LIMIT_S)
    assert rec["streams"] == plain["streams"]
    assert all(r["streams"] == plain["streams"] for r in rec["per_rank"])
    recs = ref_load_obs(tmp_path / "obs" / "cap.jsonl")
    warm = [r for r in recs if r["kind"] == "gauge"
            and r["metric"] == "serve.warm_layers"]
    assert [r["value"] for r in warm] == [REDUCED[ARCH]().num_layers]
    assert sorted(os.listdir(tmp_path / "obs")) == ["cap.jsonl",
                                                    "cap.trace.json"]


def test_launch_serve_ranks_past_the_limit_are_killed(monkeypatch):
    import multiprocessing as mp
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    with pytest.raises(RuntimeError, match="past the run's limit"):
        launch_serve.main(_ARGV + ["--mesh-data", "2", "--gen-len", "100000"],
                          timeout_s=0.5)
    assert not mp.active_children()


# ---------------------------------------------------------------------------
# the load benchmark
# ---------------------------------------------------------------------------

_TRAFFIC_BODY = """
from repro_torch.benchmarks import serve_traffic
from repro_torch.serve.queue import ExecutorPool
from repro_torch.serve.scheduler import SchedulerConfig
mesh = make_test_mesh(1, 2, device="cpu")
cfg = config()
params = api.shard_params(cfg, full_model(cfg), mesh, device="cpu")
trace = serve_traffic.build_trace(np.random.default_rng(3), 3, 2,
                                  serve_traffic.SMOKE_SHAPES,
                                  cfg.vocab_size)
pool = ExecutorPool(cfg, params, mesh=mesh)
res = serve_traffic.run_traffic(
    cfg, params, trace, pool=pool, mesh=mesh, seed=0,
    sched_cfg=SchedulerConfig(max_in_flight=2, max_batch=8, max_wait_s=2.0))
if rank == 0:
    for k in ("completed", "n_requests", "engine_calls", "tokens"):
        out[k] = res[k]
else:
    out["tokens"] = sum(len(v) for v in res["streams"].values())
""" + EXIT


def test_run_traffic_on_a_mesh(tmp_path, served):
    """One closed-loop pass on a (1, 2) mesh: rank 0's engine calls and
    tokens equal the same pass on one device, and the follower emits
    every token."""
    _, rp, _, _, _ = served
    cfg = dataclasses.replace(REDUCED[ARCH](), dtype=torch.float32)
    outs = _spawn(tmp_path, 2, _TRAFFIC_BODY, **_port_tree(rp, cfg))
    from repro_torch.models import transformer
    from repro_torch.serve.queue import ExecutorPool
    params = transformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, rp), device="cpu")
    trace = serve_traffic.build_trace(np.random.default_rng(3), 3, 2,
                                      serve_traffic.SMOKE_SHAPES,
                                      cfg.vocab_size)
    want = serve_traffic.run_traffic(
        cfg, params, trace, pool=ExecutorPool(cfg, params), seed=0,
        sched_cfg=SchedulerConfig(max_in_flight=2, max_batch=8,
                                  max_wait_s=2.0))
    for k in ("completed", "n_requests", "engine_calls", "tokens"):
        assert int(outs[0][k]) == want[k], k
    assert want["completed"] == want["n_requests"]
    assert int(outs[1]["tokens"]) == want["tokens"]


def test_a_follower_cannot_schedule_and_a_pool_keeps_its_mesh():
    cfg = dataclasses.replace(REDUCED[ARCH](), dtype=torch.float32)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    q = ServeQueue(cfg, params)
    assert q.pool.leader and q.pool.wire is None
    q.stop()                       # no mesh: nothing to tell
    with pytest.raises(RuntimeError, match="ranks other than 0"):
        q.follow()
    with pytest.raises(ValueError, match="another mesh"):
        ServeQueue(cfg, params, mesh=object(), pool=q.pool)
