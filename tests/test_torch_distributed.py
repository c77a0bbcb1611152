"""The port's distributed LOOPS operator (``repro_torch.core.distributed``,
``dist/sharding.py``, ``dist/step.py::loops_cotangent_psum``,
``dist/compress.py``, ``launch/mesh.py``) against the reference on the CPU.

* In-process, no process group: ``shard_loops`` is array-equal to the
  reference's (the reference tests' splits, and the pure formats), each
  rank's chunk format covers its rows, ``shard_loops_auto`` picks the
  reference's split (calibrated model, nnz fallback, a cache miss then a
  hit, a ``TraceDB`` empty and not), the D = 1 ``ValueError``, and the
  LOOPS placements against the reference's ``PartitionSpec`` s.  A 1 x 1
  mesh on a single-rank ``HashStore`` group.
* Multi-process, gloo on the CPU: ``distributed_spmm`` at D = 8 at the
  reference tests' splits and shapes against dense numpy (forward assembled
  and stacked, batched, dB for both layouts), and ``compressed_psum`` at
  D = 4 against the reference's bounds and its int8 result, the byte
  gauge, and a fault on one rank that degrades every rank.

Every multi-process test runs its ranks as processes of their own, once,
on a ``file://`` store under ``tmp_path`` (no port to collide on), with the
gloo timeout and a wall-clock limit of ``RANK_LIMIT_S`` enforced here: a
rank that fails or overruns fails the test, and every rank is killed.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.core import distributed as rdist
from repro.core import formats as rf
from repro.core.perf_model import calibrate as rcalibrate
from repro.dist import sharding as rshr
from repro.perf.replay import TraceDB as RTraceDB
from repro.tune import cache as rcache
from repro_torch.core import distributed as tdist
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core.perf_model import calibrate as tcalibrate
from repro_torch.dist import sharding as tshr
from repro_torch.perf.replay import TraceDB as TTraceDB
from repro_torch.tune import cache as tcache

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Each multi-process test's wall-clock limit, and its ranks' gloo timeout.
RANK_LIMIT_S = 120
GLOO_TIMEOUT_S = 60

FIELDS = ("row_ids", "col_idx", "vals", "tile_rows", "tile_cols",
          "tile_vals", "row_offset", "row_count", "rows_pad", "g_vpu", "br",
          "shape")


def _sparse(rng, m, k, density):
    return ((rng.random((m, k)) < density)
            * rng.standard_normal((m, k))).astype(np.float32)


# (name, matrix, r_boundary, D, g_vpu): the reference tests' splits
# (tests/test_distributed.py at 210 x 64, tests/test_dist.py at 64 x 40)
# and the two pure formats.
def _cases():
    a210 = _sparse(np.random.default_rng(0), 210, 64, 0.15)
    a64 = _sparse(np.random.default_rng(0), 64, 40, 0.25)
    out = [(f"210x64-{g}-{f}", a210, int(210 * f) // 8 * 8, 8, g)
           for g, f in [(2, 0.25), (4, 0.5), (7, 0.9)]]
    out.append(("64x40-3", a64, 32, 8, 3))
    out.append(("pure-csr", a210, 210, 8, 8))
    out.append(("pure-bcsr", a210, 0, 8, 0))
    return out


CASES = _cases()


def _both(a, r_b, d, g):
    ref = rdist.shard_loops(rf.loops_from_csr(rf.csr_from_dense(a), r_b, 8),
                            d, g)
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), r_b, 8)
    return ref, fmt, tdist.shard_loops(fmt, d, g)


@pytest.mark.parametrize("name,a,r_b,d,g", CASES, ids=[c[0] for c in CASES])
def test_shard_loops_array_equal(name, a, r_b, d, g):
    ref, _, got = _both(a, r_b, d, g)
    for f in FIELDS:
        want, have = getattr(ref, f), getattr(got, f)
        if isinstance(want, np.ndarray):
            assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(np.asarray(have), np.asarray(want),
                                      err_msg=f)
    # past each rank's real count there is only padding
    for r in range(d):
        assert not got.vals[r, got.nnz_count[r]:].any()
        assert not got.tile_vals[r, got.tile_count[r]:].any()


@pytest.mark.parametrize("name,a,r_b,d,g", CASES, ids=[c[0] for c in CASES])
def test_chunk_formats_cover_their_rows(name, a, r_b, d, g):
    """Each rank's single-part chunk is exactly its rows of A: CSR-group
    chunks have no BCSR rows and BCSR-group chunks no CSR rows."""
    _, _, sh = _both(a, r_b, d, g)
    b = np.random.default_rng(1).standard_normal((a.shape[1], 5)) \
        .astype(np.float32)
    seen = 0
    for r in range(d):
        o, c = sh.row_offset[r], sh.row_count[r]
        chunk = sh.chunk(r)
        if c == 0:
            assert chunk is None
            continue
        assert chunk.shape == (c, a.shape[1])
        assert chunk.r_boundary == (c if r < sh.g_vpu else 0)
        got = tspmm.loops_spmm(chunk, torch.from_numpy(b), device="cpu",
                               backend="torch")
        np.testing.assert_allclose(got.numpy(), a[o:o + c] @ b, rtol=1e-5,
                                   atol=1e-5)
        assert sh.chunk(r) is chunk          # built once
        seen += c
    assert seen == a.shape[0]


def _auto_matrix():
    a = _sparse(np.random.default_rng(0), 96, 32, 0.2)
    return (rf.loops_from_csr(rf.csr_from_dense(a), 48, 8),
            tf.loops_from_csr(tf.csr_from_dense(a), 48, 8))


def _model(calibrate):
    # tests/test_dist.py: the vector unit scales linearly, the matrix unit
    # saturates past 2 workers
    return calibrate(lambda x, y: 1.0 * x + 4.0 * min(y, 2)
                     + 0.3 * max(y - 2, 0), total=8)


def _synth_spmm(x, y, g, gflops):
    return {"schema": 1, "kind": "spmm", "source": "synth", "t_vpu": x,
            "t_mxu": y, "panel_g": g, "gflops": gflops}


_RICH = [_synth_spmm(x, y, 1, 1.0 * x + 4.0 * y)
         for x in (1, 2, 4, 6, 8) for y in (1, 3, 5)]


@pytest.mark.parametrize("how", ["model", "measure", "nnz", "trace_db_rich",
                                 "trace_db_empty"])
def test_shard_loops_auto_picks_the_reference_split(how):
    rfmt, tfmt = _auto_matrix()
    kw = {"model": lambda p: {"model": _model(p["calibrate"])},
          "measure": lambda p: {"measure": lambda x, y: 2.0 * x + y
                                - 0.1 * x * x},
          "nnz": lambda p: {},
          "trace_db_rich": lambda p: {"trace_db": p["db"](records=_RICH)},
          "trace_db_empty": lambda p: {"trace_db": p["db"](records=[])}}[how]
    ref = rdist.shard_loops_auto(
        rfmt, 8, **kw({"calibrate": rcalibrate, "db": RTraceDB}))
    got = tdist.shard_loops_auto(
        tfmt, 8, **kw({"calibrate": tcalibrate, "db": TTraceDB}))
    assert got.g_vpu == ref.g_vpu
    assert 1 <= got.g_vpu <= 7
    assert sum(got.row_count) == tfmt.nrows
    if how == "model":
        assert got.g_vpu == _model(tcalibrate).best_allocation(8)[0]


def test_shard_loops_auto_cache_miss_then_hit(tmp_path):
    """The first call stores its split under backend ``dist8``; the second
    hits it without solving Eq. 3, in both packages alike."""
    rfmt, tfmt = _auto_matrix()
    rc = rcache.PlanCache(str(tmp_path / "ref"))
    tc = tcache.PlanCache(str(tmp_path / "port"))
    model = _model(tcalibrate)
    for pkg_calls in range(2):
        ref = rdist.shard_loops_auto(rfmt, 8, model=_model(rcalibrate),
                                     cache=rc)
        got = tdist.shard_loops_auto(tfmt, 8, model=model, cache=tc)
        assert got.g_vpu == ref.g_vpu
    assert (tc.stats.misses, tc.stats.hits) == (rc.stats.misses,
                                                rc.stats.hits) == (1, 1)
    # the hit ignores the solver: another model gives the cached split
    other = tdist.shard_loops_auto(tfmt, 8, cache=tc)
    assert other.g_vpu == got.g_vpu and tc.stats.hits == 2
    rec = json.loads((tmp_path / "port" / "plans.json").read_text())
    assert [e["backend"] for e in rec["entries"].values()] == ["dist8"]


def test_shard_loops_auto_one_device_raises():
    rfmt, tfmt = _auto_matrix()
    with pytest.raises(ValueError):
        rdist.shard_loops_auto(rfmt, 1)
    with pytest.raises(ValueError, match=">= 2 devices"):
        tdist.shard_loops_auto(tfmt, 1)


def _placement(spec):
    """A reference ``PartitionSpec`` on the worker axis as a placement."""
    return Replicate() if spec == P() else Shard(0)


@pytest.mark.parametrize("axis", ["model", ("model",), ("data", "model")])
def test_loops_specs_match_the_reference(axis):
    assert tshr.loops_axis_spec(axis) == rshr.loops_axis_spec(axis)
    want = tuple(_placement(s) for s in rshr.loops_in_specs(axis))
    assert tshr.loops_in_specs(axis) == want
    assert tshr.loops_out_spec(axis) == _placement(rshr.loops_out_spec(axis))
    assert want == (Shard(0),) * 6 + (Replicate(),)


@pytest.fixture
def one_rank_group():
    """A 1 x 1 mesh's single-rank group, torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    try:
        yield make_test_mesh(1, 1, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_one_by_one_mesh_needs_no_launcher(one_rank_group):
    """A 1 x 1 mesh runs a pure format on one rank (the hybrid case needs
    two groups, so two ranks), ``compressed_psum`` returns its input with
    zero wire bytes, and the cotangent reduction is the identity."""
    from repro_torch.dist.compress import compressed_psum
    from repro_torch.launch.mesh import dp_axes, flat_axes
    from repro_torch.obs import Obs, set_active
    mesh = one_rank_group
    assert mesh.mesh_dim_names == ("data", "model")
    assert dp_axes(mesh) == ("data",) and flat_axes(mesh) == ("data",
                                                              "model")
    a = _sparse(np.random.default_rng(2), 40, 24, 0.2)
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), 40, 8)
    sh = tdist.shard_loops_auto(fmt, 1)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((24, 6))
                         .astype(np.float32)).requires_grad_()
    y = tdist.distributed_spmm(sh, b, mesh, device="cpu")
    np.testing.assert_allclose(y.detach().numpy(), a @ b.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    dy = torch.ones_like(y)
    (db,) = torch.autograd.grad(y, b, dy)
    np.testing.assert_allclose(db.numpy(), a.T @ dy.numpy(), rtol=1e-4,
                               atol=1e-4)
    # checked before any rank runs its chunk (a rank with none would not)
    with pytest.raises(ValueError, match="dtype"):
        tdist.distributed_spmm(sh, b.detach().double(), mesh, device="cpu")
    obs = Obs(source="test")
    prev = set_active(obs)
    try:
        x = torch.arange(10, dtype=torch.float32)
        assert compressed_psum(x, None, "int8") is x
    finally:
        set_active(prev)
    assert obs.metrics.gauge("dist.collective_bytes", kind="psum",
                             precision="int8").value == 0.0


def test_mesh_without_a_launcher_raises():
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for, make_test_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 4 processes"):
        make_test_mesh(2, 2, device="cpu")
    assert backend_for("cpu", 4) == "gloo"
    if torch.cuda.device_count() < 4:
        assert backend_for("cuda", 4) == "gloo"


def test_note_collective_counts_calls():
    """Deliberate divergence: the reference notes a collective once per
    compilation (so ``dist.collective_sites`` counts compiled call sites);
    eager PyTorch notes every call."""
    from repro_torch.obs import Obs, note_collective, set_active
    obs = Obs(source="test")
    prev = set_active(obs)
    try:
        for nbytes in (100, 250):
            note_collective(nbytes, kind="psum", precision="bf16")
    finally:
        set_active(prev)
    assert obs.metrics.gauge("dist.collective_bytes", kind="psum",
                             precision="bf16").value == 250.0
    assert obs.metrics.counter("dist.collective_sites", kind="psum",
                               precision="bf16").value == 2.0
    note_collective(7, kind="psum", precision="none")   # no capture: no-op


# ---------------------------------------------------------------------------
# multi-process, gloo on the CPU
# ---------------------------------------------------------------------------

_PRELUDE = """
import datetime, pathlib, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world = int(sys.argv[1]), int(sys.argv[2])
work = pathlib.Path(sys.argv[3])
dist.init_process_group(
    "gloo", init_method=f"file://{work}/store", rank=rank, world_size=world,
    timeout=datetime.timedelta(seconds=%d))
inp = np.load(work / "inputs.npz") if (work / "inputs.npz").exists() else {}
out = {}
""" % GLOO_TIMEOUT_S

_EPILOGUE = """
np.savez(work / f"rank{rank}.npz", **out)
dist.destroy_process_group()
"""


def _spawn(work: pathlib.Path, world: int, body: str, **inputs) -> list:
    """Run ``body`` in ``world`` ranks (one process each, gloo over a
    ``file://`` store in ``work``) with ``inputs`` saved for them, and
    return each rank's ``out`` dict.  Any rank that fails or is still
    running after ``RANK_LIMIT_S`` fails the call; every rank is killed on
    the way out."""
    work.mkdir(parents=True, exist_ok=True)
    if inputs:
        np.savez(work / "inputs.npz", **inputs)
    script = work / "rank.py"
    script.write_text(_PRELUDE + textwrap.dedent(body) + _EPILOGUE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    logs = [open(work / f"log{r}.txt", "w") for r in range(world)]
    procs = []
    deadline = time.monotonic() + RANK_LIMIT_S
    try:
        procs = [subprocess.Popen([sys.executable, str(script), str(r),
                                   str(world), str(work)], env=env,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                          + (work / f"log{r}.txt").read_text()[-3000:]
                          for r, rc in enumerate(rcs))
        pytest.fail(f"ranks exited {rcs} (limit {RANK_LIMIT_S} s):\n{tails}")
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(world)]


def _dense_split(a, r_b, d, g):
    sh = tdist.shard_loops(tf.loops_from_csr(tf.csr_from_dense(a), r_b, 8),
                           d, g)
    return sh.row_offset, sh.row_count, sh.rows_pad


def test_distributed_spmm_device_groups(tmp_path):
    """The reference's three splits at D = 8 against dense numpy: the
    assembled result on every rank, each rank's stacked shard (a DTensor
    of global shape (8, rows_pad, N)), the workload put by
    ``loops_shardings``; the same product over the flattened ("data",
    "model") axis of a 2 x 4 mesh, and over "model" alone with the data
    axis replicating it."""
    a = _sparse(np.random.default_rng(0), 210, 64, 0.15)
    b = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    splits = [(2, 0.25), (4, 0.5), (7, 0.9)]
    outs = _spawn(tmp_path, 8, """
        from repro_torch.core import formats as tf
        from repro_torch.core.distributed import distributed_spmm, shard_loops
        from repro_torch.dist.sharding import loops_shardings
        from repro_torch.launch.mesh import make_test_mesh
        a, b = inp["a"], torch.from_numpy(inp["b"])
        csr = tf.csr_from_dense(a)
        flat8 = make_test_mesh(1, 8, device="cpu")
        two_by_four = make_test_mesh(2, 4, device="cpu")
        for i, (g, f) in enumerate(%r):
            fmt = tf.loops_from_csr(csr, int(210 * f) // 8 * 8, 8)
            sh = shard_loops(fmt, 8, g_vpu=g)
            out[f"y{i}"] = distributed_spmm(sh, b, flat8, device="cpu").numpy()
            st = distributed_spmm(sh, b, flat8, assemble=False, device="cpu")
            out[f"st_shape{i}"] = np.array(st.shape)
            out[f"st{i}"] = st.to_local().numpy()
            out[f"yt{i}"] = distributed_spmm(
                sh, b, two_by_four, axis=("data", "model"),
                device="cpu").numpy()
            if i == 0:
                for name, s in zip(("row_ids", "tile_vals"),
                                   loops_shardings(flat8, "model")[::5]):
                    arr = getattr(sh, name)
                    dt = s.put(arr)
                    assert tuple(dt.shape) == arr.shape, name
                    assert np.array_equal(dt.to_local().numpy(),
                                          arr[rank:rank + 1]), name
        sh4 = shard_loops(tf.loops_from_csr(csr, 104, 8), 4, g_vpu=2)
        out["y4"] = distributed_spmm(sh4, b, two_by_four, axis="model",
                                     device="cpu").numpy()
    """ % (splits,), a=a, b=b)
    want = a @ b
    for i, (g, f) in enumerate(splits):
        off, cnt, rows_pad = _dense_split(a, int(210 * f) // 8 * 8, 8, g)
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o[f"y{i}"], want, rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(o[f"yt{i}"], want, rtol=1e-4,
                                       atol=1e-4)
            assert tuple(o[f"st_shape{i}"]) == (8, rows_pad, 16)
            st = o[f"st{i}"][0]
            np.testing.assert_allclose(st[:cnt[r]],
                                       want[off[r]:off[r] + cnt[r]],
                                       rtol=1e-4, atol=1e-4)
            assert not st[cnt[r]:].any()
        assert all(np.array_equal(o[f"y{i}"], outs[0][f"y{i}"])
                   for o in outs)
    for o in outs:
        np.testing.assert_allclose(o["y4"], want, rtol=1e-4, atol=1e-4)


def test_distributed_spmm_cotangent_psum(tmp_path):
    """dB through autograd, assembled and stacked, at tests/test_dist.py's
    64 x 40 matrix split (8, 3): every rank holds Aᵀ·dY, bit for bit the
    same."""
    rng = np.random.default_rng(0)
    a = _sparse(rng, 64, 40, 0.25)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    dy = rng.standard_normal((64, 16)).astype(np.float32)
    outs = _spawn(tmp_path, 8, """
        from repro_torch.core import formats as tf
        from repro_torch.core.distributed import distributed_spmm, shard_loops
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(1, 8, device="cpu")
        sh = shard_loops(tf.loops_from_csr(tf.csr_from_dense(inp["a"]), 32,
                                           8), 8, 3)
        b = torch.from_numpy(inp["b"]).requires_grad_()
        dy = torch.from_numpy(inp["dy"])
        y = distributed_spmm(sh, b, mesh, device="cpu")
        (out["db"],) = [g.numpy() for g in torch.autograd.grad(
            (y * dy).sum(), b)]
        st = distributed_spmm(sh, b, mesh, assemble=False, device="cpu")
        o, c = sh.row_offset[rank], sh.row_count[rank]
        loss = (st.to_local()[0, :c] * dy[o:o + c]).sum()
        (out["db_stacked"],) = [g.numpy() for g in torch.autograd.grad(
            loss, b)]
    """, a=a, b=b, dy=dy)
    want = a.T @ dy
    for o in outs:
        for k in ("db", "db_stacked"):
            np.testing.assert_allclose(o[k], want, rtol=1e-4, atol=1e-4)
            assert np.array_equal(o[k], outs[0][k]), k


def test_distributed_spmm_batched_rhs(tmp_path):
    """The batched contract (3, 32, 8) at D = 8, forward and dB, one call
    per part a rank; the stacked layout is (8, 3, rows_pad, N)."""
    rng = np.random.default_rng(0)
    a = _sparse(rng, 100, 32, 0.2)
    b = rng.standard_normal((3, 32, 8)).astype(np.float32)
    dy = rng.standard_normal((3, 100, 8)).astype(np.float32)
    outs = _spawn(tmp_path, 8, """
        from repro_torch.core import formats as tf
        from repro_torch.core.distributed import distributed_spmm, shard_loops
        from repro_torch.kernels import engine
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(1, 8, device="cpu")
        sh = shard_loops(tf.loops_from_csr(tf.csr_from_dense(inp["a"]), 48,
                                           8), 8, g_vpu=3)
        calls = []
        for part in ("csr", "bcsr"):
            fn = engine.get_kernel(part, "spmm", "panels")
            engine.register_kernel(part, "spmm", "panels",
                                   lambda *a, _f=fn, _p=part, **k:
                                   calls.append(_p) or _f(*a, **k))
        b = torch.from_numpy(inp["b"]).requires_grad_()
        y = distributed_spmm(sh, b, mesh, device="cpu")
        out["fwd_calls"] = np.array([calls.count("csr"),
                                     calls.count("bcsr")])
        out["y"] = y.detach().numpy()
        (out["db"],) = [g.numpy() for g in torch.autograd.grad(
            y, b, torch.from_numpy(inp["dy"]))]
        out["calls"] = np.array([calls.count("csr"), calls.count("bcsr")])
        out["st_shape"] = np.array(distributed_spmm(
            sh, b, mesh, assemble=False, device="cpu").shape)
    """, a=a, b=b, dy=dy)
    _, _, rows_pad = _dense_split(a, 48, 8, 3)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["y"], np.einsum("mk,zkn->zmn", a, b),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["db"], np.einsum("mk,zmn->zkn", a, dy),
                                   rtol=1e-4, atol=1e-4)
        assert tuple(o["st_shape"]) == (8, 3, rows_pad, 8)
        # forward: B1 on a CSR-group rank, B2 on a BCSR-group rank, once
        assert tuple(o["fwd_calls"]) == ((1, 0) if r < 3 else (0, 1))
        # backward: at most one call per part of the transposed chunk
        assert 1 <= sum(o["calls"]) - sum(o["fwd_calls"]) <= 2


# The reference's ``compressed_psum`` on ``x`` (D, n) over D forced host
# devices, in a subprocess (the host-device count is fixed when JAX starts):
# device 0's result per precision.
_REFERENCE_PSUM = """
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.dist.compress import compressed_psum
x = np.load(sys.argv[1])
mesh = make_mesh((x.shape[0],), ("d",))
out = {}
for prec in ("int8", "bf16", "none"):
    @partial(shard_map, mesh=mesh, in_specs=P("d"), out_specs=P("d"))
    def f(xs, _p=prec):
        return compressed_psum(xs[0], "d", _p)[None]
    out[prec] = np.asarray(f(jnp.asarray(x)))[0]
np.savez(sys.argv[2], **out)
"""


def test_compressed_psum_against_the_reference(tmp_path):
    """n = 10,000 (not a multiple of D = 4): each precision within the
    reference's bound of the exact sum, every rank's result bit for bit the
    same, and the int8 result within 1 ulp of the reference's on the same
    inputs."""
    d, n = 4, 10_000
    x = np.random.default_rng(3).standard_normal((d, n)).astype(np.float32)
    outs = _spawn(tmp_path / "ranks", d, """
        from repro_torch.dist.compress import compressed_psum
        x = torch.from_numpy(inp["x"][rank])
        for prec in ("int8", "bf16", "none"):
            out[prec] = compressed_psum(x, None, prec).numpy()
    """, x=x)
    np.save(tmp_path / "x.npy", x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={d}",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _REFERENCE_PSUM,
                          str(tmp_path / "x.npy"), str(tmp_path / "ref.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=RANK_LIMIT_S)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = dict(np.load(tmp_path / "ref.npz"))
    want = x.sum(0)
    for prec, bound in [("int8", 2e-2), ("bf16", 1e-2), ("none", 1e-6)]:
        got = outs[0][prec]
        assert got.shape == (n,) and got.dtype == np.float32
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < bound, (prec, err)
        assert all(np.array_equal(o[prec], got) for o in outs), prec
    ulp = np.spacing(np.abs(ref["int8"]).astype(np.float32))
    assert (np.abs(outs[0]["int8"] - ref["int8"]) <= ulp).all()


def test_compressed_psum_byte_gauge(tmp_path):
    """Each call reports its per-rank wire bytes, n + 4n/D, 2n and 4n, and
    the call counter counts calls; a bf16 operand comes back reduced and
    is itself left as it was."""
    d, n = 4, 10_000
    outs = _spawn(tmp_path, d, """
        from repro_torch.dist.compress import compressed_psum
        from repro_torch.obs import Obs, set_active
        obs = Obs(source="test")
        set_active(obs)
        x = torch.ones(%d)
        for prec in ("int8", "bf16", "none", "int8"):
            compressed_psum(x, None, prec)
            out[prec] = np.array(obs.metrics.gauge(
                "dist.collective_bytes", kind="psum", precision=prec).value)
        out["int8_calls"] = np.array(obs.metrics.counter(
            "dist.collective_sites", kind="psum", precision="int8").value)
        xb = torch.ones(%d, dtype=torch.bfloat16)
        yb = compressed_psum(xb, None, "bf16")
        out["bf16_kept"] = np.array(bool((xb == 1).all() and (yb == 4).all()))
    """ % (n, n))
    for o in outs:
        assert float(o["int8"]) == n + 4 * n // d
        assert float(o["bf16"]) == 2 * n and float(o["none"]) == 4 * n
        assert float(o["int8_calls"]) == 2
        assert bool(o["bf16_kept"])      # a bf16 input is not reduced in place


def test_compressed_psum_fault_on_one_rank_degrades_every_rank(tmp_path):
    """An injected ``dist.psum.int8`` fault on rank 0 alone: under the
    default policy every rank raises (rank 0 the fault, its peers that a
    peer failed) and none hangs; opted in, every rank degrades to the fp32
    sum, bit for bit the plain all-reduce's, with one ``dist.fallback``
    count a rank."""
    d, n = 4, 1000
    outs = _spawn(tmp_path, d, """
        from repro_torch.dist.compress import compressed_psum
        from repro_torch.obs import Obs, set_active
        from repro_torch.resilience import fallback, inject
        x = torch.from_numpy(np.random.default_rng(rank)
                             .standard_normal(%d).astype(np.float32))
        plan = "dist.psum.int8:raise:0:0" if rank == 0 else None
        inject.set_plan(inject.FaultPlan.parse(plan) if plan else None)
        try:
            compressed_psum(x, None, "int8")
            out["raised"] = np.array("")
        except Exception as e:
            out["raised"] = np.array(type(e).__name__)
        obs = Obs(source="test")
        set_active(obs)
        fallback.set_policy(fallback.FallbackPolicy())
        out["degraded"] = compressed_psum(x, None, "int8").numpy()
        out["plain"] = compressed_psum(x, None, "none").numpy()
        out["fallbacks"] = np.array(sum(
            inst.value for kind, inst in obs.metrics.instruments()
            if kind == "counter" and inst.name == "dist.fallback"))
        out["reason"] = np.array(obs.metrics.find(
            "counter", "dist.fallback", precision="int8",
            reason="injected" if rank == 0 else "peer").value)
    """ % n)
    assert str(outs[0]["raised"]) == "InjectedFault"
    assert all(str(o["raised"]) == "RuntimeError" for o in outs[1:])
    for o in outs:
        assert np.array_equal(o["degraded"], o["plain"])
        assert np.array_equal(o["degraded"], outs[0]["degraded"])
        assert float(o["fallbacks"]) == 1.0 and float(o["reason"]) == 1.0
