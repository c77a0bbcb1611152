"""The port's step analyser (``repro_torch.perf.hlo_analysis``) against the
reference's HLO analyser, and B1-B5 as ``torch.ops.repro_torch``
operators on fake tensors.

The analyser counts one rank's traced operators (``StepTrace`` over fake
tensors) where the reference parses a compiled step's HLO; on the
reference test's computations (``tests/test_hlo_analysis.py``: 11 chained
64 x 64 matmuls with tanh, a nested loop, a batched einsum) both give the
same flops, exactly, and one block's all-reduce, all-gather and
reduce-scatter on a group of 4 the same collective bytes by kind (the
reference on a 4-device ``shard_map`` in a subprocess).  The operators'
shape functions give their plain versions' shapes, dtypes and strides, and
their flop formulas the closed forms of PERF.md §3.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.utils.flop_counter import FlopCounterMode

from repro.perf.hlo_analysis import analyze_hlo
from repro_torch.core import formats as tf
from repro_torch.kernels import bcsr_spmm, csr_spmm, spmm_sdd
from repro_torch.kernels import flash_attention as b5
from repro_torch.launch.dryrun import fake_world
from repro_torch.perf import hlo_analysis as ha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace(fn, *shapes):
    """Stats of ``fn`` over fake fp32 tensors of ``shapes``."""
    with FakeTensorMode():
        args = [torch.empty(s) for s in shapes]
        with ha.StepTrace(arguments=args) as tr:
            out = fn(*args)
        return tr, tr.memory(out)


def _ref(f, *shapes):
    avals = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(f).lower(*avals).compile().as_text())


def test_chained_matmuls_flops_equal_reference():
    def ref(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=11)[0]

    def port(x, w):
        for _ in range(11):
            x = torch.tanh(x @ w)
        return x
    tr, _ = _trace(port, (64, 64), (64, 64))
    assert tr.stats.flops == _ref(ref, (64, 64), (64, 64)).flops \
        == 11 * 2 * 64 ** 3
    assert tr.stats.unknown_trip_loops == 0


def test_nested_loops_flops_equal_reference():
    def ref(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def port(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    tr, _ = _trace(port, (16, 16), (16, 16))
    assert tr.stats.flops == _ref(ref, (16, 16), (16, 16)).flops \
        == 15 * 2 * 16 ** 3


def test_batched_einsum_flops_equal_reference():
    tr, _ = _trace(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                   (4, 8, 16), (4, 16, 8))
    want = _ref(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                (4, 8, 16), (4, 16, 8)).flops
    assert tr.stats.flops == want == 2 * 4 * 8 * 8 * 16


def test_elementwise_bytes_read_inputs_write_output():
    """a + b reads 2 x 4096 bytes and writes 4096 (the reference's bound:
    between 2 and 4 x 4096); views are free; ``copy_`` reads its source and
    writes its target; a fill writes only."""
    tr, _ = _trace(lambda a, b: a + b, (1024,), (1024,))
    ref = _ref(lambda a, b: a + b, (1024,), (1024,)).hbm_bytes
    assert tr.stats.hbm_bytes == 3 * 4096
    assert 2 * 4096 <= ref <= 4 * 4096
    tr, _ = _trace(lambda a: a.view(32, 32).t().unsqueeze(0)[:, :8],
                   (1024,))
    assert tr.stats.hbm_bytes == 0
    # a reshape that cannot be a view copies: read once, written once
    tr, _ = _trace(lambda a: a.view(32, 32).t().reshape(-1), (1024,))
    assert tr.stats.hbm_bytes == 2 * 4096
    tr, _ = _trace(lambda a, b: a.copy_(b), (1024,), (1024,))
    assert tr.stats.hbm_bytes == 2 * 4096
    tr, _ = _trace(lambda a: a.fill_(1.0), (1024,))
    assert tr.stats.hbm_bytes == 4096


def test_memory_record_keys_and_peak():
    """The reference's memory keys: arguments, outputs (and those aliasing
    an argument) and the peak of the storage the traced calls allocated,
    freed storage leaving the live count."""
    def fn(a, b):
        h = a @ b            # 4 KB, freed after the next line
        y = torch.tanh(h)    # 4 KB: peak 8 KB while both live
        del h
        return y, a
    tr, mem = _trace(fn, (32, 32), (32, 32))
    assert mem == {"argument_size_in_bytes": 2 * 4096,
                   "output_size_in_bytes": 2 * 4096,
                   "alias_size_in_bytes": 4096,
                   "temp_size_in_bytes": 2 * 4096}


def test_saved_ops_recount_to_the_trace(tmp_path):
    """A kept trace (JSON lines with shapes) recounts to the live counts,
    collectives included, without tracing again."""
    with fake_world(4, 0), FakeTensorMode():
        x, w = torch.empty(64, 32), torch.empty(32, 32)
        with ha.StepTrace() as tr:
            y = torch.relu(x @ w)
            dist.all_reduce(y)
            out = torch.empty(256, 32)
            dist.all_gather_into_tensor(out, y)
    path = tmp_path / "ops.jsonl"
    ha.save_ops(tr.records, path)
    again = ha.analyze_ops(ha.load_ops(path))
    assert again == tr.stats
    lines = ha.load_ops(path)
    assert {"flops", "bytes", "collective_bytes", "group"} <= set(lines[0])
    assert max(r["group"] for r in lines) == 4


_REF_COLLECTIVES = textwrap.dedent("""
    import json, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.perf.hlo_analysis import analyze_hlo
    mesh = make_mesh((4,), ("d",))
    x = jax.ShapeDtypeStruct((4 * 8, 256), jnp.float32)
    def by_kind(fn):
        f = shard_map(fn, mesh=mesh, in_specs=P("d"), out_specs=P("d"))
        return analyze_hlo(jax.jit(f).lower(x).compile().as_text()
                           ).collective_by_kind
    print(json.dumps({
        "all-reduce": by_kind(lambda b: jax.lax.psum(b, "d")),
        "all-gather": by_kind(lambda b: jax.lax.all_gather(
            b, "d", tiled=True)[:8]),
        "reduce-scatter": by_kind(lambda b: jnp.tile(jax.lax.psum_scatter(
            b, "d", tiled=True), (4, 1)))}))
""")


def test_collectives_bytes_by_kind_equal_reference():
    """One (8, 256) fp32 block a rank on a group of 4: all-reduce,
    all-gather and reduce-scatter count the reference's operand bytes
    (its 4-device ``shard_map``), kind by kind."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_COLLECTIVES], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    got = {}
    with fake_world(4, 0), FakeTensorMode():
        blk = torch.empty(8, 256)
        for kind, fn in (
                ("all-reduce", lambda: dist.all_reduce(blk.clone())),
                ("all-gather", lambda: dist.all_gather_into_tensor(
                    torch.empty(32, 256), blk)),
                ("reduce-scatter", lambda: dist.reduce_scatter_tensor(
                    torch.empty(2, 256), blk))):
            with ha.StepTrace() as tr:
                fn()
            got[kind] = tr.stats.collective_by_kind
    for kind in ("all-reduce", "all-gather"):
        assert got[kind] == {kind: ref[kind][kind]} == {kind: 8 * 256 * 4}
    # the reference's reduce-scatter operand is its (8, 256) block too
    assert got["reduce-scatter"] == {"reduce-scatter": 8 * 256 * 4}
    assert ref["reduce-scatter"]["reduce-scatter"] == 8 * 256 * 4


# -- B1-B5 as operators ------------------------------------------------------

def _kernel_case():
    """Real CPU inputs of each wrapper, with the closed-form flops of its
    operator."""
    rng = np.random.default_rng(3)
    a = (rng.random((60, 50)) < 0.2) * rng.standard_normal((60, 50))
    fmt = tf.loops_from_csr(tf.csr_from_dense(a.astype(np.float32)), 20, 8,
                            panel_g=4)
    dev = fmt.on("cpu")
    cp, bp = dev.csr, dev.bcsr
    b = torch.as_tensor(rng.standard_normal((50, 16)).astype(np.float32))
    dy = torch.as_tensor(rng.standard_normal((60, 16)).astype(np.float32))
    q = torch.randn(2, 64, 4, 16)
    k = torch.randn(2, 64, 2, 16)
    v = torch.randn(2, 64, 2, 16)
    nb = fmt.bcsr_part.nblocks
    blocks = spmm_sdd.sdd_block_table(cp.rows, cp.cols, cp.mask)
    return {
        "csr_panels_spmm": (
            lambda t: csr_spmm.csr_panels_spmm(
                t(cp.rows), t(cp.cols), t(cp.vals), t(cp.mask), t(b),
                nrows=20, units=_units(cp.units, t), live=cp.live),
            2 * cp.live * 16),
        "bcsr_panels_spmm": (
            lambda t: bcsr_spmm.bcsr_panels_spmm(
                t(bp.rows), t(bp.cols), t(bp.vals), t(bp.mask), t(b),
                nblocks=nb, units=_units(bp.units, t), live=bp.live),
            2 * bp.live * 8 * 16),
        "csr_sdd_panels": (
            lambda t: spmm_sdd.csr_sdd_panels(
                t(cp.rows), t(cp.cols), t(cp.mask), t(dy), t(b),
                blocks=_blocks(blocks, t), live=cp.live),
            2 * cp.live * 16),
        "bcsr_sdd_panels": (
            lambda t: spmm_sdd.bcsr_sdd_panels(
                t(bp.rows), t(bp.cols), t(bp.mask), t(dy), t(b), br=8,
                row_offset=20, nrows=40, units=_units(bp.units, t),
                live=bp.live),
            2 * bp.live * 8 * 16),
        "flash_attention": (
            lambda t: b5.flash_attention(t(q), t(k), t(v), causal=True,
                                         return_lse=True),
            4 * 2 * 4 * 16 * (64 * 65 // 2)),
    }


def _units(units, t):
    import dataclasses
    return dataclasses.replace(units, units=t(units.units),
                               splits=t(units.splits))


def _blocks(blocks, t):
    import dataclasses
    return dataclasses.replace(blocks, blocks=t(blocks.blocks),
                               outs=t(blocks.outs), info=t(blocks.info),
                               cols=t(blocks.cols))


NAMES = ["csr_panels_spmm", "bcsr_panels_spmm", "csr_sdd_panels",
         "bcsr_sdd_panels", "flash_attention"]


def _layout(x):
    xs = x if isinstance(x, tuple) else (x,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in xs]


@pytest.mark.parametrize("name", NAMES)
def test_operator_fake_shapes_equal_plain_version(name):
    """Under ``FakeTensorMode``, on fake CUDA tensors made from the same
    real inputs, each wrapper goes through its operator's shape function
    (no launch) and returns the shapes, dtypes and strides that its plain
    version returns on the real inputs; its flops are the closed form."""
    call, flops = _kernel_case()[name]
    want = call(lambda x: x)              # CPU tensors: the plain version
    mode = FakeTensorMode()

    def to_cuda(x):     # a fake CUDA twin of a real CPU tensor
        with unset_fake_temporarily():
            meta = x.to("meta")
        return mode.fake_tensor_converter.from_meta_and_device(
            mode, meta, torch.device("cuda", 0))
    fn = {"csr_panels_spmm": csr_spmm.csr_panels_spmm,
          "bcsr_panels_spmm": bcsr_spmm.bcsr_panels_spmm,
          "csr_sdd_panels": spmm_sdd.csr_sdd_panels,
          "bcsr_sdd_panels": spmm_sdd.bcsr_sdd_panels,
          "flash_attention": b5.flash_attention}[name]
    before = fn.launches
    with mode, FlopCounterMode(display=False) as counter:
        got = call(to_cuda)
    assert _layout(got) == _layout(want)
    assert all(t.device.type == "cuda" for t in (
        got if isinstance(got, tuple) else (got,)))
    assert fn.launches == before
    packet = getattr(torch.ops.repro_torch, name)
    assert counter.get_flop_counts()["Global"] == {packet: flops}


@pytest.mark.parametrize("name", NAMES)
def test_operator_counts_in_a_step_trace(name):
    """In a ``StepTrace`` on ``meta`` each wrapper is one operator record
    whose flops are the closed form and whose bytes are its byte formula:
    every input once and the outputs once."""
    call, flops = _kernel_case()[name]
    with FakeTensorMode(allow_non_fake_inputs=True):
        with ha.StepTrace() as tr:
            out = call(lambda x: x.to("meta"))
    recs = [r for r in tr.records if r["op"].startswith("repro_torch::")]
    assert [r["op"] for r in recs] == [f"repro_torch::{name}.default"]
    st = ha.op_stats(recs[0])
    assert st.flops == flops
    ins = ha._bytes(ha._tensors(recs[0]["args"]))
    if name.endswith("panels_spmm"):
        # a fresh output: the rows written are the whole buffer, an input
        assert st.hbm_bytes == ins
    else:
        outs = out if isinstance(out, tuple) else (out,)
        assert st.hbm_bytes == ins + sum(t.numel() * t.itemsize
                                         for t in outs)


def test_port_imports_no_jax_and_no_reference():
    """Every module of ``repro_torch`` and ``chip_smoke.py`` import with
    ``jax`` and ``repro`` made unimportable, and none of them loads either."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"{name} imported")
        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        sys.path.insert(0, sys.argv[1])
        importlib.import_module("chip_smoke")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) > 80
