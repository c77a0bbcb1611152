"""Slice parity of the PyTorch port: ``repro_torch.core.loops_spmm`` on the
CPU against the JAX reference's ``loops_spmm(backend="jnp")`` and dense
numpy, the structural step counts, the GCN forward, and the port's guards
(no JAX import, CUDA by default, autograd never cut)."""
import contextlib
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import spmm as rspmm
from repro.core import suite as rsuite
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.kernels import engine
from repro_torch.models import GCN, gcn_params_from_numpy

from test_torch_gpu import adversarial_cases


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def both(csr_dense_or_mid, r_b=None, br=8, g=8, **kw):
    """The same matrix converted by both packages (``r_b=None``: the
    default plan)."""
    if isinstance(csr_dense_or_mid, str):
        cr = rsuite.table2_like(csr_dense_or_mid, scale_rows=256, seed=1)
        cp = tsuite.table2_like(csr_dense_or_mid, scale_rows=256, seed=1)
    else:
        cr = rf.csr_from_dense(csr_dense_or_mid)
        cp = tf.csr_from_dense(csr_dense_or_mid)
    if r_b is None:
        return (rspmm.plan_and_convert(cr, **kw)[0],
                tspmm.plan_and_convert(cp, device="cpu", **kw)[0])
    return (rf.loops_from_csr(cr, r_b, br, panel_g=g, **kw),
            tf.loops_from_csr(cp, r_b, br, panel_g=g, **kw))


def run_both(fr, fp, b, tol, **kw):
    want = np.asarray(rspmm.loops_spmm(fr, jnp.asarray(b), backend="jnp",
                                       **kw))
    for backend in ("cuda", "torch"):
        got = tspmm.loops_spmm(fp, b, device="cpu", backend=backend, **kw)
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(got.double().numpy(),
                                   want.astype(np.float64), rtol=tol,
                                   atol=tol, err_msg=backend)
    return want


@pytest.mark.parametrize("mid", ["m4", "m6", "m8", "m10", "m12", "m13"])
def test_suite_matrices_match_reference_and_dense(mid):
    fr, fp = both(mid, total_workers=4)
    b = np.random.default_rng(2).standard_normal(
        (fr.ncols, 8)).astype(np.float32)
    want = run_both(fr, fp, b, 2e-5)
    dense = rf.csr_to_dense(rsuite.table2_like(mid, scale_rows=256, seed=1))
    np.testing.assert_allclose(want, dense @ b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mid", ["m8", "m14", "m19"])
def test_block_family_nnz_grows_with_the_square_of_the_rows(mid):
    """table2_like's block family holds ~0.2 n^2 nonzeros at n rows
    whatever the Table 2 entry (its block density clamps to 0.25), so the
    published row count does not give the published size; the fig4
    benchmark's published_rows cuts the rows to sqrt(nnz / 0.2)."""
    from repro_torch.benchmarks import fig4_throughput as f4
    for n in (1024, 2048):
        nnz = tsuite.table2_like(mid, scale_rows=n, seed=3).nnz
        assert nnz == pytest.approx(0.2 * n * n, rel=0.1), (n, nnz)
    e = tsuite.TABLE2_STATS[mid]
    rows, cut = f4.published_rows(mid)
    assert rows < e.nrow and cut and str(e.nrow) in cut
    assert 0.2 * rows * rows == pytest.approx(e.nnz, rel=1e-3)
    assert f4.published_rows("m6") == (200_000, None)


@pytest.mark.parametrize("r_frac", [0.0, 0.3, 0.55, 1.0])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_explicit_boundaries(rng, r_frac, g):
    """Pure-CSR, pure-BCSR, hybrid, and a boundary that is no multiple of
    Br (the port's BCSR kernel takes a row offset)."""
    a = ((rng.random((40, 24)) < 0.2)
         * rng.standard_normal((40, 24))).astype(np.float32)
    r_b = int(r_frac * 40)
    if r_frac != 0.55:
        r_b = r_b // 8 * 8
    fp = tf.loops_from_csr(tf.csr_from_dense(a), r_b, 8, panel_g=g)
    b = rng.standard_normal((24, 16)).astype(np.float32)
    for backend in ("cuda", "torch"):
        got = tspmm.loops_spmm(fp, b, device="cpu", backend=backend)
        np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    if r_b % 8 == 0:
        fr = rf.loops_from_csr(rf.csr_from_dense(a), r_b, 8, panel_g=g)
        run_both(fr, fp, b, 1e-5)


@pytest.mark.parametrize("batch", [(3,), (2, 3), (1,), (11,)])
def test_batched_matches_reference(rng, batch):
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    fr, fp = both(a, r_b=8, g=3)
    b = rng.standard_normal(batch + (a.shape[1], 40)).astype(np.float32)
    want = run_both(fr, fp, b, 1e-5)
    np.testing.assert_allclose(want, a @ b, rtol=1e-4, atol=1e-4)


def test_non_contiguous_operand(rng):
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    fp = tf.loops_from_csr(tf.csr_from_dense(a), 8, 8, panel_g=3)
    bt = torch.from_numpy(rng.standard_normal((24, a.shape[1])).astype(
        np.float32)).T
    assert not bt.is_contiguous()
    got = tspmm.loops_spmm(fp, bt, device="cpu")
    np.testing.assert_allclose(got.numpy(), a @ bt.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fp64_matches_reference_under_x64(rng):
    with x64():
        a = ((rng.random((37, 29)) < 0.3) * rng.standard_normal((37, 29)))
        fr, fp = both(a, r_b=16, g=4)
        b = rng.standard_normal((2, 29, 33))
        want = run_both(fr, fp, b, 1e-12)
        assert want.dtype == np.float64
        np.testing.assert_allclose(want, a @ b, rtol=1e-12, atol=1e-12)


def test_half_precision_accumulates_in_fp32(rng):
    a = ((rng.random((33, 20)) < 0.3)
         * rng.standard_normal((33, 20))).astype(np.float16)
    fr, fp = both(a)               # default plan: Br = 16
    assert fp.bcsr_part.br == 16
    b = rng.standard_normal((20, 24)).astype(np.float16)
    want = run_both(fr, fp, b, 1e-3)
    assert want.dtype == np.float32
    got = tspmm.loops_spmm(fp, b, device="cpu", out_dtype=torch.float16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3,
                               atol=2e-3)


def test_empty_matrix_and_empty_batch(rng):
    fr, fp = both(np.zeros((7, 5), np.float32), r_b=0)
    assert fp.nnz == 0
    out = tspmm.loops_spmm(fp, rng.standard_normal((5, 8)).astype(
        np.float32), device="cpu")
    assert out.shape == (7, 8) and not out.any()
    a = adversarial_cases(rng)["indivisible"].astype(np.float32)
    fr, fp = both(a, r_b=4)
    for shape in ((0, 9, 6), (2, 0, 9, 6)):
        b = np.zeros(shape, np.float32)
        want = rspmm.loops_spmm(fr, jnp.asarray(b), backend="jnp")
        for backend in ("cuda", "torch"):
            got = tspmm.loops_spmm(fp, b, device="cpu", backend=backend)
            assert got.shape == tuple(want.shape) == shape[:-2] + (11, 6)


def test_shape_and_dtype_errors(rng):
    a = adversarial_cases(rng)["indivisible"].astype(np.float32)
    fr, fp = both(a, r_b=4)
    with pytest.raises(ValueError, match="rank"):
        rspmm.loops_spmm(fr, jnp.zeros(9), backend="jnp")
    with pytest.raises(ValueError, match="rank"):
        tspmm.loops_spmm(fp, np.zeros(9, np.float32), device="cpu")
    with pytest.raises(ValueError, match="K=8"):
        tspmm.loops_spmm(fp, np.zeros((8, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="value dtype"):
        tspmm.loops_spmm(fp, np.zeros((9, 3), np.float64), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        tspmm.loops_spmm(fp, torch.zeros((9, 3), device="meta"),
                         device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tspmm.loops_spmm(fp, np.zeros((9, 3), np.float32), device="xpu")
    # meta is a device of its own now (shapes only, through the kernels'
    # operators): the product's shape and dtype, no values
    out = tspmm.loops_spmm(fp, np.zeros((9, 3), np.float32), device="meta")
    assert out.device.type == "meta" and tuple(out.shape) == (11, 3)
    assert out.dtype == torch.float32


def test_autograd_raises_instead_of_cutting_the_graph(rng):
    """The graph is not cut: ``b.grad`` is the dense ``Aᵀ·dY`` (the name
    is kept from when the port refused to differentiate)."""
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    for r_b in (0, 16, a.shape[0]):
        fp = tf.loops_from_csr(tf.csr_from_dense(a), r_b, 8, panel_g=3)
        b = torch.tensor(rng.standard_normal((a.shape[1], 5)).astype(
            np.float32), requires_grad=True)
        dy = rng.standard_normal((a.shape[0], 5)).astype(np.float32)
        y = tspmm.loops_spmm(fp, b, device="cpu")
        assert y.requires_grad
        y.backward(torch.from_numpy(dy))
        np.testing.assert_allclose(b.grad.numpy(), a.T @ dy, rtol=1e-5,
                                   atol=1e-5)
        with torch.no_grad():
            assert not tspmm.loops_spmm(fp, b, device="cpu").requires_grad


@pytest.mark.parametrize("mid", ["m6", "m10", "m13"])
def test_grid_steps_match_reference(mid):
    for g, m, depth in ((1, 1, 1), (8, 1, 1), (4, 2, 2), (8, 2, 1)):
        fr, fp = both(mid, panel_g=g, macro_m=m, pipeline_depth=depth)
        for n in (8, 40, 600, 1024):
            assert (tspmm.loops_grid_steps(fp, n)
                    == rspmm.loops_grid_steps(fr, n))
            assert (tspmm.loops_grid_steps(fp, n, bn=8)
                    == rspmm.loops_grid_steps(fr, n, bn=8))
        for batch in (0, 1, 3, 8, 11, 12, (2, 3)):
            assert (tspmm.loops_batched_grid_steps(fp, batch, 40)
                    == rspmm.loops_batched_grid_steps(fr, batch, 40))


def test_tracer_records_reference_fields(rng):
    """The structural dispatch notes of one fused call agree with the
    reference's (backend names aside)."""
    class Rec:
        def __init__(self):
            self.notes = []

        def on_dispatch(self, **f):
            self.notes.append({k: v for k, v in f.items()
                               if k != "backend"})

    from repro.kernels import engine as rengine
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    fr, fp = both(a, r_b=16, g=3)
    b = rng.standard_normal((3, a.shape[1], 40)).astype(np.float32)
    rr, tr = Rec(), Rec()
    prev = rengine.set_tracer(rr)
    try:
        rspmm.loops_spmm(fr, jnp.asarray(b), backend="interpret")
    finally:
        rengine.set_tracer(prev)
    prev = engine.set_tracer(tr)
    try:
        tspmm.loops_spmm(fp, b, device="cpu")
    finally:
        engine.set_tracer(prev)
    assert tr.notes == rr.notes and len(tr.notes) == 2


def _gcn_reference(adj_r, x, params):
    def agg(h):
        return rspmm.loops_spmm(adj_r, h, backend="jnp")
    h = jax.nn.relu(agg(jnp.asarray(x) @ jnp.asarray(params["w0"])))
    return np.asarray(agg(h @ jnp.asarray(params["w1"])))


def test_gcn_logits_match_reference():
    rng = np.random.default_rng(0)
    nodes, f_in, f_hid, f_out = 300, 16, 24, 5
    adj_r = rsuite.gcn_graph(nodes, 5, seed=0)
    adj_p = tsuite.gcn_graph(nodes, 5, seed=0)
    fr, _ = rspmm.plan_and_convert(adj_r)
    fp, _ = tspmm.plan_and_convert(adj_p, device="cpu")
    params = {"w0": (rng.standard_normal((f_in, f_hid)) * 0.1).astype(
                  np.float32),
              "w1": (rng.standard_normal((f_hid, f_out)) * 0.1).astype(
                  np.float32)}
    model = GCN(fp, **gcn_params_from_numpy(params, device="cpu"))
    for _ in range(2):
        x = rng.standard_normal((nodes, f_in)).astype(np.float32)
        got = model(torch.from_numpy(x))
        assert got.shape == (nodes, f_out)
        np.testing.assert_allclose(got.detach().numpy(),
                                   _gcn_reference(fr, x, params),
                                   rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert all(p.grad is not None and bool(p.grad.any())
               for p in model.parameters())


def test_baselines_match_reference(rng):
    csr_r = rsuite.table2_like("m13", scale_rows=128, seed=0)
    csr_p = tsuite.table2_like("m13", scale_rows=128, seed=0)
    b = rng.standard_normal((128, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tspmm.spmm_csr_baseline(csr_p, torch.from_numpy(b)).numpy(),
        np.asarray(rspmm.spmm_csr_baseline(csr_r, jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    dense = rf.csr_to_dense(csr_r)
    np.testing.assert_allclose(
        tspmm.spmm_dense_baseline(dense, torch.from_numpy(b)).numpy(),
        np.asarray(rspmm.spmm_dense_baseline(dense, jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    assert tspmm.default_br(np.float16) == rspmm.default_br(jnp.float16)
    assert tspmm.default_br(torch.bfloat16) == rspmm.default_br(jnp.bfloat16)
    assert tspmm.default_br(np.float64) == rspmm.default_br(jnp.float32)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_import_pulls_in_neither_jax_nor_the_reference():
    example = (pathlib.Path(__file__).resolve().parents[1] / "examples"
               / "gcn_train_torch.py")
    code = ("import sys, importlib.util, repro_torch, repro_torch.core, "
            "repro_torch.kernels, repro_torch.models, "
            "repro_torch.resilience, repro_torch.perf.schema\n"
            "from repro_torch.kernels import _build\n"
            "from repro_torch.resilience import fallback, validate\n"
            "from repro_torch.core import distributed\n"
            "from repro_torch.dist import compress, sharding, step\n"
            "from repro_torch.launch import mesh, train\n"
            "sharding.param_specs, sharding.cache_specs, "
            "sharding.model_layout\n"
            "from repro_torch.benchmarks import (run, perf_gate, "
            "fig4_throughput, fig5_halfprec, sec43_scheduling, "
            "batched_spmm, autotune_suite, table3_energy, table4_gnn, "
            "serve_traffic)\n"
            "run._suite_registry()\n"
            f"spec = importlib.util.spec_from_file_location('ex', "
            f"{str(example)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_is_cuda_and_raises_without_a_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    csr = tf.csr_from_dense(np.eye(8, dtype=np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmm.plan_and_convert(csr)
    fmt = tf.loops_from_csr(csr, 0, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmm.loops_spmm(fmt, torch.eye(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn_params_from_numpy({"w0": np.eye(2), "w1": np.eye(2)})
