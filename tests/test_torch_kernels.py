"""Kernel-level parity of the PyTorch port with the JAX reference.

The plain PyTorch versions of B1 (``csr_panels_spmm_plain``) and B2
(``bcsr_panels_spmm_plain``) run on the reference format's own panel
arrays and are held against the Pallas kernels in interpret mode, the way
the reference's own tests run them on the CPU.  Tolerances: fp32 1e-5,
bf16 3e-2, fp64 1e-12 under x64 (the sums run in another order).  The
CUDA kernels themselves are compared with these plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.kernels import engine as rengine
from repro.kernels import ref as rref
from repro.kernels.bcsr_spmm import bcsr_panels_spmm_pallas
from repro.kernels.csr_spmm import csr_panels_spmm_pallas
from repro.kernels.panel_common import default_bn as r_default_bn
from repro_torch.core import formats as tf
from repro_torch.kernels import bcsr_spmm, csr_spmm, engine, spmm_sdd
from repro_torch.kernels import ref as tref
from repro_torch.kernels.panel_common import default_bn

from test_torch_gpu import adversarial_cases

DTYPES = [("float32", 1e-5), ("bfloat16", 3e-2), ("float64", 1e-12)]
GS = [1, 3, 8]


@contextlib.contextmanager
def x64_if(dname):
    if dname == "float64":
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", False)
    else:
        yield


def to_torch(arr, dname=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(arr.copy())   # a writable copy of a jax buffer
    return t.to(getattr(torch, dname)) if dname else t


def ref_format(a, dname, r_b, br, g):
    """The reference's LOOPS format of dense ``a`` in dtype ``dname``."""
    dense = np.asarray(jnp.asarray(a, getattr(jnp, dname)))
    return rf.loops_from_csr(rf.csr_from_dense(dense), r_b, br, panel_g=g)


def torch_panels(p):
    return (to_torch(p.panel_rows), to_torch(p.panel_cols),
            to_torch(p.panel_vals), to_torch(p.panel_mask))


def assert_close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("dname,tol", DTYPES)
def test_csr_plain_matches_pallas(rng, dname, tol, g):
    with x64_if(dname):
        for name, a in adversarial_cases(rng).items():
            m, k = a.shape
            fmt = ref_format(a, dname, m, 8, g)
            p = fmt.csr_panels
            b = jnp.asarray(rng.standard_normal((k, 8)), getattr(jnp, dname))
            want = csr_panels_spmm_pallas(
                jnp.asarray(p.panel_rows), jnp.asarray(p.panel_cols),
                jnp.asarray(p.panel_vals), jnp.asarray(p.panel_mask), b,
                nrows=m, interpret=True)
            got = csr_spmm.csr_panels_spmm_plain(
                *torch_panels(p), to_torch(np.asarray(b)), nrows=m)
            assert got.dtype == getattr(torch, str(want.dtype))
            assert_close(got, want, tol, name)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("dname,tol", DTYPES)
def test_bcsr_plain_matches_pallas(rng, dname, tol, g):
    with x64_if(dname):
        for name, a in adversarial_cases(rng).items():
            m, k = a.shape
            fmt = ref_format(a, dname, 0, 4, g)
            p = fmt.bcsr_panels
            b = jnp.asarray(rng.standard_normal((k, 8)), getattr(jnp, dname))
            want = bcsr_panels_spmm_pallas(
                jnp.asarray(p.panel_rows), jnp.asarray(p.panel_cols),
                jnp.asarray(p.panel_vals), jnp.asarray(p.panel_mask), b,
                nblocks=p.nblocks, interpret=True)
            got = bcsr_spmm.bcsr_panels_spmm_plain(
                *torch_panels(p), to_torch(np.asarray(b)), nblocks=p.nblocks)
            assert got.shape == tuple(want.shape)
            assert_close(got, want, tol, name)


@pytest.mark.parametrize("dname,tol", DTYPES[:2])
def test_plain_batched_matches_pallas(rng, dname, tol):
    """A (3, K, 40) operand: one call serves every slice, per kernel."""
    a = adversarial_cases(rng)["empty_rows"]
    m, k = a.shape
    fmt = ref_format(a, dname, 16, 8, 3)
    b = jnp.asarray(rng.standard_normal((3, k, 40)), getattr(jnp, dname))
    bt = to_torch(np.asarray(b))
    cp, bp = fmt.csr_panels, fmt.bcsr_panels
    want = csr_panels_spmm_pallas(
        jnp.asarray(cp.panel_rows), jnp.asarray(cp.panel_cols),
        jnp.asarray(cp.panel_vals), jnp.asarray(cp.panel_mask), b,
        nrows=16, interpret=True)
    assert_close(csr_spmm.csr_panels_spmm_plain(*torch_panels(cp), bt,
                                                nrows=16), want, tol)
    want = bcsr_panels_spmm_pallas(
        jnp.asarray(bp.panel_rows), jnp.asarray(bp.panel_cols),
        jnp.asarray(bp.panel_vals), jnp.asarray(bp.panel_mask), b,
        nblocks=bp.nblocks, interpret=True)
    assert_close(bcsr_spmm.bcsr_panels_spmm_plain(
        *torch_panels(bp), bt, nblocks=bp.nblocks), want, tol)


@pytest.mark.parametrize("dname,tol", DTYPES)
def test_plain_fused_buffer_matches_pallas_carry(rng, dname, tol):
    """B1 fills rows [0, r_b) and B2 the rows from r_b on of ONE buffer:
    the reference's carry + row_block_offset, here ``out`` + row_offset."""
    a = adversarial_cases(rng)["empty_rows"]
    m, k = a.shape
    r_b, br = 8, 8
    with x64_if(dname):
        fmt = ref_format(a, dname, r_b, br, 4)
        cp, bp = fmt.csr_panels, fmt.bcsr_panels
        r_pad = r_b + bp.nblocks * br
        for shape in ((k, 16), (2, k, 16)):
            b = jnp.asarray(rng.standard_normal(shape), getattr(jnp, dname))
            want = csr_panels_spmm_pallas(
                jnp.asarray(cp.panel_rows), jnp.asarray(cp.panel_cols),
                jnp.asarray(cp.panel_vals), jnp.asarray(cp.panel_mask), b,
                nrows=r_b, out_rows=r_pad, interpret=True)
            want = bcsr_panels_spmm_pallas(
                jnp.asarray(bp.panel_rows), jnp.asarray(bp.panel_cols),
                jnp.asarray(bp.panel_vals), jnp.asarray(bp.panel_mask), b,
                nblocks=bp.nblocks, row_block_offset=r_b // br,
                out_rows=r_pad, carry=want, interpret=True)
            bt = to_torch(np.asarray(b))
            acc = engine.acc_dtype_for(bt.dtype)
            y = torch.full(tuple(want.shape), float("nan"), dtype=acc)
            csr_spmm.csr_panels_spmm_plain(*torch_panels(cp), bt, nrows=r_b,
                                           out=y)
            bcsr_spmm.bcsr_panels_spmm_plain(*torch_panels(bp), bt,
                                             nblocks=bp.nblocks,
                                             row_offset=r_b, out=y)
            assert not y.isnan().any()
            assert_close(y, want, tol)


def test_wrappers_on_cpu_run_the_plain_version(rng):
    a = adversarial_cases(rng)["indivisible"].astype(np.float32)
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), 4, 4, panel_g=3)
    dev = fmt.on("cpu")
    b = torch.from_numpy(rng.standard_normal((9, 40)).astype(np.float32))
    before = (csr_spmm.csr_panels_spmm.launches,
              bcsr_spmm.bcsr_panels_spmm.launches)
    c, p = dev.csr, dev.bcsr
    for fn, plain, kw, pan in (
            (csr_spmm.csr_panels_spmm, csr_spmm.csr_panels_spmm_plain,
             {"nrows": 4}, c),
            (bcsr_spmm.bcsr_panels_spmm, bcsr_spmm.bcsr_panels_spmm_plain,
             {"nblocks": fmt.bcsr_part.nblocks}, p)):
        got = fn(pan.rows, pan.cols, pan.vals, pan.mask, b, **kw)
        want = plain(pan.rows, pan.cols, pan.vals, pan.mask, b, **kw)
        assert torch.equal(got, want)
        half = fn(pan.rows, pan.cols, pan.vals, pan.mask, b,
                  out_dtype=torch.bfloat16, **kw)
        assert half.dtype == torch.bfloat16
        meta = b.to("meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(pan.rows, pan.cols, pan.vals, pan.mask, meta, **kw)
    # The plain version is not a kernel launch.
    assert (csr_spmm.csr_panels_spmm.launches,
            bcsr_spmm.bcsr_panels_spmm.launches) == before
    np.testing.assert_allclose(
        csr_spmm.csr_panels_spmm(c.rows, c.cols, c.vals, c.mask, b,
                                 nrows=4).numpy(), a[:4] @ b.numpy(),
        rtol=1e-5, atol=1e-5)


def test_panel_ptr_of_matches_format(rng):
    csr = tf.csr_from_dense(adversarial_cases(rng)["empty_rows"])
    fmt = tf.loops_from_csr(csr, 16, 4, panel_g=2)
    for p, n in ((fmt.csr_panels, 16), (fmt.bcsr_panels,
                                        fmt.bcsr_part.nblocks)):
        got = csr_spmm.panel_ptr_of(torch.from_numpy(p.panel_rows), n)
        np.testing.assert_array_equal(got.numpy(), p.panel_ptr)
        assert got.dtype == torch.int64


@pytest.mark.parametrize("dname,tol", DTYPES)
def test_flat_references_match(rng, dname, tol):
    with x64_if(dname):
        a = ((rng.random((21, 17)) < 0.3)
             * rng.standard_normal((21, 17)))
        fmt = ref_format(a, dname, 8, 4, 1)
        b = jnp.asarray(rng.standard_normal((2, 17, 12)),
                        getattr(jnp, dname))
        bt = to_torch(np.asarray(b))
        c, t = fmt.csr_part, fmt.bcsr_part
        want = rref.csr_spmm_ref(jnp.asarray(c.row_ids),
                                 jnp.asarray(c.col_idx), jnp.asarray(c.vals),
                                 b, c.nrows)
        got = tref.csr_spmm_ref(to_torch(c.row_ids), to_torch(c.col_idx),
                                to_torch(c.vals), bt, c.nrows)
        assert_close(got, want, tol)
        want = rref.bcsr_spmm_ref(jnp.asarray(t.tile_rows),
                                  jnp.asarray(t.tile_cols),
                                  jnp.asarray(t.tile_vals), b, t.nblocks)
        got = tref.bcsr_spmm_ref(to_torch(t.tile_rows), to_torch(t.tile_cols),
                                 to_torch(t.tile_vals), bt, t.nblocks)
        assert_close(got, want, tol)
        dense = jnp.asarray(a, getattr(jnp, dname))
        want = rref.dense_spmm(dense, b[0])
        got = tref.dense_spmm(to_torch(np.asarray(dense)), bt[0])
        assert got.dtype == getattr(torch, str(want.dtype))
        assert_close(got, want, max(tol, 1e-6))


def test_engine_helpers_match_reference():
    for n in range(0, 41):
        assert engine.batch_block(n) == rengine.batch_block(n)
        assert engine.padded_batch(n) == rengine.padded_batch(n)
    for n in (1, 8, 40, 200, 512, 600, 1000, 1024, 4096, 4099):
        assert default_bn(n) == r_default_bn(n)
    assert engine.acc_dtype_for(torch.bfloat16) == torch.float32
    assert engine.acc_dtype_for(np.float16) == torch.float32
    assert engine.acc_dtype_for(torch.float64) == torch.float64
    assert engine.resolve_dtypes(np.float32, torch.bfloat16) == (
        torch.float32, torch.bfloat16)
    assert engine.resolve_backend(None) == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        engine.resolve_backend("pallas")
    b = torch.zeros((2, 3, 5, 4))
    flat, batch = engine.flatten_batch(b)
    assert flat.shape == (6, 5, 4) and batch == (2, 3)
    assert engine.unflatten_batch(flat, batch).shape == b.shape
    with pytest.raises(ValueError, match="rank"):
        engine.check_rhs(5, torch.zeros(5))
    with pytest.raises(ValueError, match="K=5"):
        engine.check_rhs(4, torch.zeros((5, 3)))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_part_entry_points_match_reference(rng, backend):
    """``engine.csr_spmm``/``bcsr_spmm`` per part, against the reference
    engine's ``jnp`` backend, batched and trimmed to the part's rows."""
    from repro.kernels import engine as rengine
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    fr = rf.loops_from_csr(rf.csr_from_dense(a), 12, 8, panel_g=3)
    fp = tf.loops_from_csr(tf.csr_from_dense(a), 12, 8, panel_g=3)
    b = rng.standard_normal((2, a.shape[1], 24)).astype(np.float32)
    dev = fp.on("cpu")
    for part, ep, er, pan in (("csr_part", engine.csr_spmm,
                               rengine.csr_spmm, dev.csr),
                              ("bcsr_part", engine.bcsr_spmm,
                               rengine.bcsr_spmm, dev.bcsr)):
        want = er(getattr(fr, part), jnp.asarray(b), backend="jnp")
        got = ep(getattr(fp, part), torch.from_numpy(b), backend=backend,
                 panels=pan)
        assert got.shape == tuple(want.shape)
        assert_close(got, want, 1e-5, part)
    with pytest.raises(ValueError, match="device panels"):
        engine.csr_spmm(fp.csr_part, torch.from_numpy(b), backend="cuda")


def test_registry_resolves_both_flavours():
    assert engine.get_kernel("csr", "spmm") is csr_spmm.csr_panels_spmm
    assert engine.get_kernel("bcsr", "spmm") is bcsr_spmm.bcsr_panels_spmm
    assert engine.get_kernel("csr", "spmm", "ref") is tref.csr_spmm_ref
    assert engine.get_kernel("bcsr", "spmm", "ref") is tref.bcsr_spmm_ref
    assert engine.get_kernel("csr", "sdd") is spmm_sdd.csr_sdd_panels
    assert engine.get_kernel("bcsr", "sdd") is spmm_sdd.bcsr_sdd_panels
    assert engine.get_kernel("csr", "sdd", "ref") is tref.csr_sdd_ref
    assert engine.get_kernel("bcsr", "sdd", "ref") is tref.bcsr_sdd_ref
    with pytest.raises(KeyError):
        engine.get_kernel("csr", "spgemm")
