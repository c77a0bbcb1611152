"""The port on the card: the CUDA kernels B1-B5 against their plain
PyTorch versions, ``loops_spmm`` / ``loops_spmm_values`` (forward and
backward) and the GCN against the flat PyTorch path, and a full-width
llama3.2-1b prefill (two layers) through B5 against its plain attention
path, the tuner's timed window and cache hits on the card, the
serve executor pool's CUDA graphs (graphed against eager logits, two
slots of one bucket, launch counts through replays, a failing capture),
``torch.vmap`` over ``loops_spmm`` (one launch a part, forward and
backward, equal to the batched call and to each element's gradient), and
training: B5's log-sum-exp and gradients against its plain version, the
serving launch unchanged by the lse, a reduced llama train step on the
card against the same step on the CPU, the opt-in fallback chain on CUDA
tensors (raising by default, degrading once opted in, re-raising during a
graph capture) and NVML's energy counter around a timed loop, and B1-B5
through their ``torch.ops.repro_torch`` operators (bits and launches
against a direct operator call and the plain version; a fake trace on CUDA
tensors launching nothing).  Every test here needs a CUDA device and skips
without one.

This file imports neither JAX nor the reference package, so it runs on the
GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

It also holds the adversarial panel shapes the CPU parity files share.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.configs import get_config
from repro_torch.kernels import bcsr_spmm, csr_spmm, spmm_sdd
from repro_torch.kernels import flash_attention as b5
from repro_torch.models import GCN, api, gcn_params_from_numpy


def adversarial_cases(rng):
    """Dense float64 matrices whose panelizations hit every padding edge:
    the reference kernel tests' cases plus empty rows, an empty block-row
    and a column-0 entry."""
    def sparse(m, k, d):
        return (rng.random((m, k)) < d) * rng.standard_normal((m, k))
    cases = {"indivisible": sparse(11, 9, 0.35),
             "single_row": sparse(1, 13, 0.6)}
    hub = np.zeros((5, 24))
    hub[2, :] = rng.standard_normal(24)
    hub[0, 3] = 1.5
    cases["row_spans_panels"] = hub
    short = np.zeros((9, 6))
    for r in range(9):
        short[r, r % 6] = r + 1.0
        if r % 2:
            short[r, (r + 3) % 6] = -1.0
    cases["panel_at_row_boundary"] = short
    holes = sparse(40, 17, 0.25)
    holes[3] = 0
    holes[16:33] = 0          # whole empty block-rows at Br 4, 8 and 16
    holes[35, 0] = 2.0
    cases["empty_rows"] = holes
    return cases


def hub_case(rng, k):
    """A 68 x ``k`` matrix whose rows 1, 3, 4 and 36 are dense, with empty
    rows around them, and one more entry: at Br 4, 8 and 16 and any
    boundary a multiple of 4, a hub row or block-row sits between empty
    groups, and at a boundary of 4 the first BCSR block-row is a hub."""
    a = np.zeros((68, k))
    for r in (1, 3, 4, 36):
        a[r] = rng.standard_normal(k)
    a[10, 5] = 0.5
    return a


def sdd_block_case(rng, k=3000):
    """A 200 x ``k`` matrix whose CSR part (rows 0-191 at a boundary of
    192) has B3's three kinds of row group (``kernels/spmm_sdd.py``'s
    ``BLOCK_ROWS`` = 64): rows 0-63 at 10% over 700 columns (shared
    columns, like the sparse FFN: staged), rows 64-127 a hub row of ``k``
    columns among sparse ones (no shared columns: direct blocks cut across
    the hub), and rows 128-191 where every column has two values (rows
    128-129 share 600 columns, rows 130-191 pair up on 31 more): staged
    bands at the distinct-column cap."""
    a = np.zeros((200, k))
    a[:64, :700] = (rng.random((64, 700)) < 0.1) * rng.standard_normal(
        (64, 700))
    a[64] = rng.standard_normal(k)
    for r in range(65, 128):
        a[r, rng.choice(k, 3, replace=False)] = rng.standard_normal(3)
    a[128:130, :600] = rng.standard_normal((2, 600))
    for r in range(130, 192):
        a[r, 600 + r % 31] = rng.standard_normal()
    a[192:] = (rng.random((8, k)) < 0.01) * rng.standard_normal((8, k))
    return a


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_cuda_kernels_match_plain(cuda, rng, dname):
    dt = getattr(torch, dname)
    tol = {"float32": 1e-5, "float64": 1e-12}.get(dname, 1e-2)
    br = 16 if dname in ("bfloat16", "float16") else 8
    for name, a in adversarial_cases(rng).items():
        fmt = tf.loops_from_csr(tf.csr_from_dense(a), a.shape[0] // 2, br,
                                panel_g=3)
        for part, fn, plain, kw in (
                ("csr", csr_spmm.csr_panels_spmm,
                 csr_spmm.csr_panels_spmm_plain,
                 {"nrows": fmt.r_boundary}),
                ("bcsr", bcsr_spmm.bcsr_panels_spmm,
                 bcsr_spmm.bcsr_panels_spmm_plain,
                 {"nblocks": fmt.bcsr_part.nblocks})):
            p = getattr(fmt.on(cuda), part)
            vals = p.vals.to(dt)
            for shape in ((a.shape[1], 40), (3, a.shape[1], 600)):
                b = torch.randn(shape, device=cuda).to(dt)
                launches = fn.launches
                got = fn(p.rows, p.cols, vals, p.mask, b, panel_ptr=p.ptr,
                         **kw)
                assert fn.launches == launches + 1
                want = plain(p.rows, p.cols, vals, p.mask, b, **kw)
                assert got.shape == want.shape and got.dtype == want.dtype
                if want.numel():      # a part with no rows returns (.., 0, N)
                    scale = max(1.0, float(want.abs().max()))
                    err = float((got.double() - want.double()).abs().max())
                    assert err <= tol * scale, (name, part, shape, err)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p = tf.loops_from_csr(tf.csr_from_dense(np.eye(8, dtype=np.float32)),
                          8, 8).on(cuda).csr
    b = torch.ones((8, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="share"):
        csr_spmm.csr_panels_spmm(p.rows, p.cols, p.vals, p.mask, b, nrows=8)
    with pytest.raises(ValueError, match="bool"):
        csr_spmm.csr_panels_spmm(p.rows, p.cols, p.vals, p.mask.float(),
                                 b.float(), nrows=8)


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["float32", "float64", "float16"])
def test_cuda_loops_spmm_matches_flat_torch(cuda, dname):
    csr = tsuite.table2_like("m4", scale_rows=4096, seed=0).astype(dname)
    fmt, plan = tspmm.plan_and_convert(csr)
    b = torch.randn((2, csr.shape[1], 40), device=cuda).to(
        getattr(torch, dname))
    counts = (csr_spmm.csr_panels_spmm.launches,
              bcsr_spmm.bcsr_panels_spmm.launches)
    got = tspmm.loops_spmm(fmt, b)
    assert (csr_spmm.csr_panels_spmm.launches,
            bcsr_spmm.bcsr_panels_spmm.launches) == (counts[0] + 1,
                                                     counts[1] + 1)
    want = tspmm.loops_spmm(fmt, b, backend="torch")
    # a transposed (non-contiguous) operand runs through the same kernels
    bt = b.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not bt.is_contiguous()
    assert torch.equal(tspmm.loops_spmm(fmt, bt), got)
    tol = {"float32": 1e-5, "float64": 1e-12}.get(dname, 1e-2)
    scale = max(1.0, float(want.abs().max()))
    assert float((got.double() - want.double()).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_cuda_kernels_with_forced_splits_match_plain(cuda, rng, dname):
    """B1/B2 on unit tables that split every group longer than U = 1, 2, 3
    panels (the second pass on every multi-panel group), and on a hub case
    whose row and block-row span hundreds of units, against the plain
    versions; each table also through the fused buffer, B2 at a row offset
    whose first block-row is split."""
    dt = getattr(torch, dname)
    tol = {"float32": 1e-5, "float64": 1e-12}.get(dname, 1e-2)
    br = 16 if dname in ("bfloat16", "float16") else 8
    cases = {**adversarial_cases(rng), "hub": hub_case(rng, 2000)}
    for name, a in cases.items():
        r_b = 4 if name == "hub" else a.shape[0] // 2
        fmt = tf.loops_from_csr(tf.csr_from_dense(a), r_b, br, panel_g=3)
        dev = fmt.on(cuda)
        cp = dataclasses.replace(dev.csr, vals=dev.csr.vals.to(dt))
        bp = dataclasses.replace(dev.bcsr, vals=dev.bcsr.vals.to(dt))
        nb = fmt.bcsr_part.nblocks
        for u in (1, 2, 3):
            ct = csr_spmm.unit_table_of(cp.ptr, u)
            bt = csr_spmm.unit_table_of(bp.ptr, u)
            if name == "hub":
                assert ct.max_slots >= 50 and bt.max_slots >= 50
            for shape in ((a.shape[1], 32), (3, a.shape[1], 40),
                          (2, a.shape[1], 600)):
                b = torch.randn(shape, device=cuda).to(dt)
                want = torch.full((shape[0] if len(shape) == 3 else 1,
                                   r_b + nb * br, shape[-1]), float("nan"),
                                  dtype=dt, device=cuda)
                got = want.clone()
                csr_spmm.csr_panels_spmm_plain(
                    cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=r_b,
                    out_dtype=dt, out=want)
                bcsr_spmm.bcsr_panels_spmm_plain(
                    bp.rows, bp.cols, bp.vals, bp.mask, b, nblocks=nb,
                    row_offset=r_b, out_dtype=dt, out=want)
                csr_spmm.csr_panels_spmm(
                    cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=r_b,
                    units=ct, out_dtype=dt, out=got)
                bcsr_spmm.bcsr_panels_spmm(
                    bp.rows, bp.cols, bp.vals, bp.mask, b, nblocks=nb,
                    units=bt, row_offset=r_b, out_dtype=dt, out=got)
                assert not got.isnan().any(), (name, u, shape)
                scale = max(1.0, float(want.abs().max()))
                err = float((got.double() - want.double()).abs().max())
                assert err <= tol * scale, (name, u, shape, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_cuda_loops_spmm_is_bitwise_deterministic(cuda, dname):
    """Split groups are summed in a fixed order: two calls give the same
    bits (an in-2004-like matrix whose hub rows split in both parts)."""
    csr = tsuite.table2_like("m4", scale_rows=20_000, seed=0).astype(dname)
    fmt, _ = tspmm.plan_and_convert(csr)
    dev = fmt.on(cuda)
    assert dev.csr.units.nsplit and dev.bcsr.units.nsplit
    b = torch.randn((3, csr.shape[1], 32), device=cuda).to(
        getattr(torch, dname))
    first = tspmm.loops_spmm(fmt, b)
    for _ in range(3):
        assert torch.equal(tspmm.loops_spmm(fmt, b), first)


@pytest.mark.gpu
def test_cuda_gcn_matches_cpu(cuda):
    """The GCN on the default (CUDA) device against the same model on the
    CPU, where the wrappers run their plain versions."""
    rng = np.random.default_rng(0)
    adj = tsuite.gcn_graph(2000, 5, seed=0)
    params = {"w0": rng.standard_normal((16, 256)).astype(np.float32) * 0.1,
              "w1": rng.standard_normal((256, 40)).astype(np.float32) * 0.1}
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    fmt, _ = tspmm.plan_and_convert(adj)
    launches = csr_spmm.csr_panels_spmm.launches
    got = GCN(fmt, **gcn_params_from_numpy(params))(
        torch.from_numpy(x).to(cuda))
    assert csr_spmm.csr_panels_spmm.launches == launches + 2
    want = GCN(fmt, **gcn_params_from_numpy(params, device="cpu"))(
        torch.from_numpy(x))
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_cuda_sdd_kernels_match_plain(cuda, rng, dname):
    """B3 and B4 against their plain versions, whole panel arrays (masked
    lanes 0 in both), with dY in B's dtype and, for half B, in fp32; B4
    with the part's row offset equals B4 on the zero-padded rows."""
    dt = getattr(torch, dname)
    half = dname in ("bfloat16", "float16")
    tol = {"float32": 1e-5, "float64": 1e-12}.get(dname, 1e-2)
    br = 16 if half else 8
    for name, a in adversarial_cases(rng).items():
        m = a.shape[0]
        fmt = tf.loops_from_csr(tf.csr_from_dense(a), m // 2 // br * br, br,
                                panel_g=3)
        dev = fmt.on(cuda)
        r_b, nb = fmt.r_boundary, fmt.bcsr_part.nblocks
        for shape_b, n in (((a.shape[1],), 40), ((3, a.shape[1]), 600)):
            b = torch.randn(shape_b[:-1] + (shape_b[-1], n),
                            device=cuda).to(dt)
            for dy_dt in ((dt, torch.float32) if half else (dt,)):
                dy = torch.randn(shape_b[:-1] + (m, n), device=cuda).to(dy_dt)
                runs = [(spmm_sdd.csr_sdd_panels,
                         spmm_sdd.csr_sdd_panels_plain, dev.csr, {}, dy)]
                dy_pad = torch.zeros(dy.shape[:-2] + (nb * br, n),
                                     device=cuda, dtype=dy_dt)
                dy_pad[..., :m - r_b, :] = dy[..., r_b:, :]
                runs += [(spmm_sdd.bcsr_sdd_panels,
                          spmm_sdd.bcsr_sdd_panels_plain, dev.bcsr,
                          {"br": br, "row_offset": r_b, "nrows": m - r_b}, dy),
                         (spmm_sdd.bcsr_sdd_panels,
                          spmm_sdd.bcsr_sdd_panels_plain, dev.bcsr,
                          {"br": br}, dy_pad)]
                outs = []
                for fn, plain, p, kw, d in runs:
                    launches = fn.launches
                    got = fn(p.rows, p.cols, p.mask, d, b, **kw)
                    assert fn.launches == launches + 1
                    want = plain(p.rows, p.cols, p.mask, d, b, **kw)
                    assert got.shape == want.shape and got.dtype == want.dtype
                    if want.numel():
                        scale = max(1.0, float(want.abs().max()))
                        err = float((got.double() - want.double()).abs().max())
                        assert err <= tol * scale, (name, fn.__name__, n, err)
                    outs.append(got)
                assert torch.equal(outs[1], outs[2]), name


# (dY dtype, B dtype): the pairs B3/B4 take (LOOPS_DISPATCH_SDD).
SDD_PAIRS = [("float32", "float32"), ("float64", "float64"),
             ("float16", "float16"), ("bfloat16", "bfloat16"),
             ("float32", "float16"), ("float32", "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("dy_name,b_name", SDD_PAIRS)
@pytest.mark.parametrize("br", [4, 8, 16])
def test_cuda_bcsr_sdd_unit_edges(cuda, rng, dy_name, b_name, br):
    """B4 (one CTA a work unit, the dY chunk staged once a unit) at its
    edges, against the plain version: hub block-rows of 140 panels split
    over two units of the uploaded table and over 47 units of a table at
    U = 3, a block-row of one panel, G = 5 (a job of 5 live lanes), batch
    1, 2 and 3 and none, N 40 and 600 and 37 (B rows not 16-byte aligned:
    staged with plain loads), every dtype pair; masked lanes exactly 0,
    and two calls bitwise equal.  Tolerances are B's dtype's (fp32
    1e-5, fp64 1e-12, half 1e-2) of max(1, max |plain|), except fp32 dY
    against bf16 B: the hi + mid + lo split keeps dY's fp32 precision, so
    1e-4 (one bf16 rounding of dY is ~1e-3 off at these sums)."""
    dyt, bt = getattr(torch, dy_name), getattr(torch, b_name)
    tol = {"float32": 1e-5, "float64": 1e-12}.get(b_name, 1e-2)
    if (dy_name, b_name) == ("float32", "bfloat16"):
        tol = 1e-4
    a = hub_case(rng, 700)
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), 4, br, panel_g=5)
    p = fmt.on(cuda).bcsr
    assert np.bincount(p.units.units[:, 0].cpu().numpy()).max() > 1
    assert 1 in np.diff(p.ptr.cpu().numpy())
    kw = {"br": br, "row_offset": fmt.r_boundary,
          "nrows": fmt.nrows - fmt.r_boundary}
    for lead, n in (((), 40), ((3,), 600), ((1,), 40), ((2,), 37)):
        b = torch.randn(lead + (a.shape[1], n), device=cuda).to(bt)
        dy = torch.randn(lead + (fmt.nrows, n), device=cuda).to(dyt)
        want = spmm_sdd.bcsr_sdd_panels_plain(p.rows, p.cols, p.mask, dy, b,
                                              **kw)
        scale = max(1.0, float(want.abs().max()))
        for units in (p.units, csr_spmm.unit_table_of(p.ptr, 3)):
            got = spmm_sdd.bcsr_sdd_panels(p.rows, p.cols, p.mask, dy, b,
                                           units=units, **kw)
            again = spmm_sdd.bcsr_sdd_panels(p.rows, p.cols, p.mask, dy, b,
                                             units=units, **kw)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(got, again)
            dead = ~p.mask[:, None, :].expand_as(got)
            assert bool((got[dead] == 0).all())
            err = float((got.double() - want.double()).abs().max())
            assert err <= tol * scale, (lead, n, units.unit_panels, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dy_name,b_name", SDD_PAIRS)
@pytest.mark.parametrize("g", [3, 8])
def test_cuda_csr_sdd_block_edges(cuda, rng, dy_name, b_name, g):
    """B3 (one CTA a block of its table) at its edges, against the plain
    version: staged and direct blocks in one call (``sdd_block_case``), a
    hub row cut across direct blocks, staged bands at the distinct-column
    cap, blocks larger than a CTA holds (walked in passes, at caps of
    4096), G 3 and 8, batch 1 and 3 and none, N 1, 33, 40, 600 and 1000
    (N 33: B rows not 16-byte aligned, staged with plain loads), every
    dtype pair; masked lanes exactly 0, and two calls bitwise equal.  B3
    accumulates in fp32 as the plain version does (fp64 in fp64), so the
    tolerance is 1e-5 (fp64 1e-12) of max(1, max |plain|)."""
    dyt, bt = getattr(torch, dy_name), getattr(torch, b_name)
    tol = 1e-12 if b_name == "float64" else 1e-5
    a = sdd_block_case(rng)
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), 192, 8, panel_g=g)
    p = fmt.on(cuda).csr
    tables = {"uploaded": p.sdd_blocks,
              "passes": spmm_sdd.sdd_block_table(
                  p.rows, p.cols, p.mask, block_outs=4096, direct_outs=4096)}
    own = p.sdd_blocks
    assert own.nstaged and own.ndirect
    assert own.max_cols == spmm_sdd.BLOCK_COLS
    for lead, n in (((1,), 40), ((3,), 600), ((), 33), ((1,), 1000),
                    ((3,), 1)):
        b = torch.randn(lead + (a.shape[1], n), device=cuda).to(bt)
        dy = torch.randn(lead + (a.shape[0], n), device=cuda).to(dyt)
        want = spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask, dy, b)
        scale = max(1.0, float(want.abs().max()))
        for name, t in tables.items():
            launches = spmm_sdd.csr_sdd_panels.launches
            got = spmm_sdd.csr_sdd_panels(p.rows, p.cols, p.mask, dy, b,
                                          blocks=t)
            again = spmm_sdd.csr_sdd_panels(p.rows, p.cols, p.mask, dy, b,
                                            blocks=t)
            torch.cuda.synchronize()
            assert spmm_sdd.csr_sdd_panels.launches == launches + 2
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(got, again), (name, lead, n)
            assert bool((got[~p.mask] == 0).all())
            err = float((got.double() - want.double()).abs().max())
            assert err <= tol * scale, (name, lead, n, err)


# B5's bound on |got - plain| / |plain| of each output row (norms over
# hd), as chip_smoke.FLASH_ROW_TOL.
ROW_TOL = {"bfloat16": 1.5e-2, "float16": 3e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["bfloat16", "float16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 1, 4, 1, 64), (1, 63, 3, 1, 32), (2, 65, 4, 4, 16),
    (1, 65, 4, 1, 16), (1, 1000, 12, 3, 128), (2, 200, 6, 2, 128),
    (1, 1000, 3, 3, 32), (1, 2049, 8, 2, 64), (4, 2048, 32, 8, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_edges(cuda, dname, B, S, H, KV, hd, causal):
    """B5's wgmma body at its edges: hd 16/32/64/128 (each its own swizzle
    and descriptors), 1, 3 and 4 q-heads a kv-head (a CTA serves at most 2
    heads of a group: 2 of 4, 1 of 3), ragged S (1, 63, 65, 1000, 2049:
    rows TMA zero-fills, keys masked), and the serving shape (1,024 CTAs,
    32 tiles deep), causal and not, against the plain version at 1e-2 of
    max(1, max |plain|), and each output row within ``ROW_TOL`` of its own
    norm (``chip_smoke.FLASH_ROW_TOL``): a long row's output is ~1e-2 of
    that scale, and a lost or misplaced K / V tile moves it by more."""
    g = torch.Generator(device=cuda).manual_seed(S + 7 * H + hd)
    dt = getattr(torch, dname)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dt)
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda).to(dt)
    before = b5.flash_attention.launches
    got = b5.flash_attention(q, k, v, causal=causal)
    want = b5.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert b5.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    scale = max(1.0, float(want.double().abs().max()))
    assert float((got.double() - want.double()).abs().max()) <= 1e-2 * scale
    d = (got.double() - want.double()).norm(dim=-1)
    row = float((d / want.double().norm(dim=-1).clamp_min(1e-300)).max())
    assert row <= ROW_TOL[dname], row


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_cuda_loops_spmm_values_backward_matches_flat(cuda, dname):
    """One ``loops_spmm_values`` forward and backward on the kernels (B1/B2
    forward, B1/B2 on Aᵀ for dB, B3/B4 for the values) against autograd
    through the flat path, with the same cotangent.  The flat path runs in
    fp32 on the same values (bf16 is exact in fp32): in bf16 its autograd
    rounds every gathered product's gradient to bf16 before the scatter."""
    dt = getattr(torch, dname)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((512, 96)).astype(np.float32)
    from repro_torch.models import sparse_linear_from_dense
    layer = sparse_linear_from_dense(torch.from_numpy(w).to(dt), 0.8)
    fmt = layer.fmt
    assert 0 < fmt.r_boundary < fmt.nrows
    b = torch.randn((2, 96, 48), device=cuda).to(dt).requires_grad_(True)
    dy = torch.randn((2, 512, 48), device=cuda)
    kernels = (csr_spmm.csr_panels_spmm, bcsr_spmm.bcsr_panels_spmm,
               spmm_sdd.csr_sdd_panels, spmm_sdd.bcsr_sdd_panels)
    before = [k.launches for k in kernels]
    y = tspmm.loops_spmm_values(fmt, layer.csr_vals, layer.bcsr_vals, b)
    got = torch.autograd.grad(y, [layer.csr_vals, layer.bcsr_vals, b], dy)
    tl = fmt.transposed(dtype=dt)
    assert [k.launches - n for k, n in zip(kernels, before)] == [
        1 + int(tl.fmt.r_boundary > 0),
        1 + int(tl.fmt.r_boundary < tl.fmt.nrows), 1, 1]
    flat_in = [t.detach().float().requires_grad_(True)
               for t in (layer.csr_vals, layer.bcsr_vals, b)]
    before = [k.launches for k in kernels]
    want = torch.autograd.grad(
        tspmm.loops_spmm_values(fmt, *flat_in, backend="torch"), flat_in,
        dy)
    assert [k.launches for k in kernels] == before
    tol = 1e-5 if dname == "float32" else 1e-2
    for g, w_ in zip(got, want):
        assert g.dtype == dt and g.shape == w_.shape
        scale = max(1.0, float(w_.abs().max()))
        assert float((g.double() - w_.double()).abs().max()) <= tol * scale


def _spmm_launches():
    return (csr_spmm.csr_panels_spmm.launches,
            bcsr_spmm.bcsr_panels_spmm.launches)


def _parts(fmt):
    return (int(fmt.r_boundary > 0), int(fmt.r_boundary < fmt.nrows))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4, 16])
def test_cuda_vmap_is_one_launch_a_part(cuda, batch):
    """``torch.vmap(lambda b: loops_spmm(fmt, b))`` over a (batch, K, N)
    operand launches B1 and B2 once each, and gives the bits of
    ``loops_spmm(fmt, b3)``; its backward (vmap of the gradient) launches
    each part of Aᵀ once and gives each element's unbatched gradient."""
    csr = tsuite.table2_like("m13", scale_rows=4096, seed=3)
    fmt, plan = tspmm.plan_and_convert(csr)
    assert _parts(fmt) == (1, 1)
    b3 = torch.randn((batch, csr.shape[1], 32), device=cuda)
    dy = torch.randn((batch, csr.nrows, 32), device=cuda)
    direct = tspmm.loops_spmm(fmt, b3)
    before = _spmm_launches()
    got = torch.vmap(lambda b: tspmm.loops_spmm(fmt, b))(b3)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_spmm_launches(), before)] == [1, 1]
    assert torch.equal(got, direct)

    def loss(b, d):
        return (tspmm.loops_spmm(fmt, b) * d).sum()
    tl = fmt.transposed()
    torch.func.grad(loss)(b3[0], dy[0])      # builds Aᵀ outside the count
    before = _spmm_launches()
    db = torch.vmap(torch.func.grad(loss))(b3, dy)
    torch.cuda.synchronize()
    want = [p + q for p, q in zip(_parts(fmt), _parts(tl.fmt))]
    assert [a - b for a, b in zip(_spmm_launches(), before)] == want
    for i in range(batch):
        assert torch.equal(db[i], torch.func.grad(loss)(b3[i], dy[i]))


@pytest.mark.gpu
def test_cuda_vmap_value_grads_match_unbatched(cuda):
    """vmap of the gradient of ``loops_spmm_values`` on the kernels: each
    element's value gradients (B3/B4, one call an element) and dB equal the
    unbatched gradients of that element."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((512, 96)).astype(np.float32)
    from repro_torch.models import sparse_linear_from_dense
    layer = sparse_linear_from_dense(torch.from_numpy(w), 0.8)
    fmt = layer.fmt
    cv, bv = layer.csr_vals.detach(), layer.bcsr_vals.detach()
    b3 = torch.randn((3, 96, 48), device=cuda)

    def loss(c, v, b):
        return torch.tanh(tspmm.loops_spmm_values(fmt, c, v, b)).sum()
    grads = torch.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                       in_dims=(None, None, 0))(cv, bv, b3)
    for i in range(3):
        one = torch.func.grad(loss, argnums=(0, 1, 2))(cv, bv, b3[i])
        for g, o in zip(grads, one):
            assert torch.equal(g[i], o)


@pytest.mark.gpu
@pytest.mark.parametrize("dname,tol", [("float32", 2e-5), ("bfloat16", 1e-2),
                                       ("float16", 1e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 1, 1, 16), (2, 128, 4, 2, 32), (1, 64, 6, 2, 16),
    (1, 1000, 4, 1, 128), (2, 200, 8, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain(cuda, dname, tol, B, S, H, KV,
                                            hd, causal):
    """B5 against its plain version on the same card tensors; fp32 at the
    reference test's 2e-5, half at 1e-2 (both accumulate in fp32 and round
    the output once, so they differ by an output ulp at most), relative to
    max(1, max |plain|)."""
    g = torch.Generator(device=cuda).manual_seed(S + H + hd)
    dt = getattr(torch, dname)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dt)
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda).to(dt)
    before = b5.flash_attention.launches
    got = b5.flash_attention(q, k, v, causal=causal)
    want = b5.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert b5.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    scale = max(1.0, float(want.double().abs().max()))
    assert float((got.double() - want.double()).abs().max()) <= tol * scale


@pytest.mark.gpu
def test_cuda_full_width_prefill_matches_plain_attention(cuda):
    """llama3.2-1b at full width with two of its 16 layers, fp32 (TF32 off):
    prefill through B5 (one launch per layer) against the plain attention
    path, logits within 1e-4 of max(1, max |logits|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              dtype=torch.float32)
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = b5.flash_attention.launches
    cache, got = api.prefill(cfg, params, {"tokens": toks})
    assert b5.flash_attention.launches == before + cfg.num_layers
    cache_p, want = api.prefill(cfg, params, {"tokens": toks},
                                backend="torch")
    assert b5.flash_attention.launches == before + cfg.num_layers
    torch.cuda.synchronize()
    for g, w in ((got, want), (cache["k"], cache_p["k"]),
                 (cache["v"], cache_p["v"])):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale



@pytest.mark.gpu
def test_cuda_tuner_timed_window_syncs_and_excludes_the_upload(cuda,
                                                               monkeypatch):
    """``measure_plan_gflops`` uploads both parts' panels (and B1/B2's unit
    tables) before the first timed call, synchronises once, and then times
    ``repeats`` runs of ``CUDA_RUN_CALLS`` back-to-back calls with CUDA
    events (no host sync between the calls)."""
    import importlib
    from repro_torch.kernels import engine
    search = importlib.import_module("repro_torch.tune.search")
    csr = tsuite.table2_like("m4", scale_rows=4096, seed=1)
    events = []
    upload = tf.DevicePanels.upload.__func__
    monkeypatch.setattr(tf.DevicePanels, "upload", classmethod(
        lambda cls, panels, device: (events.append("upload"),
                                     upload(cls, panels, device))[1]))
    fused = engine.loops_spmm_fused
    monkeypatch.setattr(engine, "loops_spmm_fused", lambda *a, **k: (
        events.append("call"), fused(*a, **k))[1])
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (
        events.append("sync"), sync(*a))[1])
    plan = tspmm.SpmmPlan(r_boundary=1024, t_vpu=2, t_mxu=6, br=8,
                          panel_g=4)
    b = torch.randn((csr.ncols, 32), device=cuda)
    launches = csr_spmm.csr_panels_spmm.launches
    fmt, gflops = search.measure_plan_gflops(
        csr, plan, b, budget=search.SearchBudget(repeats=3, warmup=0))
    calls = 3 * search.CUDA_RUN_CALLS
    assert events == ["upload", "upload", "sync"] + ["call"] * calls
    assert csr_spmm.csr_panels_spmm.launches == launches + calls
    assert gflops > 0 and str(b.device) in fmt._device_cache


@pytest.mark.gpu
def test_cuda_exact_hit_makes_no_measurement(cuda, tmp_path, monkeypatch):
    """A repeat ``autotune`` on the card is an exact hit: no measurement,
    the same plan, and the tuned format runs B1/B2 to the flat result."""
    import importlib
    from repro_torch.tune import PlanCache, SearchBudget, autotune
    search = importlib.import_module("repro_torch.tune.search")
    calls = []
    real = search.measure_plan_gflops
    monkeypatch.setattr(search, "measure_plan_gflops", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    csr = tsuite.table2_like("m12", scale_rows=4096, seed=1)
    cache = PlanCache(str(tmp_path))
    budget = SearchBudget(top_k=3, repeats=2, warmup=1)
    fmt, plan = autotune(csr, n_cols=32, cache=cache, budget=budget)
    # the three survivors, and the model's plan unless one converts alike
    trials = len(calls)
    assert trials in (3, 4) and cache.stats.misses == 1
    assert plan.pipeline_depth == 1
    fmt2, plan2 = autotune(csr, n_cols=32, cache=cache, budget=budget)
    assert len(calls) == trials and cache.stats.hits == 1 and plan2 == plan
    b = torch.randn((csr.ncols, 32), device=cuda)
    launches = bcsr_spmm.bcsr_panels_spmm.launches
    got = tspmm.loops_spmm(fmt2, b)
    want = tspmm.loops_spmm(fmt2, b, backend="torch")
    assert bcsr_spmm.bcsr_panels_spmm.launches == launches + int(
        plan.r_boundary < csr.nrows)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the serve executor pool: CUDA graphs per shape bucket
# ---------------------------------------------------------------------------

def _graph_model(cuda, **change):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), **change)
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    return cfg, params


@pytest.mark.gpu
def test_cuda_graphed_steps_match_eager(cuda):
    """llama3.2-1b at full width with two layers, fp32: a bucket's captured
    prefill and 4 decode steps against eager ``api.prefill`` /
    ``api.decode_step`` on the same tokens, logits within 1e-4 of max(1,
    max |logits|); B5 counts 2 launches per prefill replay, none per decode
    replay, and none for the capture itself."""
    from repro_torch.serve.queue import ExecutorPool, pad_cache
    cfg, params = _graph_model(cuda, num_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 64 + 4))
    pool = ExecutorPool(cfg, params)
    slot = pool.acquire(pool.bundle(2, 64, 72))
    before = b5.flash_attention.launches
    _, got = slot.prefill_fn({"tokens": toks[:, :64]})
    got = [got.clone()]
    assert b5.flash_attention.launches == before + 2
    for i in range(4):
        _, lg = slot.serve_fn(toks[:, 64 + i:65 + i], 64 + i)
        got.append(lg.clone())
    assert b5.flash_attention.launches == before + 2
    cache, lg = api.prefill(cfg, params, {"tokens": torch.as_tensor(
        toks[:, :64], device=cuda)})
    want = [lg]
    cache = pad_cache(cfg, cache, 72)
    for i in range(4):
        _, lg = api.decode_step(cfg, params, cache, torch.as_tensor(
            toks[:, 64 + i:65 + i], device=cuda), 64 + i)
        want.append(lg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale
    for name in ("k", "v"):
        assert torch.allclose(slot.cache[name][:, :, :68],
                              cache[name][:, :, :68], rtol=0, atol=1e-4)


def _reduced_queue(cfg, params, pool, in_flight):
    from repro_torch.serve.queue import ServeQueue
    from repro_torch.serve.scheduler import SchedulerConfig
    return ServeQueue(cfg, params, pool=pool, temperature=0.7, seed=5,
                      config=SchedulerConfig(max_in_flight=in_flight,
                                             max_batch=1, min_batch=1,
                                             max_wait_s=0.0))


def _drive_all(q, prompts, gen, rids):
    reqs = [q.submit(p, gen, now=0.0, rid=rid)
            for p, rid in zip(prompts, rids)]
    t = 0.0
    while q.pending and q.step(now=t):
        t += 1.0
    return [r.tokens for r in reqs]


@pytest.mark.gpu
def test_cuda_two_groups_of_one_bucket_take_two_slots(cuda):
    """Two groups of one bucket in flight at once each replay their own
    slot's graphs over their own cache: the streams equal each request's
    alone, and B5 counts one launch a layer for every prefill replay and
    every slot's warm-up run, none for the captures."""
    from repro_torch.configs import REDUCED
    from repro_torch.serve.queue import ExecutorPool
    cfg = REDUCED["llama3.2-1b"]()
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 12).tolist()
               for _ in range(2)]
    pool = ExecutorPool(cfg, params)
    before = b5.flash_attention.launches
    both = _reduced_queue(cfg, params, pool, 2)
    got = _drive_all(both, prompts, 6, [100, 101])
    assert pool.slots == 2 and pool.peak_in_use == 2 and len(pool) == 1
    assert b5.flash_attention.launches - before == cfg.num_layers * (
        both.sched.counters["prefill_batches"] + pool.slots)
    for i, p in enumerate(prompts):
        alone = _reduced_queue(cfg, params, ExecutorPool(cfg, params), 1)
        assert _drive_all(alone, [p], 6, [100 + i])[0] == got[i]


@pytest.mark.gpu
def test_cuda_failing_capture_raises(cuda, monkeypatch):
    """A step that raises while it is captured propagates its error: no
    slot is kept and nothing runs eagerly in its place."""
    from repro_torch.configs import REDUCED
    from repro_torch.models import layers
    from repro_torch.serve.queue import ExecutorPool
    cfg = REDUCED["llama3.2-1b"]()
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    real = layers.decode_attention

    def fail_in_capture(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused in capture")
        return real(*a, **k)
    monkeypatch.setattr(layers, "decode_attention", fail_in_capture)
    pool = ExecutorPool(cfg, params)
    q = _reduced_queue(cfg, params, pool, 1)
    q.submit([1, 2, 3, 4], 3, now=0.0)
    with pytest.raises(RuntimeError) as err:
        q.step(now=0.0)
    # the step's own error, or the capture's end raising on top of it
    assert "refused in capture" in str(err.value) + str(
        err.value.__context__)
    assert pool.slots == 0 and not q.completed


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _grad_row_err(got, want):
    """max over rows of |got - want| / max(|want|, 1e-3 max|want|)."""
    w = want.double()
    norms = w.norm(dim=-1)
    floor = max(float(norms.max()) * 1e-3, 1e-300)
    return float(((got.double() - w).norm(dim=-1)
                  / norms.clamp_min(floor)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dname,row_tol", [("float32", 1e-4),
                                           ("bfloat16", 1.5e-2),
                                           ("float16", 3e-3)])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 64, 1, 1, 16),
                                         (2, 200, 8, 2, 64),
                                         (1, 300, 4, 1, 128),
                                         (2, 128, 4, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_lse_and_grads(cuda, dname, row_tol, B, S, H,
                                            KV, hd, causal):
    """B5's log-sum-exp against the plain version's (1e-5 of max(1,
    |lse|)), the output with an lse equal to the output without, and the
    Function's dQ, dK, dV against autograd through the plain forward in
    fp32 on the same inputs, each row within the dtype's row tolerance
    (chip_smoke's ``FLASH_ROW_TOL``)."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    dt = getattr(torch, dname)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=cuda).to(dt)
               for n in (H, KV, KV))
    do = torch.randn(q.shape, generator=g, device=cuda).to(dt)
    before = b5.flash_attention.launches
    out, lse = b5.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert b5.flash_attention.launches == before + 1
    _, lse_p = b5.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=True)
    assert torch.equal(out, b5.flash_attention(q, k, v, causal=causal))
    scale = max(1.0, float(lse_p.abs().max()))
    assert float((lse - lse_p).abs().max()) <= 1e-5 * scale
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(b5.flash_attention_train(
        *ins, causal=causal), ins, do)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(b5.flash_attention_plain(
        *ref, causal=causal), ref, do.float())
    torch.cuda.synchronize()
    for got, w in zip(grads, want):
        assert got.dtype == dt and got.shape == w.shape
        assert _grad_row_err(got, w) <= row_tol


@pytest.mark.gpu
def test_cuda_serving_launch_unchanged_by_training(cuda):
    """The serving path runs under ``no_grad`` over the now-trainable
    weights: prefill at the reduced llama launches B5 once per layer (with
    a null lse, outside the Function), its logits record no graph, and a
    second call gives the same bits."""
    from repro_torch.configs import REDUCED
    cfg = REDUCED["llama3.2-1b"]()
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = b5.flash_attention.launches
    cache, logits = api.prefill(cfg, params, {"tokens": toks})
    assert b5.flash_attention.launches == before + cfg.num_layers
    assert logits.grad_fn is None and not logits.requires_grad
    _, again = api.prefill(cfg, params, {"tokens": toks})
    assert torch.equal(logits, again)


@pytest.mark.gpu
def test_cuda_reduced_train_step_matches_cpu(cuda):
    """One train step (two microbatches, AdamW) of the reduced llama in
    fp32 on the card (B5, its Function) against the same step on the CPU
    (the plain versions), from the same weights and batch: loss and
    grad_norm within 1e-5 relative, the new parameters within 1e-2 of the
    step's lr (Adam's first step normalises each gradient element; at eps
    1e-3 it is well conditioned)."""
    from repro_torch.configs import REDUCED
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist.step import build_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(REDUCED["llama3.2-1b"](), dtype=torch.float32)
    cpu = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    gpu = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu").to(cuda)
    batch = global_batch_at(DataConfig(seed=3), cfg, ShapeConfig(
        "t", 64, 4, "train"), 2, 0, device="cpu")
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    out = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, cuda)):
        fn = build_train_step(cfg, params, opt, n_microbatches=2)
        before = b5.flash_attention.launches
        params, _, m = fn(params, init_opt_state(params, 1),
                          {k: v.to(dev) for k, v in batch.items()})
        launched = b5.flash_attention.launches - before
        assert launched == (0 if dev == "cpu" else cfg.num_layers * 2 * 2)
        out[name] = ({k: float(v) for k, v in m.items()},
                     {k: p.detach().cpu() for k, p in
                      params.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm"):
        assert mg[key] == pytest.approx(mc[key], rel=1e-5)
    for name, p in pc.items():
        assert float((pg[name] - p).abs().max()) <= 1e-2 * mc["lr"], name


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip_and_async_copy(cuda, tmp_path):
    """A tree on the card saves (through pinned host copies) and restores
    bit for bit; ``save_async`` has copied the tree before it returns, so
    an in-place update right after does not reach the file."""
    from repro_torch.checkpoint import Checkpointer, restore, save
    g = torch.Generator(device=cuda).manual_seed(3)
    tree = {"p": {"w": torch.randn((64, 33), generator=g,
                                   device=cuda).to(torch.bfloat16)},
            "opt": {"m": torch.randn(1000, generator=g, device=cuda),
                    "count": torch.tensor(3, dtype=torch.int32,
                                          device=cuda)}}
    save(str(tmp_path / "a"), 1, tree)
    _, back, _ = restore(str(tmp_path / "a"), tree)
    want = {"w": tree["p"]["w"].cpu(), "m": tree["opt"]["m"].cpu()}
    assert torch.equal(back["p"]["w"], want["w"])
    assert torch.equal(back["opt"]["m"], want["m"])
    assert int(back["opt"]["count"]) == 3
    ck = Checkpointer(str(tmp_path / "b"))
    ck.save_async(2, tree)
    tree["opt"]["m"].add_(1.0)
    ck.close()
    _, back, _ = restore(str(tmp_path / "b"), tree)
    assert torch.equal(back["opt"]["m"], want["m"])


# ---------------------------------------------------------------------------
# the opt-in fallback chain and Table 3's energy counter
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_fallback_chain_is_opt_in_and_reraises_in_capture(cuda):
    """On CUDA tensors: an injected first-link fault raises under the
    process's policy; opted in, it degrades to the flat product (no B1/B2
    launch, one ``engine.fallback`` count, the kernel's result within
    1e-5); during a CUDA graph capture it raises."""
    from repro_torch.obs import Obs, set_active
    from repro_torch.resilience import (FallbackPolicy, FaultPlan,
                                        InjectedFault, get_policy, set_plan,
                                        set_policy)
    csr = tsuite.table2_like("m12", scale_rows=4096, seed=1)
    fmt, _ = tspmm.plan_and_convert(csr, device=cuda)
    assert 0 < fmt.r_boundary < fmt.nrows
    b = torch.randn((csr.ncols, 32), device=cuda)
    want = tspmm.loops_spmm(fmt, b)
    obs = Obs(source="t")
    prev_obs = set_active(obs)
    assert get_policy().enabled is False
    site = "engine.fused.spmm.cuda"
    try:
        set_plan(FaultPlan.parse(f"{site}:raise:0:0"))
        with pytest.raises(InjectedFault):
            tspmm.loops_spmm(fmt, b)
        prev = set_policy(FallbackPolicy())
        try:
            launches = (csr_spmm.csr_panels_spmm.launches,
                        bcsr_spmm.bcsr_panels_spmm.launches)
            got = tspmm.loops_spmm(fmt, b)
            torch.cuda.synchronize()
            assert (csr_spmm.csr_panels_spmm.launches,
                    bcsr_spmm.bcsr_panels_spmm.launches) == launches
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= 1e-5 * scale
            assert obs.metrics.find("counter", "engine.fallback",
                                    part="fused", op="spmm",
                                    reason="injected").value == 1
            graph = torch.cuda.CUDAGraph()
            with pytest.raises(Exception) as err:
                with torch.cuda.graph(graph):
                    tspmm.loops_spmm(fmt, b)
            assert isinstance(err.value, InjectedFault) or isinstance(
                err.value.__context__, InjectedFault)
            assert obs.metrics.find("counter", "engine.fallback",
                                    part="fused", op="spmm",
                                    reason="injected").value == 1
        finally:
            set_policy(prev)
    finally:
        set_plan(None)
        set_active(prev_obs)


@pytest.mark.gpu
def test_cuda_nvml_energy_counter_increases_around_a_loop(cuda):
    """NVML's total-energy counter, read through ``ctypes``, names this
    card and grows across half a second of matrix products."""
    from repro_torch.benchmarks import table3_energy
    nvml = table3_energy.Nvml(cuda)
    try:
        assert nvml.name == torch.cuda.get_device_name(cuda)
        assert nvml.power_limit_w() > 0
        a = torch.randn((4096, 4096), device=cuda)
        torch.cuda.synchronize()
        e0, t0 = nvml.energy_j(), time.perf_counter()
        while time.perf_counter() - t0 < 0.5:
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
        e1 = nvml.energy_j()
        assert e1 > e0
    finally:
        nvml.close()


@pytest.mark.gpu
def test_cuda_nvml_counter_refresh_interval_is_measured(cuda):
    """Table 3's window ends: NVML's energy counter changes within
    ``TICK_WAIT_S`` and its refresh interval is positive."""
    from repro_torch.benchmarks import table3_energy
    nvml = table3_energy.Nvml(cuda)
    try:
        assert 0 < table3_energy.refresh_ms(nvml) < 1e3 * \
            table3_energy.TICK_WAIT_S
    finally:
        nvml.close()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-34b", "internlm2-20b",
                                  "qwen3-32b"])
def test_cuda_dense_family_serving_matches_cpu(cuda, arch):
    """The dense family's reduced configs (MQA; kv 2; qk-norm) in fp32 on
    the card: a prefill through B5 (one launch a layer) and 2 decode steps
    against the same weights on the CPU, logits within 1e-4 of max(1, max
    |logits|)."""
    from repro_torch.configs import REDUCED
    from repro_torch.models import transformer
    cfg = dataclasses.replace(REDUCED[arch](), dtype=torch.float32)
    cpu = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    card = transformer.LM(cfg, cuda)
    with torch.no_grad():
        card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 34))
    outs = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        cache = api.init_cache(cfg, 2, 34, device=dev)
        before = b5.flash_attention.launches
        _, lg = api.prefill(cfg, params, {"tokens": torch.as_tensor(
            toks[:, :32], device=dev)}, cache=cache)
        launched = b5.flash_attention.launches - before
        got = [lg]
        for i in range(2):
            _, lg = api.decode_step(cfg, params, cache, torch.as_tensor(
                toks[:, 32 + i:33 + i], device=dev), 32 + i)
            got.append(lg)
        outs.append((got, launched))
    assert outs[0][1] == 0 and outs[1][1] == cfg.num_layers
    for w, g in zip(outs[0][0], outs[1][0]):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale


# -- B1-B5 as operators (kernels/_ops.py) ----------------------------------

def _op_case(cuda):
    """Each kernel's wrapper call, its operator's direct call (same
    tensors, the wrapper's own output buffer for B1/B2), and its plain
    version, at a mid size in fp32 (B5 in bf16, causal)."""
    rng = np.random.default_rng(11)
    a = (rng.random((300, 257)) < 0.1) * rng.standard_normal((300, 257))
    fmt = tf.loops_from_csr(tf.csr_from_dense(a.astype(np.float32)), 152, 8,
                            panel_g=8)
    dev = fmt.on(cuda)
    cp, bp = dev.csr, dev.bcsr
    b = torch.as_tensor(rng.standard_normal((1, 257, 32)).astype(
        np.float32), device=cuda)
    dy = torch.as_tensor(rng.standard_normal((1, 300, 32)).astype(
        np.float32), device=cuda)
    q = torch.randn((2, 256, 8, 64), device=cuda).to(torch.bfloat16)
    k = torch.randn((2, 256, 2, 64), device=cuda).to(torch.bfloat16)
    v = torch.randn((2, 256, 2, 64), device=cuda).to(torch.bfloat16)
    nb = fmt.bcsr_part.nblocks
    ops = torch.ops.repro_torch

    def b1_direct():
        out = torch.empty((1, 152, 32), device=cuda)
        ops.csr_panels_spmm(cp.units.units, cp.units.splits, cp.cols,
                            cp.vals, cp.mask, b, out, cp.units.nslots,
                            cp.units.max_slots, 152, cp.live)
        return out[0]

    def b2_direct():
        out = torch.empty((1, nb * 8, 32), device=cuda)
        ops.bcsr_panels_spmm(bp.units.units, bp.units.splits, bp.cols,
                             bp.vals, bp.mask, b, out, bp.units.nslots,
                             bp.units.max_slots, 0, nb * 8, bp.live)
        return out[0]

    blocks = cp.sdd_blocks
    return {
        "csr_panels_spmm": (
            lambda: csr_spmm.csr_panels_spmm(cp.rows, cp.cols, cp.vals,
                                             cp.mask, b[0], nrows=152,
                                             units=cp.units, live=cp.live),
            b1_direct,
            lambda: csr_spmm.csr_panels_spmm_plain(
                cp.rows, cp.cols, cp.vals, cp.mask, b[0], nrows=152)),
        "bcsr_panels_spmm": (
            lambda: bcsr_spmm.bcsr_panels_spmm(bp.rows, bp.cols, bp.vals,
                                               bp.mask, b[0], nblocks=nb,
                                               units=bp.units,
                                               live=bp.live),
            b2_direct,
            lambda: bcsr_spmm.bcsr_panels_spmm_plain(
                bp.rows, bp.cols, bp.vals, bp.mask, b[0], nblocks=nb)),
        "csr_sdd_panels": (
            lambda: spmm_sdd.csr_sdd_panels(cp.rows, cp.cols, cp.mask, dy,
                                            b, blocks=blocks, live=cp.live),
            lambda: ops.csr_sdd_panels(
                blocks.blocks, blocks.outs, blocks.info, blocks.cols,
                cp.rows, cp.cols, cp.mask, dy, b, blocks.nstaged,
                blocks.max_rows, blocks.max_cols, cp.live),
            lambda: spmm_sdd.csr_sdd_panels_plain(cp.rows, cp.cols, cp.mask,
                                                  dy, b)),
        "bcsr_sdd_panels": (
            lambda: spmm_sdd.bcsr_sdd_panels(bp.rows, bp.cols, bp.mask, dy,
                                             b, br=8, row_offset=152,
                                             nrows=148, units=bp.units,
                                             live=bp.live),
            lambda: ops.bcsr_sdd_panels(bp.units.units, bp.cols, bp.mask,
                                        dy, b, 8, 152, 148, bp.live),
            lambda: spmm_sdd.bcsr_sdd_panels_plain(
                bp.rows, bp.cols, bp.mask, dy, b, br=8, row_offset=152,
                nrows=148)),
        "flash_attention": (
            lambda: b5.flash_attention(q, k, v, causal=True),
            lambda: ops.flash_attention(q, k, v, True, False)[0],
            lambda: b5.flash_attention_plain(q, k, v, causal=True)),
    }


_OP_NAMES = ["csr_panels_spmm", "bcsr_panels_spmm", "csr_sdd_panels",
             "bcsr_sdd_panels", "flash_attention"]


def _launch_counter(name):
    return {"csr_panels_spmm": csr_spmm.csr_panels_spmm,
            "bcsr_panels_spmm": bcsr_spmm.bcsr_panels_spmm,
            "csr_sdd_panels": spmm_sdd.csr_sdd_panels,
            "bcsr_sdd_panels": spmm_sdd.bcsr_sdd_panels,
            "flash_attention": b5.flash_attention}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _OP_NAMES)
def test_cuda_operator_bits_and_launches(cuda, name):
    """Each kernel through its ``torch.ops.repro_torch`` operator: two
    wrapper calls bitwise equal, the operator called directly equal to
    them and launching once as the wrapper does, and the result within
    the dtype's tolerance of the plain version (fp32 1e-5, bf16 1e-2 of
    max(1, max |plain|))."""
    wrapper, direct, plain = _op_case(cuda)[name]
    fn = _launch_counter(name)
    before = fn.launches
    first = wrapper()
    second = wrapper()
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(first, second)
    got = direct()
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    assert torch.equal(got, first)
    want = plain()
    tol = 1e-2 if first.dtype == torch.bfloat16 else 1e-5
    scale = max(1.0, float(want.abs().max()))
    assert float((first.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
def test_cuda_fake_trace_launches_nothing(cuda):
    """Under ``FakeTensorMode`` a wrapper given CUDA tensors returns the
    launch's shapes, dtypes and strides, launches nothing, and its flops
    under ``FlopCounterMode`` are its operator's closed form."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cases = _op_case(cuda)
    for name in _OP_NAMES:
        wrapper = cases[name][0]
        real = wrapper()
        fn = _launch_counter(name)
        before = fn.launches
        with FakeTensorMode(allow_non_fake_inputs=True):
            with FlopCounterMode(display=False) as counter:
                fake = wrapper()
        assert fn.launches == before
        assert (fake.shape, fake.dtype, fake.stride()) == (
            real.shape, real.dtype, real.stride())
        assert counter.get_total_flops() > 0
