"""The port on the card: the CUDA kernels B1-B5 against their plain
PyTorch versions, ``loops_spmm`` / ``loops_spmm_values`` (forward and
backward) and the GCN against the flat PyTorch path, and a full-width
llama3.2-1b prefill (two layers) through B5 against its plain attention
path.  Every test here
needs a CUDA device and skips without one.

This file imports neither JAX nor the reference package, so it runs on the
GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

It also holds the adversarial panel shapes the CPU parity files share.
"""
import dataclasses

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

