"""The port on the card: the CUDA kernels B1 and B2 against their plain
PyTorch versions, and ``loops_spmm`` / the GCN against the flat PyTorch
path.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the reference package, so it runs on the
GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

It also holds the adversarial panel shapes the CPU parity files share.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.kernels import bcsr_spmm, csr_spmm
from repro_torch.models import GCN, gcn_params_from_numpy


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
