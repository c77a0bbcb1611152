"""Quickstart of the PyTorch/CUDA port: the LOOPS hybrid SpMM pipeline.

  stats -> perf-model calibration -> boundary (Eq. 1) -> Algorithm 1
  conversion -> hybrid execution (the CSR part on kernel B1, the BCSR part
  on kernel B2, one output buffer).

The twin of ``examples/quickstart.py`` on ``repro_torch``.  It runs on the
GPU by default (the CUDA kernels; without a GPU it raises); ``--device
cpu`` runs the kernels' plain PyTorch versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (csr_from_dense, csr_to_dense, loops_spmm,
                              plan_and_convert, row_stats, suite)
from repro_torch.core.perf_model import calibrate


def main(device: str = "cuda"):
    # A skewed matrix: hub rows on top (web-graph-like), regular band below
    # -- the regime the paper's hybrid format exists for.
    top = csr_to_dense(suite.powerlaw(256, 1024, 12.0, seed=0))
    bot = csr_to_dense(suite.banded(768, 1024, 5, seed=1))
    dense = np.concatenate([top, bot], axis=0).astype(np.float32)

    csr = csr_from_dense(dense)
    print("matrix:", csr.shape, "nnz:", csr.nnz)
    print("row stats:", row_stats(csr))

    # Calibrate the quadratic perf model (paper Eq. 2) from warm-up probes.
    # Here the probe is synthetic; benchmarks/fig4_throughput.py's
    # calibrated_plan times real kernel splits.
    model = calibrate(lambda x, y: 1.0 * x + 4.0 * min(y, 2)
                      + 0.3 * max(y - 2, 0), total=8)
    fmt, plan = plan_and_convert(csr, total_workers=8, model=model,
                                 device=device)
    print(f"plan: r_boundary={plan.r_boundary} "
          f"(CSR rows -> B1: {plan.r_boundary}, "
          f"BCSR rows -> B2: {csr.nrows - plan.r_boundary}), "
          f"workers vpu={plan.t_vpu} mxu={plan.t_mxu}, Br={plan.br}")

    b = torch.as_tensor(np.random.default_rng(2)
                        .standard_normal((1024, 32)).astype(np.float32),
                        device=device)
    out = loops_spmm(fmt, b, device=device)                  # B1 + B2
    flat = loops_spmm(fmt, b, device=device, backend="torch")  # flat path
    np.testing.assert_allclose(out.cpu().numpy(), dense @ b.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.cpu().numpy(), flat.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    where = "CUDA kernels" if out.is_cuda else "their plain versions"
    print(f"hybrid SpMM == dense ground truth == flat path ({where}): OK")
    print("C shape:", tuple(out.shape), "||C|| =",
          float(torch.linalg.norm(out)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    main(ap.parse_args().device)
