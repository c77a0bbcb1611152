"""Paper Fig. 5: half-precision SpMM (paper: FP16 2-way fmopa; here bf16 in,
fp32 accumulation, the kernels' contract for half inputs).

Port of the reference's ``benchmarks/fig5_halfprec.py``.  Strategies, all
on the port's kernels B1/B2:

  * **hybrid**     -- LOOPS at its calibrated plan (Br 16);
  * **block-only** -- pure vector-wise BCSR (r_boundary = 0): the
                      Magicube-style "everything through the matrix unit"
                      strategy, which pays padding on irregular rows;
  * **csr-only**   -- pure row-wise execution (r_boundary = nrows).

A bf16 format keeps its host values in fp32 (numpy has no bfloat16), so
the values are A's rounded to bf16 and the products run through
``loops_spmm_values`` with bf16 values and a bf16 operand.  The
calibration probes run the same structure in fp32.  The reference's
"packed" rows timed its Pallas kernels in interpret mode; here they time
the CUDA kernels at the plan's layout and at the macro-fused depth-2 one
(no kernel reads the depth, ROADMAP queue C).

  PYTHONPATH=src python -m repro_torch.benchmarks.fig5_halfprec --smoke \\
      --device cpu
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import loops_from_csr, loops_spmm_values, suite
from ..kernels import engine
from ._util import csv_row, gflops, time_fn
from .fig4_throughput import calibrated_plan, geomean

N = 32
MATRICES = ["m6", "m8", "m10", "m13", "m14", "m17"]
BR = 16     # the half-precision tile height (HALF_PACKED_ROWS)


def bf16_values(fmt, device):
    """The format's CSR and BCSR values as bf16 tensors on ``device``."""
    return (torch.as_tensor(fmt.csr_part.vals).to(device, torch.bfloat16),
            torch.as_tensor(fmt.bcsr_part.tile_vals)
            .to(device, torch.bfloat16))


def main(out=print, smoke: bool = False, device=None) -> dict:
    dev = engine.resolve_device(device)
    scale = 192 if smoke else 1024
    repeats, warmup = (3, 1) if smoke else (20, 3)
    rng = np.random.default_rng(1)
    sp_block, sp_csr, results = [], [], {}
    for mid in MATRICES:
        csr32 = suite.table2_like(mid, scale_rows=scale, seed=4)
        csr = dataclasses.replace(csr32, vals=torch.as_tensor(csr32.vals).to(
            torch.bfloat16).float().numpy())
        b = torch.as_tensor(rng.standard_normal((csr.shape[1], N))).to(
            dev, torch.bfloat16)
        fmt, plan = calibrated_plan(csr, b, br=BR)
        fmt_block = loops_from_csr(csr, 0, plan.br)         # pure BCSR
        fmt_csr = loops_from_csr(csr, csr.nrows, plan.br)   # pure CSR
        fmt_piped = loops_from_csr(csr, plan.r_boundary, plan.br,
                                   panel_g=plan.panel_g, macro_m=4,
                                   pipeline_depth=2)
        ts = {}
        for tag, f in (("hybrid", fmt), ("block", fmt_block),
                       ("csr", fmt_csr), ("piped", fmt_piped)):
            cv, bv = bf16_values(f, dev)
            ts[tag] = time_fn(
                lambda f=f, cv=cv, bv=bv: loops_spmm_values(
                    f, cv, bv, b, device=dev),
                device=dev, repeats=repeats, warmup=warmup)
        t_h = ts["hybrid"]
        out(csv_row(f"fig5_bf16_{mid}_packed", t_h * 1e6,
                    f"packed_piped_us={ts['piped'] * 1e6:.1f};"
                    f"pipeline_depth=2;macro_m=4;"
                    f"piped_speedup={t_h / max(ts['piped'], 1e-12):.2f}x"))
        # padding waste of the block-only format (zero fraction of tiles)
        tiles = fmt_block.bcsr_part.tile_vals
        waste = 1.0 - (np.count_nonzero(tiles) / max(tiles.size, 1))
        g = gflops(csr.nnz, N, t_h)
        out(csv_row(f"fig5_bf16_{mid}_{suite.TABLE2_STATS[mid].name}",
                    t_h * 1e6,
                    f"GFLOPS={g:.2f};vs_blockonly={ts['block'] / t_h:.2f}x;"
                    f"vs_csronly={ts['csr'] / t_h:.2f}x;"
                    f"block_pad_waste={waste:.2f}"))
        sp_block.append(ts["block"] / t_h)
        sp_csr.append(ts["csr"] / t_h)
        results[mid] = {"times": ts, "gflops": g, "nnz": csr.nnz,
                        "r_boundary": plan.r_boundary,
                        "block_pad_waste": waste}
    out(csv_row("fig5_bf16_geomean", 0.0,
                f"vs_blockonly={geomean(sp_block):.2f}x;"
                f"vs_csronly={geomean(sp_csr):.2f}x"))
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    main(smoke=args.smoke, device=args.device)
