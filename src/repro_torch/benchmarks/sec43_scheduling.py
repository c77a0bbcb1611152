"""Paper §4.3: effectiveness of adaptive scheduling -- LOOPS (perf-model
driven hybrid) against pure-vector (r_b = nrows) and pure-matrix (r_b = 0)
across sparsity patterns, reporting how often the adaptive choice wins
(paper: best on 83.3% of SuiteSparse).

Port of the reference's ``benchmarks/sec43_scheduling.py``.  The
calibration probes (``calibrate``'s ``measure``) and the three timed
plans run ``loops_spmm`` on the port's kernels B1/B2 on the device.  The
five regimes are the reference's generators at ``ROWS`` = 768 rows;
``rows`` scales them while keeping each regime's nonzeros per row (the
block, uniform and hypersparse densities shrink as 768 / rows), so the
card can run them at 100,000 rows and more; at 768 rows they are the
reference's matrices exactly.

  PYTHONPATH=src python -m repro_torch.benchmarks.sec43_scheduling \\
      --device cpu
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import loops_from_csr, loops_spmm, plan_and_convert, suite
from ..core.partition import choose_r_boundary
from ..core.perf_model import calibrate
from ..kernels import engine
from ._util import csv_row, time_fn

N = 32
ROWS = 768
REGIMES = ("banded", "powerlaw", "block", "uniform", "hypersparse")


def case(name: str, rows: int = ROWS):
    """The regime's matrix at ``rows`` rows (square)."""
    s = ROWS / rows
    if name == "banded":
        return suite.banded(rows, rows, 6, seed=0)
    if name == "powerlaw":
        return suite.powerlaw(rows, rows, 8.0, seed=1)
    if name == "block":
        return suite.block_dense(rows, rows, 16, 0.05 * s, seed=2)
    if name == "uniform":
        return suite.uniform(rows, rows, 0.01 * s, seed=3)
    if name == "hypersparse":
        return suite.uniform(rows, rows, 0.001 * s, seed=4)
    raise ValueError(f"unknown regime {name!r}; expected one of {REGIMES}")


def run_case(csr, b, *, probe_repeats: int = 3, repeats: int = 5) -> dict:
    """Calibrate on ``b``'s device, plan, and time the adaptive plan
    against pure vector and pure matrix.  Returns times (s), the boundary
    and whether the adaptive plan won (within 5% of the best)."""
    dev = b.device
    fmts = {}

    def measure(x, y):
        """Warm-up measurement for the perf model: the hybrid at the
        boundary implied by (x, y), one conversion per boundary."""
        r = choose_r_boundary(csr.nrows, 1.0, 4.0, max(x, 0), max(y, 0),
                              br=8)
        if r not in fmts:
            fmts[r] = loops_from_csr(csr, r, 8)
        return 1.0 / time_fn(lambda: loops_spmm(fmts[r], b, device=dev),
                             device=dev, repeats=probe_repeats, warmup=1)

    model = calibrate(measure, total=4)
    fmt_ad, _ = plan_and_convert(csr, total_workers=4, model=model,
                                    device=dev)
    fmt_v = fmts.get(csr.nrows) or loops_from_csr(csr, csr.nrows, 8)
    fmt_m = fmts.get(0) or loops_from_csr(csr, 0, 8)
    ts = {}
    for tag, fmt in (("adaptive", fmt_ad), ("pure_vector", fmt_v),
                     ("pure_matrix", fmt_m)):
        ts[tag] = time_fn(lambda f=fmt: loops_spmm(f, b, device=dev),
                          device=dev, repeats=repeats)
    won = ts["adaptive"] <= min(ts.values()) * 1.05
    return {"times": ts, "r_boundary": fmt_ad.r_boundary,
            "nrows": csr.nrows, "nnz": csr.nnz, "won": bool(won),
            "probes": model.calibrated_from}


def main(out=print, rows: int = ROWS, device=None) -> dict:
    dev = engine.resolve_device(device)
    rng = np.random.default_rng(5)
    results = {}
    for name in REGIMES:
        csr = case(name, rows)
        b = torch.as_tensor(rng.standard_normal((csr.shape[1], N))
                            .astype(np.float32)).to(dev)
        res = results[name] = run_case(csr, b)
        ts = res["times"]
        t = ts["adaptive"]
        out(csv_row(f"sec43_{name}", t * 1e6,
                    f"vs_pure_vector={ts['pure_vector'] / t:.2f}x;"
                    f"vs_pure_matrix={ts['pure_matrix'] / t:.2f}x;"
                    f"r_b={res['r_boundary']}/{csr.nrows};"
                    f"win={int(res['won'])}"))
    frac = sum(r["won"] for r in results.values()) / len(REGIMES)
    out(csv_row("sec43_summary", 0.0,
                f"adaptive_best_frac={frac:.2f} "
                f"(paper: 0.833 on full SuiteSparse)"))
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    main(device=args.device)
