"""Batched multi-RHS SpMM: per-element loop against unrolled stack against
native batching, and ``torch.vmap``.

Port of the reference's ``benchmarks/batched_spmm.py``.  The kernels B1
and B2 take the whole batch of right-hand sides on their grid (A's panel
layout read once per unit and applied to every slice), so a batched
workload (GNN minibatches, sparse-FFN activations, concurrent requests)
can run the same math four ways:

  * **loop**       -- a Python loop over the elements, one ``loops_spmm``
                     call each (``batch`` x the launches);
  * **vmap**       -- the reference's meaning: the unrolled stack of
                     per-element calls in one function (``batch`` x the
                     launches, plus the stack);
  * **native**     -- ONE call on the ``(batch, K, N)`` operand (one launch
                     per part);
  * **torch_vmap** -- ``torch.vmap`` over ``loops_spmm``, whose rule folds
                     the mapped dim into the native call (one launch per
                     part, forward and backward; ``core/spmm.py``).

Forward and forward+backward (the gradient in the operand; under
``torch.vmap`` the per-element gradient, vmapped) are timed, and the
reference's grid-step cost proxy (``loops_batched_grid_steps``) is
recorded: the structural columns the perf gate pins, equal to the
reference's.  The outputs of loop, native and ``torch.vmap`` are checked
bitwise equal (each slice is summed in the same order), the unrolled
stack and the macro-fused layout against them to tolerance.

  PYTHONPATH=src python -m repro_torch.benchmarks.batched_spmm --smoke \\
      --device cpu
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import csr_from_dense, loops_spmm, plan_and_convert
from ..core.spmm import loops_batched_grid_steps, loops_grid_steps
from ..kernels import engine
from ._util import bench_rng, csv_row, time_fn

N = 32                       # dense columns per RHS (paper fixes N=32)
BATCHES = [1, 4, 8]
SMOKE_BATCHES = [4]
STRATEGIES = ("loop", "vmap", "native", "torch_vmap")


def _grad_of_sum(f, b):
    """The gradient of ``sum(f(b))`` in ``b`` (autograd)."""
    bb = b.detach().requires_grad_()
    f(bb).sum().backward()
    return bb.grad


def strategies(fmt, batch: int, device) -> dict:
    """``{name: (fwd, fwdbwd)}``, functions of the ``(batch, K, N)``
    operand: the four ways of the module docstring."""
    def one(b):
        return loops_spmm(fmt, b, device=device)

    def loop(b3):
        return [one(b3[i]) for i in range(batch)]

    def unrolled(b3):
        return torch.stack([one(b3[i]) for i in range(batch)])

    grad_one = torch.func.grad(lambda b: one(b).sum())
    return {
        "loop": (loop, lambda b3: [_grad_of_sum(one, b3[i])
                                   for i in range(batch)]),
        "vmap": (unrolled, lambda b3: _grad_of_sum(unrolled, b3)),
        "native": (one, lambda b3: _grad_of_sum(one, b3)),
        "torch_vmap": (torch.vmap(one), torch.vmap(grad_one)),
    }


def check_parity(fmt, fmt_piped, b3, device) -> None:
    """Loop, native and ``torch.vmap`` give the same bits, forward and
    backward; the unrolled stack and the macro-fused layout agree with
    them to tolerance."""
    fns = strategies(fmt, int(b3.shape[0]), device)
    fwd = {k: f(b3) for k, (f, _) in fns.items()}
    fwd["loop"] = torch.stack(fwd["loop"])
    bwd = {k: g(b3) for k, (_, g) in fns.items()}
    bwd["loop"] = torch.stack(bwd["loop"])
    for k in ("native", "torch_vmap"):
        if not (torch.equal(fwd[k], fwd["loop"])
                and torch.equal(bwd[k], bwd["loop"])):
            raise AssertionError(f"{k} differs from the per-element loop")
    torch.testing.assert_close(fwd["vmap"], fwd["loop"], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(loops_spmm(fmt_piped, b3, device=device),
                               fwd["loop"], rtol=1e-4, atol=1e-4)


def formats(csr, device):
    """The suite's plan of ``csr`` and its piped variant: the same plan at
    the macro-fused layout with the reference's depth-2 pipeline
    (structural; no kernel reads the depth), both on ``device``."""
    fmt, _ = plan_and_convert(csr, total_workers=8, device=device)
    fmt_piped, _ = plan_and_convert(csr, total_workers=8, pipeline_depth=2,
                                    macro_m=4, device=device)
    return fmt, fmt_piped


def run_matrix(fmt, fmt_piped, batches, *, rng, out=print, record=None,
               repeats: int = 5, warmup: int = 2, device=None) -> list:
    """The suite on one matrix's formats (:func:`formats`); returns the
    per-batch records."""
    dev = engine.resolve_device(device)
    k = fmt.ncols
    results = []
    for batch in batches:
        b3 = torch.as_tensor(rng.standard_normal((batch, k, N))
                             .astype(np.float32)).to(dev)
        steps_one = loops_grid_steps(fmt, N)
        steps = {"loop": batch * steps_one, "vmap": batch * steps_one,
                 "native": loops_batched_grid_steps(fmt, batch, N)}
        steps["torch_vmap"] = steps["native"]
        steps_piped = loops_batched_grid_steps(fmt_piped, batch, N)
        check_parity(fmt, fmt_piped, b3, dev)

        times = {}
        for name, (fwd, fwdbwd) in strategies(fmt, batch, dev).items():
            times[(name, "fwd")] = time_fn(fwd, b3, device=dev,
                                           repeats=repeats, warmup=warmup)
            times[(name, "fwdbwd")] = time_fn(fwdbwd, b3, device=dev,
                                              repeats=repeats, warmup=warmup)
        times[("piped", "fwd")] = time_fn(
            lambda b: loops_spmm(fmt_piped, b, device=dev), b3, device=dev,
            repeats=repeats, warmup=warmup)

        for name in STRATEGIES:
            out(csv_row(
                f"batched_b{batch}_{name}", times[(name, "fwd")] * 1e6,
                f"grid_steps={steps[name]};"
                f"fwdbwd_us={times[(name, 'fwdbwd')] * 1e6:.1f};"
                f"steps_vs_loop={steps['loop'] / max(steps[name], 1):.2f}x"))
        out(csv_row(
            f"batched_b{batch}_piped", times[("piped", "fwd")] * 1e6,
            f"grid_steps={steps_piped};pipeline_depth=2;macro_m=4;"
            f"steps_vs_loop={steps['loop'] / max(steps_piped, 1):.2f}x"))
        if batch >= 4 and not steps["native"] < steps["loop"]:
            raise AssertionError(
                f"native batched must beat the per-element loop on grid "
                f"steps at batch={batch}: {steps['native']} vs "
                f"{steps['loop']}")
        rec = {
            "suite": "batched", "batch": batch, "n_cols": N,
            "panel_g": fmt.panel_g,
            "pipeline_depth": fmt_piped.pipeline_depth,
            "macro_m": fmt_piped.macro_m,
            "grid_steps_loop": steps["loop"],
            "grid_steps_native": steps["native"],
            "grid_steps_piped": steps_piped,
            "fwd_us_piped": times[("piped", "fwd")] * 1e6,
            "step_reduction_vs_loop":
                steps["loop"] / max(steps["native"], 1),
            **{f"{p}_us_{name}": times[(name, p)] * 1e6
               for name in STRATEGIES for p in ("fwd", "fwdbwd")},
        }
        if record is not None:
            record(rec)
        results.append(rec)
    return results


def main(out=print, record=None, smoke: bool = False, device=None):
    scale = 96 if smoke else 256
    density = 0.08
    repeats, warmup = (2, 1) if smoke else (5, 2)
    rng = bench_rng()
    a = ((rng.random((scale, scale // 2)) < density)
         * rng.standard_normal((scale, scale // 2))).astype(np.float32)
    dev = engine.resolve_device(device)
    return run_matrix(*formats(csr_from_dense(a), dev),
                      SMOKE_BATCHES if smoke else BATCHES, rng=rng, out=out,
                      record=record, repeats=repeats, warmup=warmup,
                      device=dev)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    main(smoke=args.smoke, device=args.device)
