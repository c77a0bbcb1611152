"""Paper §4.5 / Table 4: end-to-end GCN training with the LOOPS aggregation
against the dense-adjacency and CSR-baseline aggregations.

Port of the reference's ``benchmarks/table4_gnn.py``.  A 2-layer GCN on a
synthetic graph, ``Â · relu(Â · X W0) W1``; one training step is the loss
and its gradients in ``W0`` and ``W1``.  Aggregations:

  * **loops** -- ``loops_spmm`` on the kernels B1/B2, backward B1/B2 on
    Âᵀ (the calibrated plan);
  * **dense** -- cuBLAS on Â dense (``None`` with its reason where Â dense
    exceeds ``_util.DENSE_BUDGET_BYTES``: ogbn-arxiv's is 115 GB);
  * **csr**   -- the flat row-wise path (``spmm_csr_baseline``'s), which
    autograd differentiates.

Reports per-epoch (one step) time, speedups, loss parity (the losses must
agree to 1e-3: same math, other operator) and the preparation's share
(conversion and calibration; the paper amortises it, 1.3%).

``train_step_us`` times the step through B1/B2 forward and B1/B2 on Âᵀ
backward, with its gradients within 1e-4 of the dense path's (the flat
path's where Â dense does not fit).  On the card it runs on the whole
graph; on the CPU on the reference's 256-node replica of each graph (the
same degree statistics).

``GRAPHS`` are the reference's; ``ARXIV`` is ogbn-arxiv's published size
and widths, which ``chip_smoke.py`` adds on the card.

  PYTHONPATH=src python -m repro_torch.benchmarks.table4_gnn --device cpu
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import loops_spmm, plan_and_convert, spmm_dense_baseline, suite
from ..kernels import engine
from ._util import csv_row, dense_operand, exact_fp32, time_fn
from .fig4_throughput import calibrated_plan, flat_path

# (name, nodes, average degree, F_in, F_hid, F_out)
GRAPHS = [("reddit-like", 2048, 24, 32, 32, 8),
          ("amazon-like", 1024, 8, 32, 32, 8),
          ("yelp-like", 1536, 16, 32, 32, 8)]
# ogbn-arxiv: 169,343 nodes, average degree ~7, 128 features, 40 classes;
# 256 hidden is OGB's GCN baseline width.
ARXIV = ("ogbn-arxiv", 169_343, 7, 128, 256, 40)
# The CPU's train-step replica (the reference's interpret-mode size).
TRAIN_STEP_NODES = 256
GRAD_TOL = 1e-4
LOSS_TOL = 1e-3


def _gcn_loss(agg, x, w0, w1, y):
    h = torch.relu(agg(x @ w0))
    logits = agg(h @ w1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[:, None])[:, 0]
    return (logz - gold).mean()


def _step(agg, x, w0, w1, y):
    """One training step: the loss and its gradients in (w0, w1)."""
    w0_ = w0.detach().requires_grad_()
    w1_ = w1.detach().requires_grad_()
    loss = _gcn_loss(agg, x, w0_, w1_, y)
    loss.backward()
    return loss.detach(), (w0_.grad, w1_.grad)


def _aggregations(adj, fmt, dev):
    """``{tag: agg or None}`` and the dense column's reason."""
    a_dense, why = dense_operand(adj, dev)
    flat = flat_path(adj, dev)
    aggs = {"loops": lambda h: loops_spmm(fmt, h, device=dev),
            "dense": None if a_dense is None else
            (lambda h: spmm_dense_baseline(a_dense, h)),
            "csr": flat}
    return aggs, why


def _inputs(rng, nodes, f_in, f_hid, f_out, dev):
    x = torch.as_tensor(rng.standard_normal((nodes, f_in)),
                        dtype=torch.float32).to(dev)
    w0 = torch.as_tensor(rng.standard_normal((f_in, f_hid)) * 0.1,
                         dtype=torch.float32).to(dev)
    w1 = torch.as_tensor(rng.standard_normal((f_hid, f_out)) * 0.1,
                         dtype=torch.float32).to(dev)
    y = torch.as_tensor(rng.integers(0, f_out, nodes)).to(dev)
    return x, w0, w1, y


def run_graph(name, n_nodes, deg, f_in, f_hid, f_out, *, rng, device,
              repeats: int = 5) -> dict:
    """One graph's row: times (s) of a step per aggregation, loss parity,
    the train step and its gradient error, preparation seconds."""
    dev = engine.resolve_device(device)
    t0 = time.perf_counter()
    adj = suite.gcn_graph(n_nodes, deg, seed=1)
    probe = torch.zeros((n_nodes, f_hid), dtype=torch.float32, device=dev)
    fmt, _ = calibrated_plan(adj, probe)
    t_prep = time.perf_counter() - t0
    x, w0, w1, y = _inputs(rng, n_nodes, f_in, f_hid, f_out, dev)
    aggs, dense_why = _aggregations(adj, fmt, dev)
    times, losses = {}, {}
    with exact_fp32():
        for tag, agg in aggs.items():
            if agg is None:
                times[tag] = None
                continue
            times[tag] = time_fn(_step, agg, x, w0, w1, y, device=dev,
                                 repeats=repeats, warmup=1)
            losses[tag] = float(_step(agg, x, w0, w1, y)[0])
        oracle = "dense" if aggs["dense"] is not None else "csr"
        parity = abs(losses["loops"] - losses[oracle])
        if parity >= LOSS_TOL:
            raise AssertionError(f"{name}: loss {losses['loops']} against "
                                 f"the {oracle} path's {losses[oracle]}")

        # The train step through the kernel path: the whole graph on the
        # card, the reference's replica on the CPU.
        if dev.type == "cuda":
            aggs_t, inputs_t = aggs, (x, w0, w1, y)
        else:
            nodes_t = min(TRAIN_STEP_NODES, n_nodes)
            adj_t = suite.gcn_graph(nodes_t, min(deg, nodes_t // 4 or 1),
                                    seed=1)
            fmt_t, _ = plan_and_convert(adj_t, total_workers=8, device=dev)
            aggs_t, _ = _aggregations(adj_t, fmt_t, dev)
            x_t = torch.as_tensor(rng.standard_normal((nodes_t, f_in)),
                                  dtype=torch.float32).to(dev)
            y_t = torch.as_tensor(rng.integers(0, f_out, nodes_t)).to(dev)
            inputs_t = (x_t, w0, w1, y_t)
        t_train = time_fn(_step, aggs_t["loops"], *inputs_t, device=dev,
                          repeats=3, warmup=1)
        g_real = _step(aggs_t["loops"], *inputs_t)[1]
        grad_oracle = "dense" if aggs_t["dense"] is not None else "csr"
        g_ref = _step(aggs_t[grad_oracle], *inputs_t)[1]
    gerr = max(float((a - b).abs().max()) for a, b in zip(g_real, g_ref))
    if gerr > GRAD_TOL:
        raise AssertionError(f"{name}: kernel-path gradients off by "
                             f"{gerr:.2e} from the {grad_oracle} path's")
    return {"nodes": n_nodes, "nnz": adj.nnz, "times": times,
            "r_boundary": fmt.r_boundary,
            "transposed_r_boundary": fmt.transposed().fmt.r_boundary,
            "loss_parity": parity, "loss_oracle": oracle,
            "dense_note": dense_why, "train_step_s": t_train,
            "train_nodes": int(inputs_t[0].shape[0]),
            "train_grad_err": gerr, "grad_oracle": grad_oracle,
            "prep_s": t_prep}


def main(out=print, device=None, graphs=GRAPHS) -> dict:
    rng = np.random.default_rng(0)
    results = {}
    for g in graphs:
        res = results[g[0]] = run_graph(*g, rng=rng, device=device)
        t = res["times"]
        vs_dense = "n/a" if t["dense"] is None else \
            f"{t['dense'] / t['loops']:.2f}x"
        out(csv_row(f"table4_{g[0]}", t["loops"] * 1e6,
                    f"vs_dense={vs_dense};"
                    f"vs_csr={t['csr'] / t['loops']:.2f}x;"
                    f"loss_parity={res['loss_parity']:.1e};"
                    f"train_step_us={res['train_step_s'] * 1e6:.0f};"
                    f"train_nodes={res['train_nodes']};"
                    f"train_grad_err={res['train_grad_err']:.1e};"
                    f"prep_amortized_over_epochs="
                    f"{res['prep_s'] / max(t['loops'], 1e-9):.0f}"))
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    main(device=args.device)
