"""Paper §4.5 end-to-end case study on the PyTorch/CUDA port: train a
2-layer GCN whose neighbourhood aggregation runs through the LOOPS SpMM.

The twin of ``examples/gcn_train.py`` on ``repro_torch``.  It trains a few
hundred steps of node classification on a synthetic graph and checks that
(a) the loss decreases and (b) the LOOPS operator's gradients match the
dense adjacency's (no accuracy loss, as the paper reports).

The model and loss are ``repro_torch.models``' ``GCN`` and ``gcn_loss``;
``--backend cuda`` (the default) runs both aggregations on the kernels B1
and B2, forward and backward (B1/B2 on the cached transposed adjacency),
and ``--backend torch`` on the flat references, the gradient oracle.  It
runs on the GPU unless ``--device cpu`` is given (where ``cuda`` runs the
kernels' plain versions).  The inputs come from
``numpy.random.default_rng(0)`` in the reference's order, so step 0's loss
equals the reference's.

Run:  PYTHONPATH=src python examples/gcn_train_torch.py        # the card
      PYTHONPATH=src python examples/gcn_train_torch.py --autotune
      PYTHONPATH=src python examples/gcn_train_torch.py --device cpu \\
          --backend torch --steps 2 --nodes 64 --degree 4         # smoke
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import csr_to_dense, plan_and_convert, suite
from repro_torch.kernels.engine import resolve_device
from repro_torch.models import GCN, gcn_loss, sgd_step

F_IN, F_HID, F_OUT = 64, 64, 10
GRAD_TOL = 1e-4


def main(argv=None) -> dict:
    """Run the example; returns its readings (plan, gradient check, first
    and last loss, ms a step), also printed as the last line in JSON."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5.0)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="SpMM backend of both aggregations, forward and "
                         "backward: the kernels (default) or the flat "
                         "references (the gradient oracle)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--skip-grad-check", action="store_true",
                    help="skip the one-off LOOPS against dense-adjacency "
                         "gradient check")
    ap.add_argument("--autotune", action="store_true",
                    help="plan with the measured repro_torch.tune cache "
                         "instead of the model's total_workers=8 plan; the "
                         "two GCN layers (and every restart with the same "
                         "graph statistics) share one cached plan")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    adj = suite.gcn_graph(args.nodes, args.degree, seed=0)
    result = {"nodes": args.nodes, "nnz": adj.nnz, "backend": args.backend,
              "device": str(dev)}
    if args.autotune:
        from repro_torch.tune import PlanCache, autotune
        cache = PlanCache()   # $REPRO_TUNE_CACHE honoured
        # One autotune per layer: layer 0 pays for the search (or hits a
        # previous run's plan on disk), layer 1 is an in-process cache hit.
        fmt, plan = autotune(adj, n_cols=F_HID, cache=cache,
                             backend=args.backend, device=dev)
        _, plan1 = autotune(adj, n_cols=F_HID, cache=cache,
                            backend=args.backend, device=dev)
        if plan1 != plan:
            raise RuntimeError("the second layer's plan is not the first's")
        st = cache.stats
        result["cache"] = {"hits": st.hits, "misses": st.misses,
                           "near_hits": st.near_hits, "stored": len(cache)}
        print(f"autotune: plan={plan}; cache {st} ({len(cache)} stored "
              f"plans in {cache.dir})")
    else:
        fmt, plan = plan_and_convert(adj, total_workers=8, device=dev)
    sync()
    t_prep = time.perf_counter() - t0
    result["plan"] = {"r_boundary": plan.r_boundary, "br": plan.br,
                      "panel_g": plan.panel_g}
    result["prep_s"] = t_prep
    print(f"graph: {args.nodes} nodes, nnz={adj.nnz}; conversion "
          f"{t_prep:.3f}s (r_boundary={plan.r_boundary}); "
          f"backend={args.backend} on {dev}")

    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((args.nodes, F_IN)).astype(np.float32)
    # planted labels: community = argmax of a random linear map of features
    w_true = rng.standard_normal((F_IN, F_OUT))
    y_np = np.argmax(csr_to_dense(adj) @ (x_np @ w_true), axis=1)
    w0 = (rng.standard_normal((F_IN, F_HID)) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((F_HID, F_OUT)) * 0.1).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np.astype(np.int32), device=dev)
    model = GCN(fmt, torch.as_tensor(w0, device=dev),
                torch.as_tensor(w1, device=dev), backend=args.backend)

    if not args.skip_grad_check:
        # One-off parity: autograd through LOOPS against the dense
        # adjacency's (paper: "no accuracy loss").  The dense adjacency
        # exists only here; the training step never touches it.
        a_dense = torch.as_tensor(csr_to_dense(adj), device=dev)

        def dense_logits(x_):
            h = torch.relu(a_dense @ (x_ @ model.w0))
            return a_dense @ (h @ model.w1)
        params = list(model.parameters())
        g_loops = torch.autograd.grad(gcn_loss(model, x, y)[0], params)
        g_dense = torch.autograd.grad(gcn_loss(dense_logits, x, y)[0],
                                      params)
        err = max(float((a - b).abs().max())
                  for a, b in zip(g_loops, g_dense))
        result["grad_err"] = err
        if not err <= GRAD_TOL:
            raise RuntimeError(f"LOOPS gradients off by {err:.2e} "
                               f"(> {GRAD_TOL})")
        print(f"grad check: max |loops - dense| = {err:.2e}  "
              f"(<= {GRAD_TOL}) OK")
        del a_dense

    sync()
    t0 = time.perf_counter()
    first = last = None
    for s in range(args.steps):
        loss, acc = sgd_step(model, x, y, args.lr)
        if first is None:
            first = float(loss)
        if s % max(args.steps // 10, 1) == 0 or s == args.steps - 1:
            last = float(loss)
            print(f"step {s:4d} loss {last:.4f} acc {float(acc):.3f}")
    sync()
    dt = time.perf_counter() - t0
    result.update(steps=args.steps, first_loss=first, last_loss=last,
                  ms_per_step=dt / max(args.steps, 1) * 1e3)
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({result['ms_per_step']:.1f} ms/step); prep amortised over "
          f"{t_prep / max(dt / max(args.steps, 1), 1e-12):.0f} steps "
          f"(paper: 1.3% of e2e)")
    if args.steps >= 40:
        if not last < first * 0.7:
            raise RuntimeError(f"GCN failed to learn: {first} -> {last}")
        print("OK: loss decreased", first, "->", last)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
