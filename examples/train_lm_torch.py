"""Sparse-FFN LM training on the PyTorch/CUDA port: the paper's technique
inside a transformer.

Port of ``examples/train_lm.py``.  A small llama-style LM whose every FFN
up/down projection is magnitude-pruned and executed through the LOOPS
SpMM (values trainable, structure fixed), trained with plain SGD.  On
``cuda`` (the default) one step runs every hand-written kernel: B1/B2 in
the FFN forward and, on the transposed formats, for dX; B3/B4 for the
value gradients; B5 for attention (its forward, with the backward from
the saved log-sum-exp).  The run ends with the reference's check turned
round: the model trained on the kernels gives the same logits on the
plain path (``backend="torch"``: the flat SpMM references and the plain
attention) within 1e-3.

The parameters come from the same ``np.random.default_rng(0)`` draws as
the reference's, through ``sparse_linear_from_dense``, so the structures
match the reference's panel for panel.  The token stream is a
deliberate divergence: the reference draws it with ``jax.random``, the
port with numpy seeded from ``(7, step)`` (the same period-8 induction
task).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sparse_ffn import (sparse_linear_apply,
                                           sparse_linear_from_dense)


def build(d_model, d_ff, n_layers, vocab, sparsity, rng, *, device):
    """The reference's parameters (same draws, same order), as a dict of
    trainable fp32 tensors on ``device``; the FFN entries are the sparse
    layers' own value parameters.  Returns (params, structures)."""
    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            requires_grad=True)
    params = {"embed": put(rng.standard_normal((vocab, d_model)) * 0.02)}
    structures = []
    for i in range(n_layers):
        wi = rng.standard_normal((d_ff, d_model)).astype(np.float32) * 0.05
        wo = rng.standard_normal((d_model, d_ff)).astype(np.float32) * 0.05
        li = sparse_linear_from_dense(wi, sparsity, device=device)
        lo = sparse_linear_from_dense(wo, sparsity, device=device)
        structures.append((li, lo))
        params[f"ffn{i}_in"] = {"csr_vals": li.csr_vals,
                                "bcsr_vals": li.bcsr_vals}
        params[f"ffn{i}_out"] = {"csr_vals": lo.csr_vals,
                                 "bcsr_vals": lo.bcsr_vals}
        params[f"attn{i}"] = {
            name: put(rng.standard_normal((d_model, d_model)) * 0.05)
            for name in ("wq", "wk", "wv", "wo")}
        params[f"norm{i}a"] = {"scale": put(np.ones(d_model))}
        params[f"norm{i}b"] = {"scale": put(np.ones(d_model))}
    params["final_norm"] = {"scale": put(np.ones(d_model))}
    return params, structures


def leaves(params):
    """The trainable tensors, in a fixed order."""
    out = []
    for name in params:
        v = params[name]
        out.extend(v[k] for k in sorted(v)) if isinstance(v, dict) \
            else out.append(v)
    return out


def _norm(p):
    return types.SimpleNamespace(scale=p["scale"])


def forward(params, structures, tokens, n_heads, backend=None, taps=None):
    """Logits (B, S, vocab) of ``tokens`` (B, S).  ``backend="torch"`` runs
    the plain path; ``taps`` (a list) collects ``(layer, input, output)``
    of every sparse layer, with the output's gradient retained."""
    x = F.embedding(tokens, params["embed"])
    bsz, seq, d = x.shape
    pos = torch.arange(seq, device=x.device)[None]
    hd = d // n_heads

    def sparse(layer, h):
        y = sparse_linear_apply(layer, h, backend=backend)
        if taps is not None:
            y.retain_grad()
            taps.append((layer, h, y))
        return y
    for i, (li, lo) in enumerate(structures):
        h = L.rmsnorm(_norm(params[f"norm{i}a"]), x)
        ap = params[f"attn{i}"]
        q = L.rope((h @ ap["wq"]).reshape(bsz, seq, n_heads, hd), pos, 1e4)
        k = L.rope((h @ ap["wk"]).reshape(bsz, seq, n_heads, hd), pos, 1e4)
        v = (h @ ap["wv"]).reshape(bsz, seq, n_heads, hd)
        attn = L.flash_attention(q, k, v, causal=True, backend=backend)
        x = x + attn.reshape(bsz, seq, d) @ ap["wo"]
        h2 = L.rmsnorm(_norm(params[f"norm{i}b"]), x)
        inner = torch.relu(sparse(li, h2))
        x = x + sparse(lo, inner)
    x = L.rmsnorm(_norm(params["final_norm"]), x)
    return x @ params["embed"].T


def loss_fn(params, structures, toks, tgt, n_heads, backend=None,
            taps=None):
    logits = forward(params, structures, toks, n_heads, backend, taps)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    return torch.mean(logz - gold)


def sgd_step(params, structures, toks, tgt, n_heads, lr, backend=None):
    """One SGD step in place; returns the loss (a 0-d tensor)."""
    ps = leaves(params)
    loss = loss_fn(params, structures, toks, tgt, n_heads, backend)
    grads = torch.autograd.grad(loss, ps)
    with torch.no_grad():
        for p, g in zip(ps, grads):
            p.sub_(lr * g)
    return loss.detach()


def batch_at(step, batch, seq, vocab, device):
    """The induction task: a stream that repeats with period 8, so the next
    token is visible 8 positions back.  Returns (tokens, targets)."""
    rng = np.random.default_rng([7, step])
    s = rng.integers(0, vocab, (batch, seq + 1))
    s = np.tile(s[:, :8], (1, (seq + 8) // 8 + 1))
    t = torch.as_tensor(s, dtype=torch.long, device=device)
    return t[:, :seq], t[:, 1:seq + 1]


def build_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--d-ff", type=int, default=512)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = build_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params, structures = build(args.d_model, args.d_ff, args.layers,
                               args.vocab, args.sparsity, rng, device=dev)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for li, lo in structures:     # the backward's Wᵀ, built once up front
        for layer in (li, lo):
            layer.fmt.transposed(dtype=torch.float32).fmt.on(dev)
    transpose_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    nnz = sum(p.numel() for name, v in params.items()
              if name.startswith("ffn") for p in v.values())
    print(f"params: {n_params / 1e6:.2f}M  (sparse FFN values: "
          f"{nnz / 1e6:.2f}M at {args.sparsity:.0%} sparsity); plan "
          f"{plan_s:.2f}s, transposed build {transpose_s:.2f}s")

    t0 = time.perf_counter()
    first = loss = None
    losses, step_s = [], []
    for s in range(args.steps):
        ts = time.perf_counter()
        toks, tgt = batch_at(s, args.batch, args.seq, args.vocab, dev)
        loss = float(sgd_step(params, structures, toks, tgt, args.heads,
                              args.lr))
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if first is None:
            first = loss
        if s % max(args.steps // 10, 1) == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {loss:.4f}")
    print(f"{args.steps} steps in {time.perf_counter() - t0:.1f}s; "
          f"loss {first:.3f} -> {loss:.3f}")
    assert loss < first, "did not learn"

    # The kernels' logits against the plain path's on the trained model.
    toks, _ = batch_at(0, args.batch, args.seq, args.vocab, dev)
    with torch.no_grad():
        l_ker = forward(params, structures, toks[:1, :16], args.heads)
        l_ref = forward(params, structures, toks[:1, :16], args.heads,
                        "torch")
    torch.testing.assert_close(l_ker, l_ref, rtol=1e-3, atol=1e-3)
    print("OK: the kernel path's logits match the plain path's")
    return {"losses": losses, "step_s": step_s, "plan_s": plan_s,
            "transpose_s": transpose_s, "n_params": n_params, "nnz": nnz,
            "logits_max_abs_err": float((l_ker - l_ref).abs().max())}


if __name__ == "__main__":
    main()
