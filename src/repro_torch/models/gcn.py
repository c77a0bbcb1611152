"""The paper's §4.5 consumer: a 2-layer GCN whose neighbourhood aggregation
runs through the LOOPS SpMM.

``examples/gcn_train.py``'s model, ``logits = Â · relu(Â · X · W0) · W1``,
as an ``nn.Module``: both aggregations go through
:func:`repro_torch.core.loops_spmm` (the CUDA kernels on a GPU, forward and
backward), and ``X · W`` stays ``torch.matmul``, as the reference leaves it
to XLA.  :func:`gcn_loss` and :func:`sgd_step` are the example's loss and
plain SGD update; no dense adjacency appears in either.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..core.formats import LoopsFormat
from ..core.spmm import loops_spmm
from ..kernels.engine import resolve_device

__all__ = ["GCN", "gcn_params_from_numpy", "gcn_loss", "sgd_step"]


class GCN(nn.Module):
    """Two-layer GCN over a fixed normalised adjacency ``adj`` (LOOPS
    format, ``(nodes, nodes)``); ``w0`` is ``(F_in, F_hid)`` and ``w1``
    ``(F_hid, F_out)``, both trainable.  ``backend`` is the SpMM backend of
    both aggregations (``None``: the CUDA kernels; ``"torch"``: the flat
    references, the gradient oracle)."""

    def __init__(self, adj: LoopsFormat, w0: torch.Tensor, w1: torch.Tensor,
                 *, backend: str | None = None):
        super().__init__()
        self.adj = adj
        self.backend = backend
        self.w0 = nn.Parameter(w0)
        self.w1 = nn.Parameter(w1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(nodes, F_in)`` features -> ``(nodes, F_out)`` logits."""
        h = torch.relu(loops_spmm(self.adj, x @ self.w0, device=x.device,
                                  backend=self.backend))
        return loops_spmm(self.adj, h @ self.w1, device=x.device,
                          backend=self.backend)


def gcn_params_from_numpy(params: Mapping[str, np.ndarray], *,
                          device=None) -> Dict[str, torch.Tensor]:
    """The reference's ``{"w0", "w1"}`` numpy weights as tensors on
    ``device`` (``None`` -> CUDA), in their own dtype; copies, so training
    never writes into the caller's arrays."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k]), device=dev)
            for k in ("w0", "w1")}


def gcn_loss(model: GCN, x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, accuracy)``: the mean over nodes of ``logsumexp(logits) -
    logits[gold]`` for integer labels ``y``, and the share of nodes whose
    argmax is the label."""
    logits = model(x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[:, None].long())[:, 0]
    acc = (logits.argmax(-1) == y).float().mean()
    return (logz - gold).mean(), acc


def sgd_step(model: GCN, x: torch.Tensor, y: torch.Tensor, lr: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of plain SGD, ``w <- w - lr * dloss/dw``, on every
    parameter; returns the step's ``(loss, accuracy)`` (before the
    update)."""
    params = list(model.parameters())
    loss, acc = gcn_loss(model, x, y)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return loss.detach(), acc
