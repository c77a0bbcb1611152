"""The paper's §4.5 consumer: a 2-layer GCN whose neighbourhood aggregation
runs through the LOOPS SpMM.

Forward of ``examples/gcn_train.py``'s model,
``logits = Â · relu(Â · X · W0) · W1``, as an ``nn.Module`` for serving:
both aggregations go through :func:`repro_torch.core.loops_spmm` (the CUDA
kernels on a GPU), and ``X · W`` stays ``torch.matmul``, as the reference
leaves it to XLA.  The weights are frozen until autograd through
``loops_spmm`` is ported.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..core.formats import LoopsFormat
from ..core.spmm import loops_spmm
from ..kernels.engine import resolve_device

__all__ = ["GCN", "gcn_params_from_numpy"]


class GCN(nn.Module):
    """Two-layer GCN over a fixed normalised adjacency ``adj`` (LOOPS
    format, ``(nodes, nodes)``); ``w0`` is ``(F_in, F_hid)`` and ``w1``
    ``(F_hid, F_out)``."""

    def __init__(self, adj: LoopsFormat, w0: torch.Tensor, w1: torch.Tensor):
        super().__init__()
        self.adj = adj
        self.w0 = nn.Parameter(w0, requires_grad=False)
        self.w1 = nn.Parameter(w1, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(nodes, F_in)`` features -> ``(nodes, F_out)`` logits."""
        h = torch.relu(loops_spmm(self.adj, x @ self.w0, device=x.device))
        return loops_spmm(self.adj, h @ self.w1, device=x.device)


def gcn_params_from_numpy(params: Mapping[str, np.ndarray], *,
                          device=None) -> Dict[str, torch.Tensor]:
    """The reference's ``{"w0", "w1"}`` numpy weights as tensors on
    ``device`` (``None`` -> CUDA), in their own dtype."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(params[k])).to(dev)
            for k in ("w0", "w1")}
