"""Public LOOPS SpMM API (paper §3.1 pipeline: partition -> schedule ->
execute), forward path.

Port of ``repro/core/spmm.py``.  ``plan_and_convert`` is the host half:
pick the Eq. 2/3 split, solve Eq. 1 for ``r_boundary``, run Algorithm 1 and
upload the panels to the device.  ``loops_spmm`` executes the hybrid
``C = A @ B``: on the default ``"cuda"`` backend both parts fill disjoint
row ranges of one buffer through the CUDA kernels B1 and B2
(:func:`repro_torch.kernels.engine.loops_spmm_fused`); the ``"torch"``
backend runs the flat PyTorch references.

Both entry points run on CUDA unless the caller passes ``device="cpu"``,
and raise without a GPU.  Autograd through ``loops_spmm`` is not ported
yet: a call that would need a gradient raises ``NotImplementedError``
instead of silently cutting the graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import engine, ref
from ..kernels.panel_common import default_bn
from . import partition
from .formats import (CSR, DEFAULT_PANEL_G, HALF_PACKED_ROWS, LoopsFormat,
                      SUBLANE_ROWS, loops_from_csr)
from .perf_model import QuadraticPerfModel

__all__ = ["loops_spmm", "loops_grid_steps", "loops_batched_grid_steps",
           "plan_and_convert", "SpmmPlan", "default_br",
           "spmm_csr_baseline", "spmm_dense_baseline"]


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Resolved execution plan for one sparse matrix (paper Fig. 1)."""

    r_boundary: int
    t_vpu: int      # paper: t_neon, workers for the CSR part
    t_mxu: int      # paper: t_sme, workers for the BCSR part
    br: int         # tile height (cntd / cntf / cnth analogue)
    panel_g: int = DEFAULT_PANEL_G  # panel width (Fig. 2 multi-tile count)
    pipeline_depth: int = 1  # reference kernel pipeline depth (structural)
    macro_m: int = 1         # same-row panels fused per panel


def default_br(dtype) -> int:
    """Tile height: 16 for half precision (bf16, f16), 8 otherwise (the
    reference's ``HALF_PACKED_ROWS`` / ``SUBLANE_ROWS``)."""
    if engine.torch_dtype(dtype) in (torch.bfloat16, torch.float16):
        return HALF_PACKED_ROWS
    return SUBLANE_ROWS


def plan_and_convert(csr: CSR, *, total_workers: int = 8,
                     model: QuadraticPerfModel | None = None,
                     tp_vpu: float = 1.0, tp_mxu: float = 4.0,
                     br: int | None = None, panel_g: int | None = None,
                     paper_literal: bool = False,
                     validate: str | None = "strict",
                     pipeline_depth: int = 1, macro_m: int = 1,
                     device=None) -> tuple[LoopsFormat, SpmmPlan]:
    """Pick (t_vpu, t_mxu) via the perf model, solve Eq. 1, run Algorithm
    1, and upload the panels to ``device`` (``None`` -> CUDA; raises
    without a GPU).

    ``tp_vpu``/``tp_mxu`` are per-worker row throughputs.  With ``model``
    the allocation is the model argmax (Eq. 3); otherwise it is
    proportional to the throughputs.  ``validate`` gates ingestion
    validation of ``csr``: ``"strict"`` raises a classified
    ``SparseInputError``, ``"drop"``/``"clip"`` repair, ``None`` trusts the
    caller.
    """
    dev = engine.resolve_device(device)
    if validate is not None:
        from ..resilience.validate import validate_csr
        csr, _ = validate_csr(
            csr, repair=None if validate == "strict" else validate)
    br = br or default_br(csr.vals.dtype)
    panel_g = panel_g or DEFAULT_PANEL_G
    if model is not None:
        t_vpu, t_mxu = model.best_allocation(total_workers)
    else:
        t_mxu = max(int(round(total_workers * tp_mxu / (tp_vpu + tp_mxu))), 1)
        t_vpu = max(total_workers - t_mxu, 1)
    r_b = partition.choose_r_boundary(
        csr.nrows, tp_vpu, tp_mxu, t_vpu, t_mxu, br=br,
        paper_literal=paper_literal)
    fmt = loops_from_csr(csr, r_b, br, panel_g=panel_g,
                         macro_m=macro_m, pipeline_depth=pipeline_depth)
    fmt.on(dev)
    return fmt, SpmmPlan(
        r_boundary=r_b, t_vpu=t_vpu, t_mxu=t_mxu, br=br, panel_g=panel_g,
        pipeline_depth=pipeline_depth, macro_m=macro_m)


def loops_spmm(fmt: LoopsFormat, b, *, device=None,
               backend: str | None = None, out_dtype=None) -> torch.Tensor:
    """Execute the hybrid SpMM ``C = A @ B`` with A in LOOPS format.

    ``b`` has shape ``(..., K, N)`` and the format's value dtype; the
    result is ``(..., nrows, N)`` in the accumulation dtype unless
    ``out_dtype`` is given.  ``b`` must already be on ``device`` (an array
    is copied there); ``device=None`` means CUDA and raises without a GPU.
    Leading batch dims run as one launch per kernel.  An all-zero matrix or
    an empty batch returns zeros of the full shape; a rank-1 or
    K-mismatched ``b`` raises ``ValueError``.

    The CSR-part rows land in ``C[..., :r_boundary, :]`` and the BCSR-part
    rows after them; each output row is written by exactly one kernel
    (paper §3.4), so there is no atomic and no concatenation.
    """
    dev = engine.resolve_device(device)
    b = engine.as_operand(b, dev)
    backend = engine.resolve_backend(backend)
    if torch.is_grad_enabled() and b.requires_grad:
        raise NotImplementedError(
            "loops_spmm has no autograd rule yet; call it under "
            "torch.no_grad() or on an operand that needs no gradient")
    vdt = engine.torch_dtype(fmt.csr_part.vals.dtype)
    _, out_dt = engine.resolve_dtypes(vdt, out_dtype)
    engine.check_rhs(fmt.ncols, b)
    if b.dtype != vdt:
        raise ValueError(f"dense operand dtype {b.dtype} differs from the "
                         f"format's value dtype {vdt}")
    if fmt.nnz == 0 or any(d == 0 for d in b.shape[:-2]):
        # All-zero matrix or empty batch: zeros of the full shape.
        return torch.zeros(b.shape[:-2] + (fmt.nrows, b.shape[-1]),
                           dtype=out_dt, device=dev)
    if backend == "cuda":
        return engine.loops_spmm_fused(fmt, b, out_dtype=out_dtype)
    parts = []
    if fmt.r_boundary > 0:
        parts.append(engine.csr_spmm(fmt.csr_part, b, backend=backend,
                                     out_dtype=out_dtype))
    if fmt.r_boundary < fmt.nrows:
        parts.append(engine.bcsr_spmm(fmt.bcsr_part, b, backend=backend,
                                      out_dtype=out_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def loops_grid_steps(fmt: LoopsFormat, n_cols: int,
                     bn: int | None = None) -> int:
    """The reference's total Pallas grid steps to execute ``fmt`` against a
    (K, n_cols) operand: its hardware-independent cost proxy, reproduced
    exactly ((panels at ``panel_g_eff`` + depth - 1) x column blocks per
    executed part)."""
    bn = bn or default_bn(n_cols)
    col_blocks = -(-n_cols // bn)
    depth = max(int(fmt.pipeline_depth), 1)
    p_csr = fmt.csr_panels.npanels
    p_bcsr = fmt.bcsr_panels.npanels
    if fmt.r_boundary == 0:
        p_csr = 0
    if fmt.r_boundary == fmt.nrows:
        p_bcsr = 0
    steps = 0
    for p in (p_csr, p_bcsr):
        if p > 0:
            steps += (p + depth - 1) * col_blocks
    return steps


def loops_batched_grid_steps(fmt: LoopsFormat, batch, n_cols: int,
                             bn: int | None = None) -> int:
    """The reference's grid steps of one batched call against a
    ``(*batch, K, n_cols)`` operand (``ceil(batch / bz)`` times the
    single-element count, after its batch padding)."""
    b = int(np.prod(batch)) if np.ndim(batch) else int(batch)
    if b == 0:
        return 0
    bp = engine.padded_batch(b)
    return (bp // engine.batch_block(bp)) * loops_grid_steps(fmt, n_cols, bn)


# ---------------------------------------------------------------------------
# Baselines the paper compares against
# ---------------------------------------------------------------------------

def spmm_csr_baseline(csr: CSR, b: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """Row-wise CSR schedule (the flat reference) on ``b``'s device."""
    def put(a):
        return torch.as_tensor(a).to(b.device)
    return ref.csr_spmm_ref(put(csr.row_ids), put(csr.col_idx),
                            put(csr.vals), b, csr.nrows, out_dtype=out_dtype)


def spmm_dense_baseline(a_dense: np.ndarray, b: torch.Tensor,
                        out_dtype=None) -> torch.Tensor:
    """Dense GEMM on the densified operand, on ``b``'s device."""
    return ref.dense_spmm(torch.as_tensor(a_dense).to(b.device), b,
                          out_dtype=out_dtype)
