"""Public LOOPS SpMM API (paper §3.1 pipeline: partition -> schedule ->
execute).

Port of ``repro/core/spmm.py``.  ``plan_and_convert`` is the host half:
pick the Eq. 2/3 split, solve Eq. 1 for ``r_boundary``, run Algorithm 1 and
upload the panels to the device; with ``tuner=`` (a
:class:`repro_torch.tune.Tuner`) the plan comes from the measured,
fingerprint-keyed plan cache instead.  ``loops_spmm`` executes the hybrid
``C = A @ B``: on the default ``"cuda"`` backend both parts fill disjoint
row ranges of one buffer through the CUDA kernels B1 and B2
(:func:`repro_torch.kernels.engine.loops_spmm_fused`); the ``"torch"``
backend runs the flat PyTorch references (the same entry point's
``"torch"`` link, which an opted-in fallback chain degrades to).
``loops_spmm_values`` is the same product with trainable stored values.

Both are differentiable.  On the ``"cuda"`` backend a
``torch.autograd.Function`` computes ``dB = Aᵀ·dY`` through B1/B2 on the
cached transposed format (``fmt.transposed()``) and, for
``loops_spmm_values``, the gradient at A's stored values through the SDD
kernels B3/B4 (:func:`repro_torch.kernels.engine.loops_sdd`), summed over
batch dims.  The ``"torch"`` backend differentiates natively through the
flat references and is the gradient oracle.

Both entry points run on CUDA unless the caller passes ``device="cpu"``,
and raise without a GPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import engine, ref
from ..kernels.panel_common import default_bn
from . import partition
from .formats import (CSR, DEFAULT_PANEL_G, HALF_PACKED_ROWS, LoopsFormat,
                      SUBLANE_ROWS, loops_from_csr, transposed_values)
from .perf_model import QuadraticPerfModel

__all__ = ["loops_spmm", "loops_spmm_values", "loops_grid_steps",
           "loops_batched_grid_steps", "plan_and_convert", "plan_for",
           "SpmmPlan", "default_br", "spmm_csr_baseline",
           "spmm_dense_baseline"]


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


def plan_for(csr: CSR, *, total_workers: int = 8,
             model: QuadraticPerfModel | None = None,
             tp_vpu: float = 1.0, tp_mxu: float = 4.0,
             br: int | None = None, panel_g: int | None = None,
             paper_literal: bool = False, pipeline_depth: int = 1,
             macro_m: int = 1) -> SpmmPlan:
    """The planning half of :func:`plan_and_convert`: the Eq. 2/3 split and
    the Eq. 1 boundary for ``csr``, without converting it."""
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
    return SpmmPlan(r_boundary=r_b, t_vpu=t_vpu, t_mxu=t_mxu, br=br,
                    panel_g=panel_g, pipeline_depth=pipeline_depth,
                    macro_m=macro_m)


def plan_and_convert(csr: CSR, *, total_workers: int = 8,
                     model: QuadraticPerfModel | None = None,
                     tp_vpu: float = 1.0, tp_mxu: float = 4.0,
                     br: int | None = None, panel_g: int | None = None,
                     paper_literal: bool = False,
                     tuner=None, validate: str | None = "strict",
                     pipeline_depth: int = 1, macro_m: int = 1,
                     device=None) -> tuple[LoopsFormat, SpmmPlan]:
    """Pick (t_vpu, t_mxu) via the perf model, solve Eq. 1, run Algorithm
    1, and upload the panels to ``device`` (``None`` -> CUDA; raises
    without a GPU).

    ``tp_vpu``/``tp_mxu`` are per-worker row throughputs.  With ``model``
    the allocation is the model argmax (Eq. 3); otherwise it is
    proportional to the throughputs.  ``tuner`` (a
    :class:`repro_torch.tune.Tuner`, or anything with ``.tune(csr) ->
    (fmt, plan)``) replaces the model-only path entirely: the plan comes
    from the measured plan cache, so repeated call sites never re-derive
    it.  ``validate`` gates ingestion validation of ``csr``: ``"strict"``
    raises a classified ``SparseInputError``, ``"drop"``/``"clip"``
    repair, ``None`` trusts the caller.
    """
    dev = engine.resolve_device(device)
    if validate is not None:
        from ..resilience.validate import validate_csr
        csr, _ = validate_csr(
            csr, repair=None if validate == "strict" else validate)
    if tuner is not None:
        fmt, plan = tuner.tune(csr)
        fmt.on(dev)
        return fmt, plan
    plan = plan_for(csr, total_workers=total_workers, model=model,
                    tp_vpu=tp_vpu, tp_mxu=tp_mxu, br=br, panel_g=panel_g,
                    paper_literal=paper_literal,
                    pipeline_depth=pipeline_depth, macro_m=macro_m)
    fmt = loops_from_csr(csr, plan.r_boundary, plan.br, panel_g=plan.panel_g,
                         macro_m=macro_m, pipeline_depth=pipeline_depth)
    fmt.on(dev)
    return fmt, plan


def _pick(t, dim, i):
    """Element ``i`` of ``t`` along its mapped ``dim`` (``None``: shared)."""
    return t if dim is None else t.select(dim, i)


class _ZeroProduct(torch.autograd.Function):
    """The all-zero product of an empty matrix or an empty batch, kept on
    the graph: its inputs get gradients of zeros rather than none."""

    @staticmethod
    def forward(shape, dtype, *inputs):
        return torch.zeros(shape, dtype=dtype, device=inputs[-1].device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.specs = [(t.shape, t.dtype, t.device) for t in inputs[2:]]

    @staticmethod
    def backward(ctx, dy):
        return (None, None, *[torch.zeros(s, dtype=d, device=dev)
                              for s, d, dev in ctx.specs])

    @staticmethod
    def vmap(info, in_dims, shape, dtype, *inputs):
        moved = [t if d is None else t.movedim(d, 0)
                 for t, d in zip(inputs, in_dims[2:])]
        return _ZeroProduct.apply((info.batch_size,) + tuple(shape), dtype,
                                  *moved), 0


def _backward_db(fmt: LoopsFormat, dy: torch.Tensor, transpose_plan,
                 csr_vals=None, bcsr_vals=None) -> torch.Tensor:
    """``dB = Aᵀ · dY`` through B1/B2 on the cached transposed format, with
    live values carried across when given.  The cotangent is cast to the
    value dtype first, so the backward products keep the forward kernels'
    precision contract (half operands, fp32 accumulation).  The product
    goes through the forward's autograd Functions, so a backward under
    ``torch.vmap`` folds the mapped cotangents into one call as the
    forward does."""
    vdt = (csr_vals.dtype if csr_vals is not None
           else engine.torch_dtype(fmt.csr_part.vals.dtype))
    tl = fmt.transposed(plan=transpose_plan, dtype=vdt)
    dy = dy.to(vdt)
    if csr_vals is None:
        return _LoopsSpmm.apply(dy, tl.fmt, None, None)
    return _LoopsSpmmValues.apply(*transposed_values(tl, csr_vals, bcsr_vals),
                                  dy, tl.fmt, None, None)


class _LoopsSpmm(torch.autograd.Function):
    """``C = A @ B`` on the panel kernels; backward ``dB`` on Aᵀ.

    Under ``torch.vmap`` over ``b`` the mapped dim moves to the front and
    folds into the kernels' batch: one B1 and one B2 launch for the whole
    batch (the reference's ``custom_vmap`` rule in ``_execute_engine``)."""

    @staticmethod
    def forward(b, fmt, out_dtype, transpose_plan):
        return engine.loops_spmm_fused(fmt, b, out_dtype=out_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        b, ctx.fmt, _, ctx.transpose_plan = inputs
        ctx.b_dtype = b.dtype

    @staticmethod
    def backward(ctx, dy):
        db = _backward_db(ctx.fmt, dy, ctx.transpose_plan)
        return db.to(ctx.b_dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, b, fmt, out_dtype, transpose_plan):
        return _LoopsSpmm.apply(b.movedim(in_dims[0], 0), fmt, out_dtype,
                                transpose_plan), 0


class _LoopsSpmmValues(torch.autograd.Function):
    """``C = A(vals) @ B`` on the panel kernels with live values; backward
    ``dB`` on Aᵀ (B1/B2) and the value gradients on B3/B4.

    Under ``torch.vmap`` a mapped ``b`` with shared values folds into one
    call, as :class:`_LoopsSpmm`; mapped values change the panels per
    element, so the elements run one call each and are stacked (the
    reference's rule)."""

    @staticmethod
    def forward(csr_vals, bcsr_vals, b, fmt, out_dtype, transpose_plan):
        return engine.loops_spmm_fused(fmt, b, out_dtype=out_dtype,
                                       csr_vals=csr_vals,
                                       bcsr_vals=bcsr_vals)

    @staticmethod
    def setup_context(ctx, inputs, output):
        csr_vals, bcsr_vals, b, ctx.fmt, _, ctx.transpose_plan = inputs
        ctx.save_for_backward(csr_vals, bcsr_vals, b)

    @staticmethod
    def backward(ctx, dy):
        cv, bv, b = ctx.saved_tensors
        need_cv, need_bv, need_b = ctx.needs_input_grad[:3]
        d_cv = d_bv = db = None
        if need_b:
            db = _backward_db(ctx.fmt, dy, ctx.transpose_plan,
                              csr_vals=cv, bcsr_vals=bv).to(b.dtype)
        if need_cv or need_bv:
            d_cv, d_bv = _ValueGrad.apply(dy, b, ctx.fmt)
            d_cv, d_bv = d_cv.to(cv.dtype), d_bv.to(bv.dtype)
        return d_cv, d_bv, db, None, None, None

    @staticmethod
    def vmap(info, in_dims, csr_vals, bcsr_vals, b, fmt, out_dtype,
             transpose_plan):
        d_cv, d_bv, d_b = in_dims[:3]
        if d_cv is None and d_bv is None:
            return _LoopsSpmmValues.apply(csr_vals, bcsr_vals,
                                          b.movedim(d_b, 0), fmt, out_dtype,
                                          transpose_plan), 0
        return torch.stack([_LoopsSpmmValues.apply(
            _pick(csr_vals, d_cv, i), _pick(bcsr_vals, d_bv, i),
            _pick(b, d_b, i), fmt, out_dtype, transpose_plan)
            for i in range(info.batch_size)]), 0


class _ValueGrad(torch.autograd.Function):
    """The gradient at A's stored values on B3/B4
    (:func:`repro_torch.kernels.engine.loops_sdd`, summed over ``b``'s batch
    dims).  Under ``torch.vmap`` each element's gradient is its own, so the
    elements run one call each and are stacked."""

    @staticmethod
    def forward(dy, b, fmt):
        return engine.loops_sdd(fmt, dy, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, dy, b, fmt):
        outs = [_ValueGrad.apply(_pick(dy, in_dims[0], i),
                                 _pick(b, in_dims[1], i), fmt)
                for i in range(info.batch_size)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)


def loops_spmm(fmt: LoopsFormat, b, *, device=None,
               backend: str | None = None, out_dtype=None,
               transpose_plan: SpmmPlan | None = None) -> torch.Tensor:
    """Execute the hybrid SpMM ``C = A @ B`` with A in LOOPS format.

    ``b`` has shape ``(..., K, N)`` and the format's value dtype; the
    result is ``(..., nrows, N)`` in the accumulation dtype unless
    ``out_dtype`` is given.  ``b`` must already be on ``device`` (an array
    is copied there); ``device=None`` means CUDA and raises without a GPU.
    Leading batch dims run as one launch per kernel, and so does
    ``torch.vmap`` over ``b``: its rule folds the mapped dim into the same
    batched call (one B1 and one B2 launch), forward and backward.  An
    all-zero matrix or
    an empty batch returns zeros of the full shape; a rank-1 or
    K-mismatched ``b`` raises ``ValueError``.

    The CSR-part rows land in ``C[..., :r_boundary, :]`` and the BCSR-part
    rows after them; each output row is written by exactly one kernel
    (paper §3.4), so there is no atomic and no concatenation.

    Differentiable in ``b``: on the ``"cuda"`` backend the backward runs
    ``dB = Aᵀ·dY`` through the same kernels on ``fmt.transposed()``, whose
    plan ``transpose_plan`` pins (otherwise Aᵀ is planned from its own row
    statistics); ``dB`` comes back in ``b``'s dtype.  A's values are
    constants here; for trainable values use :func:`loops_spmm_values`.
    """
    dev = engine.resolve_device(device)
    b = engine.as_operand(b, dev)
    backend = engine.resolve_backend(backend)
    vdt = engine.torch_dtype(fmt.csr_part.vals.dtype)
    _, out_dt = engine.resolve_dtypes(vdt, out_dtype)
    engine.check_rhs(fmt.ncols, b)
    if b.dtype != vdt:
        raise ValueError(f"dense operand dtype {b.dtype} differs from the "
                         f"format's value dtype {vdt}")
    if fmt.nnz == 0 or any(d == 0 for d in b.shape[:-2]):
        # All-zero matrix or empty batch: zeros of the full shape.
        return _ZeroProduct.apply(b.shape[:-2] + (fmt.nrows, b.shape[-1]),
                                  out_dt, b)
    if backend == "torch":
        return engine.loops_spmm_fused(fmt, b, backend="torch",
                                       out_dtype=out_dtype)
    return _LoopsSpmm.apply(b, fmt, out_dtype, transpose_plan)


def loops_spmm_values(fmt: LoopsFormat, csr_vals, bcsr_vals, b, *,
                      device=None, backend: str | None = None,
                      out_dtype=None,
                      transpose_plan: SpmmPlan | None = None
                      ) -> torch.Tensor:
    """Hybrid SpMM with trainable stored values: ``C = A(vals) @ B``.

    ``csr_vals`` ``(nnz,)`` and ``bcsr_vals`` ``(ntiles, Br)`` are live
    tensors laid out like ``fmt.csr_part.vals`` /
    ``fmt.bcsr_part.tile_vals``, in the dtype of ``b``; the structure in
    ``fmt`` stays fixed and uploaded once.  ``b`` follows the
    ``(..., K, N)`` contract of :func:`loops_spmm`.

    On the ``"cuda"`` backend the backward gives ``dB = Aᵀ·dY`` through
    B1/B2 on the transposed format with the live values carried across,
    and ``d_csr_vals``/``d_bcsr_vals`` through the SDD kernels B3/B4,
    summed over batch dims (the values are shared across the batch);
    ``dY @ Bᵀ`` is never materialised.  Gradients come back in the dtypes
    of their inputs.  As in the reference, the format's own (initial)
    values are not consulted, so an all-zero start still trains.
    """
    dev = engine.resolve_device(device)
    b = engine.as_operand(b, dev)
    csr_vals = engine.as_operand(csr_vals, dev)
    bcsr_vals = engine.as_operand(bcsr_vals, dev)
    backend = engine.resolve_backend(backend)
    _, out_dt = engine.resolve_dtypes(csr_vals.dtype, out_dtype)
    engine.check_rhs(fmt.ncols, b)
    if not b.dtype == csr_vals.dtype == bcsr_vals.dtype:
        raise ValueError(f"values ({csr_vals.dtype}, {bcsr_vals.dtype}) and "
                         f"dense operand ({b.dtype}) must share one dtype")
    if (tuple(csr_vals.shape) != (fmt.csr_part.nnz,)
            or tuple(bcsr_vals.shape) != fmt.bcsr_part.tile_vals.shape):
        raise ValueError(f"values of shapes {tuple(csr_vals.shape)} and "
                         f"{tuple(bcsr_vals.shape)} do not fit the format's "
                         f"({fmt.csr_part.nnz},) and "
                         f"{fmt.bcsr_part.tile_vals.shape}")
    if any(d == 0 for d in b.shape[:-2]):
        return _ZeroProduct.apply(b.shape[:-2] + (fmt.nrows, b.shape[-1]),
                                  out_dt, csr_vals, bcsr_vals, b)
    if backend == "torch":
        return engine.loops_spmm_fused(fmt, b, backend="torch",
                                       out_dtype=out_dtype,
                                       csr_vals=csr_vals, bcsr_vals=bcsr_vals)
    return _LoopsSpmmValues.apply(csr_vals, bcsr_vals, b, fmt, out_dtype,
                                  transpose_plan)


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
