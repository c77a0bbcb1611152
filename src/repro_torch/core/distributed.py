"""Distributed two-level LOOPS SpMM (paper §3.4 + §3.5, scaled out).

Port of ``repro/core/distributed.py`` over ``torch.distributed``, one
process per rank.  Coarse level (paper: disjoint OpenMP thread groups) ->
**disjoint rank groups** along the worker axis of a device mesh: the first
``g`` ranks run the CSR-part kernel B1 on the irregular-row region, the
other ``D - g`` the BCSR-part kernel B2 on the regular-row region.  Fine
level -> each rank's kernel grid over its row chunk.

Row-exclusive outputs keep it synchronisation-free as in the paper: every
global output row belongs to exactly one rank, so the assembled result is a
concatenation (one ``all_gather``), with no atomics and no reduction on C.
The gradient of the replicated dense operand is the one reduction: each
rank's ``Aᵀ_chunk · dY_chunk``, summed over the worker group.

Balance *within* each group is nnz-balanced (not row-balanced) chunking,
the distributed analogue of the paper's row-wise OpenMP partitioning.

Where the reference runs one SPMD program over a ``shard_map`` with the
flat references (``ref.csr_spmm_ref`` / ``ref.bcsr_spmm_ref``) as the body,
each rank here wraps its own chunk as a single-part
:class:`~repro_torch.core.formats.LoopsFormat` (a CSR chunk with
``r_boundary`` equal to its rows, a BCSR chunk with ``r_boundary`` 0) and
runs the port's own :func:`~repro_torch.core.spmm.loops_spmm` on it, so a
CSR-group rank launches B1 and a BCSR-group rank B2; the backward runs
B1/B2 on the chunk's transposed format.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import engine
from .formats import (CSR, LoopsFormat, VectorBCSR, _csr_from_arrays,
                      bcsr_from_csr_rows)
from .perf_model import QuadraticPerfModel

__all__ = ["ShardedLoops", "shard_loops", "shard_loops_auto",
           "distributed_spmm"]


@dataclasses.dataclass(frozen=True)
class ShardedLoops:
    """Rank-stacked LOOPS workload: leading axis = rank along the worker
    axis.  CSR-group ranks carry real CSR chunks and a trivial (single zero
    tile) BCSR chunk; BCSR-group ranks vice versa.

    The first twelve fields are the reference's, array-equal, padding
    included.  The port adds the real entry and tile counts of each rank: a
    padding entry (row 0, column 0, value 0) cannot be told from a stored
    zero, and a CSR chunk needs its entries in row order, which the
    padding after them breaks.  ``panel_g`` is the chunks' panel width (the
    format's effective one)."""

    row_ids: np.ndarray    # (D, nnz_pad) int32 -- local row ids
    col_idx: np.ndarray    # (D, nnz_pad) int32
    vals: np.ndarray       # (D, nnz_pad)
    tile_rows: np.ndarray  # (D, t_pad) int32 -- local block-row ids
    tile_cols: np.ndarray  # (D, t_pad) int32
    tile_vals: np.ndarray  # (D, t_pad, Br)
    row_offset: Tuple[int, ...]  # global first row per rank
    row_count: Tuple[int, ...]   # logical rows per rank
    rows_pad: int                # uniform local output height
    g_vpu: int                   # ranks in the CSR group
    br: int
    shape: Tuple[int, int]
    nnz_count: Tuple[int, ...]   # real CSR entries per rank
    tile_count: Tuple[int, ...]  # real BCSR tiles per rank
    panel_g: int

    def chunk(self, d: int) -> LoopsFormat | None:
        """Rank ``d``'s chunk as a single-part format (``None`` for a rank
        with no rows), built once and cached on this instance, so its
        device panels and transposed format are built once per rank."""
        cache = self.__dict__.setdefault("_chunk_cache", {})
        if d not in cache:
            cache[d] = _chunk_format(self, d)
        return cache[d]


def _empty_csr(ncols: int, dtype) -> CSR:
    return _csr_from_arrays(np.zeros(1, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, dtype), (0, ncols))


def _chunk_format(sh: ShardedLoops, d: int) -> LoopsFormat | None:
    rows, k = sh.row_count[d], sh.shape[1]
    if rows == 0:
        return None
    if d < sh.g_vpu:
        n = sh.nnz_count[d]
        local = sh.row_ids[d, :n]
        row_ptr = np.zeros(rows + 1, np.int32)
        np.cumsum(np.bincount(local, minlength=rows), out=row_ptr[1:])
        csr = _csr_from_arrays(row_ptr, sh.col_idx[d, :n], sh.vals[d, :n],
                               (rows, k))
        return LoopsFormat(csr_part=csr,
                           bcsr_part=bcsr_from_csr_rows(csr, rows, rows,
                                                        sh.br),
                           r_boundary=rows, shape=(rows, k),
                           panel_g=sh.panel_g)
    t = sh.tile_count[d]
    nblocks = (rows + sh.br - 1) // sh.br
    tile_rows = sh.tile_rows[d, :t]
    block_ptr = np.zeros(nblocks + 1, np.int32)
    np.cumsum(np.bincount(tile_rows, minlength=nblocks), out=block_ptr[1:])
    bcsr = VectorBCSR(tile_rows=tile_rows, tile_cols=sh.tile_cols[d, :t],
                      tile_vals=sh.tile_vals[d, :t], block_ptr=block_ptr,
                      br=sh.br, nrows=rows, shape=(rows, k))
    return LoopsFormat(csr_part=_empty_csr(k, sh.vals.dtype), bcsr_part=bcsr,
                       r_boundary=0, shape=(rows, k), panel_g=sh.panel_g)


def _balanced_chunks(weights: np.ndarray, parts: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) unit ranges with ~equal total weight."""
    total = float(weights.sum())
    cum = np.concatenate([[0.0], np.cumsum(weights)])
    bounds = [0]
    for p in range(1, parts):
        target = total * p / parts
        bounds.append(int(np.searchsorted(cum, target)))
    bounds.append(len(weights))
    bounds = np.maximum.accumulate(bounds)
    return [(bounds[i], bounds[i + 1]) for i in range(parts)]


def shard_loops(fmt: LoopsFormat, num_devices: int, g_vpu: int) -> ShardedLoops:
    """Split a LoopsFormat across ``num_devices`` ranks with ``g_vpu``
    CSR-group ranks (paper: t_neon) and the rest BCSR-group (t_sme)."""
    if not 0 <= g_vpu <= num_devices:
        raise ValueError("g_vpu out of range")
    csr, bcsr = fmt.csr_part, fmt.bcsr_part
    g_mxu = num_devices - g_vpu
    dtype = csr.vals.dtype

    # --- CSR group: nnz-balanced contiguous row ranges of the CSR-part.
    row_chunks = []
    if g_vpu:
        counts = np.diff(csr.row_ptr)
        for (r0, r1) in _balanced_chunks(counts.astype(np.float64),
                                         g_vpu):
            row_chunks.append((r0, r1))
    # --- BCSR group: tile-balanced contiguous block-row ranges.
    blk_chunks = []
    if g_mxu:
        bcounts = np.diff(bcsr.block_ptr)
        for (b0, b1) in _balanced_chunks(bcounts.astype(np.float64), g_mxu):
            blk_chunks.append((b0, b1))

    nnz_pad = 1
    for (r0, r1) in row_chunks:
        nnz_pad = max(nnz_pad, int(csr.row_ptr[r1] - csr.row_ptr[r0]), r1 - r0)
    t_pad = 1
    for (b0, b1) in blk_chunks:
        t_pad = max(t_pad, int(bcsr.block_ptr[b1] - bcsr.block_ptr[b0]))

    rows_pad = 1
    for (r0, r1) in row_chunks:
        rows_pad = max(rows_pad, r1 - r0)
    for (b0, b1) in blk_chunks:
        rows_pad = max(rows_pad, (b1 - b0) * bcsr.br)

    D = num_devices
    row_ids = np.zeros((D, nnz_pad), np.int32)
    col_idx = np.zeros((D, nnz_pad), np.int32)
    vals = np.zeros((D, nnz_pad), dtype)
    tile_rows = np.zeros((D, t_pad), np.int32)
    tile_cols = np.zeros((D, t_pad), np.int32)
    tile_vals = np.zeros((D, t_pad, bcsr.br), dtype)
    row_offset, row_count = [], []
    nnz_count, tile_count = [0] * D, [0] * D

    for d, (r0, r1) in enumerate(row_chunks):
        s, e = int(csr.row_ptr[r0]), int(csr.row_ptr[r1])
        row_ids[d, :e - s] = csr.row_ids[s:e] - r0
        # Padding entries keep writing row 0 with val 0 -- harmless.
        col_idx[d, :e - s] = csr.col_idx[s:e]
        vals[d, :e - s] = csr.vals[s:e]
        row_offset.append(r0)
        row_count.append(r1 - r0)
        nnz_count[d] = e - s
    for i, (b0, b1) in enumerate(blk_chunks):
        d = g_vpu + i
        s, e = int(bcsr.block_ptr[b0]), int(bcsr.block_ptr[b1])
        tile_rows[d, :e - s] = bcsr.tile_rows[s:e] - b0
        tile_cols[d, :e - s] = bcsr.tile_cols[s:e]
        tile_vals[d, :e - s] = bcsr.tile_vals[s:e]
        row_offset.append(fmt.r_boundary + b0 * bcsr.br)
        row_count.append(min((b1 - b0) * bcsr.br,
                             bcsr.nrows - b0 * bcsr.br))
        tile_count[d] = e - s

    return ShardedLoops(
        row_ids=row_ids, col_idx=col_idx, vals=vals, tile_rows=tile_rows,
        tile_cols=tile_cols, tile_vals=tile_vals,
        row_offset=tuple(row_offset), row_count=tuple(row_count),
        rows_pad=rows_pad, g_vpu=g_vpu, br=bcsr.br, shape=fmt.shape,
        nnz_count=tuple(nnz_count), tile_count=tuple(tile_count),
        panel_g=fmt.panel_g_eff)


def shard_loops_auto(fmt: LoopsFormat, num_devices: int, *,
                     model: QuadraticPerfModel | None = None,
                     measure: Callable[[int, int], float] | None = None,
                     cache=None, trace_db=None) -> ShardedLoops:
    """Coarse-level scheduling (paper §3.5.3): let the quadratic perf model
    pick the (CSR-group, BCSR-group) *rank* split, then shard.

    Eq. 3's argmax applied one level up from threads: ``x`` ranks run the
    CSR kernel on the irregular region, ``y = D - x`` the BCSR kernel on
    the regular region.  ``model`` is a pre-fitted
    :class:`~repro_torch.core.perf_model.QuadraticPerfModel`; or pass
    ``measure(x, y) -> perf`` to calibrate one from warm-up probes.  With
    neither, the split falls back to proportional nnz weight -- the same
    default as ``plan_and_convert``'s thread-level path.

    ``cache`` -- a :class:`repro_torch.tune.PlanCache` -- is consulted
    *before* solving Eq. 3: a structurally matching split recorded for this
    ``num_devices`` (backend ``dist{D}``, near distance 0.25) is reused;
    otherwise the solved split is stored for the next caller.

    ``trace_db`` -- a :class:`repro_torch.perf.replay.TraceDB` -- supplies
    the model when neither ``model`` nor ``measure`` is given (Eq. 2 refit
    from the traces); an underdetermined database falls back to the nnz
    split silently.  Both regions non-empty need ``num_devices >= 2``.
    """
    has_csr = fmt.r_boundary > 0
    has_bcsr = fmt.r_boundary < fmt.nrows
    if num_devices < 2 and has_csr and has_bcsr:
        # one rank cannot host two disjoint groups; the single-device
        # hybrid path is core.spmm.loops_spmm
        raise ValueError("shard_loops_auto needs >= 2 devices when both the "
                         "CSR and BCSR regions are non-empty; use "
                         "loops_spmm for single-device execution")
    key = fp = None
    if cache is not None:
        from ..tune.fingerprint import cache_key, loops_fingerprint
        fp = loops_fingerprint(fmt)
        dt = np.dtype(fmt.csr_part.vals.dtype)
        key = cache_key(fp, n_cols=0, dtype=dt,
                        backend=f"dist{num_devices}")
        rec = cache.lookup(key, features=fp.features(), dtype=dt.name,
                           n_cols=0, backend=f"dist{num_devices}",
                           max_distance=0.25)
        if rec is not None:
            g_vpu = int(rec["plan"]["t_vpu"])
            g_vpu = int(np.clip(g_vpu, 1 if has_csr else 0,
                                num_devices - 1 if has_bcsr
                                else num_devices))
            return shard_loops(fmt, num_devices, g_vpu)
    if model is None and measure is not None:
        from .perf_model import calibrate
        model = calibrate(measure, num_devices)
    if model is None and trace_db is not None:
        model = trace_db.cost_model()   # None when underdetermined
    if model is not None:
        # best_allocation may leave ranks idle (x + y < D); only the ratio
        # matters here, every rank gets a chunk of its group's work
        g_vpu, _ = model.best_allocation(num_devices)
    else:
        nnz_csr = int(np.count_nonzero(fmt.csr_part.vals))
        nnz_b = int(np.count_nonzero(fmt.bcsr_part.tile_vals))
        total = max(nnz_csr + nnz_b, 1)
        g_vpu = int(round(num_devices * nnz_csr / total))
    if has_csr:
        g_vpu = max(g_vpu, 1)
    if has_bcsr:
        g_vpu = min(g_vpu, num_devices - 1)
    g_vpu = int(np.clip(g_vpu, 0, num_devices))
    if cache is not None and key is not None:
        from ..tune.api import make_record
        cache.put(key, make_record(
            fp.features(), dtype=fmt.csr_part.vals.dtype, n_cols=0,
            backend=f"dist{num_devices}",
            r_frac=fmt.r_boundary / max(fmt.nrows, 1),
            t_vpu=g_vpu, t_mxu=num_devices - g_vpu,
            br=fmt.bcsr_part.br, panel_g=fmt.panel_g))
    return shard_loops(fmt, num_devices, g_vpu)


def distributed_spmm(sharded: ShardedLoops, b, mesh, axis="model",
                     assemble: bool = True, *, device=None):
    """Run the two-level schedule on ``mesh``'s worker ``axis``; every rank
    calls it with the same ``sharded`` and ``b`` and gets the global C.

    ``axis`` is a mesh axis name or a tuple of names (flattened in mesh
    order into one worker axis).  ``b`` follows the batched contract
    ``(..., K, N)``: each rank runs one call per part whatever the batch.
    The result is ``(..., M, N)`` assembled (every rank holds all of it),
    or, with ``assemble=False``, no collective: a ``DTensor`` sharded
    ``Shard(0)`` on the worker mesh with global shape ``(D, ...,
    rows_pad, N)``, each rank's local shard its own padded rows.

    Differentiable in ``b``: each rank computes ``Aᵀ_chunk · dY_chunk``
    over its exclusive rows (B1/B2 on the chunk's transposed format, batch
    dims carried through) and :func:`repro_torch.dist.step.
    loops_cotangent_psum` sums the partials over the worker group, so every
    rank holds the same ``dB``, replicated like the operand.

    ``b`` must be on ``device`` (``None`` means CUDA and raises without a
    GPU), the mesh's device type.
    """
    from torch.distributed.tensor import DTensor

    from ..dist.sharding import loops_out_spec, worker_mesh
    dev = engine.resolve_device(device)
    b = engine.as_operand(b, dev)
    engine.check_rhs(sharded.shape[1], b)
    # checked here, the same on every rank: a rank whose chunk is empty
    # launches nothing that would raise, and its peers would wait for it
    if b.dtype != engine.torch_dtype(sharded.vals.dtype):
        raise ValueError(f"dense operand dtype {b.dtype} differs from the "
                         f"workload's value dtype {sharded.vals.dtype}")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the call runs "
                         f"on {dev}")
    wm = worker_mesh(mesh, axis)
    if wm.size() != len(sharded.row_count):
        raise ValueError(f"the workload is split {len(sharded.row_count)} "
                         f"ways, the worker axis {axis!r} has {wm.size()} "
                         "ranks")
    out = _DistributedSpmm.apply(b, sharded, mesh, axis, assemble)
    if assemble:
        return out
    shape = torch.Size((wm.size(),) + tuple(out.shape[1:]))
    return DTensor.from_local(out, wm, [loops_out_spec(axis)],
                              run_check=False, shape=shape,
                              stride=out.stride())


def _local_product(sharded: ShardedLoops, d: int, b: torch.Tensor
                   ) -> torch.Tensor:
    """Rank ``d``'s rows of ``A @ b``, zero-padded to ``rows_pad``."""
    from .spmm import loops_spmm
    chunk = sharded.chunk(d)
    if chunk is None:
        _, acc = engine.resolve_dtypes(b.dtype, None)
        return b.new_zeros(b.shape[:-2] + (sharded.rows_pad, b.shape[-1]),
                           dtype=acc)
    y = loops_spmm(chunk, b, device=b.device)
    return torch.nn.functional.pad(y, (0, 0, 0, sharded.rows_pad - chunk.nrows))


class _DistributedSpmm(torch.autograd.Function):
    """The forward of :func:`distributed_spmm` (the local product, then the
    ``all_gather`` when assembling) and its backward, ``dB``."""

    @staticmethod
    def forward(b, sharded, mesh, axis, assemble):
        from ..dist.sharding import worker_mesh
        wm = worker_mesh(mesh, axis)
        y = _local_product(sharded, wm.get_local_rank(), b)
        if not assemble:
            return y.unsqueeze(0)
        pieces = [y]
        if wm.size() > 1:
            pieces = [torch.empty_like(y) for _ in range(wm.size())]
            dist.all_gather(pieces, y.contiguous(), group=wm.get_group())
        return torch.cat([p[..., :c, :] for p, c in
                          zip(pieces, sharded.row_count) if c > 0], dim=-2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        b, ctx.sharded, ctx.mesh, ctx.axis, ctx.assemble = inputs
        ctx.b_dtype, ctx.b_shape = b.dtype, b.shape

    @staticmethod
    def backward(ctx, dy):
        from ..dist.sharding import worker_mesh
        from ..dist.step import loops_cotangent_psum
        from .spmm import _backward_db
        sh = ctx.sharded
        d = worker_mesh(ctx.mesh, ctx.axis).get_local_rank()
        o, c = sh.row_offset[d], sh.row_count[d]
        # The rank's exclusive rows of the cotangent: a slice of the
        # assembled dY (the same on every rank), or its own shard.
        dyl = dy[..., o:o + c, :] if ctx.assemble else dy[0][..., :c, :]
        chunk = sh.chunk(d)
        if chunk is None:
            _, acc = engine.resolve_dtypes(ctx.b_dtype, None)
            db = dy.new_zeros(ctx.b_shape, dtype=acc)
        else:
            db = _backward_db(chunk, dyl, None)
        db = loops_cotangent_psum(db.contiguous(), ctx.mesh, ctx.axis)
        return db.to(ctx.b_dtype), None, None, None, None
