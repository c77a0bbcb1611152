"""B3 and B4: the sampled dense-dense (SDD) panel kernels, the
value-gradient half of LOOPS training.

For ``Y = A @ B`` with A sparse, the gradient at A's stored values is
``dY @ Bᵀ`` sampled at the stored coordinates, summed over the batch (the
values are shared across it).  Both kernels walk the forward panels:

  * B3, ``csr_sdd_panels`` (``csrc/csr_sdd.cu``, replaces the TPU kernel
    ``repro/kernels/spmm_sdd.py::csr_sdd_panels_pallas``)::

        out[p, i] = sum_z sum_n dY[z, rows[p], n] * B[z, cols[p, i], n]

    It walks the part's block table (:func:`sdd_block_table`), one CTA a
    block: a staged block (rows x a band of columns they share) stages its
    distinct B rows in shared memory once, a direct block (a range of
    panels without shared columns, such as a hub row's) gathers them.

  * B4, ``bcsr_sdd_panels`` (``csrc/bcsr_sdd.cu``, replaces
    ``repro/kernels/spmm_sdd.py::bcsr_sdd_panels_pallas``)::

        out[p, r, i] = sum_z sum_n dY[z, row_offset + rows[p]*Br + r, n]
                                   * B[z, cols[p, i], n]

    where a row ``rows[p]*Br + r >= nrows`` reads as zero, so the kernel
    takes the whole cotangent with the BCSR part's row offset instead of
    the reference's zero-padded copy of its BCSR rows.  It walks the
    block-rows' work units (:func:`sdd_unit_table`, the forward's B2 table),
    one CTA a unit: the unit's panels share one dY slab, staged once.

Masked (padding) lanes are written as exactly 0 by the kernels and by the
plain versions, so whole panel arrays compare; callers read the real slots
through ``gather_values``.  Outputs are in the accumulation dtype of ``B``
(fp32 for bf16/f16, else B's own).  ``dY`` has B's dtype or, as in the
training backward, the accumulation dtype.

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU tensor
they run :func:`csr_sdd_panels_plain` / :func:`bcsr_sdd_panels_plain`, the
same panel functions in plain PyTorch.  ``.launches`` counts kernel
launches only.  Each launch is an operator,
``torch.ops.repro_torch.csr_sdd_panels`` / ``bcsr_sdd_panels``
(``kernels/_ops.py``), whose tables are tensor inputs: on ``meta`` or
fake tensors the wrappers run their checks and the operators' shape
functions, and the tables are the caller's (they are built on the host).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build, _ops
from .bcsr_spmm import UNIT_PANELS
from .csr_spmm import (_PLAIN_CHUNK, UnitTable, _check_device, _lanes,
                       _units_for)
from .engine import acc_dtype_for, register_kernel

__all__ = ["csr_sdd_panels", "bcsr_sdd_panels", "csr_sdd_panels_plain",
           "bcsr_sdd_panels_plain", "sdd_unit_table", "sdd_block_table",
           "SddBlockTable", "KERNEL_BRS"]

# Tile heights B4 is instantiated for.
KERNEL_BRS = (4, 8, 16)

# B3's block table (csrc/csr_sdd.cu's note), chosen on the H100 with
# kernel_sweep.py b3 (PERF.md).  A row group holds BLOCK_ROWS consecutive
# rows; it is staged when its stored values are at least BLOCK_REUSE times
# its distinct columns, and its columns are then cut into bands of at most
# BLOCK_OUTS outputs and BLOCK_COLS distinct columns (the staged B rows).
# The other groups' panels are cut into direct blocks of at most
# DIRECT_OUTS panel slots.  BLOCK_OUTS and DIRECT_OUTS are the outputs the
# kernels' CTAs keep at once (kThreads / 8 x kOuts, kDirectThreads / 8 x
# kDirectOuts).
BLOCK_ROWS = 64
BLOCK_OUTS = 1024
BLOCK_COLS = 256
DIRECT_OUTS = 128
BLOCK_REUSE = 2.0
# Block kinds (csrc/csr_sdd.cu).
STAGED, DIRECT = 0, 1


def _pair(dy: torch.Tensor, b: torch.Tensor):
    """``(dy3, b3)``: both operands as (batch, rows, N)."""
    if dy.ndim != b.ndim or b.ndim not in (2, 3):
        raise ValueError(f"dy/b must both be rank 2 or 3; got {dy.ndim} / "
                         f"{b.ndim}")
    if dy.shape[-1] != b.shape[-1] or dy.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"dy {tuple(dy.shape)} and b {tuple(b.shape)} "
                         "disagree in batch or N")
    return ((dy.unsqueeze(0), b.unsqueeze(0)) if b.ndim == 2
            else (dy, b))


@dataclasses.dataclass(frozen=True)
class SddBlockTable:
    """A CSR part's panel slots cut into the blocks B3 walks, one CTA a
    block; every slot ``p * G + i`` of the ``(P, G)`` layout lies in
    exactly one block.

    ``blocks`` is ``(nblocks, 8)`` int64, one row a block:

      * staged: ``(STAGED, first, count, col0, ncols, row0, nrows, 0)``.
        Its outputs are ``outs[first:first + count]`` (flat panel slots, in
        (row, column) order); ``info`` at the same index is
        ``(row - row0) << 16 | slot``, the output's dY row in the block and
        the slot of its column in ``cols[col0:col0 + ncols]`` (the block's
        sorted distinct columns, the B rows it stages), or -1 at a masked
        lane.  The block stages dY rows ``row0 .. row0 + nrows - 1``.
      * direct: ``(DIRECT, first, count, 0, 0, 0, 0, 0)``: the flat slots
        ``first .. first + count - 1``, whole panels.

    The staged blocks come first (the kernel launches one grid for each
    kind), each kind in order of decreasing ``count``.  ``max_rows`` and
    ``max_cols`` are the most dY rows and distinct columns of a staged
    block (they size the kernel's shared memory).
    """

    blocks: torch.Tensor
    outs: torch.Tensor
    info: torch.Tensor
    cols: torch.Tensor
    npanels: int
    g: int
    nstaged: int
    ndirect: int
    max_rows: int
    max_cols: int

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])


def sdd_block_table(panel_rows, panel_cols, panel_mask, *,
                    block_rows: int = BLOCK_ROWS,
                    block_outs: int = BLOCK_OUTS,
                    block_cols: int = BLOCK_COLS,
                    direct_outs: int = DIRECT_OUTS,
                    reuse: float = BLOCK_REUSE) -> SddBlockTable:
    """The :class:`SddBlockTable` of a CSR part's panels (``panel_rows``
    nondecreasing), built on the host with numpy and placed on
    ``panel_cols``' device.

    Rows ``r`` with the same ``r // block_rows`` form a row group.  A group
    whose live lanes number at least ``reuse`` times its distinct columns
    is staged: its (column, count) pairs in column order, plus one pair
    after them for its masked lanes, are cut greedily into bands of at most
    ``block_outs`` outputs and ``block_cols`` pairs (a band is one pair if
    that pair alone is over the cap), one block a band.  The other groups'
    panels, runs of consecutive groups taken together, are cut into direct
    blocks of ``max(G, direct_outs // G * G)`` slots.
    """
    if min(block_rows, block_outs, block_cols, direct_outs) < 1 \
            or block_rows >= 1 << 15 or block_cols >= 1 << 16:
        raise ValueError("block caps must be positive, block_rows < 2**15 "
                         "and block_cols < 2**16")
    device = panel_cols.device
    rows = np.asarray(panel_rows.cpu(), np.int64)
    cols = np.asarray(panel_cols.cpu(), np.int64)
    npanels, g = cols.shape
    if npanels * g >= 1 << 31:
        raise ValueError(f"{npanels} x {g} panel slots do not fit int32")
    if npanels and np.any(np.diff(rows) < 0):
        raise ValueError("panel_rows must be nondecreasing")
    live = np.asarray(panel_mask.cpu() != 0).reshape(-1)
    flat_col = cols.reshape(-1)
    # Row groups: contiguous panel ranges.
    gkey = rows // block_rows
    gfirst = np.flatnonzero(np.r_[True, gkey[1:] != gkey[:-1]]) \
        if npanels else np.zeros(0, np.int64)
    gend = np.r_[gfirst[1:], npanels].astype(np.int64)
    ngroups = gfirst.size
    pgroup = np.repeat(np.arange(ngroups), gend - gfirst)
    fgroup = np.repeat(pgroup, g)
    frow = np.repeat(rows, g)
    sentinel = int(flat_col.max()) + 1 if flat_col.size else 0
    key = fgroup * (sentinel + 1) + np.where(live, flat_col, sentinel)
    lkeys = np.unique(key[live])
    nlive = np.bincount(fgroup[live], minlength=ngroups)
    ndistinct = np.bincount(lkeys // (sentinel + 1), minlength=ngroups)
    staged = (ndistinct > 0) & (nlive >= reuse * ndistinct)

    # Staged groups: their (group, column) pairs, cut into bands.
    sel = np.flatnonzero(staged[fgroup])
    pairs, pinv, pcount = np.unique(key[sel], return_inverse=True,
                                    return_counts=True)
    pgrp = pairs // (sentinel + 1)
    sgroups = np.flatnonzero(staged)
    pstart = np.searchsorted(pgrp, sgroups, "left")
    pend = np.searchsorted(pgrp, sgroups, "right")
    cum = np.cumsum(pcount)
    before = cum - pcount
    pos, band_start, band_group = pstart.copy(), [], []
    while True:
        act = np.flatnonzero(pos < pend)
        if not act.size:
            break
        p = pos[act]
        end = np.minimum.reduce([
            np.searchsorted(cum, before[p] + block_outs, "right"),
            p + block_cols, pend[act]])
        band_start.append(p)
        band_group.append(sgroups[act])
        pos[act] = np.maximum(end, p + 1)
    none = [np.zeros(0, np.int64)]
    bstart = np.concatenate(band_start + none)
    order = np.argsort(bstart, kind="stable")
    bstart = bstart[order]
    bgroup = np.concatenate(band_group + none)[order]
    bend = np.r_[bstart[1:], pairs.size].astype(np.int64)
    pblock = np.repeat(np.arange(bstart.size), bend - bstart)
    is_dead = pairs % (sentinel + 1) == sentinel
    nreal = np.add.reduceat((~is_dead).astype(np.int64), bstart) \
        if bstart.size else np.zeros(0, np.int64)
    col0 = np.cumsum(nreal) - nreal
    row0 = rows[gfirst[bgroup]]
    nrows = rows[gend[bgroup] - 1] - row0 + 1
    # Staged outputs, by block, then row, then column.
    oblock = pblock[pinv]
    oslot = pinv - bstart[oblock]
    orow = frow[sel]
    oorder = np.lexsort((key[sel], orow, oblock))
    outs = sel[oorder]
    info = np.where(live[sel], (orow - row0[oblock]) << 16 | oslot, -1)[oorder]
    ocount = np.bincount(oblock, minlength=bstart.size)
    ofirst = np.cumsum(ocount) - ocount
    staged_rows = np.stack(
        [np.full(bstart.size, STAGED), ofirst, ocount, col0, nreal, row0,
         nrows, np.zeros(bstart.size, np.int64)], axis=1)

    # Direct groups: runs of consecutive groups, cut at panel boundaries.
    dg = np.flatnonzero(~staged)
    run = np.flatnonzero(np.r_[True, np.diff(dg) > 1]) if dg.size \
        else np.zeros(0, np.int64)
    rstart = gfirst[dg[run]] * g
    rend = gend[dg[np.r_[run[1:] - 1, dg.size - 1]]] * g if dg.size \
        else np.zeros(0, np.int64)
    step = max(g, direct_outs // max(g, 1) * g)
    nchunk = -(-(rend - rstart) // step)
    cfirst = np.repeat(rstart, nchunk) + step * (
        np.arange(nchunk.sum()) - np.repeat(np.cumsum(nchunk) - nchunk,
                                            nchunk))
    ccount = np.minimum(step, np.repeat(rend, nchunk) - cfirst)
    direct_rows = np.zeros((cfirst.size, 8), np.int64)
    direct_rows[:, 0], direct_rows[:, 1], direct_rows[:, 2] = (
        DIRECT, cfirst, ccount)

    table = np.concatenate([
        rows_[np.argsort(-rows_[:, 2], kind="stable")]
        for rows_ in (staged_rows.reshape(-1, 8), direct_rows)])
    dcols = pairs[~is_dead] % (sentinel + 1)
    return SddBlockTable(
        blocks=torch.from_numpy(np.ascontiguousarray(table)).to(device),
        outs=torch.from_numpy(outs.astype(np.int32)).to(device),
        info=torch.from_numpy(info.astype(np.int32)).to(device),
        cols=torch.from_numpy(dcols.astype(np.int32)).to(device),
        npanels=int(npanels), g=int(g), nstaged=int(bstart.size),
        ndirect=int(cfirst.size),
        max_rows=int(nrows.max()) if nrows.size else 0,
        max_cols=int(nreal.max()) if nreal.size else 0)


def csr_sdd_panels_plain(panel_rows, panel_cols, panel_mask, dy, b
                         ) -> torch.Tensor:
    """Plain PyTorch version of B3: ``(P, G)`` in the accumulation dtype,
    0 at masked lanes."""
    dy3, b3 = _pair(dy, b)
    acc = acc_dtype_for(b.dtype)
    npanels, g = panel_cols.shape
    out = torch.zeros((npanels, g), dtype=acc, device=b.device)
    step = max(1, _PLAIN_CHUNK // max(b3.shape[0] * g * b3.shape[-1], 1))
    for s in range(0, npanels, step):
        rows = dy3[:, panel_rows[s:s + step].long()].to(acc)    # (Z, p, N)
        gath = b3[:, panel_cols[s:s + step].long()].to(acc)     # (Z, p, G, N)
        out[s:s + step] = (rows[:, :, None] * gath).sum(dim=-1).sum(dim=0)
    return torch.where(panel_mask != 0, out, torch.zeros((), dtype=acc,
                                                          device=b.device))


def bcsr_sdd_panels_plain(panel_rows, panel_cols, panel_mask, dy, b, *,
                          br: int, row_offset: int = 0,
                          nrows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of B4: ``(P, Br, G)`` in the accumulation
    dtype, 0 at masked lanes.  Rows ``[row_offset, row_offset + nrows)`` of
    ``dy`` are the BCSR part's (``nrows`` defaults to the rest of ``dy``);
    rows of a block past ``nrows`` read as zero."""
    dy3, b3 = _pair(dy, b)
    acc = acc_dtype_for(b.dtype)
    z, m, n = dy3.shape
    if nrows is None:
        nrows = m - row_offset
    npanels, g = panel_cols.shape
    nblocks = int(panel_rows.max()) + 1 if npanels else 0
    region = dy3[:, row_offset:row_offset + min(nrows, nblocks * br)]
    slab = torch.zeros((z, nblocks * br, n), dtype=acc, device=b.device)
    slab[:, :region.shape[1]] = region.to(acc)
    blocks = slab.view(z, nblocks, br, n)
    out = torch.zeros((npanels, br, g), dtype=acc, device=b.device)
    step = max(1, _PLAIN_CHUNK // max(z * g * br * n, 1))
    for s in range(0, npanels, step):
        rows = blocks[:, panel_rows[s:s + step].long()]         # (Z, p, Br, N)
        gath = b3[:, panel_cols[s:s + step].long()].to(acc)     # (Z, p, G, N)
        out[s:s + step] = torch.einsum("zprn,zpgn->prg", rows, gath)
    return torch.where((panel_mask != 0)[:, None, :], out,
                       torch.zeros((), dtype=acc, device=b.device))


def _check(rows, cols, mask, dy3, b3) -> None:
    """Device, dtype, shape and contiguity checks shared by B3 and B4."""
    dev = b3.device
    for name, t in (("panel_rows", rows), ("panel_cols", cols),
                    ("panel_mask", mask), ("dy", dy3), ("b", b3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, b on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        raise ValueError(f"panel_rows/panel_cols must be int32 and "
                         f"panel_mask bool, got {rows.dtype}, {cols.dtype} "
                         f"and {mask.dtype}")
    if cols.ndim != 2 or mask.shape != cols.shape \
            or rows.shape != cols.shape[:1]:
        raise ValueError(f"panel shapes disagree: rows {tuple(rows.shape)}, "
                         f"cols {tuple(cols.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if b3.dtype not in _build.DTYPE_CODES or dy3.dtype not in (
            b3.dtype, acc_dtype_for(b3.dtype)):
        raise ValueError(f"b ({b3.dtype}) must be one of "
                         f"{list(_build.DTYPE_CODES)} and dy ({dy3.dtype}) "
                         "its dtype or its accumulation dtype")


_CSR_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 9
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def csr_sdd_panels(panel_rows, panel_cols, panel_mask, dy, b, *,
                   blocks: SddBlockTable | None = None,
                   live: int | None = None) -> torch.Tensor:
    """B3 on ``b``'s device.

    Args:
      panel_rows: (P,) int32 cotangent row of each panel, nondecreasing.
      panel_cols: (P, G) int32 gather rows of ``b``.
      panel_mask: (P, G) lane validity (``bool`` for the kernel).
      dy:         (M, N) or (batch, M, N) output cotangent.
      b:          (K, N) or (batch, K, N) forward dense operand.
      blocks:     the panels' :class:`SddBlockTable` on ``b``'s device (one
                  CTA a block; ``DevicePanels.sdd_blocks`` keeps one per
                  part), built by :func:`sdd_block_table` when not given.
                  The plain version does not read it.
      live:       the unmasked lanes, for the operator's flop count
                  (default: every lane, P x G).
    Returns (P, G) gradients in the accumulation dtype, summed over the
    batch, 0 at masked lanes.
    """
    if b.device.type == "cpu":
        return csr_sdd_panels_plain(panel_rows, panel_cols, panel_mask, dy,
                                    b)
    _check_device("csr_sdd_panels", b, panel_cols)
    dy3, b3 = _pair(dy, b)
    _check(panel_rows, panel_cols, panel_mask, dy3, b3)
    npanels, g = panel_cols.shape
    if blocks is None:
        blocks = sdd_block_table(panel_rows, panel_cols, panel_mask)
    if (blocks.npanels, blocks.g) != (npanels, g):
        raise ValueError(f"the block table covers {blocks.npanels} panels "
                         f"of {blocks.g} lanes; the call has {npanels} of "
                         f"{g}")
    tabs = (blocks.blocks, blocks.outs, blocks.info, blocks.cols)
    if any(t.device != b3.device or not t.is_contiguous() for t in tabs):
        raise ValueError(f"the block table must be contiguous on "
                         f"{b3.device}")
    return _ops.dispatch(_B3, _launch_b3, b3, *tabs, panel_rows, panel_cols,
                         panel_mask, dy3, b3, blocks.nstaged,
                         blocks.max_rows, blocks.max_cols,
                         _lanes(live, panel_cols))


csr_sdd_panels.launches = 0


def _launch_b3(blocks, outs, info, tcols, rows, cols, mask, dy3, b3,
               nstaged: int, max_rows: int, max_cols: int,
               live: int) -> torch.Tensor:
    """The CUDA kernel of ``repro_torch::csr_sdd_panels``."""
    out = torch.empty(cols.shape, dtype=acc_dtype_for(b3.dtype),
                      device=b3.device)
    fn = _build.kernel_fn("csr_sdd", "csr_sdd_panels", _CSR_ARGTYPES)
    with torch.cuda.device(b3.device):
        rc = fn(blocks.data_ptr(), outs.data_ptr(), info.data_ptr(),
                tcols.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                mask.data_ptr(), dy3.data_ptr(), b3.data_ptr(),
                out.data_ptr(), blocks.shape[0], nstaged, max_rows,
                max_cols, cols.shape[1], dy3.shape[1], b3.shape[1],
                b3.shape[2], b3.shape[0], _build.DTYPE_CODES[dy3.dtype],
                _build.DTYPE_CODES[b3.dtype],
                torch.cuda.current_stream(b3.device).cuda_stream)
    _build.check_launch("csr_sdd_panels", rc)
    csr_sdd_panels.launches += 1
    return out


def _shape_b3(blocks, outs, info, tcols, rows, cols, mask, dy3, b3, *ints):
    return torch.empty(cols.shape, dtype=acc_dtype_for(b3.dtype),
                       device=b3.device)


def _sdd_flops(*args, out_shape=None, **kwargs) -> int:
    """B3 / B4: 2 flops a column and batch slice for each unmasked value
    (``live`` lanes, the last integer, of Br values: the output's middle
    dim for B4, 1 for B3)."""
    b3 = args[-5] if len(out_shape) == 2 else args[4]
    br = out_shape[1] if len(out_shape) == 3 else 1
    return 2 * args[-1] * br * b3[0] * b3[2]


_B3 = _ops.define(
    "csr_sdd_panels",
    "(Tensor blocks, Tensor outs, Tensor info, Tensor tcols, Tensor rows, "
    "Tensor cols, Tensor mask, Tensor dy, Tensor b, int nstaged, "
    "int max_rows, int max_cols, int live) -> Tensor",
    _launch_b3, _shape_b3, _sdd_flops, _ops.io_bytes)

_BCSR_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 9
                  + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def sdd_unit_table(panel_rows: torch.Tensor, nblocks: int,
                   units: UnitTable | None = None) -> UnitTable:
    """The work units B4 walks over a part of ``nblocks`` block-rows:
    ``units`` as given (the forward's B2 table, ``DevicePanels.units``),
    checked to cover those block-rows and every panel, else the block-rows
    of ``panel_rows`` (nondecreasing) cut at
    :data:`~repro_torch.kernels.bcsr_spmm.UNIT_PANELS`, on their device."""
    npanels = int(panel_rows.shape[0])
    if units is None:
        units = _units_for(panel_rows, None, None, nblocks, UNIT_PANELS)
    if units.ngroups != nblocks or units.npanels != npanels:
        raise ValueError(f"the unit table covers {units.ngroups} block-rows "
                         f"and {units.npanels} panels; the call has "
                         f"{nblocks} and {npanels}")
    return units


def bcsr_sdd_panels(panel_rows, panel_cols, panel_mask, dy, b, *, br: int,
                    row_offset: int = 0, nrows: int | None = None,
                    units: UnitTable | None = None,
                    live: int | None = None) -> torch.Tensor:
    """B4 on ``b``'s device.

    Args:
      panel_rows: (P,) int32 block-row of each panel.
      panel_cols: (P, G) int32 gather rows of ``b``.
      panel_mask: (P, G) lane validity (``bool`` for the kernel).
      dy:         (M, N) or (batch, M, N) cotangent; the part's rows start
                  at ``row_offset``.
      b:          (K, N) or (batch, K, N) forward dense operand.
      br:         tile height, in :data:`KERNEL_BRS` for the kernel.
      nrows:      rows of the part (default: the rest of ``dy``); block
                  rows past it read as zero.
      units:      the :class:`UnitTable` of the part's ceil(nrows / br)
                  block-rows on ``b``'s device (one CTA a unit); built by
                  :func:`sdd_unit_table` when not given.  The plain version
                  does not read it.
      live:       the unmasked lanes (tiles), for the operator's flop
                  count (default: every lane, P x G).
    Returns (P, Br, G) gradients in the accumulation dtype, summed over the
    batch, 0 at masked lanes.
    """
    if b.device.type == "cpu":
        return bcsr_sdd_panels_plain(panel_rows, panel_cols, panel_mask, dy,
                                     b, br=br, row_offset=row_offset,
                                     nrows=nrows)
    _check_device("bcsr_sdd_panels", b, panel_cols)
    dy3, b3 = _pair(dy, b)
    _check(panel_rows, panel_cols, panel_mask, dy3, b3)
    if br not in KERNEL_BRS:
        raise ValueError(f"br must be one of {KERNEL_BRS}, got {br}")
    if nrows is None:
        nrows = dy3.shape[1] - row_offset
    if row_offset < 0 or nrows < 0 or row_offset + nrows > dy3.shape[1]:
        raise ValueError(f"rows [{row_offset}, {row_offset + nrows}) are not "
                         f"inside dy's {dy3.shape[1]} rows")
    units = sdd_unit_table(panel_rows, max(-(-nrows // br), 1), units)
    if units.units.device != b3.device or not units.units.is_contiguous():
        raise ValueError(f"units must be contiguous on {b3.device}, not "
                         f"{units.units.device}")
    return _ops.dispatch(_B4, _launch_b4, b3, units.units, panel_cols,
                         panel_mask, dy3, b3, br, row_offset, nrows,
                         _lanes(live, panel_cols))


bcsr_sdd_panels.launches = 0


def _launch_b4(units, cols, mask, dy3, b3, br: int, row_offset: int,
               nrows: int, live: int) -> torch.Tensor:
    """The CUDA kernel of ``repro_torch::bcsr_sdd_panels``."""
    npanels, g = cols.shape
    out = torch.empty((npanels, br, g), dtype=acc_dtype_for(b3.dtype),
                      device=b3.device)
    fn = _build.kernel_fn("bcsr_sdd", "bcsr_sdd_panels", _BCSR_ARGTYPES)
    with torch.cuda.device(b3.device):
        rc = fn(units.data_ptr(), cols.data_ptr(), mask.data_ptr(),
                dy3.data_ptr(), b3.data_ptr(), out.data_ptr(),
                units.shape[0], br, g, dy3.shape[1], b3.shape[1],
                b3.shape[2], b3.shape[0], row_offset, nrows,
                _build.DTYPE_CODES[dy3.dtype], _build.DTYPE_CODES[b3.dtype],
                torch.cuda.current_stream(b3.device).cuda_stream)
    _build.check_launch("bcsr_sdd_panels", rc)
    bcsr_sdd_panels.launches += 1
    return out


def _shape_b4(units, cols, mask, dy3, b3, br, *ints):
    return torch.empty((cols.shape[0], br, cols.shape[1]),
                       dtype=acc_dtype_for(b3.dtype), device=b3.device)


_B4 = _ops.define(
    "bcsr_sdd_panels",
    "(Tensor units, Tensor cols, Tensor mask, Tensor dy, Tensor b, int br, "
    "int row_offset, int nrows, int live) -> Tensor",
    _launch_b4, _shape_b4, _sdd_flops, _ops.io_bytes)

register_kernel("csr", "sdd", "panels", csr_sdd_panels)
register_kernel("bcsr", "sdd", "panels", bcsr_sdd_panels)
