"""Sparse formats for LOOPS (paper §3.2): host-side numpy construction plus
device residency for the CUDA kernels.

Port of ``repro/core/formats.py``.  The hybrid format row-splits a CSR
matrix at ``r_boundary`` into a CSR part (rows ``[0, r_boundary)``, the
vector pipeline) and a vector-wise BCSR part (rows ``[r_boundary, nrows)``
re-tiled into ``Br x 1`` column tiles, the matrix pipeline).  Construction
follows the paper's Algorithm 1 and is array-equal to the reference.

Differences from the reference:
  * :func:`bcsr_from_csr_rows` and :func:`_ensure_nonempty_rows` are
    vectorised (the reference loops over every nonzero / row in Python,
    over a minute at the paper's in-2004 size);
  * :meth:`LoopsFormat.on` uploads the panel arrays to a device once and
    caches them (the JAX path holds them as jit constants; re-uploading
    hundreds of MB per call would hide the kernels), together with the
    ``group -> first panel`` offsets the CUDA kernels walk
    (:attr:`PanelCSR.panel_ptr`) and the flat value-slot index that carries
    live values into the panels (:meth:`DevicePanels.scatter_values`);
  * :meth:`LoopsFormat.transposed` is cached per plan and value dtype (numpy
    has no bfloat16, so a bf16 layer keeps its host values in fp32 and names
    its dtype to pick the transposed tile height); the transposed device
    panels and value maps are then uploaded once per device.

Invariants the kernels rely on: every CSR row and every BCSR block-row
owns at least one (possibly zero-valued) panel, and panels are sorted by
(row, col) / (block-row, col), so each output row is written by exactly
one kernel thread group, in a fixed order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..kernels.csr_spmm import UnitTable
    from ..kernels.spmm_sdd import SddBlockTable

__all__ = [
    "CSR", "VectorBCSR", "PanelCSR", "PanelBCSR", "LoopsFormat",
    "DevicePanels", "DeviceLoops", "csr_from_coo", "csr_from_dense",
    "csr_to_dense", "csr_slice_rows", "bcsr_from_csr_rows", "panelize_csr",
    "panelize_bcsr", "loops_from_csr", "loops_format_from_arrays",
    "permute_rows", "loops_from_csr_sorted",
    "TransposedLoops", "loops_from_csr_mapped", "transposed_values",
    "SUBLANE_ROWS", "HALF_PACKED_ROWS", "DEFAULT_PANEL_G",
]

# Tile heights (paper: cntd / cntf / cnth).  ``core.spmm.default_br``
# selects 8 for fp32/fp64 and 16 for half precision, as the reference does.
SUBLANE_ROWS = 8
HALF_PACKED_ROWS = 2 * SUBLANE_ROWS

# Default panel width G: nonzeros (CSR part) / tiles (BCSR part) per panel.
DEFAULT_PANEL_G = 8


@dataclasses.dataclass(frozen=True)
class CSR:
    """Standard CSR with an auxiliary per-nonzero row-id array."""

    row_ptr: np.ndarray  # (nrows + 1,) int32
    col_idx: np.ndarray  # (nnz,) int32
    vals: np.ndarray     # (nnz,) float
    row_ids: np.ndarray  # (nnz,) int32, nondecreasing
    shape: Tuple[int, int]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    def astype(self, dtype) -> "CSR":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))


@dataclasses.dataclass(frozen=True)
class VectorBCSR:
    """Vector-wise BCSR: ``Br x 1`` column tiles grouped by block-row.

    Tile ``t`` holds the ``Br`` values of column ``tile_cols[t]`` for rows
    ``[tile_rows[t]*Br, +Br)`` of the part; ``tile_rows`` is nondecreasing
    and tiles within a block-row are sorted by column.
    """

    tile_rows: np.ndarray  # (ntiles,) int32 block-row index, nondecreasing
    tile_cols: np.ndarray  # (ntiles,) int32 column index
    tile_vals: np.ndarray  # (ntiles, Br) float
    block_ptr: np.ndarray  # (nblocks + 1,) int32 tile extents per block-row
    br: int
    nrows: int             # logical row count covered (<= nblocks * br)
    shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return int(self.block_ptr.shape[0] - 1)

    @property
    def ntiles(self) -> int:
        return int(self.tile_cols.shape[0])

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def astype(self, dtype) -> "VectorBCSR":
        return dataclasses.replace(self, tile_vals=self.tile_vals.astype(dtype))


def _panel_ptr(panel_rows: np.ndarray, ngroups: int) -> np.ndarray:
    """``ptr[r]`` = first panel of group ``r`` (``ptr[ngroups]`` = P): the
    panels of output row / block-row ``r`` are ``[ptr[r], ptr[r+1])``."""
    return np.searchsorted(panel_rows, np.arange(ngroups + 1)).astype(
        np.int64)


@dataclasses.dataclass(frozen=True)
class PanelCSR:
    """CSR-part nonzeros packed into dense ``(P, G)`` panels.

    Panel ``p`` holds up to ``G`` nonzeros of the single output row
    ``panel_rows[p]``; a row's last panel is padded (``panel_mask`` 0,
    col 0, value 0).  ``panel_rows`` is nondecreasing and covers every row.
    """

    panel_rows: np.ndarray  # (P,) int32 output row per panel, nondecreasing
    panel_cols: np.ndarray  # (P, G) int32 gather rows of B (0 where padded)
    panel_vals: np.ndarray  # (P, G) values (0 where padded)
    panel_mask: np.ndarray  # (P, G) validity, same dtype as vals (1 / 0)
    src_panel: np.ndarray   # (nnz,) int32 panel of flat nonzero k
    src_lane: np.ndarray    # (nnz,) int32 lane of flat nonzero k
    g: int
    nrows: int
    shape: Tuple[int, int]

    @property
    def npanels(self) -> int:
        return int(self.panel_rows.shape[0])

    @functools.cached_property
    def panel_ptr(self) -> np.ndarray:
        """(nrows + 1,) int64 first panel of each output row."""
        return _panel_ptr(self.panel_rows, self.nrows)

    def scatter_values(self, vals: torch.Tensor) -> torch.Tensor:
        """Live flat ``(nnz,)`` values -> the ``(P, G)`` panel layout on
        ``vals``' device; padding lanes stay exactly zero and gradients flow
        back to ``vals``."""
        return _scatter(_slot_index(self, vals.device),
                        self.panel_vals.shape, vals)

    def gather_values(self, panel_arr: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`scatter_values`: ``(P, G)`` -> ``(nnz,)``
        (padding lanes dropped)."""
        return _gather(_slot_index(self, panel_arr.device), panel_arr)


@dataclasses.dataclass(frozen=True)
class PanelBCSR:
    """BCSR-part tiles packed into dense ``(P, Br, G)`` value panels.

    Panel ``p`` stacks up to ``G`` of block-row ``panel_rows[p]``'s
    ``Br x 1`` tiles side by side into one ``(Br, G)`` operand; the
    trailing panel of each block-row is padded (mask 0, zero columns).
    """

    panel_rows: np.ndarray  # (P,) int32 block-row per panel, nondecreasing
    panel_cols: np.ndarray  # (P, G) int32 gather rows of B (0 where padded)
    panel_vals: np.ndarray  # (P, Br, G) tile values (zero columns = padding)
    panel_mask: np.ndarray  # (P, G) validity, same dtype as vals (1 / 0)
    src_panel: np.ndarray   # (ntiles,) int32 panel of tile t
    src_lane: np.ndarray    # (ntiles,) int32 lane of tile t
    g: int
    br: int
    nblocks: int
    nrows: int              # logical rows covered (<= nblocks * br)
    shape: Tuple[int, int]

    @property
    def npanels(self) -> int:
        return int(self.panel_rows.shape[0])

    @functools.cached_property
    def panel_ptr(self) -> np.ndarray:
        """(nblocks + 1,) int64 first panel of each block-row."""
        return _panel_ptr(self.panel_rows, self.nblocks)

    def scatter_values(self, tile_vals: torch.Tensor) -> torch.Tensor:
        """Live ``(ntiles, Br)`` tile values -> the ``(P, Br, G)`` panel
        layout (padding columns stay exactly zero)."""
        return _scatter(_slot_index(self, tile_vals.device),
                        self.panel_vals.shape, tile_vals)

    def gather_values(self, panel_arr: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`scatter_values`: ``(P, Br, G)`` ->
        ``(ntiles, Br)`` (padding columns dropped)."""
        return _gather(_slot_index(self, panel_arr.device), panel_arr)


def _slot_index(panels, device) -> torch.Tensor:
    """The flat panel slot ``src_panel * G + src_lane`` of every item of a
    :class:`PanelCSR` / :class:`PanelBCSR`, as int64 on ``device``."""
    return torch.as_tensor(panels.src_panel.astype(np.int64) * panels.g
                           + panels.src_lane, device=device)


def _scatter(slot: torch.Tensor, shape, vals: torch.Tensor) -> torch.Tensor:
    """Items (``(n,)`` or ``(n, Br)``) into a zero panel array of ``shape``
    (``(P, G)`` or ``(P, Br, G)``) at flat slots ``slot``; differentiable
    in ``vals``."""
    if len(shape) == 2:
        p, g = shape
        flat = vals.new_zeros(p * g).index_copy(0, slot, vals.reshape(-1))
        return flat.view(p, g)
    p, br, g = shape
    flat = vals.new_zeros((p * g, br)).index_copy(0, slot,
                                                  vals.reshape(-1, br))
    return flat.view(p, g, br).transpose(1, 2).contiguous()


def _gather(slot: torch.Tensor, panel_arr: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_scatter`: the items at flat slots ``slot``."""
    if panel_arr.ndim == 2:
        return panel_arr.reshape(-1)[slot]
    p, br, g = panel_arr.shape
    return panel_arr.transpose(1, 2).reshape(p * g, br)[slot]


@dataclasses.dataclass(frozen=True)
class DevicePanels:
    """One part's panels resident on a torch device, in the layout the
    kernel wrappers take (mask as ``bool``, group offsets as int64)."""

    rows: torch.Tensor   # (P,) int32 output row / block-row per panel
    ptr: torch.Tensor    # (ngroups + 1,) int64 first panel per group
    cols: torch.Tensor   # (P, G) int32
    vals: torch.Tensor   # (P, G) or (P, Br, G)
    mask: torch.Tensor   # (P, G) bool
    slot: torch.Tensor   # (items,) int64 flat panel slot of each item
    units: "UnitTable"   # the groups' bounded work units (B1/B2's grid)

    @classmethod
    def upload(cls, panels, device) -> "DevicePanels":
        from ..kernels import bcsr_spmm, csr_spmm
        unit_panels = (bcsr_spmm.UNIT_PANELS if panels.panel_vals.ndim == 3
                       else csr_spmm.UNIT_PANELS)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)
        return cls(rows=put(panels.panel_rows), ptr=put(panels.panel_ptr),
                   cols=put(panels.panel_cols), vals=put(panels.panel_vals),
                   mask=put(panels.panel_mask != 0),
                   slot=_slot_index(panels, device),
                   units=csr_spmm.unit_table_of(
                       panels.panel_ptr, unit_panels).to(device))

    @property
    def ngroups(self) -> int:
        return int(self.ptr.shape[0] - 1)

    @property
    def live(self) -> int:
        """The unmasked lanes (the part's items): the kernels' flop
        count."""
        return int(self.slot.shape[0])

    @functools.cached_property
    def sdd_blocks(self) -> "SddBlockTable":
        """A CSR part's block table for B3
        (``kernels/spmm_sdd.py::sdd_block_table``), built on first use and
        kept: only the value gradient reads it, so a format that is never
        trained (the transposed one, a served one) never builds it."""
        if self.vals.ndim != 2:
            raise ValueError("only a CSR part's panels have an SDD block "
                             "table")
        from ..kernels.spmm_sdd import sdd_block_table
        return sdd_block_table(self.rows, self.cols, self.mask)

    def scatter_values(self, vals: torch.Tensor) -> torch.Tensor:
        """Live item values (``(nnz,)`` or ``(ntiles, Br)``) in this part's
        panel layout, in their own dtype; the structure is not re-uploaded."""
        return _scatter(self.slot, tuple(self.vals.shape), vals)

    def gather_values(self, panel_arr: torch.Tensor) -> torch.Tensor:
        """Per-item values out of a panel-layout array (padding dropped)."""
        return _gather(self.slot, panel_arr)


@dataclasses.dataclass(frozen=True)
class DeviceLoops:
    """A :class:`LoopsFormat`'s two panel sets resident on one device."""

    csr: DevicePanels
    bcsr: DevicePanels


@dataclasses.dataclass(frozen=True)
class LoopsFormat:
    """The hybrid LOOPS format (paper §3.2.1, Algorithm 1).

    ``csr_panels``/``bcsr_panels`` are the G-wide panel views of the two
    parts, packed lazily at ``panel_g_eff = panel_g * macro_m`` lanes.
    ``pipeline_depth`` is the reference's software-pipeline depth; it never
    changes a result and enters only the structural step count
    (``core.spmm.loops_grid_steps``).
    """

    csr_part: CSR          # rows [0, r_boundary)
    bcsr_part: VectorBCSR  # rows [r_boundary, nrows)
    r_boundary: int
    shape: Tuple[int, int]
    panel_g: int = 1
    macro_m: int = 1
    pipeline_depth: int = 1

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def panel_g_eff(self) -> int:
        """Effective panel width after macro-step fusion."""
        return max(self.panel_g, 1) * max(self.macro_m, 1)

    @functools.cached_property
    def csr_panels(self) -> PanelCSR:
        return panelize_csr(self.csr_part, self.panel_g_eff)

    @functools.cached_property
    def bcsr_panels(self) -> PanelBCSR:
        return panelize_bcsr(self.bcsr_part, self.panel_g_eff)

    @functools.cached_property
    def nnz(self) -> int:
        # Logical nonzeros (excluding structural zero padding).
        return int(np.count_nonzero(self.csr_part.vals)
                   + np.count_nonzero(self.bcsr_part.tile_vals))

    def astype(self, dtype) -> "LoopsFormat":
        # Panel views and device copies are derived state: the replaced
        # instance rebuilds them from the cast parts.
        return dataclasses.replace(
            self, csr_part=self.csr_part.astype(dtype),
            bcsr_part=self.bcsr_part.astype(dtype))

    def on(self, device) -> DeviceLoops:
        """Both parts' panels on ``device``, uploaded on first use and
        cached on this instance per device."""
        device = torch.device(device)
        cache: Dict[str, DeviceLoops] = self.__dict__.setdefault(
            "_device_cache", {})
        key = str(device)
        if key not in cache:
            cache[key] = DeviceLoops(
                csr=DevicePanels.upload(self.csr_panels, device),
                bcsr=DevicePanels.upload(self.bcsr_panels, device))
        return cache[key]

    def transposed(self, *, plan=None, tuner=None, total_workers: int = 8,
                   dtype=None) -> "TransposedLoops":
        """Aᵀ as a LOOPS format plus the value-linear maps from A's stored
        values: the operand of the backward ``dB = Aᵀ·dY``.

        ``plan`` pins the transposed plan (a ``core.spmm.SpmmPlan``);
        otherwise it comes from ``tuner`` (a ``repro_torch.tune.Tuner``:
        the measured plan cache, tuned on Aᵀ's own structure), or is
        planned from Aᵀ's own rows with ``total_workers`` and the tile
        height of ``dtype``, the dtype the values run in (default: the
        host values' dtype).  Cached on this instance per ``(plan, tuner,
        total_workers, dtype)``, so every training step after the first
        pays nothing.  The transposed format's device panels and value maps
        are cached per device on the result.
        """
        from ..kernels.engine import torch_dtype
        dt = torch_dtype(self.csr_part.vals.dtype if dtype is None
                         else dtype)
        key = (plan, id(tuner) if tuner is not None else None,
               total_workers, str(dt))
        cache = self.__dict__.setdefault("_transposed_cache", {})
        if key not in cache:
            # The entry pins the tuner: id() is only a safe key while the
            # object is alive (a freed address can be recycled by a new
            # tuner, which must not hit this entry).
            cache[key] = (tuner, _build_transposed(
                self, plan=plan, tuner=tuner, total_workers=total_workers,
                dtype=dt))
        return cache[key][1]


# ---------------------------------------------------------------------------
# CSR construction
# ---------------------------------------------------------------------------

def _ensure_nonempty_rows(row_ptr, col_idx, vals):
    """Insert a single explicit zero entry (col 0) into every empty row, so
    every output row owns at least one panel (vectorised twin of the
    reference's per-row loop)."""
    counts = np.diff(row_ptr)
    if (counts > 0).all() and len(counts) > 0:
        return row_ptr, col_idx, vals
    nrows = len(counts)
    new_counts = np.maximum(counts, 1)
    new_ptr = np.zeros(nrows + 1, np.int32)
    np.cumsum(new_counts, out=new_ptr[1:])
    new_cols = np.zeros(new_ptr[-1], np.int32)
    new_vals = np.zeros(new_ptr[-1], vals.dtype)
    # Entry k of row i moves to new_ptr[i] + (k - row_ptr[i]); the pad of
    # an empty row is the zero already at new_ptr[i].
    rid = np.repeat(np.arange(nrows, dtype=np.int64), counts)
    src = np.arange(len(rid), dtype=np.int64) + (int(row_ptr[0]) if nrows
                                                 else 0)
    dest = (new_ptr[:-1].astype(np.int64)[rid] + src
            - row_ptr[:-1].astype(np.int64)[rid])
    new_cols[dest] = col_idx[src]
    new_vals[dest] = vals[src]
    return new_ptr, new_cols, new_vals


def _csr_from_arrays(row_ptr, col_idx, vals, shape) -> CSR:
    row_ptr = np.asarray(row_ptr, np.int32)
    col_idx = np.asarray(col_idx, np.int32)
    vals = np.asarray(vals)
    row_ptr, col_idx, vals = _ensure_nonempty_rows(row_ptr, col_idx, vals)
    row_ids = np.repeat(
        np.arange(shape[0], dtype=np.int32), np.diff(row_ptr)).astype(np.int32)
    return CSR(row_ptr=row_ptr, col_idx=col_idx, vals=vals, row_ids=row_ids,
               shape=tuple(shape))


def csr_from_dense(dense: np.ndarray) -> CSR:
    dense = np.asarray(dense)
    nrows, _ = dense.shape
    mask = dense != 0
    counts = mask.sum(axis=1)
    row_ptr = np.zeros(nrows + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    rows, cols = np.nonzero(mask)
    return _csr_from_arrays(row_ptr, cols, dense[rows, cols], dense.shape)


def csr_from_coo(rows, cols, vals, shape, *,
                 validate: str | None = "strict") -> CSR:
    """COO -> CSR, summing values that share a ``(row, col)`` coordinate.

    Coordinates are validated first (``repro_torch.resilience.validate``):
    under ``validate="strict"`` (default) a negative or out-of-range
    coordinate raises a classified ``SparseInputError``; ``"drop"`` /
    ``"clip"`` repair instead; ``None`` skips the gate.
    """
    if validate is not None:
        from ..resilience.validate import validate_coo
        rows, cols, vals, _ = validate_coo(
            rows, cols, vals, shape,
            repair=None if validate == "strict" else validate)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    # np.unique on the linearised coordinate both dedups and (row, col)-sorts.
    lin = rows * int(shape[1]) + cols
    uniq, inv = np.unique(lin, return_inverse=True)
    summed = np.zeros(len(uniq), vals.dtype)
    np.add.at(summed, inv, vals)
    rows = uniq // int(shape[1])
    cols = uniq % int(shape[1])
    counts = np.bincount(rows, minlength=shape[0])
    row_ptr = np.zeros(shape[0] + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return _csr_from_arrays(row_ptr, cols, summed, shape)


def csr_to_dense(csr: CSR) -> np.ndarray:
    out = np.zeros(csr.shape, csr.vals.dtype)
    # += (not =) so structural-zero pads coexisting with real entries are safe.
    np.add.at(out, (csr.row_ids, csr.col_idx), csr.vals)
    return out


def csr_slice_rows(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) as a new CSR (paper Alg. 1 Step 1)."""
    s, e = int(csr.row_ptr[start]), int(csr.row_ptr[stop])
    row_ptr = (csr.row_ptr[start:stop + 1] - csr.row_ptr[start]).astype(np.int32)
    return _csr_from_arrays(row_ptr, csr.col_idx[s:e], csr.vals[s:e],
                            (stop - start, csr.shape[1]))


# ---------------------------------------------------------------------------
# Vector-wise BCSR construction (paper Alg. 1 Step 2, with B_c = 1)
# ---------------------------------------------------------------------------

def bcsr_from_csr_rows(csr: CSR, start: int, stop: int, br: int, *,
                       keep_zeros: bool = False, return_map: bool = False):
    """Re-tile rows [start, stop) of ``csr`` into ``br x 1`` tiles.

    Each nonzero (i, j) lands in tile ``(i // br, j)`` at offset
    ``i % br``; tiles are sorted by (block_row, col) and every block-row
    gets >= 1 tile (an all-zero tile at column 0 where it has none).
    Zero-valued stored entries are dropped unless ``keep_zeros`` (the
    autodiff transpose keeps them: its structure must not depend on
    values).  ``return_map`` also returns ``slot_map``, int64 over the
    sliced entries: the flat destination ``tile * br + offset`` of entry
    ``row_ptr[start] + k``, or -1 where it was dropped.  Vectorised:
    ``np.unique`` over the linearised tile key, then ``np.add.at`` into
    ``(ntiles, br)`` (which sums duplicate coordinates in entry order, as
    the reference does).
    """
    nrows = stop - start
    nblocks = max((nrows + br - 1) // br, 1)
    s, e = int(csr.row_ptr[start]), int(csr.row_ptr[stop])
    local = csr.row_ids[s:e].astype(np.int64) - start
    cols = csr.col_idx[s:e].astype(np.int64)
    vals = csr.vals[s:e]
    # Dropping zeros removes the parent CSR's structural pads.
    keep = np.ones(len(vals), bool) if keep_zeros else vals != 0
    local, cols, vals = local[keep], cols[keep], vals[keep]
    tr = local // br
    stride = max(int(csr.shape[1]), 1)
    key = tr * stride + cols
    missing = np.setdiff1d(np.arange(nblocks, dtype=np.int64), tr)
    keys, inv = np.unique(np.concatenate([key, missing * stride]),
                          return_inverse=True)
    inv = inv.reshape(-1)
    tile_vals = np.zeros((len(keys), br), csr.vals.dtype)
    np.add.at(tile_vals, (inv[:len(key)], local % br), vals)
    tile_rows = (keys // stride).astype(np.int32)
    tile_cols = (keys % stride).astype(np.int32)
    counts = np.bincount(tile_rows, minlength=nblocks)
    block_ptr = np.zeros(nblocks + 1, np.int32)
    np.cumsum(counts, out=block_ptr[1:])
    bcsr = VectorBCSR(tile_rows=tile_rows, tile_cols=tile_cols,
                      tile_vals=tile_vals, block_ptr=block_ptr, br=br,
                      nrows=nrows, shape=(nrows, csr.shape[1]))
    if not return_map:
        return bcsr
    slot_map = np.full(e - s, -1, np.int64)
    slot_map[keep] = inv[:len(key)] * br + local % br
    return bcsr, slot_map


# ---------------------------------------------------------------------------
# G-wide panelization (paper Figure 2 multi-tile batching)
# ---------------------------------------------------------------------------

def _pack_panels(group_of_item: np.ndarray, group_ptr: np.ndarray,
                 ngroups: int, g: int):
    """Split each group's items into ceil(n/g) dense panels (>= 1 per
    group).  Returns ``(panel_rows, item_panel, item_lane, npanels)``."""
    counts = np.diff(group_ptr).astype(np.int64)
    per_group = np.maximum(-(-counts // g), 1)          # ceil, min 1
    start = np.zeros(ngroups + 1, np.int64)
    np.cumsum(per_group, out=start[1:])
    npanels = int(start[-1])
    panel_rows = np.repeat(np.arange(ngroups, dtype=np.int32),
                           per_group).astype(np.int32)
    offset = np.arange(len(group_of_item), dtype=np.int64) \
        - group_ptr[group_of_item].astype(np.int64)
    item_panel = start[group_of_item] + offset // g
    item_lane = offset % g
    return panel_rows, item_panel, item_lane, npanels


def panelize_csr(csr: CSR, g: int) -> PanelCSR:
    """Pack the CSR-part nonzeros into ``(P, G)`` panels, G per row-visit;
    a row with ``c`` nonzeros yields ``max(ceil(c / g), 1)`` panels."""
    if g < 1:
        raise ValueError(f"panel width g must be >= 1, got {g}")
    panel_rows, pnl, lane, npanels = _pack_panels(
        csr.row_ids, csr.row_ptr, csr.nrows, g)
    cols = np.zeros((npanels, g), np.int32)
    vals = np.zeros((npanels, g), csr.vals.dtype)
    mask = np.zeros((npanels, g), csr.vals.dtype)
    cols[pnl, lane] = csr.col_idx
    vals[pnl, lane] = csr.vals
    mask[pnl, lane] = 1
    return PanelCSR(panel_rows=panel_rows, panel_cols=cols, panel_vals=vals,
                    panel_mask=mask, src_panel=pnl.astype(np.int32),
                    src_lane=lane.astype(np.int32), g=g, nrows=csr.nrows,
                    shape=csr.shape)


def panelize_bcsr(bcsr: VectorBCSR, g: int) -> PanelBCSR:
    """Pack the BCSR-part ``Br x 1`` tiles into ``(P, Br, G)`` panels;
    block-rows with ``t`` tiles yield ``max(ceil(t/g), 1)`` panels."""
    if g < 1:
        raise ValueError(f"panel width g must be >= 1, got {g}")
    panel_rows, pnl, lane, npanels = _pack_panels(
        bcsr.tile_rows, bcsr.block_ptr, bcsr.nblocks, g)
    cols = np.zeros((npanels, g), np.int32)
    mask = np.zeros((npanels, g), bcsr.tile_vals.dtype)
    cols[pnl, lane] = bcsr.tile_cols
    mask[pnl, lane] = 1
    # (P, G, Br) scatter then transpose to the (P, Br, G) operand layout.
    vals = np.zeros((npanels, g, bcsr.br), bcsr.tile_vals.dtype)
    vals[pnl, lane] = bcsr.tile_vals
    return PanelBCSR(panel_rows=panel_rows, panel_cols=cols,
                     panel_vals=np.ascontiguousarray(vals.transpose(0, 2, 1)),
                     panel_mask=mask, src_panel=pnl.astype(np.int32),
                     src_lane=lane.astype(np.int32), g=g, br=bcsr.br,
                     nblocks=bcsr.nblocks, nrows=bcsr.nrows, shape=bcsr.shape)


# ---------------------------------------------------------------------------
# Hybrid LOOPS format (Algorithm 1)
# ---------------------------------------------------------------------------

def loops_from_csr(csr: CSR, r_boundary: int, br: int,
                   panel_g: int = DEFAULT_PANEL_G, *,
                   macro_m: int = 1,
                   pipeline_depth: int = 1) -> LoopsFormat:
    """Algorithm 1: CSR-part = rows [0, r_boundary), BCSR-part = the rest.

    ``panel_g`` is the panel width; ``macro_m`` fuses that many consecutive
    same-row panels into one (panels pack at ``panel_g * macro_m`` lanes);
    ``pipeline_depth`` (1 or 2) is carried for the structural step count.
    """
    if not 0 <= r_boundary <= csr.nrows:
        raise ValueError(f"r_boundary {r_boundary} out of range [0, {csr.nrows}]")
    if macro_m < 1:
        raise ValueError(f"macro_m must be >= 1, got {macro_m}")
    if pipeline_depth not in (1, 2):
        raise ValueError(f"pipeline_depth must be one of (1, 2), got "
                         f"{pipeline_depth}")
    return LoopsFormat(csr_part=csr_slice_rows(csr, 0, r_boundary),
                       bcsr_part=bcsr_from_csr_rows(csr, r_boundary,
                                                    csr.nrows, br),
                       r_boundary=r_boundary, shape=csr.shape,
                       panel_g=panel_g, macro_m=macro_m,
                       pipeline_depth=pipeline_depth)


def permute_rows(csr: CSR, order: np.ndarray) -> CSR:
    """New CSR whose row i is ``csr`` row ``order[i]`` (O(nnz)); array-equal
    to the reference's, with the gather index built without a Python loop
    over rows."""
    counts = np.diff(csr.row_ptr)[order]
    new_ptr = np.zeros(csr.nrows + 1, np.int32)
    np.cumsum(counts, out=new_ptr[1:])
    if csr.nnz:
        starts = csr.row_ptr[order].astype(np.int64)
        idx = (np.arange(int(counts.sum()), dtype=np.int64)
               + np.repeat(starts - new_ptr[:-1].astype(np.int64), counts))
    else:
        idx = np.zeros(0, np.int64)
    return _csr_from_arrays(new_ptr, csr.col_idx[idx], csr.vals[idx],
                            csr.shape)


def loops_from_csr_sorted(csr: CSR, r_boundary: int, br: int,
                          panel_g: int = DEFAULT_PANEL_G, *,
                          macro_m: int = 1, pipeline_depth: int = 1
                          ) -> Tuple[LoopsFormat, np.ndarray]:
    """The reference's row-sorted variant: rows by nnz descending (stable)
    before the positional split, so scattered hub rows land in the CSR
    part and the BCSR part has no monster block-rows.  Returns (format,
    order) with ``C_permuted[i] == C[order[i]]``."""
    order = np.argsort(-np.diff(csr.row_ptr), kind="stable").astype(np.int64)
    return loops_from_csr(permute_rows(csr, order), r_boundary, br,
                          panel_g=panel_g, macro_m=macro_m,
                          pipeline_depth=pipeline_depth), order


def loops_format_from_arrays(arrays: dict) -> LoopsFormat:
    """A :class:`LoopsFormat` from the numpy arrays of an already converted
    one (for instance the JAX reference's), taken as they are.

    Keys: ``csr_row_ptr``, ``csr_col_idx``, ``csr_vals`` (the CSR part),
    ``tile_rows``, ``tile_cols``, ``tile_vals``, ``block_ptr`` (the BCSR
    part), ``r_boundary``, ``shape``, ``panel_g``, ``macro_m`` and
    ``pipeline_depth``.  The tile height is ``tile_vals.shape[1]``.
    """
    a = arrays
    shape = tuple(int(s) for s in a["shape"])
    r_b = int(a["r_boundary"])
    row_ptr = np.asarray(a["csr_row_ptr"], np.int32)
    csr = CSR(row_ptr=row_ptr,
              col_idx=np.asarray(a["csr_col_idx"], np.int32),
              vals=np.asarray(a["csr_vals"]),
              row_ids=np.repeat(np.arange(r_b, dtype=np.int32),
                                np.diff(row_ptr)).astype(np.int32),
              shape=(r_b, shape[1]))
    tile_vals = np.asarray(a["tile_vals"])
    bcsr = VectorBCSR(tile_rows=np.asarray(a["tile_rows"], np.int32),
                      tile_cols=np.asarray(a["tile_cols"], np.int32),
                      tile_vals=tile_vals,
                      block_ptr=np.asarray(a["block_ptr"], np.int32),
                      br=int(tile_vals.shape[1]), nrows=shape[0] - r_b,
                      shape=(shape[0] - r_b, shape[1]))
    return LoopsFormat(csr_part=csr, bcsr_part=bcsr, r_boundary=r_b,
                       shape=shape, panel_g=int(a["panel_g"]),
                       macro_m=int(a["macro_m"]),
                       pipeline_depth=int(a["pipeline_depth"]))


# ---------------------------------------------------------------------------
# Transposed format for the backward pass
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransposedLoops:
    """Aᵀ in LOOPS form plus the value-linear maps from A's stored values.

    The structure depends on A's sparsity pattern only; the maps are static
    index arrays, so live values of A reach Aᵀ's layout through two
    ``index_add``s (:func:`transposed_values`).  A's flat value vector is
    ``concat(csr_part.vals, bcsr_part.tile_vals.ravel())``; BCSR tile slots
    on padding rows (``row >= nrows``) carry no gradient and are left out.
    """

    fmt: LoopsFormat        # Aᵀ, converted under the resolved plan
    plan: object            # the SpmmPlan the conversion used
    entry_src: np.ndarray   # (E,) int64 index into A's flat value vector
    entry_slot: np.ndarray  # (E,) int64 destination slot in Aᵀ's CSR
    n_slots: int            # stored entries of Aᵀ (incl. empty-row pads)
    csr_len: int            # slots [0, csr_len) are fmt.csr_part.vals
    bcsr_slot: np.ndarray   # (n_slots - csr_len,) int64 flat tile*Br+off

    def maps_on(self, device) -> Tuple[torch.Tensor, ...]:
        """``(entry_src, entry_slot, bcsr_slot)`` as int64 tensors on
        ``device``, uploaded on first use and cached per device."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_maps_cache", {})
        key = str(device)
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(a, device=device) for a in (
                self.entry_src, self.entry_slot, self.bcsr_slot))
        return cache[key]


def loops_from_csr_mapped(csr: CSR, r_boundary: int, br: int,
                          panel_g: int = DEFAULT_PANEL_G, *,
                          macro_m: int = 1, pipeline_depth: int = 1
                          ) -> Tuple[LoopsFormat, int, np.ndarray]:
    """Algorithm 1 with value-slot bookkeeping (the autodiff transpose).

    Like :func:`loops_from_csr`, but the BCSR part keeps zero-valued stored
    entries and the result carries the maps from ``csr``'s flat value order
    into the two parts: ``(fmt, csr_len, bcsr_slot)`` where entries
    ``[0, csr_len)`` become ``fmt.csr_part.vals`` verbatim and entry
    ``csr_len + j`` lands at flat tile slot ``bcsr_slot[j]``.  ``csr`` must
    have no empty rows.
    """
    if not 0 <= r_boundary <= csr.nrows:
        raise ValueError(f"r_boundary {r_boundary} out of range "
                         f"[0, {csr.nrows}]")
    csr_part = csr_slice_rows(csr, 0, r_boundary)
    csr_len = int(csr.row_ptr[r_boundary])
    if csr_part.nnz != csr_len:
        raise ValueError("loops_from_csr_mapped needs a CSR with no empty "
                         "rows (slicing inserted pad entries)")
    bcsr_part, bcsr_slot = bcsr_from_csr_rows(
        csr, r_boundary, csr.nrows, br, keep_zeros=True, return_map=True)
    fmt = LoopsFormat(csr_part=csr_part, bcsr_part=bcsr_part,
                      r_boundary=r_boundary, shape=csr.shape,
                      panel_g=panel_g, macro_m=macro_m,
                      pipeline_depth=pipeline_depth)
    return fmt, csr_len, bcsr_slot


def _transposed_csr(fmt: LoopsFormat) -> Tuple[CSR, np.ndarray, np.ndarray]:
    """Aᵀ as a (row, col)-sorted CSR with every row populated, plus the
    entry maps ``(csr_t, entry_src, entry_slot)``: A's flat stored entry
    ``entry_src[e]`` adds into ``csr_t.vals[entry_slot[e]]``.  Empty rows
    of Aᵀ get an explicit zero pad at column 0 with no source entry."""
    csr, bc = fmt.csr_part, fmt.bcsr_part
    m, k = fmt.shape
    t, br = bc.tile_vals.shape
    rows = np.concatenate([
        csr.row_ids.astype(np.int64),
        fmt.r_boundary + np.repeat(bc.tile_rows.astype(np.int64), br) * br
        + np.tile(np.arange(br, dtype=np.int64), t)])
    cols = np.concatenate([csr.col_idx.astype(np.int64),
                           np.repeat(bc.tile_cols.astype(np.int64), br)])
    keep = rows < m          # BCSR padding rows never reach the output
    entry_src = np.nonzero(keep)[0].astype(np.int64)
    # Transposed coordinate, linearised in Aᵀ's (row, col) = (col, row) order.
    lin = cols[keep] * m + rows[keep]
    uniq, inv = np.unique(lin, return_inverse=True)
    inv = inv.reshape(-1)
    missing = np.setdiff1d(np.arange(k, dtype=np.int64),
                           np.unique(uniq // m))
    all_lin = np.sort(np.concatenate([uniq, missing * m]))
    entry_slot = np.searchsorted(all_lin, uniq)[inv].astype(np.int64)
    rows_t = (all_lin // m).astype(np.int32)
    cols_t = (all_lin % m).astype(np.int32)
    flat_vals = np.concatenate([np.asarray(csr.vals).ravel(),
                                np.asarray(bc.tile_vals).ravel()])
    vals_t = np.zeros(len(all_lin), flat_vals.dtype)
    np.add.at(vals_t, entry_slot, flat_vals[entry_src])
    row_ptr = np.zeros(k + 1, np.int32)
    np.cumsum(np.bincount(rows_t, minlength=k), out=row_ptr[1:])
    csr_t = CSR(row_ptr=row_ptr, col_idx=cols_t, vals=vals_t,
                row_ids=rows_t, shape=(k, m))
    return csr_t, entry_src, entry_slot


def _build_transposed(fmt: LoopsFormat, *, plan=None, tuner=None,
                      total_workers: int = 8,
                      dtype=None) -> TransposedLoops:
    """Materialise :class:`TransposedLoops` (cached by
    :meth:`LoopsFormat.transposed`).  Without ``plan``, Aᵀ is planned
    through ``tuner`` when given (``tuner.tune(csr_t)``, as the reference's
    ``plan_and_convert(csr_t, tuner=...)``), else like a forward matrix
    (``core.spmm.plan_for``, the planning half of ``plan_and_convert``)
    from its own row statistics, at the tile height of ``dtype``."""
    from .spmm import default_br, plan_for   # spmm imports this module
    csr_t, entry_src, entry_slot = _transposed_csr(fmt)
    if plan is None and tuner is not None:
        _, plan = tuner.tune(csr_t)
    elif plan is None:
        plan = plan_for(csr_t, total_workers=total_workers,
                        br=default_br(dtype if dtype is not None
                                      else csr_t.vals.dtype),
                        panel_g=fmt.panel_g or None, macro_m=fmt.macro_m,
                        pipeline_depth=fmt.pipeline_depth)
    fmt_t, csr_len, bcsr_slot = loops_from_csr_mapped(
        csr_t, plan.r_boundary, plan.br, panel_g=plan.panel_g,
        macro_m=int(plan.macro_m), pipeline_depth=int(plan.pipeline_depth))
    tl = TransposedLoops(fmt=fmt_t, plan=plan, entry_src=entry_src,
                         entry_slot=entry_slot, n_slots=csr_t.nnz,
                         csr_len=csr_len, bcsr_slot=bcsr_slot)
    # Round-trip check: A's own values carried through the maps must
    # reproduce the converted parts (a map/structure drift would otherwise
    # surface as a silently wrong gradient).
    flat = np.concatenate([np.asarray(fmt.csr_part.vals).ravel(),
                           np.asarray(fmt.bcsr_part.tile_vals).ravel()])
    vals_t = np.zeros(tl.n_slots, flat.dtype)
    np.add.at(vals_t, tl.entry_slot, flat[tl.entry_src])
    nt, brr = fmt_t.bcsr_part.tile_vals.shape
    tile_flat = np.zeros(nt * brr, flat.dtype)
    np.add.at(tile_flat, tl.bcsr_slot, vals_t[tl.csr_len:])
    if not (np.allclose(vals_t[:tl.csr_len].astype(np.float64),
                        np.asarray(fmt_t.csr_part.vals, np.float64))
            and np.allclose(tile_flat.reshape(nt, brr).astype(np.float64),
                            np.asarray(fmt_t.bcsr_part.tile_vals,
                                       np.float64))):
        raise AssertionError("transposed value maps disagree with the "
                             "converted transposed format")
    return tl


def transposed_values(tl: TransposedLoops, csr_vals: torch.Tensor,
                      bcsr_vals: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry live values of A into the transposed layout.

    Returns ``(csr_vals_t, bcsr_tile_vals_t)`` matching ``tl.fmt.csr_part``
    / ``tl.fmt.bcsr_part``: two ``index_add``s with static indices on the
    values' device, linear in the inputs, so gradients flow through them.
    """
    src, slot, bslot = tl.maps_on(csr_vals.device)
    flat = torch.cat([csr_vals.reshape(-1), bcsr_vals.reshape(-1)])
    vals_t = flat.new_zeros(tl.n_slots).index_add(0, slot, flat[src])
    nt, br = tl.fmt.bcsr_part.tile_vals.shape
    tile_flat = flat.new_zeros(nt * br).index_add(0, bslot,
                                                  vals_t[tl.csr_len:])
    return vals_t[:tl.csr_len], tile_flat.view(nt, br)
