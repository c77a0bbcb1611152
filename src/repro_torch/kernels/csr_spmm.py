"""B1: the CSR-part panel SpMM (the vector-pipeline half of LOOPS).

``csr_panels_spmm`` is the wrapper of the hand-written CUDA kernel
``csrc/csr_spmm.cu``, which replaces the TPU kernel
``repro/kernels/csr_spmm.py::csr_panels_spmm_pallas``.  For every panel p
of the ``(P, G)`` layout it computes

    C[panel_rows[p], :] += sum_i mask[p,i] * vals[p,i] * B[panel_cols[p,i], :]

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`csr_panels_spmm_plain`, the same panel function in
plain PyTorch, which the tests and ``chip_smoke.py`` hold the kernel
against.

The kernel walks bounded work units (:func:`unit_table_of`): at most
:data:`UNIT_PANELS` panels of one row per warp, a longer row split into
several units whose partial sums a second pass adds in a fixed order (see
the source's note).  ``csr_panels_spmm.launches`` counts calls that launch
the kernel, one per call whether or not the second pass runs (never the
plain version's calls).

The launch is the operator ``torch.ops.repro_torch.csr_panels_spmm``
(``kernels/_ops.py``, which says when the wrapper calls its CUDA kernel
without the dispatcher): its tables, the unit table and the panels, are
tensor inputs and its output buffer a mutated argument, so on ``meta`` or
fake tensors (a ``FakeTensorMode`` trace) the wrapper runs its checks and
the operator's shape function and launches nothing.  The unit table is
then the caller's: it is built on the host from index data.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build, _ops
from .engine import acc_dtype_for, register_kernel, resolve_dtypes

__all__ = ["csr_panels_spmm", "csr_panels_spmm_plain", "panel_ptr_of",
           "unit_table_of", "UnitTable", "UNIT_PANELS"]

# Most panels one work unit of B1 walks (one warp per unit x column tile):
# a row with more is split into ceil(panels / UNIT_PANELS) units.  Chosen on
# the H100 with spmm_sweep.py (PERF.md): on the in-2004-like matrix 8 and 16
# are 10% faster than 32 and 128 is 1.8x slower; on the GCN's transposed
# adjacency 16 is the fastest.
UNIT_PANELS = 16

# Elements of the (batch, panels, G, N) gather the plain versions hold at
# once; larger inputs are processed in panel chunks.
_PLAIN_CHUNK = 1 << 24


def panel_ptr_of(panel_rows: torch.Tensor, ngroups: int) -> torch.Tensor:
    """``ptr[r]`` = first panel of group ``r`` (int64, ``ngroups + 1``)."""
    groups = torch.arange(ngroups + 1, device=panel_rows.device,
                          dtype=panel_rows.dtype)
    return torch.searchsorted(panel_rows.contiguous(), groups).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class UnitTable:
    """A part's panels cut into bounded work units (the B1/B2 kernels' grid).

    ``units`` is ``(nunits, 4)`` int64, one row ``(group, first panel, end
    panel, slot)`` per unit, ordered by group and then by panel; a unit
    holds at most ``unit_panels`` panels, every group (even an empty one)
    has at least one unit, and ``slot`` is -1 for the one unit of an unsplit
    group, else the unit's partial-sum slot, consecutive within a split
    group.  ``splits`` is ``(nsplit, 3)`` int64, one row ``(group, first
    slot, end slot)`` per split group.
    """

    units: torch.Tensor
    splits: torch.Tensor
    ngroups: int
    npanels: int
    nslots: int
    unit_panels: int
    max_panels: int     # the longest unit's panels (<= unit_panels)
    max_slots: int      # the most slots of one split group (0: no split)

    @property
    def nunits(self) -> int:
        return int(self.units.shape[0])

    @property
    def nsplit(self) -> int:
        return int(self.splits.shape[0])

    def to(self, device) -> "UnitTable":
        return dataclasses.replace(self, units=self.units.to(device),
                                   splits=self.splits.to(device))


def unit_table_of(panel_ptr, unit_panels: int) -> UnitTable:
    """The :class:`UnitTable` of a part's group -> first-panel offsets
    ``panel_ptr`` (numpy or tensor; the table lands on its device), with at
    most ``unit_panels`` panels a unit."""
    if unit_panels < 1:
        raise ValueError(f"unit_panels must be >= 1, got {unit_panels}")
    device = panel_ptr.device if isinstance(panel_ptr, torch.Tensor) \
        else torch.device("cpu")
    if isinstance(panel_ptr, torch.Tensor):
        panel_ptr = panel_ptr.cpu().numpy()
    ptr = np.asarray(panel_ptr, np.int64)
    count = np.diff(ptr)
    per_group = np.maximum(1, -(-count // unit_panels))
    group = np.repeat(np.arange(count.size, dtype=np.int64), per_group)
    first_unit = np.cumsum(per_group) - per_group
    begin = ptr[group] + (np.arange(group.size) - first_unit[group]) \
        * unit_panels
    end = np.minimum(begin + unit_panels, ptr[group + 1])
    split = per_group[group] > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    split_groups = np.flatnonzero(per_group > 1)
    slot_end = np.cumsum(per_group[split_groups])
    units = np.stack([group, begin, end, slot], axis=1).astype(np.int64)
    splits = np.stack([split_groups, slot_end - per_group[split_groups],
                       slot_end], axis=1).astype(np.int64)
    return UnitTable(
        units=torch.from_numpy(units).to(device),
        splits=torch.from_numpy(splits).to(device),
        ngroups=int(count.size), npanels=int(ptr[-1]) if ptr.size else 0,
        nslots=int(split.sum()), unit_panels=int(unit_panels),
        max_panels=int((end - begin).max()) if group.size else 0,
        max_slots=int(per_group[split_groups].max()) if split_groups.size
        else 0)


def _as3(b: torch.Tensor) -> torch.Tensor:
    if b.ndim not in (2, 3):
        raise ValueError(f"b must be (K, N) or (batch, K, N); got rank "
                         f"{b.ndim}")
    return b if b.ndim == 3 else b.unsqueeze(0)


def _target(out, b3, rows_needed: int, dtype) -> torch.Tensor:
    """The output buffer: ``out`` checked, or a fresh one of
    ``rows_needed`` rows per slice."""
    shape = (b3.shape[0], rows_needed, b3.shape[-1])
    if out is None:
        return torch.empty(shape, dtype=dtype, device=b3.device)
    o3 = out if out.ndim == 3 else out.unsqueeze(0)
    if (o3.shape[0] != shape[0] or o3.shape[2] != shape[2]
            or o3.shape[1] < rows_needed or o3.dtype != dtype
            or o3.device != b3.device):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} cannot hold rows [0, {rows_needed}) "
                         f"of {shape} {dtype} on {b3.device}")
    return o3


def csr_panels_spmm_plain(panel_rows, panel_cols, panel_vals, panel_mask, b,
                          *, nrows: int, out_dtype=None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the panel function: masked gather,
    multiply, sum over G, ``index_add_`` over ``panel_rows``.  Writes rows
    ``[0, nrows)`` of ``out`` when given, else returns a new
    ``(..., nrows, N)`` tensor."""
    b3 = _as3(b)
    acc, out_dt = resolve_dtypes(panel_vals.dtype, out_dtype)
    y = torch.zeros((b3.shape[0], nrows, b3.shape[-1]), dtype=acc,
                    device=b3.device)
    npanels, g = panel_cols.shape
    mask = panel_mask != 0
    step = max(1, _PLAIN_CHUNK // max(b3.shape[0] * g * b3.shape[-1], 1))
    for s in range(0, npanels, step):
        rows = b3[:, panel_cols[s:s + step].long()].to(acc)   # (B, p, G, N)
        contrib = panel_vals[s:s + step].to(acc)[None, :, :, None] * rows
        contrib = torch.where(mask[s:s + step][None, :, :, None], contrib,
                              torch.zeros((), dtype=acc, device=b3.device))
        y.index_add_(1, panel_rows[s:s + step].long(), contrib.sum(dim=2))
    if out is None:
        y = y.to(out_dt)
        return y if b.ndim == 3 else y[0]
    o3 = _target(out, b3, nrows, out_dt)
    o3[:, :nrows] = y
    return out


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 8
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def csr_panels_spmm(panel_rows, panel_cols, panel_vals, panel_mask, b, *,
                    nrows: int, panel_ptr: torch.Tensor | None = None,
                    units: UnitTable | None = None, out_dtype=None,
                    out: torch.Tensor | None = None,
                    live: int | None = None) -> torch.Tensor:
    """B1 on ``b``'s device.

    Args:
      panel_rows: (P,) int32 nondecreasing output row per panel.
      panel_cols: (P, G) int32 gather rows of ``b``.
      panel_vals: (P, G) values, the dtype of ``b``.
      panel_mask: (P, G) lane validity (``bool`` for the kernel).
      b:          (K, N) or (batch, K, N).
      nrows:      output rows this call owns.
      panel_ptr:  (nrows + 1,) int64 first panel per row; derived from
                  ``panel_rows`` when not given.
      units:      the rows' :class:`UnitTable` on ``b``'s device; built
                  from ``panel_ptr`` with :data:`UNIT_PANELS` when not given.
      out:        optional (batch, R, N) buffer with R >= nrows; rows
                  ``[0, nrows)`` are written, the others are left alone.
      live:       the unmasked lanes, for the operator's flop count
                  (default: every lane, P x G); nothing else reads it.
    Returns ``out``, or a new (..., nrows, N) tensor in the output dtype
    (the accumulation dtype unless ``out_dtype`` is given).  Split rows
    need a ``(slots, batch, 1, N)`` workspace in the accumulation dtype,
    allocated by the operator; an allocation that fails raises.
    """
    if b.device.type == "cpu":
        return csr_panels_spmm_plain(panel_rows, panel_cols, panel_vals,
                                     panel_mask, b, nrows=nrows,
                                     out_dtype=out_dtype, out=out)
    _check_device("csr_panels_spmm", b, panel_cols)
    b3 = _as3(b)
    _, out_dt = resolve_dtypes(panel_vals.dtype, out_dtype)
    units = _units_for(panel_rows, panel_ptr, units, nrows, UNIT_PANELS)
    _check(units, panel_cols, panel_vals, panel_mask, b3, nrows)
    o3 = _target(out, b3, nrows, out_dt)
    if not o3.is_contiguous():
        raise ValueError("out must be contiguous")
    _ops.dispatch(_OP, _launch_b1, b3, units.units, units.splits, panel_cols,
                  panel_vals, panel_mask, b3, o3, units.nslots,
                  units.max_slots, nrows, _lanes(live, panel_cols))
    if out is not None:
        return out
    return o3 if b.ndim == 3 else o3.squeeze(0)


csr_panels_spmm.launches = 0


def _check_device(name: str, b, cols) -> None:
    """A wrapper's kernel path runs on CUDA tensors, or on ``meta`` ones
    (shapes only) when the panels are on ``meta`` too."""
    if b.device.type == "cuda" or (b.device.type == "meta"
                                   and cols.device.type == "meta"):
        return
    raise ValueError(f"{name} runs on cuda or cpu tensors (or on meta "
                     f"ones, with every input there), not b on {b.device} "
                     f"and the panels on {cols.device}")


def _lanes(live: int | None, cols) -> int:
    """The operators' ``live``: the unmasked lanes, else every lane."""
    return int(cols.shape[0] * cols.shape[1]) if live is None else int(live)


def _launch_b1(units, splits, cols, vals, mask, b3, o3, nslots: int,
               max_slots: int, nrows: int, live: int) -> None:
    """The CUDA kernel of ``repro_torch::csr_panels_spmm``: B1's launch
    into ``o3``, with the second pass's workspace."""
    acc = acc_dtype_for(vals.dtype)
    ws = _workspace(nslots, b3, 1, acc)
    _launch("csr_spmm", "csr_panels_spmm", _ARGTYPES, b3.device,
            units.data_ptr(), splits.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), mask.data_ptr(), b3.data_ptr(), o3.data_ptr(),
            ws.data_ptr() if ws is not None else None, units.shape[0],
            splits.shape[0], max_slots, cols.shape[1], b3.shape[1],
            b3.shape[2], b3.shape[0], o3.shape[1],
            _build.DTYPE_CODES[vals.dtype], _build.DTYPE_CODES[o3.dtype])
    csr_panels_spmm.launches += 1


def _no_launch(*args) -> None:
    """The shape function of B1 and B2: they write into ``out``."""


def _panel_flops(units, splits, cols, vals, mask, b3, o3, *ints,
                 out_shape=None, **kwargs) -> int:
    """B1 / B2: 2 flops a column for each unmasked value, ``live`` lanes
    of Br values (Br 1 for B1)."""
    br = vals[1] if len(vals) == 3 else 1
    return 2 * ints[-1] * br * b3[0] * b3[2]


def _panel_bytes(units, splits, cols, vals, mask, b3, o3, *ints,
                 out=None) -> int:
    """B1 / B2: the tables, panels and ``b`` once, and the rows written
    (``nrows``, the next-to-last integer) of ``o3``."""
    ins = sum(_ops.nbytes(t) for t in (units, splits, cols, vals, mask, b3))
    return ins + ints[-2] * int(o3.shape[0]) * int(o3.shape[2]) \
        * int(o3.itemsize)


_OP = _ops.define(
    "csr_panels_spmm",
    "(Tensor units, Tensor splits, Tensor cols, Tensor vals, Tensor mask, "
    "Tensor b, Tensor(a!) out, int nslots, int max_slots, int nrows, "
    "int live) -> ()",
    _launch_b1, _no_launch, _panel_flops, _panel_bytes)


def _launch(source: str, symbol: str, argtypes, device, *args) -> None:
    """Call the C entry point ``symbol`` of ``csrc/<source>.cu`` with
    ``args`` and ``device``'s current stream, on that device (switching to
    it only when it is not the current one), and raise if it failed."""
    fn = _build.kernel_fn(source, symbol, argtypes)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(symbol, rc)


def _units_for(panel_rows, panel_ptr, units, ngroups: int,
               unit_panels: int) -> UnitTable:
    """The unit table a kernel call walks: ``units`` as given, else built
    at ``unit_panels`` from ``panel_ptr`` (itself derived from
    ``panel_rows`` if absent)."""
    if units is not None:
        return units
    if panel_ptr is None:
        panel_ptr = panel_ptr_of(panel_rows, ngroups)
    elif panel_ptr.dtype != torch.int64 or panel_ptr.shape != (ngroups + 1,):
        raise ValueError(f"panel_ptr must be ({ngroups + 1},) int64, got "
                         f"{tuple(panel_ptr.shape)} {panel_ptr.dtype}")
    return unit_table_of(panel_ptr, unit_panels)


def _workspace(nslots: int, b3, br: int, acc) -> torch.Tensor | None:
    """The second pass's ``(slots, batch, br, N)`` partial sums, or None
    when no group is split (the second pass does not run)."""
    if not nslots:
        return None
    return torch.empty((nslots, b3.shape[0], br, b3.shape[2]), dtype=acc,
                       device=b3.device)


def _check(units: UnitTable, cols, vals, mask, b3, ngroups: int) -> None:
    """Device, dtype, shape and contiguity checks shared by B1 and B2."""
    dev = b3.get_device()
    for name, t in (("units", units.units), ("unit splits", units.splits),
                    ("panel_cols", cols), ("panel_vals", vals),
                    ("panel_mask", mask)):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, b on {b3.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not b3.is_contiguous():
        raise ValueError("b must be contiguous")
    if units.ngroups != ngroups or units.npanels != cols.shape[0]:
        raise ValueError(f"the unit table covers {units.ngroups} groups and "
                         f"{units.npanels} panels; the call has {ngroups} "
                         f"groups and {cols.shape[0]} panels")
    if cols.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError(f"panel_cols must be int32 and panel_mask bool, "
                         f"got {cols.dtype} and {mask.dtype}")
    if mask.shape != cols.shape or vals.shape[0] != cols.shape[0] \
            or vals.shape[-1] != cols.shape[1]:
        raise ValueError(f"panel shapes disagree: cols {tuple(cols.shape)}, "
                         f"vals {tuple(vals.shape)}, mask {tuple(mask.shape)}")
    if vals.dtype not in _build.DTYPE_CODES or vals.dtype != b3.dtype:
        raise ValueError(f"panel_vals ({vals.dtype}) and b ({b3.dtype}) must "
                         f"share one of {list(_build.DTYPE_CODES)}")
    if b3.shape[0] > 65535:
        raise ValueError(f"batch {b3.shape[0]} exceeds the grid's z limit "
                         "65535")


register_kernel("csr", "spmm", "panels", csr_panels_spmm)
