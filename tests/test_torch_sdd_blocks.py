"""B3's block table (``kernels/spmm_sdd.py::sdd_block_table``) and the
value gradient it defines, on the CPU.

The CUDA kernel ``csrc/csr_sdd.cu`` walks a CSR part's panel slots as
blocks, one CTA a block: staged blocks (consecutive rows x a band of the
columns they share, whose B rows are staged once) and direct blocks (a range
of whole panels, such as a hub row's).  Here the table's invariants are held
on the adversarial panel cases, the sparse FFN's shape at a small size, a
hub row longer than a block and a band at its distinct-column cap, and a
plain walk of the table (each block's outputs gathered through their slots)
is held against ``csr_sdd_panels_plain`` and a dense numpy product: fp64 at
1e-12, fp32 at 1e-5 of max(1, max |want|), the kernel tests' tolerances (the
sums run in another order).  The kernel itself runs the same tables on the
card in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as tf
from repro_torch.kernels import spmm_sdd
from repro_torch.kernels.engine import acc_dtype_for

from test_torch_gpu import adversarial_cases, hub_case, sdd_block_case

# Caps small enough that the small cases cut into many blocks of both
# kinds and hit every cap ("default": the module's own).
SMALL = {"block_rows": 8, "block_outs": 24, "block_cols": 8,
         "direct_outs": 16, "reuse": 1.5}
CAPS = {"default": {}, "small": SMALL}


def _ffn_like(rng):
    """The sparse FFN's CSR part at a small size: 10% of a 192 x 512
    weight, every row about as long as the others."""
    return (rng.random((192, 512)) < 0.1) * rng.standard_normal((192, 512))


def cases(rng):
    """``{name: (dense matrix, CSR-part rows)}``."""
    out = {name: (a, a.shape[0]) for name, a in adversarial_cases(rng).items()}
    out["ffn_like"] = (_ffn_like(rng), 192)
    out["hub_row"] = (hub_case(rng, 700), 64)
    out["three_groups"] = (sdd_block_case(rng), 192)
    return out


def csr_panels(a, rows, g):
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), rows, 8, panel_g=g)
    return fmt.on("cpu").csr


def table_of(p, caps):
    return spmm_sdd.sdd_block_table(p.rows, p.cols, p.mask, **caps)


def check_table(p, t, caps) -> None:
    """Every invariant the kernel relies on."""
    block_rows = caps.get("block_rows", spmm_sdd.BLOCK_ROWS)
    block_outs = caps.get("block_outs", spmm_sdd.BLOCK_OUTS)
    block_cols = caps.get("block_cols", spmm_sdd.BLOCK_COLS)
    direct_outs = caps.get("direct_outs", spmm_sdd.DIRECT_OUTS)
    rows = p.rows.numpy().astype(np.int64)
    cols = p.cols.numpy().reshape(-1)
    live = p.mask.numpy().reshape(-1)
    npanels, g = p.cols.shape
    blocks = t.blocks.numpy()
    outs, info, dcols = t.outs.numpy(), t.info.numpy(), t.cols.numpy()
    assert blocks.dtype == np.int64 and blocks.shape[1] == 8
    assert outs.dtype == info.dtype == dcols.dtype == np.int32
    assert (t.npanels, t.g) == (npanels, g)
    kind = blocks[:, 0]
    assert set(kind.tolist()) <= {spmm_sdd.STAGED, spmm_sdd.DIRECT}
    assert (t.nstaged, t.ndirect) == ((kind == spmm_sdd.STAGED).sum(),
                                      (kind == spmm_sdd.DIRECT).sum())
    # staged blocks first, each kind largest first
    assert np.all(np.diff(kind) >= 0)
    for kd in (spmm_sdd.STAGED, spmm_sdd.DIRECT):
        assert np.all(np.diff(blocks[kind == kd, 2]) <= 0)
    seen = np.zeros(npanels * g, np.int64)
    step = max(g, direct_outs // g * g)
    for kd, first, count, col0, ncol, row0, nrow, pad in blocks.tolist():
        assert count >= 1 and pad == 0
        if kd == spmm_sdd.DIRECT:
            assert (col0, ncol, row0, nrow) == (0, 0, 0, 0)
            assert first % g == 0 and count % g == 0 and count <= step
            seen[first:first + count] += 1
            continue
        flat = outs[first:first + count].astype(np.int64)
        x = info[first:first + count]
        seen[flat] += 1
        bcols = dcols[col0:col0 + ncol]
        # the column list is sorted, unique and within its cap
        assert np.all(np.diff(bcols) > 0) and ncol <= block_cols
        # masked lanes carry -1, live ones their dY row and column slot
        assert np.array_equal(x < 0, ~live[flat])
        xl = x[x >= 0]
        slot, lrow = xl & 0xffff, xl >> 16
        assert np.all(slot < ncol)
        assert np.array_equal(bcols[slot], cols[flat[x >= 0]])
        assert np.array_equal(row0 + lrow, rows[flat[x >= 0] // g])
        assert np.all(rows[flat // g] - row0 < nrow) and nrow <= block_rows
        assert np.all(rows[flat // g] // block_rows == row0 // block_rows)
        # one pair (a column, or the masked lanes) may overrun the cap
        assert count <= block_outs or ncol <= 1
        # outputs in (row, column) order: a group reads a dY row once
        key = rows[flat // g] * (cols.max() + 2) + np.where(
            live[flat], cols[flat], cols.max() + 1)
        assert np.all(np.diff(key) >= 0)
    assert np.all(seen == 1), "a panel slot is in no block or in two"
    staged = blocks[kind == spmm_sdd.STAGED]
    assert t.max_rows == (staged[:, 6].max() if staged.size else 0)
    assert t.max_cols == (staged[:, 4].max() if staged.size else 0)


def walk(t, rows, cols, mask, dy, b) -> torch.Tensor:
    """B3 by the table: each block's outputs gathered through their slots
    (staged) or their panel slots (direct), 0 at masked lanes."""
    dy3, b3 = (dy[None], b[None]) if b.ndim == 2 else (dy, b)
    acc = acc_dtype_for(b.dtype)
    npanels, g = cols.shape
    out = torch.full((npanels * g,), float("nan"), dtype=acc)
    for kd, first, count, col0, ncol, row0, _, _ in t.blocks.tolist():
        if kd == spmm_sdd.STAGED:
            flat = t.outs[first:first + count].long()
            x = t.info[first:first + count].long()
            src_row = row0 + (x >> 16).clamp(min=0)
            src_col = t.cols[col0:col0 + max(ncol, 1)].long()[
                (x & 0xffff).clamp(max=max(ncol - 1, 0))] if ncol else x * 0
        else:
            flat = torch.arange(first, first + count)
            x = mask.reshape(-1)[flat].long() - 1
            src_row = rows.long()[flat // g]
            src_col = cols.reshape(-1).long()[flat]
        got = (dy3[:, src_row].to(acc) * b3[:, src_col].to(acc)).sum((0, -1))
        out[flat] = torch.where(x >= 0, got, torch.zeros((), dtype=acc))
    return out.view(npanels, g)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("g", [1, 3, 8])
def test_block_table_invariants(rng, caps, g):
    for name, (a, rows) in cases(rng).items():
        p = csr_panels(a, rows, g)
        check_table(p, table_of(p, CAPS[caps]), CAPS[caps])


def test_block_table_kinds_and_caps(rng):
    """The sparse FFN's shape is staged only; a hub row is cut across
    direct blocks; rows whose columns all hold two values give a band at
    the distinct-column cap; one table holds both kinds."""
    p = csr_panels(_ffn_like(rng), 192, 8)
    t = p.sdd_blocks
    assert t.ndirect == 0 and t.nstaged > 1
    assert p.sdd_blocks is t           # built once per part and kept
    a = sdd_block_case(rng)
    p = csr_panels(a, 192, 8)
    t = p.sdd_blocks
    blocks = t.blocks.numpy()
    assert t.nstaged and t.ndirect
    assert t.max_cols == spmm_sdd.BLOCK_COLS
    hub = np.flatnonzero(p.rows.numpy() == 64)     # the hub row's panels
    direct = blocks[blocks[:, 0] == spmm_sdd.DIRECT]
    inside = (direct[:, 1] < (hub[-1] + 1) * 8) \
        & (direct[:, 1] + direct[:, 2] > hub[0] * 8)
    assert inside.sum() >= a.shape[1] // spmm_sdd.DIRECT_OUTS
    small = table_of(p, SMALL)
    assert small.max_cols == SMALL["block_cols"]
    assert small.max_rows == SMALL["block_rows"]
    # a group is staged at BLOCK_REUSE values a distinct column, not below
    rows = torch.tensor([0, 1], dtype=torch.int32)
    mask = torch.ones((2, 8), dtype=torch.bool)
    for last, kind in ((7, spmm_sdd.STAGED), (9, spmm_sdd.DIRECT)):
        cols = torch.tensor([list(range(8)), list(range(7)) + [last]],
                            dtype=torch.int32)
        t = spmm_sdd.sdd_block_table(rows, cols, mask, reuse=2.0)
        assert t.blocks[:, 0].tolist() == [kind]


def test_block_table_empty_and_bcsr():
    empty = spmm_sdd.sdd_block_table(
        torch.zeros(0, dtype=torch.int32), torch.zeros((0, 8),
                                                       dtype=torch.int32),
        torch.zeros((0, 8), dtype=torch.bool))
    assert empty.nblocks == 0 and empty.blocks.shape == (0, 8)
    assert (empty.outs.numel(), empty.cols.numel()) == (0, 0)
    assert (empty.max_rows, empty.max_cols) == (0, 0)
    fmt = tf.loops_from_csr(tf.csr_from_dense(np.eye(16)), 8, 4, panel_g=2)
    with pytest.raises(ValueError):
        fmt.on("cpu").bcsr.sdd_blocks
    with pytest.raises(ValueError):
        spmm_sdd.sdd_block_table(torch.tensor([1, 0], dtype=torch.int32),
                                 torch.zeros((2, 2), dtype=torch.int32),
                                 torch.ones((2, 2), dtype=torch.bool))


@pytest.mark.parametrize("n", [1, 33, 1000])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dname,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
def test_block_walk_matches_plain(rng, n, batch, dname, tol):
    """The table's walk equals the plain version and a dense product, for
    N not a multiple of any line (1, 33, 1000) and batches 1 and 3."""
    dt = getattr(torch, dname)
    for name, (a, rows) in cases(rng).items():
        if n == 1000 and name not in ("three_groups", "hub_row"):
            continue
        p = csr_panels(a, rows, 8)
        b = torch.as_tensor(rng.standard_normal((batch, a.shape[1], n)),
                            dtype=dt)
        dy = torch.as_tensor(rng.standard_normal((batch, a.shape[0], n)),
                             dtype=dt)
        want = spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask, dy, b)
        # dense: sum over the batch of dY · Bᵀ, read at the panel slots
        full = np.einsum("zmn,zkn->mk", dy.double().numpy(),
                         b.double().numpy())
        dense = np.where(p.mask.numpy(), full[p.rows.numpy()[:, None],
                                              p.cols.numpy()], 0.0)
        scale = max(1.0, float(want.abs().max()))
        for caps in CAPS.values():
            got = walk(table_of(p, caps), p.rows, p.cols, p.mask, dy, b)
            assert got.dtype == want.dtype
            assert not got[~p.mask].any()
            err = float((got.double() - want.double()).abs().max())
            assert err <= tol * scale, (name, caps, err)
            err = float(np.abs(got.double().numpy() - dense).max())
            assert err <= tol * scale, (name, caps, err)


def test_wrapper_takes_the_table_and_runs_plain_on_cpu(rng):
    """On a CPU tensor the wrapper runs the plain version whatever table
    it is given; the engine's backward reads the part's kept table."""
    a = _ffn_like(rng)
    p = csr_panels(a, 192, 8)
    b = torch.as_tensor(rng.standard_normal((2, 512, 9)))
    dy = torch.as_tensor(rng.standard_normal((2, 192, 9)))
    want = spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask, dy, b)
    launches = spmm_sdd.csr_sdd_panels.launches
    got = spmm_sdd.csr_sdd_panels(p.rows, p.cols, p.mask, dy, b,
                                  blocks=p.sdd_blocks)
    assert torch.equal(got, want)
    assert spmm_sdd.csr_sdd_panels.launches == launches
