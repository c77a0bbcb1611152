"""The bounded work units of B1/B2 (``kernels/csr_spmm.py::unit_table_of``)
and the two-pass product they define, on the CPU.

The CUDA kernels walk a part's panels as units of at most U panels of one
group; a longer group is split, its units' partial sums go to consecutive
workspace slots, and a second pass adds them in slot order.  Here the unit
table's invariants are held as a property over random group lengths, and
the product is rebuilt unit by unit with the plain panel functions (each
unit's panel range, split groups' partials added in slot order) and held
against the JAX reference's ``jnp`` backend and its Pallas kernels in
interpret mode.  Tolerances are the kernel tests': fp32 1e-5, fp64 1e-12
under x64 (the sums run in another order).  The kernels themselves run the
same tables on the card in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import engine as rengine
from repro.kernels.bcsr_spmm import bcsr_panels_spmm_pallas
from repro.kernels.csr_spmm import csr_panels_spmm_pallas
from repro_torch.core import formats as tf
from repro_torch.kernels import bcsr_spmm, csr_spmm, spmm_sdd

from test_torch_gpu import adversarial_cases, hub_case
from test_torch_kernels import assert_close, ref_format, to_torch, x64_if

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

DTYPES = [("float32", 1e-5), ("float64", 1e-12)]
# Forced splits (U = 1, 2, 3 panels) and each kernel's own unit size.
UNIT_SIZES = [1, 2, 3, None]


def check_table(ptr: np.ndarray, u: int, t: csr_spmm.UnitTable) -> None:
    """Every invariant the kernels rely on."""
    units = t.units.numpy()
    splits = t.splits.numpy()
    group, begin, end, slot = units.T
    ngroups = ptr.size - 1
    assert units.dtype == np.int64 and splits.dtype == np.int64
    assert (t.ngroups, t.npanels, t.unit_panels) == (ngroups, ptr[-1], u)
    # units in group order, then panel order; they tile [0, P) exactly
    assert np.all(np.diff(group) >= 0)
    assert np.array_equal(np.unique(group), np.arange(ngroups))
    assert np.all(begin[1:] == end[:-1]) and begin[0] == 0 \
        and end[-1] == ptr[-1]
    assert np.array_equal(begin[np.r_[True, np.diff(group) > 0]], ptr[:-1])
    assert np.array_equal(end[np.r_[np.diff(group) > 0, True]], ptr[1:])
    sizes = end - begin
    assert np.all(sizes >= 0) and np.all(sizes <= u)
    assert t.max_panels == sizes.max()
    # a group is split iff it has more than u panels; its units get
    # consecutive slots in panel order, the unsplit group's unit gets -1
    per_group = np.bincount(group, minlength=ngroups)
    split = per_group[group] > 1
    assert np.array_equal(split, np.diff(ptr)[group] > u)
    assert np.all(slot[~split] == -1)
    assert np.array_equal(slot[split], np.arange(int(split.sum())))
    assert t.nslots == int(split.sum())
    assert np.array_equal(splits[:, 0], np.flatnonzero(per_group > 1))
    for g, first, stop in splits:
        assert np.array_equal(slot[group == g], np.arange(first, stop))
    assert t.max_slots == (int(per_group.max()) if t.nsplit else 0)


@hypothesis.given(
    counts=st.lists(st.integers(0, 40), min_size=1, max_size=30),
    giant=st.one_of(st.none(), st.integers(100, 3000)),
    u=st.integers(1, 40))
def test_unit_table_invariants(counts, giant, u):
    """Random group lengths, with empty groups, optionally one giant group,
    at every unit size from 1."""
    if giant is not None:
        half = len(counts) // 2
        counts = counts[:half] + [giant] + counts[half:]
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    check_table(ptr, u, csr_spmm.unit_table_of(ptr, u))
    # the same table from a tensor, on the tensor's device
    t = csr_spmm.unit_table_of(torch.from_numpy(ptr), u)
    assert t.units.device.type == "cpu"
    check_table(ptr, u, t)


def test_unit_table_edges():
    # no group at all, one empty group, one group of exactly U panels
    for ptr, nunits, nsplit in (([0], 0, 0), ([0, 0], 1, 0),
                                ([0, 4], 1, 0), ([0, 5], 2, 1)):
        t = csr_spmm.unit_table_of(np.asarray(ptr, np.int64), 4)
        assert (t.nunits, t.nsplit) == (nunits, nsplit)
    with pytest.raises(ValueError, match="unit_panels"):
        csr_spmm.unit_table_of(np.zeros(2, np.int64), 0)


def test_uploaded_tables_use_each_kernels_unit_size(rng):
    fmt = tf.loops_from_csr(
        tf.csr_from_dense(adversarial_cases(rng)["empty_rows"]), 16, 8,
        panel_g=2)
    dev = fmt.on("cpu")
    for p, u in ((dev.csr, csr_spmm.UNIT_PANELS),
                 (dev.bcsr, bcsr_spmm.UNIT_PANELS)):
        assert p.units.unit_panels == u
        check_table(p.ptr.numpy(), u, p.units)


def units_product(kind, p, b, t, ngroups, br):
    """The two-pass product the kernels compute, in plain PyTorch: pass 1
    runs the plain panel function on each unit's panel range and keeps the
    group's Br rows (into the output, or into the unit's slot); pass 2
    adds each split group's slots in slot order."""
    plain = (csr_spmm.csr_panels_spmm_plain if kind == "csr"
             else bcsr_spmm.bcsr_panels_spmm_plain)
    kw = {"nrows": ngroups} if kind == "csr" else {"nblocks": ngroups}
    b3 = b if b.ndim == 3 else b[None]
    out = torch.full((b3.shape[0], ngroups * br, b3.shape[-1]), float("nan"),
                     dtype=b.dtype)
    ws = torch.full((t.nslots, b3.shape[0], br, b3.shape[-1]), float("nan"),
                    dtype=b.dtype)
    for g, lo, hi, slot in t.units.tolist():
        y = plain(p.rows[lo:hi], p.cols[lo:hi], p.vals[lo:hi], p.mask[lo:hi],
                  b3, **kw)[:, g * br:(g + 1) * br]
        if slot < 0:
            out[:, g * br:(g + 1) * br] = y
        else:
            ws[slot] = y
    for g, first, stop in t.splits.tolist():
        acc = ws[first].clone()
        for s in range(first + 1, stop):
            acc += ws[s]
        out[:, g * br:(g + 1) * br] = acc
    assert not out.isnan().any(), "a row was not written"
    return out if b.ndim == 3 else out[0]


def cases(rng):
    out = dict(adversarial_cases(rng))
    out["hub"] = hub_case(rng, 200)
    return out


@pytest.mark.parametrize("u", UNIT_SIZES)
@pytest.mark.parametrize("dname,tol", DTYPES)
def test_csr_units_product_matches_reference(rng, dname, tol, u):
    """B1's two passes against the reference's jnp backend and its Pallas
    kernel (interpret mode)."""
    with x64_if(dname):
        for name, a in cases(rng).items():
            m, k = a.shape
            g = 1 if name == "hub" else 3
            fr = ref_format(a, dname, m, 8, g)
            fp = tf.loops_from_csr(tf.csr_from_dense(a), m, 8, panel_g=g)
            p = fp.on("cpu").csr
            p = dataclasses.replace(p, vals=p.vals.to(getattr(torch, dname)))
            t = p.units if u is None else csr_spmm.unit_table_of(p.ptr, u)
            if name == "hub" and u is not None:
                assert t.nsplit and t.max_slots >= 50
            b = jnp.asarray(rng.standard_normal((2, k, 8)),
                            getattr(jnp, dname))
            got = units_product("csr", p, to_torch(np.asarray(b)), t, m, 1)
            want = rengine.csr_spmm(fr.csr_part, b, backend="jnp")
            assert_close(got, want, tol, f"{name} jnp")
            rp = fr.csr_panels
            want = csr_panels_spmm_pallas(
                jnp.asarray(rp.panel_rows), jnp.asarray(rp.panel_cols),
                jnp.asarray(rp.panel_vals), jnp.asarray(rp.panel_mask), b,
                nrows=m, interpret=True)
            assert_close(got, want, tol, f"{name} pallas")


@pytest.mark.parametrize("u", UNIT_SIZES)
@pytest.mark.parametrize("dname,tol", DTYPES)
def test_bcsr_units_product_matches_reference(rng, dname, tol, u):
    """B2's two passes against the reference's jnp backend and its Pallas
    kernel (interpret mode), Br = 4."""
    with x64_if(dname):
        for name, a in cases(rng).items():
            m, k = a.shape
            g = 1 if name == "hub" else 3
            fr = ref_format(a, dname, 0, 4, g)
            fp = tf.loops_from_csr(tf.csr_from_dense(a), 0, 4, panel_g=g)
            p = fp.on("cpu").bcsr
            p = dataclasses.replace(p, vals=p.vals.to(getattr(torch, dname)))
            t = p.units if u is None else csr_spmm.unit_table_of(p.ptr, u)
            if name == "hub" and u is not None:
                assert t.nsplit and t.max_slots >= 50
            nb = fp.bcsr_part.nblocks
            b = jnp.asarray(rng.standard_normal((k, 8)), getattr(jnp, dname))
            got = units_product("bcsr", p, to_torch(np.asarray(b)), t, nb, 4)
            want = rengine.bcsr_spmm(fr.bcsr_part, b, backend="jnp")
            assert_close(got[:m], want, tol, f"{name} jnp")
            rp = fr.bcsr_panels
            want = bcsr_panels_spmm_pallas(
                jnp.asarray(rp.panel_rows), jnp.asarray(rp.panel_cols),
                jnp.asarray(rp.panel_vals), jnp.asarray(rp.panel_mask), b,
                nblocks=rp.nblocks, interpret=True)
            assert_close(got, want, tol, f"{name} pallas")


def test_wrapper_helpers(rng):
    """The wrapper derives a table at its kernel's U when given none, checks
    a given ``panel_ptr``, and sizes the workspace to the split slots."""
    fp = tf.loops_from_csr(tf.csr_from_dense(hub_case(rng, 200)), 4, 8,
                           panel_g=1)
    p = fp.on("cpu").csr
    t = csr_spmm._units_for(p.rows, None, None, 4, 3)
    assert t.unit_panels == 3 and t.nsplit
    assert csr_spmm._units_for(p.rows, p.ptr, p.units, 4, 3) is p.units
    with pytest.raises(ValueError, match="panel_ptr"):
        csr_spmm._units_for(p.rows, p.ptr.int(), None, 4, 3)
    b3 = torch.zeros((3, 200, 40))
    ws = csr_spmm._workspace(t, b3, 8, torch.float32)
    assert ws.shape == (t.nslots, 3, 8, 40) and ws.dtype == torch.float32
    unsplit = csr_spmm.unit_table_of(p.ptr, 10_000)
    assert unsplit.nslots == 0
    assert csr_spmm._workspace(unsplit, b3, 1, torch.float32) is None


@pytest.mark.parametrize("br", [4, 8, 16])
def test_sdd_unit_table_covers_every_panel_once(rng, br):
    """B4's grid is one CTA a unit of the forward's B2 table (or of the
    table built from the panel rows when none is given): every panel lies
    in exactly one unit and every unit holds panels of one block-row; a
    table of other panels or of another block-row count is refused, and on
    CPU tensors the wrapper runs the plain version whatever table it is
    given."""
    a = hub_case(rng, 700)
    fmt = tf.loops_from_csr(tf.csr_from_dense(a), 4, br, panel_g=5)
    p = fmt.on("cpu").bcsr
    nblocks = fmt.bcsr_part.nblocks
    assert nblocks == -(-(fmt.nrows - fmt.r_boundary) // br)
    rows = p.rows.numpy()
    built = spmm_sdd.sdd_unit_table(p.rows, nblocks)
    assert built.unit_panels == bcsr_spmm.UNIT_PANELS
    assert spmm_sdd.sdd_unit_table(p.rows, nblocks, p.units) is p.units
    for t in (built, p.units, csr_spmm.unit_table_of(p.ptr, 3)):
        group, begin, end, _ = t.units.numpy().T
        walked = np.concatenate([np.arange(s, e) for s, e in
                                 zip(begin, end)])
        assert np.array_equal(walked, np.arange(rows.size))
        for blk, s, e in zip(group, begin, end):
            assert np.all(rows[s:e] == blk)
    assert np.bincount(built.units[:, 0].numpy()).max() > 1
    assert spmm_sdd.sdd_unit_table(p.rows[:0], 0).nunits == 0
    with pytest.raises(ValueError, match="covers"):
        spmm_sdd.sdd_unit_table(p.rows[:-1], nblocks, p.units)
    # Equal panels, other block-rows: the panels of the last block-row
    # moved into one more, empty before.
    moved = p.rows.clone()
    moved[moved == nblocks - 1] = nblocks
    other = csr_spmm.unit_table_of(
        csr_spmm.panel_ptr_of(moved, nblocks + 1), bcsr_spmm.UNIT_PANELS)
    assert other.npanels == p.units.npanels
    with pytest.raises(ValueError, match="block-rows"):
        spmm_sdd.sdd_unit_table(p.rows, nblocks, other)
    b = torch.randn((3, a.shape[1], 40), dtype=torch.float64)
    dy = torch.randn((3, fmt.nrows, 40), dtype=torch.float64)
    kw = {"br": br, "row_offset": fmt.r_boundary,
          "nrows": fmt.nrows - fmt.r_boundary}
    want = spmm_sdd.bcsr_sdd_panels_plain(p.rows, p.cols, p.mask, dy, b, **kw)
    got = spmm_sdd.bcsr_sdd_panels(p.rows, p.cols, p.mask, dy, b,
                                   units=csr_spmm.unit_table_of(p.ptr, 3),
                                   **kw)
    assert torch.equal(got, want)
