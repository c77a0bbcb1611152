"""Host-side parity of the PyTorch port (``repro_torch``) with the JAX
reference (``repro``): the synthetic suite, validated ingestion, Algorithm 1
and the panel packing are array-equal; the plan, partition and performance
model give the same numbers."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import partition as rpart
from repro.core import perf_model as rpm
from repro.core import spmm as rspmm
from repro.core import suite as rsuite
from repro.resilience import validate as rval
from repro_torch.core import formats as tf
from repro_torch.core import partition as tpart
from repro_torch.core import perf_model as tpm
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.resilience import validate as tval

from test_torch_gpu import adversarial_cases

SUITE_IDS = sorted(rsuite.TABLE2_STATS, key=lambda s: int(s[1:]))
PARITY_IDS = ["m4", "m6", "m8", "m10", "m12", "m13"]
GS = (1, 3, 8)
MACROS = (1, 2)
BRS = (4, 8, 16)


def assert_same(ref, port, path="") -> None:
    """Array-equal (dtype included) over the numpy fields of two format
    objects of the two packages."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f"{path}{f.name}: {a.dtype} {b.dtype}"
            np.testing.assert_array_equal(a, b, err_msg=path + f.name)
        elif dataclasses.is_dataclass(a):
            assert_same(a, b, f"{path}{f.name}.")
        else:
            assert a == b, f"{path}{f.name}: {a!r} != {b!r}"


def assert_loops_equal(csr_ref, csr_port, r_b, br) -> None:
    """Algorithm 1 and every (G, macro_m) panel packing agree."""
    for g in GS:
        for m in MACROS:
            fr = rf.loops_from_csr(csr_ref, r_b, br, panel_g=g, macro_m=m)
            fp = tf.loops_from_csr(csr_port, r_b, br, panel_g=g, macro_m=m)
            assert_same(fr, fp)
            assert fr.panel_g_eff == fp.panel_g_eff and fr.nnz == fp.nnz
            assert_same(fr.csr_panels, fp.csr_panels, f"g{g}m{m}.csr.")
            assert_same(fr.bcsr_panels, fp.bcsr_panels, f"g{g}m{m}.bcsr.")


@pytest.mark.parametrize("mid", SUITE_IDS)
def test_suite_is_byte_identical(mid):
    a = rsuite.table2_like(mid, scale_rows=256, seed=3)
    b = tsuite.table2_like(mid, scale_rows=256, seed=3)
    assert_same(a, b)


def test_suite_generators_byte_identical():
    for name, kw in (("uniform", dict(nrows=50, ncols=40, density=0.1)),
                     ("banded", dict(nrows=60, ncols=60, bandwidth=3,
                                     fill=0.7)),
                     ("powerlaw", dict(nrows=90, ncols=70, mean_nnz=5.0)),
                     ("block_dense", dict(nrows=64, ncols=64, block=8,
                                          block_density=0.2))):
        for dtype in (np.float32, np.float64):
            assert_same(getattr(rsuite, name)(seed=5, dtype=dtype, **kw),
                        getattr(tsuite, name)(seed=5, dtype=dtype, **kw))
    assert_same(rsuite.gcn_graph(300, 5, seed=2),
                tsuite.gcn_graph(300, 5, seed=2))


@pytest.mark.parametrize("br", BRS)
@pytest.mark.parametrize("mid", PARITY_IDS)
def test_loops_format_parity_suite(mid, br):
    csr_r = rsuite.table2_like(mid, scale_rows=512, seed=1)
    csr_p = tsuite.table2_like(mid, scale_rows=512, seed=1)
    r_b = (csr_r.nrows // 3) // br * br
    assert_loops_equal(csr_r, csr_p, r_b, br)


@pytest.mark.parametrize("br", BRS)
@pytest.mark.parametrize("case", sorted(adversarial_cases(
    np.random.default_rng(0))))
def test_loops_format_parity_adversarial(case, br):
    a = adversarial_cases(np.random.default_rng(0))[case]
    for dtype in (np.float32, np.float64):
        csr_r = rf.csr_from_dense(a.astype(dtype))
        csr_p = tf.csr_from_dense(a.astype(dtype))
        assert_same(csr_r, csr_p)
        m = a.shape[0]
        for r_b in sorted({0, (m // 2) // br * br, m // 2, m}):
            assert_loops_equal(csr_r, csr_p, r_b, br)


def test_empty_matrix_and_empty_rows():
    for shape in ((7, 5), (0, 4), (3, 0)):
        z = np.zeros(shape, np.float32)
        csr_r, csr_p = rf.csr_from_dense(z), tf.csr_from_dense(z)
        assert_same(csr_r, csr_p)
        if shape[1]:
            assert_loops_equal(csr_r, csr_p, 0, 8)
    # A CSR whose first row pointer is not 0 (a row slice) keeps its
    # entries through the empty-row padding.
    a = np.zeros((6, 5), np.float32)
    a[1, 2], a[4, 0], a[4, 3] = 1.0, 2.0, 3.0
    full_r, full_p = rf.csr_from_dense(a), tf.csr_from_dense(a)
    assert_same(rf.csr_slice_rows(full_r, 1, 5),
                tf.csr_slice_rows(full_p, 1, 5))
    assert_same(rf.bcsr_from_csr_rows(full_r, 1, 6, 4),
                tf.bcsr_from_csr_rows(full_p, 1, 6, 4))


def test_csr_from_coo_coalesces_like_reference():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 30, 400)
    cols = rng.integers(0, 20, 400)
    vals = rng.standard_normal(400).astype(np.float32)
    assert_same(rf.csr_from_coo(rows, cols, vals, (30, 20)),
                tf.csr_from_coo(rows, cols, vals, (30, 20)))
    np.testing.assert_array_equal(
        rf.csr_to_dense(rf.csr_from_coo(rows, cols, vals, (30, 20))),
        tf.csr_to_dense(tf.csr_from_coo(rows, cols, vals, (30, 20))))


BAD_COO = {
    "negative-index": ([0, -1], [0, 1], [1.0, 2.0]),
    "out-of-range-index": ([0, 5], [0, 1], [1.0, 2.0]),
    "nonfinite-value": ([0, 1], [0, 1], [1.0, np.nan]),
}


@pytest.mark.parametrize("kind", sorted(BAD_COO))
def test_coo_validation_parity(kind):
    rows, cols, vals = (np.asarray(x) for x in BAD_COO[kind])
    with pytest.raises(rval.SparseInputError) as er:
        rf.csr_from_coo(rows, cols, vals, (4, 3))
    with pytest.raises(tval.SparseInputError) as ep:
        tf.csr_from_coo(rows, cols, vals, (4, 3))
    assert er.value.kind == ep.value.kind == kind
    for mode in ("drop", "clip"):
        assert_same(rf.csr_from_coo(rows, cols, vals, (4, 3), validate=mode),
                    tf.csr_from_coo(rows, cols, vals, (4, 3), validate=mode))


def test_csr_validation_parity():
    good_r = rf.csr_from_dense(np.eye(4, dtype=np.float32))
    good_p = tf.csr_from_dense(np.eye(4, dtype=np.float32))
    broken = {
        "nonmonotone-indptr": dict(row_ptr=np.array([0, 2, 1, 3, 4],
                                                    np.int32)),
        "out-of-range-index": dict(col_idx=np.array([0, 1, 9, 3], np.int32)),
        "nonfinite-value": dict(vals=np.array([1, np.inf, 1, 1],
                                              np.float32)),
        "shape-mismatch": dict(row_ptr=np.array([0, 4], np.int32)),
    }
    before = dict(tval.repair_counts)
    for kind, change in broken.items():
        bad_r = dataclasses.replace(good_r, **change)
        bad_p = dataclasses.replace(good_p, **change)
        with pytest.raises(rval.SparseInputError) as er:
            rval.validate_csr(bad_r)
        with pytest.raises(tval.SparseInputError) as ep:
            tval.validate_csr(bad_p)
        assert er.value.kind == ep.value.kind == kind
        with pytest.raises(tval.SparseInputError):
            tspmm.plan_and_convert(bad_p, device="cpu")
        if kind != "shape-mismatch":
            for mode in ("drop", "clip"):
                fixed_r, rep_r = rval.validate_csr(bad_r, repair=mode)
                fixed_p, rep_p = tval.validate_csr(bad_p, repair=mode)
                assert_same(fixed_r, fixed_p)
                assert dataclasses.asdict(rep_r) == dataclasses.asdict(rep_p)
    assert sum(tval.repair_counts.values()) > sum(before.values())


@pytest.mark.parametrize("mid", PARITY_IDS)
def test_plan_and_convert_parity(mid):
    csr_r = rsuite.table2_like(mid, scale_rows=300, seed=2)
    csr_p = tsuite.table2_like(mid, scale_rows=300, seed=2)
    for kw in ({}, {"total_workers": 4}, {"paper_literal": True},
               {"panel_g": 3, "macro_m": 2, "pipeline_depth": 2}):
        fr, pr = rspmm.plan_and_convert(csr_r, **kw)
        fp, pp = tspmm.plan_and_convert(csr_p, device="cpu", **kw)
        assert dataclasses.asdict(pr) == dataclasses.asdict(pp)
        assert_same(fr, fp)
        assert_same(fr.bcsr_panels, fp.bcsr_panels)
    half = csr_p.astype(np.float16)
    _, plan = tspmm.plan_and_convert(half, device="cpu")
    assert plan.br == 16 and plan.r_boundary % 16 == 0


def test_loops_format_from_arrays_round_trip():
    csr_r = rsuite.table2_like("m13", scale_rows=200, seed=0)
    fr, _ = rspmm.plan_and_convert(csr_r, panel_g=4, macro_m=2)
    arrays = dict(
        csr_row_ptr=fr.csr_part.row_ptr, csr_col_idx=fr.csr_part.col_idx,
        csr_vals=fr.csr_part.vals, tile_rows=fr.bcsr_part.tile_rows,
        tile_cols=fr.bcsr_part.tile_cols, tile_vals=fr.bcsr_part.tile_vals,
        block_ptr=fr.bcsr_part.block_ptr, r_boundary=fr.r_boundary,
        shape=fr.shape, panel_g=fr.panel_g, macro_m=fr.macro_m,
        pipeline_depth=fr.pipeline_depth)
    fp = tf.loops_format_from_arrays(arrays)
    assert_same(fr, fp)
    assert_same(fr.csr_panels, fp.csr_panels)
    assert_same(fr.bcsr_panels, fp.bcsr_panels)


def test_device_residency_cpu():
    csr = tsuite.table2_like("m10", scale_rows=200, seed=0)
    fmt, _ = tspmm.plan_and_convert(csr, device="cpu", panel_g=3)
    dev = fmt.on("cpu")
    assert fmt.on(torch.device("cpu")) is dev          # uploaded once
    for panels, dp, ngroups in ((fmt.csr_panels, dev.csr, fmt.r_boundary),
                                (fmt.bcsr_panels, dev.bcsr,
                                 fmt.bcsr_part.nblocks)):
        ptr = np.searchsorted(panels.panel_rows, np.arange(ngroups + 1))
        np.testing.assert_array_equal(dp.ptr.numpy(), ptr)
        assert dp.ptr.dtype == torch.int64 and dp.ngroups == ngroups
        assert dp.mask.dtype == torch.bool
        np.testing.assert_array_equal(dp.mask.numpy(),
                                      panels.panel_mask != 0)
        np.testing.assert_array_equal(dp.cols.numpy(), panels.panel_cols)
        np.testing.assert_array_equal(dp.vals.numpy(), panels.panel_vals)
        # every group owns >= 1 panel: each output row is written
        assert (np.diff(ptr) >= 1).all()
    assert fmt.astype(np.float64).on("cpu").csr.vals.dtype == torch.float64


def test_partition_parity():
    for mid in PARITY_IDS:
        csr_r = rsuite.table2_like(mid, scale_rows=400, seed=0)
        csr_p = tsuite.table2_like(mid, scale_rows=400, seed=0)
        assert (dataclasses.asdict(rpart.row_stats(csr_r))
                == dataclasses.asdict(tpart.row_stats(csr_p)))
        for br in (4, 8, 16):
            assert (rpart.regularity_boundary(csr_r, br=br)
                    == tpart.regularity_boundary(csr_p, br=br))
    for args in [(1000, 1.0, 4.0, 2, 6), (37, 2.0, 1.0, 3, 1),
                 (64, 1.0, 1.0, 0, 4), (64, 1.0, 1.0, 4, 0)]:
        for lit in (False, True):
            assert (rpart.choose_r_boundary(*args, paper_literal=lit)
                    == tpart.choose_r_boundary(*args, paper_literal=lit))


def test_perf_model_parity():
    rng = np.random.default_rng(7)
    samples = [(x, y) for x in range(5) for y in range(5) if x + y]
    perfs = rng.random(len(samples))
    mr = rpm.fit_perf_model(samples, perfs)
    mp = tpm.fit_perf_model(samples, perfs)
    np.testing.assert_array_equal(mr.coef, mp.coef)
    assert mr.best_allocation(8) == mp.best_allocation(8)
    s3 = [(x, y, g) for (x, y) in samples[:6] for g in (1, 4, 8)]
    p3 = rng.random(len(s3))
    mr3 = rpm.fit_perf_model(s3, p3, ridge=1e-3)
    mp3 = tpm.fit_perf_model(s3, p3, ridge=1e-3)
    np.testing.assert_array_equal(mr3.coef, mp3.coef)
    assert mr3.best_allocation_g(8) == mp3.best_allocation_g(8)

    def measure(x, y):
        return 1.0 + x + 2 * y - 0.1 * x * x - 0.2 * y * y
    assert (rpm.calibrate(measure, 8).best_allocation(8)
            == tpm.calibrate(measure, 8).best_allocation(8))
    assert rpm.best_allocation(measure, 6) == tpm.best_allocation(measure, 6)
