"""The port's benchmark suites on the CPU against the reference's inputs:
§4.3's regimes are the reference's matrices at 768 rows and keep their
nonzeros per row when scaled; the quickstart's plan equals the
reference's; Table 4's row holds its loss and gradient checks; the
benchmarks run on the card unless the caller asks for the CPU."""
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import perf_model as rpm
from repro.core import spmm as rspmm
from repro.core import suite as rsuite
from repro_torch.core import formats as tf
from repro_torch.core import perf_model as tpm
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite

from test_torch_formats import assert_same


@pytest.mark.parametrize("name", ["banded", "powerlaw", "block", "uniform",
                                  "hypersparse"])
def test_sec43_regimes_equal_reference_at_768_rows(name):
    from benchmarks import sec43_scheduling as rs
    from repro_torch.benchmarks import sec43_scheduling as ts
    want = dict(rs.CASES)[name]()
    got = ts.case(name)
    assert_same(want, got)
    big = ts.case(name, 4 * ts.ROWS)
    if name != "powerlaw":   # it keeps its parameter, 8 a row; a sample
        # of 768 heavy-tailed rows lies below that (5.3 a row)
        per_row = want.nnz / want.nrows
        assert big.nnz / big.nrows == pytest.approx(per_row, rel=0.2)


def test_quickstart_plan_equals_reference():
    """examples/quickstart_torch.py's steps give the reference
    quickstart's plan and format, and its checks pass on the CPU."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "quickstart_torch.py")
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    qs.main("cpu")

    def probe(x, y):
        return 1.0 * x + 4.0 * min(y, 2) + 0.3 * max(y - 2, 0)
    top = rf.csr_to_dense(rsuite.powerlaw(256, 1024, 12.0, seed=0))
    bot = rf.csr_to_dense(rsuite.banded(768, 1024, 5, seed=1))
    dense = np.concatenate([top, bot], axis=0).astype(np.float32)
    fr, pr = rspmm.plan_and_convert(rf.csr_from_dense(dense),
                                    total_workers=8,
                                    model=rpm.calibrate(probe, total=8))
    fp, pp = tspmm.plan_and_convert(tf.csr_from_dense(dense),
                                    total_workers=8,
                                    model=tpm.calibrate(probe, total=8),
                                    device="cpu")
    assert (pp.r_boundary, pp.t_vpu, pp.t_mxu, pp.br) == \
        (pr.r_boundary, pr.t_vpu, pr.t_mxu, pr.br)
    assert tspmm.loops_grid_steps(fp, 32) == rspmm.loops_grid_steps(fr, 32)


def test_table4_row_on_the_cpu():
    """One Table 4 graph on the CPU: the loss parity and the train step's
    gradient check (its 256-node replica) hold, the dense column fits."""
    from repro_torch.benchmarks import table4_gnn
    res = table4_gnn.run_graph(*table4_gnn.GRAPHS[1],
                               rng=np.random.default_rng(0), device="cpu",
                               repeats=1)
    assert res["loss_parity"] < table4_gnn.LOSS_TOL
    assert res["train_grad_err"] <= table4_gnn.GRAD_TOL
    assert res["train_nodes"] == table4_gnn.TRAIN_STEP_NODES
    assert res["grad_oracle"] == "dense" and res["times"]["dense"] > 0


def test_dense_baseline_refuses_over_budget():
    from repro_torch.benchmarks import _util
    csr = tsuite.table2_like("m6", scale_rows=512, seed=3)
    a, why = _util.dense_operand(csr, "cpu", budget=1000)
    assert a is None and "budget" in why
    a, why = _util.dense_operand(csr, "cpu")
    assert why == "" and torch.equal(
        a, torch.as_tensor(tf.csr_to_dense(csr)))


@pytest.mark.parametrize("suite_name", ["fig4", "fig5", "sec43", "table4",
                                        "autotune", "batched"])
def test_suites_run_on_the_card_by_default(suite_name):
    """Without a GPU a suite called with no device raises before it
    measures anything: there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.benchmarks import run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run._suite_registry()[suite_name](out=lambda line: None)
