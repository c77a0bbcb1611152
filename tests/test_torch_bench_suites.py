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


@pytest.mark.parametrize("suite_name", ["fig4", "fig5", "sec43", "table3",
                                        "table4", "autotune", "batched"])
def test_suites_run_on_the_card_by_default(suite_name):
    """Without a GPU a suite called with no device raises before it
    measures anything: there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.benchmarks import run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run._suite_registry()[suite_name](out=lambda line: None)


# ---------------------------------------------------------------------------
# Table 3
# ---------------------------------------------------------------------------

def test_table3_cpu_rows_are_the_references():
    """On the CPU, Table 3's rows have the reference's names, matrices
    (1024 rows, seed 6) and flop counts, and the paper's two columns; the
    energy columns are left out, and the records say so."""
    from benchmarks import table3_energy as r3
    from repro_torch.benchmarks import table3_energy as t3
    ref_rows, rows = [], []
    r3.main(out=ref_rows.append)
    recs = t3.main(out=rows.append, device="cpu")
    assert [r.split(",")[0] for r in rows] == \
        [r.split(",")[0] for r in ref_rows]
    assert [(m, a, b) for m, a, b in t3.PAPER_TABLE3] == r3.PAPER_TABLE3
    for rec, (mid, a100, m4) in zip(recs, r3.PAPER_TABLE3):
        want = rsuite.table2_like(mid, scale_rows=1024, seed=6)
        assert rec["matrix"] == mid and rec["nnz"] == want.nnz
        assert rec["flops"] == 2.0 * want.nnz * r3.N
        assert rec["paper_a100_cusparse_fp16_gflops_per_w"] == a100
        assert rec["paper_m4pro_loops_gflops_per_w"] == m4
        assert "not measured" in rec["energy"]
        assert not {"loops", "cusparse", "idle_w"} & set(rec)
    assert all(",nan," in r for r in rows)


def test_table3_runs_from_the_runner_without_records(tmp_path):
    """``run --only table3`` (no longer unported) writes its CSV rows and
    no bench.json record."""
    import json
    from repro_torch.benchmarks import run
    assert "table3" not in run.UNPORTED and "table3" in run.SUITE_NAMES
    out = tmp_path / "bench"
    assert run.main(["--only", "table3", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert json.loads((out / "bench.json").read_text()) == []
    csv = (out / "bench.csv").read_text().splitlines()
    assert len([ln for ln in csv if ln.startswith("table3_")]) == 6


def test_table3_without_nvml_raises_and_writes_no_number(monkeypatch):
    """On a CUDA device without NVML there is no reading, so no number:
    the suite raises before it measures anything."""
    import ctypes
    from repro_torch.benchmarks import table3_energy as t3

    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")
    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    monkeypatch.setattr(t3, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    rows = []
    with pytest.raises(t3.NvmlError, match="no Table 3 number"):
        t3.main(out=rows.append)
    assert rows == []


class _FakeNvml:
    """A board that draws 250 W while the energy counter is read."""
    name, pci_bus_id = "fake", None

    def __init__(self):
        import time
        self.t0 = time.perf_counter()

    def energy_j(self):
        import time
        return 250.0 * (time.perf_counter() - self.t0)


class _FakeSampler:
    def start(self):
        pass

    def stop(self):
        return [240.0, 260.0]


class _SteppedNvml:
    """A board at 400 W until ``switch_s`` after its start, 100 W after,
    whose energy counter is refreshed every ``period_s`` (a read returns
    the energy at the last refresh)."""
    name, pci_bus_id = "stepped", None

    def __init__(self, period_s=0.03, switch_s=0.1):
        import time
        self.t0, self.period, self.switch = time.perf_counter(), period_s, \
            switch_s

    def _energy(self, t):
        return 400.0 * min(t, self.switch) + 100.0 * max(t - self.switch, 0)

    def energy_j(self):
        import time
        t = time.perf_counter() - self.t0
        return self._energy(t // self.period * self.period)


def test_table3_window_opens_and_closes_on_a_change_of_the_counter(
        monkeypatch):
    """Each energy reading waits for the counter to change, so a loop
    started right after heavy work is not credited with that work's
    energy (a reading taken at once is up to one refresh old: here 400 W
    for up to 30 ms), and the refresh interval is measured."""
    import time

    from repro_torch.benchmarks import table3_energy as t3
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    nvml = _SteppedNvml()
    assert 20.0 <= t3.refresh_ms(nvml) <= 60.0
    nvml = _SteppedNvml()
    time.sleep(nvml.switch + 0.005)     # the loop starts after the switch
    stale = nvml.energy_j()
    assert stale < nvml._energy(nvml.switch)     # a read at once lags
    m = t3._energy_loop(lambda: None, nvml, _FakeSampler(),
                        torch.device("cpu"), 0.2)
    # (the window's ends are seen within a poll of the refresh; a window
    # opened at the stale reading would read ~120 W here)
    assert m["mean_w"] == pytest.approx(100.0, rel=1e-2)
    assert m["window_s"] >= m["seconds"] >= 0.2
    assert m["j_per_call"] == pytest.approx(m["joules"] / m["calls"])


def test_table3_measurement_arithmetic_on_the_cpu(monkeypatch):
    """The measured columns' arithmetic, run on CPU tensors with a fake
    energy counter: a loop lasts at least its minimum, GFLOP/s per W is
    the flop rate over the counter's mean power, and ``loops_spmm``
    agrees with the flat path."""
    from repro_torch.benchmarks import table3_energy as t3
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    csr = t3._matrix("m6", 512)
    b = np.random.default_rng(2).standard_normal((csr.shape[1], t3.N))
    flops = 2.0 * csr.nnz * t3.N
    rec = t3._measure(csr, b, torch.device("cpu"), _FakeNvml(),
                      _FakeSampler(), flops, 0.05)
    assert rec["max_err"] <= t3.TOL
    for name in ("loops", "cusparse"):
        m = rec[name]
        assert m["seconds"] >= 0.05 and m["calls"] % t3.LOOP_CHUNK == 0
        assert m["mean_w"] == pytest.approx(250.0, rel=1e-3)
        assert m["smi_mean_w"] == 250.0 and m["smi_samples"] == 2
        assert m["gflops"] == pytest.approx(
            flops * m["calls"] / m["seconds"] / 1e9)
        assert m["gflops_per_w"] == pytest.approx(m["gflops"] / m["mean_w"])
        assert m["j_per_call"] == pytest.approx(m["joules"] / m["calls"])
    assert rec["cusparse"]["dtype"] in ("float16", "float32")
