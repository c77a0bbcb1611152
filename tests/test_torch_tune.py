"""The port's tuner (``repro_torch.tune``) against the reference's
(``repro.tune``) on the CPU.

* Fingerprint features are bitwise equal for the same CSR arrays, and
  cache keys are equal for the same backend string and apart across the
  two packages' backends.
* ``enumerate_plans`` is equal; ``search`` with the same deterministic
  ``measure`` measures the same survivors in the same order and picks the
  same winner: on ``"torch"`` against the reference's ``"jnp"``, and on
  ``"cuda"`` (the kernels' plain versions on CPU tensors) against the
  reference with depth pinned to 1 and Br 2 left out.
* ``autotune``'s miss / exact / near / ``on_miss="model"`` sequence gives
  the same ``CacheStats`` and structurally equal formats; a plan file
  written by either package reads in the other; the ``tuner=`` arguments
  of ``plan_and_convert``, ``transposed`` and ``sparse_linear_from_dense``
  give the reference's plans; an autotuned ``loops_spmm`` matches the
  reference's ``backend="jnp"``.
* The deliberate divergences: depth pinned on ``"cuda"``, Br 2 not a
  candidate there, a non-injected trial error propagating, the timed
  window (upload before the first timed call; on the CPU a sync after
  each call, on a CUDA device CUDA events around runs of calls), and on a
  CUDA device the model's plan measured after the reference's survivors.

No test touches ``~/.cache/repro-tune``: ``$REPRO_TUNE_CACHE`` points at a
temporary directory for every test here.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import spmm as rspmm
from repro.core import suite as rsuite
from repro.models import sparse_ffn as rffn
from repro.tune import api as rapi
from repro.tune import cache as rcache
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.kernels import engine
from repro_torch.kernels.bcsr_spmm import KERNEL_BRS
from repro_torch.models import sparse_ffn as tffn
from repro_torch.obs import Obs, set_active
from repro_torch.resilience import inject
from repro_torch.tune import api as tapi
from repro_torch.tune import cache as tcache

from test_torch_formats import assert_same

# ``tune/__init__`` re-exports functions named like these two modules.
rfp = importlib.import_module("repro.tune.fingerprint")
rsearch = importlib.import_module("repro.tune.search")
tfp = importlib.import_module("repro_torch.tune.fingerprint")
tsearch = importlib.import_module("repro_torch.tune.search")

MIDS = ["m4", "m6", "m8", "m12", "m13"]
BUDGET = dict(top_k=2, repeats=1, warmup=0)


@pytest.fixture(autouse=True)
def _private_cache_dir(tmp_path, monkeypatch):
    """Both packages' default caches live in a fresh directory."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "default"))
    monkeypatch.setattr(tapi, "_DEFAULT_CACHE", None)
    monkeypatch.setattr(rapi, "_DEFAULT_CACHE", None)


def pair(mid, rows=256, seed=1):
    return (rsuite.table2_like(mid, scale_rows=rows, seed=seed),
            tsuite.table2_like(mid, scale_rows=rows, seed=seed))


def as_tuple(plan):
    return dataclasses.astuple(plan)


def score(plan) -> float:
    """A deterministic 'throughput' over every plan knob."""
    return 1.0 + float((plan.r_boundary * 7 + plan.br * 3
                        + plan.panel_g * 5 + plan.macro_m * 11
                        + plan.pipeline_depth * 13 + plan.t_vpu) % 17)


def measure_with(formats, log):
    """An injected ``measure`` for the package whose formats module is
    ``formats``: converts, logs the plan, returns :func:`score`."""
    def measure(csr, plan, b):
        log.append(plan)
        return formats.loops_from_csr(
            csr, plan.r_boundary, plan.br, panel_g=plan.panel_g,
            macro_m=plan.macro_m,
            pipeline_depth=plan.pipeline_depth), score(plan)
    return measure


def fake_measure_plan_gflops(formats, log):
    """A stand-in for both packages' ``measure_plan_gflops``."""
    inner = measure_with(formats, log)

    def measure_plan_gflops(csr, plan, b, *, backend, budget):
        return inner(csr, plan, b)
    return measure_plan_gflops


@pytest.fixture
def deterministic(monkeypatch):
    """Both packages' default measurement replaced by :func:`score`;
    returns the two measurement logs (reference, port)."""
    logs = ([], [])
    monkeypatch.setattr(rsearch, "measure_plan_gflops",
                        fake_measure_plan_gflops(rf, logs[0]))
    monkeypatch.setattr(tsearch, "measure_plan_gflops",
                        fake_measure_plan_gflops(tf, logs[1]))
    return logs


def assert_formats_equal(fr, fp, n_cols=8):
    assert_same(fr.csr_part, fp.csr_part)
    assert_same(fr.bcsr_part, fp.bcsr_part)
    assert_same(fr.csr_panels, fp.csr_panels)
    assert_same(fr.bcsr_panels, fp.bcsr_panels)
    assert (fr.r_boundary, fr.panel_g, fr.macro_m, fr.pipeline_depth) == \
        (fp.r_boundary, fp.panel_g, fp.macro_m, fp.pipeline_depth)
    assert fr.nnz == fp.nnz
    assert rspmm.loops_grid_steps(fr, n_cols) == \
        tspmm.loops_grid_steps(fp, n_cols)


# ---------------------------------------------------------------------------
# fingerprint and key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mid", MIDS)
def test_fingerprint_features_bitwise_equal(mid):
    cr, cp = pair(mid)
    a, b = rfp.fingerprint(cr), tfp.fingerprint(cp)
    assert a.features().tobytes() == b.features().tobytes()
    assert a.quantised() == b.quantised()
    fr = rf.loops_from_csr(cr, cr.nrows // 2 // 8 * 8, 8)
    fp = tf.loops_from_csr(cp, cp.nrows // 2 // 8 * 8, 8)
    assert rfp.loops_fingerprint(fr).features().tobytes() == \
        tfp.loops_fingerprint(fp).features().tobytes()


@pytest.mark.parametrize("rows", [2048, 4096])
def test_reseeded_feature_distance_bitwise_equal(rows):
    """An in-2004-like matrix against the same generator under another
    seed: both packages put the pair at the same distance, so the near
    match accepts or refuses reseeded traffic alike."""
    r0, t0 = pair("m4", rows=rows, seed=0)
    r1, t1 = pair("m4", rows=rows, seed=1)
    dr = rfp.feature_distance(rfp.fingerprint(r0).features(),
                              rfp.fingerprint(r1).features())
    dt = tfp.feature_distance(tfp.fingerprint(t0).features(),
                              tfp.fingerprint(t1).features())
    assert np.float64(dt).tobytes() == np.float64(dr).tobytes()
    near = rapi.Tuner.near_distance
    assert (dt <= near) == (dr <= near)


def test_fingerprint_of_adversarial_cases_bitwise_equal(rng):
    from test_torch_gpu import adversarial_cases
    for name, a in adversarial_cases(rng).items():
        for dt in (np.float32, np.float64):
            fr = rfp.fingerprint(rf.csr_from_dense(a.astype(dt)))
            fp = tfp.fingerprint(tf.csr_from_dense(a.astype(dt)))
            assert fr.features().tobytes() == fp.features().tobytes(), name


@pytest.mark.parametrize("mid", ["m6", "m12"])
def test_cache_key_equal_per_backend_and_apart_across_packages(mid):
    cr, cp = pair(mid)
    fr, fp = rfp.fingerprint(cr), tfp.fingerprint(cp)
    for backend in ("cuda", "torch", "pallas", "jnp"):
        kw = dict(n_cols=32, dtype=np.float32, backend=backend)
        assert rfp.cache_key(fr, **kw) == tfp.cache_key(fp, **kw)
    keys = {b: tfp.cache_key(fp, n_cols=32, dtype=np.float32, backend=b)
            for b in ("cuda", "torch", "pallas", "interpret", "jnp")}
    assert len(set(keys.values())) == len(keys)
    assert tfp.effective_n_cols((3, 40, 16)) == \
        rfp.effective_n_cols((3, 40, 16)) == 48
    assert tcache.CACHE_VERSION == rcache.CACHE_VERSION


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mid", MIDS)
def test_enumerate_plans_equal(mid):
    cr, cp = pair(mid)
    for kw in ({}, dict(total_workers=4, br_choices=(4, 16),
                        g_choices=(1, 2), depth_choices=(1,),
                        macro_choices=(1, 2, 4))):
        want = [as_tuple(p) for p in rsearch.enumerate_plans(cr, **kw)]
        got = [as_tuple(p) for p in tsearch.enumerate_plans(cp, **kw)]
        assert got == want
    assert tsearch.prior_model(8).coef.tolist() == \
        rsearch.prior_model(8).coef.tolist()


@pytest.mark.parametrize("top_k", [2, 4, 9])
@pytest.mark.parametrize("mid", ["m4", "m8", "m12"])
def test_search_matches_reference_on_torch(mid, top_k):
    """``"torch"`` (the flat references) against the reference's
    ``"jnp"``, the same injected measurement."""
    cr, cp = pair(mid)
    logs = ([], [])
    budget = dict(top_k=top_k, max_trials=top_k)
    want = rsearch.search(cr, n_cols=8, backend="jnp",
                          budget=rsearch.SearchBudget(**budget),
                          measure=measure_with(rf, logs[0]))
    got = tsearch.search(cp, n_cols=8, backend="torch", device="cpu",
                         budget=tsearch.SearchBudget(**budget),
                         measure=measure_with(tf, logs[1]))
    assert [as_tuple(p) for p in logs[1]] == [as_tuple(p) for p in logs[0]]
    assert [(as_tuple(p), g) for p, g in got.trials] == \
        [(as_tuple(p), g) for p, g in want.trials]
    assert as_tuple(got.plan) == as_tuple(want.plan)
    assert got.gflops == want.gflops
    assert_formats_equal(want.fmt, got.fmt)


@pytest.mark.parametrize("top_k", [2, 4, 9])
@pytest.mark.parametrize("mid", ["m4", "m8", "m12"])
def test_search_matches_reference_on_cuda_with_depth_pinned(mid, top_k):
    """``"cuda"`` (the kernel wrappers, plain versions on CPU tensors)
    against the reference restricted as the port restricts itself there:
    depth 1, and no Br without a B2 instantiation."""
    cr, cp = pair(mid)
    logs = ([], [])
    budget = dict(top_k=top_k, max_trials=top_k)
    want = rsearch.search(cr, n_cols=8, backend="pallas",
                          depth_choices=(1,), br_choices=(4, 8),
                          budget=rsearch.SearchBudget(**budget),
                          measure=measure_with(rf, logs[0]))
    got = tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                         budget=tsearch.SearchBudget(**budget),
                         measure=measure_with(tf, logs[1]))
    assert [as_tuple(p) for p in logs[1]] == [as_tuple(p) for p in logs[0]]
    assert as_tuple(got.plan) == as_tuple(want.plan)
    assert [g for _, g in got.trials] == [g for _, g in want.trials]


def test_depth_pinned_on_cuda():
    """Divergence: no kernel reads ``pipeline_depth``, so ``"cuda"`` never
    measures depth 2; G and macro_m stay measured axes."""
    _, cp = pair("m12", rows=96)
    log = []
    n = len(tsearch.enumerate_plans(cp))
    tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                   budget=tsearch.SearchBudget(top_k=n, max_trials=n),
                   measure=measure_with(tf, log))
    assert log and {p.pipeline_depth for p in log} == {1}
    assert len({p.panel_g for p in log}) > 1
    assert len({p.macro_m for p in log}) > 1


def test_torch_backend_pins_g_macro_and_depth_like_jnp(deterministic):
    """``"torch"`` without an injected measure pins (G, macro_m, depth)
    to the structural winner, as the reference does on ``"jnp"``."""
    cr, cp = pair("m12", rows=96)
    budget = dict(top_k=12, max_trials=12, repeats=1, warmup=0)
    want = rsearch.search(cr, n_cols=8, backend="jnp",
                          budget=rsearch.SearchBudget(**budget))
    got = tsearch.search(cp, n_cols=8, backend="torch", device="cpu",
                         budget=tsearch.SearchBudget(**budget))
    ref_log, port_log = deterministic
    assert [as_tuple(p) for p in port_log] == [as_tuple(p) for p in ref_log]
    assert len({(p.panel_g, p.macro_m, p.pipeline_depth)
                for p in port_log}) == 1
    assert as_tuple(got.plan) == as_tuple(want.plan)


def test_br_without_a_kernel_is_not_a_candidate_on_cuda():
    _, cp = pair("m8", rows=96)
    log = []
    n = len(tsearch.enumerate_plans(cp))
    tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                   budget=tsearch.SearchBudget(top_k=n, max_trials=n),
                   measure=measure_with(tf, log))
    assert {p.br for p in log} <= set(KERNEL_BRS)
    assert {p.br for p in log} == {4, 8}
    with pytest.raises(ValueError, match="B2 instantiation"):
        tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                       br_choices=(2,), measure=measure_with(tf, []))


def test_non_injected_trial_error_propagates_on_cuda():
    """Divergence: the reference skips any failing trial; the port skips
    only injected faults and timeouts, so a kernel that does not build or
    launch is never hidden behind a model-ranked plan."""
    _, cp = pair("m8", rows=96)

    def broken(csr, plan, b):
        raise RuntimeError("kernel launch failed")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                       measure=broken)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_injected_trial_fault_is_skipped_and_counted(backend):
    cr, cp = pair("m8", rows=96)
    logs = ([], [])
    obs = Obs(source="t")
    prev_obs = set_active(obs)
    prev = inject.set_plan(inject.FaultPlan.parse("tune.trial:raise:0"))
    try:
        got = tsearch.search(cp, n_cols=8, backend=backend, device="cpu",
                             budget=tsearch.SearchBudget(top_k=3),
                             measure=measure_with(tf, logs[1]))
    finally:
        inject.set_plan(prev)
        set_active(prev_obs)
    assert got.measured == 2 and len(logs[1]) == 2
    assert obs.metrics.find("counter", "tune.search.trial_failed",
                            reason="injected").value == 1
    assert obs.metrics.find("counter", "inject.fired", site="tune.trial",
                            kind="raise").value == 1


def test_all_trials_injected_degrades_to_the_model_plan():
    cr, cp = pair("m8", rows=96)
    from repro.resilience import inject as rinject
    prev_r = rinject.set_plan(rinject.FaultPlan.parse("tune.trial:raise:0:0"))
    prev_t = inject.set_plan(inject.FaultPlan.parse("tune.trial:raise:0:0"))
    try:
        want = rsearch.search(cr, n_cols=8, backend="jnp",
                              measure=measure_with(rf, []))
        got = tsearch.search(cp, n_cols=8, backend="torch", device="cpu",
                             measure=measure_with(tf, []))
    finally:
        rinject.set_plan(prev_r)
        inject.set_plan(prev_t)
    assert got.gflops == want.gflops == 0.0 and got.measured == 0
    assert as_tuple(got.plan) == as_tuple(want.plan)


def test_trial_timeout_counts_as_failed():
    _, cp = pair("m8", rows=96)
    obs = Obs(source="t")
    prev = set_active(obs)
    try:
        got = tsearch.search(
            cp, n_cols=8, backend="cuda", device="cpu",
            budget=tsearch.SearchBudget(top_k=2, trial_timeout_s=0.0),
            measure=measure_with(tf, []))
    finally:
        set_active(prev)
    assert got.measured == 0 and got.gflops == 0.0
    assert obs.metrics.find("counter", "tune.search.trial_failed",
                            reason="timeout").value == 2


def test_timed_window_uploads_first_and_syncs_every_call(monkeypatch):
    """``measure_plan_gflops`` uploads the panels (and B1/B2's unit
    tables) and counts nonzeros before its first timed call; every timed
    call runs to a device sync (a no-op on the CPU, so the sync is
    observed through ``_time_fn``'s device argument)."""
    _, cp = pair("m8", rows=96)
    events = []
    upload = tf.DevicePanels.upload.__func__
    monkeypatch.setattr(tf.DevicePanels, "upload", classmethod(
        lambda cls, panels, device: (events.append("upload"),
                                     upload(cls, panels, device))[1]))
    fused = engine.loops_spmm_fused
    monkeypatch.setattr(engine, "loops_spmm_fused", lambda *a, **k: (
        events.append("call"), fused(*a, **k))[1])
    plan = tspmm.SpmmPlan(r_boundary=48, t_vpu=2, t_mxu=6, br=8, panel_g=4)
    b = torch.randn(cp.ncols, 8)
    fmt, g = tsearch.measure_plan_gflops(
        cp, plan, b, budget=tsearch.SearchBudget(repeats=3, warmup=0))
    assert events == ["upload", "upload", "call", "call", "call"]
    assert "nnz" in fmt.__dict__ and str(b.device) in fmt._device_cache
    assert g > 0


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: ``elapsed_time``
    gives the milliseconds of a fixed per-run schedule."""
    runs = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.runs.pop(0)


def test_cuda_timing_is_events_around_runs_of_calls(monkeypatch):
    """On a CUDA device ``_time_fn`` runs the warm-up, synchronises once
    and times ``repeats`` runs of ``CUDA_RUN_CALLS`` calls with CUDA
    events: the median run's milliseconds over its calls."""
    import contextlib
    events = []
    _FakeEvent.runs = [5.0, 15.0, 10.0]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: events.append("sync"))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    secs = tsearch._time_fn(lambda: events.append("call"), repeats=3,
                            warmup=2, device=torch.device("cuda", 0))
    assert events == ["call"] * 2 + ["sync"] + (
        ["call"] * 3 * tsearch.CUDA_RUN_CALLS)
    assert secs == pytest.approx(10.0 / 1e3 / tsearch.CUDA_RUN_CALLS)


@pytest.mark.parametrize("top_k", [2, 4])
@pytest.mark.parametrize("mid", ["m4", "m8", "m12"])
def test_model_plan_is_measured_after_the_survivors_on_the_card(
        monkeypatch, mid, top_k):
    """Divergence: on a CUDA device the search measures the reference's
    survivors in the reference's order and then ``plan_for``'s plan, unless
    a survivor converts the same way; the best measured plan wins, the
    model's included."""
    monkeypatch.setattr(tsearch, "_on_card", lambda b: True)
    cr, cp = pair(mid)
    logs = ([], [])
    budget = dict(top_k=top_k, max_trials=top_k + 1)
    rsearch.search(cr, n_cols=8, backend="pallas", depth_choices=(1,),
                   br_choices=(4, 8), budget=rsearch.SearchBudget(**budget),
                   measure=measure_with(rf, logs[0]))
    model_plan = tspmm.plan_for(cp)

    def measure(csr, plan, b):
        fmt, g = measure_with(tf, logs[1])(csr, plan, b)
        g = 100.0 if plan == model_plan else g
        return fmt, g
    got = tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                         budget=tsearch.SearchBudget(**budget),
                         measure=measure)
    survivors = [as_tuple(p) for p in logs[0]]
    assert [as_tuple(p) for p in logs[1][:len(survivors)]] == survivors
    conv = tsearch._conversion
    if any(conv(p) == conv(model_plan) for p in logs[1][:len(survivors)]):
        assert len(logs[1]) == len(survivors)
    else:
        assert logs[1][len(survivors):] == [model_plan]
        assert got.plan == model_plan and got.gflops == 100.0


def test_model_plan_respects_max_trials_and_stays_off_the_cpu(monkeypatch):
    """The model's plan is measured only within ``max_trials``, and never
    on the CPU (where the search measures the reference's trials alone)."""
    _, cp = pair("m4")
    model_plan = tspmm.plan_for(cp)
    for on_card, max_trials, want in ((True, 2, False), (True, 3, True),
                                      (False, 3, False)):
        monkeypatch.setattr(tsearch, "_on_card", lambda b: on_card)
        log = []
        tsearch.search(cp, n_cols=8, backend="cuda", device="cpu",
                       budget=tsearch.SearchBudget(top_k=2,
                                                   max_trials=max_trials),
                       measure=measure_with(tf, log))
        assert (model_plan in log) == want, (on_card, max_trials)
    assert not tsearch._on_card(torch.zeros(1))


# ---------------------------------------------------------------------------
# autotune and the cache
# ---------------------------------------------------------------------------

def _stats(cache):
    s = cache.stats
    return (s.hits, s.near_hits, s.misses, s.prewarmed, s.quarantined)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_autotune_sequence_matches_reference(tmp_path, deterministic,
                                             backend):
    """miss (search) -> exact hit -> near hit (promoted) -> exact hit ->
    ``on_miss="model"`` miss: the same stats after every step; on
    ``"torch"`` the same formats as the reference's ``"jnp"``."""
    ref_backend = "jnp" if backend == "torch" else "pallas"
    rcache_, tcache_ = (rcache.PlanCache(str(tmp_path / "r")),
                        tcache.PlanCache(str(tmp_path / "t")))
    a_r, a_t = pair("m12", rows=128, seed=1)
    c_r, c_t = pair("m8", rows=160, seed=2)
    d_r, d_t = pair("m4", rows=200, seed=3)
    # a neighbour of c: a record whose fingerprint is 0.05 away
    for mod, cache, csr, bk in ((rapi, rcache_, c_r, ref_backend),
                                (tapi, tcache_, c_t, backend)):
        feats = (rfp if mod is rapi else tfp).fingerprint(csr).features()
        cache.put("neighbour", mod.make_record(
            feats + 0.05, dtype=np.float32, n_cols=8, backend=bk,
            r_frac=0.25, t_vpu=2, t_mxu=6, br=8, panel_g=4, gflops=1.5,
            trials=3))
    steps = [(a_r, a_t, "search"), (a_r, a_t, "search"),
             (c_r, c_t, "search"), (c_r, c_t, "search"),
             (d_r, d_t, "model")]
    for i, (cr, ct, on_miss) in enumerate(steps):
        fr, pr = rapi.autotune(cr, n_cols=8, cache=rcache_,
                               backend=ref_backend, on_miss=on_miss,
                               budget=rsearch.SearchBudget(**BUDGET))
        ft, pt = tapi.autotune(ct, n_cols=8, cache=tcache_, backend=backend,
                               on_miss=on_miss, device="cpu",
                               budget=tsearch.SearchBudget(**BUDGET))
        assert _stats(tcache_) == _stats(rcache_), f"step {i}"
        assert str(torch.device("cpu")) in ft._device_cache
        if backend == "torch":
            assert as_tuple(pt) == as_tuple(pr), f"step {i}"
            assert_formats_equal(fr, ft)
    assert _stats(tcache_)[:3] == (2, 1, 2)
    ref_log, port_log = deterministic
    assert len(port_log) == len(ref_log) == BUDGET["top_k"]
    assert len(tcache_) == len(rcache_) == 4   # a, c (promoted), d, neighbour


def test_repeat_autotune_makes_no_measurement(tmp_path, monkeypatch):
    _, cp = pair("m12", rows=128)
    cache = tcache.PlanCache(str(tmp_path))
    calls = []
    real = tsearch.measure_plan_gflops
    monkeypatch.setattr(tsearch, "measure_plan_gflops",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    budget = tsearch.SearchBudget(**BUDGET)
    f1, p1 = tapi.autotune(cp, n_cols=8, cache=cache, budget=budget,
                           device="cpu")
    assert len(calls) == 2 and cache.stats.misses == 1
    f2, p2 = tapi.autotune(cp, n_cols=8, cache=cache, budget=budget,
                           device="cpu")
    assert len(calls) == 2 and cache.stats.hits == 1
    assert p2 == p1 and f2.r_boundary == f1.r_boundary


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_file_reads_in_the_other_package(tmp_path, writer):
    _, cp = pair("m6")
    feats = tfp.fingerprint(cp).features()
    mods = (tapi, tcache) if writer == "port" else (rapi, rcache)
    other = rcache if writer == "port" else tcache
    rec = mods[0].make_record(feats, dtype=np.float32, n_cols=8,
                              backend="cuda", r_frac=0.5, t_vpu=2, t_mxu=6,
                              br=8, panel_g=4, pipeline_depth=1, macro_m=4,
                              gflops=12.5, trials=4)
    key = tfp.cache_key(tfp.fingerprint(cp), n_cols=8, dtype=np.float32,
                        backend="cuda")
    mods[1].PlanCache(str(tmp_path)).put(key, rec)
    reader = other.PlanCache(str(tmp_path))
    assert reader.peek(key) == rec
    # the bulk path rebuilds the same key from the stored record
    pool = other.PlanCache(str(tmp_path / "pool"))
    assert pool.prewarm([rec]) == 1 and pool.peek(key) == rec
    assert pool.prewarm([rec]) == 0 and pool.stats.prewarmed == 1
    plan_r = rapi.plan_from_record(rec, cp.nrows)
    plan_t = tapi.plan_from_record(rec, cp.nrows)
    assert as_tuple(plan_r) == as_tuple(plan_t)


def test_plan_and_convert_tuner_matches_reference(tmp_path, deterministic):
    cr, cp = pair("m13", rows=200)
    rt = rapi.Tuner(cache=rcache.PlanCache(str(tmp_path / "r")), n_cols=8,
                    backend="jnp", budget=rsearch.SearchBudget(**BUDGET))
    tt = tapi.Tuner(cache=tcache.PlanCache(str(tmp_path / "t")), n_cols=8,
                    backend="torch", device="cpu",
                    budget=tsearch.SearchBudget(**BUDGET))
    fr, pr = rspmm.plan_and_convert(cr, tuner=rt)
    fp, pp = tspmm.plan_and_convert(cp, tuner=tt, device="cpu")
    assert as_tuple(pp) == as_tuple(pr)
    assert_formats_equal(fr, fp)
    assert _stats(tt.cache) == _stats(rt.cache) == (0, 0, 1, 0, 0)
    fp2, _ = tspmm.plan_and_convert(cp, tuner=tt, device="cpu")
    assert tt.cache.stats.hits == 1 and fp2.r_boundary == fp.r_boundary


def test_transposed_tuner_matches_reference(tmp_path, deterministic):
    cr, cp = pair("m8", rows=160)
    fr = rf.loops_from_csr(cr, 64, 8)
    fp = tf.loops_from_csr(cp, 64, 8)
    rt = rapi.Tuner(cache=rcache.PlanCache(str(tmp_path / "r")), n_cols=8,
                    backend="jnp", budget=rsearch.SearchBudget(**BUDGET))
    tt = tapi.Tuner(cache=tcache.PlanCache(str(tmp_path / "t")), n_cols=8,
                    backend="torch", device="cpu",
                    budget=tsearch.SearchBudget(**BUDGET))
    tl_r = fr.transposed(tuner=rt)
    tl_t = fp.transposed(tuner=tt)
    assert as_tuple(tl_t.plan) == as_tuple(tl_r.plan)
    assert_formats_equal(tl_r.fmt, tl_t.fmt)
    np.testing.assert_array_equal(tl_t.entry_src, tl_r.entry_src)
    np.testing.assert_array_equal(tl_t.entry_slot, tl_r.entry_slot)
    # cached per tuner (pinned in the entry), apart from the model plan
    # and from the same plan pinned (one key per call, as the reference's)
    assert fp.transposed(tuner=tt) is tl_t
    assert fp.transposed(plan=tl_t.plan) is not tl_t
    assert as_tuple(fp.transposed(plan=tl_t.plan).plan) == as_tuple(tl_t.plan)
    assert fp.transposed() is not tl_t
    assert tt.cache.stats.misses == 1
    assert any(e[0] is tt for e in fp._transposed_cache.values())


def test_sparse_linear_tuner_matches_reference(tmp_path, deterministic):
    w = np.random.default_rng(4).standard_normal((96, 40)).astype(np.float32)
    rt = rapi.Tuner(cache=rcache.PlanCache(str(tmp_path / "r")), n_cols=8,
                    backend="jnp", budget=rsearch.SearchBudget(**BUDGET))
    tt = tapi.Tuner(cache=tcache.PlanCache(str(tmp_path / "t")), n_cols=8,
                    backend="torch", device="cpu",
                    budget=tsearch.SearchBudget(**BUDGET))
    layer_r = rffn.sparse_linear_from_dense(w, 0.8, tuner=rt)
    layer_t = tffn.sparse_linear_from_dense(w, 0.8, tuner=tt, device="cpu")
    assert_formats_equal(layer_r.fmt, layer_t.fmt)
    # a second layer of the same structure is a cache hit: no measurement
    ref_log, port_log = deterministic
    n = len(port_log)
    tffn.sparse_linear_from_dense(2 * w, 0.8, tuner=tt, device="cpu")
    assert len(port_log) == n and tt.cache.stats.hits == 1


@pytest.mark.parametrize("mid", ["m4", "m13"])
def test_autotuned_loops_spmm_matches_reference(tmp_path, mid):
    """Real measurement on ``"cuda"`` (plain versions on CPU tensors): the
    tuned format executes to the reference's ``jnp`` result under the same
    plan, at 1e-5 in fp32."""
    cr, cp = pair(mid, rows=192)
    fmt, plan = tapi.autotune(cp, n_cols=8, device="cpu",
                              cache=tcache.PlanCache(str(tmp_path)),
                              budget=tsearch.SearchBudget(**BUDGET))
    assert plan.pipeline_depth == 1 and plan.br in KERNEL_BRS
    fr = rf.loops_from_csr(cr, plan.r_boundary, plan.br,
                           panel_g=plan.panel_g, macro_m=plan.macro_m,
                           pipeline_depth=plan.pipeline_depth)
    assert_formats_equal(fr, fmt)
    b = np.random.default_rng(0).standard_normal(
        (cp.ncols, 8)).astype(np.float32)
    want = np.asarray(rspmm.loops_spmm(fr, jnp.asarray(b), backend="jnp"))
    got = tspmm.loops_spmm(fmt, torch.from_numpy(b), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tune_suite_matches_reference(tmp_path, deterministic):
    names = ("m6", "m12")
    mats_r = {m: pair(m, rows=128)[0] for m in names}
    mats_t = {m: pair(m, rows=128)[1] for m in names}
    want = rapi.tune_suite(mats_r, n_cols=8, backend="jnp",
                           cache=rcache.PlanCache(str(tmp_path / "r")),
                           budget=rsearch.SearchBudget(**BUDGET))
    got = tapi.tune_suite(mats_t, n_cols=8, backend="torch", device="cpu",
                          cache=tcache.PlanCache(str(tmp_path / "t")),
                          budget=tsearch.SearchBudget(**BUDGET))
    for m in names:
        assert as_tuple(got[m][0]) == as_tuple(want[m][0])
        assert got[m][1] == want[m][1]


def test_default_device_is_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, cp = pair("m8", rows=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.autotune(cp, n_cols=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Tuner().tune(cp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.search(cp, n_cols=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmm.plan_and_convert(cp, tuner=tapi.Tuner(device="cpu"))
