"""The port's fault seam and retry helper (``repro_torch.resilience``)
against the reference's (``repro.resilience``) on the CPU.

* ``FaultPlan.parse``, the firing windows and the per-site counters are
  equal; the corrupted payloads are equal for numpy inputs, and a torch
  tensor's NaN positions are the numpy branch's.
* ``retry_with_backoff`` recovers, re-raises and honours its deadline as
  the reference's does; ``classify`` gives the same labels.
* The plan cache's resilience (read-retry, quarantine, injected
  corruption, merge-on-save, clear) behaves as the reference's.
"""
import json

import numpy as np
import pytest
import torch

from repro.resilience import fallback as rfallback
from repro.resilience import inject as rinject
from repro_torch.obs import Obs, set_active
from repro_torch.resilience import fallback as tfallback
from repro_torch.resilience import inject as tinject
from repro_torch.tune import cache as tcache

SPECS = ["seed=7; engine.*.interpret:raise:0 ;cache.read:corrupt-bytes:1:0",
         "serve.step:raise:2:3;tune.*:timeout",
         "seed=11;ingest.serve.weights:nan-values:0:0;serve.*:raise:1"]
SITES = ["serve.step", "serve.prefill", "tune.trial", "cache.read",
         "engine.csr.spmm.interpret", "ingest.serve.weights"]


@pytest.fixture(autouse=True)
def _clean():
    yield
    tinject.set_plan(None)
    rinject.set_plan(None)
    set_active(None)


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_and_firing_equal_reference(spec):
    pr, pt = rinject.FaultPlan.parse(spec), tinject.FaultPlan.parse(spec)
    assert pt.seed == pr.seed
    assert [(c.site, c.kind, c.nth, c.count) for c in pt.clauses] == \
        [(c.site, c.kind, c.nth, c.count) for c in pr.clauses]
    for site in SITES * 4:
        cr, ct = pr.match(site), pt.match(site)
        assert (ct.kind if ct else None) == (cr.kind if cr else None), site
    for c in pt.clauses:
        assert [c.fires(n) for n in range(8)] == \
            [rinject.FaultClause(c.site, c.kind, c.nth, c.count).fires(n)
             for n in range(8)]


def test_fault_plan_rejects_bad_kind_and_bad_clause():
    with pytest.raises(ValueError):
        tinject.FaultPlan.parse("site:explode")
    with pytest.raises(ValueError):
        tinject.FaultPlan.parse("just-a-site")


def test_fault_point_counts_per_site_and_resets():
    plan = tinject.FaultPlan.parse("s:raise:1")
    tinject.set_plan(plan)
    assert tinject.fault_point("s", "ok") == "ok"
    with pytest.raises(tinject.InjectedFault):
        tinject.fault_point("s")
    assert tinject.fault_point("s", "ok") == "ok"
    plan.reset()
    assert tinject.fault_point("s", "ok") == "ok"
    with pytest.raises(tinject.InjectedFault):
        tinject.fault_point("s")


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_corrupted_bytes_equal_reference(seed):
    payload = json.dumps({"k": list(range(64))}).encode()
    spec = f"seed={seed};blob:corrupt-bytes:0:0"
    rinject.set_plan(rinject.FaultPlan.parse(spec))
    tinject.set_plan(tinject.FaultPlan.parse(spec))
    a, b = tinject.fault_point("blob", payload), rinject.fault_point(
        "blob", payload)
    assert a == b and a != payload
    with pytest.raises(ValueError):
        json.loads(a.decode("utf-8", errors="replace"))


@pytest.mark.parametrize("shape", [(8, 8), (5, 7, 3), (1,), (0, 4)])
@pytest.mark.parametrize("seed", [0, 5])
def test_nan_values_equal_reference_and_torch_branch(shape, seed):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    spec = f"seed={seed};w:nan-values:0:0"
    rinject.set_plan(rinject.FaultPlan.parse(spec))
    tinject.set_plan(tinject.FaultPlan.parse(spec))
    want = rinject.fault_point("w", x)
    got = tinject.fault_point("w", x)
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(x).any()                     # input untouched
    tinject.get_plan().reset()
    xt = torch.from_numpy(x.copy())
    got_t = tinject.fault_point("w", xt)
    assert isinstance(got_t, torch.Tensor) and got_t.shape == xt.shape
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert not torch.isnan(xt).any()
    if x.size:
        assert np.isnan(want).sum() == max(x.size // 16, 1)


def test_raise_and_timeout_kinds_and_payloadless_corruption():
    tinject.set_plan(tinject.FaultPlan.parse("a:timeout;b:nan-values"))
    with pytest.raises(tinject.InjectedTimeout):
        tinject.fault_point("a")
    with pytest.raises(tinject.InjectedFault, match="nan-values"):
        tinject.fault_point("b")


def test_fired_faults_are_counted_on_the_active_capture():
    obs = Obs(source="t")
    set_active(obs)
    tinject.set_plan(tinject.FaultPlan.parse("serve.step:raise:0:2"))
    for _ in range(3):
        try:
            tinject.fault_point("serve.step")
        except tinject.InjectedFault:
            pass
    assert obs.metrics.find("counter", "inject.fired", site="serve.step",
                            kind="raise").value == 2
    tinject.note_degraded("serve.degraded", reason="retry")
    assert obs.metrics.find("counter", "serve.degraded",
                            reason="retry").value == 1


def test_install_from_env_and_disabled_state():
    assert tinject.install_from_env({}) is None
    plan = tinject.install_from_env({tinject.ENV_VAR: "s:raise"})
    assert plan is not None and tinject.get_plan() is plan
    assert tinject.ENV_VAR == rinject.ENV_VAR == "REPRO_FAULT_PLAN"
    tinject.set_plan(None)
    assert tinject.fault_point("s", 1) == 1


# ---------------------------------------------------------------------------
# retry and classification
# ---------------------------------------------------------------------------

def _flaky(fail_times, exc=OSError):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail_times:
            raise exc("transient")
        return len(calls)
    return fn, calls


@pytest.mark.parametrize("fails,retries", [(0, 0), (2, 3), (3, 3), (4, 3)])
def test_retry_with_backoff_matches_reference(fails, retries):
    outcomes = []
    for mod in (rfallback, tfallback):
        fn, calls = _flaky(fails)
        seen = []
        try:
            out = mod.retry_with_backoff(
                fn, retries=retries, backoff_s=1e-4,
                on_retry=lambda n, e: seen.append((n, type(e).__name__)))
        except OSError as e:
            out = f"raised {e}"
        outcomes.append((out, len(calls), seen))
    assert outcomes[1] == outcomes[0]


def test_retry_deadline_raises_instead_of_sleeping_past():
    def always():
        raise OSError("down")
    for mod in (rfallback, tfallback):
        with pytest.raises(mod.DeadlineExceeded) as ei:
            mod.retry_with_backoff(always, retries=50, backoff_s=10.0,
                                   deadline_s=0.01)
        assert isinstance(ei.value.__cause__, OSError)
        assert isinstance(ei.value, TimeoutError)


def test_classify_equal_reference():
    excs = [(tinject.InjectedTimeout("s", "timeout"),
             rinject.InjectedTimeout("s", "timeout")),
            (tinject.InjectedFault("s", "raise"),
             rinject.InjectedFault("s", "raise")),
            (TimeoutError(), TimeoutError()), (KeyError(), KeyError()),
            (tfallback.DeadlineExceeded(), rfallback.DeadlineExceeded())]
    for et, er in excs:
        assert tfallback.classify(et) == rfallback.classify(er)


# ---------------------------------------------------------------------------
# the plan cache's resilience
# ---------------------------------------------------------------------------

def _rec(g=1.0):
    return {"version": tcache.CACHE_VERSION, "fingerprint": [0.0] * 8,
            "dtype": "float32", "n_cols": 8, "backend": "cuda",
            "plan": {"r_frac": 0.5, "t_vpu": 2, "t_mxu": 6, "br": 8,
                     "panel_g": 4, "pipeline_depth": 1, "macro_m": 1},
            "gflops": g, "trials": 2}


def test_cache_corrupt_file_is_quarantined(tmp_path, monkeypatch):
    monkeypatch.setattr(tcache, "_retry_sleep", lambda s: None)
    f = tmp_path / "plans.json"
    f.write_text("{not json")
    c = tcache.PlanCache(str(tmp_path))
    assert c.get("k") is None
    assert c.stats.quarantined == 1 and c.stats.misses == 1
    assert (tmp_path / "plans.json.quarantined").exists()
    assert not f.exists()
    c.put("k", _rec())
    assert tcache.PlanCache(str(tmp_path)).peek("k") is not None


def test_cache_reader_racing_writer_retries_not_quarantines(tmp_path,
                                                            monkeypatch):
    f = tmp_path / "plans.json"
    good = json.dumps({"version": tcache.CACHE_VERSION,
                       "entries": {"k": _rec()}})
    f.write_text(good[: len(good) // 2])
    monkeypatch.setattr(tcache, "_retry_sleep",
                        lambda _delay: f.write_text(good))
    c = tcache.PlanCache(str(tmp_path))
    assert c.peek("k") is not None
    assert c.stats.quarantined == 0


def test_cache_injected_corruption_quarantines_and_counts(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(tcache, "_retry_sleep", lambda s: None)
    tcache.PlanCache(str(tmp_path)).put("k", _rec())
    obs = Obs(source="t")
    set_active(obs)
    tinject.set_plan(tinject.FaultPlan.parse("cache.read:corrupt-bytes:0:0"))
    c2 = tcache.PlanCache(str(tmp_path))
    assert c2.get("k") is None
    assert c2.stats.quarantined == 1
    assert obs.metrics.find("counter", "tune.cache.quarantined",
                            path=c2.file).value == 1


def test_cache_version_skew_and_merge_and_clear(tmp_path):
    (tmp_path / "plans.json").write_text(json.dumps(
        {"version": tcache.CACHE_VERSION - 1, "entries": {"old": _rec()}}))
    assert tcache.PlanCache(str(tmp_path)).peek("old") is None
    c1, c2 = tcache.PlanCache(str(tmp_path)), tcache.PlanCache(str(tmp_path))
    c2._load()
    c1.put("a", _rec(1.0))
    c2.put("b", _rec(2.0))
    fresh = tcache.PlanCache(str(tmp_path))
    assert fresh.peek("a") is not None and fresh.peek("b") is not None
    c2.clear()
    assert tcache.PlanCache(str(tmp_path)).peek("a") is None


def test_cache_lru_front_is_bounded_and_stats_count_once(tmp_path):
    c = tcache.PlanCache(str(tmp_path), lru_size=3)
    for i in range(6):
        c.put(f"k{i}", _rec(float(i)))
    assert len(c._lru) == 3 and len(c) == 6
    assert c.lookup("zz", features=[0.0] * 8, dtype="float32", n_cols=8,
                    backend="cuda", max_distance=0.5) is not None
    assert c.lookup("zz", features=[9.0] * 8, dtype="float32", n_cols=8,
                    backend="cuda", max_distance=0.5) is None
    assert (c.stats.hits, c.stats.near_hits, c.stats.misses) == (0, 1, 1)
    assert str(c.stats) == "hits=0 near=1 misses=1 rate=0.50"
