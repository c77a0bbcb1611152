"""The port's serving layer on the CPU against the reference's.

* ``sample_token`` draws what the reference's draws from the same logits.
* The pure scheduler and session: every fake-clock test of
  ``tests/test_serve_queue.py`` runs again against ``repro_torch.serve``
  (the same test bodies with the package swapped), one case each.
* The grid mirrors: the port scheduler's ``batch_block`` /
  ``padded_batch`` / ``MAX_BATCH_BLOCK`` equal the port engine's.
* The queue: coalesced == sequential within the port at temperature 0
  and 0.7, and the port's streams equal the reference's *sequential*
  queue (its coalesced 0.7 case is a known red of the reference,
  ROADMAP §C) on the same fp32 weights, at the reduced llama config.
* The queue's seams: with an ``Obs`` capture and one injected
  ``serve.step`` fault under retries, the tokens equal a plain run's, the
  retry is counted and the histograms count every request and call.
* ``launch.serve.main`` end to end on the CPU, with ``--obs`` writing a
  capture that the reference's loader reads (the plan-cache warm-up: layer
  0 searches, later layers hit).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TEST_SEED
from repro.configs import REDUCED as REF_REDUCED
from repro.launch.mesh import make_test_mesh
from repro.models import api as ref_api
from repro.serve import queue as ref_queue
from repro.serve.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch.configs import REDUCED
from repro_torch.kernels import engine
from repro_torch.kernels import flash_attention as b5
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.obs import Obs, set_active
from repro_torch.resilience import inject
from repro_torch.serve import queue, scheduler
from repro_torch.serve.scheduler import SchedulerConfig

ARCH = "llama3.2-1b"

# The reference's pure scheduler/session tests, with ``repro.serve``
# swapped for ``repro_torch.serve`` (decided from the file's text alone,
# so every worker collects the same cases).
_REF_TESTS = pathlib.Path(__file__).with_name("test_serve_queue.py")
_PORT_NS = {"__name__": "test_serve_queue_on_port",
            "__file__": str(_REF_TESTS)}
exec(compile(_REF_TESTS.read_text().replace("repro.serve",
                                            "repro_torch.serve"),
             str(_REF_TESTS), "exec"), _PORT_NS)
PURE_CASES = sorted(n for n in _PORT_NS if n.startswith("test_"))


@pytest.mark.parametrize("name", PURE_CASES)
def test_pure_serving_layer_mirrors_reference(name):
    _PORT_NS[name]()


def test_grid_mirrors_match_engine():
    assert scheduler.MAX_BATCH_BLOCK == engine.MAX_BATCH_BLOCK
    for batch in range(1, 41):
        assert scheduler.batch_block(batch) == engine.batch_block(batch)
        assert scheduler.padded_batch(batch) == engine.padded_batch(batch)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_matches_reference(rng, temperature):
    for index in range(20):
        row = rng.normal(size=256).astype(np.float32)
        kw = dict(temperature=temperature, seed=3, rid=17, index=index)
        assert queue.sample_token(row, **kw) == ref_queue.sample_token(
            row, **kw)


def test_pad_cache_matches_reference(rng):
    ref_cfg, cfg = REF_REDUCED[ARCH](), REDUCED[ARCH]()
    k = rng.standard_normal((2, 3, 5, 2, 16)).astype(np.float32)
    want = ref_queue.pad_cache(ref_cfg, {"k": jnp.asarray(k),
                                         "v": jnp.asarray(k)}, 9)
    got = queue.pad_cache(cfg, {"k": torch.from_numpy(k),
                                "v": torch.from_numpy(k)}, 9)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


# ---------------------------------------------------------------------------
# the queue
# ---------------------------------------------------------------------------

PROMPT_LEN = 8
GEN_LENS = [3, 2, 3]          # mixed budgets: early exit rides
RIDS = [1000, 1001, 1002]     # pinned -> same sampling streams


@pytest.fixture(scope="module")
def serving():
    """Reduced llama in fp32: the reference's parameters and the port's
    copy of them."""
    ref_cfg = dataclasses.replace(REF_REDUCED[ARCH](), dtype=jnp.float32)
    cfg = dataclasses.replace(REDUCED[ARCH](), dtype=torch.float32)
    ref_params = ref_api.init_params(ref_cfg, jax.random.key(TEST_SEED))
    params = transformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    rng = np.random.default_rng(TEST_SEED + 11)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in GEN_LENS]
    return ref_cfg, ref_params, cfg, params, prompts


def _drive(q, prompts):
    """Submit everything at t=0 on a virtual clock and run to idle."""
    reqs = [q.submit(p, g, now=0.0, rid=rid)
            for p, g, rid in zip(prompts, GEN_LENS, RIDS)]
    t = 0.0
    while q.pending:
        if not q.step(now=t):
            break
        t += 1.0
    return reqs


def _configs(cls):
    coalesced = cls(max_in_flight=2, max_batch=8, min_batch=1,
                    max_wait_s=0.0)
    sequential = cls(max_in_flight=1, max_batch=1, min_batch=1,
                     max_wait_s=0.0)
    return coalesced, sequential


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_port_coalesced_equals_sequential(serving, temperature):
    _, _, cfg, params, prompts = serving
    queues = [queue.ServeQueue(cfg, params, config=c,
                               temperature=temperature, seed=TEST_SEED,
                               record_logits=True)
              for c in _configs(SchedulerConfig)]
    batched, sequential = queues
    b_reqs, s_reqs = _drive(batched, prompts), _drive(sequential, prompts)
    assert batched.sched.counters["prefill_batches"] == 1
    assert sequential.sched.counters["prefill_batches"] == 3
    assert len(batched.engine_s["prefill"]) == 1
    for br, sr in zip(b_reqs, s_reqs):
        assert br.tokens == sr.tokens and len(br.tokens) == br.gen_len
        for bl, sl in zip(batched.logits_log[br.rid],
                          sequential.logits_log[sr.rid]):
            np.testing.assert_allclose(bl, sl, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_port_streams_equal_reference_sequential(serving, temperature):
    ref_cfg, ref_params, cfg, params, prompts = serving
    ref = ref_queue.ServeQueue(
        ref_cfg, make_test_mesh(1, 1), ref_params, temperature=temperature,
        seed=TEST_SEED, record_logits=True,
        config=_configs(RefSchedulerConfig)[1])
    port = queue.ServeQueue(cfg, params, temperature=temperature,
                            seed=TEST_SEED, record_logits=True,
                            config=_configs(SchedulerConfig)[1])
    r_reqs, p_reqs = _drive(ref, prompts), _drive(port, prompts)
    for rr, pr in zip(r_reqs, p_reqs):
        assert pr.tokens == rr.tokens, f"rid {pr.rid} diverged"
        for rl, pl in zip(ref.logits_log[rr.rid], port.logits_log[pr.rid]):
            np.testing.assert_allclose(pl, rl, rtol=1e-5, atol=1e-5)


def test_launch_serve_main_on_cpu(capsys):
    before = b5.flash_attention.launches
    q = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "3", "--prompt-len", "8",
                           "--gen-len", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out
    assert len(q.completed) == 3
    assert all(len(r.tokens) == 4 for r in q.completed)
    assert q.sched.counters["prefill_batches"] == 2
    assert b5.flash_attention.launches == before    # CPU: plain version


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--batch", "1",
                           "--prompt-len", "4", "--gen-len", "2"])


def _counter(obs, name, **labels):
    inst = obs.metrics.find("counter", name, **labels)
    return inst.value if inst is not None else 0.0


def test_queue_obs_and_injected_step_fault_keep_the_tokens(serving):
    _, _, cfg, params, prompts = serving
    coalesced = _configs(SchedulerConfig)[0]
    plain = queue.ServeQueue(cfg, params, config=coalesced, seed=TEST_SEED)
    want = [r.tokens for r in _drive(plain, prompts)]
    obs = Obs(source="t")
    prev = set_active(obs)
    inject.set_plan(inject.FaultPlan.parse("serve.step:raise:1"))
    try:
        q = queue.ServeQueue(
            cfg, params, config=coalesced, seed=TEST_SEED, obs=obs,
            retry_kw=dict(retries=2, backoff_s=1e-4,
                          on_retry=lambda n, e: inject.note_degraded(
                              "serve.retries")))
        got = [r.tokens for r in _drive(q, prompts)]
        fired = _counter(obs, "inject.fired", site="serve.step",
                         kind="raise")
        # without retries the same fault propagates
        inject.get_plan().reset()
        bare = queue.ServeQueue(cfg, params, config=coalesced,
                                seed=TEST_SEED)
        with pytest.raises(inject.InjectedFault):
            _drive(bare, prompts)
    finally:
        inject.set_plan(None)
        set_active(prev)
    assert got == want
    assert fired == 1 and _counter(obs, "serve.retries") == 1
    n_decode = len(q.engine_s["decode"])
    assert _counter(obs, "serve.requests") == len(prompts)
    assert _counter(obs, "serve.prefill_calls") == 1
    assert _counter(obs, "serve.decode_calls") == n_decode
    hist = {n: obs.metrics.find("hist", n).count for n in (
        "serve.prefill_us", "serve.request_us", "serve.ttft_us",
        "serve.decode_token_us")}
    assert hist["serve.prefill_us"] == hist["serve.request_us"] == \
        hist["serve.ttft_us"] == len(prompts)
    assert hist["serve.decode_token_us"] == sum(g - 1 for g in GEN_LENS)
    assert obs.metrics.find("hist", "step.wall_us", op="decode").count == \
        n_decode
    assert obs.metrics.find("gauge", "serve.queue_depth").value == 0


def test_launch_serve_obs_writes_a_capture(tmp_path, monkeypatch, capsys):
    from repro.obs.export import load_obs as ref_load_obs
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    monkeypatch.setenv("REPRO_FAULT_PLAN", "serve.step:raise:0")
    try:
        q = launch_serve.main([
            "--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "3", "--obs", "cap",
            "--obs-dir", str(tmp_path / "obs"), "--retry-backoff-ms", "0.1"])
    finally:
        inject.set_plan(None)
    assert "obs summary" in capsys.readouterr().out
    assert len(q.completed) == 2
    recs = ref_load_obs(tmp_path / "obs" / "cap.jsonl")
    assert (tmp_path / "obs" / "cap.trace.json").exists()

    def value(kind, metric, **labels):
        return next(r["value"] if kind != "hist" else r["count"]
                    for r in recs if r["kind"] == kind
                    and r["metric"] == metric and r["labels"] == labels)
    layers = REDUCED[ARCH]().num_layers
    assert value("gauge", "serve.warm_layers") == layers
    assert value("gauge", "tune.cache.misses", cache="serve-warm") == 1
    assert value("gauge", "tune.cache.hits", cache="serve-warm") + value(
        "gauge", "tune.cache.near_hits", cache="serve-warm") == layers - 1
    assert value("gauge", "tune.cache.prewarmed", cache="serve-pool") == \
        value("gauge", "serve.prewarmed_plans") >= 1
    assert value("counter", "serve.retries") == 1
    assert value("counter", "serve.degraded", reason="retry") == 1
    assert value("hist", "serve.ttft_us") == 2
    assert value("counter", "serve.tokens_generated") == 6
    assert any(r["kind"] == "counter" and r["metric"] == "engine.dispatch"
               for r in recs)
