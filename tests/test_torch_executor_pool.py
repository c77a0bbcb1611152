"""The port's serve executor pool on the CPU against the reference's.

At the reduced llama3.2-1b config (2 layers, d 64, 4 heads, 2 kv heads,
hd 16, vocab 256) with the reference's fp32 weights carried over by
``transformer.params_from_numpy``:

* (a) ``decode_step`` with a 0-d tensor ``length`` equals the reference's
  ``decode_step`` within 1e-5 of max(1, max |logit|) (``test_torch_lm.py``'s
  fp32 tolerance) for 4 steps after a 12-token prefill, and the port's
  ``int`` path bitwise;
* (b) one sequence of ``bundle()`` / ``warm()`` calls gives both packages'
  ``ExecutorPool`` the same ``builds``, ``len()`` and bucket keys;
* (c) a pool-driven ``ServeQueue`` emits, at temperature 0 and 0.7, the
  reference's *sequential* streams (its coalesced 0.7 case is a known red
  of the reference, ROADMAP §C) and its own sequential queue's;
* (d) two groups of one bucket in flight at once take two slots and emit
  what each emits alone;
* (e) an injected ``serve.prefill`` / ``serve.step`` fault under retries
  keeps the tokens, and every slot is free afterwards;
* (f) a position past a slot's capacity raises ``ValueError`` before
  anything runs;
* (g) ``repro_torch.benchmarks.serve_traffic``'s smoke load makes the
  reference's scheduling decisions (the structural columns of
  ``tests/test_serve_batching.py``) on the same ``REPRO_TEST_SEED``, and
  the same on two runs.

On the CPU the pool's steps run eagerly over their static buffers; the
CUDA-graph capture and the launch counting under replay are held on the
card by ``tests/test_torch_gpu.py``.
"""
import dataclasses

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
from repro_torch.benchmarks import serve_traffic
from repro_torch.configs import REDUCED
from repro_torch.models import api, transformer
from repro_torch.resilience import inject
from repro_torch.serve import queue
from repro_torch.serve.scheduler import SchedulerConfig

ARCH = "llama3.2-1b"
TOL = 1e-5
PROMPT_LEN = 8
GEN_LENS = [3, 2, 3]
RIDS = [1000, 1001, 1002]
# the reference's structural columns (tests/test_serve_batching.py)
STRUCTURAL = ("n_requests", "completed", "rejected", "evicted",
              "prefill_batches", "decode_steps", "engine_calls",
              "padded_slots", "tokens")


@pytest.fixture(scope="module")
def carried():
    """Reduced llama in fp32: the reference's parameters and the port's
    copy of them, and three seeded prompts."""
    ref_cfg = dataclasses.replace(REF_REDUCED[ARCH](), dtype=jnp.float32)
    cfg = dataclasses.replace(REDUCED[ARCH](), dtype=torch.float32)
    ref_params = ref_api.init_params(ref_cfg, jax.random.key(TEST_SEED))
    params = transformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    rng = np.random.default_rng(TEST_SEED + 11)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in GEN_LENS]
    return ref_cfg, ref_params, cfg, params, prompts


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got, np.float32) - want).max()) \
        <= TOL * scale


def _drive(q, prompts, gen_lens=GEN_LENS, rids=RIDS):
    """Submit everything at t=0 on a virtual clock and run to idle."""
    reqs = [q.submit(p, g, now=0.0, rid=rid)
            for p, g, rid in zip(prompts, gen_lens, rids)]
    t = 0.0
    while q.pending:
        if not q.step(now=t):
            break
        t += 1.0
    return reqs


def _coalesced(cls):
    return cls(max_in_flight=2, max_batch=8, min_batch=1, max_wait_s=0.0)


def _sequential(cls):
    return cls(max_in_flight=1, max_batch=1, min_batch=1, max_wait_s=0.0)


# ---------------------------------------------------------------------------
# (a) decode_step with a tensor length
# ---------------------------------------------------------------------------

def test_tensor_length_decode_matches_reference_and_int_path(carried, rng):
    ref_cfg, ref_params, cfg, params, _ = carried
    B, S, steps = 2, 12, 4
    toks = rng.integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    ref_cache, _ = ref_api.prefill(ref_cfg, ref_params,
                                   {"tokens": jnp.asarray(toks[:, :S])})
    ref_cache = ref_queue.pad_cache(ref_cfg, ref_cache, S + steps)
    cache_t = api.init_cache(cfg, B, S + steps, device="cpu")
    api.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :S])},
                cache=cache_t)
    cache_i = {k: v.clone() for k, v in cache_t.items()}
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        ref_cache, want = ref_api.decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(tok),
            jnp.int32(S + i))
        length = torch.tensor(S + i, dtype=torch.int32)
        out, got = api.decode_step(cfg, params, cache_t,
                                   torch.from_numpy(tok), length)
        assert out is cache_t
        _, got_int = api.decode_step(cfg, params, cache_i,
                                     torch.from_numpy(tok), S + i)
        _close(got.numpy(), want)
        assert torch.equal(got, got_int)
    for name in ("k", "v"):
        assert torch.equal(cache_t[name], cache_i[name])
        _close(cache_t[name].numpy(), ref_cache[name])


def test_decode_length_forms_are_validated(carried):
    _, _, cfg, params, _ = carried
    cache = api.init_cache(cfg, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    for bad in (4, -1):
        with pytest.raises(ValueError, match="outside"):
            api.decode_step(cfg, params, cache, tok, bad)
    for bad in (torch.tensor([1]), torch.tensor(1.0)):
        with pytest.raises(ValueError, match="0-d int32/int64"):
            api.decode_step(cfg, params, cache, tok, bad)
    # a prefill cache shorter than the prompt
    with pytest.raises(ValueError, match="the prefill needs"):
        api.prefill(cfg, params, {"tokens": torch.zeros((1, 5), dtype=int)},
                    cache=cache)
    assert not cache["k"].any()


# ---------------------------------------------------------------------------
# (b) the pool's buckets
# ---------------------------------------------------------------------------

def test_pool_buckets_match_reference(carried):
    ref_cfg, ref_params, cfg, params, _ = carried
    ref = ref_queue.ExecutorPool(ref_cfg, make_test_mesh(1, 1), ref_params)
    port = queue.ExecutorPool(cfg, params)
    for pool in (ref, port):
        pool.bundle(2, 8, 16)
        pool.bundle(2, 8, 16)
        assert pool.warm([(3, 4, 8), (2, 8, 16), (3, 4, 8)]) == 2
        pool.bundle(1, 4, 8)
    assert port.builds == ref.builds == 3
    assert len(port) == len(ref) == 3
    assert list(port._bundles) == list(ref._bundles)
    # warm() built one slot in each warmed bucket; bundle() builds none
    assert port.slots == 2 and port.peak_in_use == 1
    assert all(len(b.free) == len(b.slots) for b in port._bundles.values())


# ---------------------------------------------------------------------------
# (c)-(e) the pool-driven queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_pool_queue_streams_equal_reference_sequential(carried,
                                                       temperature):
    ref_cfg, ref_params, cfg, params, prompts = carried
    ref = ref_queue.ServeQueue(
        ref_cfg, make_test_mesh(1, 1), ref_params, temperature=temperature,
        seed=TEST_SEED, record_logits=True,
        config=_sequential(RefSchedulerConfig))
    pool = queue.ExecutorPool(cfg, params)
    coalesced, sequential = (
        queue.ServeQueue(cfg, params, pool=pool, config=c(SchedulerConfig),
                         temperature=temperature, seed=TEST_SEED,
                         record_logits=True)
        for c in (_coalesced, _sequential))
    r_reqs = _drive(ref, prompts)
    c_reqs, s_reqs = _drive(coalesced, prompts), _drive(sequential, prompts)
    assert coalesced.sched.counters["prefill_batches"] == 1
    assert sequential.sched.counters["prefill_batches"] == 3
    for rr, cr, sr in zip(r_reqs, c_reqs, s_reqs):
        assert cr.tokens == sr.tokens == rr.tokens, f"rid {rr.rid}"
        for rl, cl in zip(ref.logits_log[rr.rid], coalesced.logits_log[
                cr.rid]):
            _close(cl, rl)
    # one bucket for the coalesced group, one whose slot the three
    # sequential groups reuse in turn (budgets 2 and 3 round up to 8)
    assert sorted(pool._bundles) == [(1, 8, 16), (3, 8, 16)]
    assert pool.slots == 2 and pool.peak_in_use == 1


def test_two_groups_of_one_bucket_take_two_slots(carried):
    _, _, cfg, params, prompts = carried
    gens, rids = [3, 3], [7, 8]
    pool = queue.ExecutorPool(cfg, params)
    both = queue.ServeQueue(
        cfg, params, pool=pool, seed=TEST_SEED, temperature=0.7,
        config=SchedulerConfig(max_in_flight=2, max_batch=1, min_batch=1,
                               max_wait_s=0.0))
    got = [r.tokens for r in _drive(both, prompts[:2], gens, rids)]
    assert pool.slots == 2 and pool.peak_in_use == 2 and len(pool) == 1
    for i in range(2):
        alone = queue.ServeQueue(cfg, params, seed=TEST_SEED,
                                 temperature=0.7,
                                 config=_sequential(SchedulerConfig))
        [req] = _drive(alone, prompts[i:i + 1], gens[i:i + 1],
                       rids[i:i + 1])
        assert req.tokens == got[i] and len(req.tokens) == 3


@pytest.mark.parametrize("site", ["serve.prefill", "serve.step"])
def test_injected_fault_under_retries_keeps_the_tokens(carried, site):
    _, _, cfg, params, prompts = carried
    plain = queue.ServeQueue(cfg, params, config=_coalesced(SchedulerConfig),
                             seed=TEST_SEED)
    want = [r.tokens for r in _drive(plain, prompts)]
    pool = queue.ExecutorPool(cfg, params)
    inject.set_plan(inject.FaultPlan.parse(f"{site}:raise:0"))
    try:
        q = queue.ServeQueue(cfg, params, pool=pool, seed=TEST_SEED,
                             config=_coalesced(SchedulerConfig),
                             retry_kw=dict(retries=2, backoff_s=1e-4))
        got = [r.tokens for r in _drive(q, prompts)]
        inject.get_plan().reset()
        bare = queue.ServeQueue(cfg, params, pool=pool, seed=TEST_SEED,
                                config=_coalesced(SchedulerConfig))
        with pytest.raises(inject.InjectedFault):
            _drive(bare, prompts)
    finally:
        inject.set_plan(None)
    assert got == want
    if site == "serve.prefill":     # the failed prefill gave its slot back
        assert all(len(b.free) == len(b.slots)
                   for b in pool._bundles.values())
    assert pool.slots == 1


def test_position_past_the_slot_raises_before_running(carried):
    _, _, cfg, params, _ = carried
    pool = queue.ExecutorPool(cfg, params)
    slot = pool.acquire(pool.bundle(2, 4, 8))
    assert slot.cache["k"].shape[2] == 8
    tok = np.ones((2, 1), np.int64)
    _, logits = slot.serve_fn(tok, 7)          # the last position
    assert logits.shape == (2, cfg.vocab_padded())
    before = {k: v.clone() for k, v in slot.cache.items()}
    for bad in (8, 100, -1):
        with pytest.raises(ValueError, match="past the slot"):
            slot.serve_fn(tok, bad)
    for k in before:
        assert torch.equal(slot.cache[k], before[k])


# ---------------------------------------------------------------------------
# (g) the load benchmark
# ---------------------------------------------------------------------------

def test_serve_traffic_smoke_matches_reference_structure():
    from benchmarks import serve_traffic as ref_serve_traffic

    def run(mod, **kw):
        records = []
        mod.main(out=lambda line: None, record=records.append, smoke=True,
                 n_clients=2, rounds=1, **kw)
        return records

    want = run(ref_serve_traffic)
    first = run(serve_traffic, device="cpu")
    second = run(serve_traffic, device="cpu")
    assert [r["matrix"] for r in first] == ["batched", "sequential"]
    for w, a, b in zip(want, first, second):
        assert w["matrix"] == a["matrix"] == b["matrix"]
        assert set(a) == set(w)
        for col in STRUCTURAL:
            assert a[col] == w[col] == b[col], f"{a['matrix']}.{col}"
        assert a["completed"] == a["n_requests"]
