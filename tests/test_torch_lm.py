"""The port's dense LM on the CPU against ``repro.models.api``, at the
reduced llama3.2-1b config (2 layers, d 64, 4 heads, 2 kv heads, hd 16,
vocab 256), with the reference's own parameters carried over by
``params_from_numpy``.

Tolerances, relative to max(1, max |reference|): fp32 1e-5 (the two packages run
the same fp32 arithmetic in another order); bf16 2e-2 (both round to bf16
at the same points -- matmul outputs, norms, rope, attention -- but a sum
that lands within an ulp of a rounding boundary rounds the other way, and
such one-ulp (0.4%) flips in the hidden state feed every later layer; at
this size the logits move by 0.3-0.6% over seeds 0-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED as REF_REDUCED
from repro.models import api as ref_api
from repro.serve.queue import pad_cache as ref_pad_cache
from repro_torch.configs import REDUCED, get_config
from repro_torch.models import api, transformer
from repro_torch.serve.queue import ServeQueue, pad_cache

ARCH = "llama3.2-1b"
CASES = [("float32", 1e-5), ("bfloat16", 2e-2)]


def _cfgs(dname):
    ref = dataclasses.replace(REF_REDUCED[ARCH](), dtype=getattr(jnp, dname))
    port = dataclasses.replace(REDUCED[ARCH](), dtype=getattr(torch, dname))
    return ref, port


@pytest.fixture(scope="module")
def carried():
    """(ref cfg, ref params, port cfg, port params) per dtype, the port's
    weights carried from the reference's."""
    out = {}
    for dname, _ in CASES:
        ref_cfg, cfg = _cfgs(dname)
        ref_params = ref_api.init_params(ref_cfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, ref_params)
        out[dname] = (ref_cfg, ref_params, cfg,
                      transformer.params_from_numpy(cfg, tree, device="cpu"))
    return out


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert float(np.abs(got - want).max()) <= tol * scale


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dname,tol", CASES)
def test_prefill_and_decode_match_reference(carried, rng, dname, tol):
    ref_cfg, ref_params, cfg, params = carried[dname]
    B, S, steps = 2, 12, 4
    toks = rng.integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    ref_cache, ref_logits = ref_api.prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(toks[:, :S])})
    cache, logits = api.prefill(cfg, params,
                                {"tokens": torch.from_numpy(toks[:, :S])})
    assert logits.dtype == torch.float32
    assert logits.shape == ref_logits.shape == (B, cfg.vocab_padded())
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        assert cache[name].dtype == cfg.dtype
        _close(_np(cache[name]), ref_cache[name], tol)
    _close(_np(logits), ref_logits, tol)

    ref_cache = ref_pad_cache(ref_cfg, ref_cache, S + steps)
    cache = pad_cache(cfg, cache, S + steps)
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        ref_cache, ref_logits = ref_api.decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(tok),
            jnp.int32(S + i))
        new_cache, logits = api.decode_step(cfg, params, cache,
                                            torch.from_numpy(tok), S + i)
        assert new_cache is cache                 # updated in place
        _close(_np(logits), ref_logits, tol)
    _close(_np(cache["k"]), ref_cache["k"], tol)


@pytest.mark.parametrize("dname,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_decode_equals_prefill_of_one_more_token(carried, rng, dname, tol):
    """decode_step(token_S | prefill(S)) == prefill(S+1)'s last logits
    (the reference's tests/test_models.py consistency check and its bf16
    tolerance, 5e-2)."""
    _, _, cfg, params = carried[dname]
    B, S = 2, 17
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    cache, _ = api.prefill(cfg, params, {"tokens": toks[:, :S]})
    cache = pad_cache(cfg, cache, S + 1)
    _, got = api.decode_step(cfg, params, cache, toks[:, S:], S)
    _, want = api.prefill(cfg, params, {"tokens": toks})
    _close(_np(got), _np(want), tol)


@pytest.mark.parametrize("batch,max_len", [(1, 8), (3, 40)])
def test_init_cache_matches_reference_shapes(batch, max_len):
    ref_cfg, cfg = _cfgs("bfloat16")
    ref = jax.eval_shape(lambda: ref_api.init_cache(ref_cfg, batch, max_len))
    got = api.init_cache(cfg, batch, max_len, device="cpu")
    assert set(got) == set(ref)
    for name in got:
        assert tuple(got[name].shape) == ref[name].shape
        assert got[name].dtype == torch.bfloat16
        assert not got[name].any()


def test_parameter_tree_and_count(carried):
    ref_cfg, ref_params, cfg, params = carried["float32"]
    assert api.num_params(params) == ref_api.num_params(ref_params)
    # Full width, on the meta device (no memory): llama3.2-1b's 1.236 B.
    full = transformer.LM(get_config(ARCH), torch.device("meta"))
    assert api.num_params(full) == 1_235_814_400
    assert full.embed.shape == (128_256, 2048) and len(full.layers) == 16


def test_carried_weights_are_copies():
    ref_cfg, cfg = _cfgs("float32")
    tree = jax.tree.map(lambda a: np.array(a),
                        ref_api.init_params(ref_cfg, jax.random.key(2)))
    params = transformer.params_from_numpy(cfg, tree, device="cpu")
    before = params.layers[1].attn.wq.clone()
    tree["layers"]["attn"]["wq"][1] += 1.0
    assert torch.equal(params.layers[1].attn.wq, before)
    np.testing.assert_array_equal(
        params.layers[1].attn.wq.detach().numpy() + 1.0,
        tree["layers"]["attn"]["wq"][1])


def test_vocab_padding_never_predicted():
    """The reference pads the vocabulary to a multiple of 256; a sampled
    id must never be a padded one.  With 250 real ids (6 padded rows whose
    embeddings are made large), the padded columns carry the largest
    logits, and the queue still samples only real ids."""
    cfg = dataclasses.replace(REDUCED[ARCH](), vocab_size=250,
                              dtype=torch.float32)
    assert cfg.vocab_padded() % 256 == 0
    assert cfg.vocab_padded() >= cfg.vocab_size
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with torch.no_grad():
        params.embed[250:] *= 500.0
    queue = ServeQueue(cfg, params, record_logits=True)
    rng = np.random.default_rng(5)
    reqs = [queue.submit(rng.integers(0, 250, 6).tolist(), 4, now=0.0)
            for _ in range(3)]
    queue.drain()
    rows = [row for r in reqs for row in queue.logits_log[r.rid]]
    assert any(int(np.argmax(row)) >= 250 for row in rows)
    for r in reqs:
        assert len(r.tokens) == 4 and max(r.tokens) < 250


@pytest.mark.parametrize("change", [{"family": "moe"},
                                    {"sliding_window": 8},
                                    {"qk_norm": True}, {"act": "gelu"},
                                    {"frontend": "vision_stub"}])
def test_unported_variants_raise(change):
    cfg = dataclasses.replace(REDUCED[ARCH](), **change)
    with pytest.raises(NotImplementedError, match="A.13"):
        api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="A.13"):
        api.init_cache(cfg, 1, 8, device="cpu")
