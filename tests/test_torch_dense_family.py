"""The dense family's other three configs (ROADMAP A.13, item 7a) against
the reference on the CPU: granite-34b (MQA, kv 1), internlm2-20b (kv 8)
and qwen3-32b (qk-norm, hd 128), each at its ``reduced()`` (2 layers, d
64, 4 heads), fp32, with the reference's own parameters carried over by
``params_from_numpy`` / ``shard_params``.

* The configs: the port registers the reference's dense four in its
  order, with the reference's fields, and the published sizes count the
  reference's parameters.
* One device: prefill and 4 decode steps' logits (1e-5 of max(1, max
  |logits|)), and ``train_loss`` with every gradient leaf (loss 1e-5
  relative, leaves 1e-4 of max(1, max |g|)), as ``tests/test_torch_lm.py``
  and ``tests/test_torch_train.py`` hold llama.
* A (1, 2) mesh of gloo ranks (processes of their own, as in
  ``tests/test_torch_mesh.py``): the same logits and the gathered
  gradients against the same one-device reference, at the same
  tolerances; granite's one kv head stays whole on both ranks (each q head
  reads it), and qwen3's ``q_norm``/``k_norm`` stay whole while its heads
  split.
* qk-norm's seams: ``param_specs`` of the ``q_norm``/``k_norm`` leaves
  equal the reference's; a checkpoint round trip carries them;
  ``check_supported`` takes qk-norm and still rejects the other
  families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh as ref_abstract_mesh
from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import REDUCED as REF_REDUCED
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as rshr
from repro.launch import specs as rspecs
from repro.models import api as ref_api
from repro_torch.checkpoint import restore, save
from repro_torch.configs import ALL_ARCHS, REDUCED, get_config
from repro_torch.dist import sharding as tshr
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import api, transformer
from test_torch_mesh import _port_tree, _ref_leaf, _spawn, _unstacked
from test_torch_serve_mesh import EXIT

ARCHS = ("granite-34b", "internlm2-20b", "qwen3-32b")
DENSE = ("qwen3-32b", "granite-34b", "llama3.2-1b", "internlm2-20b")
LOGIT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
PROMPT, STEPS = 12, 4


def _cfgs(arch):
    ref = dataclasses.replace(REF_REDUCED[arch](), dtype=jnp.float32)
    port = dataclasses.replace(REDUCED[arch](), dtype=torch.float32)
    return ref, port


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _ref_serving(rcfg, rp, tokens):
    """The reference's prefill of ``tokens[:, :PROMPT]`` and its decode of
    the rest: the logits of every call, stacked."""
    cache, logits = ref_api.prefill(
        rcfg, rp, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    cache = jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]),
        cache)
    out = [np.asarray(logits)]
    for i in range(STEPS):
        cache, logits = ref_api.decode_step(
            rcfg, rp, cache, jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
            jnp.int32(PROMPT + i))
        out.append(np.asarray(logits))
    return np.stack(out)


def _ref_train(rcfg, rp, seq):
    tokens, labels = seq[:, :-1], seq[:, 1:].copy()
    labels[:, -1] = -1
    mb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss, _), g = jax.value_and_grad(
        lambda p: ref_api.train_loss(rcfg, p, mb), has_aux=True)(rp)
    return tokens, labels, float(loss), g


@pytest.fixture(scope="module")
def carried():
    """Per arch: the reference's config, fp32 parameters (seed 0) and the
    port's copy of them."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = _cfgs(arch)
        rp = ref_api.init_params(rcfg, jax.random.key(0))
        out[arch] = (rcfg, rp, cfg, transformer.params_from_numpy(
            cfg, jax.tree.map(np.asarray, rp), device="cpu"))
    return out


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

def test_registry_holds_the_dense_four_in_the_reference_order():
    assert ALL_ARCHS == tuple(a for a in REF_ARCHS if a in DENSE) == DENSE
    assert set(REDUCED) == set(DENSE)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_and_count_its_parameters(arch):
    fields = [f.name for f in dataclasses.fields(get_config(arch))
              if f.name != "dtype"]
    for full in (False, True):
        ref = ref_get_config(arch) if full else REF_REDUCED[arch]()
        port = get_config(arch) if full else REDUCED[arch]()
        assert {f: getattr(port, f) for f in fields} == \
            {f: getattr(ref, f) for f in fields}
        assert str(port.dtype).split(".")[-1] == str(jnp.dtype(ref.dtype))
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: ref_api.init_params(rcfg,
                                                   jax.random.key(0)))))
    got = api.num_params(transformer.LM(cfg, torch.device("meta")))
    assert got == want


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(carried, arch):
    rcfg, rp, cfg, params = carried[arch]
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT + STEPS))
    want = _ref_serving(rcfg, rp, tokens.astype(np.int32))
    cache = api.init_cache(cfg, 2, PROMPT + STEPS, device="cpu")
    _, logits = api.prefill(cfg, params,
                            {"tokens": torch.from_numpy(tokens[:, :PROMPT])},
                            cache=cache)
    got = [logits.numpy()]
    for i in range(STEPS):
        _, logits = api.decode_step(
            cfg, params, cache,
            torch.from_numpy(tokens[:, PROMPT + i:PROMPT + i + 1]),
            PROMPT + i)
        got.append(logits.numpy())
    _close(np.stack(got), want, LOGIT_TOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(carried, arch):
    rcfg, rp, cfg, params = carried[arch]
    seq = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 17))
    tokens, labels, want_loss, g = _ref_train(rcfg, rp, seq)
    loss, aux = api.train_loss(cfg, params, {
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    want = _port_tree(g, cfg)
    names = [n for n, _ in params.named_parameters()]
    assert set(want) == {"p/" + n for n in names}
    for name, grad in zip(names, grads):
        _close(grad.numpy(), want["p/" + name], GRAD_TOL, name)


# ---------------------------------------------------------------------------
# a (1, 2) mesh
# ---------------------------------------------------------------------------

_MESH_BODY = """
import json
from repro_torch.dist import sharding as shr
mesh = make_test_mesh(1, 2, device="cpu")
for arch in json.loads(str(inp["archs"])):
    cfg = dataclasses.replace(REDUCED[arch](), dtype=torch.float32)
    lm = transformer.LM(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            p.copy_(torch.from_numpy(inp[arch + "/p/" + name]))
    params = api.shard_params(cfg, lm, mesh, device="cpu")
    lay = params.layout
    out[arch + "/kv_take"] = np.array(lay.kv_take or [-1])
    out[arch + "/wk_cols"] = np.array(params.layers[0].attn.wk.shape[1])
    tokens = inp[arch + "/serve"]
    prompt = int(inp["prompt"])
    bsz, total = tokens.shape
    cache = step_lib.local_cache(cfg, mesh, bsz, total, device="cpu")
    prefill = step_lib.build_prefill(cfg, params, (bsz, prompt), mesh=mesh,
                                     cache=cache)
    decode = step_lib.build_serve_step(cfg, params, cache, mesh=mesh)
    _, logits = prefill({"tokens": tokens[:, :prompt]})
    got = [logits.numpy()]
    for i in range(total - prompt):
        _, logits = decode(tokens[:, prompt + i:prompt + i + 1], prompt + i)
        got.append(logits.numpy())
    out[arch + "/logits"] = np.stack(got)
    loss, _ = api.train_loss(cfg, params, {
        "tokens": torch.from_numpy(inp[arch + "/tokens"]),
        "labels": torch.from_numpy(inp[arch + "/labels"])})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    sh = shr.spec_to_sharding(lay.specs, mesh)
    out[arch + "/loss"] = float(loss)
    for (n, _), g in zip(params.named_parameters(), grads):
        out[arch + "/g/" + n] = sh[n].gather(g).numpy()
""" + EXIT


def test_on_a_1x2_mesh_match_reference(tmp_path, carried):
    """The three reduced configs on a (1, 2) mesh against the reference's
    one-device logits, loss and gradients: heads split over the two ranks
    (granite's one kv head whole on both, each q head reading it),
    qk-norm's scales whole with their gradients summed over ``model``."""
    import json
    inputs, want = {"archs": np.array(json.dumps(list(ARCHS))),
                    "prompt": np.array(PROMPT)}, {}
    for i, arch in enumerate(ARCHS):
        rcfg, rp, cfg, _ = carried[arch]
        rng = np.random.default_rng(20 + i)
        serve = rng.integers(0, cfg.vocab_size, (2, PROMPT + STEPS))
        seq = rng.integers(0, cfg.vocab_size, (2, 17))
        tokens, labels, loss, g = _ref_train(rcfg, rp, seq)
        want[arch] = (_ref_serving(rcfg, rp, serve.astype(np.int32)), loss,
                      _port_tree(g, cfg))
        inputs.update({arch + "/serve": serve, arch + "/tokens": tokens,
                       arch + "/labels": labels})
        inputs.update({arch + "/" + k: v
                       for k, v in _port_tree(rp, cfg).items()})
    outs = _spawn(tmp_path, 2, _MESH_BODY, **inputs)
    for r, o in enumerate(outs):
        for arch in ARCHS:
            logits, loss, grads = want[arch]
            _close(o[arch + "/logits"], logits, LOGIT_TOL, (r, arch))
            assert abs(float(o[arch + "/loss"]) - loss) <= \
                LOSS_TOL * abs(loss), (r, arch)
            for name, ref in grads.items():
                _close(o[arch + "/g/" + name[2:]], ref, GRAD_TOL,
                       (r, arch, name))
        # granite (4 heads, MQA): wk/wv whole on each rank, its 2 local q
        # heads both reading kv head 0; internlm2 and qwen3 (kv 2) split
        hd = REDUCED["granite-34b"]().resolved_head_dim
        assert list(o["granite-34b/kv_take"]) == [0, 0]
        assert int(o["granite-34b/wk_cols"]) == hd
        for arch in ("internlm2-20b", "qwen3-32b"):
            assert list(o[arch + "/kv_take"]) == [-1]
            assert int(o[arch + "/wk_cols"]) == \
                REDUCED[arch]().resolved_head_dim


# ---------------------------------------------------------------------------
# qk-norm's seams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    ((1, 2), ("data", "model")), ((2, 4), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))], ids=["1x2", "2x4", "pod2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, shape, names):
    rcfg, cfg = _cfgs(arch)
    want = rshr.param_specs(rspecs.abstract_params(rcfg),
                            ref_abstract_mesh(shape, names), rcfg)
    skel = transformer.LM(cfg, torch.device("meta"))
    got = tshr.param_specs(skel, abstract_mesh(shape, names), cfg)
    assert set(got) == {n for n, _ in skel.named_parameters()}
    for name, spec in got.items():
        ref, stacked = _ref_leaf(want, name)
        assert tuple(spec) == _unstacked(ref, stacked), name
    norms = [n for n in got if ".q_norm." in n or ".k_norm." in n]
    assert len(norms) == (2 * cfg.num_layers if cfg.qk_norm else 0)
    assert all(got[n] == () for n in norms)


def test_checkpoint_round_trip_carries_qk_norm(tmp_path, carried):
    cfg = carried["qwen3-32b"][2]
    params = api.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    with torch.no_grad():
        for blk in params.layers:
            blk.attn.q_norm.scale.uniform_(0.5, 1.5)
            blk.attn.k_norm.scale.uniform_(0.5, 1.5)
    tree = {"params": params.state_dict()}
    names = [k for k in tree["params"] if "q_norm" in k or "k_norm" in k]
    assert len(names) == 2 * cfg.num_layers
    save(str(tmp_path), 1, tree)
    fresh = api.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    step, restored, _ = restore(str(tmp_path), {"params":
                                                fresh.state_dict()})
    assert step == 1
    with torch.no_grad():
        fresh.load_state_dict(restored["params"])
    for name in names:
        assert torch.equal(fresh.state_dict()[name],
                           params.state_dict()[name]), name


def test_check_supported_takes_qk_norm_and_rejects_other_families():
    cfg = REDUCED["qwen3-32b"]()
    assert cfg.qk_norm
    transformer.check_supported(cfg)
    lm = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(lm.layers[0].attn.q_norm.scale,
                       torch.ones(cfg.resolved_head_dim, dtype=cfg.dtype))
    for family in ("moe", "ssm", "hybrid", "audio", "vlm"):
        with pytest.raises(NotImplementedError, match="A.13"):
            transformer.check_supported(dataclasses.replace(cfg,
                                                            family=family))
