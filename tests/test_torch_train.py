"""LM training in the port against the reference on the CPU, at the reduced
llama3.2-1b config (2 layers, d 64, 4 heads, 2 kv heads, vocab 256), with
the reference's parameters (``params_from_numpy``) and the reference's
batch (``repro.data.global_batch_at``) fed to both packages.

Tolerances: fp32 loss within 1e-5 relative and every gradient leaf within
1e-4 of max(1, max |g|) (the same fp32 arithmetic in another order, the
attention backward recomputed from the log-sum-exp); bf16 at 2e-2 of the
same scales (one-ulp flips of bf16 roundings, as tests/test_torch_lm.py
explains).  AdamW and the flat layout: 1e-6 relative (elementwise fp32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED as REF_REDUCED
from repro.configs.base import ShapeConfig as RefShape
from repro.data import DataConfig as RefData
from repro.data import global_batch_at as ref_batch_at
from repro.dist import step as ref_step
from repro.launch import specs as ref_specs
from repro.launch.mesh import make_test_mesh
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro_torch.configs import REDUCED, SHAPES, ShapeConfig
from repro_torch.dist import step as step_lib
from repro_torch.models import api, transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig

ARCH = "llama3.2-1b"
CASES = [("float32", 1e-5, 1e-4), ("bfloat16", 2e-2, 2e-2)]


def _cfgs(dname, **kw):
    ref = dataclasses.replace(REF_REDUCED[ARCH](), dtype=getattr(jnp, dname),
                              **kw)
    port = dataclasses.replace(REDUCED[ARCH](), dtype=getattr(torch, dname),
                               **kw)
    return ref, port


def _ref_params(cfg, seed=0):
    return ref_api.init_params(cfg, jax.random.key(seed))


def _carry(cfg, ref_params):
    return transformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def _ref_batch(cfg, seq, batch, n_mb, step=0, seed=3):
    return ref_batch_at(RefData(seed=seed), cfg,
                        RefShape("t", seq, batch, "train"), n_mb, step)


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _leaf(tree, name):
    """The reference's leaf for a port parameter name (layers stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node, np.float32)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node, np.float32)


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol:g} * {scale:.3g}"


@pytest.mark.parametrize("dname,loss_tol,grad_tol", CASES)
def test_train_loss_and_grads_match_reference(dname, loss_tol, grad_tol):
    rcfg, pcfg = _cfgs(dname)
    rp = _ref_params(rcfg)
    mb = jax.tree.map(lambda x: x[0], _ref_batch(rcfg, 32, 4, 1))
    (loss, aux), g = jax.value_and_grad(
        lambda p: ref_api.train_loss(rcfg, p, mb), has_aux=True)(rp)
    lm = _carry(pcfg, rp)
    ploss, paux = api.train_loss(pcfg, lm, _torch_batch(mb))
    grads = torch.autograd.grad(ploss, list(lm.parameters()))
    assert float(paux["tokens"]) == float(aux["tokens"]) == 4 * 31
    assert abs(float(ploss) - float(loss)) <= loss_tol * abs(float(loss))
    g = jax.tree.map(np.asarray, g)
    for (name, p), gp in zip(lm.named_parameters(), grads):
        assert gp.dtype == p.dtype and gp.shape == p.shape
        _close(gp.float().numpy(), _leaf(g, name), grad_tol, name)


@pytest.mark.parametrize("ce_chunk", [128, 48, 1])
def test_chunked_ce_masked_labels_and_ragged_chunks(rng, ce_chunk):
    """``chunked_ce`` with half the labels masked, at chunks that divide T
    (128), do not (48: 48 + 48 + 32) and of one token, against the
    reference's (whose chunk always divides T) and a dense float64
    cross-entropy; its gradients against the reference's at 1e-5."""
    rcfg, pcfg = _cfgs("float32", ce_chunk=ce_chunk)
    rp = _ref_params(rcfg)
    lm = _carry(pcfg, rp)
    hidden = rng.standard_normal((4, 32, pcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, pcfg.vocab_size, (4, 32))
    labels[rng.random((4, 32)) < 0.5] = -1
    h = torch.from_numpy(hidden).requires_grad_()
    loss, count = transformer.chunked_ce(pcfg, lm, h, torch.from_numpy(labels))
    dh, dw = torch.autograd.grad(loss, (h, lm.embed))

    def ref(hh, p):
        return ref_tf.chunked_ce(rcfg, p, hh, jnp.asarray(labels))[0]
    rl, (rdh, rdp) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(hidden), rp)
    w = np.asarray(rp["embed"], np.float64)
    logits = hidden.reshape(-1, pcfg.d_model).astype(np.float64) @ w.T
    lz = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) \
        + logits.max(1)
    lab = labels.reshape(-1)
    valid = lab >= 0
    dense = float(np.mean((lz - logits[np.arange(lab.size),
                                       np.maximum(lab, 0)])[valid]))
    assert float(count) == valid.sum()
    assert abs(float(loss) - dense) <= 1e-5 * abs(dense)
    assert abs(float(loss) - float(rl)) <= 1e-5 * abs(float(rl))
    _close(dh.numpy(), np.asarray(rdh), 1e-5, "dh")
    _close(dw.numpy(), np.asarray(rdp["embed"]), 1e-5, "dembed")


def _ref_bundle(cfg, rp, opt, n_mb, seq, batch):
    mesh = make_test_mesh(1, 1)
    pav = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), rp)
    bav = ref_specs.train_batch_specs(cfg, RefShape("t", seq, batch,
                                                    "train"), n_mb)
    return ref_step.build_train_step(cfg, mesh, pav, bav, opt,
                                     n_microbatches=n_mb)


@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_step_matches_reference(n_mb):
    """One ``build_train_step`` step (grad accumulation over ``n_mb``
    microbatches, AdamW) against the reference's on a 1x1 mesh, fp32: loss
    (1e-5), grad_norm (1e-4), lr (1e-6) and every new parameter within 1e-2
    of the step's lr.  Adam's first step moves each element by ``lr · g /
    (|g| + eps)``, which for a gradient element far below ``eps`` is
    ill-conditioned: the two backwards' 1e-7-relative differences (of max
    |g|) move it by up to 4% of lr at the default eps 1e-8.  So this step
    runs at ``eps = 1e-3``, above those differences, where each update is
    a smooth function of its gradient."""
    rcfg, pcfg = _cfgs("float32")
    rp = _ref_params(rcfg)
    lm = _carry(pcfg, rp)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3)
    bundle = _ref_bundle(rcfg, rp, ref_adamw.OptConfig(**kw), n_mb, 32, 4)
    batch = _ref_batch(rcfg, 32, 4, n_mb)
    new_rp, _, rm = bundle.fn(jax.tree.map(jnp.copy, rp),
                              ref_adamw.init_opt_state(rp, 1), batch)
    pb = step_lib.build_train_step(pcfg, lm, OptConfig(**kw),
                                   n_microbatches=n_mb)
    opt_state = adamw.init_opt_state(lm, 1)
    lm, opt_state, m = pb(lm, opt_state, _torch_batch(batch))
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6),
                     ("tokens", 0.0)):
        want = float(rm[key])
        assert abs(float(m[key]) - want) <= tol * max(1.0, abs(want)), key
    assert int(opt_state["count"]) == 1
    new_rp = jax.tree.map(np.asarray, new_rp)
    lr = float(rm["lr"])
    for name, p in lm.named_parameters():
        err = float(np.abs(p.detach().numpy() - _leaf(new_rp, name)).max())
        assert err <= 1e-2 * lr, f"{name}: {err:.3g} > 1e-2 * lr {lr:g}"


def test_grad_accumulation_equals_one_microbatch():
    """n_mb 2 over a batch of 4 equals n_mb 1 over the same 4 samples (the
    reference's test, at llama's reduced config: qwen3's has qk-norm, which
    the port raises on): new parameters within 1e-5, losses within 1e-6."""
    _, pcfg = _cfgs("float32")
    rcfg, _ = _cfgs("float32")
    rp = _ref_params(rcfg)
    batch1 = _ref_batch(rcfg, 16, 4, 1)
    outs = {}
    for n_mb in (1, 2):
        lm = _carry(pcfg, rp)
        b = {k: np.asarray(v).reshape(n_mb, 4 // n_mb, 16)
             for k, v in batch1.items()}
        pb = step_lib.build_train_step(pcfg, lm, OptConfig(lr=1e-3),
                                       n_microbatches=n_mb)
        lm, _, m = pb(lm, adamw.init_opt_state(lm, 1), _torch_batch(b))
        outs[n_mb] = ({k: v.detach().clone()
                       for k, v in lm.named_parameters()}, float(m["loss"]))
    for name, a in outs[1][0].items():
        _close(outs[2][0][name].numpy(), a.numpy(), 1e-5, name)
    assert outs[2][1] == pytest.approx(outs[1][1], rel=1e-6)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("size", [13, 16, 1])
def test_flat_roundtrip_matches_reference(n_shards, size):
    x = np.arange(size, dtype=np.float32).reshape(size) * 0.37 - 2.0
    for dname in ("float32", "bfloat16"):
        rf = np.asarray(ref_adamw.to_flat(jnp.asarray(x, getattr(jnp, dname)),
                                          n_shards))
        xt = torch.tensor(x).to(getattr(torch, dname))
        pf = adamw.to_flat(xt, n_shards)
        assert pf.shape == rf.shape == (n_shards, -(-size // n_shards))
        assert pf.dtype == torch.float32
        np.testing.assert_array_equal(pf.numpy(), rf)
        back = adamw.from_flat(pf, (size,), xt.dtype)
        assert back.dtype == xt.dtype and torch.equal(back, xt)
        pf[0, 0] += 1.0   # a new tensor: never the parameter's storage
        assert torch.equal(back, xt)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 99, 100, 200])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(ref_adamw.lr_at(ref_adamw.OptConfig(**kw), jnp.int32(step)))
    got = float(adamw.lr_at(OptConfig(**kw), torch.tensor(step,
                                                          dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(adamw.lr_at(OptConfig(**kw), step)) == got


def test_apply_updates_matches_reference(rng):
    """Three AdamW steps on a small tree (one clipped, weight decay on)
    against the reference's ``apply_updates``: params, m, v, master and
    the grad norm within 1e-6 relative."""
    mesh = make_test_mesh(1, 1)
    from jax.sharding import PartitionSpec as P
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 3)}
    ref_p = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    port_p = {k: torch.tensor(np.asarray(v)) for k, v in ref_p.items()}
    opt_kw = dict(lr=0.05, warmup_steps=1, total_steps=10, clip_norm=2.0)
    ref_state = ref_adamw.init_opt_state(ref_p, 1)
    state = adamw.init_opt_state(port_p, 1)
    specs = {k: P() for k in shapes}
    for i in range(3):
        g = {k: (rng.standard_normal(s) * (3.0 if i == 1 else 0.3)).astype(
            np.float32) for k, s in shapes.items()}
        rg = {k: ref_adamw.to_flat(jnp.asarray(v), 1) for k, v in g.items()}
        ref_p, ref_state, rn = ref_adamw.apply_updates(
            ref_p, ref_state, rg, ref_adamw.OptConfig(**opt_kw), specs, mesh)
        pg = {k: adamw.to_flat(torch.tensor(v), 1) for k, v in g.items()}
        port_p, state, n = adamw.apply_updates(port_p, state, pg,
                                               OptConfig(**opt_kw))
        assert float(n) == pytest.approx(float(rn), rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(port_p[k].numpy(),
                                       np.asarray(ref_p[k]), rtol=1e-6,
                                       atol=1e-7)
            for part in ("master", "m", "v"):
                np.testing.assert_allclose(
                    state["flat"][k][part].numpy(),
                    np.asarray(ref_state["flat"][k][part]), rtol=1e-6,
                    atol=1e-9)
    assert int(state["count"]) == int(ref_state["count"]) == 3


def test_loss_decreases():
    """The reference's ``test_loss_decreases``: 30 steps of the reduced
    llama at lr 1e-2 over two alternating batches; the loss falls by more
    than 0.5 and stays finite."""
    _, pcfg = _cfgs("bfloat16")
    lm = api.init_params(pcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    from repro_torch.data import DataConfig, global_batch_at
    shape = ShapeConfig("t", 32, 4, "train")
    pb = step_lib.build_train_step(
        pcfg, lm, OptConfig(lr=1e-2, warmup_steps=2, total_steps=50),
        n_microbatches=2)
    state = adamw.init_opt_state(lm, 1)
    batches = [global_batch_at(DataConfig(seed=7), pcfg, shape, 2, s,
                               device="cpu") for s in (0, 1)]
    losses = []
    for step in range(30):
        lm, state, m = pb(lm, state, batches[step % 2])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert all(np.isfinite(losses))


def test_shapes_match_reference():
    from repro.configs.base import SHAPES as REF_SHAPES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("global_batch,per", [(8, 4), (256, 4), (6, 4),
                                              (12, 5), (1, 4)])
def test_default_microbatches_matches_reference(global_batch, per):
    want = ref_step.default_microbatches(
        RefShape("t", 16, global_batch, "train"), make_test_mesh(1, 1), per)
    shape = ShapeConfig("t", 16, global_batch, "train")
    assert step_lib.default_microbatches(shape, None, per) == want
