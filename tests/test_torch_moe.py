"""The moe family (ROADMAP A.13, item 7b) against the reference on the CPU:
``repro_torch.models.moe`` against ``repro.models.moe``, and the two MoE
configs (qwen3-moe-30b-a3b: 8 experts padded to 16, top 2, qk-norm;
qwen2-moe-a2.7b: 6 padded to 16, top 2, 2 shared experts) at their
``reduced()`` sizes against ``repro.models.api``, with the reference's own
parameters carried over.  Tolerances: fp32 1e-5 of the largest reference
value, bf16 2e-2; gradients 1e-4 of max(1, max |g|), as the dense
family's tests hold them.

* The layer: ``_route``'s ids equal and weights within 1e-6;
  ``_sort_dispatch``'s slots and keep mask equal bit for bit (with drops
  forced, and a T·k that the padded expert count does not divide);
  ``moe_apply`` on both dispatch paths, with and without shared experts,
  fp32 and bf16, and the gelu FFN; gather against scatter in the port;
  padded experts inert.
* The configs: prefill and 4 decode steps, ``train_loss`` with every
  gradient, on both dispatch paths; ``ServeQueue``'s streams equal to
  the reference queue's (its pad rows route too); the router fp32 through
  ``init_params``, ``params_from_numpy`` and ``shard_params``.
* The mesh: ``param_specs`` equal to the reference's MoE rule; (1, 2) and
  (2, 2) gloo meshes (expert-parallel over ``model``, tokens gathered
  over ``data``) against the reference's one-device logits, and on (2, 2)
  its loss and gradients.
* The analyser counts the three expert products of a traced layer; the
  launcher's plan-cache warm-up prunes the reference's synthetic matrix,
  and ``launch/serve.py`` serves a reduced MoE arch end to end.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh as ref_abstract_mesh
from repro.configs import REDUCED as REF_REDUCED
from repro.dist import sharding as rshr
from repro.launch import specs as rspecs
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.models import api as ref_api
from repro.models import moe as rmoe
from repro.serve import queue as ref_queue
from repro.serve.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch.configs import REDUCED
from repro_torch.dist import sharding as tshr
from repro_torch.launch.mesh import abstract_mesh, make_test_mesh
from repro_torch.models import api, transformer
from repro_torch.models import moe as tmoe
from repro_torch.serve import queue
from repro_torch.serve.scheduler import SchedulerConfig
from test_torch_mesh import _port_tree, _ref_leaf, _spawn, _unstacked
from test_torch_serve_mesh import EXIT

ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
F32_TOL, BF16_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 2e-2, 1e-4, 1e-5
PROMPT, STEPS = 12, 4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, tol, what="", floor=0.0):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _port_moe(rp, dtype) -> tmoe.MoE:
    """The reference's MoE parameters (a dict) as the port's module."""
    e, d, f = rp["wi"].shape
    shared = rp["shared"]["wi"].shape[1] if "shared" in rp else 0
    m = tmoe.MoE(d, f, e, dtype, "cpu", int(shared > 0), shared)
    with torch.no_grad():
        for name, p in m.named_parameters():
            node = rp
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.tensor(_np(node)))
    return m


def _layer(dtype, *, num_shared=0, seed=0, d=32, f=16, experts=12,
           padded=16, top_k=2):
    return rmoe.moe_init(jax.random.key(seed), d, f, experts, padded, top_k,
                         dtype, num_shared=num_shared,
                         shared_d_ff=num_shared * f)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,d,padded,experts,k", [
    (37, 16, 16, 12, 2), (24, 32, 64, 60, 4), (16, 24, 128, 128, 8)])
def test_route_matches_reference(T, d, padded, experts, k):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, padded)) / np.sqrt(d)).astype(np.float32)
    rw, ridx = rmoe._route(jnp.asarray(w), jnp.asarray(x), experts, k)
    tw, tidx = tmoe._route(torch.tensor(w), torch.tensor(x), experts, k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=0,
                               atol=1e-6)
    assert int(tidx.max()) < experts


@pytest.mark.parametrize("T,k,padded,experts,factor", [
    (37, 2, 16, 8, 1.25), (37, 2, 16, 8, 0.5), (37, 3, 16, 12, 1.25),
    (50, 8, 128, 128, 1.25)],
    ids=["cap4", "drops", "tk_not_divisible", "e128_k8"])
def test_sort_dispatch_matches_reference(T, k, padded, experts, factor):
    rng = np.random.default_rng(100 + T + k)
    x = rng.standard_normal((T, 16)).astype(np.float32)
    w = rng.standard_normal((16, padded)).astype(np.float32)
    _, idx = rmoe._route(jnp.asarray(w), jnp.asarray(x), experts, k)
    cap = tmoe.capacity_of(T, k, padded, factor)
    assert cap == (max(int(T * k / padded * factor), 4) + 3) // 4 * 4
    rslot, rkeep = rmoe._sort_dispatch(idx, T, k, padded, cap)
    tslot, tkeep = tmoe._sort_dispatch(
        torch.tensor(np.asarray(idx)).long(), T, k, padded, cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(rkeep))
    if factor < 1:
        assert int((~tkeep).sum()) > 0      # the case does drop
    if k == 3:
        assert (T * k) % padded != 0


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_shared", [0, 2])
@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
def test_moe_apply_matches_reference(dispatch, num_shared, dname):
    """(2, 9, 32) tokens, 12 experts padded to 16, top 2: T·k = 36 is no
    multiple of 16 and the capacity of 4 drops assignments."""
    jdt, tdt = DTYPES[dname]
    rp = _layer(jdt, num_shared=num_shared)
    x = np.random.default_rng(7).standard_normal((2, 9, 32)).astype(
        np.float32)
    want = rmoe.moe_apply(rp, jnp.asarray(x, jdt), num_experts=12, top_k=2,
                          dispatch=dispatch)
    got = tmoe.moe_apply(_port_moe(rp, tdt), torch.from_numpy(x).to(tdt),
                         num_experts=12, top_k=2, dispatch=dispatch)
    assert got.dtype == tdt and got.shape == (2, 9, 32)
    _close(got.detach().float().numpy(), _np(want),
           F32_TOL if dname == "float32" else BF16_TOL, dispatch)


@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
def test_moe_apply_gelu_matches_reference(dispatch):
    rp = _layer(jnp.float32, num_shared=2, seed=1)
    x = np.random.default_rng(8).standard_normal((2, 9, 32)).astype(
        np.float32)
    want = rmoe.moe_apply(rp, jnp.asarray(x), num_experts=12, top_k=2,
                          act="gelu", dispatch=dispatch)
    got = tmoe.moe_apply(_port_moe(rp, torch.float32), torch.from_numpy(x),
                         num_experts=12, top_k=2, act="gelu",
                         dispatch=dispatch)
    _close(got.detach().numpy(), _np(want), F32_TOL, dispatch)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_port_gather_equals_scatter(dname):
    tdt = DTYPES[dname][1]
    p = tmoe.moe_init(torch.Generator().manual_seed(2), 32, 16, 12, 16, 2,
                      tdt, "cpu", 2, 32)
    x = torch.randn((3, 11, 32), generator=torch.Generator().manual_seed(3)
                    ).to(tdt)
    outs = [tmoe.moe_apply(p, x, num_experts=12, top_k=2,
                           capacity_factor=0.75, dispatch=dispatch)
            for dispatch in ("gather", "scatter")]
    _close(outs[1].detach().float().numpy(), outs[0].detach().float().numpy(),
           1e-6 if dname == "float32" else BF16_TOL)


def test_moe_expert_padding_inert():
    """The twin of ``tests/test_models.py::test_moe_expert_padding_inert``:
    padded experts are zero and never routed to, so even weights planted
    in them change nothing."""
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, 16, 8, 6, 8, 2, torch.float32, "cpu")
    x = torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(1))
    out = tmoe.moe_apply(p, x, num_experts=6, top_k=2)
    assert torch.isfinite(out).all()
    for name in ("wi", "wg", "wo"):
        assert float(getattr(p, name)[6:].abs().sum()) == 0.0
    _, idx = tmoe._route(p.router, x.reshape(-1, 16), 6, 2)
    assert int(idx.max()) < 6
    with torch.no_grad():
        for name in ("wi", "wg", "wo"):
            getattr(p, name)[6:] = 1e3
    assert torch.equal(tmoe.moe_apply(p, x, num_experts=6, top_k=2), out)


# ---------------------------------------------------------------------------
# the configs, one device
# ---------------------------------------------------------------------------

def _cfgs(arch, dname="float32", **change):
    jdt, tdt = DTYPES[dname]
    ref = dataclasses.replace(REF_REDUCED[arch](), dtype=jdt, **change)
    port = dataclasses.replace(REDUCED[arch](), dtype=tdt, **change)
    return ref, port


@pytest.fixture(scope="module")
def carried():
    """Per (arch, dtype): the reference's config and parameters (seed 0)
    and the port's copy of them."""
    out = {}
    for arch in ARCHS:
        for dname in DTYPES:
            rcfg, cfg = _cfgs(arch, dname)
            rp = ref_api.init_params(rcfg, jax.random.key(0))
            out[arch, dname] = (rcfg, rp, cfg, transformer.params_from_numpy(
                cfg, jax.tree.map(np.asarray, rp), device="cpu"))
    return out


def _ref_serving(rcfg, rp, tokens):
    cache, logits = ref_api.prefill(
        rcfg, rp, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    cache = jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]),
        cache)
    out = [_np(logits)]
    for i in range(STEPS):
        cache, logits = ref_api.decode_step(
            rcfg, rp, cache,
            jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
            jnp.int32(PROMPT + i))
        out.append(_np(logits))
    return np.stack(out)


def _port_serving(cfg, params, tokens):
    cache = api.init_cache(cfg, tokens.shape[0], PROMPT + STEPS,
                           device="cpu")
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
    return np.stack(got)


@pytest.mark.parametrize("dname,dispatch", [
    ("float32", "gather"), ("float32", "scatter"), ("bfloat16", "gather")])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(carried, arch, dname, dispatch):
    rcfg, rp, cfg, params = carried[arch, dname]
    rcfg = dataclasses.replace(rcfg, moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (3, PROMPT + STEPS))
    want = _ref_serving(rcfg, rp, tokens.astype(np.int32))
    got = _port_serving(cfg, params, tokens)
    _close(got, want, F32_TOL if dname == "float32" else BF16_TOL,
           (arch, dname, dispatch), floor=1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_gelu_config_matches_reference(carried, arch):
    """A MoE config with ``act="gelu"``: ``check_supported`` takes it (a
    dense one it still refuses), and its prefill and decode logits (gelu
    experts; qwen2-moe's shared MLP gelu too) match the reference's on
    the same parameters, whose tree ``act`` does not change."""
    rcfg, rp, cfg, params = carried[arch, "float32"]
    rcfg = dataclasses.replace(rcfg, act="gelu")
    cfg = dataclasses.replace(cfg, act="gelu")
    transformer.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="A.13"):
        transformer.check_supported(dataclasses.replace(
            cfg, family="dense"))
    tokens = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, PROMPT + STEPS))
    want = _ref_serving(rcfg, rp, tokens.astype(np.int32))
    swiglu = _ref_serving(carried[arch, "float32"][0], rp,
                          tokens.astype(np.int32))
    assert np.abs(want - swiglu).max() > 1e-3   # gelu took effect
    _close(_port_serving(cfg, params, tokens), want, F32_TOL, arch,
           floor=1.0)


def _ref_train(rcfg, rp, seq):
    tokens, labels = seq[:, :-1], seq[:, 1:].copy()
    labels[:, -1] = -1
    mb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss, _), g = jax.value_and_grad(
        lambda p: ref_api.train_loss(rcfg, p, mb), has_aux=True)(rp)
    return tokens, labels, float(loss), g


@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(carried, arch, dispatch):
    rcfg, rp, cfg, params = carried[arch, "float32"]
    rcfg = dataclasses.replace(rcfg, moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    seq = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 17))
    tokens, labels, want_loss, g = _ref_train(rcfg, rp, seq)
    loss, _ = api.train_loss(cfg, params, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    want = _port_tree(g, cfg)
    names = [n for n, _ in params.named_parameters()]
    assert set(want) == {"p/" + n for n in names}
    assert any(".moe.router" in n for n in names)
    for name, grad in zip(names, grads):
        _close(grad.numpy(), want["p/" + name], GRAD_TOL, name, floor=1.0)


GEN_LENS, RIDS = [4, 3, 4], [1000, 1001, 1002]


def _drive(q, prompts):
    reqs = [q.submit(p, g, now=0.0, rid=rid)
            for p, g, rid in zip(prompts, GEN_LENS, RIDS)]
    t = 0.0
    while q.pending:
        if not q.step(now=t):
            break
        t += 1.0
    return reqs


@pytest.mark.parametrize("coalesced", [True, False],
                         ids=["coalesced", "sequential"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_queue_streams_equal_reference(carried, arch, coalesced):
    """Greedy streams of three requests through the port's ``ServeQueue``
    and the reference's, coalesced into one padded batch (whose pad rows
    route and take capacity on both sides) or one at a time."""
    rcfg, rp, cfg, params = carried[arch, "float32"]
    kw = (dict(max_in_flight=2, max_batch=8) if coalesced
          else dict(max_in_flight=1, max_batch=1))
    kw.update(min_batch=1, max_wait_s=0.0)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in RIDS]
    ref = ref_queue.ServeQueue(rcfg, ref_test_mesh(1, 1), rp,
                               record_logits=True,
                               config=RefSchedulerConfig(**kw))
    port = queue.ServeQueue(cfg, params, record_logits=True,
                            config=SchedulerConfig(**kw))
    r_reqs, p_reqs = _drive(ref, prompts), _drive(port, prompts)
    assert port.sched.counters["prefill_batches"] == (1 if coalesced else 3)
    for rr, pr in zip(r_reqs, p_reqs):
        assert pr.tokens == rr.tokens and len(pr.tokens) == pr.gen_len
        for rl, pl in zip(ref.logits_log[rr.rid], port.logits_log[pr.rid]):
            np.testing.assert_allclose(pl, rl, rtol=1e-5, atol=1e-5)


def test_router_stays_fp32_in_every_constructor(carried):
    rcfg, rp, cfg, params = carried["qwen2-moe-a2.7b", "bfloat16"]
    assert cfg.dtype == torch.bfloat16
    fresh = api.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    mesh = make_test_mesh(1, 1, device="cpu")
    try:
        sharded = api.shard_params(cfg, jax.tree.map(np.asarray, rp), mesh,
                                   device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    ref_router = _np(rp["layers"]["moe"]["router"])
    assert str(rp["layers"]["moe"]["router"].dtype) == "float32"
    for lm in (fresh, params, sharded):
        for i, blk in enumerate(lm.layers):
            assert blk.moe.router.dtype == torch.float32
            assert blk.moe.wi.dtype == blk.moe.shared.wi.dtype == \
                blk.moe.shared_gate.dtype == torch.bfloat16
            if lm is not fresh:   # carried exactly, not through bf16
                np.testing.assert_array_equal(
                    blk.moe.router.detach().numpy(), ref_router[i])


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    ((1, 2), ("data", "model")), ((2, 4), ("data", "model")),
    ((1, 32), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))],
    ids=["1x2", "2x4", "1x32", "pod2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, shape, names):
    """The MoE rule: expert stacks split on E when ``model`` divides the
    16 padded experts (not at 32), the shared MLP column/row, the router
    and shared gate whole."""
    rcfg, cfg = _cfgs(arch)
    want = rshr.param_specs(rspecs.abstract_params(rcfg),
                            ref_abstract_mesh(shape, names), rcfg)
    skel = transformer.LM(cfg, torch.device("meta"))
    got = tshr.param_specs(skel, abstract_mesh(shape, names), cfg)
    assert set(got) == {n for n, _ in skel.named_parameters()}
    for name, spec in got.items():
        ref, stacked = _ref_leaf(want, name)
        assert tuple(spec) == _unstacked(ref, stacked), name
    split = shape[-1] <= 16
    assert tuple(got["layers.0.moe.wi"]) == (
        ("model", None, None) if split else ())
    assert tuple(got["layers.1.moe.router"]) == ()


_MESH_BODY = """
import json
from repro_torch.models import layers
mesh = make_test_mesh(*json.loads(str(inp["mesh"])), device="cpu")
reduced_rows, current = {}, [None]   # rows of each 2-D sum over model
_reduce = layers.reduce_from_model
def _spy(x, layout):
    if x.dim() == 2:
        reduced_rows.setdefault(current[0], set()).add(x.shape[0])
    return _reduce(x, layout)
layers.reduce_from_model = _spy
for arch in json.loads(str(inp["archs"])):
    current[0] = arch
    cfg = dataclasses.replace(REDUCED[arch](), dtype=torch.float32,
                              **json.loads(str(inp["change"])))
    lm = transformer.LM(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            p.copy_(torch.from_numpy(inp[arch + "/p/" + name]))
    params = api.shard_params(cfg, lm, mesh, device="cpu")
    lay = params.layout
    out[arch + "/experts"] = np.array(lay.experts or (-1, -1))
    out[arch + "/ff"] = np.array(lay.ff)
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
    if not int(inp["train"]):
        continue
    from repro_torch.data.pipeline import host_shard
    data = shr.worker_mesh(mesh, shr.dp_axes(mesh))
    batch = host_shard(
        {k: torch.from_numpy(inp[arch + "/" + k][None])
         for k in ("tokens", "labels")}, data.get_local_rank(), data.size())
    loss, _ = api.train_loss(cfg, params, {k: v[0] for k, v in
                                           batch.items()})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=lay.data_group)
    out[arch + "/loss"] = float(loss)
    sh = shr.spec_to_sharding(lay.specs, mesh)
    for (n, _), g in zip(params.named_parameters(), grads):
        g = g.clone()
        dist.all_reduce(g, group=lay.data_group)
        out[arch + "/g/" + n] = sh[n].gather(g).numpy()
for arch in json.loads(str(inp["archs"])):
    out[arch + "/reduced_rows"] = np.array(
        sorted(reduced_rows.get(arch, ())), int)
""" + EXIT


@pytest.mark.parametrize("mesh,train,batch,factor", [
    ((1, 2), False, 2, None), ((2, 2), True, 2, None),
    ((2, 1), False, 3, 2.5)], ids=["1x2", "2x2", "2x1-odd"])
def test_on_a_mesh_match_reference(tmp_path, carried, mesh, train, batch,
                                   factor):
    """The two reduced configs on gloo ranks, their experts split over
    ``model`` (8 of 16 a rank) and, with data ranks, every data rank's
    rows of the batch gathered for the dispatch: prefill and 4 decode
    steps' logits against the reference's one device (1e-5), and on (2,
    2) the loss and every gradient (summed over the data ranks, gathered
    over ``model``) at the one-device tolerances; every sum over
    ``model`` carries the rank's own tokens, never the gathered batch.
    On (2, 1) a batch of 3
    pads to 4 rows, at a capacity factor where 4 rows would give each
    expert more slots than 3 do: the pad row takes none, so the tokens
    dropped are one device's."""
    change = {} if factor is None else {"capacity_factor": factor}
    inputs = {"archs": np.array(json.dumps(list(ARCHS))),
              "mesh": np.array(json.dumps(list(mesh))),
              "change": np.array(json.dumps(change)),
              "prompt": np.array(PROMPT), "train": np.array(int(train))}
    want = {}
    for i, arch in enumerate(ARCHS):
        rcfg, rp, cfg, _ = carried[arch, "float32"]
        rcfg = dataclasses.replace(rcfg, **change)
        if batch % mesh[0]:
            e_pad = rp["layers"]["moe"]["router"].shape[-1]
            padded = -(-batch // mesh[0]) * mesh[0]
            assert tmoe.capacity_of(batch * PROMPT, cfg.top_k, e_pad,
                                    rcfg.capacity_factor) != \
                tmoe.capacity_of(padded * PROMPT, cfg.top_k, e_pad,
                                 rcfg.capacity_factor)
        rng = np.random.default_rng(20 + i)
        serve = rng.integers(0, cfg.vocab_size, (batch, PROMPT + STEPS))
        seq = rng.integers(0, cfg.vocab_size, (2, 17))
        tokens, labels, loss, g = _ref_train(rcfg, rp, seq)
        want[arch] = (_ref_serving(rcfg, rp, serve.astype(np.int32)), loss,
                      _port_tree(g, cfg))
        inputs.update({arch + "/serve": serve, arch + "/tokens": tokens,
                       arch + "/labels": labels})
        inputs.update({arch + "/" + k: v
                       for k, v in _port_tree(rp, cfg).items()})
    outs = _spawn(tmp_path, int(np.prod(mesh)), _MESH_BODY, **inputs)
    for r, o in enumerate(outs):
        for arch in ARCHS:
            logits, loss, grads = want[arch]
            _close(o[arch + "/logits"], logits, F32_TOL, (r, arch),
                   floor=1.0)
            half = r % 2
            split = mesh[1] > 1
            assert list(o[arch + "/experts"]) == (
                [8 * half, 8 * half + 8] if split else [-1, -1])
            assert bool(o[arch + "/ff"]) == (
                split and arch == "qwen2-moe-a2.7b")
            # the sums over ``model`` carry this rank's tokens only
            per = -(-batch // mesh[0])
            assert set(o[arch + "/reduced_rows"]) <= {
                per * PROMPT, per, per * 16}, (r, arch)
            assert bool(len(o[arch + "/reduced_rows"])) == split
            if not train:
                continue
            assert abs(float(o[arch + "/loss"]) - loss) <= \
                LOSS_TOL * abs(loss), (r, arch)
            for name, ref in grads.items():
                _close(o[arch + "/g/" + name[2:]], ref, GRAD_TOL,
                       (r, arch, name), floor=1.0)


# ---------------------------------------------------------------------------
# the analyser and the launcher
# ---------------------------------------------------------------------------

def test_analyser_counts_the_expert_products():
    """A reduced qwen3-moe layer traced on ``meta``: its three batched
    expert products at 2·E·C·d·f flops each; the fp32-out ``bmm.dtype``
    overload (the card's path) counts the same; and a (2, 2) decode cell
    counts each layer's three products on the rank's 8 experts at the
    global batch's capacity."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import dryrun
    from repro_torch.perf.hlo_analysis import StepTrace, _tensors, op_stats
    cfg = REDUCED["qwen3-moe-30b-a3b"]()
    d, f, e = cfg.d_model, cfg.moe_d_ff, 16
    p = tmoe.MoE(d, f, e, torch.float32, "meta")
    x = torch.empty((2, 12, d), device="meta")
    cap = tmoe.capacity_of(24, cfg.top_k, e, cfg.capacity_factor)
    with StepTrace() as tr:
        tmoe.moe_apply(p, x, num_experts=cfg.num_experts, top_k=cfg.top_k)
    bmm = [r for r in tr.records if r["op"].startswith("aten::bmm")]
    assert len(bmm) == 3
    assert [op_stats(r).flops for r in bmm] == [2 * e * cap * d * f] * 3
    a = torch.empty((e, cap, d), dtype=torch.bfloat16, device="meta")
    w = torch.empty((e, d, f), dtype=torch.bfloat16, device="meta")
    with StepTrace() as tr:
        torch.bmm(a, w, out_dtype=torch.float32)
    assert [r["op"] for r in tr.records] == ["aten::bmm.dtype"]
    assert tr.stats.flops == 2 * e * cap * d * f
    with dryrun.fake_world(4, 0):
        mesh = DeviceMesh("meta", torch.arange(4).view(2, 2),
                          mesh_dim_names=("data", "model"))
        trace, _, _ = dryrun.trace_cell(cfg, "decode_32k", mesh,
                                        device="meta")
    cap = tmoe.capacity_of(128, cfg.top_k, e, cfg.capacity_factor)
    stacks = {(e // 2, d, f), (e // 2, f, d)}    # (decode attention's
    bmm = [op_stats(r).flops for r in trace.records  # einsums are bmm too)
           if r["op"].startswith("aten::bmm")
           and _tensors(r["args"])[1].shape in stacks]
    assert bmm == [2 * (e // 2) * cap * d * f] * (3 * cfg.num_layers)


def test_warm_up_prunes_the_reference_matrix(carried, monkeypatch,
                                             tmp_path):
    """A MoE model has no dense FFN: the launcher's plan-cache warm-up
    prunes the reference's one synthetic (4d, d) matrix and warms one
    layer."""
    import repro.models.sparse_ffn as rffn
    import repro_torch.models.sparse_ffn as tffn
    from repro.launch.serve import warm_spmm_plan_cache as ref_warm
    from repro.obs import Obs as RefObs
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.obs import Obs
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    seen = {}
    for name, mod in (("ref", rffn), ("port", tffn)):
        real = mod.magnitude_prune

        def spy(w, sparsity, _real=real, _name=name):
            seen.setdefault(_name, []).append(np.array(w))
            return _real(w, sparsity)
        monkeypatch.setattr(mod, "magnitude_prune", spy)
    rcfg, rp, cfg, params = carried["qwen3-moe-30b-a3b", "float32"]
    ref_warm(rcfg, rp, RefObs(source="t"), pool=None)
    obs = Obs(source="t")
    warm_spmm_plan_cache(cfg, params, obs)
    assert len(seen["ref"]) == len(seen["port"]) == 1
    assert seen["port"][0].shape == (4 * cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(seen["port"][0], seen["ref"][0])
    assert obs.metrics.find("gauge", "serve.warm_layers").value == 1


def test_launch_serve_main_serves_a_moe_arch(monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` end to end on the CPU with a
    reduced MoE arch and ``--obs``: every request served, the warm-up's one
    synthetic layer counted."""
    from repro.obs.export import load_obs as ref_load_obs
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    q = launch_serve.main([
        "--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
        "--batch", "3", "--prompt-len", "8", "--gen-len", "4", "--obs",
        "cap", "--obs-dir", str(tmp_path / "obs")])
    assert "served 3/3 requests" in capsys.readouterr().out
    assert all(len(r.tokens) == 4 for r in q.completed)
    recs = ref_load_obs(tmp_path / "obs" / "cap.jsonl")
    assert [r["value"] for r in recs if r["kind"] == "gauge"
            and r["metric"] == "serve.warm_layers"] == [1]
