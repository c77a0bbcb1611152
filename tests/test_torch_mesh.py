"""The LM across devices (ROADMAP A.13, item 5) against the reference on the
CPU, at the reduced llama3.2-1b config (2 layers, d 64, 4 heads, 2 kv
heads, vocab 256).

* Device-free: the model half of ``dist/sharding.py`` (``param_specs`` under
  both TP rules, the batch, cache, logits and flat-gradient specs) and
  ``optim/adamw.py::opt_specs`` equal the reference's at (2, 4), (1, 2) and
  (2, 2, 2) with ``pod``, modulo the reference's leading ``L`` dim on the
  stacked layer leaves; ``default_microbatches`` with a mesh and
  ``spec_to_sharding``'s placements.
* Multi-process, gloo on the CPU (ranks as processes of their own on a
  ``file://`` store under ``tmp_path``, every rank killed at the test's
  ``RANK_LIMIT_S``): a (2, 2) and a (1, 4) fp32 train step (2 microbatches)
  against the reference's ``build_train_step`` on a 2 x 2 mesh of forced
  host devices (loss 1e-5, gradient norm 1e-4 relative, every updated leaf
  1e-5 of max(1, max |leaf|)); a resume bit-equal to the uninterrupted run;
  the checkpoint in the reference's unsharded layout, restored onto a
  (1, 4) mesh of the same D; (1, 2) prefill and decode logits against the
  reference's one-device ones (1e-4 of max(1, max |logits|)); and the two
  attention layouts without a split kv: whole ``wk``/``wv`` under a split
  ``wq`` (model 4 against kv 2) and whole attention (2 heads on model 4),
  loss and gathered gradients against the reference's (1e-5, 1e-4).

Adam's first step is ill-conditioned for gradient elements far below its
``eps``, so the steps compared across packages run at ``eps = 1e-3``
(``tests/test_torch_train.py`` says why).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.compat import abstract_mesh as ref_abstract_mesh
from repro.configs import REDUCED as REF_REDUCED
from repro.configs.base import ShapeConfig as RefShape
from repro.dist import sharding as rshr
from repro.dist import step as ref_step
from repro.launch import specs as rspecs
from repro.models import api as ref_api
from repro_torch.configs import REDUCED, ShapeConfig
from repro_torch.dist import sharding as tshr
from repro_torch.dist import step as step_lib
from repro_torch.launch.mesh import P, abstract_mesh
from repro_torch.models import transformer
from repro_torch.optim import adamw

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
RANK_LIMIT_S = 120
GLOO_TIMEOUT_S = 60
MESHES = [((2, 4), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["2x4", "1x2", "pod2x2x2"]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3)


def _cfgs(dtype="float32", **kw):
    ref = dataclasses.replace(REF_REDUCED[ARCH](), dtype=getattr(jnp, dtype),
                              **kw)
    port = dataclasses.replace(REDUCED[ARCH](), dtype=getattr(torch, dtype),
                               **kw)
    return ref, port


def _ref_leaf(tree, name: str):
    """The reference's leaf of a port parameter name, and whether it is a
    stacked layer leaf."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return node, True
    node = tree
    for key in parts:
        node = node[key]
    return node, False


def _unstacked(spec, stacked: bool) -> tuple:
    """A reference spec of a stacked ``(L, ...)`` leaf without its ``L``
    entry (``P()`` stays ``P()``)."""
    spec = tuple(spec)
    return spec[1:] if stacked and spec else spec


def _skeleton(cfg):
    return transformer.LM(cfg, torch.device("meta"))


# ---------------------------------------------------------------------------
# device-free: the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["kv_aligned", "naive"])
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_param_specs_match_reference(shape, names, rule):
    rcfg, pcfg = _cfgs(tp_rule=rule)
    want = rshr.param_specs(rspecs.abstract_params(rcfg),
                            ref_abstract_mesh(shape, names), rcfg)
    got = tshr.param_specs(_skeleton(pcfg), abstract_mesh(shape, names),
                           pcfg)
    assert set(got) == {n for n, _ in _skeleton(pcfg).named_parameters()}
    for name, spec in got.items():
        assert isinstance(spec, P)
        ref, stacked = _ref_leaf(want, name)
        assert tuple(spec) == _unstacked(ref, stacked), name
    # the rules split something at every mesh here (not a vacuous match)
    assert got["layers.0.mlp.wi"] == P(None, "model")
    assert got["embed"] == P("model", None)
    kv_split = rule == "naive" or pcfg.num_kv_heads % shape[-1] == 0
    assert (got["layers.1.attn.wk"] == P(None, "model")) == kv_split


@pytest.mark.parametrize("rule", ["kv_aligned", "naive"])
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_batch_cache_logits_flat_and_opt_specs_match_reference(shape, names,
                                                               rule):
    rcfg, pcfg = _cfgs(tp_rule=rule)
    rmesh, mesh = ref_abstract_mesh(shape, names), abstract_mesh(shape, names)
    bav = rspecs.train_batch_specs(rcfg, RefShape("t", 16, 8, "train"), 2)
    want = rshr.train_batch_specs(bav, rmesh)
    got = tshr.train_batch_specs({k: v.shape for k, v in bav.items()}, mesh)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    pbav = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32)}
    assert tuple(tshr.prefill_batch_specs({"tokens": (8, 16)}, mesh)
                 ["tokens"]) == tuple(rshr.prefill_batch_specs(
                     pbav, rmesh)["tokens"])
    cav = jax.eval_shape(lambda: ref_api.init_cache(rcfg, 8, 32))
    want = rshr.cache_specs(cav, rmesh, rcfg)
    got = tshr.cache_specs({k: cav[k].shape for k in ("k", "v")}, mesh,
                           pcfg)
    for k in ("k", "v"):
        assert tuple(got[k]) == tuple(want[k]), k
    assert tuple(tshr.logits_spec(mesh)) == tuple(rshr.logits_spec(rmesh))
    pav = rspecs.abstract_params(rcfg)
    skel = _skeleton(pcfg)
    rflat = jax.tree.leaves(rshr.flat_grad_specs(pav, rmesh),
                            is_leaf=lambda x: isinstance(x, type(
                                rshr.logits_spec(rmesh))))
    assert all(tuple(s) == tuple(rflat[0]) for s in rflat)
    assert {tuple(s) for s in tshr.flat_grad_specs(skel, mesh).values()} \
        == {tuple(rflat[0])}
    ropt = rshr.opt_specs(pav, rmesh)
    popt = tshr.opt_specs(skel, mesh)
    assert tshr.opt_specs is adamw.opt_specs
    assert tuple(popt["count"]) == tuple(ropt["count"])
    for name, triple in popt["flat"].items():
        ref, _ = _ref_leaf(ropt["flat"], name)
        assert {k: tuple(v) for k, v in triple.items()} == \
            {k: tuple(v) for k, v in ref.items()}, name
    assert tshr.dp_size(mesh) == rshr.dp_size(rmesh)
    assert tshr.model_size(mesh) == rshr.model_size(rmesh)
    assert tshr.data_axis(mesh) == rshr.data_axis(rmesh)


@pytest.mark.parametrize("global_batch,shape", [
    (64, (4, 2)), (2, (4, 2)), (8, (2, 2)), (12, (3, 1)), (6, (1, 4))])
def test_default_microbatches_with_a_mesh_matches_reference(global_batch,
                                                           shape):
    names = ("data", "model")
    want = ref_step.default_microbatches(
        RefShape("t", 16, global_batch, "train"),
        ref_abstract_mesh(shape, names))
    got = step_lib.default_microbatches(
        ShapeConfig("t", 16, global_batch, "train"),
        abstract_mesh(shape, names))
    assert got == want


def test_spec_to_sharding_places_each_mesh_dim():
    mesh = abstract_mesh((2, 2), ("data", "model"))
    sh = tshr.spec_to_sharding({"a": P(None, "model"), "b": {
        "c": P(("data", "model"), None), "d": P()}}, mesh)
    assert sh["a"].placements == (Replicate(), Shard(1))
    assert sh["b"]["c"].placements == (Shard(0), Shard(0))
    assert sh["b"]["d"].placements == (Replicate(), Replicate())
    assert sh["a"].global_shape((3, 4)) == (3, 8)
    assert sh["b"]["c"].local_shape((8, 5)) == (2, 5)
    with pytest.raises(ValueError, match="does not split"):
        sh["a"].local_shape((3, 5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_parallel_partial_product_is_fp32_with_matmuls_backward(dtype):
    """``row_parallel``'s partial product leaves the GEMM unrounded, in
    fp32, and its backward gives the gradients of the one-device
    ``layers.matmul`` (GEMMs in the operands' dtype) for the same
    upstream gradient."""
    from repro_torch.models import layers
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((2, 5, 24)), dtype=dtype,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((24, 16)), dtype=dtype,
                     requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 5, 16)), dtype=dtype)
    y = layers._PartialF32.apply(x, w)
    assert y.dtype == torch.float32
    want = torch.matmul(x.detach().double(), w.detach().double())
    torch.testing.assert_close(y.detach().double(), want, rtol=1e-6,
                               atol=1e-5)
    dx, dw = torch.autograd.grad(y, (x, w), g.float())
    rx, rw = torch.autograd.grad(layers.matmul(x, w), (x, w), g)
    assert dx.dtype == dtype and dw.dtype == dtype
    torch.testing.assert_close(dx, rx)
    torch.testing.assert_close(dw, rw)


# ---------------------------------------------------------------------------
# multi-process, gloo on the CPU
# ---------------------------------------------------------------------------

_PRELUDE = """
import dataclasses, datetime, pathlib, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world = int(sys.argv[1]), int(sys.argv[2])
work = pathlib.Path(sys.argv[3])
dist.init_process_group(
    "gloo", init_method=f"file://{work}/store", rank=rank, world_size=world,
    timeout=datetime.timedelta(seconds=%d))
inp = dict(np.load(work / "inputs.npz")) if (work / "inputs.npz").exists() \\
    else {}
out = {}
from repro_torch.configs import REDUCED
from repro_torch.dist import sharding as shr
from repro_torch.dist import step as step_lib
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api, transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig


def config(dtype="float32", **kw):
    return dataclasses.replace(REDUCED["llama3.2-1b"](),
                               dtype=getattr(torch, dtype), **kw)


def full_model(cfg):
    lm = transformer.LM(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            p.copy_(torch.from_numpy(inp["p/" + name]))
    return lm


def gathered(params, mesh, what="p/"):
    sh = shr.spec_to_sharding(params.layout.specs, mesh)
    return {what + n: sh[n].gather(p.detach()).numpy()
            for n, p in params.named_parameters()}
""" % GLOO_TIMEOUT_S

_EPILOGUE = """
np.savez(work / f"rank{rank}.npz", **out)
dist.barrier()    # no rank tears its group down while a peer still talks
dist.destroy_process_group()
"""


def _spawn(work: pathlib.Path, world: int, body: str, **inputs) -> list:
    """Run ``body`` in ``world`` ranks (one process each, gloo over a
    ``file://`` store in ``work``) with ``inputs`` saved for them; return
    each rank's ``out``.  A rank that fails or runs past ``RANK_LIMIT_S``
    fails the test; every rank is killed on the way out."""
    work.mkdir(parents=True, exist_ok=True)
    if inputs:
        np.savez(work / "inputs.npz", **inputs)
    script = work / "rank.py"
    script.write_text(_PRELUDE + textwrap.dedent(body) + _EPILOGUE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    logs = [open(work / f"log{r}.txt", "w") for r in range(world)]
    procs = []
    deadline = time.monotonic() + RANK_LIMIT_S
    try:
        procs = [subprocess.Popen([sys.executable, str(script), str(r),
                                   str(world), str(work)], env=env,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                          + (work / f"log{r}.txt").read_text()[-3000:]
                          for r, rc in enumerate(rcs))
        pytest.fail(f"ranks exited {rcs} (limit {RANK_LIMIT_S} s):\n{tails}")
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(world)]


def _port_names(cfg) -> list:
    return [n for n, _ in _skeleton(cfg).named_parameters()]


def _port_tree(ref_params, cfg) -> dict:
    """The reference's parameters under the port's names (``p/<name>``)."""
    tree = jax.tree.map(np.asarray, ref_params)
    out = {}
    for name in _port_names(cfg):
        leaf, stacked = _ref_leaf(tree, name)
        leaf = np.asarray(leaf, np.float32)
        out["p/" + name] = leaf[int(name.split(".")[1])] if stacked else leaf
    return out


# The reference's train step on a 2 x 2 mesh of forced host devices (the
# host-device count is fixed when JAX starts, so in a process of its own):
# one fp32 step of the reduced llama, 2 microbatches, at OPT.
_REFERENCE_STEP = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import REDUCED
from repro.configs.base import ShapeConfig
from repro.data import DataConfig, global_batch_at
from repro.dist import step as step_lib
from repro.launch import specs
from repro.launch.mesh import make_test_mesh
from repro.models import api
from repro.optim import adamw
import dataclasses
opt_kw = json.loads(sys.argv[2])
cfg = dataclasses.replace(REDUCED["llama3.2-1b"](), dtype=jnp.float32)
mesh = make_test_mesh(2, 2)
shape = ShapeConfig("t", 16, 4, "train")
params = api.init_params(cfg, jax.random.key(0))
batch = global_batch_at(DataConfig(seed=3), cfg, shape, 2, 0)
pav = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
bav = specs.train_batch_specs(cfg, shape, 2)
bundle = step_lib.build_train_step(cfg, mesh, pav, bav,
                                   adamw.OptConfig(**opt_kw),
                                   n_microbatches=2)
init = jax.tree.map(np.asarray, params)
new, _, m = bundle.fn(jax.tree.map(jnp.copy, params),
                      adamw.init_opt_state(params, 4), batch)
out = {"tokens": np.asarray(batch["tokens"]),
       "labels": np.asarray(batch["labels"])}
for key in ("loss", "grad_norm", "lr", "tokens"):
    out["m_" + key] = np.asarray(m[key])
for tag, tree in (("init", init), ("new", jax.tree.map(np.asarray, new))):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[tag + "/" + key] = np.asarray(leaf, np.float32)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref_step_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    import json
    res = subprocess.run([sys.executable, "-c", _REFERENCE_STEP, str(path),
                          json.dumps(OPT)], env=env, capture_output=True,
                         text=True, timeout=RANK_LIMIT_S)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(path))


def _ref_tree(out: dict, tag: str, cfg) -> dict:
    """``p/<port name>`` arrays of the reference's saved ``tag`` tree."""
    res = {}
    for name in _port_names(cfg):
        parts = name.split(".")
        if parts[0] == "layers":
            leaf = out[f"{tag}/layers/" + "/".join(parts[2:])][int(parts[1])]
        else:
            leaf = out[f"{tag}/" + "/".join(parts)]
        res["p/" + name] = leaf
    return res


_TRAIN_STEP_BODY = """
d, m = (int(x) for x in inp["mesh"])
mesh = make_test_mesh(d, m, device="cpu")
cfg = config()
params = api.shard_params(cfg, full_model(cfg), mesh, device="cpu")
state = adamw.init_opt_state(params, d * m, param_specs=params.layout.specs,
                             mesh=mesh)
step = step_lib.build_train_step(cfg, params, OptConfig(
    **{k: float(v) for k, v in zip(inp["opt_keys"], inp["opt_vals"])}),
    mesh=mesh, n_microbatches=2)
params, state, met = step(params, state, {
    "tokens": torch.from_numpy(inp["tokens"]),
    "labels": torch.from_numpy(inp["labels"])})
out.update({"m_" + k: float(v) for k, v in met.items()})
out.update(gathered(params, mesh))
out["count"] = int(state["count"])
"""


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_train_step_matches_reference(tmp_path, ref_step_out, mesh):
    """One fp32 step (2 microbatches of 2 sequences of 16 tokens) of the
    port on the mesh against the reference's on its 2 x 2 mesh, both from
    the reference's parameters and batch; and against the port's own
    one-device step (the same bounds).  (1, 4) keeps ``wk``/``wv`` whole
    (2 kv heads on model 4): each rank reads its q head's kv head."""
    rcfg, pcfg = _cfgs()
    init = _ref_tree(ref_step_out, "init", pcfg)
    want = _ref_tree(ref_step_out, "new", pcfg)
    opt = OPT
    outs = _spawn(tmp_path, 4, _TRAIN_STEP_BODY, mesh=np.array(mesh),
                  opt_keys=np.array(list(opt)),
                  opt_vals=np.array(list(opt.values()), np.float64),
                  tokens=ref_step_out["tokens"],
                  labels=ref_step_out["labels"], **init)
    lm = transformer.LM(pcfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            p.copy_(torch.from_numpy(init["p/" + name]))
    one = step_lib.build_train_step(pcfg, lm, adamw.OptConfig(**opt),
                                    n_microbatches=2)
    _, _, m1 = one(lm, adamw.init_opt_state(lm, 1), {
        "tokens": torch.from_numpy(ref_step_out["tokens"]),
        "labels": torch.from_numpy(ref_step_out["labels"])})
    single = {"p/" + n: p.detach().numpy() for n, p in lm.named_parameters()}
    for r, o in enumerate(outs):
        assert int(o["count"]) == 1
        for other, metrics in (("reference", {k: float(ref_step_out[
                "m_" + k]) for k in ("loss", "grad_norm", "lr", "tokens")}),
                               ("one device", {k: float(v) for k, v in
                                               m1.items()})):
            for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4),
                             ("lr", 1e-6), ("tokens", 0.0)):
                got, ref = float(o["m_" + key]), metrics[key]
                assert abs(got - ref) <= tol * max(1.0, abs(ref)), \
                    (r, other, key, got, ref)
        for name in want:
            for other, ref in (("reference", want[name]),
                               ("one device", single[name])):
                scale = max(1.0, float(np.abs(ref).max()))
                err = float(np.abs(o[name] - ref).max())
                assert err <= 1e-5 * scale, (r, other, name, err)


_RESUME_BODY = """
import os
from repro_torch.checkpoint import Checkpointer, restore
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, global_batch_at
mesh = make_test_mesh(2, 2, device="cpu")
cfg = config("bfloat16")
shape = ShapeConfig("t", 16, 4, "train")
opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
batches = [global_batch_at(DataConfig(seed=5), cfg, shape, 1, s,
                           device="cpu") for s in range(3)]


def fresh():
    params = api.shard_params(cfg, api.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), mesh,
        device="cpu")
    state = adamw.init_opt_state(params, 4, param_specs=params.layout.specs,
                                 mesh=mesh)
    return params, state, step_lib.build_train_step(cfg, params, opt,
                                                    mesh=mesh)


params, state, step = fresh()
ck = Checkpointer(str(work / "ck"), write=rank == 0)
runs = {"a": [], "b": []}
for i in range(3):
    params, state, met = step(params, state, batches[i])
    runs["a"].append([float(met["loss"]), float(met["grad_norm"])])
    if i == 1:
        ck.save_async(2, {"params": params.state_dict(), "opt": state},
                      gather=step_lib.gather_state(params, mesh))
        ck.close()
final_a = {n: p.detach().clone() for n, p in params.named_parameters()}
dist.barrier()
params, state, step = fresh()
at, tree, _ = restore(str(work / "ck"), {"params": params.state_dict(),
                                         "opt": state})
step_lib.load_state(params, state, tree, mesh)
params, state, met = step(params, state, batches[2])
runs["b"].append([float(met["loss"]), float(met["grad_norm"])])
out["at"] = at
out["a"] = np.array(runs["a"])
out["b"] = np.array(runs["b"])
out["count"] = int(state["count"])
out["equal"] = all(torch.equal(p.detach(), final_a[n])
                   for n, p in params.named_parameters())
"""


def test_resume_on_the_mesh_is_bit_equal(tmp_path):
    """Three bf16 steps on a (2, 2) mesh with a checkpoint after the second;
    a fresh model restored from it (memory-mapped, each rank copying its
    shards and rows) takes the third step: its loss, gradient norm and
    every rank's parameters bit-equal to the uninterrupted run's."""
    outs = _spawn(tmp_path, 4, _RESUME_BODY)
    for o in outs:
        assert int(o["at"]) == 2 and int(o["count"]) == 3
        assert np.array_equal(o["b"][0], o["a"][2])
        assert bool(o["equal"])
        assert np.all(np.isfinite(o["a"]))
    assert all(np.array_equal(o["a"], outs[0]["a"]) for o in outs)


_LAYOUT_BODY = """
from repro_torch.checkpoint import Checkpointer, restore
from repro_torch.checkpoint import checkpoint as ck_mod
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, global_batch_at
cfg = config()
shape = ShapeConfig("t", 16, 4, "train")
mesh = make_test_mesh(2, 2, device="cpu")
params = api.shard_params(cfg, api.init_params(
    cfg, torch.Generator().manual_seed(0), device="cpu"), mesh, device="cpu")
state = adamw.init_opt_state(params, 4, param_specs=params.layout.specs,
                             mesh=mesh)
step = step_lib.build_train_step(cfg, params, OptConfig(lr=1e-2), mesh=mesh)
params, state, _ = step(params, state, global_batch_at(
    DataConfig(seed=1), cfg, shape, 1, 0, device="cpu"))
full = gathered(params, mesh)
ck = Checkpointer(str(work / "ck"), write=rank == 0)
ck.save_async(1, {"params": params.state_dict(), "opt": state},
              gather=step_lib.gather_state(params, mesh))
ck.close()
dist.barrier()
_, saved = ck_mod._read(ck_mod._ckpt_path(str(work / "ck"), 1))
out["params_equal"] = all(np.array_equal(saved["params/" + k[2:]].numpy(),
                                         v) for k, v in full.items())
from repro_torch.launch.mesh import all_gather_cat
out["rows_equal"] = all(
    np.array_equal(saved[f"opt/flat/{n}/master"].numpy(),
                   all_gather_cat(tr["master"], dist.group.WORLD).numpy())
    for n, tr in state["flat"].items())
out["row_shapes"] = np.array([tuple(saved[f"opt/flat/{n}/m"].shape)
                              for n in state["flat"]])
out["master_is_params"] = all(np.array_equal(
    saved[f"opt/flat/{n}/master"].numpy().reshape(-1)[:v.size],
    v.reshape(-1)) for n, v in ((k[2:], v) for k, v in full.items()))
# onto a (1, 4) mesh of the same D
mesh14 = make_test_mesh(1, 4, device="cpu")
p14 = api.shard_params(cfg, api.init_params(
    cfg, torch.Generator().manual_seed(9), device="cpu"), mesh14,
    device="cpu")
s14 = adamw.init_opt_state(p14, 4, param_specs=p14.layout.specs, mesh=mesh14)
_, tree, _ = restore(str(work / "ck"), {"params": p14.state_dict(),
                                        "opt": s14})
step_lib.load_state(p14, s14, tree, mesh14)
out["restored_equal"] = all(np.array_equal(v, full[k]) for k, v in
                            gathered(p14, mesh14).items())
out["restored_rows"] = all(np.array_equal(
    tr["m"].numpy(), saved[f"opt/flat/{n}/m"].numpy()[rank:rank + 1])
    for n, tr in s14["flat"].items())
out["count"] = int(s14["count"])
"""


def test_checkpoint_is_the_unsharded_layout_and_restores_on_another_mesh(
        tmp_path):
    """A (2, 2) mesh's checkpoint after one fp32 step holds the gathered
    full parameters and each optimizer leaf's (4, cols) rows (the masters
    the parameters' values, padded), as the reference's unsharded tree;
    restored onto a (1, 4) mesh (the same D), every rank's shards gather to
    the same parameters and it holds its row of every moment."""
    outs = _spawn(tmp_path, 4, _LAYOUT_BODY)
    for o in outs:
        for key in ("params_equal", "rows_equal", "master_is_params",
                    "restored_equal", "restored_rows"):
            assert bool(o[key]), key
        assert int(o["count"]) == 1
        assert all(int(r[0]) == 4 for r in o["row_shapes"])


_SERVE_BODY = """
mesh = make_test_mesh(1, 2, device="cpu")
cfg = config()
tree = {}
for key, v in inp.items():
    if key.startswith("ref/"):
        node = tree
        *parents, leaf = key[4:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
params = api.shard_params(cfg, tree, mesh, device="cpu")
bsz, seq = inp["tokens"].shape
cache = step_lib.local_cache(cfg, mesh, bsz, seq + inp["gen"].shape[1],
                             device="cpu")
prefill = step_lib.build_prefill(cfg, params, (bsz, seq), mesh=mesh,
                                 cache=cache)
decode = step_lib.build_serve_step(cfg, params, cache, mesh=mesh)
_, logits = prefill({"tokens": inp["tokens"]})
got = [logits.numpy()]
for i in range(inp["gen"].shape[1]):
    _, logits = decode(inp["gen"][:, i:i + 1], seq + i)
    got.append(logits.numpy())
out["logits"] = np.stack(got)
out["cache_k"] = np.array(cache["k"].shape)
"""


def test_prefill_and_decode_on_a_mesh_match_reference(tmp_path):
    """fp32 prefill of 2 x 8 tokens and 4 decode steps on a (1, 2) mesh
    (eager, the cache's kv heads split, the logits gathered along the
    vocabulary), from the reference's numpy parameters through
    ``shard_params``, against the reference's one-device logits."""
    rcfg, pcfg = _cfgs()
    rp = ref_api.init_params(rcfg, jax.random.key(0))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    gen = rng.integers(0, rcfg.vocab_size, (2, 4)).astype(np.int32)
    cache, logits = ref_api.prefill(rcfg, rp, {"tokens": jnp.asarray(tokens)})
    cache = jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]),
        cache)
    want = [np.asarray(logits)]
    for i in range(4):
        cache, logits = ref_api.decode_step(rcfg, rp, cache,
                                            jnp.asarray(gen[:, i:i + 1]),
                                            jnp.int32(8 + i))
        want.append(np.asarray(logits))
    want = np.stack(want)
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, rp)):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        flat["ref/" + key] = np.asarray(leaf, np.float32)
    outs = _spawn(tmp_path, 2, _SERVE_BODY, tokens=tokens, gen=gen, **flat)
    scale = max(1.0, float(np.abs(want).max()))
    for o in outs:
        assert tuple(o["cache_k"]) == (2, 2, 12, 1, 16)   # 1 of 2 kv heads
        assert float(np.abs(o["logits"] - want).max()) <= 1e-4 * scale


_EDGE_BODY = """
mesh = make_test_mesh(1, 4, device="cpu")
cfg = config(num_heads=int(inp["heads"]), num_kv_heads=int(inp["kv"]))
params = api.shard_params(cfg, full_model(cfg), mesh, device="cpu")
lay = params.layout
out["heads"] = -1 if lay.heads is None else lay.heads[1] - lay.heads[0]
out["kv_take"] = np.array(lay.kv_take if lay.kv_take else [-1])
loss, aux = api.train_loss(cfg, params, {
    "tokens": torch.from_numpy(inp["tokens"]),
    "labels": torch.from_numpy(inp["labels"])})
grads = torch.autograd.grad(loss, list(params.parameters()))
sh = shr.spec_to_sharding(lay.specs, mesh)
out["loss"] = float(loss)
out["tokens"] = float(aux["tokens"])
for (n, _), g in zip(params.named_parameters(), grads):
    out["g/" + n] = sh[n].gather(g).numpy()
"""


@pytest.mark.parametrize("heads,kv,local_heads", [(4, 2, 1), (2, 1, -1)],
                         ids=["whole_kv_split_q", "whole_attention"])
def test_attention_layouts_without_a_split_kv_match_reference(
        tmp_path, heads, kv, local_heads):
    """Loss and gradients of one fp32 microbatch on a (1, 4) mesh against
    the reference's ``value_and_grad``: 4 heads on 2 kv heads keep
    ``wk``/``wv`` whole under the kv-aligned rule (each rank reads the kv
    head of its one q head; their gradients summed over ``model``), and 2
    heads replicate the whole attention (no collective in it), while the
    MLP and the vocabulary stay split."""
    rcfg, pcfg = _cfgs(num_heads=heads, num_kv_heads=kv)
    rp = ref_api.init_params(rcfg, jax.random.key(2))
    rng = np.random.default_rng(6)
    seq = rng.integers(0, rcfg.vocab_size, (2, 17))
    tokens, labels = seq[:, :16], seq[:, 1:].copy()
    labels[:, -1] = -1
    mb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss, aux), g = jax.value_and_grad(
        lambda p: ref_api.train_loss(rcfg, p, mb), has_aux=True)(rp)
    outs = _spawn(tmp_path, 4, _EDGE_BODY, heads=np.array(heads),
                  kv=np.array(kv), tokens=tokens, labels=labels,
                  **_port_tree(rp, pcfg))
    want = _port_tree(g, pcfg)
    for r, o in enumerate(outs):
        assert int(o["heads"]) == local_heads
        take = ([h // (heads // kv) for h in range(
            r * local_heads, (r + 1) * local_heads)] if local_heads > 0
            else [-1])
        assert list(o["kv_take"]) == take
        assert float(o["tokens"]) == float(aux["tokens"])
        assert abs(float(o["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        for name, ref in want.items():
            scale = max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(o["g/" + name[2:]] - ref).max())
            assert err <= 1e-4 * scale, (r, name, err)
