"""The ssm family (ROADMAP A.13, item 7c) against the reference on the CPU:
``repro_torch.models.rwkv6`` and ``repro_torch.kernels.wkv6`` against
``repro.models.rwkv6``, and rwkv6-3b at its ``reduced()`` size against
``repro.models.api``, with the reference's own parameters carried over.
Tolerances: fp32 1e-5 of the largest reference value, bf16 2e-2; logits
1e-4 of max(1, max |logits|) where a serving path compounds the layers,
as ``tests/test_torch_moe.py`` states them.

* The recurrence: ``wkv6_plain`` and the wrapper's CPU path against
  ``_wkv_scan`` with a zero and a non-zero initial state, at T = 1, odd T
  and a longer T; the state written in place into the caller's buffer
  (``s0`` itself included); the wrapper's checks, and on ``meta`` tensors
  its operator's shapes, the refused head size and its flop and byte
  formulas.
* The blocks: ``rwkv6_forward`` with and without state and
  ``channel_mix`` with and without a carry, fp32 and bf16.
* The config: fields equal the reference's, the full-size parameter count
  (3,099,857,920), prefill and 4 decode steps through ``params_from_numpy``
  in fp32 and bf16, a prefill into a used cache equal to one into a fresh
  cache, ``ServeQueue``'s greedy streams equal to the reference queue's
  (coalesced and sequential), two groups through one reused slot.
* Training: ``wkv6_bwd_plain`` and the autograd Function's backward
  (``wkv6_train``) against ``jax.vjp`` of ``_wkv_scan`` (T = 1, 7, 16;
  zero and non-zero start; a non-zero final-state cotangent) at 1e-5 of
  the largest reference value; ``wkv6_bwd``'s meta operator (shapes,
  flops, bytes); ``train_loss`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's, fp32 (loss 1e-5 relative,
  leaves 1e-4 of max(1, max |g|): the same fp32 arithmetic in another
  order) and bf16 (2e-2 of the same scales: bf16 roundings one ulp apart);
  a train step on (1, 2) and (2, 1) gloo meshes against one device's; the
  launcher training a reduced rwkv6 with a checkpoint and a resume.
* The mesh: ``param_specs`` and ``cache_specs`` equal to the reference's;
  (1, 2) and (2, 1) gloo meshes in fp32: the steps' logits against the
  reference's one device and the mesh queue's streams against its queue.
* The dry-run traces a serving cell with one ``wkv6`` operator a layer
  and the ``train_4k`` cell with one ``wkv6_bwd`` a layer and microbatch
  (and two ``wkv6``: the forward and the checkpoint's recompute); the
  launcher serves a reduced rwkv6 end to end.
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
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as rshr
from repro.launch import specs as rspecs
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.models import api as ref_api
from repro.models import rwkv6 as rrwkv
from repro.serve import queue as ref_queue
from repro.serve.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch.configs import REDUCED, get_config
from repro_torch.dist import sharding as tshr
from repro_torch.kernels import wkv6 as twkv
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import api, transformer
from repro_torch.models import rwkv6 as trwkv
from repro_torch.serve import queue
from repro_torch.serve.scheduler import SchedulerConfig
from test_torch_mesh import _port_tree, _ref_leaf, _spawn, _unstacked
from test_torch_serve_mesh import EXIT

ARCH = "rwkv6-3b"
F32_TOL, BF16_TOL, LM_TOL = 1e-5, 2e-2, 1e-4
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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a)))


def _carry(module, rp, dtype):
    """Copy the reference's parameter dict ``rp`` into ``module`` by
    name (values through fp32, exact for bf16)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = rp
            for key in name.split("."):
                node = node[key]
            p.copy_(_t(node).to(dtype))
    return module


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

def _scan_inputs(rng, B, T, H, N, nonzero_s0):
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N)) - 1.0)).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)).astype(np.float32) if nonzero_s0
          else np.zeros((B, H, N, N), np.float32))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("nonzero_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("T", [1, 7, 16])
def test_wkv6_plain_matches_reference_scan(T, nonzero_s0):
    """``wkv6_plain`` and the wrapper (a CPU tensor: the plain loop) against
    ``_wkv_scan``: y and the final state within 1e-5 of their largest
    reference value; the wrapper writes the state into ``state`` in place,
    also when that buffer is ``s0``."""
    rng = np.random.default_rng(T + 10 * nonzero_s0)
    B, H, N = 2, 3, 16
    r, k, v, w, u, s0 = _scan_inputs(rng, B, T, H, N, nonzero_s0)
    want_y, want_s = rrwkv._wkv_scan(*(jnp.asarray(a)
                                       for a in (r, k, v, w, u, s0)))
    tr, tk, tv, tw, tu, ts0 = (torch.from_numpy(a)
                               for a in (r, k, v, w, u, s0))
    y, s = twkv.wkv6_plain(tr, tk, tv, tw, tu,
                           ts0 if nonzero_s0 else None)
    _close(y.numpy(), want_y, F32_TOL, "y")
    _close(s.numpy(), want_s, F32_TOL, "s")
    buf = torch.full((B, H, N, N), 7.0)
    y2, s2 = twkv.wkv6(tr, tk, tv, tw, tu, ts0 if nonzero_s0 else None,
                       state=buf)
    assert s2 is buf and torch.equal(y2, y) and torch.equal(buf, s)
    inplace = ts0.clone()
    _, s3 = twkv.wkv6(tr, tk, tv, tw, tu, inplace, state=inplace)
    assert s3 is inplace and torch.equal(inplace, s)
    assert twkv.wkv6.launches == 0     # the plain loop counts nothing


def test_wkv6_checks_and_meta_operator():
    """The wrapper refuses mismatched shapes, a non-fp32 input and a
    strided state; on ``meta`` tensors it goes through
    ``torch.ops.repro_torch.wkv6`` (no launch), refuses a head size the
    kernel is not built for, and the operator's flop and byte formulas
    are the kernel's arithmetic and each tensor once."""
    from repro_torch.perf.hlo_analysis import StepTrace, op_stats
    r = torch.zeros((2, 5, 3, 16))
    u = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="must match"):
        twkv.wkv6(r, r[:, :4], r, r, u)
    with pytest.raises(ValueError, match="float32"):
        twkv.wkv6(r, r, r.double(), r, u)
    with pytest.raises(ValueError, match="contiguous"):
        twkv.wkv6(r, r, r, r, u,
                  state=torch.zeros((2, 3, 16, 32))[..., ::2])
    m16 = torch.empty((2, 5, 3, 16), device="meta")
    with pytest.raises(NotImplementedError, match="head size 16"):
        twkv.wkv6(m16, m16, m16, m16, torch.empty((3, 16), device="meta"))
    B, T, H, N = 2, 5, 3, 64
    m = torch.empty((B, T, H, N), device="meta")
    mu = torch.empty((H, N), device="meta")
    for s0 in (None, torch.empty((B, H, N, N), device="meta")):
        with StepTrace() as tr:
            y, s = twkv.wkv6(m, m, m, m, mu, s0)
        assert y.shape == (B, T, H, N) and s.shape == (B, H, N, N)
        rec = [x for x in tr.records if x["op"].startswith(
            "repro_torch::wkv6")]
        assert len(rec) == 1
        st = op_stats(rec[0])
        assert st.flops == B * T * H * (5 * N * N + 5 * N)
        io = 4 * (5 * B * T * H * N + H * N)
        state = 4 * B * H * N * N
        assert st.hbm_bytes == io + state * (1 if s0 is None else 2)
    assert twkv.wkv6.launches == 0


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_rwkv6_forward_matches_reference(dname, with_state):
    jdt, tdt = DTYPES[dname]
    d, H, B, T = 64, 4, 2, 9
    rp = rrwkv.rwkv6_init(jax.random.key(3), d, H, jdt)
    p = _carry(trwkv.TimeMix(d, H, tdt, "cpu"), rp, tdt)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    rstate = tstate = None
    if with_state:
        xl = rng.standard_normal((B, d)).astype(np.float32)
        s0 = (0.3 * rng.standard_normal((B, H, d // H, d // H))).astype(
            np.float32)
        rstate = (jnp.asarray(xl, jdt), jnp.asarray(s0))
        tstate = (torch.from_numpy(xl).to(tdt), torch.from_numpy(s0))
    want, (wlast, ws) = rrwkv.rwkv6_forward(rp, jx, H, rstate)
    with torch.no_grad():
        got, (glast, gs) = trwkv.rwkv6_forward(p, tx, H, tstate)
        got1, _ = trwkv.rwkv6_decode_step(p, tx[:, :1], H, tstate)
    assert got.dtype == tdt and gs.dtype == torch.float32
    tol = F32_TOL if dname == "float32" else BF16_TOL
    _close(got.float().numpy(), _np(want), tol, "out")
    _close(gs.numpy(), _np(ws), tol, "state")
    np.testing.assert_array_equal(glast.float().numpy(), _np(wlast))
    # the single-token step is the forward at T = 1
    want1, _ = rrwkv.rwkv6_decode_step(rp, jx[:, :1], H, rstate)
    _close(got1.float().numpy(), _np(want1), tol, "decode")


@pytest.mark.parametrize("with_carry", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dname, with_carry):
    jdt, tdt = DTYPES[dname]
    d, f = 64, 128
    rp = rrwkv.channel_mix_init(jax.random.key(5), d, f, jdt)
    p = _carry(trwkv.ChannelMix(d, f, tdt, "cpu"), rp, tdt)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    last = rng.standard_normal((3, d)).astype(np.float32)
    want, wl = rrwkv.channel_mix(rp, jnp.asarray(x, jdt),
                                 jnp.asarray(last, jdt) if with_carry
                                 else None)
    with torch.no_grad():
        got, gl = trwkv.channel_mix(p, torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(last).to(tdt)
                                    if with_carry else None)
    _close(got.float().numpy(), _np(want),
           F32_TOL if dname == "float32" else BF16_TOL)
    np.testing.assert_array_equal(gl.float().numpy(), _np(wl))


def test_init_draws_the_reference_distributions():
    """``rwkv6_init`` / ``channel_mix_init`` from a generator: the
    constants equal the reference's, the random leaves at its scales."""
    d, H = 256, 4
    ref = jax.tree.map(np.asarray, rrwkv.rwkv6_init(jax.random.key(0), d,
                                                    H, jnp.float32))
    p = trwkv.rwkv6_init(torch.Generator().manual_seed(0), d, H,
                         torch.float32, "cpu")
    got = {n: t.detach().numpy() for n, t in p.named_parameters()}
    for name in ("mu_x", "mu", "w0", "ln_out.scale", "ln_out.bias"):
        node = ref
        for key in name.split("."):
            node = node[key]
        np.testing.assert_allclose(got[name], node, rtol=1e-6)
    scale = {"mix_a": d ** -0.5, "mix_b": 0.01, "wr": d ** -0.5,
             "wg": d ** -0.5, "decay_a": d ** -0.5, "decay_b": 0.01,
             "u": 0.1}
    for name, want in scale.items():    # both at the reference's scale
        assert got[name].shape == ref[name].shape
        for drawn in (got[name], ref[name]):
            assert abs(drawn.std() / want - 1) < 0.15, name
    cm = trwkv.channel_mix_init(torch.Generator().manual_seed(0), d, 512,
                                torch.float32, "cpu")
    assert float(cm.mu_k.detach()[0]) == float(cm.mu_r.detach()[0]) == 0.5
    assert abs(float(cm.wv.detach().std()) * np.sqrt(512) - 1) < 0.1


# ---------------------------------------------------------------------------
# the config, one device
# ---------------------------------------------------------------------------

def _cfgs(dname="float32"):
    jdt, tdt = DTYPES[dname]
    return (dataclasses.replace(REF_REDUCED[ARCH](), dtype=jdt),
            dataclasses.replace(REDUCED[ARCH](), dtype=tdt))


@pytest.fixture(scope="module")
def carried():
    """Per dtype: the reference's config and parameters (seed 0) and the
    port's copy of them."""
    out = {}
    for dname in DTYPES:
        rcfg, cfg = _cfgs(dname)
        rp = ref_api.init_params(rcfg, jax.random.key(0))
        out[dname] = (rcfg, rp, cfg, transformer.params_from_numpy(
            cfg, jax.tree.map(np.asarray, rp), device="cpu"))
    return out


def test_config_equals_the_reference_and_counts_its_parameters():
    fields = [f.name for f in dataclasses.fields(get_config(ARCH))
              if f.name != "dtype"]
    for ref, port in ((ref_get_config(ARCH), get_config(ARCH)),
                      (REF_REDUCED[ARCH](), REDUCED[ARCH]())):
        assert {f: getattr(port, f) for f in fields} == {
            f: getattr(ref, f) for f in fields}
        assert str(port.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
    full = transformer.LM(get_config(ARCH), torch.device("meta"))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        rspecs.abstract_params(ref_get_config(ARCH))))
    assert transformer.num_params(full) == n_ref == 3_099_857_920
    assert not hasattr(full.layers[0], "attn")
    assert not hasattr(full.layers[0], "mlp")
    transformer.check_supported(get_config(ARCH))    # act "swiglu", unused


def _ref_serving(rcfg, rp, tokens):
    cache, logits = ref_api.prefill(
        rcfg, rp, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    out = [_np(logits)]
    for i in range(STEPS):
        cache, logits = ref_api.decode_step(
            rcfg, rp, cache,
            jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
            jnp.int32(PROMPT + i))
        out.append(_np(logits))
    return np.stack(out), jax.tree.map(_np, cache)


def _port_serving(cfg, params, tokens, cache=None):
    cache = (api.init_cache(cfg, tokens.shape[0], PROMPT + STEPS,
                            device="cpu") if cache is None else cache)
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
    return np.stack(got), cache


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(carried, dname):
    """Prefill and 4 decode steps: every step's logits, and the final state
    cache (``x_tm``, ``s`` fp32, ``x_cm``) of the reference's layout."""
    rcfg, rp, cfg, params = carried[dname]
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (3, PROMPT + STEPS))
    want, rcache = _ref_serving(rcfg, rp, tokens.astype(np.int32))
    got, cache = _port_serving(cfg, params, tokens)
    tol = LM_TOL if dname == "float32" else BF16_TOL
    _close(got, want, tol, dname, floor=1.0)
    assert set(cache) == set(rcache) == {"x_tm", "s", "x_cm"}
    assert cache["s"].dtype == torch.float32
    for name in cache:
        assert tuple(cache[name].shape) == rcache[name].shape
        _close(cache[name].float().numpy(), rcache[name],
               F32_TOL if dname == "float32" else BF16_TOL, name, floor=1.0)


def test_prefill_overwrites_a_used_cache(carried):
    """A prefill into a cache that holds another group's state equals one
    into a fresh cache, bit for bit: nothing of the old state is read."""
    _, _, cfg, params = carried["float32"]
    tokens = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, PROMPT + STEPS))
    fresh, fresh_cache = _port_serving(cfg, params, tokens)
    used = api.init_cache(cfg, 2, PROMPT + STEPS, device="cpu")
    other = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 9))
    api.prefill(cfg, params, {"tokens": other}, cache=used)
    api.decode_step(cfg, params, used, other[:, :1], 9)
    assert float(used["s"].abs().max()) > 0
    got, used = _port_serving(cfg, params, tokens, cache=used)
    np.testing.assert_array_equal(got, fresh)
    for name in used:
        assert torch.equal(used[name], fresh_cache[name]), name


def test_torch_backend_runs_the_plain_loop(carried, monkeypatch):
    """``backend="torch"`` on ``prefill`` and ``decode_step`` runs the
    recurrence's plain loop and never the kernel's wrapper, with the
    default path's logits."""
    _, _, cfg, params = carried["float32"]
    seq = np.random.default_rng(16).integers(0, cfg.vocab_size,
                                             (2, PROMPT + STEPS))
    want, _ = _port_serving(cfg, params, seq)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran")
    monkeypatch.setattr(trwkv._wkv, "wkv6", refuse)
    cache = api.init_cache(cfg, 2, PROMPT + STEPS, device="cpu")
    _, logits = api.prefill(cfg, params, {"tokens": seq[:, :PROMPT]},
                            cache=cache, backend="torch")
    got = [logits.numpy()]
    for i in range(STEPS):
        _, logits = api.decode_step(cfg, params, cache,
                                    seq[:, PROMPT + i:PROMPT + i + 1],
                                    PROMPT + i, backend="torch")
        got.append(logits.numpy())
    np.testing.assert_array_equal(np.stack(got), want)
    with pytest.raises(AssertionError, match="wrapper ran"):
        api.decode_step(cfg, params, cache, seq[:, :1], 0)


def _train_batch(cfg, seed=5, B=2, S=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[0, :3] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("dname,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-4), ("bfloat16", 2e-2, 2e-2)])
def test_train_loss_and_grads_match_reference(carried, dname, loss_tol,
                                              grad_tol):
    """``api.train_loss`` (each block under the checkpoint, the
    recurrence through ``wkv6_train``) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``train_loss``, with the
    reference's parameters carried over."""
    rcfg, rp, cfg, params = carried[dname]
    batch = _train_batch(cfg)
    (want, aux), g = jax.value_and_grad(
        lambda p: ref_api.train_loss(rcfg, p, {k: jnp.asarray(v) for k, v
                                               in batch.items()}),
        has_aux=True)(rp)
    loss, paux = api.train_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert float(paux["tokens"]) == float(aux["tokens"]) == 2 * 12 - 3
    assert abs(float(loss.detach()) - float(want)) <= loss_tol * abs(
        float(want))
    g = jax.tree.map(np.asarray, g)
    for (name, p), gp in zip(params.named_parameters(), grads):
        assert gp.dtype == p.dtype and gp.shape == p.shape
        w = transformer._numpy_leaf(g, name)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(gp.float().numpy() - w).max())
        assert err <= grad_tol * scale, (name, err)


@pytest.mark.parametrize("nonzero_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("T", [1, 7, 16])
def test_wkv6_bwd_matches_reference_vjp(T, nonzero_s0):
    """``wkv6_bwd_plain``, the wrapper on CPU tensors (from the plain
    loop's snapshots) and the autograd Function's backward against
    ``jax.vjp`` of ``_wkv_scan`` with cotangents on y and on the final
    state: dr, dk, dv, dw, du and ds0 within 1e-5 of their largest
    reference value; the Function leaves its inputs as they were."""
    rng = np.random.default_rng(40 + T + 10 * nonzero_s0)
    B, H, N = 2, 3, 16
    r, k, v, w, u, s0 = _scan_inputs(rng, B, T, H, N, nonzero_s0)
    dy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    dsT = rng.standard_normal((B, H, N, N)).astype(np.float32)
    _, vjp = jax.vjp(rrwkv._wkv_scan, *(jnp.asarray(a)
                                        for a in (r, k, v, w, u, s0)))
    want = [np.asarray(x) for x in vjp((jnp.asarray(dy), jnp.asarray(dsT)))]
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0, dy, dsT)]
    start = t[5] if nonzero_s0 else None
    got = twkv.wkv6_bwd_plain(*t[:5], t[6], start, t[7])
    _, _, snap = twkv.wkv6(*t[:5], start, snapshots=True)
    assert snap.shape == (-(-T // 8), B, H, N, N)
    assert torch.equal(snap[0], t[5])
    wrapped = twkv.wkv6_bwd(*t[:5], t[6], snap, t[7])
    keep = [x.clone() for x in t[:6]]
    ins = [x.clone().requires_grad_() for x in t[:5]]
    s0_in = t[5].clone().requires_grad_() if nonzero_s0 else None
    y, sT = twkv.wkv6_train(*ins, s0_in)
    fn = torch.autograd.grad(
        (y * t[6]).sum() + (sT * t[7]).sum(),
        ins + ([s0_in] if nonzero_s0 else []))
    for x, kept in zip(t[:6], keep):
        assert torch.equal(x, kept)
    for name, a, b, c, ref in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                                  got, wrapped, list(fn) + [None], want):
        _close(a.numpy(), ref, F32_TOL, name)
        assert torch.equal(a, b), name
        if c is not None:
            _close(c.numpy(), ref, F32_TOL, "fn " + name)
    assert twkv.wkv6_bwd.launches == 0


def test_wkv6_bwd_meta_operator():
    """``wkv6_bwd`` on ``meta`` tensors goes through
    ``torch.ops.repro_torch.wkv6_bwd`` (no launch): the six gradients'
    shapes, the flop formula (14 flops a state element and step, 15 a
    step's row: the bonus terms as row scalars) and the byte formula (the function's inputs and outputs
    once; the snapshots are workspace); the training forward's snapshots
    through ``repro_torch::wkv6``; a head size the kernel is not built for
    and a wrong snapshot shape raise."""
    from repro_torch.perf.hlo_analysis import StepTrace, op_stats
    B, T, H, N = 2, 13, 3, 64
    m = torch.empty((B, T, H, N), device="meta")
    mu = torch.empty((H, N), device="meta")
    with StepTrace() as tr:
        y, s, snap = twkv.wkv6(m, m, m, m, mu, snapshots=True)
        outs = twkv.wkv6_bwd(m, m, m, m, mu, m, snap)
    assert snap.shape == (2, B, H, N, N)
    assert [tuple(o.shape) for o in outs] == [(B, T, H, N)] * 4 + [
        (H, N), (B, H, N, N)]
    rec = [x for x in tr.records if x["op"].startswith(
        "repro_torch::wkv6_bwd")]
    assert len(rec) == 1
    st = op_stats(rec[0])
    assert st.flops == B * T * H * (14 * N * N + 15 * N)
    elems = 4 * B * T * H * N
    assert st.hbm_bytes == 9 * elems + 2 * 4 * H * N + 4 * B * H * N * N
    fwd = [x for x in tr.records if x["op"] == "repro_torch::wkv6.default"]
    assert len(fwd) == 1
    with pytest.raises(ValueError, match="snap"):
        twkv.wkv6_bwd(m, m, m, m, mu, m, snap[:1])
    m16 = torch.empty((B, T, H, 16), device="meta")
    with pytest.raises(NotImplementedError, match="head size 16"):
        twkv.wkv6_bwd(m16, m16, m16, m16, torch.empty((H, 16), device="meta"),
                      m16, torch.empty((2, B, H, 16, 16), device="meta"))
    assert twkv.wkv6.launches == twkv.wkv6_bwd.launches == 0


GEN_LENS, RIDS = [4, 3, 4], [1000, 1001, 1002]


def _drive(q, prompts, gens=GEN_LENS, rids=RIDS):
    reqs = [q.submit(p, g, now=0.0, rid=rid)
            for p, g, rid in zip(prompts, gens, rids)]
    t = 0.0
    while q.pending:
        if not q.step(now=t):
            break
        t += 1.0
    return reqs


def _kw(coalesced):
    kw = (dict(max_in_flight=2, max_batch=8) if coalesced
          else dict(max_in_flight=1, max_batch=1))
    kw.update(min_batch=1, max_wait_s=0.0)
    return kw


@pytest.mark.parametrize("coalesced", [True, False],
                         ids=["coalesced", "sequential"])
def test_serve_queue_streams_equal_reference(carried, coalesced):
    """Greedy streams of three requests through the port's ``ServeQueue``
    (its pool's slots over state caches) and the reference's, coalesced
    into one padded batch or one at a time; every logits row within
    1e-5."""
    rcfg, rp, cfg, params = carried["float32"]
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (8, 8, 5)]
    ref = ref_queue.ServeQueue(rcfg, ref_test_mesh(1, 1), rp,
                               record_logits=True,
                               config=RefSchedulerConfig(**_kw(coalesced)))
    port = queue.ServeQueue(cfg, params, record_logits=True,
                            config=SchedulerConfig(**_kw(coalesced)))
    r_reqs, p_reqs = _drive(ref, prompts), _drive(port, prompts)
    for rr, pr in zip(r_reqs, p_reqs):
        assert pr.tokens == rr.tokens and len(pr.tokens) == pr.gen_len
        for rl, pl in zip(ref.logits_log[rr.rid], port.logits_log[pr.rid]):
            np.testing.assert_allclose(pl, rl, rtol=1e-5, atol=1e-5)


def test_two_groups_reuse_one_slot(carried):
    """Two groups of one bucket, one after the other: the second takes the
    slot the first gave back (one slot built), and each request emits what
    the reference's queue emits for it."""
    rcfg, rp, cfg, params = carried["float32"]
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(2)]
    kw = _kw(False)
    port = queue.ServeQueue(cfg, params, config=SchedulerConfig(**kw))
    p_reqs = _drive(port, prompts, [4, 4], [1, 2])
    assert port.sched.counters["prefill_batches"] == 2
    assert len(port.pool) == 1 and port.pool.slots == 1
    ref = ref_queue.ServeQueue(rcfg, ref_test_mesh(1, 1), rp,
                               config=RefSchedulerConfig(**kw))
    r_reqs = _drive(ref, prompts, [4, 4], [1, 2])
    assert [r.tokens for r in p_reqs] == [r.tokens for r in r_reqs]
    # the second request alone in a fresh queue emits the same
    alone = queue.ServeQueue(cfg, params, config=SchedulerConfig(**kw))
    assert _drive(alone, prompts[1:], [4], [2])[0].tokens == \
        p_reqs[1].tokens


def test_pad_cache_leaves_state_leaves():
    cfg = REDUCED[ARCH]()
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    out = queue.pad_cache(cfg, cache, 64)
    assert all(out[k] is cache[k] for k in cache)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    ((1, 2), ("data", "model")), ((2, 4), ("data", "model")),
    ((1, 128), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))],
    ids=["1x2", "2x4", "1x128", "pod2x2x2"])
def test_param_and_cache_specs_match_reference(shape, names):
    """The reference's name rules on an RWKV block: the time mix's ``wg``
    columns and ``wo`` rows over ``model`` (whole where ``model`` does not
    divide d), everything else whole; the state cache's batch on the data
    axes."""
    rcfg, cfg = _cfgs()
    mesh, rmesh = abstract_mesh(shape, names), ref_abstract_mesh(shape,
                                                                 names)
    want = rshr.param_specs(rspecs.abstract_params(rcfg), rmesh, rcfg)
    skel = transformer.LM(cfg, torch.device("meta"))
    got = tshr.param_specs(skel, mesh, cfg)
    assert set(got) == {n for n, _ in skel.named_parameters()}
    for name, spec in got.items():
        ref, stacked = _ref_leaf(want, name)
        assert tuple(spec) == _unstacked(ref, stacked), name
    split = shape[-1] <= cfg.d_model
    assert tuple(got["layers.0.time_mix.wg"]) == (
        (None, "model") if split else ())
    assert tuple(got["layers.1.time_mix.wo"]) == (
        ("model", None) if split else ())
    for leaf in ("time_mix.wk", "channel_mix.wk", "channel_mix.wv",
                 "channel_mix.wr", "time_mix.mix_b", "time_mix.u"):
        assert tuple(got["layers.0." + leaf]) == (), leaf
    cache = api.init_cache(cfg, 4, 16, device="meta")
    rcache = jax.eval_shape(lambda: ref_api.init_cache(rcfg, 4, 16))
    rspec = rshr.cache_specs(rcache, rmesh, rcfg)
    assert {k: tuple(v) for k, v in tshr.cache_specs(
        {k: tuple(v.shape) for k, v in cache.items()}, mesh, cfg).items()} \
        == {k: tuple(v) for k, v in rspec.items()}


_MESH_BODY = """
import json
from repro_torch.serve.queue import ServeQueue
from repro_torch.serve.scheduler import SchedulerConfig
mesh = make_test_mesh(*json.loads(str(inp["mesh"])), device="cpu")
cfg = dataclasses.replace(REDUCED["rwkv6-3b"](), dtype=torch.float32)
params = api.shard_params(cfg, full_model(cfg), mesh, device="cpu")
out["gate"] = np.array(params.layout.gate or (-1, -1))
out["wg_cols"] = np.array(params.layers[0].time_mix.wg.shape[1])
tokens = inp["serve"]
prompt = int(inp["prompt"])
bsz, total = tokens.shape
cache = step_lib.local_cache(cfg, mesh, bsz, total, device="cpu")
out["s_shape"] = np.array(cache["s"].shape)
prefill = step_lib.build_prefill(cfg, params, (bsz, prompt), mesh=mesh,
                                 cache=cache)
decode = step_lib.build_serve_step(cfg, params, cache, mesh=mesh)
_, logits = prefill({"tokens": tokens[:, :prompt]})
got = [logits.numpy()]
for i in range(total - prompt):
    _, logits = decode(tokens[:, prompt + i:prompt + i + 1], prompt + i)
    got.append(logits.numpy())
out["logits"] = np.stack(got)
spec = json.loads(str(inp["spec"]))
q = ServeQueue(cfg, params, mesh=mesh, config=SchedulerConfig(**spec["kw"]))
if rank == 0:
    try:
        for p, g, rid in zip(spec["prompts"], spec["gen"], spec["rids"]):
            q.submit(p, g, now=0.0, rid=rid)
        t = 0.0
        while q.pending and q.step(now=t):
            t += 1.0
    finally:
        q.stop()
else:
    q.follow()
for rid, toks in q.streams.items():
    out[f"stream/{rid}"] = np.asarray(toks, np.int64)
""" + EXIT


@pytest.mark.parametrize("mesh,batch", [((1, 2), 2), ((2, 1), 3)],
                         ids=["1x2", "2x1-odd"])
def test_on_a_mesh_matches_one_device(tmp_path, carried, mesh, batch):
    """The reduced rwkv6 in fp32 on gloo ranks: at (1, 2) the time mix's
    gate split over ``model`` (32 of 64 columns a rank, ``wo``'s rows
    summed in fp32), at (2, 1) a batch of 3 padded to 2 rows a data rank;
    prefill and 4 decode steps' logits within 1e-5 of the reference's one
    device, and the mesh queue's greedy streams (rank 0 scheduling, the
    other rank following) equal to the reference queue's on every rank."""
    rcfg, rp, cfg, _ = carried["float32"]
    rng = np.random.default_rng(20 + batch)
    serve = rng.integers(0, cfg.vocab_size, (batch, PROMPT + STEPS))
    want, _ = _ref_serving(rcfg, rp, serve.astype(np.int32))
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (8, 8, 5)]
    kw = _kw(True)
    ref = ref_queue.ServeQueue(rcfg, ref_test_mesh(1, 1), rp,
                               config=RefSchedulerConfig(**kw))
    streams = {r.rid: r.tokens for r in _drive(ref, prompts)}
    spec = {"prompts": prompts, "gen": GEN_LENS, "rids": RIDS, "kw": kw}
    outs = _spawn(tmp_path, int(np.prod(mesh)), _MESH_BODY,
                  mesh=np.array(json.dumps(list(mesh))),
                  spec=np.array(json.dumps(spec)), serve=serve,
                  prompt=np.array(PROMPT), **_port_tree(rp, cfg))
    for r, o in enumerate(outs):
        _close(o["logits"], want, F32_TOL, r, floor=1.0)
        split = mesh[1] > 1
        assert list(o["gate"]) == ([32 * r, 32 * r + 32] if split
                                   else [-1, -1])
        assert int(o["wg_cols"]) == (32 if split else 64)
        assert int(o["s_shape"][1]) == -(-batch // mesh[0])
        got = {int(k.split("/")[1]): [int(t) for t in v]
               for k, v in o.items() if k.startswith("stream/")}
        assert got == streams, r


_TRAIN_BODY = """
import json
d, m = json.loads(str(inp["mesh"]))
mesh = make_test_mesh(d, m, device="cpu")
cfg = dataclasses.replace(REDUCED["rwkv6-3b"](), dtype=torch.float32)
params = api.shard_params(cfg, full_model(cfg), mesh, device="cpu")
state = adamw.init_opt_state(params, d * m, param_specs=params.layout.specs,
                             mesh=mesh)
step = step_lib.build_train_step(cfg, params, OptConfig(
    lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3), mesh=mesh,
    n_microbatches=2)
params, state, met = step(params, state, {
    "tokens": torch.from_numpy(inp["tokens"]),
    "labels": torch.from_numpy(inp["labels"])})
out.update({"m_" + k: float(v) for k, v in met.items()})
out.update(gathered(params, mesh))
""" + EXIT


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_train_step_on_a_mesh_matches_one_device(tmp_path, carried, mesh):
    """One fp32 AdamW step (2 microbatches of 2 sequences of 12 tokens) of
    the reduced rwkv6 on gloo ranks against the same step on one device,
    from the reference's parameters: at (1, 2) the time mix's gate split
    over ``model`` (y behind ``copy_to_model``, so the gradients of the
    whole weights are summed over the ranks), at (2, 1) the batch split
    over ``data``.  Step 0's loss within 1e-5 and gradient norm within
    1e-4 relative, every updated parameter within 1e-5 of max(1, max |p|)
    (Adam's eps 1e-3, as the dense family's mesh test)."""
    _, rp, cfg, _ = carried["float32"]
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, cfg.vocab_size, (2, 2, 12))
    labels = rng.integers(0, cfg.vocab_size, (2, 2, 12))
    init = _port_tree(rp, cfg)
    lm = transformer.LM(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            p.copy_(torch.from_numpy(init["p/" + name]))
    from repro_torch.dist import step as step_lib
    from repro_torch.optim import adamw
    one = step_lib.build_train_step(cfg, lm, adamw.OptConfig(
        lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3),
        n_microbatches=2)
    _, _, m1 = one(lm, adamw.init_opt_state(lm, 1), {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    outs = _spawn(tmp_path, int(np.prod(mesh)), _TRAIN_BODY,
                  mesh=np.array(json.dumps(list(mesh))), tokens=tokens,
                  labels=labels, **init)
    for r, o in enumerate(outs):
        for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            got, want = float(o["m_" + key]), float(m1[key])
            assert abs(got - want) <= tol * max(1.0, abs(want)), (r, key)
        for name, p in lm.named_parameters():
            want = p.detach().numpy()
            scale = max(1.0, float(np.abs(want).max()))
            err = float(np.abs(o["p/" + name] - want).max())
            assert err <= 1e-5 * scale, (r, name, err)


def test_launcher_trains_rwkv6_and_resumes_bitwise(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch rwkv6-3b --reduced``
    for 4 steps with a checkpoint after step 2, then ``--resume`` from it:
    the resumed steps' losses and gradient norms equal the uninterrupted
    run's bit for bit, and the loss stays finite."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
            "--seq-len", "16", "--global-batch", "4", "--ckpt-dir",
            str(tmp_path / "ck"), "--log-every", "1", "--no-final-ckpt"]
    first = launch_train.main(argv + ["--ckpt-every", "2"])
    again = launch_train.main(argv + ["--resume"])
    assert again["start_step"] == 2 and first["arch"] == "rwkv6-3b-reduced"
    for a, b in zip(first["steps"][2:], again["steps"]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    assert all(np.isfinite(s["loss"]) for s in first["steps"])
    assert "trained 2 steps" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the dry-run, the analyser and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k",
                                        "long_500k", "train_4k"])
def test_reduced_cell_traces_with_one_wkv6_a_layer(shape_name):
    """A reduced rwkv6 (head size 64: the kernel's) traced on ``meta`` at a
    (2, 2) mesh: one ``repro_torch::wkv6`` operator a layer, its flops the
    kernel's formula at the rank's rows, no launch; ``train_4k``: per
    microbatch and layer one ``repro_torch::wkv6_bwd`` and two
    ``repro_torch::wkv6`` (the forward and the checkpoint's recompute),
    at the microbatch's rows."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.perf.hlo_analysis import op_stats
    cfg = dataclasses.replace(REDUCED[ARCH](), rwkv_head_dim=64)
    shape = SHAPES[shape_name]
    with dryrun.fake_world(4, 0):
        mesh = DeviceMesh("meta", torch.arange(4).view(2, 2),
                          mesh_dim_names=("data", "model"))
        trace, _, mem = dryrun.trace_cell(cfg, shape_name, mesh,
                                          device="meta")
    h, n = cfg.d_model // 64, 64
    if shape.kind == "train":
        fwd = [r for r in trace.records
               if r["op"] == "repro_torch::wkv6.default"]
        bwd = [r for r in trace.records
               if r["op"] == "repro_torch::wkv6_bwd.default"]
        n_mb = len(bwd) // cfg.num_layers
        assert n_mb >= 1 and len(bwd) == cfg.num_layers * n_mb
        rows = shape.global_batch // 2 // n_mb
        assert len(fwd) == 2 * cfg.num_layers * n_mb
        assert all(op_stats(r).flops == rows * shape.seq_len * h * (
            14 * n * n + 15 * n) for r in bwd)
        assert twkv.wkv6.launches == twkv.wkv6_bwd.launches == 0
        return
    recs = [r for r in trace.records if r["op"].startswith(
        "repro_torch::wkv6")]
    assert len(recs) == cfg.num_layers
    rows = -(-shape.global_batch // 2)
    seq = shape.seq_len if shape.kind == "prefill" else 1
    assert all(op_stats(r).flops == rows * seq * h * (5 * n * n + 5 * n)
               for r in recs)
    assert trace.stats.flops > 0 and mem["argument_size_in_bytes"] > 0
    assert twkv.wkv6.launches == 0


def test_warm_up_and_launcher_serve_rwkv6(carried, monkeypatch, tmp_path,
                                          capsys):
    """An ssm model has no dense FFN: the launcher's plan-cache warm-up
    prunes the reference's synthetic (4d, d) matrix, and ``python -m
    repro_torch.launch.serve --arch rwkv6-3b --reduced`` serves every
    request."""
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    q = launch_serve.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "3",
        "--prompt-len", "8", "--gen-len", "4", "--obs", "cap", "--obs-dir",
        str(tmp_path / "obs")])
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and "wkv6 launches: 0" in out
    assert all(len(r.tokens) == 4 for r in q.completed)
