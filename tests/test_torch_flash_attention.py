"""B5 on the CPU: the port's ``flash_attention`` (its plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode and its
XLA-level ``layers.flash_attention``, with the reference test's shapes and
tolerances (fp32 2e-5, bf16 3e-2), plus ragged S, chunk invariance, the
inputs the kernel refuses, and the per-row bound ``chip_smoke.py`` holds
the kernel to on the card against faults of a model of the kernel.  The
reference attention's contract beyond its kernel: sliding windows (4, 5,
16, and 20 with a prefix offset), causal Sq < Sk and Sq > Sk (rows no key
may see), non-causal Sq != Sk, hd 96, against ``repro.models.layers.
flash_attention`` in fp32 at 2e-5 and bf16 at 3e-2, with the gradients of
the autograd Function against ``jax.vjp`` at 1e-5 of max(1, max |g|); the
mask's kept pairs in the flop formula; ``decode_attention``'s window
against the reference's.  Inputs come from numpy with a seed."""
import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as b5
from repro_torch.models import layers as tlayers

SHAPES = [(1, 64, 1, 1, 16), (2, 128, 4, 2, 32), (1, 64, 6, 2, 16)]
DTYPES = [("float32", 2e-5), ("bfloat16", 3e-2)]


def _qkv(rng, B, S, H, KV, hd):
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _torch(a, dname):
    return torch.from_numpy(a).to(getattr(torch, dname))


def _jax(a, dname):
    return jnp.asarray(a, getattr(jnp, dname))


def _naive(q, k, v, causal):
    """Full softmax(QKᵀ/sqrt(hd))V in float64 with GQA, as ground truth."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kr = np.repeat(k, rep, axis=2).astype(np.float64)
    vr = np.repeat(v, rep, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(hd)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vr)


@pytest.mark.parametrize("dname,tol", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_port_matches_pallas_kernel_and_xla(rng, dname, tol, B, S, H, KV,
                                            hd, causal):
    q, k, v = _qkv(rng, B, S, H, KV, hd)
    before = b5.flash_attention.launches
    got = b5.flash_attention(_torch(q, dname), _torch(k, dname),
                             _torch(v, dname), causal=causal)
    assert b5.flash_attention.launches == before   # CPU: no kernel launch
    assert got.dtype == getattr(torch, dname) and got.shape == q.shape
    got = got.float().numpy()
    jq, jk, jv = (_jax(a, dname) for a in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=32,
                                    block_k=32, interpret=True)
    xla = ref_flash(jq, jk, jv, causal=causal, q_chunk=32, k_chunk=32)
    for want in (pallas, xla):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("S,causal", [(100, True), (100, False),
                                      (577, True)])
def test_ragged_sequence(rng, S, causal):
    """S not a multiple of any chunk: shorter last chunks, against the
    float64 softmax and the reference's one-chunk XLA path."""
    q, k, v = _qkv(rng, 2, S, 4, 2, 16)
    got = b5.flash_attention_plain(_torch(q, "float32"), _torch(k, "float32"),
                                   _torch(v, "float32"), causal=causal,
                                   q_chunk=64, k_chunk=48).numpy()
    np.testing.assert_allclose(got, _naive(q, k, v, causal), rtol=2e-5,
                               atol=2e-5)
    want = ref_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     q_chunk=S, k_chunk=S)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_chunk_invariance(rng):
    """The reference kernel's block-shape invariance, on the plain
    version's chunking (equal and ragged chunks)."""
    q, k, v = (_torch(a, "float32") for a in _qkv(rng, 1, 128, 2, 2, 16))
    outs = [b5.flash_attention_plain(q, k, v, causal=True, q_chunk=qc,
                                     k_chunk=kc)
            for qc, kc in [(32, 32), (64, 32), (128, 128), (48, 80)]]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_layers_entry_routes_to_b5(rng, backend):
    q, k, v = (_torch(a, "float32") for a in _qkv(rng, 1, 64, 4, 2, 32))
    got = tlayers.flash_attention(q, k, v, causal=True, backend=backend)
    want = b5.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(got, want)


def _args(rng, B=1, S=16, H=4, KV=2, hd=16, Sk=None, dtype=torch.float32):
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd))).to(dtype)
    kv = torch.from_numpy(rng.standard_normal((B, Sk or S, KV, hd))).to(
        dtype)
    return q, kv, kv.clone()


@pytest.mark.parametrize("case,exc", [
    ("negative_window", ValueError), ("no_keys", ValueError),
    ("head_dim_24", ValueError), ("heads_not_multiple", ValueError),
    ("float64", ValueError), ("not_contiguous", ValueError)])
@pytest.mark.parametrize("entry", ["kernel", "layers_torch"])
def test_refuses_what_the_kernel_does_not_take(rng, case, exc, entry):
    """A window and Sq != Sk are taken (the parity tests below); a
    negative window, no keys, an unbuilt head dim, heads that KV does not
    divide, fp64 and a strided q are refused."""
    window = 0
    if case == "negative_window":
        q, k, v = _args(rng)
        window = -1
    elif case == "no_keys":
        q, k, v = _args(rng, Sk=24)
        k, v = k[:, :0].contiguous(), v[:, :0].contiguous()
    elif case == "head_dim_24":
        q, k, v = _args(rng, hd=24)
    elif case == "heads_not_multiple":
        q, k, v = _args(rng, H=3)
    elif case == "float64":
        q, k, v = _args(rng, dtype=torch.float64)
    else:
        q, k, v = _args(rng)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(exc):
        if entry == "kernel":
            b5.flash_attention(q, k, v, causal=True, window=window)
        else:
            tlayers.flash_attention(q, k, v, causal=True, window=window,
                                    backend="torch")


def _tiled_model(q, k, v, causal, *, drop=None, swap_v=None, tile=64):
    """B5's wgmma body modelled in fp32: online softmax over ``tile``-key
    tiles, P rounded to q's dtype before P·V, the output rounded once.  The
    faults: ``drop`` leaves tile ``drop`` out; ``swap_v`` = (i, j) reads
    tile j's V for tile i and i's for j."""
    B, S, H, hd = q.shape
    kv = k.shape[2]
    qf = q.float().reshape(B, S, kv, H // kv, hd)
    vf = v.float().clone()
    if swap_v is not None:
        i, j = (slice(t * tile, (t + 1) * tile) for t in swap_v)
        vf[:, i], vf[:, j] = vf[:, j].clone(), vf[:, i].clone()
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float()) / math.sqrt(hd)
    pos = torch.arange(S)
    keep = (pos[None, :] <= pos[:, None]) if causal else torch.ones(
        S, S, dtype=torch.bool)
    if drop is not None:
        keep[:, drop * tile:(drop + 1) * tile] = False
    s = torch.where(keep, s, torch.tensor(b5.NEG_INF))
    m = torch.full(s.shape[:-1], b5.NEG_INF)
    den = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (hd,))
    for k0 in range(0, S, tile):
        m_new = torch.maximum(m, s[..., k0:k0 + tile].amax(-1))
        p = torch.exp(s[..., k0:k0 + tile] - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgh->bgrqh", p.to(q.dtype).float(), vf[:, k0:k0 + tile])
        m = m_new
    o = acc / den.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


@pytest.mark.parametrize("dname", ["bfloat16", "float16"])
@pytest.mark.parametrize("S,causal", [(1000, True), (1000, False),
                                      (2049, True), (2049, False)])
@pytest.mark.parametrize("hd", [16, 64])
def test_row_bound_passes_rounding_and_fails_a_lost_tile(rng, dname, S,
                                                         causal, hd):
    """``chip_smoke.FLASH_ROW_TOL``, the per-row bound B5 is held to on the
    card, against the plain version: the kernel's model passes it, and the
    model fails it with a K / V tile left out (the first, a middle one, the
    last full one and the ragged last) or two tiles' V swapped.  Not the
    ragged last tile of 1 key at S 2049 when causal: it reaches one row a
    head, which it moves by that one key's weight only."""
    q, k, v = (_torch(a, dname) for a in _qkv(rng, 1, S, 4, 1, hd))
    want = b5.flash_attention_plain(q, k, v, causal=causal)
    tol = chip_smoke.FLASH_ROW_TOL[dname]
    assert chip_smoke.row_err(_tiled_model(q, k, v, causal), want) < tol
    last = (S - 1) // 64
    faults = [{"drop": t} for t in (0, last // 2, last - 1)]
    faults += [{"swap_v": (1, last // 2)}]
    if not causal or S % 64 > 1:
        faults += [{"drop": last}]
    for fault in faults:
        got = _tiled_model(q, k, v, causal, **fault)
        assert chip_smoke.row_err(got, want) > tol, fault


# ---------------------------------------------------------------------------
# training: B5's log-sum-exp and its autograd Function
# ---------------------------------------------------------------------------

GRAD_SHAPES = [(1, 64, 1, 1, 16), (2, 96, 4, 2, 32), (1, 80, 6, 2, 16),
               (1, 48, 4, 1, 64)]


def _ref_lse(q, k, causal):
    """Each row's log-sum-exp of the scaled, masked scores, float64."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kr = np.repeat(k, rep, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(hd)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("B,S,H,KV,hd", GRAD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_function_grads_match_jax_grad(rng, B, S, H, KV, hd, causal):
    """The Function (plain forward on the CPU, the chunked backward) against
    ``jax.grad`` of the reference's ``layers.flash_attention`` on the same
    numpy inputs and cotangent, GQA: output, dQ, dK and dV within 1e-5 of
    max(1, max |reference|) in fp32, and the log-sum-exp the backward reads
    within 1e-5 of a float64 one."""
    import jax
    qa, ka, va = _qkv(rng, B, S, H, KV, hd)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def ref_loss(q, k, v):
        out = ref_flash(q, k, v, causal=causal, q_chunk=16, k_chunk=16)
        return jnp.sum(out * do), out
    (_, ref_out), ref_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qa, ka, va))
    out = b5.flash_attention_train(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    _, lse = b5.flash_attention(q.detach(), k.detach(), v.detach(),
                                causal=causal, return_lse=True)
    assert lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(qa, ka, causal),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((out.detach(),) + grads, (ref_out,) + ref_g):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_plain_lse_and_layers_route(rng, dname):
    """``return_lse`` leaves the output as it was, and ``layers`` routes a
    call that needs a gradient through the Function (same output) and one
    under ``no_grad`` to the plain call."""
    q, k, v = (_torch(a, dname) for a in _qkv(rng, 2, 64, 4, 2, 32))
    out, lse = b5.flash_attention_plain(q, k, v, causal=True,
                                        return_lse=True)
    assert torch.equal(out, b5.flash_attention_plain(q, k, v, causal=True))
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 64)
    qg = q.clone().requires_grad_()
    routed = tlayers.flash_attention(qg, k, v, causal=True)
    assert routed.grad_fn is not None and torch.equal(routed.detach(), out)
    with torch.no_grad():
        plain = tlayers.flash_attention(qg, k, v, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out)


def test_layers_torch_backend_differentiates_the_plain_version(rng):
    """``backend="torch"`` with a gradient is autograd through the plain
    version, not B5's Function: bit for bit the gradients of
    ``flash_attention_plain`` itself, so it serves as a reference that
    shares nothing with ``flash_attention_bwd``."""
    qa, ka, va = _qkv(rng, 1, 48, 4, 2, 16)
    do = _torch(rng.standard_normal(qa.shape).astype(np.float32), "float32")
    outs = {}
    for route in ("layers_torch", "plain", "layers_default"):
        q, k, v = (_torch(a, "float32").requires_grad_()
                   for a in (qa, ka, va))
        if route == "plain":
            y = b5.flash_attention_plain(q, k, v, causal=True)
        else:
            y = tlayers.flash_attention(
                q, k, v, causal=True,
                backend="torch" if route == "layers_torch" else None)
        outs[route] = (type(y.grad_fn).__name__,
                       torch.autograd.grad(y, (q, k, v), do))
    assert "_FlashAttention" not in outs["layers_torch"][0]
    assert "_FlashAttention" in outs["layers_default"][0]
    for g, w in zip(outs["layers_torch"][1], outs["plain"][1]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("chunk_elems", [1, 7 * 64 * 8, 1 << 26])
def test_backward_chunking_invariance(rng, chunk_elems):
    """The backward's query chunks (1 row, ragged, all rows) give the same
    gradients within fp32 rounding: 1e-5 of max(1, max |gradient|)."""
    q, k, v = (_torch(a, "float32") for a in _qkv(rng, 1, 64, 8, 2, 16))
    do = _torch(rng.standard_normal(q.shape).astype(np.float32), "float32")
    out, lse = b5.flash_attention_plain(q, k, v, causal=True,
                                        return_lse=True)
    got = b5.flash_attention_bwd(q, k, v, lse, do, causal=True,
                                 chunk_elems=chunk_elems)
    want = b5.flash_attention_bwd(q, k, v, lse, do, causal=True)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_function_under_checkpoint(rng):
    """Under ``torch.utils.checkpoint`` (non-reentrant, as the LM's remat
    runs it) the Function's gradients equal those without, and the forward
    runs twice (the recompute), as B5 launches twice on the card."""
    from torch.utils.checkpoint import checkpoint
    qa, ka, va = _qkv(rng, 1, 48, 4, 2, 16)
    do = torch.from_numpy(rng.standard_normal((1, 48, 4, 16)).astype(
        np.float32))
    calls = []
    real = b5.flash_attention_plain

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def block(q, k, v):
        return b5.flash_attention_train(q * 1.5, k, v, causal=True)

    grads = []
    for remat in (False, True):
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in (qa, ka, va))
        calls.clear()
        b5.flash_attention_plain = counted
        try:
            out = (checkpoint(block, q, k, v, use_reentrant=False) if remat
                   else block(q, k, v))
            grads.append(torch.autograd.grad(out, (q, k, v), do))
        finally:
            b5.flash_attention_plain = real
        assert len(calls) == (2 if remat else 1)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference attention's contract: windows, Sq != Sk, hd 96
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd, causal, window); the reference needs its chunks
# to divide Sq and Sk, so it runs 16-row chunks where 16 divides them.
CONTRACT = [
    (2, 32, 32, 4, 2, 16, True, 4), (1, 40, 40, 6, 2, 16, True, 5),
    (2, 64, 64, 4, 1, 32, True, 16), (1, 16, 48, 4, 2, 16, True, 0),
    (1, 48, 16, 4, 2, 16, True, 0), (1, 16, 48, 4, 4, 16, False, 0),
    (1, 48, 16, 2, 2, 16, False, 0), (1, 32, 32, 2, 1, 96, True, 0),
    (1, 16, 48, 4, 2, 16, True, 20), (1, 40, 40, 5, 1, 16, True, 0)]
CONTRACT_IDS = ["w4", "w5", "w16", "causal_sq_lt_sk", "causal_sq_gt_sk",
                "full_sq_lt_sk", "full_sq_gt_sk", "hd96", "offset_w20",
                "rep5"]


def _chunk(n):
    return 16 if n % 16 == 0 else n


def _ref_attn(B, Sq, Sk, causal, window):
    def f(q, k, v):
        return ref_flash(q, k, v, causal=causal, window=window,
                         q_chunk=_chunk(Sq), k_chunk=_chunk(Sk))
    return f


@pytest.mark.parametrize("dname,tol", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", CONTRACT,
                         ids=CONTRACT_IDS)
def test_contract_matches_reference_attention(rng, dname, tol, B, Sq, Sk, H,
                                              KV, hd, causal, window):
    """The plain version (odd chunks: 7 queries, 5 keys) and
    ``layers.flash_attention`` on both backends against the reference's
    ``flash_attention``; rows no key may see (causal, Sq > Sk) give its
    -1e30 fill's uniform row, the mean of v."""
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    want = np.asarray(_ref_attn(B, Sq, Sk, causal, window)(
        *(_jax(a, dname) for a in (q, k, v))), np.float32)
    tq, tk, tv = (_torch(a, dname) for a in (q, k, v))
    outs = [b5.flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, q_chunk=7, k_chunk=5)]
    outs += [tlayers.flash_attention(tq, tk, tv, causal=causal,
                                     window=window, backend=be)
             for be in ("cuda", "torch")]
    for got in outs:
        assert got.shape == q.shape and got.dtype == tq.dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
    if causal and Sq > Sk:      # the uniform rows, pinned
        mean = v.mean(axis=1)                            # (B, KV, hd)
        rows = np.repeat(mean, H // KV, axis=1)[:, None]
        np.testing.assert_allclose(
            outs[0][:, :Sq - Sk].float().numpy(),
            np.broadcast_to(rows, (B, Sq - Sk, H, hd)), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", CONTRACT,
                         ids=CONTRACT_IDS)
def test_contract_grads_match_reference(rng, B, Sq, Sk, H, KV, hd, causal,
                                        window):
    """The autograd Function (B5's forward with its lse, then
    ``flash_attention_bwd``) and the plain version through autograd,
    against ``jax.vjp`` of the reference's attention, fp32: dq, dk, dv
    within 1e-5 of max(1, max |g|)."""
    import jax
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    _, vjp = jax.vjp(_ref_attn(B, Sq, Sk, causal, window),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    for backend in ("cuda", "torch"):
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tlayers.flash_attention(*ins, causal=causal, window=window,
                                      backend=backend)
        grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
        for name, g, w in zip("qkv", grads, want):
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-5 * scale, (backend, name, err)


def test_lse_of_rows_no_key_may_see_and_kept_pairs(rng):
    """A row no key may see has the log-sum-exp -1e30 (its fill), and the
    flop formula counts the pairs the mask keeps: every key for such a
    row, the window's span otherwise."""
    q, k, v = (_torch(a, "float32") for a in (
        rng.standard_normal((1, 20, 2, 16)), rng.standard_normal(
            (1, 8, 2, 16)), rng.standard_normal((1, 8, 2, 16))))
    _, lse = b5.flash_attention_plain(q, k, v, causal=True,
                                      return_lse=True)
    assert bool((lse[:, :, :12] == b5.NEG_INF).all())
    assert bool((lse[:, :, 12:] > -1e3).all())
    assert b5.kept_pairs(20, 8, True) == 12 * 8 + sum(range(1, 9))
    assert b5.kept_pairs(16, 16, True) == 16 * 17 // 2
    assert b5.kept_pairs(16, 16, False) == 256
    assert b5.kept_pairs(10, 30, True, 4) == 10 * 4
    assert b5.kept_pairs(10, 10, True, 3) == 1 + 2 + 8 * 3
    assert b5.kept_pairs(10, 30, False, 4) == sum(
        30 - (i + 20 - 4 + 1) for i in range(10))


@pytest.mark.parametrize("window", [0, 3, 8])
@pytest.mark.parametrize("length", [1, 5, 12])
def test_decode_attention_window_matches_reference(rng, window, length):
    """``layers.decode_attention(window=)`` against the reference's: the
    entries before ``length - window`` dropped as the ones past
    ``length``, fp32 at 1e-6."""
    from repro.models.layers import decode_attention as ref_decode
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    want = ref_decode(*(jnp.asarray(a) for a in (q, kc, vc)), length,
                      window=window)
    got = tlayers.decode_attention(*(torch.from_numpy(a) for a in
                                     (q, kc, vc)), length, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    as_tensor = tlayers.decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc)),
        torch.tensor(length), window=window)
    assert torch.equal(as_tensor, got)
