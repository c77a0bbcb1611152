"""B5 on the CPU: the port's ``flash_attention`` (its plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode and its
XLA-level ``layers.flash_attention``, with the reference test's shapes and
tolerances (fp32 2e-5, bf16 3e-2), plus ragged S, chunk invariance, the
inputs the kernel refuses, and the per-row bound ``chip_smoke.py`` holds
the kernel to on the card against faults of a model of the kernel.  Inputs
come from numpy with a seed."""
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
    ("window", NotImplementedError), ("prefix_offset", NotImplementedError),
    ("head_dim_24", ValueError), ("heads_not_multiple", ValueError),
    ("float64", ValueError), ("not_contiguous", ValueError)])
@pytest.mark.parametrize("entry", ["kernel", "layers_torch"])
def test_refuses_what_the_kernel_does_not_take(rng, case, exc, entry):
    window = 0
    if case == "window":
        q, k, v = _args(rng)
        window = 4
    elif case == "prefix_offset":
        q, k, v = _args(rng, Sk=24)
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
