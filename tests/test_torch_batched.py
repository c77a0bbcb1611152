"""Batched multi-RHS execution of the PyTorch port against the JAX
reference (``tests/test_batched.py``, case by case), on the CPU.

The contract under test:
  * ``loops_spmm`` / ``loops_spmm_values`` take ``B`` of shape
    ``(..., K, N)`` and return ``(..., M, N)``: native batched == the
    unrolled per-element stack == ``torch.vmap`` == the reference's jnp
    oracle on the same numpy inputs, forward and gradients, across {fp32,
    bf16} x G{1, 8} x {pure-CSR, pure-BCSR, hybrid};
  * ``torch.vmap`` over the operand and a direct ``(batch, K, N)`` input
    both launch each kernel ONCE (the reference counts ``pallas_call``s in
    the jaxpr; here ``engine.get_kernel`` is routed, in the test only, to
    counting wrappers over the plain versions), forward and backward;
    the per-element loop launches ``batch`` times;
  * the backward under ``torch.vmap`` (``vmap(grad)``: per-element dB and
    value gradients; ``grad(vmap)``: value gradients summed over the
    batch) equals the reference's ``jax.vmap`` / ``jax.grad``;
  * empty batches and the empty matrix return correctly-shaped zeros on
    both backends; rank-1 / K-mismatched operands raise ``ValueError``;
  * one native batched call costs ``ceil(batch/bz)`` x the single-element
    grid steps, equal to the reference's counts.

Tolerances: fp32 1e-4, bf16 5e-2 (relative, and of the largest magnitude),
the reference test's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import spmm as rspmm
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.kernels import engine

DTYPES = [("float32", 1e-4), ("bfloat16", 5e-2)]
PANEL_GS = [1, 8]
BATCH = 3


def _sparse(rng, m, k, density, dname):
    """The reference test's matrix, rounded to ``dname``, as float32."""
    a = (rng.random((m, k)) < density) * rng.standard_normal((m, k))
    return np.asarray(jnp.asarray(a, getattr(jnp, dname))).astype(np.float32)


def _boundaries(m, br):
    # pure CSR, pure BCSR, and a hybrid br-aligned interior boundary
    return [m, 0, br]


def both(a, r_b, br, g, dname="float32"):
    """The reference's and the port's conversion of ``a``."""
    fr = rf.loops_from_csr(rf.csr_from_dense(
        np.asarray(jnp.asarray(a, getattr(jnp, dname)))), r_b, br, panel_g=g)
    fp = tf.loops_from_csr(tf.csr_from_dense(a), r_b, br, panel_g=g)
    return fr, fp


def values(fp, dname):
    """The port format's stored values as live tensors of ``dname``."""
    dt = getattr(torch, dname)
    return (torch.as_tensor(fp.csr_part.vals).to(dt),
            torch.as_tensor(fp.bcsr_part.tile_vals).to(dt))


def port(fp, b, dname, backend=None):
    """The port's product in ``dname``: ``loops_spmm`` for fp32,
    ``loops_spmm_values`` for bf16 (a bf16 format keeps fp32 host
    values)."""
    if dname == "float32":
        return tspmm.loops_spmm(fp, b, device="cpu", backend=backend)
    cv, bv = values(fp, dname)
    return tspmm.loops_spmm_values(fp, cv, bv, b, device="cpu",
                                   backend=backend)


def close(got, want, tol, msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got.detach().double().numpy(), want,
                               rtol=tol, atol=atol, err_msg=msg)


@pytest.fixture
def launches(monkeypatch):
    """Counts of the B1/B2 wrapper calls (launches on the card), routed
    through ``engine.get_kernel`` to counting wrappers over the plain
    panel versions, as the kernel wrappers count on the card."""
    counts = {"csr": 0, "bcsr": 0}
    get = engine.get_kernel

    def counting(part, op, impl="panels"):
        fn = get(part, op, impl)
        if op != "spmm" or impl != "panels":
            return fn

        def run(*a, **k):
            counts[part] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(engine, "get_kernel", counting)
    return counts


@pytest.mark.parametrize("dname,tol", DTYPES)
@pytest.mark.parametrize("g", PANEL_GS)
def test_batched_forward_parity(rng, dname, tol, g):
    """Native batched == unrolled == torch.vmap == the reference's jnp
    oracle, forward, across plans."""
    m, k, n = 24, 17, 8
    br = 16 if dname == "bfloat16" else 8
    a = _sparse(rng, m, k, 0.3, dname)
    b_np = np.asarray(jnp.asarray(rng.standard_normal((BATCH, k, n)),
                                  getattr(jnp, dname))).astype(np.float32)
    b3 = torch.as_tensor(b_np).to(getattr(torch, dname))
    want = np.einsum("mk,zkn->zmn", a, b_np)
    for r_b in _boundaries(m, br):
        fr, fp = both(a, r_b, br, g, dname)
        native = port(fp, b3, dname)
        assert native.shape == (BATCH, m, n)
        vmapped = torch.vmap(lambda bb: port(fp, bb, dname))(b3)
        unrolled = torch.stack([port(fp, b3[i], dname)
                                for i in range(BATCH)])
        oracle = np.asarray(rspmm.loops_spmm(
            fr, jnp.asarray(b_np, getattr(jnp, dname)), backend="jnp"),
            np.float32)
        close(native, want, tol, f"r_boundary={r_b} g={g}")
        close(native, oracle, tol, f"r_boundary={r_b} g={g}")
        assert torch.equal(vmapped, native)
        close(unrolled, native.double().numpy(), 1e-6)


@pytest.mark.parametrize("dname,tol", DTYPES)
@pytest.mark.parametrize("g", PANEL_GS)
def test_batched_grad_b_parity(rng, dname, tol, g):
    """dB = Aᵀ·dY per element, native and under torch.vmap, against the
    reference's gradient and dense numpy."""
    m, k, n = 24, 17, 8
    br = 16 if dname == "bfloat16" else 8
    a = _sparse(rng, m, k, 0.3, dname)
    b_np = rng.standard_normal((BATCH, k, n)).astype(np.float32)
    dy = rng.standard_normal((BATCH, m, n)).astype(np.float32)
    want = np.einsum("mk,zmn->zkn", a, dy)
    dt = getattr(torch, dname)
    b3 = torch.as_tensor(b_np).to(dt)
    for r_b in _boundaries(m, br):
        fr, fp = both(a, r_b, br, g, dname)
        bb = b3.clone().requires_grad_()
        out = port(fp, bb, dname)
        (out * torch.as_tensor(dy).to(out.dtype)).sum().backward()
        assert bb.grad.dtype == b3.dtype and bb.grad.shape == b3.shape
        close(bb.grad, want, tol, f"r_boundary={r_b} g={g}")

        def loss(b2, d2):
            out = port(fp, b2, dname)
            return (out * d2.to(out.dtype)).sum()
        db = torch.vmap(torch.func.grad(loss))(b3, torch.as_tensor(dy))
        close(db, bb.grad.double().numpy(), 1e-6)

        def rloss(b2, d2):
            out = rspmm.loops_spmm(fr, b2, backend="jnp")
            return jnp.sum(out * d2.astype(out.dtype))
        rdb = jax.vmap(jax.grad(rloss))(jnp.asarray(b_np, getattr(jnp, dname)),
                                        jnp.asarray(dy))
        close(db, np.asarray(rdb, np.float32), tol)


@pytest.mark.parametrize("g", PANEL_GS)
def test_batched_value_grads_summed_over_batch(rng, g):
    """loops_spmm_values under a batched operand: d(values) is the batch
    sum (shared parameters), dB stays per-element -- both equal the
    reference's jnp autodiff, and the port's torch backend's."""
    m, k, n = 21, 13, 8
    a = _sparse(rng, m, k, 0.35, "float32")
    b_np = rng.standard_normal((BATCH, k, n)).astype(np.float32)
    fr, fp = both(a, 8, 8, g)
    cv, bv = values(fp, "float32")
    b3 = torch.as_tensor(b_np)

    def loss(cv_, bv_, bb, backend=None):
        return torch.tanh(tspmm.loops_spmm_values(
            fp, cv_, bv_, bb, device="cpu", backend=backend)).sum()

    def rloss(cv_, bv_, bb):
        return jnp.sum(jnp.tanh(rspmm.loops_spmm_values(
            fr, cv_, bv_, bb, backend="jnp")))

    gi = torch.func.grad(loss, argnums=(0, 1, 2))(cv, bv, b3)
    gt = torch.func.grad(lambda *x: loss(*x, backend="torch"),
                         argnums=(0, 1, 2))(cv, bv, b3)
    gj = jax.grad(rloss, argnums=(0, 1, 2))(
        jnp.asarray(fr.csr_part.vals), jnp.asarray(fr.bcsr_part.tile_vals),
        jnp.asarray(b_np))
    for got, alt, want in zip(gi, gt, gj):
        close(got, np.asarray(want), 1e-4)
        close(alt, np.asarray(want), 1e-4)
    per_elem = [torch.func.grad(loss)(cv, bv, b3[i:i + 1])
                for i in range(BATCH)]
    close(gi[0], sum(per_elem).numpy(), 1e-4)


def test_vmap_lowers_to_single_batched_call(rng, launches):
    """torch.vmap and a direct (batch, K, N) input both launch each part's
    kernel once; the per-element loop launches batch x.  The vmapped
    result equals the native batched one bitwise."""
    m, k, n = 24, 16, 8
    a = _sparse(rng, m, k, 0.3, "float32")
    _, fmt = both(a, 8, 8, 8)                  # hybrid: 2 parts
    b3 = torch.as_tensor(rng.standard_normal((BATCH, k, n)),
                         dtype=torch.float32)

    def f(bb):
        return tspmm.loops_spmm(fmt, bb, device="cpu")

    def count(fn):
        launches.update(csr=0, bcsr=0)
        out = fn(b3)
        return out, dict(launches)

    y_vmap, n_vmap = count(torch.vmap(f))
    y_direct, n_direct = count(f)
    _, n_loop = count(lambda bb: torch.stack([f(bb[i])
                                              for i in range(BATCH)]))
    assert n_vmap == {"csr": 1, "bcsr": 1}, n_vmap
    assert n_direct == {"csr": 1, "bcsr": 1}
    assert n_loop == {"csr": BATCH, "bcsr": BATCH}
    assert torch.equal(y_vmap, y_direct)


def test_vmap_backward_is_one_batched_call_per_part(rng, launches):
    """vmap of the gradient: the forward and the dB = Aᵀ·dY backward each
    launch every part of their format once for the whole batch, and give
    the unbatched gradient of each element."""
    m, k, n = 24, 16, 8
    a = _sparse(rng, m, k, 0.3, "float32")
    _, fmt = both(a, 8, 8, 8)
    tl = fmt.transposed()
    b3 = torch.as_tensor(rng.standard_normal((BATCH, k, n)),
                         dtype=torch.float32)
    dy = torch.as_tensor(rng.standard_normal((BATCH, m, n)),
                         dtype=torch.float32)

    def loss(bb, d):
        return (tspmm.loops_spmm(fmt, bb, device="cpu") * d).sum()

    launches.update(csr=0, bcsr=0)
    db = torch.vmap(torch.func.grad(loss))(b3, dy)
    parts = {"csr": 0, "bcsr": 0}
    for f in (fmt, tl.fmt):
        parts["csr"] += int(f.r_boundary > 0)
        parts["bcsr"] += int(f.r_boundary < f.nrows)
    assert launches == parts
    for i in range(BATCH):
        assert torch.equal(db[i], torch.func.grad(loss)(b3[i], dy[i]))


def test_vmap_value_grads_match_reference(rng):
    """The backward under vmap of loops_spmm_values: vmap(grad) gives each
    element's value gradients (the reference's jax.vmap of jax.grad), and
    grad of the vmapped sum gives their batch sum."""
    m, k, n = 21, 13, 8
    a = _sparse(rng, m, k, 0.35, "float32")
    b_np = rng.standard_normal((BATCH, k, n)).astype(np.float32)
    fr, fp = both(a, 8, 8, 8)
    cv, bv = values(fp, "float32")

    def loss(cv_, bv_, bb):
        return torch.tanh(tspmm.loops_spmm_values(fp, cv_, bv_, bb,
                                                  device="cpu")).sum()

    def rloss(cv_, bv_, bb):
        return jnp.sum(jnp.tanh(rspmm.loops_spmm_values(
            fr, cv_, bv_, bb, backend="jnp")))

    rargs = (jnp.asarray(fr.csr_part.vals),
             jnp.asarray(fr.bcsr_part.tile_vals))
    per = torch.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                     in_dims=(None, None, 0))(cv, bv, torch.as_tensor(b_np))
    rper = jax.vmap(jax.grad(rloss, argnums=(0, 1, 2)),
                    in_axes=(None, None, 0))(*rargs, jnp.asarray(b_np))
    for got, want in zip(per, rper):
        assert got.shape == want.shape
        close(got, np.asarray(want), 1e-4)
    summed = torch.func.grad(
        lambda c, v: torch.tanh(torch.vmap(
            lambda bb: tspmm.loops_spmm_values(fp, c, v, bb, device="cpu"))(
                torch.as_tensor(b_np))).sum(), argnums=(0, 1))(cv, bv)
    for got, want in zip(summed, rper[:2]):
        close(got, np.asarray(want).sum(0), 1e-4)
    # mapped values: one call per element, stacked
    scale = torch.arange(1, BATCH + 1, dtype=torch.float32)
    cv3 = cv[None] * scale[:, None]
    got = torch.vmap(lambda c, bb: tspmm.loops_spmm_values(
        fp, c, bv, bb, device="cpu"))(cv3, torch.as_tensor(b_np))
    want = jax.vmap(lambda c, bb: rspmm.loops_spmm_values(
        fr, c, rargs[1], bb, backend="jnp"))(
            jnp.asarray(cv3.numpy()), jnp.asarray(b_np))
    close(got, np.asarray(want), 1e-4)


def test_multi_leading_batch_dims(rng):
    """Arbitrary-rank leading dims flatten into one batched call, also
    under torch.vmap."""
    m, k, n = 16, 12, 8
    a = _sparse(rng, m, k, 0.3, "float32")
    fr, fp = both(a, 8, 8, 4)
    b4 = rng.standard_normal((2, 2, k, n)).astype(np.float32)
    out = tspmm.loops_spmm(fp, torch.as_tensor(b4), device="cpu")
    assert out.shape == (2, 2, m, n)
    want = rspmm.loops_spmm(fr, jnp.asarray(b4), backend="jnp")
    close(out, np.asarray(want), 1e-4)
    vm = torch.vmap(lambda bb: tspmm.loops_spmm(fp, bb, device="cpu"),
                    in_dims=1)(torch.as_tensor(b4))
    assert torch.equal(vm, out.transpose(0, 1))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_empty_batch_returns_zeros(rng, backend):
    """A zero-size batch dim yields correctly shaped zeros on both
    backends, as does the empty matrix under batching and under vmap."""
    m, k, n = 16, 12, 8
    a = _sparse(rng, m, k, 0.3, "float32")
    _, fmt = both(a, 8, 8, 8)
    kw = dict(device="cpu", backend=backend)
    assert tspmm.loops_spmm(fmt, torch.zeros((0, k, n)), **kw).shape == \
        (0, m, n)
    assert tspmm.loops_spmm(fmt, torch.zeros((2, 0, k, n)), **kw).shape == \
        (2, 0, m, n)
    cv, bv = values(fmt, "float32")
    assert tspmm.loops_spmm_values(fmt, cv, bv, torch.zeros((0, k, n)),
                                   **kw).shape == (0, m, n)
    zfmt = tf.loops_from_csr(tf.csr_from_dense(np.zeros((m, k), np.float32)),
                             8, 8)
    out = tspmm.loops_spmm(zfmt, torch.zeros((2, k, n)), **kw)
    assert out.shape == (2, m, n) and not out.any()
    b3 = torch.as_tensor(rng.standard_normal((2, k, n)), dtype=torch.float32)
    vm = torch.vmap(lambda bb: tspmm.loops_spmm(zfmt, bb, **kw))(b3)
    assert vm.shape == (2, m, n) and not vm.any()
    gz = torch.vmap(torch.func.grad(
        lambda bb: tspmm.loops_spmm(zfmt, bb, **kw).sum()))(b3)
    assert gz.shape == b3.shape and not gz.any()


def test_bad_rhs_raises_value_error(rng):
    """Rank-1 and K-mismatched operands fail fast with a clear message."""
    m, k = 16, 12
    a = _sparse(rng, m, k, 0.3, "float32")
    _, fmt = both(a, 8, 8, 8)
    with pytest.raises(ValueError, match=r"\(\.\.\., K, N\)"):
        tspmm.loops_spmm(fmt, torch.zeros((k,)), device="cpu",
                         backend="torch")
    with pytest.raises(ValueError, match="ncols"):
        tspmm.loops_spmm(fmt, torch.zeros((k + 1, 4)), device="cpu")
    cv, bv = values(fmt, "float32")
    with pytest.raises(ValueError, match=r"\(\.\.\., K, N\)"):
        tspmm.loops_spmm_values(fmt, cv, bv, torch.zeros((k,)),
                                device="cpu", backend="torch")
    with pytest.raises(ValueError, match="ncols"):
        engine.csr_spmm(fmt.csr_part, torch.zeros((k + 3, 4)),
                        backend="torch")


@pytest.mark.parametrize("batch", [0, 2, 4, 8, 11, 12, 13, 16, (2, 4)])
def test_batched_grid_steps_equal_reference(rng, batch):
    """One native batched call costs ceil(batch/bz) x the single-element
    steps, strictly below the per-element loop from batch 2 up; the
    counts equal the reference's (awkward sizes pad, not degrade)."""
    m, k = 48, 32
    a = _sparse(rng, m, k, 0.15, "float32")
    fr = rf.loops_from_csr(rf.csr_from_dense(a), 24, 8, panel_g=8)
    fp = tf.loops_from_csr(tf.csr_from_dense(a), 24, 8, panel_g=8)
    one = tspmm.loops_grid_steps(fp, 32)
    assert one == rspmm.loops_grid_steps(fr, 32)
    got = tspmm.loops_batched_grid_steps(fp, batch, 32)
    assert got == rspmm.loops_batched_grid_steps(fr, batch, 32)
    flat = int(np.prod(batch))
    if flat >= 2:
        assert got < flat * one


def test_prime_batch_pads_not_degrades(rng):
    """A batch with no small divisor (11) stays right, forward and
    backward, against the reference's jnp oracle."""
    m, k, n, batch = 16, 12, 8, 11
    a = _sparse(rng, m, k, 0.3, "float32")
    fr, fp = both(a, 8, 8, 4)
    b_np = rng.standard_normal((batch, k, n)).astype(np.float32)
    b3 = torch.as_tensor(b_np)
    out = tspmm.loops_spmm(fp, b3, device="cpu")
    assert out.shape == (batch, m, n)
    close(out, np.asarray(rspmm.loops_spmm(fr, jnp.asarray(b_np),
                                           backend="jnp")), 1e-4)
    cv, bv = values(fp, "float32")

    def loss(cv_, bv_, bb):
        return (tspmm.loops_spmm_values(fp, cv_, bv_, bb,
                                        device="cpu") ** 2).sum()

    def rloss(cv_, bv_, bb):
        return jnp.sum(rspmm.loops_spmm_values(fr, cv_, bv_, bb,
                                               backend="jnp") ** 2)

    gi = torch.func.grad(loss, argnums=(0, 1, 2))(cv, bv, b3)
    gj = jax.grad(rloss, argnums=(0, 1, 2))(
        jnp.asarray(fr.csr_part.vals), jnp.asarray(fr.bcsr_part.tile_vals),
        jnp.asarray(b_np))
    for got, want in zip(gi, gj):
        close(got, np.asarray(want), 1e-4)


def test_sparse_ffn_batched_activations(rng):
    """The sparse FFN consumes the batched path: rank-3 activations keep
    their batch structure and match the reference's jnp oracle, forward
    and backward."""
    from repro.models import sparse_ffn as rffn

    from test_torch_sparse_ffn import carried
    w = rng.standard_normal((24, 16)).astype(np.float32)
    rl = rffn.sparse_linear_from_dense(w, 0.6)
    vals = rl.init_values()
    layer = carried(rl, {k: np.asarray(v) for k, v in vals.items()},
                    "float32")
    x_np = rng.standard_normal((2, 5, 16)).astype(np.float32)
    x = torch.as_tensor(x_np).requires_grad_()
    y = layer(x)
    assert y.shape == (2, 5, 24)
    (y ** 2).sum().backward()

    def rloss(v, x_):
        return jnp.sum(rffn.sparse_linear_apply(rl, v, x_, backend="jnp")
                       ** 2)
    gv, gx = jax.grad(rloss, argnums=(0, 1))(vals, jnp.asarray(x_np))
    close(x.grad, np.asarray(gx), 1e-4)
    close(layer.csr_vals.grad, np.asarray(gv["csr_vals"]), 1e-4)
    close(layer.bcsr_vals.grad, np.asarray(gv["bcsr_vals"]), 1e-4)


def test_every_product_goes_through_its_function(rng, monkeypatch):
    """Every call runs the kernels through the autograd Function, with or
    without a gradient to record and under torch.vmap, and gives the bits
    of the kernels called directly."""
    m, k, n = 24, 16, 8
    a = _sparse(rng, m, k, 0.3, "float32")
    _, fmt = both(a, 8, 8, 8)
    b3 = torch.as_tensor(rng.standard_normal((BATCH, k, n)),
                         dtype=torch.float32)
    direct = engine.loops_spmm_fused(fmt, b3)
    calls = []
    apply = tspmm._LoopsSpmm.apply
    monkeypatch.setattr(tspmm._LoopsSpmm, "apply",
                        lambda *a: calls.append(1) or apply(*a))

    def f(bb):
        return tspmm.loops_spmm(fmt, bb, device="cpu")

    plain = f(b3)
    assert len(calls) == 1 and plain.grad_fn is None
    assert torch.equal(plain, direct)
    with torch.no_grad():
        assert f(b3.clone().requires_grad_()).grad_fn is None
    assert len(calls) == 2
    traced = f(b3.clone().requires_grad_())
    assert len(calls) == 3 and traced.grad_fn is not None
    assert torch.equal(traced.detach(), plain)
    assert torch.equal(torch.vmap(f)(b3), plain) and len(calls) == 5
