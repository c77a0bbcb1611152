"""The weight-sparse linear layer of the PyTorch port against the JAX
reference's ``repro.models.sparse_ffn`` on the CPU: pruning and conversion,
and forward values, activation and value gradients, and a few SGD steps
with the weights carried across by ``sparse_linear_from_numpy``, for rank
1, 2 and 3 activations.

Tolerances: fp32 1e-5 of the largest magnitude (sums in another order);
bf16 2e-2 of it (the kernel path casts the cotangent to bf16 before
``dx``, as the reference's Pallas path does, and bf16 rounds the outputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sparse_ffn as rffn
from repro_torch.core import formats as tf
from repro_torch.models import sparse_ffn as tffn

from test_torch_formats import assert_same

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def close(got, want, tol, msg=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().double().numpy(), want, rtol=0,
                               atol=tol * scale, err_msg=msg)


def f32(a):
    return np.asarray(a).astype(np.float32)


def carried(ref_layer, values, dname):
    """The port's layer built from the reference layer's format arrays and
    its numpy values (bf16 arrives as fp32)."""
    fr = ref_layer.fmt
    arrays = dict(
        csr_row_ptr=fr.csr_part.row_ptr, csr_col_idx=fr.csr_part.col_idx,
        csr_vals=f32(fr.csr_part.vals), tile_rows=fr.bcsr_part.tile_rows,
        tile_cols=fr.bcsr_part.tile_cols,
        tile_vals=f32(fr.bcsr_part.tile_vals),
        block_ptr=fr.bcsr_part.block_ptr, r_boundary=fr.r_boundary,
        shape=fr.shape, panel_g=fr.panel_g, macro_m=fr.macro_m,
        pipeline_depth=fr.pipeline_depth)
    return tffn.sparse_linear_from_numpy(
        arrays, {k: f32(v) for k, v in values.items()},
        dtype=getattr(torch, dname), device="cpu")


def ref_layer(rng, dname, d_out=256, d_in=24, sparsity=0.6):
    """A reference layer; at 256 output rows the default plan is hybrid
    for both tile heights."""
    w = np.asarray(jnp.asarray(rng.standard_normal((d_out, d_in)),
                               getattr(jnp, dname)))
    layer = rffn.sparse_linear_from_dense(w, sparsity)
    assert 0 < layer.fmt.r_boundary < d_out
    return w, layer


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_magnitude_prune_matches_reference(rng, sparsity):
    w = rng.standard_normal((33, 17)).astype(np.float32)
    np.testing.assert_array_equal(tffn.magnitude_prune(w, sparsity),
                                  rffn.magnitude_prune(w, sparsity))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_from_dense_matches_reference(rng, dname):
    """Pruning and conversion agree; a bf16 layer plans with Br=16 and
    keeps its (exact) values in fp32 on the host."""
    w, layer_r = ref_layer(rng, dname)
    wt = torch.from_numpy(f32(w)).to(getattr(torch, dname))
    layer_t = tffn.sparse_linear_from_dense(wt, 0.6, device="cpu")
    fr, fp = layer_r.fmt, layer_t.fmt
    assert fp.bcsr_part.br == fr.bcsr_part.br
    assert fp.r_boundary == fr.r_boundary
    if dname == "float32":
        assert_same(fr, fp)
    for part in ("csr_part", "bcsr_part"):
        for name in ("row_ptr", "col_idx", "tile_rows", "tile_cols"):
            if hasattr(getattr(fr, part), name):
                np.testing.assert_array_equal(getattr(getattr(fr, part), name),
                                              getattr(getattr(fp, part), name))
    np.testing.assert_array_equal(f32(fr.bcsr_part.tile_vals),
                                  fp.bcsr_part.tile_vals)
    assert layer_t.csr_vals.dtype == getattr(torch, dname)
    assert (layer_t.d_in, layer_t.d_out) == (layer_r.d_in, layer_r.d_out)
    # the parameters are copies: training leaves the host format alone
    with torch.no_grad():
        layer_t.csr_vals.add_(1)
    np.testing.assert_array_equal(f32(fr.csr_part.vals), fp.csr_part.vals)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [None, (5,), (2, 5), (2, 3, 4)])
def test_grads_match_reference(rng, dname, lead):
    """Forward values and the gradients of ``sum(y * dy)`` at both value
    arrays and at ``x``, on the port's kernel path and its flat path."""
    _, layer_r = ref_layer(rng, dname)
    values_r = layer_r.init_values()
    layer_t = carried(layer_r, values_r, dname)
    shape = (layer_r.d_in,) if lead is None else lead + (layer_r.d_in,)
    jdt = getattr(jnp, dname)
    x = np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
    dy = rng.standard_normal(shape[:-1] + (layer_r.d_out,)).astype(
        np.float32)

    def loss_r(v, x_):
        y = rffn.sparse_linear_apply(layer_r, v, x_, backend="jnp")
        return jnp.sum(y.astype(jnp.float32) * dy), y
    (_, y_r), g_r = jax.value_and_grad(loss_r, argnums=(0, 1),
                                       has_aux=True)(values_r,
                                                     jnp.asarray(x))
    for backend in ("cuda", "torch"):
        xt = torch.from_numpy(f32(x)).to(getattr(torch, dname))
        xt.requires_grad_(True)
        y = layer_t(xt, backend=backend)
        assert y.dtype == xt.dtype and y.shape == tuple(y_r.shape)
        close(y, f32(y_r), TOL[dname], f"{backend} y")
        g_cv, g_bv, g_x = torch.autograd.grad(
            (y.float() * torch.from_numpy(dy)).sum(),
            [layer_t.csr_vals, layer_t.bcsr_vals, xt])
        for got, want, what in ((g_cv, g_r[0]["csr_vals"], "csr_vals"),
                                (g_bv, g_r[0]["bcsr_vals"], "bcsr_vals"),
                                (g_x, g_r[1], "x")):
            assert got.dtype == getattr(torch, dname)
            close(got, f32(want), TOL[dname], f"{backend} d{what}")


def test_sgd_steps_follow_the_reference(rng):
    """Three SGD steps on ``sum(y²)`` over a rank-3 activation: the port's
    kernel path and the reference's ``jnp`` path give the same losses."""
    _, layer_r = ref_layer(rng, "float32", d_in=32, sparsity=0.9)
    values = layer_r.init_values()
    layer_t = carried(layer_r, values, "float32")
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    lr = 1e-3

    def loss_r(v):
        y = rffn.sparse_linear_apply(layer_r, v, jnp.asarray(x),
                                     backend="jnp")
        return jnp.sum(y ** 2)
    params = [layer_t.csr_vals, layer_t.bcsr_vals]
    losses = []
    for step in range(3):
        want, g = jax.value_and_grad(loss_r)(values)
        loss = (layer_t(torch.from_numpy(x)) ** 2).sum()
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        with torch.no_grad():
            for p, gp in zip(params, grads):
                p.sub_(lr * gp)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                                   err_msg=f"step {step}")
        values = jax.tree.map(lambda w, gw: w - lr * gw, values, g)
        losses.append(float(loss))
    assert losses[2] < losses[0]


def test_layer_is_a_module_with_two_value_parameters(rng):
    w = rng.standard_normal((20, 12)).astype(np.float32)
    layer = tffn.sparse_linear_from_dense(w, 0.5, device="cpu")
    names = dict(layer.named_parameters())
    assert set(names) == {"csr_vals", "bcsr_vals"}
    assert isinstance(layer.fmt, tf.LoopsFormat)
    x = torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
    np.testing.assert_allclose(
        layer(x).detach().numpy(),
        x.numpy() @ tffn.magnitude_prune(w, 0.5).T, rtol=1e-5, atol=1e-5)
