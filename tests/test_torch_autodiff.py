"""Training parity of the PyTorch port with the JAX reference on the CPU:
the transposed format and its value maps, the mapped BCSR conversion, the
SDD panel functions (B3/B4's plain versions) against the Pallas kernels in
interpret mode, the gradients of ``loops_spmm`` / ``loops_spmm_values``
against ``jax.grad`` through ``backend="jnp"``, and a small GCN trained in
both packages.

Tolerances: fp32 1e-5 of the largest magnitude (sums in another order),
fp64 1e-12 under x64, bf16 2e-2 of the largest magnitude (the port's
kernel path casts the cotangent to bf16 before ``dB``, as the reference's
Pallas path does, while ``jnp`` differentiates in fp32).  On the CPU the
kernel wrappers run their plain versions; the CUDA kernels are held
against those on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import spmm as rspmm
from repro.core import suite as rsuite
from repro.kernels import engine as rengine
from repro.kernels.spmm_sdd import (bcsr_sdd_panels_pallas,
                                    csr_sdd_panels_pallas)
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.core import suite as tsuite
from repro_torch.kernels import engine, spmm_sdd
from repro_torch.models import (GCN, gcn_loss, gcn_params_from_numpy,
                                sgd_step)

from test_torch_formats import assert_same
from test_torch_gpu import adversarial_cases
from test_torch_kernels import to_torch

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2}


@contextlib.contextmanager
def x64_if(dname):
    if dname == "float64":
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", False)
    else:
        yield


def sparse(rng, m, k, density):
    return (rng.random((m, k)) < density) * rng.standard_normal((m, k))


def formats(a, dname, r_b, br, g):
    """The reference's format of ``a`` in ``dname`` and the port's of the
    same values (a bf16 port format holds its values in fp32)."""
    dense = np.asarray(jnp.asarray(a, getattr(jnp, dname)))
    host = dense.astype(np.float32) if dname == "bfloat16" else dense
    return (rf.loops_from_csr(rf.csr_from_dense(dense), r_b, br, panel_g=g),
            tf.loops_from_csr(tf.csr_from_dense(host), r_b, br, panel_g=g))


def close(got, want, tol, msg=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.double().detach().numpy(), want,
                               rtol=0, atol=tol * scale, err_msg=msg)


def port_grads(fp, dname, b, dy, backend, *, values):
    """``(d_csr_vals, d_bcsr_vals, dB)`` of ``sum(Y * dy)`` through the port
    (value grads ``None`` unless ``values``)."""
    dt = getattr(torch, dname)
    bt = torch.tensor(np.asarray(b, np.float64), dtype=dt, requires_grad=True)
    dyt = torch.as_tensor(np.asarray(dy))
    if values:
        cv = torch.tensor(fp.csr_part.vals, dtype=dt, requires_grad=True)
        bv = torch.tensor(fp.bcsr_part.tile_vals, dtype=dt,
                          requires_grad=True)
        y = tspmm.loops_spmm_values(fp, cv, bv, bt, device="cpu",
                                    backend=backend)
        return torch.autograd.grad(y, [cv, bv, bt], dyt.to(y.dtype),
                                   allow_unused=True, materialize_grads=True)
    y = tspmm.loops_spmm(fp, bt, device="cpu", backend=backend)
    return None, None, torch.autograd.grad(y, bt, dyt.to(y.dtype))[0]


def ref_grads(fr, b, dy, *, values):
    """The same through ``jax.grad`` of the reference on ``backend="jnp"``."""
    if values:
        def loss(cv, bv, bb):
            out = rspmm.loops_spmm_values(fr, cv, bv, bb, backend="jnp")
            return jnp.sum(out * jnp.asarray(dy, out.dtype))
        return jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(fr.csr_part.vals), jnp.asarray(fr.bcsr_part.tile_vals),
            b)

    def loss_b(bb):
        out = rspmm.loops_spmm(fr, bb, backend="jnp")
        return jnp.sum(out * jnp.asarray(dy, out.dtype))
    return None, None, jax.grad(loss_b)(b)


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["indivisible", "row_spans_panels",
                                  "empty_rows", "panel_at_row_boundary"])
@pytest.mark.parametrize("keep_zeros", [False, True])
def test_bcsr_from_csr_rows_options_match_reference(rng, case, keep_zeros):
    a = adversarial_cases(rng)[case].astype(np.float32)
    # stored zeros (the transposed CSR's pads) must keep their slots
    cr, _, _ = rf._transposed_csr(rf.loops_from_csr(rf.csr_from_dense(a),
                                                    0, 4))
    cp, _, _ = tf._transposed_csr(tf.loops_from_csr(tf.csr_from_dense(a),
                                                    0, 4))
    assert_same(cr, cp)
    for start, stop, br in ((0, cr.nrows, 4), (1, cr.nrows, 8),
                            (cr.nrows // 2, cr.nrows, 16),
                            (cr.nrows, cr.nrows, 8)):
        want = rf.bcsr_from_csr_rows(cr, start, stop, br,
                                     keep_zeros=keep_zeros, return_map=True)
        got = tf.bcsr_from_csr_rows(cp, start, stop, br,
                                    keep_zeros=keep_zeros, return_map=True)
        assert_same(want[0], got[0])
        assert want[1].dtype == got[1].dtype
        np.testing.assert_array_equal(want[1], got[1])


@pytest.mark.parametrize("r_frac", [1.0, 0.0, 0.4])
@pytest.mark.parametrize("t_plan", [None, "csr", "hybrid"])
def test_transposed_format_matches_reference(rng, r_frac, t_plan):
    """Pure-CSR, pure-BCSR and hybrid A, under the default transposed plan
    and under pinned pure-CSR and hybrid transposed plans."""
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    a[:, 5] = 0                       # an empty row of Aᵀ
    m, k = a.shape
    r_b = int(r_frac * m) // 8 * 8
    fr, fp = formats(a, "float32", r_b, 8, 3)
    plans = {None: (None, None),
             "csr": (rspmm.SpmmPlan(k, 4, 4, 8, 3), tspmm.SpmmPlan(k, 4, 4, 8, 3)),
             "hybrid": (rspmm.SpmmPlan(8, 4, 4, 4, 2),
                        tspmm.SpmmPlan(8, 4, 4, 4, 2))}[t_plan]
    tr, tp = fr.transposed(plan=plans[0]), fp.transposed(plan=plans[1])
    assert_same(tr.fmt, tp.fmt)
    assert dataclasses.asdict(tr.plan) == dataclasses.asdict(tp.plan)
    for name in ("entry_src", "entry_slot", "bcsr_slot"):
        assert getattr(tr, name).dtype == getattr(tp, name).dtype
        np.testing.assert_array_equal(getattr(tr, name), getattr(tp, name))
    assert (tr.n_slots, tr.csr_len) == (tp.n_slots, tp.csr_len)
    assert_same(tr.fmt.csr_panels, tp.fmt.csr_panels)
    assert_same(tr.fmt.bcsr_panels, tp.fmt.bcsr_panels)


def test_transposed_values_carry_live_values_and_gradients(rng):
    a = sparse(rng, 19, 12, 0.4).astype(np.float32)
    fr, fp = formats(a, "float32", 8, 8, 4)
    tr, tp = fr.transposed(), fp.transposed()
    cv = torch.tensor(fp.csr_part.vals, requires_grad=True)
    bv = torch.tensor(fp.bcsr_part.tile_vals, requires_grad=True)
    got = tf.transposed_values(tp, cv, bv)
    want = rf.transposed_values(tr, jnp.asarray(fr.csr_part.vals),
                                jnp.asarray(fr.bcsr_part.tile_vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].detach().numpy(),
                                  tp.fmt.csr_part.vals)
    # linear in the values: the gradient of sum(w * out) is the carried w
    w0 = torch.tensor(rng.standard_normal(got[0].shape).astype(np.float32))
    w1 = torch.tensor(rng.standard_normal(got[1].shape).astype(np.float32))
    g_cv, g_bv = torch.autograd.grad((got[0] * w0).sum()
                                     + (got[1] * w1).sum(), [cv, bv])
    jg = jax.grad(lambda c, b: jnp.sum(rf.transposed_values(tr, c, b)[0]
                                       * w0.numpy())
                  + jnp.sum(rf.transposed_values(tr, c, b)[1]
                            * w1.numpy()), argnums=(0, 1))(
        jnp.asarray(fr.csr_part.vals), jnp.asarray(fr.bcsr_part.tile_vals))
    np.testing.assert_allclose(g_cv.numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(g_bv.numpy(), np.asarray(jg[1]), atol=1e-6)


@pytest.mark.parametrize("part", ["csr", "bcsr"])
def test_scatter_gather_values_match_reference(rng, part):
    a = adversarial_cases(rng)["row_spans_panels"].astype(np.float32)
    fr, fp = formats(a, "float32", 2, 4, 3)
    pr, pp = getattr(fr, f"{part}_panels"), getattr(fp, f"{part}_panels")
    items = (fp.csr_part.vals if part == "csr" else fp.bcsr_part.tile_vals)
    live = torch.tensor(items + 1.0, requires_grad=True)
    got = pp.scatter_values(live)
    want = pr.scatter_values(jnp.asarray(items + 1.0))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert torch.equal(getattr(fp.on("cpu"), part).scatter_values(live), got)
    assert torch.equal(pp.gather_values(got), live)
    (g,) = torch.autograd.grad(got.sum(), live)
    assert torch.equal(g, torch.ones_like(live))


# ---------------------------------------------------------------------------
# B3 / B4 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64"])
def test_sdd_plain_matches_pallas(rng, dname, batch):
    with x64_if(dname):
        jdt = getattr(jnp, dname)
        for name, a in adversarial_cases(rng).items():
            m, k = a.shape
            br = 16 if dname == "bfloat16" else 8
            r_b = m // 2 // br * br
            fr, _ = formats(a, dname, r_b, br, 3)
            lead = () if batch is None else (batch,)
            b = np.asarray(jnp.asarray(rng.standard_normal(lead + (k, 40)),
                                       jdt))
            dy = rng.standard_normal(lead + (m, 40)).astype(
                np.float64 if dname == "float64" else np.float32)
            cp, bp = fr.csr_panels, fr.bcsr_panels
            if r_b == 0:      # no CSR part (the engine launches nothing)
                cp = fr.bcsr_panels
            want = csr_sdd_panels_pallas(
                jnp.asarray(cp.panel_rows), jnp.asarray(cp.panel_cols),
                jnp.asarray(dy), jnp.asarray(b), interpret=True)
            got = spmm_sdd.csr_sdd_panels(
                to_torch(cp.panel_rows), to_torch(cp.panel_cols),
                to_torch(cp.panel_mask) != 0, torch.as_tensor(dy),
                to_torch(b))
            assert got.dtype == to_torch(np.asarray(want)).dtype
            real = cp.panel_mask != 0
            close(got[torch.as_tensor(real)], np.asarray(want)[real],
                  TOL[dname], name)
            assert not got[torch.as_tensor(~real)].any()
            # B4 on the reference's zero-padded BCSR rows, and on the whole
            # cotangent with a row offset: the same numbers.
            nblocks = fr.bcsr_part.nblocks
            dy_b = dy[..., r_b:, :]
            pad = [(0, 0)] * (dy.ndim - 2) + [(0, nblocks * br
                                                - dy_b.shape[-2]), (0, 0)]
            dy_pad = np.pad(dy_b, pad)
            want = bcsr_sdd_panels_pallas(
                jnp.asarray(bp.panel_rows), jnp.asarray(bp.panel_cols),
                jnp.asarray(dy_pad), jnp.asarray(b), br=br, interpret=True)
            real = bp.panel_mask != 0
            args = (to_torch(bp.panel_rows), to_torch(bp.panel_cols),
                    to_torch(bp.panel_mask) != 0)
            padded = spmm_sdd.bcsr_sdd_panels(*args, torch.as_tensor(dy_pad),
                                              to_torch(b), br=br)
            offset = spmm_sdd.bcsr_sdd_panels(*args, torch.as_tensor(dy),
                                              to_torch(b), br=br,
                                              row_offset=r_b, nrows=m - r_b)
            assert torch.equal(padded, offset)
            close(offset.permute(0, 2, 1)[torch.as_tensor(real)],
                  np.asarray(want).transpose(0, 2, 1)[real], TOL[dname],
                  name)
            assert not offset.permute(0, 2, 1)[torch.as_tensor(~real)].any()


@pytest.mark.parametrize("batch", [(), (3,)])
def test_loops_sdd_matches_reference(rng, batch):
    """``engine.loops_sdd`` on both port backends against the reference's
    ``loops_sdd(backend="jnp")``, including its dispatch notes."""
    a = adversarial_cases(rng)["empty_rows"].astype(np.float32)
    fr, fp = formats(a, "float32", 16, 8, 3)
    b = rng.standard_normal(batch + (a.shape[1], 24)).astype(np.float32)
    dy = rng.standard_normal(batch + (a.shape[0], 24)).astype(np.float32)
    want = rengine.loops_sdd(fr, jnp.asarray(dy), jnp.asarray(b),
                             backend="jnp")
    for backend in ("cuda", "torch"):
        got = engine.loops_sdd(fp, torch.from_numpy(dy), torch.from_numpy(b),
                               backend=backend)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            close(g, w, 1e-5, backend)

    class Rec:
        def __init__(self):
            self.notes = []

        def on_dispatch(self, **f):
            self.notes.append({k: v for k, v in f.items() if k != "backend"})
    rr, tr = Rec(), Rec()
    prev = rengine.set_tracer(rr)
    try:
        rengine.loops_sdd(fr, jnp.asarray(dy), jnp.asarray(b),
                          backend="interpret")
    finally:
        rengine.set_tracer(prev)
    prev = engine.set_tracer(tr)
    try:
        engine.loops_sdd(fp, torch.from_numpy(dy), torch.from_numpy(b))
    finally:
        engine.set_tracer(prev)
    assert tr.notes == rr.notes and len(tr.notes) == 2


# ---------------------------------------------------------------------------
# gradients against jax.grad through backend="jnp"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dname", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("boundary", ["csr", "bcsr", "hybrid"])
def test_grad_b_matches_reference(rng, dname, g, boundary):
    """dB of ``loops_spmm`` (fp32, fp64) and of ``loops_spmm_values``
    (every dtype; the port has no bf16 host format) against the
    reference's autodiff, on pure-CSR, pure-BCSR and hybrid plans."""
    with x64_if(dname):
        m, k, n = 24, 17, 16
        br = 16 if dname == "bfloat16" else 8
        r_b = {"csr": m, "bcsr": 0, "hybrid": br}[boundary]
        a = sparse(rng, m, k, 0.3)
        fr, fp = formats(a, dname, r_b, br, g)
        b = jnp.asarray(rng.standard_normal((k, n)), getattr(jnp, dname))
        dy = rng.standard_normal((m, n)).astype(np.float32)
        tol = TOL[dname]
        for values in ((False, True) if dname != "bfloat16" else (True,)):
            want = ref_grads(fr, b, dy, values=values)[2]
            for backend in ("cuda", "torch"):
                got = port_grads(fp, dname, b, dy, backend,
                                 values=values)[2]
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                close(got, want, tol, f"{backend} values={values}")


@pytest.mark.parametrize("dname", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_value_grads_match_reference(rng, dname, g, batch):
    """``d_csr_vals``, ``d_bcsr_vals`` and ``dB`` of
    ``loops_spmm_values`` on a hybrid plan, summed over batch dims."""
    with x64_if(dname):
        m, k, n = 21, 17, 16
        br = 16 if dname == "bfloat16" else 8
        a = sparse(rng, m, k, 0.3)
        fr, fp = formats(a, dname, br if m > br else m, br, g)
        b = jnp.asarray(rng.standard_normal(batch + (k, n)),
                        getattr(jnp, dname))
        dy = rng.standard_normal(batch + (m, n)).astype(
            np.float64 if dname == "float64" else np.float32)
        want = ref_grads(fr, b, dy, values=True)
        for backend in ("cuda", "torch"):
            got = port_grads(fp, dname, b, dy, backend, values=True)
            for gg, w, what in zip(got, want, ("csr", "bcsr", "b")):
                assert str(gg.dtype).split(".")[-1] == str(w.dtype)
                close(gg, w, TOL[dname], f"{backend} d_{what}")


def test_grad_matches_torch_backend_through_a_nonlinearity(rng):
    m, k, n = 21, 13, 8
    a = sparse(rng, m, k, 0.35).astype(np.float32)
    fr, fp = formats(a, "float32", 8, 8, 1)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = jax.grad(lambda bb: jnp.sum(jnp.tanh(
        rspmm.loops_spmm(fr, bb, backend="jnp"))))(jnp.asarray(b))
    for backend in ("cuda", "torch"):
        bt = torch.tensor(b, requires_grad=True)
        torch.tanh(tspmm.loops_spmm(fp, bt, device="cpu",
                                    backend=backend)).sum().backward()
        close(bt.grad, want, 1e-5, backend)


def test_empty_matrix_and_empty_batch_give_zero_gradients(rng):
    fp = tf.loops_from_csr(tf.csr_from_dense(np.zeros((7, 5), np.float32)),
                           0, 8)
    for backend in ("cuda", "torch"):
        bt = torch.ones((5, 3), requires_grad=True)
        tspmm.loops_spmm(fp, bt, device="cpu", backend=backend).sum() \
            .backward()
        assert torch.equal(bt.grad, torch.zeros_like(bt))
    a = adversarial_cases(rng)["indivisible"].astype(np.float32)
    fp = tf.loops_from_csr(tf.csr_from_dense(a), 4, 4)
    cv = torch.tensor(fp.csr_part.vals, requires_grad=True)
    bv = torch.tensor(fp.bcsr_part.tile_vals, requires_grad=True)
    bt = torch.ones((0, a.shape[1], 6), requires_grad=True)
    y = tspmm.loops_spmm_values(fp, cv, bv, bt, device="cpu")
    assert y.shape == (0, a.shape[0], 6)
    grads = torch.autograd.grad(y.sum(), [cv, bv, bt])
    assert all(g.shape == t.shape and not g.any()
               for g, t in zip(grads, (cv, bv, bt)))


def test_all_zero_start_still_trains(rng):
    """``loops_spmm_values`` never consults the format's (initial) values:
    an all-zero start gets the gradient of ``dY @ Bᵀ``."""
    a = adversarial_cases(rng)["indivisible"].astype(np.float32)
    fp = tf.loops_from_csr(tf.csr_from_dense(a), 4, 4)
    cv = torch.zeros(fp.csr_part.vals.shape, requires_grad=True)
    bv = torch.zeros(fp.bcsr_part.tile_vals.shape, requires_grad=True)
    b = torch.tensor(rng.standard_normal((a.shape[1], 6)).astype(np.float32))
    y = tspmm.loops_spmm_values(fp, cv, bv, b, device="cpu")
    assert not y.any()
    d_cv, _ = torch.autograd.grad(y.sum(), [cv, bv])
    dw = np.ones((a.shape[0], 6), np.float32) @ b.numpy().T
    close(d_cv, dw[fp.csr_part.row_ids, fp.csr_part.col_idx], 1e-5)


def test_transposed_format_is_built_once_across_backwards(rng, monkeypatch):
    a = sparse(rng, 24, 16, 0.3).astype(np.float32)
    fp, _ = tspmm.plan_and_convert(tf.csr_from_dense(a), total_workers=4,
                                   device="cpu")
    calls = {"n": 0}
    real = tf._build_transposed

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(tf, "_build_transposed", counting)
    b = torch.tensor(rng.standard_normal((16, 8)).astype(np.float32),
                     requires_grad=True)
    grads = []
    for _ in range(2):
        (tspmm.loops_spmm(fp, b, device="cpu") ** 2).sum().backward()
        grads.append(b.grad.clone())
        b.grad = None
    assert calls["n"] == 1
    assert fp.transposed() is fp.transposed()
    tl = fp.transposed()
    assert tl.fmt.on("cpu") is tl.fmt.on("cpu")
    assert tl.maps_on("cpu") is tl.maps_on("cpu")
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------------------
# the §4.5 GCN trained in both packages
# ---------------------------------------------------------------------------

def test_gcn_training_follows_the_reference():
    """Five SGD steps of the GCN of ``examples/gcn_train.py`` (small
    widths) on the port's kernel path and on the reference's ``jnp`` path,
    from the same start: the same loss at every step, and the step-1
    gradients agree."""
    rng = np.random.default_rng(0)
    nodes, f_in, f_hid, f_out, lr = 256, 8, 16, 4, 5.0
    adj_r = rsuite.gcn_graph(nodes, 4, seed=0)
    fr, plan = rspmm.plan_and_convert(adj_r, total_workers=8)
    fp, _ = tspmm.plan_and_convert(tsuite.gcn_graph(nodes, 4, seed=0),
                                   total_workers=8, device="cpu")
    assert 0 < plan.r_boundary < nodes, "the scenario must be hybrid"
    x = rng.standard_normal((nodes, f_in)).astype(np.float32)
    # planted labels, as the example makes them
    w_true = rng.standard_normal((f_in, f_out))
    y = np.argmax(rf.csr_to_dense(adj_r) @ (x @ w_true), axis=1).astype(
        np.int32)
    params = {"w0": (rng.standard_normal((f_in, f_hid)) * 0.1).astype(
                  np.float32),
              "w1": (rng.standard_normal((f_hid, f_out)) * 0.1).astype(
                  np.float32)}

    def loss_fn(p):
        def agg(h):
            return rspmm.loops_spmm(fr, h, backend="jnp")
        logits = agg(jax.nn.relu(agg(jnp.asarray(x) @ p["w0"])) @ p["w1"])
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(y)[:, None],
                                   axis=-1)[:, 0]
        return jnp.mean(logz - gold)

    model = GCN(fp, **gcn_params_from_numpy(params, device="cpu"))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    for step in range(5):
        loss_r, g_r = jax.value_and_grad(loss_fn)(p)
        if step == 0:
            loss_t, _ = gcn_loss(model, xt, yt)
            g_t = torch.autograd.grad(loss_t, [model.w0, model.w1])
            for gt, name in zip(g_t, ("w0", "w1")):
                close(gt, g_r[name], 1e-5, name)
        loss_t, _ = sgd_step(model, xt, yt, lr)
        np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=1e-5,
                                   err_msg=f"step {step}")
        p = jax.tree.map(lambda w, gw: w - lr * gw, p, g_r)
    assert float(loss_t) < float(loss_fn({k: jnp.asarray(v) for k, v in
                                          params.items()}))
