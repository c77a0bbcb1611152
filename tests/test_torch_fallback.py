"""The port's engine fallback chains and ``validate_loops`` against the
reference's (``tests/test_resilience.py``'s chain and ``validate_loops``
tests) on the CPU.

The reference's chain is ``pallas → interpret → jnp``; the port's is
``cuda → torch`` (the kernel wrappers, which run their plain versions on
CPU tensors, then the flat references).  The same injected first-link
faults degrade to the same answers with the same ``engine.fallback``
counters, ``disabled()`` re-raises, and ``chain_for`` gives the
reference's chains with the backends renamed.  The port's own rules are
pinned too: the process policy starts disabled whatever the environment,
a chain re-raises while a CUDA graph is being captured, the fused chain's
``torch`` link is the flat product that ``backend="torch"`` runs, and a
degraded call under autograd and ``torch.vmap`` gives the kernel path's
shapes, values and gradients.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import spmm as rspmm
from repro.kernels import engine as rengine
from repro.resilience import fallback as rfallback
from repro.resilience import validate as rvalidate
from repro_torch.core import formats as tf
from repro_torch.core import spmm as tspmm
from repro_torch.kernels import engine
from repro_torch.obs import Obs, set_active
from repro_torch.resilience import fallback, inject, validate
from repro_torch.resilience.inject import FaultPlan, InjectedFault

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The reference's backend names as the port's: the kernels, the oracle.
PORT_NAME = {"pallas": "cuda", "jnp": "torch"}


@pytest.fixture(autouse=True)
def _clean():
    """No fault plan, the port's default policy and no capture leak."""
    yield
    inject.set_plan(None)
    fallback.set_policy(fallback.FallbackPolicy(enabled=False))
    set_active(None)


@pytest.fixture
def chains_on():
    """The chains opted in, with an obs capture to read the counters."""
    fallback.set_policy(fallback.FallbackPolicy())
    obs = Obs(source="t")
    set_active(obs)
    return obs


def random_sparse(rng, m, k, density=0.3, dtype=np.float32):
    a = (rng.random((m, k)) < density) * rng.standard_normal((m, k))
    return a.astype(dtype)


def formats(a, r_boundary, br):
    """The same matrix in both packages' LOOPS format."""
    return (rf.loops_from_csr(rf.csr_from_dense(a), r_boundary, br),
            tf.loops_from_csr(tf.csr_from_dense(a), r_boundary, br))


def counter(obs, name, **labels):
    return sum(inst.value for kind, inst in obs.metrics.instruments()
               if kind == "counter" and inst.name == name
               and all(inst.labels.get(k) == v for k, v in labels.items()))


# ---------------------------------------------------------------------------
# chain_for, the policy and the kill switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part,op", [("csr", "spmm"), ("bcsr", "spmm"),
                                     ("loops", "sdd"), ("fused", "spmm")])
@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_chain_for_gives_the_reference_answers(part, op, backend):
    """The reference's chain from each of its backends, its ``interpret``
    link dropped and the rest renamed, is the port's.  The reference's
    fused chain ends at ``interpret`` and then runs the parts path, whose
    chains end at ``jnp``: the port's fused chain ends at the flat
    product, ``torch``."""
    want = rfallback.FallbackPolicy().chain_for(part, op, backend)
    if want[-1] == "interpret":
        want = want + ("jnp",)
    want = tuple(PORT_NAME[b] for b in want if b != "interpret")
    got = fallback.FallbackPolicy().chain_for(part, op, PORT_NAME[backend])
    assert got == want
    assert fallback.FallbackPolicy(enabled=False).chain_for(
        part, op, PORT_NAME[backend]) == (PORT_NAME[backend],) == \
        tuple(PORT_NAME[b] for b in rfallback.FallbackPolicy(
            enabled=False).chain_for(part, op, backend))


def test_chain_constants_and_exports():
    assert fallback.DEFAULT_CHAIN == ("cuda", "torch")
    assert fallback.CHAIN_OVERRIDES == {}
    assert fallback.FallbackPolicy().enabled is True
    import repro_torch.resilience as res
    for name in ("DEFAULT_CHAIN", "CHAIN_OVERRIDES", "FallbackPolicy",
                 "get_policy", "set_policy", "disabled", "run_chain",
                 "validate_loops"):
        assert getattr(res, name) is not None, name


@pytest.mark.parametrize("env", [{}, {"REPRO_NO_FALLBACK": "0"},
                                 {"REPRO_NO_FALLBACK": ""},
                                 {"REPRO_NO_FALLBACK": "1"}])
def test_process_policy_starts_disabled_whatever_the_environment(env):
    """Divergence: the reference's process policy starts enabled unless
    ``REPRO_NO_FALLBACK`` is set; the port's starts disabled and reads no
    environment variable."""
    full = {k: v for k, v in os.environ.items() if k != "REPRO_NO_FALLBACK"}
    full.update(env, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.resilience import "
         "get_policy; p = get_policy(); print(p.enabled, p.chain_for("
         "'csr', 'spmm', 'cuda'))"],
        env=full, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "('cuda',)"]


def test_default_policy_raises_the_injected_fault(rng):
    """With the policy a process starts with, an injected first-link fault
    raises out of ``loops_spmm`` and of each engine entry point."""
    _, fmt = formats(random_sparse(rng, 32, 24), 16, 4)
    b = torch.as_tensor(rng.standard_normal((24, 8)).astype(np.float32))
    assert fallback.get_policy().enabled is False
    inject.set_plan(FaultPlan.parse("engine.*.cuda:raise:0:0"))
    dev = fmt.on("cpu")
    for call in (lambda: tspmm.loops_spmm(fmt, b, device="cpu"),
                 lambda: engine.csr_spmm(fmt.csr_part, b, panels=dev.csr),
                 lambda: engine.bcsr_spmm(fmt.bcsr_part, b, panels=dev.bcsr),
                 lambda: engine.loops_sdd(fmt, torch.ones(32, 8), b)):
        with pytest.raises(InjectedFault):
            call()


def test_kill_switch_propagates_the_failure(rng, chains_on):
    a = random_sparse(rng, 16, 12)
    ref_fmt, fmt = formats(a, 16, 4)                   # pure CSR part
    b = rng.standard_normal((12, 4)).astype(np.float32)
    inject.set_plan(FaultPlan.parse("engine.csr.spmm.cuda:raise:0:0"))
    panels = fmt.on("cpu").csr
    with fallback.disabled():
        with pytest.raises(InjectedFault):
            engine.csr_spmm(fmt.csr_part, torch.as_tensor(b), panels=panels)
    assert fallback.get_policy().enabled is True       # restored
    # same plan, chains enabled: degrades instead
    inject.get_plan().reset()
    want = np.asarray(rspmm.loops_spmm(ref_fmt, jnp.asarray(b),
                                       backend="jnp"))
    got = engine.csr_spmm(fmt.csr_part, torch.as_tensor(b), panels=panels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert counter(chains_on, "engine.fallback", part="csr") == 1


# ---------------------------------------------------------------------------
# injected kernel faults degrade to the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["csr", "bcsr"])
def test_part_falls_back_to_oracle(rng, chains_on, part):
    """``engine.{part}.spmm.cuda`` fails: the part's product comes from
    its flat reference, equal to the reference's ``jnp`` path, with one
    ``engine.fallback`` count."""
    a = random_sparse(rng, 32, 24)
    ref_fmt, fmt = formats(a, 32 if part == "csr" else 0, 4)
    b = rng.standard_normal((24, 8)).astype(np.float32)
    want = np.asarray(rspmm.loops_spmm(ref_fmt, jnp.asarray(b),
                                       backend="jnp"))
    inject.set_plan(FaultPlan.parse(f"engine.{part}.spmm.cuda:raise:0:0"))
    dev = fmt.on("cpu")
    if part == "csr":
        got = engine.csr_spmm(fmt.csr_part, torch.as_tensor(b),
                              panels=dev.csr)
    else:
        got = engine.bcsr_spmm(fmt.bcsr_part, torch.as_tensor(b),
                               panels=dev.bcsr)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert counter(chains_on, "engine.fallback", part=part, op="spmm",
                   reason="injected") == 1
    assert counter(chains_on, "inject.fired") >= 1


def test_fused_degrades_to_the_flat_product(rng, chains_on):
    """The fused chain's ``torch`` link is the flat product: the degraded
    ``loops_spmm`` equals the reference's ``jnp`` path and, bit for bit,
    ``loops_spmm(backend="torch")``; no part chain degraded."""
    a = random_sparse(rng, 32, 24)
    ref_fmt, fmt = formats(a, 16, 4)
    assert 0 < fmt.r_boundary < fmt.nrows
    b = rng.standard_normal((24, 8)).astype(np.float32)
    want = np.asarray(rspmm.loops_spmm(ref_fmt, jnp.asarray(b),
                                       backend="jnp"))
    flat = tspmm.loops_spmm(fmt, torch.as_tensor(b), device="cpu",
                            backend="torch")
    inject.set_plan(FaultPlan.parse("engine.fused.spmm.cuda:raise:0:0"))
    got = tspmm.loops_spmm(fmt, torch.as_tensor(b), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got, flat)
    assert counter(chains_on, "engine.fallback", part="fused",
                   op="spmm") == 1
    assert counter(chains_on, "engine.fallback", part="csr") == 0
    assert counter(chains_on, "engine.fallback", part="bcsr") == 0


def test_sdd_falls_back_to_oracle(rng, chains_on):
    a = random_sparse(rng, 16, 12)
    ref_fmt, fmt = formats(a, 8, 4)
    dy = rng.standard_normal((16, 4)).astype(np.float32)
    b = rng.standard_normal((12, 4)).astype(np.float32)
    want = rengine.loops_sdd(ref_fmt, jnp.asarray(dy), jnp.asarray(b),
                             backend="jnp")
    inject.set_plan(FaultPlan.parse("engine.loops.sdd.cuda:raise:0:0"))
    got = engine.loops_sdd(fmt, torch.as_tensor(dy), torch.as_tensor(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert counter(chains_on, "engine.fallback", part="loops",
                   op="sdd") == 1


def test_a_raising_kernel_degrades_with_its_error_type(rng, chains_on,
                                                       monkeypatch):
    """A failure that is not injected (a wrapper's check, a build error)
    degrades the same way, counted under its exception type."""
    _, fmt = formats(random_sparse(rng, 32, 24), 16, 4)
    b = torch.as_tensor(rng.standard_normal((24, 8)).astype(np.float32))
    flat = tspmm.loops_spmm(fmt, b, device="cpu", backend="torch")
    real = engine.get_kernel

    def broken(part, op, impl="panels"):
        if impl == "panels":
            raise OSError("the extension did not build")
        return real(part, op, impl)
    monkeypatch.setattr(engine, "get_kernel", broken)
    assert torch.equal(tspmm.loops_spmm(fmt, b, device="cpu"), flat)
    assert counter(chains_on, "engine.fallback", part="fused",
                   reason="OSError") == 1


def test_exhausted_chain_raises_the_last_failure(rng, chains_on):
    _, fmt = formats(random_sparse(rng, 32, 24), 16, 4)
    b = torch.as_tensor(rng.standard_normal((24, 8)).astype(np.float32))
    inject.set_plan(FaultPlan.parse("engine.fused.spmm.*:raise:0:0"))
    with pytest.raises(InjectedFault) as err:
        tspmm.loops_spmm(fmt, b, device="cpu")
    assert "engine.fused.spmm.torch" in str(err.value)
    assert counter(chains_on, "engine.fallback", part="fused") == 1


@pytest.mark.parametrize("site", ["engine.fused.spmm.cuda",
                                  "engine.csr.spmm.cuda"])
def test_chain_reraises_while_a_graph_is_captured(rng, chains_on,
                                                  monkeypatch, site):
    """While the current CUDA stream is being captured, an opted-in chain
    re-raises instead of degrading: no plain version is baked into a graph
    in the kernel's place."""
    _, fmt = formats(random_sparse(rng, 32, 24), 16, 4)
    b = torch.as_tensor(rng.standard_normal((24, 8)).astype(np.float32))
    inject.set_plan(FaultPlan.parse(f"{site}:raise:0:0"))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(InjectedFault):
        if site.startswith("engine.fused"):
            tspmm.loops_spmm(fmt, b, device="cpu")
        else:
            engine.csr_spmm(fmt.csr_part, b, panels=fmt.on("cpu").csr)
    assert counter(chains_on, "engine.fallback") == 0
    # the capture over, the same fault degrades
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    inject.get_plan().reset()
    tspmm.loops_spmm(fmt, b, device="cpu")
    engine.csr_spmm(fmt.csr_part, b, panels=fmt.on("cpu").csr)
    assert counter(chains_on, "engine.fallback") == 1


def test_no_capture_check_without_cuda():
    """A process that has not initialised CUDA is never capturing (the
    CPU build's ``is_current_stream_capturing`` would raise)."""
    assert not torch.cuda.is_initialized()
    assert fallback._capturing() is False


# ---------------------------------------------------------------------------
# a degraded call under autograd and torch.vmap
# ---------------------------------------------------------------------------

DEGRADE_ALL = "engine.fused.spmm.cuda:raise:0:0;engine.loops.sdd.cuda:raise:0:0"


def _values_grads(fmt, cv, bv, b, w):
    cv = cv.clone().requires_grad_(True)
    bv = bv.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    y = tspmm.loops_spmm_values(fmt, cv, bv, b, device="cpu")
    loss = (y * w).sum()
    return (y.detach(),) + torch.autograd.grad(loss, (cv, bv, b))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_degraded_autograd_matches_the_kernel_path(rng, chains_on, batch):
    """Every product and value gradient of a ``loops_spmm_values`` step
    degraded (forward, dB on Aᵀ and the SDD): the same shapes, the same
    output and batch-summed value gradients as the kernel path."""
    _, fmt = formats(random_sparse(rng, 32, 24), 16, 4)
    cv = torch.as_tensor(fmt.csr_part.vals)
    bv = torch.as_tensor(fmt.bcsr_part.tile_vals)
    b = torch.as_tensor(rng.standard_normal(batch + (24, 8))
                        .astype(np.float32))
    w = torch.as_tensor(rng.standard_normal(batch + (32, 8))
                        .astype(np.float32))
    want = _values_grads(fmt, cv, bv, b, w)
    inject.set_plan(FaultPlan.parse(DEGRADE_ALL))
    got = _values_grads(fmt, cv, bv, b, w)
    for g, x in zip(got, want):
        assert g.shape == x.shape
        torch.testing.assert_close(g, x, atol=1e-5, rtol=1e-5)
    assert counter(chains_on, "engine.fallback", part="fused") >= 2
    assert counter(chains_on, "engine.fallback", part="loops") == 1


def test_degraded_vmap_matches_the_kernel_path(rng, chains_on):
    """``torch.vmap`` over ``b`` folds into one degraded call: the same
    mapped shapes and values as the kernel path's, and ``vmap(grad)``
    gives each element's gradient."""
    _, fmt = formats(random_sparse(rng, 32, 24), 16, 4)
    b = torch.as_tensor(rng.standard_normal((5, 24, 8)).astype(np.float32))

    def f(x):
        return tspmm.loops_spmm(fmt, x, device="cpu")

    def g(x):
        return torch.func.grad(lambda z: f(z).square().sum())(x)
    want_y, want_g = torch.vmap(f)(b), torch.vmap(g)(b)
    inject.set_plan(FaultPlan.parse(DEGRADE_ALL))
    got_y, got_g = torch.vmap(f)(b), torch.vmap(g)(b)
    assert got_y.shape == want_y.shape == (5, 32, 8)
    torch.testing.assert_close(got_y, want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_g, want_g, atol=1e-5, rtol=1e-5)
    assert counter(chains_on, "engine.fallback", part="fused") >= 2


# ---------------------------------------------------------------------------
# validate_loops
# ---------------------------------------------------------------------------

def _corrupt(fmt, how):
    """``fmt`` (a LOOPS format of either package) with one planted
    defect."""
    bc, cp = fmt.bcsr_part, fmt.csr_part
    rep = dataclasses.replace
    if how == "clean":
        return fmt
    if how == "r_boundary":
        return rep(fmt, r_boundary=fmt.nrows + 1)
    if how == "csr_nan":
        v = cp.vals.copy()
        v[0] = np.nan
        return rep(fmt, csr_part=rep(cp, vals=v))
    if how == "csr_col_oob":
        c = cp.col_idx.copy()
        c[-1] = cp.shape[1]
        return rep(fmt, csr_part=rep(cp, col_idx=c))
    if how == "br_zero":
        return rep(fmt, bcsr_part=rep(bc, br=0))
    if how == "block_ptr":
        p = bc.block_ptr.copy()
        p[1], p[2] = p[2] + 1, p[1]
        return rep(fmt, bcsr_part=rep(bc, block_ptr=p))
    if how == "tile_rows":
        r = bc.tile_rows.copy()
        r[0] = r[-1] + 1
        return rep(fmt, bcsr_part=rep(bc, tile_rows=r))
    if how == "tile_cols_negative":
        c = bc.tile_cols.copy()
        c[0] = -1
        return rep(fmt, bcsr_part=rep(bc, tile_cols=c))
    if how == "tile_cols_oob":
        c = bc.tile_cols.copy()
        c[-1] = bc.shape[1]
        return rep(fmt, bcsr_part=rep(bc, tile_cols=c))
    if how == "tile_vals_shape":
        return rep(fmt, bcsr_part=rep(bc, tile_vals=bc.tile_vals[:, :-1]))
    if how == "tile_vals_nan":
        return rep(fmt, bcsr_part=rep(
            bc, tile_vals=np.full_like(bc.tile_vals, np.nan)))
    raise ValueError(how)


def _verdict(mod, fmt):
    try:
        mod.validate_loops(fmt)
    except mod.SparseInputError as e:
        return e.kind
    return None


@pytest.mark.parametrize("how", [
    "clean", "r_boundary", "csr_nan", "csr_col_oob", "br_zero",
    "block_ptr", "tile_rows", "tile_cols_negative", "tile_cols_oob",
    "tile_vals_shape", "tile_vals_nan"])
def test_validate_loops_gives_the_reference_verdicts(rng, how):
    """Clean and corrupted formats of the same matrix: both packages pass
    or raise the same defect kind."""
    ref_fmt, fmt = formats(random_sparse(rng, 40, 24), 16, 4)
    assert 0 < fmt.r_boundary < fmt.nrows and fmt.bcsr_part.nblocks >= 3
    want = _verdict(rvalidate, _corrupt(ref_fmt, how))
    got = _verdict(validate, _corrupt(fmt, how))
    assert got == want
    assert (got is None) == (how == "clean")


def test_validate_loops_checks_both_parts(rng):
    """The reference test's case: the clean format passes, a NaN BCSR
    tile raises."""
    _, fmt = formats(random_sparse(rng, 16, 12), 8, 4)
    assert validate.validate_loops(fmt).ok
    with pytest.raises(validate.SparseInputError) as err:
        validate.validate_loops(_corrupt(fmt, "tile_vals_nan"))
    assert err.value.kind == "nonfinite-value"
