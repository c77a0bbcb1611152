"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU at the reduced llama config: a 5-step run and its ``--resume``
(heartbeat file, the restore's NaN/Inf check), ``--obs`` captures,
``REPRO_FAULT_PLAN`` and the mesh flags (spawned gloo ranks); and the
port's sparse-FFN LM example (``examples/train_lm_torch.py``) against the
reference's ``examples/train_lm.py`` on the same numpy parameters and
tokens."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.checkpoint import latest_step
from repro_torch.launch import train as train_cli
from repro_torch.resilience import SparseInputError, inject

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _args(ckpt_dir, *extra):
    return ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
            "--ckpt-dir", str(ckpt_dir), *extra]


def test_cli_runs_and_resumes(tmp_path, capsys):
    """5 steps as the CLI in a process of its own, then ``--resume`` to
    step 7 in-process: the heartbeat holds the last step, the resume starts
    at the final checkpoint (5) and writes its own (7), the losses stay
    finite and the step count and lr follow the schedule of ``--steps``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_args(tmp_path, "--steps", "5", "--ckpt-every", "2")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "trained 5 steps" in proc.stdout
    assert open(tmp_path / "heartbeat").read() == "4"
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith("ckpt_")) == [
        "ckpt_0000000002.tensors", "ckpt_0000000004.tensors",
        "ckpt_0000000005.tensors"]
    rec = train_cli.main(_args(tmp_path, "--steps", "7", "--resume"))
    out = capsys.readouterr().out
    assert "[resume] step 5" in out and "'final': True" in out
    assert rec["start_step"] == 5 and [s["step"] for s in rec["steps"]] == \
        [5, 6]
    assert open(tmp_path / "heartbeat").read() == "6"
    assert latest_step(str(tmp_path)) == 7
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
               for s in rec["steps"])
    assert rec["steps"][-1]["lr"] == pytest.approx(3e-4 * 0.1, rel=1e-5)


def test_resume_refuses_nonfinite_params(tmp_path):
    """A checkpoint whose parameters hold a NaN fails ``--resume`` at the
    restore (``check_finite_tree``), before any step runs."""
    train_cli.main(_args(tmp_path, "--steps", "2", "--ckpt-every", "0"))
    path = ck._ckpt_path(str(tmp_path), 2)
    header, arrays = ck._read(path)
    arrays["params/final_norm.scale"][3] = float("nan")
    tree = {}
    for key, t in arrays.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    ck.save(str(tmp_path), 2, tree, meta=header["meta"])
    with pytest.raises(SparseInputError) as e:
        train_cli.main(_args(tmp_path, "--steps", "3", "--resume"))
    assert e.value.kind == "nonfinite-value"
    assert open(tmp_path / "heartbeat").read() == "1"


def test_obs_capture(tmp_path):
    """``--obs`` writes the JSONL and Chrome trace; the capture counts the
    steps (``train.steps``), has the steps/s gauge and one
    ``step.wall_us{op=train_step}`` observation a step."""
    rec = train_cli.main(_args(tmp_path / "ck", "--steps", "3", "--obs",
                               "tr", "--obs-dir", str(tmp_path / "obs")))
    jsonl, chrome = (pathlib.Path(p) for p in rec["obs"])
    assert jsonl == tmp_path / "obs" / "tr.jsonl" and chrome.exists()
    recs = [json.loads(line) for line in open(jsonl)]
    by = {(r["kind"], r.get("metric")): r for r in recs}
    assert by[("counter", "train.steps")]["value"] == 3
    assert by[("gauge", "train.steps_per_s")]["value"] > 0
    hist = [r for r in recs if r["kind"] == "hist"
            and r["metric"] == "step.wall_us"]
    assert len(hist) == 1 and hist[0]["labels"] == {"op": "train_step"}
    assert hist[0]["count"] == 3
    json.load(open(chrome))


def test_fault_plan_is_installed(tmp_path, monkeypatch):
    """``REPRO_FAULT_PLAN`` is installed at start (as the reference's
    launcher does); the train path passes no fault site, so the run
    completes."""
    monkeypatch.setenv("REPRO_FAULT_PLAN", "serve.step:raise:0")
    try:
        rec = train_cli.main(_args(tmp_path, "--steps", "2"))
        plan = inject.get_plan()
        assert plan is not None and [c.site for c in plan.clauses] == \
            ["serve.step"]
    finally:
        inject.set_plan(None)
    assert len(rec["steps"]) == 2


def test_watchdog_aborts_an_overrunning_step(tmp_path):
    """``--max-step-seconds`` raises once a step overran, after the step
    (its heartbeat not yet written), as the reference's watchdog does."""
    with pytest.raises(TimeoutError, match="step 0 exceeded watchdog"):
        train_cli.main(_args(tmp_path, "--steps", "3",
                             "--max-step-seconds", "1e-9"))
    assert not (tmp_path / "heartbeat").exists()


@pytest.mark.parametrize("flags", [("--mesh-data", "2"),
                                   ("--mesh-model", "2")])
def test_mesh_flags_above_one_raise(tmp_path, flags):
    """The mesh flags above one (which raised before the port trained
    across devices) spawn their ranks, gloo on the CPU: two bf16 steps on a
    (2, 1) and a (1, 2) mesh; rank 0's record carries every rank's.  Step
    0's loss equals the one-device run's within 1e-5 relative.  Step 1's
    within 5e-5: the two runs sum the fp32 gradients in another order, so
    an element near zero can take the other sign, which Adam's first step
    turns into +-lr, and the bf16 parameters round apart; it measured
    1.9e-5 and 2.3e-5 here (the fp32 steps are held to 1e-5 in
    tests/test_torch_mesh.py)."""
    base = ("--steps", "2", "--ckpt-every", "0")
    one = train_cli.main(_args(tmp_path / "one", *base))
    rec = train_cli.main(_args(tmp_path / "mesh", *base, *flags))
    want = [s["loss"] for s in one["steps"]]
    got = [s["loss"] for s in rec["steps"]]
    assert len(got) == 2
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert got[1] == pytest.approx(want[1], rel=5e-5)
    assert rec["mesh"] == ([2, 1] if flags[0] == "--mesh-data" else [1, 2])
    assert [r["rank"] for r in rec["per_rank"]] == [0, 1]
    assert all(r["loss"] == got for r in rec["per_rank"])
    assert latest_step(str(tmp_path / "mesh")) == 2
    assert not [f for f in os.listdir(tmp_path / "mesh")
                if f.startswith(".store")]


def test_mesh_ranks_past_the_time_limit_are_killed(tmp_path):
    """Ranks the launcher spawned that are still running at ``timeout_s``
    are killed, and the run fails; nothing is left behind."""
    import multiprocessing as mp
    with pytest.raises(RuntimeError, match="past the run's limit"):
        train_cli.main(_args(tmp_path, "--steps", "50", "--mesh-data", "2"),
                       timeout_s=0.5)
    assert not mp.active_children()
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".store")]


def test_entry_defaults_to_cuda():
    args = train_cli.build_args(["--arch", "llama3.2-1b"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "llama3.2-1b", "--reduced",
                            "--steps", "1"])


# ---------------------------------------------------------------------------
# the sparse-FFN LM example against the reference's
# ---------------------------------------------------------------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return (_load("ref_train_lm", ROOT / "examples" / "train_lm.py"),
            _load("port_train_lm", ROOT / "examples" / "train_lm_torch.py"))


SIZES = dict(d_model=32, d_ff=64, n_layers=2, vocab=64, sparsity=0.8)


def _both(examples):
    ref, port = examples
    rp, rs = ref.build(*SIZES.values(), np.random.default_rng(0))
    pp, ps = port.build(*SIZES.values(), np.random.default_rng(0),
                        device="cpu")
    return ref, port, rp, rs, pp, ps


def _flat_ref(rp, pp):
    """The reference's leaves in the port's ``leaves`` order (``pp``'s
    keys; the reference's dict comes back key-sorted from jax)."""
    out = []
    for name in pp:
        v = rp[name]
        out.extend(np.asarray(v[k]) for k in sorted(v)) \
            if isinstance(v, dict) else out.append(np.asarray(v))
    return out


def test_example_structures_and_params_match_reference(examples):
    ref, port, rp, rs, pp, ps = _both(examples)
    for (rli, rlo), (pli, plo) in zip(rs, ps):
        for r, p in ((rli, pli), (rlo, plo)):
            assert r.fmt.r_boundary == p.fmt.r_boundary
            assert r.fmt.csr_part.nnz == p.fmt.csr_part.nnz
            assert r.fmt.bcsr_part.ntiles == p.fmt.bcsr_part.ntiles
    for a, b in zip(_flat_ref(rp, pp), port.leaves(pp)):
        np.testing.assert_array_equal(a, b.detach().numpy())


def test_example_forward_and_sgd_step_match_reference(examples):
    """Logits (1e-5 of max(1, max |logits|)) and one SGD step's new
    parameters (1e-5 of each leaf's scale) against the reference's
    ``backend="jnp"`` path, on the same tokens."""
    ref, port, rp, rs, pp, ps = _both(examples)
    rng = np.random.default_rng(1)
    s = rng.integers(0, SIZES["vocab"], (2, 17))
    toks, tgt = s[:, :16], s[:, 1:]
    want = np.asarray(ref.forward(rp, rs, jnp.asarray(toks), 2, "jnp"))
    with torch.no_grad():
        got = port.forward(pp, ps, torch.as_tensor(toks), 2).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale

    def loss(p):
        logits = ref.forward(p, rs, jnp.asarray(toks), 2, "jnp")
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(tgt)[..., None],
                                   axis=-1)[..., 0]
        return jnp.mean(logz - gold)
    lr = 3e-2
    rl, g = jax.value_and_grad(loss)(rp)
    new_rp = jax.tree.map(lambda w, gw: w - lr * gw, rp, g)
    pl = port.sgd_step(pp, ps, torch.as_tensor(toks), torch.as_tensor(tgt),
                       2, lr)
    assert float(pl) == pytest.approx(float(rl), rel=1e-5)
    for a, b in zip(_flat_ref(new_rp, pp), port.leaves(pp)):
        assert b.shape == a.shape
        if a.size:    # a part may hold no values (an empty CSR part)
            scale = max(1.0, float(np.abs(a).max()))
            assert float(np.abs(b.detach().numpy() - a).max()) <= \
                1e-5 * scale


def test_example_learns_on_the_cpu(examples):
    """The example's own run, shortened, on the CPU: it learns and its
    closing check (the default path's logits against the plain path's)
    passes."""
    _, port = examples
    rec = port.main(["--device", "cpu", "--steps", "25", "--d-model", "64",
                     "--d-ff", "64", "--vocab", "64", "--seq", "32",
                     "--batch", "4"])
    assert rec["losses"][-1] < rec["losses"][0]
    assert rec["logits_max_abs_err"] <= 1e-3
