"""``examples/gcn_train_torch.py`` against the reference's
``examples/gcn_train.py`` on the CPU, each in a process of its own at the
same small size: step 0's loss agrees to 1e-5 and both gradient checks
pass.

The reference prints its losses to four decimals; its process here wraps
``jax.jit`` so the jitted ``step`` also records each step's loss at full
precision.  The port's example prints its readings as JSON on its last
line.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ["--steps", "2", "--nodes", "64", "--degree", "4"]

# Runs the reference example with the jitted step's losses recorded.
REFERENCE = """
import json, runpy, sys
import jax
losses = []
real_jit = jax.jit

def jit(fn, *args, **kwargs):
    compiled = real_jit(fn, *args, **kwargs)
    if getattr(fn, "__name__", "") != "step":
        return compiled

    def step(*a, **k):
        out = compiled(*a, **k)
        losses.append(float(out[1]))
        return out
    return step

jax.jit = jit
sys.argv = ["gcn_train.py"] + sys.argv[1:]
runpy.run_path("examples/gcn_train.py", run_name="__main__")
print("LOSSES " + json.dumps(losses))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(argv):
    out = subprocess.run(argv, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


@pytest.fixture(scope="module")
def reference():
    stdout = _run([sys.executable, "-c", REFERENCE, "--backend", "jnp",
                   *FLAGS])
    losses = json.loads(stdout.rsplit("LOSSES ", 1)[1])
    return stdout, losses


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_step0_loss_and_grad_check_match_the_reference(reference, backend):
    """``--backend torch`` (the flat references) and ``--backend cuda``
    (the kernels' plain versions on the CPU) against the reference's
    ``--backend jnp``."""
    ref_out, ref_losses = reference
    assert "grad check" in ref_out and "OK" in ref_out
    assert len(ref_losses) == 2
    stdout = _run([sys.executable, "examples/gcn_train_torch.py",
                   "--backend", backend, "--device", "cpu", *FLAGS])
    got = json.loads(stdout.strip().splitlines()[-1])
    assert "grad check" in stdout and "OK" in stdout
    assert got["grad_err"] <= 1e-4
    assert got["steps"] == 2 and got["backend"] == backend
    assert abs(got["first_loss"] - ref_losses[0]) <= 1e-5
    # the step lines print the reference's four decimals
    ref_lines = [ln for ln in ref_out.splitlines() if ln.startswith("step")]
    lines = [ln for ln in stdout.splitlines() if ln.startswith("step")]
    assert [ln.split()[:4] for ln in lines] == \
        [ln.split()[:4] for ln in ref_lines]


def test_main_returns_its_readings_and_learns(monkeypatch, tmp_path):
    """``main`` at 40 steps on the CPU: the loss falls below 0.7 of its
    start (the example's own check), and ``--autotune`` plans the second
    layer from the first layer's cached plan."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gcn_train_torch", ROOT / "examples" / "gcn_train_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    got = ex.main(["--device", "cpu", "--backend", "torch", "--steps", "40",
                   "--nodes", "128", "--degree", "4", "--autotune"])
    assert got["last_loss"] < 0.7 * got["first_loss"]
    assert got["cache"]["misses"] == 1 and got["cache"]["hits"] == 1
    assert got["grad_err"] <= 1e-4
