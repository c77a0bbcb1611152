"""The launchers' ``--layers N`` (``launch/serve.py``, ``launch/train.py``):
the config's first N layers at full width, the rest of the run unchanged.
``chip_smoke.py``'s phase 17 runs llama3.2-1b at 4 of its 16 layers with
it.  On the CPU at the reduced size: the model built has N blocks, a
request is served and a step taken, and an N at or past the config's
depth leaves the config whole."""
import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import api


@pytest.mark.parametrize("layers,want", [(1, 1), (2, 2), (5, 2)])
def test_serve_builds_the_first_layers(monkeypatch, tmp_path, layers, want):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    q = launch_serve.main([
        "--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
        "--layers", str(layers), "--batch", "2", "--prompt-len", "8",
        "--gen-len", "3"])
    assert q.cfg.num_layers == len(q.params.layers) == want
    assert all(len(r.tokens) == 3 for r in q.completed)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-3b"])
def test_serve_without_layers_keeps_the_config(monkeypatch, tmp_path, arch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    q = launch_serve.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--batch", "1",
        "--prompt-len", "4", "--gen-len", "2"])
    assert len(q.params.layers) == q.cfg.num_layers == 2


def test_train_builds_the_first_layers(monkeypatch, tmp_path):
    built = []
    real = api.init_params

    def spy(cfg, gen, **kw):
        params = real(cfg, gen, **kw)
        built.append((cfg.num_layers, len(params.layers)))
        return params
    monkeypatch.setattr(launch_train.api, "init_params", spy)
    rec = launch_train.main([
        "--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
        "--layers", "1", "--steps", "1", "--seq-len", "16",
        "--global-batch", "4", "--ckpt-dir", str(tmp_path / "ck"),
        "--no-final-ckpt"])
    assert built == [(1, 1)]
    assert len(rec["steps"]) == 1
    assert torch.isfinite(torch.tensor(rec["steps"][0]["loss"]))
