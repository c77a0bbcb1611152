"""The port's checkpoints (``repro_torch.checkpoint``): the six cases of
tests/test_checkpoint.py on torch trees, the format read back with numpy
alone, the restore-time NaN/Inf check against the reference's
``check_finite_tree``, a training run resumed from a checkpoint that
equals the uninterrupted run bit for bit on the CPU, and the two pieces a
mesh uses: the memory-mapped restore and a save that gathers each leaf
(``tests/test_torch_mesh.py`` runs them across ranks)."""
import json
import os
import struct

import numpy as np
import pytest
import torch

from repro.resilience.validate import SparseInputError as RefSparseInputError
from repro.resilience.validate import check_finite_tree as ref_check
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.launch import train as train_cli
from repro_torch.resilience import SparseInputError, check_finite_tree


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(rng.standard_normal((4, 8)),
                                         dtype=torch.bfloat16),
                       "b": torch.tensor(rng.standard_normal(8),
                                         dtype=torch.float32)},
            "opt": {"m": torch.zeros((3,), dtype=torch.float32),
                    "count": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    return [leaf for _, leaf in ck._leaves(tree)]


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save(str(tmp_path), 42, tree, meta={"arch": "x"})
    step, restored, meta = restore(str(tmp_path), tree)
    assert step == 42 and meta["arch"] == "x"
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, tree, keep=3)
    assert latest_step(str(tmp_path)) == 5
    kept = [f for f in os.listdir(tmp_path) if f.startswith("ckpt_")]
    assert len(kept) == 3


def test_no_partial_files_after_save(tmp_path):
    save(str(tmp_path), 9, _tree())
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp.")]


def test_async_checkpointer(tmp_path):
    ck_ = Checkpointer(str(tmp_path), keep=2)
    tree = _tree(1)
    for s in (10, 20):
        ck_.save_async(s, tree, meta={"s": s})
    ck_.close()
    assert latest_step(str(tmp_path)) == 20
    step, restored, meta = restore(str(tmp_path), tree)
    assert meta["s"] == 20
    assert [t["step"] for t in ck_.timings] == [10, 20]
    assert all(t["handoff_s"] >= 0 and t["write_s"] >= 0
               for t in ck_.timings)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "nope"), _tree())


def test_elastic_restore_shape_independent(tmp_path):
    """A checkpoint restores into any placement: its arrays are unsharded
    CPU tensors, so only the tree structure must match; the caller moves
    them where it wants."""
    tree = _tree(2)
    save(str(tmp_path), 1, tree)
    _, restored, _ = restore(str(tmp_path), tree)
    placed = {k: {n: t.to("cpu", copy=True) for n, t in v.items()}
              for k, v in restored.items()}
    for a, b in zip(_leaves(tree), _leaves(placed)):
        assert torch.equal(a, b)


def test_async_hand_off_copies_before_in_place_updates(tmp_path):
    """``save_async`` copies the tree on the caller's thread: an in-place
    update right after it does not reach the checkpoint."""
    tree = _tree(3)
    want = {k: v.clone() for k, v in tree["params"].items()}
    ck_ = Checkpointer(str(tmp_path))
    ck_.save_async(1, tree)
    tree["params"]["b"].add_(1.0)
    ck_.close()
    _, restored, _ = restore(str(tmp_path), tree)
    for k, v in want.items():
        assert torch.equal(restored["params"][k], v)


def test_async_saves_reuse_the_checkpointers_buffers(tmp_path):
    """A save whose write has ended gives its host buffers back: the next
    save copies into the same tensors, and each checkpoint still holds its
    own step's values."""
    tree = _tree(4)
    want = [{k: v.clone() for k, v in tree["params"].items()}]
    ck_ = Checkpointer(str(tmp_path), keep=2)
    ck_.save_async(1, tree)
    ck_.wait()
    first = {k: v.data_ptr() for k, v in ck_._free[0].items()}
    tree["params"]["w"].mul_(2.0)
    tree["params"]["b"].add_(1.0)
    want.append({k: v.clone() for k, v in tree["params"].items()})
    ck_.save_async(2, tree)
    ck_.wait()
    assert len(ck_._free) == 1
    assert {k: v.data_ptr() for k, v in ck_._free[0].items()} == first
    ck_.close()
    for step, w in zip((1, 2), want):
        _, restored, _ = restore(str(tmp_path), tree, step=step)
        for k, v in w.items():
            assert torch.equal(restored["params"][k], v), (step, k)


def test_format_reads_with_numpy_alone(tmp_path):
    """The file is the magic, a uint64 header length, a JSON header and
    raw bytes: numpy reads every array back (bf16 as its raw uint16)."""
    tree = _tree(4)
    path = save(str(tmp_path), 3, tree, meta={"k": 1})
    raw = open(path, "rb").read()
    assert raw[:16] == ck.MAGIC
    (hlen,) = struct.unpack("<Q", raw[16:24])
    header = json.loads(raw[24:24 + hlen])
    base = 24 + hlen
    assert header["step"] == 3 and header["meta"] == {"k": 1}
    np_dtypes = {"float32": np.float32, "int32": np.int32,
                 "bfloat16": np.uint16}
    for key, leaf in ck._leaves(tree):
        dtype, shape, off, nbytes = header["arrays"][key]
        arr = np.frombuffer(raw[base + off:base + off + nbytes],
                            np_dtypes[dtype]).reshape(shape)
        want = (leaf.view(torch.int16).numpy().view(np.uint16)
                if leaf.dtype == torch.bfloat16 else leaf.numpy())
        np.testing.assert_array_equal(arr, want)


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf")])
def test_check_finite_tree_matches_reference(bad):
    """The port's ``check_finite_tree`` raises where the reference's does
    (kind ``nonfinite-value``) and counts the same leaves."""
    rng = np.random.default_rng(5)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32),
                    "d": np.arange(4, dtype=np.int32)}}
    if bad is not None:
        arrays["b"]["c"][2] = bad
    port = {"a": torch.from_numpy(arrays["a"]).to(torch.bfloat16),
            "b": {"c": torch.from_numpy(arrays["b"]["c"]),
                  "d": torch.from_numpy(arrays["b"]["d"])}}
    if bad is None:
        assert check_finite_tree(port) == ref_check(arrays) == 3
        return
    with pytest.raises(RefSparseInputError) as ref_e:
        ref_check(arrays, what="restored params")
    with pytest.raises(SparseInputError) as e:
        check_finite_tree(port, what="restored params")
    assert e.value.kind == ref_e.value.kind == "nonfinite-value"
    assert "leaf 1 of 3" in str(e.value) and "leaf 1 of 3" in str(ref_e.value)


def _run(tmp_path, *extra):
    return train_cli.main([
        "--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
        "--seq-len", "16", "--global-batch", "8", "--log-every", "100",
        "--seed", "1", *extra])


def test_resume_equals_uninterrupted_run_bit_for_bit(tmp_path):
    """4 straight steps (a checkpoint after step 2) against the same run
    resumed from that checkpoint in a fresh model for steps 3-4: the same
    losses and gradient norms, and the same final parameters and optimizer
    state, bit for bit."""
    straight = _run(tmp_path, "--steps", "4", "--ckpt-every", "2",
                    "--ckpt-dir", str(tmp_path / "a"))
    os.makedirs(tmp_path / "b")
    os.link(tmp_path / "a" / "ckpt_0000000002.tensors",
            tmp_path / "b" / "ckpt_0000000002.tensors")
    resumed = _run(tmp_path, "--steps", "4", "--resume",
                   "--ckpt-dir", str(tmp_path / "b"))
    assert resumed["start_step"] == 2 and len(resumed["steps"]) == 2
    for a, b in zip(straight["steps"][2:], resumed["steps"]):
        assert (a["step"], a["loss"], a["grad_norm"], a["lr"]) == \
            (b["step"], b["loss"], b["grad_norm"], b["lr"])
    tmpl = _template(tmp_path / "a")
    _, fa, _ = restore(str(tmp_path / "a"), tmpl)
    _, fb, _ = restore(str(tmp_path / "b"), tmpl)
    for (ka, a), (kb, b) in zip(ck._leaves(fa), ck._leaves(fb)):
        assert ka == kb and torch.equal(a, b), ka


def _template(directory):
    """A template with every array of the newest checkpoint in
    ``directory``, built from its header."""
    header, _ = ck._read(ck._ckpt_path(str(directory),
                                       latest_step(str(directory))))
    tmpl = {}
    for key in header["arrays"]:
        node = tmpl
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = None
    return tmpl


def test_restore_maps_the_file_copy_on_write(tmp_path):
    """``restore`` maps the file (copy-on-write): the tensors equal the
    saved ones, and writing into one leaves the file alone."""
    tree = _tree(3)
    save(str(tmp_path), 5, tree)
    _, mapped, _ = restore(str(tmp_path), tree)
    for a, b in zip(_leaves(tree), _leaves(mapped)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mapped["params"]["b"][0] = 123.0
    _, again, _ = restore(str(tmp_path), tree)
    assert torch.equal(again["params"]["b"], tree["params"]["b"])


def test_save_gathers_each_leaf_and_a_non_writer_writes_nothing(tmp_path):
    """``save_async(gather=)`` saves what ``gather(path, leaf)`` returns
    for each leaf, in the tree's order; a ``write=False`` checkpointer
    calls the same gathers and writes no file."""
    tree = _tree(4)
    seen = []

    def gather(path, leaf):
        seen.append(path)
        return leaf * 2 if leaf.is_floating_point() else leaf
    ck_w = Checkpointer(str(tmp_path / "w"))
    ck_w.save_async(1, tree, gather=gather)
    ck_w.close()
    paths = [p for p, _ in ck._leaves(tree)]
    assert seen == paths
    _, back, _ = restore(str(tmp_path / "w"), tree)
    assert torch.equal(back["params"]["w"], tree["params"]["w"] * 2)
    assert torch.equal(back["opt"]["count"], tree["opt"]["count"])
    seen.clear()
    ck_r = Checkpointer(str(tmp_path / "r"), write=False)
    ck_r.save_async(1, tree, gather=gather)
    ck_r.close()
    assert seen == paths and latest_step(str(tmp_path / "r")) is None
