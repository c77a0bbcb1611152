"""The port's data pipeline (``repro_torch.data``) against the reference's
``repro.data``: the batch layout and label mask, per-step determinism, host
sharding, and the Zipf law.  The port draws from a ``torch.Generator``
seeded from ``(seed, step)`` (a deliberate divergence: ``jax.random``'s
bits are not reproducible), so the two streams are compared by their
token frequencies, not token by token."""
import numpy as np
import pytest
import torch

from repro.configs import REDUCED as REF_REDUCED
from repro.configs.base import ShapeConfig as RefShape
from repro.data import DataConfig as RefData
from repro.data import global_batch_at as ref_batch_at
from repro.data import host_shard as ref_host_shard
from repro_torch.configs import REDUCED, ShapeConfig
from repro_torch.data import DataConfig, global_batch_at, host_shard

ARCH = "llama3.2-1b"


def _batch(step, seed=3, n_mb=2, seq=16, batch=8):
    return global_batch_at(DataConfig(seed=seed), REDUCED[ARCH](),
                           ShapeConfig("t", seq, batch, "train"), n_mb, step,
                           device="cpu")


def test_layout_and_label_mask_match_reference():
    b = _batch(5)
    ref = ref_batch_at(RefData(seed=3), REF_REDUCED[ARCH](),
                       RefShape("t", 16, 8, "train"), 2, 5)
    assert set(b) == set(ref) == {"tokens", "labels"}
    for k in b:
        assert tuple(b[k].shape) == tuple(ref[k].shape) == (2, 4, 16)
        assert b[k].dtype == torch.int64
    assert torch.equal(b["labels"][..., :-1], b["tokens"][..., 1:])
    assert bool((b["labels"][..., -1] == -1).all())
    vocab = REDUCED[ARCH]().vocab_size
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < vocab


@pytest.mark.parametrize("step", [0, 5, 123])
def test_per_step_determinism(step):
    assert torch.equal(_batch(step)["tokens"], _batch(step)["tokens"])
    assert not torch.equal(_batch(step)["tokens"],
                           _batch(step + 1)["tokens"])
    assert not torch.equal(_batch(step)["tokens"],
                           _batch(step, seed=4)["tokens"])


@pytest.mark.parametrize("n_mb", [1, 2, 4])
def test_microbatch_count_only_reshapes_the_layout(n_mb):
    """Each count of microbatches draws the (n_mb, mb, S + 1) stream of the
    same step: shapes follow n_mb, and the step stays deterministic."""
    b = _batch(2, n_mb=n_mb)
    assert tuple(b["tokens"].shape) == (n_mb, 8 // n_mb, 16)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_host_shards_partition_the_batch(hosts):
    b = _batch(5)
    shards = [host_shard(b, h, hosts) for h in range(hosts)]
    recon = torch.cat([s["tokens"] for s in shards], dim=1)
    assert torch.equal(recon, b["tokens"])
    ref = ref_host_shard({k: v.numpy() for k, v in b.items()}, 1 % hosts,
                         hosts)
    for k in b:
        np.testing.assert_array_equal(
            host_shard(b, 1 % hosts, hosts)[k].numpy(), np.asarray(ref[k]))


def test_zipf_frequencies_match_reference():
    """64k tokens from each package: the frequency of each of the 8 most
    common token ids (0-5, and 255, where ranks past the int32 range land)
    within 0.01 of the reference's."""
    shape = ShapeConfig("t", 255, 256, "train")
    got = global_batch_at(DataConfig(seed=0), REDUCED[ARCH](), shape, 1, 0,
                          device="cpu")["tokens"].numpy().ravel()
    ref = np.asarray(ref_batch_at(
        RefData(seed=0), REF_REDUCED[ARCH](), RefShape("t", 255, 256,
                                                       "train"), 1,
        0)["tokens"]).ravel()
    vocab = REDUCED[ARCH]().vocab_size
    fg = np.bincount(got, minlength=vocab) / got.size
    fr = np.bincount(ref, minlength=vocab) / ref.size
    top = np.argsort(-fr)[:8]
    np.testing.assert_allclose(fg[top], fr[top], atol=0.01)
