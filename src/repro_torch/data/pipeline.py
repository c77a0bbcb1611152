"""Deterministic, shardable, resumable synthetic data pipeline (port of
``repro/data/pipeline.py``).

Every batch is a pure function of ``(seed, step)``: the iterator "state"
is the step counter (stored in the checkpoint), so a restart reproduces
the exact token stream; a host can make its own shard of the global batch
(:func:`host_shard`) without talking to any other.

Tokens follow the reference's Zipfian law (the same inverse CDF on a
uniform draw), laid out ``(n_microbatches, microbatch, seq_len)``; labels
are the next-token shift with the final position masked (-1).

Deliberate divergence: the uniform draw comes from a ``torch.Generator``
on the batch's device, seeded from ``(seed, step)``, not from
``jax.random``, so the two packages draw different tokens from one seed
(and the CPU and the card draw different tokens from each other).  Tests
that hold the port against the reference feed both the reference's batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.engine import resolve_device

__all__ = ["DataConfig", "global_batch_at", "host_shard"]

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_alpha: float = 1.1


def _generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` whose state is a function of ``(seed,
    step)`` alone (numpy's ``SeedSequence`` mixes the pair)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _zipf_tokens(gen: torch.Generator, shape, vocab: int, alpha: float,
                 device) -> torch.Tensor:
    """Zipf via inverse-CDF on a uniform draw in [1e-6, 1) (the
    reference's), ranks past the int32 range saturating, as an int32 cast
    of the reference's float ranks would."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    u = u * (1.0 - 1e-6) + 1e-6
    ranks = torch.pow(u, -1.0 / (alpha - 1.0) if alpha > 1.0 else -1.0)
    ranks = torch.clamp(torch.clamp(ranks, max=2.0 ** 31).to(torch.int64),
                        max=_INT32_MAX)
    return torch.clamp(ranks % vocab, 0, vocab - 1)


def global_batch_at(data: DataConfig, cfg: ModelConfig, shape: ShapeConfig,
                    n_microbatches: int, step: int, *,
                    device=None) -> Dict[str, torch.Tensor]:
    """The full ``(n_mb, mb, seq_len)`` training batch for ``step`` on
    ``device`` (default: CUDA): ``tokens`` and ``labels``, int64."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} batches come with their families "
            "(ROADMAP A.13)")
    dev = resolve_device(device)
    mb = shape.global_batch // n_microbatches
    gen = _generator(data.seed, step, dev)
    seq = _zipf_tokens(gen, (n_microbatches, mb, shape.seq_len + 1),
                       cfg.vocab_size, data.zipf_alpha, dev)
    tokens = seq[..., :-1]
    labels = seq[..., 1:].clone()
    labels[..., -1] = -1
    return {"tokens": tokens.contiguous(), "labels": labels}


def host_shard(batch: Dict[str, torch.Tensor], host_id: int,
               num_hosts: int) -> Dict[str, torch.Tensor]:
    """Slice a host's rows from the global batch (dim 1 = batch)."""
    def leaf(x):
        per = x.shape[1] // num_hosts
        return x[:, host_id * per:(host_id + 1) * per]
    return {k: leaf(v) for k, v in batch.items()}
