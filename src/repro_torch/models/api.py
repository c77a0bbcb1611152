"""Family-dispatching model API (port of ``repro/models/api.py``).

Every architecture exposes the same entry points regardless of family:

    init_params(cfg, generator, device=)       -> params (an nn.Module)
    train_loss(cfg, params, batch)             -> (loss, aux)
    prefill(cfg, params, batch, cache=)        -> (cache, last_logits)
    decode_step(cfg, params, cache, tok, len)  -> (cache, logits)
        (``len``: an int, or a 0-d int32/int64 tensor on the device)
    init_cache(cfg, batch, max_len)            -> cache dict
    num_params(params)                         -> int
    shard_params(cfg, full, mesh, device=)     -> this rank's params

``batch`` for ``train_loss``: ``{tokens (B, S), labels (B, S)}`` integer
tensors (or arrays) with -1 = masked label; ``aux`` is ``{"tokens":
n_unmasked}``.  The port runs the dense, moe and ssm families
(:mod:`.transformer`, :mod:`.moe`, :mod:`.rwkv6`); every other family
raises ``NotImplementedError`` (ROADMAP A.13).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import transformer

__all__ = ["init_params", "train_loss", "prefill", "decode_step",
           "init_cache", "num_params", "shard_params"]


def _mod(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return transformer


def init_params(cfg: ModelConfig, generator, *, device=None):
    return _mod(cfg).init_params(cfg, generator, device=device)


def train_loss(cfg: ModelConfig, params, batch, *, backend=None):
    return _mod(cfg).train_loss(cfg, params, batch, backend=backend)


def prefill(cfg: ModelConfig, params, batch, *, backend=None, cache=None,
            rows=None):
    return _mod(cfg).prefill(cfg, params, batch, backend=backend,
                             cache=cache, rows=rows)


def decode_step(cfg: ModelConfig, params, cache, tokens, length, *,
                rows=None, backend=None):
    return _mod(cfg).decode_step(cfg, params, cache, tokens, length,
                                 rows=rows, backend=backend)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                device=device)


def num_params(params) -> int:
    return transformer.num_params(params)


def shard_params(cfg: ModelConfig, full, mesh, *, device=None):
    return _mod(cfg).shard_params(cfg, full, mesh, device=device)
