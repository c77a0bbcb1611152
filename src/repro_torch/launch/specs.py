"""Allocation-free stand-ins of every (arch x shape) cell's inputs.

Port of ``repro/launch/specs.py``.  The reference builds
``ShapeDtypeStruct`` avals (``jax.eval_shape`` over the real init); here
the same inputs are fake tensors (``torch._subclasses.FakeTensorMode``)
or ``meta`` tensors, made by the port's real constructors
(``models/api.py::init_params`` and ``init_cache``), so no weight, batch
or cache is allocated.  Call these inside the ``FakeTensorMode`` that
the trace runs under (``launch/dryrun.py``), or on ``meta``; outside
either a fresh ``FakeTensorMode`` builds them, for reading shapes.

A rank's shards of these come through ``models/api.py::shard_params``
(parameters) and ``dist/step.py::local_cache`` (a decode cache), which
:func:`decode_input_specs` takes a ``mesh`` for.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.engine import _fake_mode_active
from ..models import api

__all__ = ["abstract_params", "train_batch_specs", "prefill_batch_specs",
           "decode_input_specs"]

I32 = torch.int32


def _abstract(device):
    """A fresh ``FakeTensorMode`` unless one is active or ``device`` is
    ``meta`` (which allocates nothing by itself)."""
    if torch.device(device).type == "meta" or _fake_mode_active():
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def abstract_params(cfg: ModelConfig):
    """The full (unsharded) parameters of ``cfg`` as
    ``models/api.py::init_params`` draws them, as fake CPU tensors (the
    generator is a CPU one: a fake run never reads the values);
    ``api.shard_params(cfg, full, mesh, device=)`` takes a rank's shards
    of them onto the traced device."""
    with _abstract("cpu"):
        gen = torch.Generator()
        gen.manual_seed(0)
        return api.init_params(cfg, gen, device="cpu")


def _frontend_extras(cfg: ModelConfig):
    """The reference's frontend inputs (patches, frames): none until their
    families are ported."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend comes with its family "
            "(ROADMAP A.13)")
    return {}


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      n_microbatches: int, *, device="cpu"
                      ) -> Dict[str, Any]:
    """Microbatched layout: (n_mb, mb, ...), int32 tokens and labels."""
    mb = shape.global_batch // n_microbatches
    lead = (n_microbatches, mb)
    with _abstract(device):
        batch = {"tokens": torch.empty((*lead, shape.seq_len), dtype=I32,
                                       device=device),
                 "labels": torch.empty((*lead, shape.seq_len), dtype=I32,
                                       device=device)}
        batch.update(_frontend_extras(cfg))
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                        device="cpu") -> Dict[str, Any]:
    B = shape.global_batch
    with _abstract(device):
        batch = {"tokens": torch.empty((B, shape.seq_len), dtype=I32,
                                       device=device)}
        batch.update(_frontend_extras(cfg))
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                       device="cpu", mesh=None):
    """(cache, tokens, length) for one serve step against a cache of
    ``seq_len`` entries: the whole cache (``init_cache``), or with a
    ``mesh`` the rank's shard of it (``dist/step.py::local_cache``);
    ``tokens`` (B, 1) int32; ``length`` the positions already in the
    cache, ``seq_len - 1`` (a host int: the port's step reads it on the
    host, where the reference's is a traced int32)."""
    B = shape.global_batch
    with _abstract(device):
        if mesh is None:
            cache = api.init_cache(cfg, B, shape.seq_len, device=device)
        else:
            from ..dist.step import local_cache
            cache = local_cache(cfg, mesh, B, shape.seq_len, device=device)
        tokens = torch.empty((B, 1), dtype=I32, device=device)
    return cache, tokens, shape.seq_len - 1
