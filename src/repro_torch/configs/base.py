"""Model configuration dataclass + the architecture registry.

Port of ``repro/configs/base.py``: the same fields and defaults, with
``dtype`` a ``torch.dtype``, and the same input-shape cells
(:class:`ShapeConfig`, :data:`SHAPES`).  Only the architectures whose family the port
runs are registered (the dense family: qwen3-32b, granite-34b,
llama3.2-1b and internlm2-20b); the other six come with their families
(ROADMAP A.13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register",
           "get_config", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per assigned arch (exact
    literature values) plus reduced variants for smoke tests."""

    name: str
    family: str               # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    # --- attention flavour ---
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    sliding_window: int = 0    # 0 = full attention
    # --- ssm / hybrid ---
    ssm_state: int = 0
    rwkv_head_dim: int = 64
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- frontends ---
    frontend: str = "none"     # none | audio_stub | vision_stub
    num_patches: int = 0
    # --- misc ---
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"        # swiglu | gelu
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    subquadratic: bool = False
    ce_chunk: int = 2048
    capacity_factor: float = 1.25
    attn_schedule: str = "triangular"
    tp_rule: str = "kv_aligned"
    moe_dispatch: str = "gather"
    replicate_attn_input: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def vocab_padded(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered config ``name`` (the package's ``__init__`` imports
    every config module, so the registry is full once ``configs`` is
    imported)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; the port registers "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The assignment's skip rules: long_500k only for sub-quadratic archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return tuple(names)
