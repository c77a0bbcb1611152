"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free, Finch data-dependent
decay) d_ff=8960 vocab=65536; head size 64 -> 40 matrix-state heads.
[arXiv:2404.05892]

Sub-quadratic (O(1) decode state) -> runs the long_500k cell."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # informational; rwkv path uses rwkv_heads
    num_kv_heads=40,
    rwkv_head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    norm="layernorm",
    subquadratic=True,
))


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-reduced", family="ssm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, rwkv_head_dim=16, d_ff=128,
        vocab_size=256, norm="layernorm", subquadratic=True)
