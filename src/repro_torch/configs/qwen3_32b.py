"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family scaling]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256,
        qk_norm=True)
