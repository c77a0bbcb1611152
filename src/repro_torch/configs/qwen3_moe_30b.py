"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768(expert)
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,          # qwen3 uses explicit head_dim 128 (32*128 != 2048)
    d_ff=6144,             # dense fallback width (unused: all layers MoE)
    moe_d_ff=768,
    num_experts=128,
    top_k=8,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    notes="128 routed experts, top-8, no shared expert; qk_norm GQA",
))


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-reduced", family="moe", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        moe_d_ff=32, num_experts=8, top_k=2, vocab_size=256, qk_norm=True)
