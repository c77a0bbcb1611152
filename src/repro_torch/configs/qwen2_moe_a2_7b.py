"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408(expert)
vocab=151936, 4 shared + 60 routed experts top-4.  [hf:Qwen/Qwen1.5-MoE-A2.7B]

The 60 routed experts pad to 64 for the 16-way EP axis (padded experts carry
zero weights and -inf router logits — inert)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,             # shared-expert width = 4 * 1408
    moe_d_ff=1408,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    notes="4 shared (always-on, sigmoid-gated) + 60 routed top-4",
))


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced", family="moe", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, moe_d_ff=32,
        num_experts=6, num_shared_experts=2, top_k=2, vocab_size=256)
