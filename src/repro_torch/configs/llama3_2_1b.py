"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings.  [hf:meta-llama/Llama-3.2-1B]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    tie_embeddings=True,
))


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=256,
        tie_embeddings=True)
