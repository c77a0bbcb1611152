"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch, code model.  [arXiv:2405.04324]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,        # multi-query attention
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=10_000.0,
))


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=1, d_ff=256, vocab_size=256)
