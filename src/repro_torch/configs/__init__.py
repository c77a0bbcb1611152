"""Architecture registry of the port: the architectures whose family the
port runs (the moe family: qwen3-moe-30b-a3b and qwen2-moe-a2.7b; the
dense family: qwen3-32b, granite-34b, llama3.2-1b and internlm2-20b; the
ssm family: rwkv6-3b, served and trained), in the reference's order.

``get_config(name)`` / ``--arch <id>`` resolve through here; each module
also provides ``reduced()``, the same family at smoke-test scale.
"""
from .base import (SHAPES, ModelConfig, ShapeConfig, applicable_shapes,
                   get_config, register)
from . import (granite_34b, internlm2_20b, llama3_2_1b, qwen2_moe_a2_7b,
               qwen3_32b, qwen3_moe_30b, rwkv6_3b)

ALL_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "qwen3-32b",
             "granite-34b", "llama3.2-1b", "internlm2-20b", "rwkv6-3b")

REDUCED = {
    "qwen3-moe-30b-a3b": qwen3_moe_30b.reduced,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.reduced,
    "qwen3-32b": qwen3_32b.reduced,
    "granite-34b": granite_34b.reduced,
    "llama3.2-1b": llama3_2_1b.reduced,
    "internlm2-20b": internlm2_20b.reduced,
    "rwkv6-3b": rwkv6_3b.reduced,
}

__all__ = ["ALL_ARCHS", "REDUCED", "SHAPES", "ModelConfig", "ShapeConfig",
           "applicable_shapes", "get_config", "register"]
