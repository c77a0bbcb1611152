"""Architecture registry of the port: the architectures whose family the
port runs (the dense family: qwen3-32b, granite-34b, llama3.2-1b and
internlm2-20b, in the reference's order).

``get_config(name)`` / ``--arch <id>`` resolve through here; each module
also provides ``reduced()``, the same family at smoke-test scale.
"""
from .base import (SHAPES, ModelConfig, ShapeConfig, applicable_shapes,
                   get_config, register)
from . import granite_34b, internlm2_20b, llama3_2_1b, qwen3_32b

ALL_ARCHS = ("qwen3-32b", "granite-34b", "llama3.2-1b", "internlm2-20b")

REDUCED = {
    "qwen3-32b": qwen3_32b.reduced,
    "granite-34b": granite_34b.reduced,
    "llama3.2-1b": llama3_2_1b.reduced,
    "internlm2-20b": internlm2_20b.reduced,
}

__all__ = ["ALL_ARCHS", "REDUCED", "SHAPES", "ModelConfig", "ShapeConfig",
           "applicable_shapes", "get_config", "register"]
