"""Architecture registry of the port: the architectures whose family the
port runs (the dense family, llama3.2-1b).

``get_config(name)`` / ``--arch <id>`` resolve through here; each module
also provides ``reduced()``, the same family at smoke-test scale.
"""
from .base import SHAPES, ModelConfig, ShapeConfig, get_config, register
from . import llama3_2_1b

ALL_ARCHS = ("llama3.2-1b",)

REDUCED = {
    "llama3.2-1b": llama3_2_1b.reduced,
}

__all__ = ["ALL_ARCHS", "REDUCED", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "register"]
