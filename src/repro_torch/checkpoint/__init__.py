"""Step-atomic, async, topology-independent checkpoints (port of
``repro/checkpoint``)."""
from .checkpoint import Checkpointer, latest_step, restore, save

__all__ = ["Checkpointer", "latest_step", "restore", "save"]
