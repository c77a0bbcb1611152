"""The port's synthetic training data (port of ``repro/data``)."""
from .pipeline import DataConfig, global_batch_at, host_shard

__all__ = ["DataConfig", "global_batch_at", "host_shard"]
