"""Optimizers of the port (port of ``repro/optim``): AdamW on the flat
ZeRO-1 layout."""
from .adamw import (OptConfig, apply_updates, from_flat, global_norm_flat,
                    init_opt_state, lr_at, to_flat)

__all__ = ["OptConfig", "apply_updates", "from_flat", "global_norm_flat",
           "init_opt_state", "lr_at", "to_flat"]
