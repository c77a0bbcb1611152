"""Step functions of the port (port of ``repro/dist``): the
grad-accumulating train step, and the serving path's prefill and decode
over static buffers, captured as CUDA graphs on the card (:mod:`.step`).
Sharding and the distributed operator are ROADMAP A.12 / A.13."""
from .step import (build_prefill, build_serve_step, build_train_step,
                   default_microbatches)

__all__ = ["build_prefill", "build_serve_step", "build_train_step",
           "default_microbatches"]
