"""Step functions and the distributed operator's layer of the port (port of
``repro/dist``): the grad-accumulating train step, the serving path's
prefill and decode over static buffers, captured as CUDA graphs on the
card, and the LOOPS operator's cotangent reduction (:mod:`.step`); the
placements of the distributed LOOPS operator over a device mesh
(:mod:`.sharding`); the compressed all-reduce (:mod:`.compress`).  The
model half of the sharding is ROADMAP A.13."""
from .compress import compressed_psum
from .step import (build_prefill, build_serve_step, build_train_step,
                   default_microbatches, loops_cotangent_psum)

__all__ = ["build_prefill", "build_serve_step", "build_train_step",
           "compressed_psum", "default_microbatches", "loops_cotangent_psum"]
