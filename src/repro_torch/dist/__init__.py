"""Step functions and the mesh layer of the port (port of ``repro/dist``):
the grad-accumulating train step (ZeRO-1 on a mesh), the serving path's
prefill and decode (over static buffers, captured as CUDA graphs on one
card; eager on a mesh), and the LOOPS operator's cotangent reduction
(:mod:`.step`); the placements of the LM and of the distributed LOOPS
operator over a device mesh (:mod:`.sharding`); the compressed all-reduce
(:mod:`.compress`)."""
from .compress import compressed_psum
from .step import (build_prefill, build_serve_step, build_train_step,
                   default_microbatches, loops_cotangent_psum)

__all__ = ["build_prefill", "build_serve_step", "build_train_step",
           "compressed_psum", "default_microbatches", "loops_cotangent_psum"]
