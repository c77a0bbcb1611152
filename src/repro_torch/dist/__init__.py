"""Step functions of the port (port of ``repro/dist``): the serving path's
prefill and decode over static buffers, captured as CUDA graphs on the
card (:mod:`.step`).  Sharding and the distributed operator are ROADMAP
A.12."""
from .step import build_prefill, build_serve_step

__all__ = ["build_prefill", "build_serve_step"]
