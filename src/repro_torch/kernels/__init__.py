"""LOOPS kernels for Hopper: the CUDA panel kernels B1 (``csr_spmm``) and
B2 (``bcsr_spmm``) with their plain PyTorch versions, the flat references
(``ref``) and the dispatch engine (``engine``)."""
from . import engine, ref
from .bcsr_spmm import bcsr_panels_spmm, bcsr_panels_spmm_plain
from .csr_spmm import csr_panels_spmm, csr_panels_spmm_plain

__all__ = ["engine", "ref", "bcsr_panels_spmm", "bcsr_panels_spmm_plain",
           "csr_panels_spmm", "csr_panels_spmm_plain"]
