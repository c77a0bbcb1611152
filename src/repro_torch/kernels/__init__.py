"""Kernels for Hopper: the LOOPS CUDA panel kernels B1 (``csr_spmm``) and
B2 (``bcsr_spmm``) of the forward product, the sampled dense-dense kernels
B3 and B4 (``spmm_sdd``) of the value gradient, the flash-attention
kernel B5 (the module ``flash_attention``) of the LM's prefill, and the
RWKV-6 recurrence (the module ``wkv6``) of the ssm family, each with its
plain PyTorch version, the flat references (``ref``) and the dispatch
engine (``engine``)."""
from . import engine, flash_attention, ref, wkv6
from .bcsr_spmm import bcsr_panels_spmm, bcsr_panels_spmm_plain
from .csr_spmm import csr_panels_spmm, csr_panels_spmm_plain
from .spmm_sdd import (bcsr_sdd_panels, bcsr_sdd_panels_plain,
                       csr_sdd_panels, csr_sdd_panels_plain)

__all__ = ["engine", "flash_attention", "ref", "wkv6", "bcsr_panels_spmm",
           "bcsr_panels_spmm_plain", "csr_panels_spmm",
           "csr_panels_spmm_plain", "bcsr_sdd_panels",
           "bcsr_sdd_panels_plain", "csr_sdd_panels", "csr_sdd_panels_plain"]
