"""repro_torch.resilience: validated ingestion (the forward path's gate).

Fallback chains and fault injection are not ported: a kernel that fails
to build or launch raises.
"""
from .validate import (DEFECT_KINDS, SparseInputError, ValidationReport,
                       csr_defects, repair_counts, validate_coo,
                       validate_csr)

__all__ = ["DEFECT_KINDS", "SparseInputError", "ValidationReport",
           "csr_defects", "repair_counts", "validate_coo", "validate_csr"]
