"""repro_torch.resilience: validated ingestion (sparse inputs, and
restored parameter trees), seeded fault injection and the host-side
retry/deadline helper.

Port of ``repro/resilience`` without the engine fallback chains
(``run_chain`` / ``FallbackPolicy``): a kernel that fails to build or
launch raises.  Every degradation the port records (``inject.fired``,
``validate.repaired``, ``tune.cache.quarantined``,
``tune.search.trial_failed``, ``serve.degraded``) lands on the active obs
capture through :func:`note_degraded`.
"""
from .fallback import DeadlineExceeded, classify, retry_with_backoff
from .inject import (FaultClause, FaultPlan, InjectedFault, InjectedTimeout,
                     fault_point, get_plan, install_from_env, note_degraded,
                     set_plan)
from .validate import (DEFECT_KINDS, SparseInputError, ValidationReport,
                       check_finite_tree, csr_defects, repair_counts,
                       validate_coo, validate_csr)

__all__ = ["DeadlineExceeded", "classify", "retry_with_backoff",
           "FaultClause", "FaultPlan", "InjectedFault", "InjectedTimeout",
           "fault_point", "get_plan", "install_from_env", "note_degraded",
           "set_plan",
           "DEFECT_KINDS", "SparseInputError", "ValidationReport",
           "check_finite_tree", "csr_defects", "repair_counts", "validate_coo", "validate_csr"]
