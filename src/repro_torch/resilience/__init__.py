"""repro_torch.resilience: validated ingestion (sparse inputs, converted
LOOPS formats, and restored parameter trees), the engine fallback chains,
seeded fault injection and the host-side retry/deadline helper.

Port of ``repro/resilience``.  The fallback chains (``run_chain``,
``FallbackPolicy``) are off until a caller installs
``set_policy(FallbackPolicy())``: by default a kernel that fails to build
or launch raises (``fallback.py`` says what a chain cannot catch).  Every
degradation the port records (``engine.fallback``, ``inject.fired``,
``validate.repaired``, ``tune.cache.quarantined``,
``tune.search.trial_failed``, ``serve.degraded``) lands on the active obs
capture through :func:`note_degraded`.
"""
from .fallback import (CHAIN_OVERRIDES, DEFAULT_CHAIN, DeadlineExceeded,
                       FallbackPolicy, classify, disabled, get_policy,
                       retry_with_backoff, run_chain, set_policy)
from .inject import (FaultClause, FaultPlan, InjectedFault, InjectedTimeout,
                     fault_point, get_plan, install_from_env, note_degraded,
                     set_plan)
from .validate import (DEFECT_KINDS, SparseInputError, ValidationReport,
                       check_finite_tree, csr_defects, repair_counts,
                       validate_coo, validate_csr, validate_loops)

__all__ = ["CHAIN_OVERRIDES", "DEFAULT_CHAIN", "DeadlineExceeded",
           "FallbackPolicy", "classify", "disabled", "get_policy",
           "retry_with_backoff", "run_chain", "set_policy",
           "FaultClause", "FaultPlan", "InjectedFault", "InjectedTimeout",
           "fault_point", "get_plan", "install_from_env", "note_degraded",
           "set_plan",
           "DEFECT_KINDS", "SparseInputError", "ValidationReport",
           "check_finite_tree", "csr_defects", "repair_counts",
           "validate_coo", "validate_csr", "validate_loops"]
