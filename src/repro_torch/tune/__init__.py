"""repro_torch.tune — measured autotuner with a persistent plan cache.

Port of ``repro/tune``.  Structural fingerprints key a versioned on-disk
plan cache (the reference's format and version), a budgeted search
(model-pruned, ranked by the time of the kernels B1/B2 on the device)
fills it, and the call sites ``plan_and_convert(tuner=...)``,
``LoopsFormat.transposed(tuner=...)`` and
``sparse_linear_from_dense(tuner=...)`` share one measurement sweep across
every matrix that fingerprints alike.  ``$REPRO_TUNE_CACHE`` names the
cache directory (default ``~/.cache/repro-tune``).
"""
from .api import (Tuner, autotune, default_cache, make_record,
                  plan_from_record, record_from_result, tune_suite)
from .cache import CACHE_VERSION, CacheStats, PlanCache
from .fingerprint import (Fingerprint, cache_key, effective_n_cols,
                          feature_distance, fingerprint, loops_fingerprint)
from .search import (SearchBudget, SearchResult, enumerate_plans,
                     measure_plan_gflops, prior_model, search)

__all__ = [
    "Tuner", "autotune", "default_cache", "tune_suite", "make_record",
    "plan_from_record", "record_from_result", "CACHE_VERSION", "CacheStats",
    "PlanCache",
    "Fingerprint", "cache_key", "effective_n_cols", "feature_distance",
    "fingerprint",
    "loops_fingerprint", "SearchBudget", "SearchResult", "enumerate_plans",
    "measure_plan_gflops", "prior_model", "search",
]
