"""Front door of the tuner: ``autotune`` and ``tune_suite``.

Port of ``repro/tune/api.py``.  Data flow:

    CSR ──fingerprint──▶ cache lookup (exact key, then near-match)
          │ hit: rehydrate the plan (r_boundary stored as a row *fraction*
          │      so a near-match transfers across sizes), run Algorithm 1,
          │      skip all measurement
          ▼ miss
        search (model-pruned, wall-clock-ranked) ──▶ cache.put ──▶ execute

The default backend is ``"cuda"`` (the kernels B1/B2) and the default
device is CUDA: without a GPU a default call raises, as
``core.spmm.plan_and_convert`` does; the CPU runs only when the caller
passes ``device="cpu"``.  The returned format is uploaded to the device.

A repeated ``autotune`` on the same matrix is an exact hit that performs
zero measurements; a structurally similar unseen matrix is a near-hit that
reuses the neighbour's plan.  Both are counted in ``cache.stats``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..core.formats import CSR, LoopsFormat, loops_from_csr
from ..core.perf_model import QuadraticPerfModel
from ..core.spmm import SpmmPlan
from ..kernels import engine
from .cache import CACHE_VERSION, PlanCache
from .fingerprint import (Fingerprint, cache_key, effective_n_cols,
                          fingerprint)
from .search import SearchBudget, SearchResult, search

__all__ = ["autotune", "tune_suite", "Tuner", "default_cache",
           "make_record", "plan_from_record", "record_from_result"]

_DEFAULT_CACHE: Optional[PlanCache] = None


def default_cache() -> PlanCache:
    """Process-wide cache instance (``$REPRO_TUNE_CACHE`` honoured)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = PlanCache()
    return _DEFAULT_CACHE


def make_record(features, *, dtype, n_cols: int, backend: str, r_frac: float,
                t_vpu: int, t_mxu: int, br: int, panel_g: int = 1,
                pipeline_depth: int = 1, macro_m: int = 1,
                gflops: float = 0.0, trials: int = 0) -> Dict:
    """The one place the cache-record schema is spelled out (the distributed
    scheduler and the search path both store through here).  ``r_frac`` (not
    the absolute boundary) is stored so a plan transfers to same-bucket
    matrices of slightly different height."""
    return {
        "version": CACHE_VERSION,
        "fingerprint": [float(f) for f in features],
        "dtype": str(np.dtype(dtype).name),
        "n_cols": int(n_cols),
        "backend": backend,
        "plan": {"r_frac": float(r_frac), "t_vpu": int(t_vpu),
                 "t_mxu": int(t_mxu), "br": int(br),
                 "panel_g": int(panel_g),
                 "pipeline_depth": int(pipeline_depth),
                 "macro_m": int(macro_m)},
        "gflops": float(gflops),
        "trials": int(trials),
    }


def record_from_result(fp: Fingerprint, res: SearchResult, *, nrows: int,
                       dtype, n_cols: int, backend: str) -> Dict:
    """Serialisable cache record for a completed search."""
    return make_record(
        fp.features(), dtype=dtype, n_cols=n_cols, backend=backend,
        r_frac=float(res.plan.r_boundary) / max(nrows, 1),
        t_vpu=res.plan.t_vpu, t_mxu=res.plan.t_mxu, br=res.plan.br,
        panel_g=res.plan.panel_g,
        pipeline_depth=getattr(res.plan, "pipeline_depth", 1),
        macro_m=getattr(res.plan, "macro_m", 1),
        gflops=res.gflops, trials=res.measured)


def plan_from_record(rec: Mapping, nrows: int) -> SpmmPlan:
    """Rehydrate a concrete plan for an ``nrows``-row matrix.

    The endpoints are preserved exactly (a pure-CSR plan must stay
    ``r_boundary == nrows`` even when ``nrows`` is not a ``br`` multiple),
    and the boundary is forced consistent with the worker split: a plan
    with no MXU workers cannot leave a BCSR region behind, nor vice versa.
    """
    p = rec["plan"]
    br = int(p["br"])
    t_vpu, t_mxu = int(p["t_vpu"]), int(p["t_mxu"])
    r_frac = float(p["r_frac"])
    r_b = int(round(r_frac * nrows))
    if r_b < nrows:                    # interior boundaries snap to tiles
        r_b = min(max(r_b // br * br, 0), nrows)
    if t_mxu == 0:                     # no matrix workers -> pure CSR
        r_b = nrows
    elif t_vpu == 0:                   # no vector workers -> pure BCSR
        r_b = 0
    return SpmmPlan(r_boundary=r_b, t_vpu=t_vpu, t_mxu=t_mxu, br=br,
                    panel_g=int(p.get("panel_g", 1)),
                    pipeline_depth=int(p.get("pipeline_depth", 1)),
                    macro_m=int(p.get("macro_m", 1)))


def autotune(csr: CSR, *, n_cols: int = 32, rhs_shape=None,
             backend: str = "cuda",
             total_workers: int = 8, cache: Optional[PlanCache] = None,
             model: Optional[QuadraticPerfModel] = None,
             budget: SearchBudget = SearchBudget(),
             near_distance: float = 0.25,
             on_miss: str = "search", device=None,
             ) -> Tuple[LoopsFormat, SpmmPlan]:
    """Tune-or-fetch an execution plan for ``csr`` against an (ncols, n_cols)
    dense operand; returns the converted format plus the resolved plan.

    ``rhs_shape`` — the full ``(..., K, N)`` shape of a (possibly batched)
    dense operand — overrides ``n_cols`` with the *effective* column count
    ``prod(batch) * N`` (:func:`repro_torch.tune.fingerprint.effective_n_cols`)
    and makes the search measure candidates against an operand of exactly
    that shape, so batched workloads tune (and cache) the plan the batched
    engine call will actually execute.

    On a cache hit (exact or near) only the Algorithm 1 conversion runs —
    no candidate is ever measured.  On a miss, ``on_miss`` picks the policy:

      * ``"search"`` (default) — :func:`repro_torch.tune.search.search`
        spends its budget on ``device`` and the measured winner is
        persisted;
      * ``"model"`` — degraded mode: skip measurement entirely and serve
        the Eq. 2 model-prior plan *now*
        (:func:`repro_torch.core.spmm.plan_and_convert`), persisting it with
        ``gflops=0.0, trials=0`` so a later search-mode call can tell the
        record was never measured.  This is what lets a latency-bound server
        answer a cold request without paying a tuning sweep.
    """
    if on_miss not in ("search", "model"):
        raise ValueError(f"on_miss must be 'search' or 'model', "
                         f"got {on_miss!r}")
    dev = engine.resolve_device(device)
    backend = engine.resolve_backend(backend)
    if cache is None:   # NB: not `cache or ...` — an empty PlanCache is falsy
        cache = default_cache()
    if rhs_shape is not None:
        n_cols = effective_n_cols(rhs_shape)
    fp = fingerprint(csr)
    dt = np.dtype(csr.vals.dtype)
    key = cache_key(fp, n_cols=n_cols, dtype=dt, backend=backend)
    rec = cache.lookup(key, features=fp.features(), dtype=dt.name,
                       n_cols=n_cols, backend=backend,
                       max_distance=near_distance)
    if rec is not None:
        plan = plan_from_record(rec, csr.nrows)
        if cache.peek(key) is None:
            # Near-hit: promote the borrowed plan under THIS matrix's exact
            # key (with its own fingerprint), so the next lookup is exact
            # and downstream peeks (tune_suite reporting) always resolve.
            cache.put(key, {**rec,
                            "fingerprint": [float(f) for f in fp.features()]})
        fmt = loops_from_csr(csr, plan.r_boundary, plan.br,
                             panel_g=plan.panel_g, macro_m=plan.macro_m,
                             pipeline_depth=plan.pipeline_depth)
        fmt.on(dev)
        return fmt, plan
    if on_miss == "model":
        from ..core.spmm import plan_and_convert
        fmt, plan = plan_and_convert(csr, total_workers=total_workers,
                                     model=model, validate=None, device=dev)
        cache.put(key, make_record(
            fp.features(), dtype=dt, n_cols=n_cols, backend=backend,
            r_frac=float(plan.r_boundary) / max(csr.nrows, 1),
            t_vpu=plan.t_vpu, t_mxu=plan.t_mxu, br=plan.br,
            panel_g=plan.panel_g,
            pipeline_depth=getattr(plan, "pipeline_depth", 1),
            macro_m=getattr(plan, "macro_m", 1),
            gflops=0.0, trials=0))
        return fmt, plan
    res = search(csr, n_cols=n_cols, rhs_shape=rhs_shape,
                 total_workers=total_workers,
                 model=model, budget=budget, backend=backend, device=dev)
    cache.put(key, record_from_result(fp, res, nrows=csr.nrows, dtype=dt,
                                      n_cols=n_cols, backend=backend))
    res.fmt.on(dev)
    return res.fmt, res.plan


def tune_suite(matrices: Mapping[str, CSR], *, n_cols: int = 32,
               backend: str = "cuda", total_workers: int = 8,
               cache: Optional[PlanCache] = None,
               budget: SearchBudget = SearchBudget(), device=None,
               ) -> Dict[str, Tuple[SpmmPlan, float]]:
    """Batch-tune a named matrix set (e.g. ``suite.table2_like`` outputs).

    Returns ``{name: (plan, cached_gflops)}``; structurally similar matrices
    later in the iteration order ride the near-match path of earlier ones.
    """
    if cache is None:
        cache = default_cache()
    out: Dict[str, Tuple[SpmmPlan, float]] = {}
    for name, csr in matrices.items():
        _, plan = autotune(csr, n_cols=n_cols, backend=backend,
                           total_workers=total_workers, cache=cache,
                           budget=budget, device=device)
        key = cache_key(fingerprint(csr), n_cols=n_cols,
                        dtype=np.dtype(csr.vals.dtype), backend=backend)
        rec = cache.peek(key)
        gf = float(rec["gflops"]) if rec else float("nan")
        out[name] = (plan, gf)
    return out


@dataclasses.dataclass
class Tuner:
    """Bound tuning context, pluggable into ``plan_and_convert(tuner=...)``
    and ``sparse_linear_from_dense(tuner=...)`` so call sites that used a
    hand-set ``total_workers=8`` instead share one measured plan cache.
    ``device`` is where candidates are measured and formats uploaded
    (``None`` -> CUDA)."""

    cache: PlanCache = dataclasses.field(default_factory=default_cache)
    n_cols: int = 32
    rhs_shape: Optional[Tuple[int, ...]] = None  # full (..., K, N) operand
    backend: str = "cuda"
    total_workers: int = 8
    budget: SearchBudget = dataclasses.field(default_factory=SearchBudget)
    model: Optional[QuadraticPerfModel] = None
    near_distance: float = 0.25
    device: object = None

    def tune(self, csr: CSR) -> Tuple[LoopsFormat, SpmmPlan]:
        return autotune(csr, n_cols=self.n_cols, rhs_shape=self.rhs_shape,
                        backend=self.backend,
                        total_workers=self.total_workers, cache=self.cache,
                        model=self.model, budget=self.budget,
                        near_distance=self.near_distance,
                        device=self.device)
