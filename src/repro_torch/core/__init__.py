"""LOOPS core on PyTorch: the hybrid CSR + vector-wise BCSR format, the
Eq. 1 partition, the Eq. 2/3 performance model, the synthetic suite and the
differentiable SpMM front door, and the distributed operator over
``torch.distributed``."""
from . import suite
from .formats import (CSR, DEFAULT_PANEL_G, DeviceLoops, DevicePanels,
                      LoopsFormat, PanelBCSR, PanelCSR, TransposedLoops,
                      VectorBCSR, bcsr_from_csr_rows, csr_from_coo,
                      csr_from_dense, csr_to_dense, loops_format_from_arrays,
                      loops_from_csr, loops_from_csr_mapped, panelize_bcsr,
                      panelize_csr, transposed_values)
from .partition import choose_r_boundary, regularity_boundary, row_stats
from .perf_model import (QuadraticPerfModel, best_allocation, calibrate,
                         fit_perf_model)
from .spmm import (SpmmPlan, default_br, loops_batched_grid_steps,
                   loops_grid_steps, loops_spmm, loops_spmm_values,
                   plan_and_convert, plan_for, spmm_csr_baseline,
                   spmm_dense_baseline)
from .distributed import (ShardedLoops, distributed_spmm, shard_loops,
                          shard_loops_auto)

__all__ = [
    "suite", "CSR", "DEFAULT_PANEL_G", "DeviceLoops", "DevicePanels",
    "LoopsFormat", "PanelBCSR", "PanelCSR", "TransposedLoops", "VectorBCSR",
    "bcsr_from_csr_rows", "csr_from_coo", "csr_from_dense", "csr_to_dense",
    "loops_format_from_arrays", "loops_from_csr", "loops_from_csr_mapped",
    "panelize_bcsr", "panelize_csr", "transposed_values", "choose_r_boundary", "regularity_boundary", "row_stats",
    "QuadraticPerfModel", "best_allocation", "calibrate", "fit_perf_model",
    "SpmmPlan", "default_br", "loops_batched_grid_steps", "loops_grid_steps",
    "loops_spmm", "loops_spmm_values", "plan_and_convert", "plan_for",
    "spmm_csr_baseline", "spmm_dense_baseline", "ShardedLoops",
    "distributed_spmm", "shard_loops", "shard_loops_auto",
]
