"""Helpers the port's benchmarks share: copies of the reference's
``benchmarks/_util.py::bench_rng``, ``csv_row`` and ``gflops``, a timer
for the card and the CPU, and the two library baselines the paper compares
against on a GPU (cuSPARSE and dense cuBLAS), which the port never calls
in its own paths; the H100's published peaks that the dry-run's roofline
terms divide by, and the card's name and power limit to print beside
them."""
from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch

# One H100 SXM's published peaks (NVIDIA H100 Tensor Core GPU data sheet,
# SXM part, dense rates, at its 700 W limit): what the dry-run's roofline
# terms divide by.  A card set below 700 W runs slower under load, so every
# suite that prints a term prints the card's name and power limit beside
# it (:func:`card_label`).
PEAK_FLOPS_BF16 = 989e12      # bf16 / f16, tensor cores
PEAK_FLOPS_F32 = 67e12        # fp32 on the CUDA cores (no TF32)
HBM_BW = 3.35e12              # bytes/s
NVLINK_BW = 450e9             # bytes/s each way to the other cards
PEAKS_SOURCE = ("NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16, 67 TFLOP/s "
                "fp32, 3.35 TB/s HBM, 450 GB/s NVLink a direction")

# The densified A the dense baseline may hold on the device.  At the
# published sizes A dense is far larger (pwtk's 200,000 rows: 160 GB in
# fp32), so the dense column is then None with its reason.
DENSE_BUDGET_BYTES = 16 * 2 ** 30


def bench_rng(offset: int = 0) -> np.random.Generator:
    """Seeded RNG for benchmark inputs: ``REPRO_TEST_SEED`` (default 0)
    plus ``offset``, as the reference's, so both packages draw the same
    inputs under one seed."""
    seed = int(os.environ.get("REPRO_TEST_SEED", "0"))
    return np.random.default_rng(seed + offset)


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def gflops(nnz: int, n: int, seconds: float) -> float:
    return 2.0 * nnz * n / seconds / 1e9


def time_fn(fn, *args, device, repeats: int = 20, warmup: int = 3) -> float:
    """Median seconds per call of ``fn(*args)``, each call timed alone
    after ``warmup`` calls.  On a CUDA ``device`` each call lies between
    two CUDA events, read after the end event completes, so the time is
    the device's, the host's share of the call included; on the CPU it is
    the host clock."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    ts = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sparse_operand(csr, device, dtype=None) -> torch.Tensor:
    """``csr`` as a ``torch.sparse_csr_tensor`` on ``device``: the operand
    of the cuSPARSE baseline (``sparse_operand(csr, dev) @ b``)."""
    vals = torch.as_tensor(csr.vals)
    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.row_ptr.astype(np.int64)),
        torch.as_tensor(csr.col_idx.astype(np.int64)),
        vals if dtype is None else vals.to(dtype),
        size=csr.shape, check_invariants=False).to(device)


def dense_operand(csr, device, dtype=None,
                  budget: int = DENSE_BUDGET_BYTES):
    """``(A dense on device, "")``, densified on the device, or ``(None,
    reason)`` when it would take more than ``budget`` bytes."""
    item = torch.empty((), dtype=dtype or torch.as_tensor(
        csr.vals[:0]).dtype).element_size()
    nbytes = csr.shape[0] * csr.shape[1] * item
    if nbytes > budget:
        return None, (f"A dense would take {nbytes / 1e9:.1f} GB, over the "
                      f"{budget / 2 ** 30:.0f} GiB budget")
    return sparse_operand(csr, device, dtype).to_dense(), ""


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in full fp32 (no TF32), the port's precision contract
    (ROADMAP), for the dense cuBLAS baseline."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card), or
    why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"no card ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "no card"
