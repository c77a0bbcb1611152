#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU: the LOOPS
SpMM paths and the llama3.2-1b server.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each, ``{"phase": ...}``):

  1. env      -- card name and power limit, toolchain, the kernels' build
                 (``nvcc`` for sm_90a from ``src/repro_torch/csrc``) and its
                 time;
  2. kernels  -- the CUDA kernels B1 (CSR part), B2 (BCSR part), B3 and B4
                 (their value gradients, the SDD kernels) against their
                 plain PyTorch versions on the card: fp32, fp64, bf16, f16
                 (and fp32 cotangents against half operands for B3/B4);
                 adversarial panel shapes, batch 1/3/11, N 32/40/600, the
                 fused buffer with a row offset, and B4 reading the whole
                 cotangent with a row offset against the zero-padded rows;
                 and B5 (flash attention) at the reference test's three
                 shapes, a ragged S of 1000 (hd 64 and 128) and the serving
                 shape (4, 2048, 32 heads, 8 kv heads, hd 64), causal and
                 not, fp32 / bf16 / f16;
  3. main     -- ``plan_and_convert`` -> ``loops_spmm`` at the published
                 sizes of pwtk (m6, 200k rows) and in-2004 (m4, 1.4M rows),
                 N=32, checked against the flat PyTorch path on the card,
                 with CUDA-event times of the whole call, of each kernel, of
                 its plain version and of cuSPARSE (``torch.sparse``), and
                 the bound from the bytes and operations the call needs;
  4. gcn      -- the 2-layer GCN at ogbn-arxiv's published widths answering
                 three requests, checked against the flat PyTorch path;
  5. train_gcn -- the paper's §4.5 workload: that GCN trained by plain SGD
                 (``examples/gcn_train.py``'s loss) for ``GCN_TRAIN_STEPS``
                 steps through B1/B2 forward and B1/B2 on the transposed
                 adjacency backward; the step-1 gradients of ``w0``/``w1``
                 and the loss trajectory against the flat path's autograd;
                 the transposed build's time, ms per step, and one step's
                 kernels by device time (``torch.profiler``);
  6. train_ffn -- one weight-sparse linear layer at llama3.2-1b's MLP
                 up-projection shape (8192 x 2048, 90% pruned) on a
                 (2, 1024, 2048) activation, fp32 and bf16: the value and
                 activation gradients (B3/B4 and B1/B2 on the transposed
                 weight) against the flat path's autograd, a few SGD steps,
                 B3/B4 timed alone with their bounds and
                 ``torch.sparse.sampled_addmm`` as the yardstick, and one
                 step's kernels by device time;
  7. serve_lm -- llama3.2-1b at full width (16 layers, d 2048, 32 heads,
                 8 kv heads, vocab 128,256) in bf16 with seeded random
                 weights, serving 4 requests of 2048 prompt + 32 generated
                 tokens (greedy) through ``ServeQueue``: prefill ms, decode
                 ms per step, tokens/s, time to first token, peak memory,
                 B5's launches (16 per prefill call); the same model in fp32,
                 one 2048-token prompt and 8 teacher-forced decode steps
                 through B5 and through the plain attention path, and
                 decode(token S | prefill(S)) against prefill(S + 1); the
                 bf16 greedy tokens' agreement with the plain path; B5 alone
                 at the serving shape in bf16 and fp32 (bound, plain
                 version, ``scaled_dot_product_attention`` as the
                 yardstick); one prefill call's and one decode step's
                 kernels by device time.

Each kernel's launch count is set to 0 just before phases 3-7 drive their
path and read just after; a kernel of a path that did not launch fails the
run, and so does a launch of a kernel that is not on the path (B5 in
phases 3-6, B1-B4 in phase 7).  The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero with no
result.  ``--out DIR`` also writes the full record to
``DIR/chip_smoke.json``.

Tolerances: fp32 1e-5, fp64 1e-12, bf16/f16 1e-2 (the sums run in another
order; half inputs are exact in the fp32 accumulator).  In phase 2 they
bound max |kernel - plain| / max(1, max |plain|).  At the published sizes a
hub row sums ~1e5 products, so phase 3 bounds the error of each element by
the summation bound instead: |kernel - plain| / max(1, (|A|·|B|)) <= tol.
The GCN's logits: 1e-4 of max(1, max |logits|) in fp32 (two aggregations and
two matmuls deep).  Gradients (phases 5 and 6) are bounded per element by
their own summation bound, the same products on magnitudes: in phase 6
|dY|·|B| for the values and |W|ᵀ·|dY| for the activation, at the dtype's
tolerance (bf16 1e-2: the kernel path casts dY to bf16 before dx, as the
reference does); in phase 5 the chain of |Â|ᵀ, |h|, |w1| and |x| products at
``GCN_TOL``, four SpMMs and four matmuls deep, with relu's mask taken as
all-ones (it may flip where an activation is within rounding of 0), and the
reference example's own check, max |g - g_flat| <= 1e-4.  B5 against its
plain version: 2e-5 in fp32 (the reference kernel test's) and 1e-2 in half
(both accumulate in fp32 and round the output once: at most an output ulp
apart), of max(1, max |plain|).  The LM's fp32 logits, B5 path against the
plain attention path and decode against prefill: ``LM_TOL`` = 1e-4 of
max(1, max |logits|), as the GCN's; the two paths differ only in the order
of attention's fp32 sums (~1e-7 relative), carried through 16 layers and a
2048-wide head, which leaves the logits ~1e-6 apart.  TF32 is off, and so
are cuBLAS's reduced-precision bf16 reductions.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): 3.35 TB/s HBM3; 67 TFLOP/s
# fp32 on the CUDA cores (this path uses no TF32); 67 TFLOP/s fp64 on the
# tensor cores; 989 TFLOP/s bf16/f16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "float16": 989e12,
              "bfloat16": 989e12}
TOL = {"float32": 1e-5, "float64": 1e-12, "float16": 1e-2, "bfloat16": 1e-2}
GCN_TOL = 1e-4

# (matrix id, published rows, dtypes) of the main path; N is the paper's
# fixed width (benchmarks/fig4_throughput.py).
MAIN_MATRICES = (("m6", 200_000, ("float32", "float64", "float16")),
                 ("m4", 1_400_000, ("float32", "float64")))
MAIN_N = 32
# ogbn-arxiv: 169,343 nodes, ~1.17M edges (avg degree ~7), 128 features,
# 40 classes; 256 hidden is OGB's GCN baseline width.
GCN_NODES, GCN_DEGREE, F_IN, F_HID, F_OUT = 169_343, 7, 128, 256, 40
# examples/gcn_train.py's learning rate; about 20 steps of the §4.5 loop.
GCN_TRAIN_STEPS, GCN_LR = 20, 5.0
# llama3.2-1b (src/repro/configs/llama3_2_1b.py): d_model 2048, d_ff 8192;
# the MLP up-projection is (d_ff, d_model).  90% magnitude pruning, applied
# to a (batch 2, 1024 tokens, d_model) activation.
FFN_D_OUT, FFN_D_IN, FFN_SPARSITY = 8192, 2048, 0.9
FFN_X_SHAPE = (2, 1024, 2048)
FFN_DTYPES = ("float32", "bfloat16")
FFN_STEPS, FFN_LR = 3, 1e-4

# llama3.2-1b (src/repro/configs/llama3_2_1b.py) at full width, served:
# 4 requests of 2048 prompt tokens and 32 generated tokens, greedy; the
# fp32 check decodes 8 teacher-forced tokens after one 2048-token prompt.
LM_ARCH, LM_SEED = "llama3.2-1b", 0
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK_STEPS = 4, 2048, 32, 8
LM_TOL = 1e-4
# B5 in phase 2: (B, S, H, KV, hd); the reference test's three shapes, a
# ragged S and the serving shape.
FLASH_SHAPES = ((1, 64, 1, 1, 16), (2, 128, 4, 2, 32), (1, 64, 6, 2, 16),
                (2, 1000, 8, 2, 64), (1, 1000, 4, 1, 128),
                (LM_BATCH, LM_PROMPT, 32, 8, 64))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2, "float16": 1e-2}

RECORD = {"phases": []}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(obj: dict) -> None:
    RECORD["phases"].append(obj)
    emit(obj)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(fn, *, samples: int = 10, reps: int = 5, warmup: int = 2) -> float:
    """Median over ``samples`` of the CUDA-event time of ``reps``
    back-to-back calls, divided by ``reps`` (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile_step(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (host
    clock around the synchronised call), the device time of the kernels it
    ran, summed by name (the eight longest), and the device's idle share
    of the wall time.  Device numbers are None where the profiler saw no
    kernel (it is untried on the GPU machine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) if rows else None
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "kernels": len(rows),
            "top": [{"name": n[:100], "device_ms": ms, "count": c}
                    for n, ms, c in rows[:8]]}


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max(1, max |want|)) in float64."""
    g = got.double()
    w = want.double()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    scale = max(1.0, float(w.abs().max()) if w.numel() else 0.0)
    return err, scale


def sum_err(got, want, absprod) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / max(1, absprod)) elementwise,
    where ``absprod`` = |A|·|B| bounds the rounding of each sum."""
    d = (got.double() - want.double()).abs()
    if not d.numel():
        return 0.0, 0.0
    return float(d.max()), float((d / absprod.double().clamp_min(1.0)).max())


def abs_format(fmt):
    """``fmt`` with every stored value replaced by its magnitude."""
    import dataclasses
    import numpy as np
    return dataclasses.replace(
        fmt, csr_part=dataclasses.replace(
            fmt.csr_part, vals=np.abs(fmt.csr_part.vals)),
        bcsr_part=dataclasses.replace(
            fmt.bcsr_part, tile_vals=np.abs(fmt.bcsr_part.tile_vals)))


def bound(*, bytes_moved: float, flops: float, dtype: str) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def panel_bound(panels, b3, out_elem: int, *, br: int, dtype: str) -> dict:
    """Least time of one panel-kernel call: each input read once (the panel
    arrays, the B rows the panels reference), each output row written once;
    flops of the real (unmasked) lanes."""
    import torch
    n = b3.shape[-1]
    real_cols = panels.cols[panels.mask]
    distinct_rows = int(torch.unique(real_cols).numel())
    elem = b3.element_size()
    meta = (panels.ptr.numel() * 8 + panels.cols.numel() * 4
            + panels.vals.numel() * panels.vals.element_size()
            + panels.mask.numel())
    out_rows = panels.ngroups * br
    nbytes = (meta + b3.shape[0] * distinct_rows * n * elem
              + b3.shape[0] * out_rows * n * out_elem)
    flops = 2.0 * real_cols.numel() * br * n * b3.shape[0]
    return bound(bytes_moved=float(nbytes), flops=flops, dtype=dtype)


def sdd_bound(panels, dy3, b3, out, *, br: int, dy_rows: int,
              dtype: str) -> dict:
    """Least time of one SDD-kernel call: the panel structure, the part's
    ``dy_rows`` cotangent rows and the B rows the panels reference, each
    read once, the panel-layout output written once; flops of the real
    (unmasked) lanes, Br per lane."""
    import torch
    n = b3.shape[-1]
    real_cols = panels.cols[panels.mask]
    distinct_rows = int(torch.unique(real_cols).numel())
    meta = (panels.rows.numel() * 4 + panels.cols.numel() * 4
            + panels.mask.numel())
    nbytes = (meta + b3.shape[0] * dy_rows * n * dy3.element_size()
              + b3.shape[0] * distinct_rows * n * b3.element_size()
              + out.numel() * out.element_size())
    flops = 2.0 * real_cols.numel() * br * n * b3.shape[0]
    return bound(bytes_moved=float(nbytes), flops=flops, dtype=dtype)


def library_sdd_ms(part_csr, dy_rows, bt, dtype) -> tuple[float | None, str]:
    """``torch.sparse.sampled_addmm`` on the part's CSR with the part's
    cotangent rows ``(rows, Z*N)`` and ``Bᵀ`` ``(Z*N, K)``: the same
    batch-summed SDD at the part's real nonzeros, as a yardstick only (the
    port never calls it)."""
    import torch
    try:
        a = torch.sparse_csr_tensor(
            torch.as_tensor(part_csr.row_ptr.astype("int64")).to(DEVICE),
            torch.as_tensor(part_csr.col_idx.astype("int64")).to(DEVICE),
            torch.as_tensor(part_csr.vals).to(DEVICE, dtype),
            size=part_csr.shape)
        m1, m2 = dy_rows.to(dtype), bt.to(dtype)
        ms = time_ms(lambda: torch.sparse.sampled_addmm(a, m1, m2, beta=0.0))
    except RuntimeError as e:   # a dtype the library does not take
        return None, f"n/a: {type(e).__name__}: " \
            f"{str(e).splitlines()[0][:160]}"
    return ms, "torch.sparse.sampled_addmm on the part's CSR (cuSPARSE SDDMM)"


def library_ms(csr, b, dtype) -> tuple[float | None, str]:
    """cuSPARSE through ``torch.sparse_csr_tensor(...) @ B`` on the same
    matrix, as a yardstick only (the port never calls it)."""
    import torch
    try:
        a = torch.sparse_csr_tensor(
            torch.as_tensor(csr.row_ptr.astype("int64")).to(DEVICE),
            torch.as_tensor(csr.col_idx.astype("int64")).to(DEVICE),
            torch.as_tensor(csr.vals).to(DEVICE, dtype), size=csr.shape)
        ms = time_ms(lambda: a @ b)
    except RuntimeError as e:   # a dtype cuSPARSE does not take
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return ms, "torch.sparse_csr_tensor @ dense (cuSPARSE)"


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    check(smi.returncode == 0 and smi_line, f"nvidia-smi failed: "
          f"{smi.stderr.strip()}")
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    RECORD["build_log"] = dict(_build.build_log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "env", "nvidia_smi": smi_line,
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "build_s": build_s, "libraries": sorted(p.name for p in
                                                   libs.values())}
    phase(info)
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _adversarial(rng):
    """Dense matrices whose panelizations hit every padding edge (the
    reference's tests/test_kernels.py::_adversarial_cases), plus a skewed
    random one with a hub row and empty rows."""
    import numpy as np

    def sparse(m, k, d):
        return (rng.random((m, k)) < d) * rng.standard_normal((m, k))
    cases = {"indivisible": sparse(11, 9, 0.35),
             "single_row": sparse(1, 13, 0.6)}
    hub = np.zeros((5, 24))
    hub[2, :] = rng.standard_normal(24)
    hub[0, 3] = 1.5
    cases["row_spans_panels"] = hub
    short = np.zeros((9, 6))
    for r in range(9):
        short[r, r % 6] = r + 1.0
        if r % 2:
            short[r, (r + 3) % 6] = -1.0
    cases["panel_at_row_boundary"] = short
    skew = sparse(300, 257, 0.03)
    skew[7] = rng.standard_normal(257)
    skew[40:60] = 0
    cases["skewed_300x257"] = skew
    return cases


def phase_kernels() -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import (csr_from_dense, default_br,
                                  loops_from_csr)
    from repro_torch.core.formats import DevicePanels
    from repro_torch.kernels import bcsr_spmm, csr_spmm, spmm_sdd

    rng = np.random.default_rng(0)
    cases = _adversarial(rng)
    worst = {k: 0.0 for k in KERNELS}
    ms = {}
    ncheck = 0
    dev = torch.device(DEVICE)
    for dname in ("float32", "float64", "bfloat16", "float16"):
        dt = getattr(torch, dname)
        tol = TOL[dname]
        for cname, a in cases.items():
            for g in (1, 8):
                for br in sorted({4, default_br(dt)}):
                    r_b = (a.shape[0] // 2) // br * br
                    fmt = loops_from_csr(csr_from_dense(a.astype(np.float64)),
                                         r_b, br, panel_g=g)
                    cp, bp = (dataclasses.replace(
                        p, vals=p.vals.to(dt)) for p in (
                        DevicePanels.upload(fmt.csr_panels, dev),
                        DevicePanels.upload(fmt.bcsr_panels, dev)))
                    for batch in (None, 3, 11):
                        for n in (32, 40, 600):
                            shape = ((a.shape[1], n) if batch is None
                                     else (batch, a.shape[1], n))
                            b = torch.as_tensor(
                                rng.standard_normal(shape)).to(dev, dt)
                            for name, fn, plain, kw, p in (
                                    ("csr_panels_spmm",
                                     csr_spmm.csr_panels_spmm,
                                     csr_spmm.csr_panels_spmm_plain,
                                     {"nrows": r_b}, cp),
                                    ("bcsr_panels_spmm",
                                     bcsr_spmm.bcsr_panels_spmm,
                                     bcsr_spmm.bcsr_panels_spmm_plain,
                                     {"nblocks": fmt.bcsr_part.nblocks}, bp)):
                                got = fn(p.rows, p.cols, p.vals, p.mask, b,
                                         panel_ptr=p.ptr, **kw)
                                want = plain(p.rows, p.cols, p.vals, p.mask,
                                             b, **kw)
                                torch.cuda.synchronize()
                                check(got.shape == want.shape
                                      and got.dtype == want.dtype,
                                      f"{name} {cname}: {got.shape} "
                                      f"{got.dtype} vs {want.shape} "
                                      f"{want.dtype}")
                                err, scale = max_err(got, want)
                                check(err <= tol * scale,
                                      f"{name} {dname} {cname} g={g} br={br} "
                                      f"batch={batch} n={n}: err {err:.3g} "
                                      f"> {tol:g} * {scale:.3g}")
                                worst[name] = max(worst[name], err / scale)
                                ncheck += 1
                            ncheck += _sdd_checks(fmt, cp, bp, b, dt, tol,
                                                  worst, rng)
                    # The fused buffer: B1 fills [0, r_b), B2 the rows from
                    # r_b on, and out_dtype = the storage dtype.
                    b = torch.as_tensor(rng.standard_normal(
                        (3, a.shape[1], 40))).to(dev, dt)
                    rows = r_b + fmt.bcsr_part.nblocks * br
                    bufs = []
                    for f1, f2 in ((csr_spmm.csr_panels_spmm,
                                    bcsr_spmm.bcsr_panels_spmm),
                                   (csr_spmm.csr_panels_spmm_plain,
                                    bcsr_spmm.bcsr_panels_spmm_plain)):
                        y = torch.full((3, rows, 40), float("nan"),
                                       dtype=dt, device=dev)
                        f1(cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=r_b,
                           out_dtype=dt, out=y)
                        f2(bp.rows, bp.cols, bp.vals, bp.mask, b,
                           nblocks=fmt.bcsr_part.nblocks, row_offset=r_b,
                           out_dtype=dt, out=y)
                        bufs.append(y)
                    torch.cuda.synchronize()
                    check(not bufs[0].isnan().any(),
                          f"fused buffer {dname} {cname}: a row was not "
                          "written")
                    err, scale = max_err(bufs[0], bufs[1])
                    check(err <= tol * scale,
                          f"fused buffer {dname} {cname} g={g} br={br}: "
                          f"err {err:.3g}")
                    ncheck += 1
    # One timing at a mid size per kernel (the main-path times are phase 3).
    a = cases["skewed_300x257"].astype(np.float32)
    fmt = loops_from_csr(csr_from_dense(a), 152, 8, panel_g=8)
    cp = DevicePanels.upload(fmt.csr_panels, dev)
    bp = DevicePanels.upload(fmt.bcsr_panels, dev)
    b = torch.as_tensor(rng.standard_normal((257, 32)).astype(
        np.float32)).to(dev)
    ms["csr_panels_spmm"] = time_ms(lambda: csr_spmm.csr_panels_spmm(
        cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=152, panel_ptr=cp.ptr))
    ms["bcsr_panels_spmm"] = time_ms(lambda: bcsr_spmm.bcsr_panels_spmm(
        bp.rows, bp.cols, bp.vals, bp.mask, b, nblocks=fmt.bcsr_part.nblocks,
        panel_ptr=bp.ptr))
    dy = torch.as_tensor(rng.standard_normal((300, 32)).astype(
        np.float32)).to(dev)
    ms["csr_sdd_panels"] = time_ms(lambda: spmm_sdd.csr_sdd_panels(
        cp.rows, cp.cols, cp.mask, dy, b))
    ms["bcsr_sdd_panels"] = time_ms(lambda: spmm_sdd.bcsr_sdd_panels(
        bp.rows, bp.cols, bp.mask, dy, b, br=8, row_offset=152, nrows=148))
    ncheck += _flash_checks(worst)
    rec = {"phase": "kernels_vs_plain", "checks": ncheck,
           "kernels": [{"name": k, "launches_in_checks":
                        _kernel_fns()[k].launches,
                        "max_rel_err": worst[k],
                        "ms_300x257_fp32_n32": ms.get(k)}
                       for k in worst]}
    phase(rec)
    return rec


def _flash_checks(worst) -> int:
    """B5 against its plain version on the same card tensors, every shape
    of ``FLASH_SHAPES``, causal and not, fp32 / bf16 / f16."""
    import torch
    from repro_torch.kernels import flash_attention as b5
    checks = 0
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for bsz, seq, heads, kv, hd in FLASH_SHAPES:
        for dname, tol in FLASH_TOL.items():
            dt = getattr(torch, dname)
            q = torch.randn((bsz, seq, heads, hd), generator=gen,
                            device=DEVICE).to(dt)
            k = torch.randn((bsz, seq, kv, hd), generator=gen,
                            device=DEVICE).to(dt)
            v = torch.randn((bsz, seq, kv, hd), generator=gen,
                            device=DEVICE).to(dt)
            for causal in (True, False):
                got = b5.flash_attention(q, k, v, causal=causal)
                want = b5.flash_attention_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == dt,
                      f"flash_attention: {got.shape} {got.dtype}")
                err, scale = max_err(got, want)
                check(err <= tol * scale, f"flash_attention {dname} "
                      f"{(bsz, seq, heads, kv, hd)} causal={causal}: err "
                      f"{err:.3g} > {tol:g} * {scale:.3g}")
                worst["flash_attention"] = max(worst["flash_attention"],
                                               err / scale)
                checks += 1
            del q, k, v, got, want
    return checks


def _sdd_checks(fmt, cp, bp, b, dt, tol, worst, rng) -> int:
    """B3 and B4 against their plain versions for one operand ``b``: dY in
    b's dtype and, for half b, in fp32 (the training backward's pair); B4
    on the whole cotangent with the part's row offset, and on the
    zero-padded BCSR rows, which must give the same numbers."""
    import torch
    from repro_torch.kernels import spmm_sdd
    m = fmt.nrows
    r_b, br, nblocks = fmt.r_boundary, fmt.bcsr_part.br, fmt.bcsr_part.nblocks
    n = b.shape[-1]
    checks = 0
    for dy_dt in ((dt,) if dt.itemsize >= 4 else (dt, torch.float32)):
        dy = torch.as_tensor(rng.standard_normal(
            b.shape[:-2] + (m, n))).to(b.device, dy_dt)
        dy_pad = torch.zeros(b.shape[:-2] + (nblocks * br, n), dtype=dy_dt,
                             device=b.device)
        dy_pad[..., :m - r_b, :] = dy[..., r_b:, :]
        outs = []
        for name, fn, plain, p, d, kw in (
                ("csr_sdd_panels", spmm_sdd.csr_sdd_panels,
                 spmm_sdd.csr_sdd_panels_plain, cp, dy, {}),
                ("bcsr_sdd_panels", spmm_sdd.bcsr_sdd_panels,
                 spmm_sdd.bcsr_sdd_panels_plain, bp, dy,
                 {"br": br, "row_offset": r_b, "nrows": m - r_b}),
                ("bcsr_sdd_panels", spmm_sdd.bcsr_sdd_panels,
                 spmm_sdd.bcsr_sdd_panels_plain, bp, dy_pad, {"br": br})):
            got = fn(p.rows, p.cols, p.mask, d, b, **kw)
            want = plain(p.rows, p.cols, p.mask, d, b, **kw)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name}: {got.shape} {got.dtype} vs {want.shape} "
                  f"{want.dtype}")
            err, scale = max_err(got, want)
            check(err <= tol * scale, f"{name} {dt} dy {dy_dt} "
                  f"{tuple(b.shape)} m={m} r_b={r_b} br={br}: err "
                  f"{err:.3g} > {tol:g} * {scale:.3g}")
            worst[name] = max(worst[name], err / scale)
            outs.append(got)
            checks += 1
        check(torch.equal(outs[1], outs[2]), f"bcsr_sdd_panels {dt}: the "
              "row-offset form differs from the zero-padded rows")
    return checks


# ---------------------------------------------------------------------------
# phase 3: the main path at published sizes
# ---------------------------------------------------------------------------

# The kernels of the port's paths: B1 and B2 (product), B3 and B4 (value
# gradient), B5 (the LM's prefill attention).
KERNELS = ("csr_panels_spmm", "bcsr_panels_spmm", "csr_sdd_panels",
           "bcsr_sdd_panels", "flash_attention")


def _kernel_fns() -> dict:
    from repro_torch.kernels import (bcsr_spmm, csr_spmm, flash_attention,
                                     spmm_sdd)
    return {"csr_panels_spmm": csr_spmm.csr_panels_spmm,
            "bcsr_panels_spmm": bcsr_spmm.bcsr_panels_spmm,
            "csr_sdd_panels": spmm_sdd.csr_sdd_panels,
            "bcsr_sdd_panels": spmm_sdd.bcsr_sdd_panels,
            "flash_attention": flash_attention.flash_attention}


def _reset_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {k: fn.launches for k, fn in _kernel_fns().items()}


def phase_main(launches: dict) -> list:
    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.kernels import bcsr_spmm, csr_spmm

    out = []
    for mid, rows, dtypes in MAIN_MATRICES:
        t0 = time.perf_counter()
        base = suite.table2_like(mid, scale_rows=rows, seed=0,
                                 dtype=np.float32)
        gen_s = time.perf_counter() - t0
        for dname in dtypes:
            dt = getattr(torch, dname)
            csr = base.astype(np.dtype(dname))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fmt, plan = plan_and_convert(csr, device=DEVICE)
            torch.cuda.synchronize()
            convert_s = time.perf_counter() - t0
            gen = torch.Generator(device=DEVICE).manual_seed(1)
            b = torch.randn((csr.shape[1], MAIN_N), generator=gen,
                            device=DEVICE, dtype=torch.float32).to(dt)

            _reset_counts()
            y = loops_spmm(fmt, b)
            torch.cuda.synchronize()
            counts = _read_counts()
            for k, v in counts.items():
                launches[k] += v
            has = {"csr_panels_spmm": plan.r_boundary > 0,
                   "bcsr_panels_spmm": plan.r_boundary < csr.nrows,
                   "csr_sdd_panels": False, "bcsr_sdd_panels": False,
                   "flash_attention": False}
            for k, v in counts.items():
                check(v == int(has[k]), f"{mid} {dname}: {k} launched {v} "
                      f"times in one loops_spmm (expected {int(has[k])})")

            want = loops_spmm(fmt, b, backend="torch")
            torch.cuda.synchronize()
            check(y.shape == (csr.nrows, MAIN_N) and bool(
                torch.isfinite(y).all()), f"{mid} {dname}: bad output "
                f"{tuple(y.shape)}")
            absprod = loops_spmm(abs_format(fmt), b.abs(), backend="torch")
            err, rel = sum_err(y, want, absprod)
            tol = TOL[dname]
            check(rel <= tol, f"{mid} {dname} loops_spmm vs flat torch: err "
                  f"{err:.3g}, {rel:.3g} of |A||B| > {tol:g}")

            dev = fmt.on(DEVICE)
            r_b, br = fmt.r_boundary, fmt.bcsr_part.br
            nblocks = fmt.bcsr_part.nblocks
            acc_elem = torch.empty((), dtype=y.dtype).element_size()
            buf = torch.empty((1, r_b + nblocks * br, MAIN_N), dtype=y.dtype,
                              device=DEVICE)
            b3 = b[None]
            kernels = {}
            parts = (
                ("csr_panels_spmm", dev.csr, 1,
                 lambda: csr_spmm.csr_panels_spmm(
                     dev.csr.rows, dev.csr.cols, dev.csr.vals, dev.csr.mask,
                     b3, nrows=r_b, panel_ptr=dev.csr.ptr, out=buf),
                 lambda vals=dev.csr.vals, b=b3:
                 csr_spmm.csr_panels_spmm_plain(
                     dev.csr.rows, dev.csr.cols, vals, dev.csr.mask, b,
                     nrows=r_b),
                 csr_slice_rows(csr, 0, r_b)),
                ("bcsr_panels_spmm", dev.bcsr, br,
                 lambda: bcsr_spmm.bcsr_panels_spmm(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.vals,
                     dev.bcsr.mask, b3, nblocks=nblocks,
                     panel_ptr=dev.bcsr.ptr, row_offset=r_b, out=buf),
                 lambda vals=dev.bcsr.vals, b=b3:
                 bcsr_spmm.bcsr_panels_spmm_plain(
                     dev.bcsr.rows, dev.bcsr.cols, vals, dev.bcsr.mask, b,
                     nblocks=nblocks),
                 csr_slice_rows(csr, r_b, csr.nrows)))
            for name, panels, pbr, run, plain, part_csr in parts:
                if not has[name]:
                    continue
                run()
                got = buf[:, :r_b] if name.startswith("csr") else \
                    buf[:, r_b:]
                ref_out = plain()
                absprod = plain(vals=panels.vals.abs(), b=b3.abs())
                torch.cuda.synchronize()
                k_err, k_rel = sum_err(got, ref_out, absprod)
                check(k_rel <= tol, f"{mid} {dname} {name} vs plain: err "
                      f"{k_err:.3g}, {k_rel:.3g} of |A||B| > {tol:g}")
                lib, lib_what = library_ms(part_csr, b, dt)
                kernels[name] = {
                    "ms": time_ms(run), "plain_ms": time_ms(
                        plain, samples=10, reps=1, warmup=1),
                    "library_ms": lib, "library": lib_what,
                    "max_abs_err": k_err, "max_err_of_absprod": k_rel,
                    "npanels": int(panels.rows.numel()),
                    "groups": panels.ngroups,
                    # the longest walk one warp makes (the tail)
                    "max_panels_per_group": int(
                        (panels.ptr[1:] - panels.ptr[:-1]).max()),
                    **panel_bound(panels, b3, acc_elem, br=pbr,
                                  dtype=dname)}
            lib, lib_what = library_ms(csr, b, dt)
            rec = {"phase": "main", "matrix": mid,
                   "name": suite.TABLE2_STATS[mid].name, "rows": csr.nrows,
                   "nnz": csr.nnz, "dtype": dname, "n": MAIN_N,
                   "generate_s": gen_s, "plan_and_convert_s": convert_s,
                   "r_boundary": plan.r_boundary, "br": br,
                   "panel_g": plan.panel_g, "launches": counts,
                   "loops_spmm_ms": time_ms(lambda: loops_spmm(fmt, b)),
                   "loops_spmm_max_abs_err": err,
                   "loops_spmm_max_err_of_absprod": rel,
                   "library_ms": lib, "library": lib_what,
                   "dense_matmul": "not run: the dense A does not fit",
                   "kernels": kernels,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            phase(rec)
            out.append(rec)
            del fmt, dev, buf, y, want, absprod
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the served GCN
# ---------------------------------------------------------------------------

def phase_gcn(launches: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.models import GCN, gcn_params_from_numpy

    t0 = time.perf_counter()
    adj = suite.gcn_graph(GCN_NODES, GCN_DEGREE, seed=0)
    fmt, plan = plan_and_convert(adj, device=DEVICE)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    params = {"w0": (rng.standard_normal((F_IN, F_HID)) * 0.1).astype(
                  np.float32),
              "w1": (rng.standard_normal((F_HID, F_OUT)) * 0.1).astype(
                  np.float32)}
    model = GCN(fmt, **gcn_params_from_numpy(params, device=DEVICE))
    xs = [torch.randn((GCN_NODES, F_IN), device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(
                          10 + i)) for i in range(3)]
    torch.cuda.synchronize()

    _reset_counts()
    logits, req_ms = [], []
    with torch.inference_mode():
        for x in xs:
            t0 = time.perf_counter()
            logits.append(model(x))
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        want = 6 if k.endswith("spmm") else 0
        check(v == want, f"gcn: {k} launched {v} times for 3 requests "
              f"(expected {want})")

    errs = []
    with torch.inference_mode():
        for x, got in zip(xs, logits):
            h = torch.relu(loops_spmm(fmt, x @ model.w0, backend="torch"))
            want = loops_spmm(fmt, h @ model.w1, backend="torch")
            check(got.shape == (GCN_NODES, F_OUT)
                  and bool(torch.isfinite(got).all()),
                  f"gcn: bad logits {tuple(got.shape)}")
            err, scale = max_err(got, want)
            check(err <= GCN_TOL * scale, f"gcn logits vs flat torch: err "
                  f"{err:.3g} > {GCN_TOL:g} * {scale:.3g}")
            errs.append(err)
        steady_ms = time_ms(lambda: model(xs[0]), samples=10, reps=3)
    rec = {"phase": "gcn", "nodes": GCN_NODES, "nnz": adj.nnz,
           "widths": [F_IN, F_HID, F_OUT], "r_boundary": plan.r_boundary,
           "setup_s": setup_s, "request_ms": req_ms,
           "steady_request_ms": steady_ms, "launches": counts,
           "max_abs_err": max(errs)}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 5: GCN training (paper §4.5)
# ---------------------------------------------------------------------------

def _grad_check(name: str, got, want, bnd, tol: float) -> dict:
    """Per-element check |got - want| <= tol * bound, where ``bnd`` >= 0 is
    the summation bound of each element; returns the record."""
    import torch
    d = (got.double() - want.double()).abs()
    rel = float((d / bnd.double().clamp_min(
        torch.finfo(torch.float64).tiny)).max()) if d.numel() else 0.0
    err = float(d.max()) if d.numel() else 0.0
    check(rel <= tol, f"{name}: max |kernel - flat| {err:.3g} is "
          f"{rel:.3g} of its summation bound (> {tol:g})")
    return {"max_abs_err": err, "max_err_of_bound": rel}


def _has_parts(fmt) -> tuple[int, int]:
    return int(fmt.r_boundary > 0), int(fmt.r_boundary < fmt.nrows)


def phase_train_gcn(launches: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.models import (GCN, gcn_loss, gcn_params_from_numpy,
                                    sgd_step)

    t0 = time.perf_counter()
    adj = suite.gcn_graph(GCN_NODES, GCN_DEGREE, seed=0)
    fmt, plan = plan_and_convert(adj, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # The transposed adjacency (Âᵀ for dB): built once, then cached.
    t0 = time.perf_counter()
    tl = fmt.transposed()
    tl.fmt.on(DEVICE)
    torch.cuda.synchronize()
    transpose_build_s = time.perf_counter() - t0
    check(fmt.transposed() is tl, "train_gcn: the transposed format was "
          "built twice")

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    x = torch.randn((GCN_NODES, F_IN), generator=gen, device=DEVICE)
    # planted labels, as examples/gcn_train.py makes them (through the
    # flat path: no dense adjacency)
    w_true = torch.as_tensor(rng.standard_normal((F_IN, F_OUT)).astype(
        np.float32)).to(DEVICE)
    with torch.no_grad():
        y = loops_spmm(fmt, x @ w_true, device=DEVICE, backend="torch").argmax(-1)
    params = {"w0": (rng.standard_normal((F_IN, F_HID)) * 0.1).astype(
                  np.float32),
              "w1": (rng.standard_normal((F_HID, F_OUT)) * 0.1).astype(
                  np.float32)}
    model = GCN(fmt, **gcn_params_from_numpy(params, device=DEVICE))
    flat = GCN(fmt, **gcn_params_from_numpy(params, device=DEVICE),
               backend="torch")

    # Step-1 gradients against the flat path's autograd.
    loss_k, _ = gcn_loss(model, x, y)
    g_k = torch.autograd.grad(loss_k, [model.w0, model.w1])
    loss_f, _ = gcn_loss(flat, x, y)
    g_f = torch.autograd.grad(loss_f, [flat.w0, flat.w1])
    with torch.no_grad():
        # Summation bounds of dW1 = hᵀ·Âᵀ·dL and dW0 = xᵀ·Âᵀ·(mask ⊙
        # (Âᵀ·dL)·W1ᵀ), on magnitudes, with the relu mask all-ones.
        tl_abs = abs_format(tl.fmt)
        h = torch.relu(loops_spmm(fmt, x @ flat.w0, device=DEVICE,
                                  backend="torch"))
        logits = loops_spmm(fmt, h @ flat.w1, device=DEVICE, backend="torch")
        dl = torch.softmax(logits, -1)
        dl[torch.arange(GCN_NODES, device=DEVICE), y] -= 1.0
        dl = dl.abs() / GCN_NODES
        b_dz1 = loops_spmm(tl_abs, dl, device=DEVICE, backend="torch")
        b_w1 = h.abs().T @ b_dz1
        b_dz0 = loops_spmm(tl_abs, b_dz1 @ flat.w1.abs().T, device=DEVICE,
                           backend="torch")
        b_w0 = x.abs().T @ b_dz0
    grads = {}
    for name, gk, gf, bnd in (("w0", g_k[0], g_f[0], b_w0),
                              ("w1", g_k[1], g_f[1], b_w1)):
        grads[name] = _grad_check(f"train_gcn d{name}", gk, gf, bnd,
                                  GCN_TOL)
        check(grads[name]["max_abs_err"] <= 1e-4, f"train_gcn d{name}: "
              f"max |kernel - flat| {grads[name]['max_abs_err']:.3g} > 1e-4 "
              "(examples/gcn_train.py's check)")
    loss_k, loss_f = float(loss_k.detach()), float(loss_f.detach())
    check(abs(loss_k - loss_f) <= GCN_TOL * max(1.0, abs(loss_f)),
          f"train_gcn: step-1 loss {loss_k} vs flat {loss_f}")
    del g_k, g_f, h, logits, dl, b_dz1, b_dz0

    # The loop: plain SGD through the kernels, then the flat path from the
    # same start.
    _reset_counts()
    losses, accs, step_ms = [], [], []
    for _ in range(GCN_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, acc = sgd_step(model, x, y, GCN_LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        accs.append(float(acc))
    counts = _read_counts()
    fwd, bwd = _has_parts(fmt), _has_parts(tl.fmt)
    want = {"csr_panels_spmm": 2 * (fwd[0] + bwd[0]) * GCN_TRAIN_STEPS,
            "bcsr_panels_spmm": 2 * (fwd[1] + bwd[1]) * GCN_TRAIN_STEPS,
            "csr_sdd_panels": 0, "bcsr_sdd_panels": 0, "flash_attention": 0}
    for k, v in counts.items():
        launches[k] += v
        check(v == want[k], f"train_gcn: {k} launched {v} times in "
              f"{GCN_TRAIN_STEPS} steps (expected {want[k]})")
    flat_losses = []
    t0 = time.perf_counter()
    for _ in range(GCN_TRAIN_STEPS):
        flat_losses.append(float(sgd_step(flat, x, y, GCN_LR)[0]))
    torch.cuda.synchronize()
    flat_step_ms = (time.perf_counter() - t0) * 1e3 / GCN_TRAIN_STEPS
    traj = max(abs(a - b) / max(1.0, abs(b))
               for a, b in zip(losses, flat_losses))
    check(all(np.isfinite(losses)) and traj <= GCN_TOL,
          f"train_gcn: loss trajectory {losses} vs flat {flat_losses}")
    check(losses[-1] < losses[0], f"train_gcn: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    profile = profile_step(lambda: sgd_step(model, x, y, GCN_LR))
    rec = {"phase": "train_gcn", "nodes": GCN_NODES, "nnz": adj.nnz,
           "widths": [F_IN, F_HID, F_OUT], "steps": GCN_TRAIN_STEPS,
           "lr": GCN_LR, "r_boundary": plan.r_boundary,
           "r_boundary_transposed": tl.fmt.r_boundary,
           "setup_s": setup_s, "transpose_build_s": transpose_build_s,
           "step_ms": step_ms,
           "steady_step_ms": statistics.median(step_ms[1:]),
           "flat_step_ms": flat_step_ms, "launches": counts,
           "losses": losses, "flat_losses": flat_losses, "accuracy": accs,
           "max_loss_diff_rel": traj, "step1_grads": grads,
           "profiled_step": profile}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 6: sparse-FFN training (llama3.2-1b MLP up-projection)
# ---------------------------------------------------------------------------

def phase_train_ffn(launches: dict) -> list:
    import numpy as np
    import torch
    from repro_torch.core import (csr_from_dense, loops_spmm_values,
                                  transposed_values)
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.kernels import spmm_sdd
    from repro_torch.models import magnitude_prune, sparse_linear_from_dense

    out = []
    for dname in FFN_DTYPES:
        dt = getattr(torch, dname)
        tol = TOL[dname]
        rng = np.random.default_rng(4)
        w = (rng.standard_normal((FFN_D_OUT, FFN_D_IN)) * 0.02).astype(
            np.float32)
        wt = torch.from_numpy(w).to(dt)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        layer = sparse_linear_from_dense(wt, FFN_SPARSITY, device=DEVICE)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        fmt = layer.fmt
        t0 = time.perf_counter()
        tl = fmt.transposed(dtype=dt)
        tl.fmt.on(DEVICE)
        tl.maps_on(DEVICE)
        torch.cuda.synchronize()
        transpose_build_s = time.perf_counter() - t0
        gen = torch.Generator(device=DEVICE).manual_seed(30)
        x = torch.randn(FFN_X_SHAPE, generator=gen, device=DEVICE).to(dt)
        x.requires_grad_(True)
        params = [layer.csr_vals, layer.bcsr_vals, x]

        # Gradients against the flat path's autograd, with one cotangent
        # (that of sum(y²) at the flat output) for both.  The flat path runs
        # in fp32 on the same values (bf16 is exact in fp32): in bf16 its
        # autograd would round each gathered product's gradient to bf16
        # before the scatter, a weaker oracle than the kernel path.
        def flat(cv, bv, xx):
            return loops_spmm_values(fmt, cv, bv, xx.transpose(-1, -2),
                                     device=DEVICE,
                                     backend="torch").transpose(-1, -2)
        flat_in = [t.detach().float().requires_grad_(True) for t in params]
        y_f = flat(*flat_in)
        y_k = layer(x)
        dy = (2.0 * y_f.detach()).to(dt)
        g_k = torch.autograd.grad(y_k, params, dy)
        g_f = torch.autograd.grad(y_f, flat_in, dy.float())
        abs_in = [t.detach().abs().requires_grad_(True) for t in flat_in]
        y_abs = flat(*abs_in)
        checks = {"y": _grad_check(f"train_ffn {dname} y", y_k.detach(),
                                   y_f.detach(), y_abs.detach(), tol)}
        bnds = torch.autograd.grad(y_abs, abs_in, dy.float().abs())
        for name, gk, gf, bnd in zip(("d_csr_vals", "d_bcsr_vals", "dx"),
                                     g_k, g_f, bnds):
            check(gk.dtype == dt and gk.shape == gf.shape,
                  f"train_ffn {dname} {name}: {gk.dtype} {gk.shape} vs "
                  f"{dt} {gf.shape}")
            checks[name] = _grad_check(f"train_ffn {dname} {name}", gk, gf,
                                       bnd, tol)
        del y_k, y_f, g_k, g_f, y_abs, bnds, abs_in, flat_in

        # B3 and B4 alone, at the backward's shapes: dY is the fp32
        # cotangent of the (d_out, tokens) product, B the activation.
        dev = fmt.on(DEVICE)
        b3 = x.detach().transpose(-1, -2).contiguous()
        dy3 = dy.transpose(-1, -2).float().contiguous()
        r_b, br = fmt.r_boundary, fmt.bcsr_part.br
        nrows_b = fmt.nrows - r_b
        csr = csr_from_dense(magnitude_prune(w if dname == "float32" else
                                             wt.float().numpy(),
                                             FFN_SPARSITY))
        zn = b3.shape[0] * b3.shape[2]
        bt = b3.permute(0, 2, 1).reshape(zn, FFN_D_IN)
        kernels = {}
        for name, panels, kbr, rows, run, plain, part_rows in (
                ("csr_sdd_panels", dev.csr, 1, r_b,
                 lambda: spmm_sdd.csr_sdd_panels(
                     dev.csr.rows, dev.csr.cols, dev.csr.mask, dy3, b3),
                 lambda d=dy3, b=b3: spmm_sdd.csr_sdd_panels_plain(
                     dev.csr.rows, dev.csr.cols, dev.csr.mask, d, b),
                 (0, r_b)),
                ("bcsr_sdd_panels", dev.bcsr, br, nrows_b,
                 lambda: spmm_sdd.bcsr_sdd_panels(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, dy3, b3,
                     br=br, row_offset=r_b, nrows=nrows_b),
                 lambda d=dy3, b=b3: spmm_sdd.bcsr_sdd_panels_plain(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, d, b,
                     br=br, row_offset=r_b, nrows=nrows_b),
                 (r_b, fmt.nrows))):
            got = run()
            want = plain()
            absprod = plain(d=dy3.abs(), b=b3.abs())
            torch.cuda.synchronize()
            k_err, k_rel = sum_err(got, want, absprod)
            check(k_rel <= tol, f"train_ffn {dname} {name} vs plain: err "
                  f"{k_err:.3g}, {k_rel:.3g} of |dY||B| > {tol:g}")
            dy_rows = dy3[:, part_rows[0]:part_rows[1]].permute(
                1, 0, 2).reshape(part_rows[1] - part_rows[0], zn)
            lib, lib_what = library_sdd_ms(
                csr_slice_rows(csr, *part_rows), dy_rows, bt, dt)
            kernels[name] = {
                "ms": time_ms(run),
                "plain_ms": time_ms(plain, samples=3, reps=1, warmup=1),
                "library_ms": lib, "library": lib_what,
                "max_abs_err": k_err, "max_err_of_absprod": k_rel,
                "npanels": int(panels.rows.numel()),
                **sdd_bound(panels, dy3, b3, got, br=kbr, dy_rows=rows,
                            dtype=dname)}
            del got, want, absprod, dy_rows
        del dy, dy3, bt
        # The live values' per-step copies: the scatter into both parts'
        # panels (forward) and the carry into Wᵀ's layout (dx).
        cv, bv = layer.csr_vals.detach(), layer.bcsr_vals.detach()
        scatter_ms = time_ms(lambda: (dev.csr.scatter_values(cv),
                                      dev.bcsr.scatter_values(bv)))
        carry_ms = time_ms(lambda: transposed_values(tl, cv, bv))

        # A few SGD steps on the stored values (x stays fixed), loss sum(y²).
        _reset_counts()
        losses, step_ms = [], []
        for _ in range(FFN_STEPS):
            t0 = time.perf_counter()
            loss = layer(x).float().square().sum()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                layer.csr_vals.sub_(FFN_LR * grads[0])
                layer.bcsr_vals.sub_(FFN_LR * grads[1])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
        counts = _read_counts()
        fw, bw = _has_parts(fmt), _has_parts(tl.fmt)
        want_n = {"csr_panels_spmm": (fw[0] + bw[0]) * FFN_STEPS,
                  "bcsr_panels_spmm": (fw[1] + bw[1]) * FFN_STEPS,
                  "csr_sdd_panels": fw[0] * FFN_STEPS,
                  "bcsr_sdd_panels": fw[1] * FFN_STEPS,
                  "flash_attention": 0}
        for k, v in counts.items():
            launches[k] += v
            check(v == want_n[k], f"train_ffn {dname}: {k} launched {v} "
                  f"times in {FFN_STEPS} steps (expected {want_n[k]})")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train_ffn {dname}: losses {losses}")
        profile = profile_step(lambda: torch.autograd.grad(
            layer(x).float().square().sum(), params))
        rec = {"phase": "train_ffn", "dtype": dname,
               "shape": [FFN_D_OUT, FFN_D_IN], "sparsity": FFN_SPARSITY,
               "x": list(FFN_X_SHAPE), "nnz": csr.nnz,
               "r_boundary": r_b, "br": br, "panel_g": fmt.panel_g,
               "r_boundary_transposed": tl.fmt.r_boundary,
               "br_transposed": tl.fmt.bcsr_part.br,
               "convert_s": convert_s,
               "transpose_build_s": transpose_build_s,
               "step_ms": step_ms, "scatter_values_ms": scatter_ms,
               "transposed_values_ms": carry_ms,
               "losses": losses, "lr": FFN_LR,
               "launches": counts, "grads": checks, "kernels": kernels,
               "profiled_step": profile,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        phase(rec)
        out.append(rec)
        del layer, x, params, grads, loss, fmt, tl, dev, b3
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: serving llama3.2-1b at full width
# ---------------------------------------------------------------------------

def flash_bound(q, k, *, causal: bool) -> dict:
    """Least time of one B5 call: Q, K, V read once and O written once;
    the QKᵀ and P·V flops of the (query, key) pairs the mask keeps, S(S+1)/2
    of S² per head when causal, at the dtype's peak."""
    bsz, seq, heads, hd = q.shape
    pairs = seq * (seq + 1) / 2 if causal else float(seq * seq)
    flops = 4.0 * hd * pairs * bsz * heads
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound(bytes_moved=float(nbytes), flops=flops,
                 dtype=str(q.dtype).replace("torch.", ""))


def _lm_logits_err(name: str, got, want) -> float:
    """Check fp32 logits against the reference path's at ``LM_TOL``;
    returns the error relative to max(1, max |want|)."""
    import torch
    err, scale = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= LM_TOL * scale,
          f"{name}: max |diff| {err:.3g} > {LM_TOL:g} * {scale:.3g}")
    return err / scale


def _b5_alone(dt) -> dict:
    """B5 at the serving shape on seeded tensors: its time, its plain
    version's, ``scaled_dot_product_attention``'s on the same tensors (the
    yardstick; the port never calls it), its error against the plain
    version, and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as b5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    _, _, heads, kv, hd = FLASH_SHAPES[-1]
    q = torch.randn((LM_BATCH, LM_PROMPT, heads, hd), generator=gen,
                    device=DEVICE).to(dt)
    k = torch.randn((LM_BATCH, LM_PROMPT, kv, hd), generator=gen,
                    device=DEVICE).to(dt)
    v = torch.randn((LM_BATCH, LM_PROMPT, kv, hd), generator=gen,
                    device=DEVICE).to(dt)
    got = b5.flash_attention(q, k, v, causal=True)
    want = b5.flash_attention_plain(q, k, v, causal=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib = sdpa().transpose(1, 2)
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    tol = FLASH_TOL[str(dt).replace("torch.", "")]
    check(err <= tol * scale, f"flash_attention alone: err {err:.3g}")
    lib_err, _ = max_err(lib, want)
    return {"dtype": str(dt), "shape": list(q.shape), "kv_heads": kv,
            "ms": time_ms(lambda: b5.flash_attention(q, k, v, causal=True)),
            "plain_ms": time_ms(lambda: b5.flash_attention_plain(
                q, k, v, causal=True), samples=3, reps=1, warmup=1),
            "library_ms": time_ms(sdpa),
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True)",
            "library_max_abs_err_vs_plain": lib_err,
            "max_abs_err": err, "max_err_rel": err / scale,
            **flash_bound(q, k, causal=True)}


def phase_serve_lm(launches: dict) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.queue import ServeQueue, pad_cache
    from repro_torch.serve.scheduler import SchedulerConfig

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(LM_ARCH)
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.num_params(params)
    rng = np.random.default_rng(LM_SEED + 1)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    # First use of cuBLAS's kernels at these shapes, outside the counts.
    warm = ServeQueue(cfg, params)
    warm.submit(prompts[0, :256].tolist(), 2)
    warm.drain()
    torch.cuda.synchronize()

    queue = ServeQueue(cfg, params, config=SchedulerConfig(max_batch=8))
    _reset_counts()
    t0 = time.perf_counter()
    reqs = [queue.submit(row.tolist(), LM_GEN) for row in prompts]
    done = queue.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _read_counts()
    n_prefill = queue.sched.counters["prefill_batches"]
    for k, v in counts.items():
        launches[k] += v
        want = layers * n_prefill if k == "flash_attention" else 0
        check(v == want, f"serve_lm: {k} launched {v} times for {n_prefill} "
              f"prefill calls (expected {want})")
    check(n_prefill == 1 and len(done) == LM_BATCH,
          f"serve_lm: {len(done)} of {LM_BATCH} requests in {n_prefill} "
          "prefill calls")
    served = np.array([r.tokens for r in reqs])
    check(served.shape == (LM_BATCH, LM_GEN) and served.min() >= 0
          and served.max() < cfg.vocab_size,
          f"serve_lm: tokens {served.shape} in [{served.min()}, "
          f"{served.max()}]")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = [s * 1e3 for s in queue.engine_s["decode"]]
    n_tokens = int(served.size)

    # bf16: the plain attention path, teacher-forced with the served tokens;
    # the share of its greedy tokens equal to the served (B5) ones.
    prompts_t = torch.as_tensor(prompts, device=DEVICE)
    served_t = torch.as_tensor(served, device=DEVICE)
    before = _read_counts()
    cache, logits = api.prefill(cfg, params, {"tokens": prompts_t},
                                backend="torch")
    plain_tokens = [logits[:, :cfg.vocab_size].argmax(-1)]
    cache = pad_cache(cfg, cache, LM_PROMPT + LM_GEN)
    for i in range(LM_GEN - 1):
        cache, logits = api.decode_step(cfg, params, cache,
                                        served_t[:, i:i + 1], LM_PROMPT + i)
        plain_tokens.append(logits[:, :cfg.vocab_size].argmax(-1))
    agree = float((torch.stack(plain_tokens, 1) == served_t).float().mean())
    check(_read_counts() == before, "serve_lm: the plain path launched a "
          "kernel")
    # One prefill call's and one decode step's kernels by device time (B5's
    # share of the prefill; the device's idle share of a decode step).
    profile = profile_step(lambda: api.prefill(cfg, params,
                                               {"tokens": prompts_t}))
    b5_share = sum(r["device_ms"] for r in profile["top"]
                   if "flash_mma_kernel" in r["name"]
                   or "flash_fwd_kernel" in r["name"])
    profile_dec = profile_step(lambda: api.decode_step(
        cfg, params, cache, served_t[:, -1:], LM_PROMPT + LM_GEN - 1))
    del cache, logits, params

    # fp32: logits through B5 and through the plain path, teacher-forced;
    # decode against prefill of one more token (S + 1 = 2049: B5's ragged
    # edge).
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = api.init_params(
        cfg32, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    toks = prompts_t[:1]
    teacher = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (1, LM_CHECK_STEPS)),
                              device=DEVICE)

    def run(backend):
        cache, logits = api.prefill(cfg32, params32, {"tokens": toks},
                                    backend=backend)
        outs = [logits]
        cache = pad_cache(cfg32, cache, LM_PROMPT + LM_CHECK_STEPS)
        for i in range(LM_CHECK_STEPS):
            cache, logits = api.decode_step(cfg32, params32, cache,
                                            teacher[:, i:i + 1],
                                            LM_PROMPT + i)
            outs.append(logits)
        return outs
    n0 = _kernel_fns()["flash_attention"].launches
    kernel_outs = run(None)
    check(_kernel_fns()["flash_attention"].launches == n0 + layers,
          "serve_lm fp32: the kernel path did not launch B5 once a layer")
    plain_outs = run("torch")
    torch.cuda.synchronize()
    step_errs = [_lm_logits_err(f"serve_lm fp32 logits step {i}", g, w)
                 for i, (g, w) in enumerate(zip(kernel_outs, plain_outs))]
    _, longer = api.prefill(cfg32, params32, {"tokens": torch.cat(
        [toks, teacher[:, :1]], 1)})
    dec_err = _lm_logits_err("serve_lm fp32 decode(S) vs prefill(S+1)",
                             kernel_outs[1], longer)
    del params32, kernel_outs, plain_outs, longer
    torch.cuda.empty_cache()

    alone = _b5_alone(torch.bfloat16)
    alone_fp32 = _b5_alone(torch.float32)
    rec = {"phase": "serve_lm", "arch": LM_ARCH, "params": n_params,
           "dtype": "bfloat16", "layers": layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "vocab": cfg.vocab_size, "requests": LM_BATCH,
           "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
           "bf16_reduced_precision_reduction": False,
           "init_s": init_s, "serve_s": serve_s,
           "prefill_calls": n_prefill,
           "prefill_ms": [s * 1e3 for s in queue.engine_s["prefill"]],
           "decode_steps": len(decode_ms),
           "decode_ms_median": statistics.median(decode_ms),
           "decode_ms": decode_ms,
           "ttft_ms": [r.wall_ttft_s * 1e3 for r in reqs],
           "tokens": n_tokens, "tokens_per_s": n_tokens / serve_s,
           "decode_tokens_per_s": LM_BATCH / (
               statistics.median(decode_ms) / 1e3),
           "peak_mem_gb": peak_gb, "launches": counts,
           "greedy_agreement_bf16_vs_plain": agree,
           "fp32_logits_err_rel": step_errs,
           "fp32_decode_vs_prefill_err_rel": dec_err,
           "b5_alone": alone, "b5_alone_fp32": alone_fp32,
           "profiled_prefill": profile,
           "profiled_prefill_b5_device_ms": b5_share,
           "profiled_decode_step": profile_dec}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------

SOURCES = {
    "csr_panels_spmm": ("src/repro_torch/csrc/csr_spmm.cu",
                        "src/repro/kernels/csr_spmm.py:172"),
    "bcsr_panels_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu",
                         "src/repro/kernels/bcsr_spmm.py:177"),
    "csr_sdd_panels": ("src/repro_torch/csrc/csr_sdd.cu",
                       "src/repro/kernels/spmm_sdd.py:164"),
    "bcsr_sdd_panels": ("src/repro_torch/csrc/bcsr_sdd.cu",
                        "src/repro/kernels/spmm_sdd.py:336"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="directory to write the full record into, as "
                         "chip_smoke.json")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU "
              "path only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    env = phase_env()
    phase_kernels()
    launches = {k: 0 for k in KERNELS}
    main_recs = phase_main(launches)
    phase_gcn(launches)
    phase_train_gcn(launches)
    ffn_recs = phase_train_ffn(launches)
    lm_rec = phase_serve_lm(launches)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the port's paths")

    # The kernels line reports B1/B2 at the pwtk (m6) fp32 main-path call,
    # B3/B4 at the fp32 sparse-FFN backward and B5 at the bf16 serving
    # shape.
    rep = next(r for r in main_recs
               if r["matrix"] == "m6" and r["dtype"] == "float32")
    rep_ffn = next(r for r in ffn_recs if r["dtype"] == "float32")
    line = []
    for name, (src, replaces) in SOURCES.items():
        if name == "flash_attention":
            k = lm_rec["b5_alone"]
        else:
            k = (rep if name.endswith("spmm") else rep_ffn)["kernels"][name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    RECORD["kernels"] = line
    RECORD["total_s"] = time.perf_counter() - t_start
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(RECORD,
                                                             indent=1))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
