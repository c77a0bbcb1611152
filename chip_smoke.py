#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU: the LOOPS
SpMM paths, its autotuner, the llama3.2-1b server and its trainer.

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
                 B1/B2 at their uploaded unit tables and at tables that
                 force splits (U = 1, 2, 3 panels), plus a hub case whose
                 row and block-row span more than 50 units, with the split
                 block-row right after the boundary of the fused buffer;
                 and B5 (flash attention) at the reference test's three
                 shapes, a ragged S of 1000 (hd 64 and 128) and the serving
                 shape (4, 2048, 32 heads, 8 kv heads, hd 64), causal and
                 not, fp32 / bf16 / f16;
  3. main     -- ``plan_and_convert`` -> ``loops_spmm`` at the published
                 sizes of pwtk (m6, 200k rows) and in-2004 (m4, 1.4M rows),
                 N=32, checked against the flat PyTorch path on the card
                 and against a second call (bitwise equal), with each
                 kernel's unit counts and workspace bytes and CUDA-event
                 times of the whole call, of each kernel, of
                 its plain version and of cuSPARSE (``torch.sparse``), and
                 the bound from the bytes and operations the call needs;
                 at m4 fp32 also B3 alone on the CSR part (its hub rows),
                 after the launch counts are read: against its plain
                 version and a second call, with its block table's counts,
                 bound and ``torch.sparse.sampled_addmm`` as the yardstick;
  4. tune     -- the autotuner (``repro_torch.tune``) at m6 and m4, fp32,
                 N=32, in a fresh ``$REPRO_TUNE_CACHE``: a miss whose search
                 measures its ``TUNE_TOP_K`` survivors on the card (none
                 failing), an exact hit with no measurement, a near hit
                 (the same generator across a quantisation edge of the row
                 count) promoted to its own key, the tuned ``loops_spmm``
                 against the flat path and a second call and timed beside
                 the default plan's; at m6 a ``TraceRecorder`` on the
                 search, a second search ranked by replay from its
                 records, and dB through ``fmt.transposed(tuner=...)``
                 against the flat path's autograd; an ``Obs`` capture over
                 the phase whose dispatch counts equal the B1/B2 launches
                 and whose ``tune.cache.*`` gauges equal the cache's stats,
                 written as JSONL and Chrome trace and read back;
  5. gcn      -- the 2-layer GCN at ogbn-arxiv's published widths answering
                 three requests, checked against the flat PyTorch path;
  6. train_gcn -- the paper's §4.5 workload: that GCN trained by plain SGD
                 (``examples/gcn_train.py``'s loss) for ``GCN_TRAIN_STEPS``
                 steps through B1/B2 forward and B1/B2 on the transposed
                 adjacency backward; the step-1 gradients of ``w0``/``w1``
                 and the loss trajectory against the flat path's autograd;
                 the transposed build's time, ms per step, and one step's
                 kernels by device time (``torch.profiler``);
  7. train_ffn -- one weight-sparse linear layer at llama3.2-1b's MLP
                 up-projection shape (8192 x 2048, 90% pruned) on a
                 (2, 1024, 2048) activation, fp32 and bf16: the value and
                 activation gradients (B3/B4 and B1/B2 on the transposed
                 weight) against the flat path's autograd, a few SGD steps,
                 B3/B4 timed alone (two calls bitwise equal) with their
                 bounds, TFLOP/s, share of the bound and
                 ``torch.sparse.sampled_addmm`` as the yardstick, and one
                 step's kernels by device time;
  8. serve_lm -- llama3.2-1b at full width (16 layers, d 2048, 32 heads,
                 8 kv heads, vocab 128,256) in bf16 with seeded random
                 weights, serving 4 requests of 2048 prompt + 32 generated
                 tokens (greedy) through ``ServeQueue`` and its
                 ``ExecutorPool`` (the bucket's prefill and decode captured
                 as CUDA graphs by ``warm()`` before traffic, then
                 replayed): the warm-up's seconds, buckets and slots,
                 prefill ms, decode ms per step, tokens/s, time to first
                 token, peak memory, B5's launches (16 per prefill replay);
                 the graphed prefill and decode steps against eager
                 ``api.prefill`` / ``api.decode_step`` at the same bucket and
                 cache, in turns; the served (graphed) bf16 greedy tokens
                 against the eager path's (equal) and the plain attention
                 path's (their agreement), teacher-forced; the same model
                 in fp32, one 2048-token prompt and 8 teacher-forced decode
                 steps graphed, eager through B5 and through the plain
                 attention path, and decode(token S | prefill(S)) against
                 prefill(S + 1); B5 alone
                 at the serving shape in bf16 and fp32 (bound, plain
                 version, ``scaled_dot_product_attention`` as the
                 yardstick, TFLOP/s and share of the bound), and at the
                 serving batch without the mask and at hd 128; one prefill
                 call's and one decode step's kernels (eager and replayed)
                 by device time;
  9. serve_obs -- ``python -m repro_torch.launch.serve --obs`` at the same
                 model and batch with 16 generated tokens: the plan-cache
                 warm-up of the 16 layers' pruned FFN weights (layer 0
                 searches on B1/B2, the rest hit, the serving pool installs
                 each distinct key once and a second warm-up none),
                 ``loops_spmm`` at the pool's plan for layer 0 (N=8)
                 against the flat path and a second call, the
                 capture's histograms against the requests and calls, the
                 tokens against a run without obs, and a run with one
                 injected ``serve.step`` fault (retried, counted, the same
                 tokens); prefill, TTFT and tokens/s beside phase 8's;
 10. serve_traffic -- ``repro_torch.benchmarks.serve_traffic`` at phase 8's
                 model and width: the reference's closed-loop load (6
                 clients x 3 rounds of its mixed shapes), batched against
                 sequential, two passes each through one pool: every request
                 completed, batched engine calls <= sequential, each mode's
                 goodput, p50/p99 and TTFT p50/p99, the pool's buckets and
                 slots, B5's launches; then two requests of one bucket in
                 flight at once, which take two slots and emit what each
                 emits alone;
 11. operator_bench -- the paper's operator evaluation
                 (``repro_torch.benchmarks``): ``python -m
                 repro_torch.benchmarks.run --smoke`` on the card in a
                 process of its own, its records validated against the
                 port's bench schema and gated (``perf_gate``, wall columns
                 off) against the committed CPU baseline; Fig. 4 at the
                 published sizes (the block family at the rows that give
                 the published nnz), N=32, fp32 and fp64, each
                 ``loops_spmm`` checked against the flat path and timed
                 beside the flat path, cuSPARSE and dense cuBLAS (None where
                 A dense exceeds the budget), with the calibrated plan at
                 m6 once; the batched suite at pwtk's size (batch 1/4/16,
                 loop / stack / native / ``torch.vmap``, forward and
                 backward, bitwise equal), with each strategy's launches
                 in one call; Table 4 with ogbn-arxiv's row; §4.3's five
                 regimes at 100,000 rows, calibrated on the card; the
                 autotune suite.
 12. train_lm -- LM training: B5 in training alone at llama3.2-1b's layer
                 shape (4, 2048, 32 heads, 8 kv, hd 64), causal, bf16 and
                 fp32 (the kernel's log-sum-exp against the plain
                 version's, the autograd Function's dQ, dK, dV against
                 autograd through the plain forward in fp32, forward /
                 backward / both against ``scaled_dot_product_attention``'s
                 forward and backward, and the serving launch with a null
                 lse); ``repro_torch.launch.train.main`` at full width in
                 bf16, 8 sequences of 2048 tokens in 2 microbatches, 4
                 steps with a checkpoint after step 2, then ``--resume``
                 from that checkpoint for steps 3-4 (bit for bit equal to
                 the uninterrupted run), step 0's loss and every gradient
                 leaf through B5 against a plain reference (autograd
                 through the plain attention and a full-logit
                 cross-entropy), with two planted faults that must fail
                 the same limits, the median step, tokens/s, peak memory,
                 the checkpoint's hand-off and write and the restore, and
                 the model-flops share; 30 steps of the reduced llama (the
                 loss falls by more than 0.5); ``examples/train_lm_torch.py``
                 at its defaults (it learns; its kernel logits equal the
                 plain path's at 1e-3) and its model at llama's FFN width
                 (d 2048, d_ff 8192, 32 heads, 90% sparsity, 2 layers, seq
                 512, batch 4: one step's value gradients against the flat
                 path, 3 SGD steps, B1-B5 all launching).

Each kernel's launch count is set to 0 just before phases 3-12 drive their
path and read just after; a kernel of a path that did not launch fails the
run, and so does a launch of a kernel that is not on the path (B5 in
phases 3-7, B1-B4 in phases 8 and 10 and in phase 12's LM runs, B3/B4 in
phase 9, B3-B5 in phase 11).  In phase 12 B5 launches twice a layer and
microbatch in a train step (the forward and the remat recompute; its
backward is PyTorch, no launch).  A replayed CUDA
graph adds the launches it captured (``repro_torch.dist.step``), and each
slot the pool builds runs its prefill once eagerly before the capture, so
B5 counts 16 launches per prefill replay and per slot built.  The last
two lines are ``{"kernels": [...]}`` and ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero with no result.  ``--out DIR``
also writes the full record to ``DIR/chip_smoke.json`` and phases 4 and
9's obs captures (JSONL and Chrome trace) beside it.

Tolerances: fp32 1e-5, fp64 1e-12, bf16/f16 1e-2 (the sums run in another
order; half inputs are exact in the fp32 accumulator).  In phase 2 they
bound max |kernel - plain| / max(1, max |plain|).  At the published sizes a
hub row sums ~1e5 products, so phase 3 bounds the error of each element by
the summation bound instead: |kernel - plain| / max(1, (|A|·|B|)) <= tol.
The GCN's logits: 1e-4 of max(1, max |logits|) in fp32 (two aggregations and
two matmuls deep).  Gradients (phases 4, 6 and 7) are bounded per element by
their own summation bound, the same products on magnitudes: in phase 7
|dY|·|B| for the values and |W|ᵀ·|dY| for the activation, at the dtype's
tolerance (bf16 1e-2: the kernel path casts dY to bf16 before dx, as the
reference does); in phase 6 the chain of |Â|ᵀ, |h|, |w1| and |x| products at
``GCN_TOL``, four SpMMs and four matmuls deep, with relu's mask taken as
all-ones (it may flip where an activation is within rounding of 0), and the
reference example's own check, max |g - g_flat| <= 1e-4.  B5 against its
plain version: 2e-5 in fp32 (the reference kernel test's) and 1e-2 in half
(both accumulate in fp32; the kernel rounds P to the half dtype before P·V,
as scaled_dot_product_attention does, and both round the output once), of
max(1, max |plain|); and, since a long row's output is ~1e-2 of that
scale, each output row within ``FLASH_ROW_TOL`` of its own norm (fp32
1e-4, bf16 1.5e-2, f16 3e-3).  The LM's fp32 logits, B5 path against the
plain attention path and decode against prefill: ``LM_TOL`` = 1e-4 of
max(1, max |logits|), as the GCN's; the two paths differ only in the order
of attention's fp32 sums (~1e-7 relative), carried through 16 layers and a
2048-wide head, which leaves the logits ~1e-6 apart.  Phase 12: B5's
log-sum-exp within ``LSE_TOL`` = 1e-5 of max(1, max |lse|) (fp32 statistics
in both); its gradients each row within ``FLASH_ROW_TOL`` of the fp32
oracle's row norm (:func:`grad_row_err`, rows at 1e-3 of the largest row's
norm floored there); the full-width step 0 on B5 against the plain
reference: loss ``TRAIN_LOSS_TOL`` = 1e-4 relative, gradient norm
``TRAIN_GNORM_TOL`` = 1e-3 relative, each leaf ``TRAIN_LEAF_TOL`` = 3e-2 of
its norm (bf16 activations rounded apart through 16 layers; measured
1.9e-5, 4.3e-5 and 1.25e-2); the sparse-FFN value gradients within
the fp32 tolerance of their summation bound, as phase 7.  TF32 is off, and
so are cuBLAS's reduced-precision bf16 reductions.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
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
# (matrix, dtype) of the main path at which B3 is timed alone on the CSR
# part: in-2004's hub rows, where no two rows share columns.
B3_MAIN = ("m4", "float32")
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
# B5 also against each output row's own size (``row_err``).  A long row's
# output is far below max |plain| (~0.03 against ~3 at S 2048), where
# FLASH_TOL is loose; P rounded once to bf16 moves a row by < 7e-3, f16 by
# < 1e-3, and a lost or misplaced K / V tile by 0.3 or more at S 1000 and
# 2049 (tests/test_torch_flash_attention.py models both).
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 1.5e-2, "float16": 3e-3}
# Phase tune: the autotuner at phase main's matrices (fp32, N = MAIN_N):
# the search's survivors, the replay search's, and the transposed search's.
TUNE_TOP_K, TUNE_REPLAY_TOP_K, TUNE_T_TOP_K = 4, 2, 2
# The near-hit matrix: phase main's generator and seed at the row count
# whose log2 lies 0.05 past the quantisation edge nearest phase main's (the
# plan cache buckets features in 0.5-wide bins): a different exact key
# within the near-match distance.  (Another seed does not do at m4: the
# power law's longest row moves with the seed, and a seed-1 in-2004-like
# matrix lay 0.80 away, a miss; PERF.md.)
# Phase serve_obs: the launcher with --obs at phase serve_lm's model and
# batch, 16 generated tokens; one injected serve.step fault in its last run.
OBS_GEN = 16
OBS_FAULT_PLAN = "serve.step:raise:0"

# Phase operator_bench: Fig. 4's dtypes at the published sizes, the matrix
# and dtype whose calibrated plan is timed once, the batched suite's
# batches at pwtk's size, and §4.3's row count.
FIG4_DTYPES = ("float32", "float64")
FIG4_CALIBRATED = ("m6", "float32")
BATCHED_BATCHES = (1, 4, 16)
SEC43_ROWS = 100_000

# Phase train_lm: the launcher at llama3.2-1b's full width (bf16, 4 x 2048
# tokens a microbatch, 2 microbatches), a checkpoint after step 2 and a
# resume from it.  Step 0's first microbatch, grad on, through B5 against
# the plain reference (_plain_train_loss): the loss within TRAIN_LOSS_TOL
# relative, the global gradient norm within TRAIN_GNORM_TOL relative and
# every leaf's gradient within TRAIN_LEAF_TOL of its norm.  The two paths
# round bf16 activations differently through 16 layers; measured on the
# H100: loss 1.9e-5, gradient norm 4.3e-5, worst leaf 1.25e-2 (an
# attention wk).  A K/V tile left out of the lse or of dK/dV moves the
# gradient norm by 0.19-1.0 and a leaf by 0.41-9.0, and the check runs both
# planted faults and requires them to fail.  The lse within LSE_TOL of
# max(1, |lse|) (fp32 statistics, ex2.approx in the half body: measured
# 2e-6); 30 steps of the reduced llama; the example at llama's FFN width.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_AT = 2048, 8, 4, 2
TRAIN_LOSS_TOL = 1e-4
TRAIN_GNORM_TOL = 1e-3
TRAIN_LEAF_TOL = 3e-2
LSE_TOL = 1e-5
REDUCED_STEPS = 30
EX_FFN = {"d_model": 2048, "d_ff": 8192, "heads": 32, "sparsity": 0.9,
          "layers": 2, "seq": 512, "batch": 4, "vocab": 512, "lr": 3e-2}
EX_STEPS = 3

# B1/B2 in phase 2: unit tables that force splits (panels per unit), and
# the width of the hub case's dense rows (> 50 units at U <= 3 and G = 8,
# and at B1's own unit size with G = 1).
SPLIT_UNIT_PANELS = (1, 2, 3)
HUB_K = 2000

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


def device_ms(fn, *, calls: int = 10, sessions: int = 3) -> float | None:
    """Device time of one call of ``fn``: the kernels ``torch.profiler``
    saw in ``calls`` calls, summed and divided by ``calls``, the median of
    ``sessions`` profiling sessions (a session now and then loses kernel
    records); None if it saw none.  Unlike :func:`time_ms` it leaves out
    the host's share of a call (the wrapper's checks and the launch), which
    bounds a call whose kernels take tens of microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        totals.append(sum(getattr(e, "self_device_time_total", 0)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    total = statistics.median(totals)
    return total / 1e3 / calls if total else None


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


def row_err(got, want) -> float:
    """max over rows of |got - want| / |want|, the norms over the last
    dimension, in float64 (a zero row of both counts as 0)."""
    if not want.numel():
        return 0.0
    w = want.double()
    d = (got.double() - w).norm(dim=-1)
    return float((d / w.norm(dim=-1).clamp_min(1e-300)).max())


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
    reference's tests/test_kernels.py::_adversarial_cases), a skewed random
    one with a hub row and empty rows, and a hub case whose rows and
    block-rows span more than 50 units at U <= 3 panels (and at B1's own
    unit size with G = 1), with empty groups on either side.  Returns ``{name:
    (matrix, r_boundary or None)}``; None puts the boundary at half the
    rows, rounded down to a whole block."""
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
    cases = {name: (a, None) for name, a in cases.items()}
    # CSR rows 1 and 3 are hubs between empty rows 0, 2; the BCSR part
    # starts at row 4 with a hub block-row (the split group right after the
    # boundary) and has another at row 36, between empty block-rows at Br
    # 4, 8 and 16.
    wide = np.zeros((68, HUB_K))
    for r in (1, 3, 4, 36):
        wide[r] = rng.standard_normal(HUB_K)
    wide[10, 5] = 0.5
    cases["hub_50_units"] = (wide, 4)
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
    most_units = {"csr_panels_spmm": 0, "bcsr_panels_spmm": 0}
    dev = torch.device(DEVICE)
    for dname in ("float32", "float64", "bfloat16", "float16"):
        dt = getattr(torch, dname)
        tol = TOL[dname]
        for cname, (a, fixed_rb) in cases.items():
            for g in (1, 8):
                for br in sorted({4, default_br(dt)}):
                    r_b = ((a.shape[0] // 2) // br * br if fixed_rb is None
                           else fixed_rb)
                    fmt = loops_from_csr(csr_from_dense(a.astype(np.float64)),
                                         r_b, br, panel_g=g)
                    cp, bp = (dataclasses.replace(
                        p, vals=p.vals.to(dt)) for p in (
                        DevicePanels.upload(fmt.csr_panels, dev),
                        DevicePanels.upload(fmt.bcsr_panels, dev)))
                    # The uploaded tables (each module's UNIT_PANELS) and
                    # tables that force splits at U = 1, 2, 3 panels.
                    tables = {name: [p.units] + [
                        csr_spmm.unit_table_of(p.ptr, u)
                        for u in SPLIT_UNIT_PANELS]
                        for name, p in (("csr_panels_spmm", cp),
                                        ("bcsr_panels_spmm", bp))}
                    for name, ts in tables.items():
                        most_units[name] = max(most_units[name], max(
                            int(t.units[:, 0].bincount().max())
                            if t.nunits else 0 for t in ts))
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
                                want = plain(p.rows, p.cols, p.vals, p.mask,
                                             b, **kw)
                                for t in tables[name]:
                                    got = fn(p.rows, p.cols, p.vals, p.mask,
                                             b, units=t, **kw)
                                    torch.cuda.synchronize()
                                    check(got.shape == want.shape
                                          and got.dtype == want.dtype,
                                          f"{name} {cname}: {got.shape} "
                                          f"{got.dtype} vs {want.shape} "
                                          f"{want.dtype}")
                                    err, scale = max_err(got, want)
                                    check(err <= tol * scale,
                                          f"{name} {dname} {cname} g={g} "
                                          f"br={br} batch={batch} n={n} "
                                          f"U={t.unit_panels}: err "
                                          f"{err:.3g} > {tol:g} * "
                                          f"{scale:.3g}")
                                    worst[name] = max(worst[name],
                                                      err / scale)
                                    ncheck += 1
                            ncheck += _sdd_checks(fmt, cp, bp, b, dt, tol,
                                                  worst, rng)
                    # The fused buffer: B1 fills [0, r_b), B2 the rows from
                    # r_b on, and out_dtype = the storage dtype; the plain
                    # pair first, then the kernels at every unit table.
                    b = torch.as_tensor(rng.standard_normal(
                        (3, a.shape[1], 40))).to(dev, dt)
                    rows = r_b + fmt.bcsr_part.nblocks * br
                    want = torch.full((3, rows, 40), float("nan"), dtype=dt,
                                      device=dev)
                    csr_spmm.csr_panels_spmm_plain(
                        cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=r_b,
                        out_dtype=dt, out=want)
                    bcsr_spmm.bcsr_panels_spmm_plain(
                        bp.rows, bp.cols, bp.vals, bp.mask, b,
                        nblocks=fmt.bcsr_part.nblocks, row_offset=r_b,
                        out_dtype=dt, out=want)
                    for ct, bt in zip(tables["csr_panels_spmm"],
                                      tables["bcsr_panels_spmm"]):
                        y = torch.full((3, rows, 40), float("nan"),
                                       dtype=dt, device=dev)
                        csr_spmm.csr_panels_spmm(
                            cp.rows, cp.cols, cp.vals, cp.mask, b,
                            nrows=r_b, units=ct, out_dtype=dt, out=y)
                        bcsr_spmm.bcsr_panels_spmm(
                            bp.rows, bp.cols, bp.vals, bp.mask, b,
                            nblocks=fmt.bcsr_part.nblocks, units=bt,
                            row_offset=r_b, out_dtype=dt, out=y)
                        torch.cuda.synchronize()
                        check(not y.isnan().any(),
                              f"fused buffer {dname} {cname} "
                              f"U={ct.unit_panels}: a row was not written")
                        err, scale = max_err(y, want)
                        check(err <= tol * scale,
                              f"fused buffer {dname} {cname} g={g} br={br} "
                              f"U={ct.unit_panels}: err {err:.3g}")
                        ncheck += 1
    check(min(most_units.values()) >= 50, f"the hub case spans at most "
          f"{most_units} units in one group (want >= 50 in each kernel)")
    # One timing at a mid size per kernel (the main-path times are phase 3).
    a = cases["skewed_300x257"][0].astype(np.float32)
    fmt = loops_from_csr(csr_from_dense(a), 152, 8, panel_g=8)
    cp = DevicePanels.upload(fmt.csr_panels, dev)
    bp = DevicePanels.upload(fmt.bcsr_panels, dev)
    b = torch.as_tensor(rng.standard_normal((257, 32)).astype(
        np.float32)).to(dev)
    ms["csr_panels_spmm"] = time_ms(lambda: csr_spmm.csr_panels_spmm(
        cp.rows, cp.cols, cp.vals, cp.mask, b, nrows=152, units=cp.units))
    ms["bcsr_panels_spmm"] = time_ms(lambda: bcsr_spmm.bcsr_panels_spmm(
        bp.rows, bp.cols, bp.vals, bp.mask, b, nblocks=fmt.bcsr_part.nblocks,
        units=bp.units))
    dy = torch.as_tensor(rng.standard_normal((300, 32)).astype(
        np.float32)).to(dev)
    ms["csr_sdd_panels"] = time_ms(lambda: spmm_sdd.csr_sdd_panels(
        cp.rows, cp.cols, cp.mask, dy, b, blocks=cp.sdd_blocks))
    ms["bcsr_sdd_panels"] = time_ms(lambda: spmm_sdd.bcsr_sdd_panels(
        bp.rows, bp.cols, bp.mask, dy, b, br=8, row_offset=152, nrows=148,
        units=bp.units))
    worst_row = {k: 0.0 for k in FLASH_ROW_TOL}
    ncheck += _flash_checks(worst, worst_row)
    rec = {"phase": "kernels_vs_plain", "checks": ncheck,
           "most_units_in_one_group": most_units,
           "flash_attention_max_row_err": worst_row,
           "kernels": [{"name": k, "launches_in_checks":
                        _kernel_fns()[k].launches,
                        "max_rel_err": worst[k],
                        "ms_300x257_fp32_n32": ms.get(k)}
                       for k in worst]}
    phase(rec)
    return rec


def _flash_checks(worst, worst_row) -> int:
    """B5 against its plain version on the same card tensors, every shape
    of ``FLASH_SHAPES``, causal and not, fp32 / bf16 / f16: at
    ``FLASH_TOL`` of max(1, max |plain|) and at ``FLASH_ROW_TOL`` of each
    row (the worst by dtype into ``worst_row``)."""
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
                rerr = row_err(got, want)
                check(rerr <= FLASH_ROW_TOL[dname], f"flash_attention "
                      f"{dname} {(bsz, seq, heads, kv, hd)} causal={causal}"
                      f": row err {rerr:.3g} > {FLASH_ROW_TOL[dname]:g}")
                worst["flash_attention"] = max(worst["flash_attention"],
                                               err / scale)
                worst_row[dname] = max(worst_row[dname], rerr)
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

            # Two calls give the same bits (fixed summation order).
            again = loops_spmm(fmt, b)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"{mid} {dname}: two loops_spmm "
                  "calls differ")
            del again
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
                     b3, nrows=r_b, units=dev.csr.units, out=buf),
                 lambda vals=dev.csr.vals, b=b3:
                 csr_spmm.csr_panels_spmm_plain(
                     dev.csr.rows, dev.csr.cols, vals, dev.csr.mask, b,
                     nrows=r_b),
                 csr_slice_rows(csr, 0, r_b)),
                ("bcsr_panels_spmm", dev.bcsr, br,
                 lambda: bcsr_spmm.bcsr_panels_spmm(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.vals,
                     dev.bcsr.mask, b3, nblocks=nblocks,
                     units=dev.bcsr.units, row_offset=r_b, out=buf),
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
                units = panels.units
                unit_panels = (csr_spmm if name.startswith("csr")
                               else bcsr_spmm).UNIT_PANELS
                check(units.unit_panels == unit_panels
                      and units.max_panels <= unit_panels,
                      f"{mid} {dname} {name}: a unit holds "
                      f"{units.max_panels} panels (U = {unit_panels})")
                kernels[name] = {
                    "ms": time_ms(run), "device_ms": device_ms(run),
                    "plain_ms": time_ms(
                        plain, samples=10, reps=1, warmup=1),
                    "library_ms": lib, "library": lib_what,
                    "max_abs_err": k_err, "max_err_of_absprod": k_rel,
                    "npanels": int(panels.rows.numel()),
                    "groups": panels.ngroups,
                    # the longest walk one warp makes (the tail)
                    "max_panels_per_group": int(
                        (panels.ptr[1:] - panels.ptr[:-1]).max()),
                    "unit_panels": units.unit_panels,
                    "units": units.nunits, "split_groups": units.nsplit,
                    "max_panels_per_unit": units.max_panels,
                    "workspace_bytes": units.nslots * pbr * MAIN_N
                    * acc_elem,
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
            if (mid, dname) == B3_MAIN:
                # After the launch counts and the phase's own times: B3 is
                # not on the forward path.
                kernels["csr_sdd_panels"] = _b3_main(fmt, csr, gen, dname)
            phase(rec)
            out.append(rec)
            del fmt, dev, buf, y, want, absprod
            torch.cuda.empty_cache()
    return out


def block_counts(blocks) -> dict:
    """What B3's block table (``kernels/spmm_sdd.py::SddBlockTable``)
    holds: blocks of each kind, the staged blocks' distinct columns (the B
    rows they stage) and dY rows, and the largest of each."""
    staged = blocks.blocks[:blocks.nstaged]   # the staged blocks come first
    return {"blocks": blocks.nblocks, "staged_blocks": blocks.nstaged,
            "direct_blocks": blocks.ndirect,
            "staged_cols": int(blocks.cols.numel()),
            "staged_dy_rows": int(staged[:, 6].sum()),
            "staged_outputs": int(blocks.outs.numel()),
            "max_cols": blocks.max_cols, "max_rows": blocks.max_rows}


def _b3_main(fmt, csr, gen, dname) -> dict:
    """B3 alone on the main path's CSR part (at in-2004's size, its hub
    rows), N = ``MAIN_N``, dY and B from the phase's generator: against its
    plain version at ``TOL`` of |dY|·|B| and a second call (bitwise equal),
    its time, device time, bound and ``torch.sparse.sampled_addmm``'s time,
    and the part's block table."""
    import torch
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.kernels import spmm_sdd
    dt = getattr(torch, dname)
    p = fmt.on(DEVICE).csr
    r_b = fmt.r_boundary
    t0 = time.perf_counter()
    blocks = p.sdd_blocks
    table_s = time.perf_counter() - t0
    b3 = torch.randn((1, csr.shape[1], MAIN_N), generator=gen, device=DEVICE,
                     dtype=torch.float32).to(dt)
    dy3 = torch.randn((1, csr.nrows, MAIN_N), generator=gen, device=DEVICE,
                      dtype=torch.float32).to(dt)

    def run():
        return spmm_sdd.csr_sdd_panels(p.rows, p.cols, p.mask, dy3, b3,
                                       blocks=blocks)

    def plain(d=dy3, b=b3):
        return spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask, d, b)
    got, again = run(), run()
    want = plain()
    absprod = plain(dy3.abs(), b3.abs())
    torch.cuda.synchronize()
    err, rel = sum_err(got, want, absprod)
    check(rel <= TOL[dname], f"B3 on the {dname} main-path CSR part vs "
          f"plain: err {err:.3g}, {rel:.3g} of |dY||B| > {TOL[dname]:g}")
    check(torch.equal(got, again), f"B3 on the {dname} main-path CSR part: "
          "two calls differ")
    lib, lib_what = library_sdd_ms(csr_slice_rows(csr, 0, r_b), dy3[0, :r_b],
                                   b3[0].t(), dt)
    rec = {"ms": time_ms(run), "device_ms": device_ms(run),
           "plain_ms": time_ms(plain, samples=3, reps=1, warmup=1),
           "library_ms": lib, "library": lib_what,
           "max_abs_err": err, "max_err_of_absprod": rel,
           "bitwise_repeatable": True, "npanels": int(p.rows.numel()),
           "stored_values": int(p.mask.sum()), "rows": r_b,
           "table_s": table_s, **block_counts(blocks),
           **sdd_bound(p, dy3, b3, got, br=1, dy_rows=r_b, dtype=dname)}
    rec.update(rate(rec))
    del got, again, want, absprod, b3, dy3
    return rec


# ---------------------------------------------------------------------------
# phase 4: the autotuner (tune/) on the card
# ---------------------------------------------------------------------------

def near_rows(rows: int) -> int:
    """``rows`` moved to 0.05 past its nearest quantisation edge in log2
    (the plan cache's 0.5-wide bins sit at x.25 and x.75)."""
    import math
    x = math.log2(rows)
    edges = (math.floor(x - 0.25) + 0.25, math.floor(x - 0.25) + 0.75,
             math.floor(x - 0.25) + 1.25)
    edge = min(edges, key=lambda e: abs(e - x))
    return int(round(2 ** (edge + (0.05 if edge > x else -0.05))))


def _dispatches(obs) -> dict:
    """The capture's ``engine.dispatch`` counts of kernel launches
    (``backend=cuda``, ``impl=panels``) by part."""
    out = {"csr": 0.0, "bcsr": 0.0}
    for kind, inst in obs.metrics.instruments():
        if (kind == "counter" and inst.name == "engine.dispatch"
                and inst.labels.get("backend") == "cuda"
                and inst.labels.get("impl") == "panels"
                and inst.labels.get("op") == "spmm"):
            out[inst.labels["part"]] += inst.value
    return out


def phase_tune(launches: dict, out_dir, work_dir) -> list:
    """``autotune`` at phase main's m6 and m4, fp32, N = MAIN_N: a miss
    that searches (every survivor measured on the card, none failed), an
    exact hit with no measurement, a near hit (the same generator across a
    quantisation edge of the row count) reusing the plan and promoted to
    its own key; the tuned ``loops_spmm`` against the flat path and a
    second call, timed beside the default plan's; at m6 dB through
    ``fmt.transposed(tuner=...)`` against the flat path's autograd, a
    ``TraceRecorder`` on the search and a second search ranked by replay
    from its records.  An ``Obs`` capture spans the phase: its dispatch
    counts equal the phase's B1/B2 launches, its ``tune.cache.*`` gauges
    the cache's stats; its JSONL and Chrome trace are written (to
    ``out_dir``, else ``work_dir``) and read back.  The plan cache lives in
    ``work_dir``."""
    import importlib
    import os

    from repro_torch.obs import Obs, load_obs, set_active
    from repro_torch.tune import PlanCache, SearchBudget
    search_mod = importlib.import_module("repro_torch.tune.search")
    api_mod = importlib.import_module("repro_torch.tune.api")

    os.environ["REPRO_TUNE_CACHE"] = str(pathlib.Path(work_dir) / "tune")
    cache = PlanCache()
    obs = Obs(source="chip_smoke_tune")
    obs.watch_cache(cache, name="tune")
    measured = []                  # (plan, gflops) of every measurement
    real_measure = search_mod.measure_plan_gflops

    def counting_measure(csr, plan, b, **kw):
        fmt, g = real_measure(csr, plan, b, **kw)
        measured.append((plan, g))
        return fmt, g
    real_search = api_mod.search
    prev_obs = set_active(obs)
    search_mod.measure_plan_gflops = counting_measure
    budget = SearchBudget(top_k=TUNE_TOP_K)
    recs = []
    _reset_counts()
    try:
        with obs.attach_engine():
            for mid, rows, _ in MAIN_MATRICES:
                recs.append(_tune_matrix(mid, rows, cache, budget, measured,
                                         api_mod, real_search))
    finally:
        search_mod.measure_plan_gflops = real_measure
        api_mod.search = real_search
        set_active(prev_obs)
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        if k in ("csr_panels_spmm", "bcsr_panels_spmm"):
            check(v > 0, f"tune: {k} never launched")
        else:
            check(v == 0, f"tune: {k} launched {v} times off its path")
    disp = _dispatches(obs)
    check(disp["csr"] == counts["csr_panels_spmm"]
          and disp["bcsr"] == counts["bcsr_panels_spmm"],
          f"tune: engine.dispatch {disp} against launches {counts}")
    check(not any(inst.name == "tune.search.trial_failed"
                  for _, inst in obs.metrics.instruments()),
          "tune: tune.search.trial_failed is not 0")
    st = cache.stats
    gauges = {r["metric"]: r["value"] for r in obs.records()
              if r["kind"] == "gauge" and r["labels"].get("cache") == "tune"}
    check(gauges["tune.cache.hits"] == st.hits
          and gauges["tune.cache.near_hits"] == st.near_hits
          and gauges["tune.cache.misses"] == st.misses
          and gauges["tune.cache.hit_rate"] == st.hit_rate,
          f"tune: gauges {gauges} against stats {st}")
    jsonl, chrome = obs.save(out_dir or work_dir, stem="chip_smoke_tune")
    back = load_obs(jsonl)
    trace = json.loads(pathlib.Path(chrome).read_text())
    check(back[0]["kind"] == "meta" and len(back) == len(obs.records())
          and trace["traceEvents"], "tune: the capture did not read back")
    rec = {"phase": "tune", "cache_stats": {"hits": st.hits, "near_hits": st.near_hits,
                           "misses": st.misses, "hit_rate": st.hit_rate},
           "engine_dispatch": disp, "launches": counts,
           "obs_records": len(back), "obs_jsonl": str(jsonl),
           "matrices": recs}
    phase(rec)
    return recs


def _tune_matrix(mid, rows, cache, budget, measured, api_mod,
                 real_search) -> dict:
    """One matrix of phase ``tune`` (see :func:`phase_tune`): ``measured``
    collects every measurement, ``api_mod.search`` is swapped for
    ``real_search`` with a recorder at m6."""
    import cProfile
    import functools

    import numpy as np
    import torch
    from repro_torch.core import loops_spmm, plan_and_convert, suite
    from repro_torch.perf import TraceRecorder
    from repro_torch.tune import (autotune, cache_key, feature_distance,
                                  fingerprint)

    def key_of(fp):
        return cache_key(fp, n_cols=MAIN_N, dtype=np.float32, backend="cuda")

    t0 = time.perf_counter()
    csr = suite.table2_like(mid, scale_rows=rows, seed=0, dtype=np.float32)
    gen_s = time.perf_counter() - t0
    rec = {"matrix": mid, "rows": rows, "nnz": csr.nnz, "generate_s": gen_s}

    # miss: the search, with a recorder at m6
    recorder = TraceRecorder(source=f"chip_smoke_tune_{mid}") \
        if mid == "m6" else None
    if recorder is not None:
        api_mod.search = functools.partial(real_search, recorder=recorder)
    n0, st0 = len(measured), lookup_counts(cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fmt, plan = autotune(csr, n_cols=MAIN_N, cache=cache, budget=budget,
                         device=DEVICE)
    torch.cuda.synchronize()
    rec["search_s"] = time.perf_counter() - t0
    api_mod.search = real_search
    trials = measured[n0:]
    fp = fingerprint(csr)
    stored = cache.peek(key_of(fp))
    check(lookup_counts(cache)["misses"] == st0["misses"] + 1,
          f"tune {mid}: the first autotune was not a miss")
    check(len(trials) == TUNE_TOP_K and stored["trials"] == TUNE_TOP_K,
          f"tune {mid}: {len(trials)} of {TUNE_TOP_K} survivors measured")
    check(all(g > 0 for _, g in trials), f"tune {mid}: a trial measured "
          "no throughput")
    best = max(trials, key=lambda t: t[1])
    check(best[0] == plan and stored["gflops"] == best[1],
          f"tune {mid}: the winner is not the best measured trial")
    rec.update({"trials": [{"plan": plan_dict(p), "gflops": g}
                           for p, g in trials],
                "winner": plan_dict(plan), "winner_gflops": best[1]})

    # exact hit: no measurement
    n0, st0 = len(measured), lookup_counts(cache)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fmt2, plan2 = autotune(csr, n_cols=MAIN_N, cache=cache, budget=budget,
                           device=DEVICE)
    prof.disable()
    rec["hit_s"] = time.perf_counter() - t0
    rec["hit_profile"] = host_profile(prof)
    check(len(measured) == n0 and plan2 == plan
          and lookup_counts(cache)["hits"] == st0["hits"] + 1,
          f"tune {mid}: the repeat autotune was not an exact hit without "
          "measurement")
    rec["hit_measurements"] = len(measured) - n0
    del fmt2

    # near hit: the same generator across a quantisation edge
    rows_near = near_rows(rows)
    csr_near = suite.table2_like(mid, scale_rows=rows_near, seed=0,
                                 dtype=np.float32)
    fp_near = fingerprint(csr_near)
    dist = feature_distance(fp.features(), fp_near.features())
    n0, st0 = len(measured), lookup_counts(cache)
    t0 = time.perf_counter()
    fmt_n, plan_n = autotune(csr_near, n_cols=MAIN_N, cache=cache,
                             budget=budget, device=DEVICE)
    rec["near_s"] = time.perf_counter() - t0
    promoted = cache.peek(key_of(fp_near))
    check(key_of(fp_near) != key_of(fp) and len(measured) == n0
          and lookup_counts(cache)["near_hits"] == st0["near_hits"] + 1
          and promoted is not None and promoted["plan"] == stored["plan"]
          and (plan_n.br, plan_n.panel_g, plan_n.macro_m, plan_n.t_vpu)
          == (plan.br, plan.panel_g, plan.macro_m, plan.t_vpu),
          f"tune {mid}: the matrix of {rows_near} rows (distance "
          f"{dist:.3f}) was not a promoted near hit")
    rec.update({"near_rows": rows_near, "near_distance": dist,
                "near_plan": plan_dict(plan_n)})
    del fmt_n, csr_near

    # the tuned product against the flat path and a second call, timed
    # beside the default plan's
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    b = torch.randn((csr.shape[1], MAIN_N), generator=gen, device=DEVICE)
    y = loops_spmm(fmt, b, device=DEVICE)
    again = loops_spmm(fmt, b, device=DEVICE)
    want = loops_spmm(fmt, b, device=DEVICE, backend="torch")
    absprod = loops_spmm(abs_format(fmt), b.abs(), device=DEVICE,
                         backend="torch")
    torch.cuda.synchronize()
    err, rel = sum_err(y, want, absprod)
    check(rel <= TOL["float32"], f"tune {mid}: tuned loops_spmm vs flat: "
          f"err {err:.3g}, {rel:.3g} of |A||B|")
    check(torch.equal(y, again), f"tune {mid}: two tuned calls differ")
    del y, again, want, absprod
    t0 = time.perf_counter()
    fmt_d, plan_d = plan_and_convert(csr, device=DEVICE)
    torch.cuda.synchronize()
    rec.update({"default_convert_s": time.perf_counter() - t0,
                "default_plan": plan_dict(plan_d),
                "tuned_ms": time_ms(lambda: loops_spmm(fmt, b, device=DEVICE)),
                "default_ms": time_ms(lambda: loops_spmm(fmt_d, b, device=DEVICE)),
                "tuned_max_abs_err": err, "tuned_max_err_of_absprod": rel,
                "bitwise_repeatable": True})
    del fmt_d

    if mid == "m6":
        rec.update(_tune_m6_extras(csr, fmt, b, cache, recorder, measured))
    del fmt, b
    torch.cuda.empty_cache()
    return rec


def _tune_m6_extras(csr, fmt, b, cache, recorder, measured) -> dict:
    """Phase tune at m6: the recorder's records, a search ranked by replay
    from them, and dB through the tuned transposed format."""
    import importlib

    import torch
    from repro_torch.core import loops_spmm
    from repro_torch.perf import TraceDB, replay
    from repro_torch.tune import SearchBudget, Tuner
    search_mod = importlib.import_module("repro_torch.tune.search")

    out = {}
    trial_recs = [r for r in recorder.records if r["kind"] == "search_trial"]
    check(len(trial_recs) == TUNE_TOP_K, f"tune m6: the recorder holds "
          f"{len(trial_recs)} search_trial records for {TUNE_TOP_K} trials")
    db = TraceDB(records=list(recorder.records))
    coef = db.step_cost("cuda")
    check(coef is not None, "tune m6: the trace records fit no step cost")
    n0 = len(measured)
    t0 = time.perf_counter()
    res = search_mod.search(csr, n_cols=MAIN_N, trace_db=db,
                            budget=SearchBudget(top_k=TUNE_REPLAY_TOP_K),
                            device=DEVICE)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    check(res.measured == TUNE_REPLAY_TOP_K
          and len(measured) - n0 == TUNE_REPLAY_TOP_K,
          f"tune m6: the replay search measured {res.measured}")
    out["replay_search"] = {
        "search_s": replay_s, "step_cost": [float(c) for c in coef],
        "trials": [{"plan": plan_dict(p), "gflops": g,
                    "replay_s": replay(p, db, csr=csr, n_cols=MAIN_N,
                                       backend="cuda")}
                   for p, g in res.trials],
        "winner": plan_dict(res.plan)}
    del res

    # dB = Aᵀ·dY through the transposed format the tuner planned
    tuner = Tuner(cache=cache, n_cols=MAIN_N, device=DEVICE,
                  budget=SearchBudget(top_k=TUNE_T_TOP_K))
    n0 = len(measured)
    t0 = time.perf_counter()
    tl = fmt.transposed(tuner=tuner)
    tl.fmt.on(DEVICE)
    torch.cuda.synchronize()
    out["transposed_tuned_s"] = time.perf_counter() - t0
    out["transposed_trials"] = len(measured) - n0
    # The backward pinned to the tuned plan files its own entry (one key
    # per call, as the reference's cache): one rebuild, timed here.
    t0 = time.perf_counter()
    tp = fmt.transposed(plan=tl.plan)
    out["transposed_pinned_s"] = time.perf_counter() - t0
    check(tp.plan == tl.plan, "tune m6: the pinned backward's Aᵀ has "
          f"plan {tp.plan}, not the tuned {tl.plan}")
    del tp
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    dy = torch.randn((csr.nrows, MAIN_N), generator=gen, device=DEVICE)
    bk = b.clone().requires_grad_(True)
    (db_k,) = torch.autograd.grad(
        loops_spmm(fmt, bk, device=DEVICE, transpose_plan=tl.plan), bk, dy)
    bf = b.clone().requires_grad_(True)
    (db_f,) = torch.autograd.grad(loops_spmm(fmt, bf, device=DEVICE, backend="torch"), bf,
                                  dy)
    with torch.no_grad():
        bnd = loops_spmm(abs_format(tl.fmt), dy.abs(), device=DEVICE,
                         backend="torch")
    out["transposed_plan"] = plan_dict(tl.plan)
    out["db"] = _grad_check("tune m6 dB through the tuned Aᵀ", db_k, db_f,
                            bnd, GCN_TOL)
    del bk, bf, db_k, db_f, bnd, dy
    return out


def host_profile(prof, top: int = 10) -> list:
    """The ``top`` functions of a ``cProfile`` run by cumulative seconds
    (host time; numpy's work counts in the caller that ran it)."""
    import pstats
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[3], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}:{k[2]}")
                   for k, v in stats.items()), reverse=True)
    return [{"fn": name, "cum_s": cum} for cum, name in rows[:top]]


def plan_dict(plan) -> dict:
    import dataclasses
    return dataclasses.asdict(plan)


def lookup_counts(cache) -> dict:
    """The plan cache's lookup buckets."""
    st = cache.stats
    return {"hits": st.hits, "near_hits": st.near_hits,
            "misses": st.misses}


# ---------------------------------------------------------------------------
# phase 5: the served GCN
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
# phase 6: GCN training (paper §4.5)
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
# phase 7: sparse-FFN training (llama3.2-1b MLP up-projection)
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
                     dev.csr.rows, dev.csr.cols, dev.csr.mask, dy3, b3,
                     blocks=dev.csr.sdd_blocks),
                 lambda d=dy3, b=b3: spmm_sdd.csr_sdd_panels_plain(
                     dev.csr.rows, dev.csr.cols, dev.csr.mask, d, b),
                 (0, r_b)),
                ("bcsr_sdd_panels", dev.bcsr, br, nrows_b,
                 lambda: spmm_sdd.bcsr_sdd_panels(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, dy3, b3,
                     br=br, row_offset=r_b, nrows=nrows_b,
                     units=dev.bcsr.units),
                 lambda d=dy3, b=b3: spmm_sdd.bcsr_sdd_panels_plain(
                     dev.bcsr.rows, dev.bcsr.cols, dev.bcsr.mask, d, b,
                     br=br, row_offset=r_b, nrows=nrows_b),
                 (r_b, fmt.nrows))):
            got = run()
            again = run()
            want = plain()
            absprod = plain(d=dy3.abs(), b=b3.abs())
            torch.cuda.synchronize()
            k_err, k_rel = sum_err(got, want, absprod)
            check(k_rel <= tol, f"train_ffn {dname} {name} vs plain: err "
                  f"{k_err:.3g}, {k_rel:.3g} of |dY||B| > {tol:g}")
            check(torch.equal(got, again), f"train_ffn {dname} {name}: two "
                  "calls differ")
            dy_rows = dy3[:, part_rows[0]:part_rows[1]].permute(
                1, 0, 2).reshape(part_rows[1] - part_rows[0], zn)
            lib, lib_what = library_sdd_ms(
                csr_slice_rows(csr, *part_rows), dy_rows, bt, dt)
            kernels[name] = {
                "ms": time_ms(run),
                "plain_ms": time_ms(plain, samples=3, reps=1, warmup=1),
                "library_ms": lib, "library": lib_what,
                "max_abs_err": k_err, "max_err_of_absprod": k_rel,
                "bitwise_repeatable": True,
                "npanels": int(panels.rows.numel()),
                **sdd_bound(panels, dy3, b3, got, br=kbr, dy_rows=rows,
                            dtype=dname)}
            if name == "csr_sdd_panels":
                kernels[name].update(block_counts(panels.sdd_blocks))
            kernels[name].update(rate(kernels[name]))
            del got, again, want, absprod, dy_rows
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
# phase 8: serving llama3.2-1b at full width
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


def rate(rec: dict) -> dict:
    """``tflops`` (the record's flops over its ``ms``) and
    ``share_of_bound`` (``bound_ms`` over ``ms``)."""
    return {"tflops": rec["flops"] / rec["ms"] / 1e9,
            "share_of_bound": rec["bound_ms"] / rec["ms"]}


def _lm_logits_err(name: str, got, want) -> float:
    """Check fp32 logits against the reference path's at ``LM_TOL``;
    returns the error relative to max(1, max |want|)."""
    import torch
    err, scale = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= LM_TOL * scale,
          f"{name}: max |diff| {err:.3g} > {LM_TOL:g} * {scale:.3g}")
    return err / scale


def _b5_alone(dt) -> dict:
    """B5 at the serving shape on seeded tensors, causal: its time, its
    plain version's, ``scaled_dot_product_attention``'s on the same tensors
    (the yardstick; the port never calls it), its error against the plain
    version, and its bound; under ``"variants"`` the same at the serving
    batch without the causal mask and at hd 128 (16 heads, 4 kv-heads)."""
    _, _, heads, kv, hd = FLASH_SHAPES[-1]
    rec = _b5_timed(dt, heads, kv, hd, True, plain=True)
    rec["variants"] = [_b5_timed(dt, heads, kv, hd, False),
                       _b5_timed(dt, heads // 2, kv // 2, 2 * hd, True)]
    return rec


def _b5_timed(dt, heads: int, kv: int, hd: int, causal: bool, *,
              plain: bool = False) -> dict:
    """One B5 record of :func:`_b5_alone` at (LM_BATCH, LM_PROMPT, heads,
    hd); the plain version is timed only when ``plain``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as b5
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    q = torch.randn((LM_BATCH, LM_PROMPT, heads, hd), generator=gen,
                    device=DEVICE).to(dt)
    k = torch.randn((LM_BATCH, LM_PROMPT, kv, hd), generator=gen,
                    device=DEVICE).to(dt)
    v = torch.randn((LM_BATCH, LM_PROMPT, kv, hd), generator=gen,
                    device=DEVICE).to(dt)
    got = b5.flash_attention(q, k, v, causal=causal)
    want = b5.flash_attention_plain(q, k, v, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    lib = sdpa().transpose(1, 2)
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    dname = str(dt).replace("torch.", "")
    rerr = row_err(got, want)
    check(err <= FLASH_TOL[dname] * scale and rerr <= FLASH_ROW_TOL[dname],
          f"flash_attention alone {tuple(q.shape)} causal={causal}: err "
          f"{err:.3g}, row err {rerr:.3g}")
    lib_err, _ = max_err(lib, want)
    rec = {"dtype": str(dt), "shape": list(q.shape), "kv_heads": kv,
           "causal": causal,
           "ms": time_ms(lambda: b5.flash_attention(q, k, v, causal=causal)),
           "plain_ms": time_ms(lambda: b5.flash_attention_plain(
               q, k, v, causal=causal), samples=3, reps=1, warmup=1)
           if plain else None,
           "library_ms": time_ms(sdpa),
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      f"is_causal={causal}, enable_gqa=True)",
           "library_max_abs_err_vs_plain": lib_err,
           "max_abs_err": err, "max_err_rel": err / scale,
           "max_row_err": rerr, "library_max_row_err": row_err(lib, want),
           "mean_abs_plain": float(want.double().abs().mean()),
           **flash_bound(q, k, causal=causal)}
    rec.update(rate(rec))
    return rec


def _wall_ms(fn) -> float:
    """Host-clock milliseconds of one call of ``fn`` that ends in a copy
    to the host (which waits for the device)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def phase_serve_lm(launches: dict) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.queue import (DEFAULT_LEN_QUANTUM, ExecutorPool,
                                         ServeQueue, pad_cache)
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
    # The pool's bucket for the served group (the queue rounds the budget
    # up to its quantum), warmed before traffic: its slot's prefill and
    # decode graphs are captured here, outside the counts.
    max_len = LM_PROMPT + -(-LM_GEN // DEFAULT_LEN_QUANTUM) * \
        DEFAULT_LEN_QUANTUM
    pool = ExecutorPool(cfg, params)
    t0 = time.perf_counter()
    pool.warm([(LM_BATCH, LM_PROMPT, max_len)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    bucket = pool.bundle(LM_BATCH, LM_PROMPT, max_len)
    check(len(pool) == 1 and pool.slots == 1,
          f"serve_lm: warm() built {len(pool)} buckets, {pool.slots} slots")

    queue = ServeQueue(cfg, params, config=SchedulerConfig(max_batch=8),
                       pool=pool)
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
              f"prefill replays (expected {want})")
    check(n_prefill == 1 and len(done) == LM_BATCH and pool.slots == 1,
          f"serve_lm: {len(done)} of {LM_BATCH} requests in {n_prefill} "
          f"prefill calls, {pool.slots} slots")
    served = np.array([r.tokens for r in reqs])
    check(served.shape == (LM_BATCH, LM_GEN) and served.min() >= 0
          and served.max() < cfg.vocab_size,
          f"serve_lm: tokens {served.shape} in [{served.min()}, "
          f"{served.max()}]")
    # allocated: live tensors (static caches, graph outputs); reserved:
    # also the graph pool's and the allocator's cached blocks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    decode_ms = [s * 1e3 for s in queue.engine_s["decode"]]
    prefill_ms = [s * 1e3 for s in queue.engine_s["prefill"]]
    n_tokens = int(served.size)

    # bf16, teacher-forced with the served tokens: the greedy tokens of the
    # eager path (B5, one launch per operation, as the queue ran before the
    # pool), which must equal the served (graphed) ones, and of the plain
    # attention path (their share of agreement).
    prompts_t = torch.as_tensor(prompts, device=DEVICE)
    served_t = torch.as_tensor(served, device=DEVICE)

    def greedy(backend):
        cache, logits = api.prefill(cfg, params, {"tokens": prompts_t},
                                    backend=backend)
        toks = [logits[:, :cfg.vocab_size].argmax(-1)]
        cache = pad_cache(cfg, cache, max_len)
        for i in range(LM_GEN - 1):
            cache, logits = api.decode_step(
                cfg, params, cache, served_t[:, i:i + 1], LM_PROMPT + i)
            toks.append(logits[:, :cfg.vocab_size].argmax(-1))
        return torch.stack(toks, 1) == served_t
    same_eager = greedy(None)
    agree_eager = float(same_eager.float().mean())
    check(bool(same_eager.all()), f"serve_lm: the graphed streams differ "
          f"from the eager path's (agreement {agree_eager:.4f})")
    before = _read_counts()
    agree = float(greedy("torch").float().mean())
    check(_read_counts() == before, "serve_lm: the plain path launched a "
          "kernel")

    # Graphed against eager at the bucket's shapes and on the slot's cache,
    # in turns: prefill (3 each), then every decode position of the run.
    slot = pool.acquire(bucket)
    prefill_g, prefill_e, decode_g, decode_e = [], [], [], []
    for _ in range(3):
        prefill_g.append(_wall_ms(lambda: slot.prefill_fn(
            {"tokens": prompts})[1].cpu()))
        prefill_e.append(_wall_ms(lambda: api.prefill(cfg, params, {
            "tokens": torch.as_tensor(prompts, device=DEVICE)})[1].cpu()))
    slot.prefill_fn({"tokens": prompts})
    for i in range(LM_GEN - 1):
        tok = served[:, i:i + 1]
        decode_g.append(_wall_ms(lambda: slot.serve_fn(
            tok, LM_PROMPT + i)[1].cpu()))
        decode_e.append(_wall_ms(lambda: api.decode_step(
            cfg, params, slot.cache, torch.as_tensor(tok, device=DEVICE),
            LM_PROMPT + i)[1].cpu()))
    # One prefill call's and one decode step's kernels by device time (B5's
    # share of the prefill; the device's idle share of a decode step,
    # eager and replayed).
    profile = profile_step(lambda: api.prefill(cfg, params,
                                               {"tokens": prompts_t}))
    b5_share = sum(r["device_ms"] for r in profile["top"]
                   if "flash_wgmma_kernel" in r["name"]
                   or "flash_fwd_kernel" in r["name"])
    last = served[:, -1:]
    profile_dec = profile_step(lambda: api.decode_step(
        cfg, params, slot.cache, torch.as_tensor(last, device=DEVICE),
        LM_PROMPT + LM_GEN - 1))
    profile_rep = profile_step(lambda: slot.serve_fn(
        last, LM_PROMPT + LM_GEN - 1))
    pool.release(bucket, slot)
    pool_rec = {"warm_s": warm_s, "buckets": len(pool), "builds": pool.builds,
                "slots": pool.slots, "build_s": pool.build_s}
    del queue, pool, slot, params
    torch.cuda.empty_cache()

    # fp32: logits through B5 and through the plain path, teacher-forced;
    # the graphed prefill and decode steps against the eager ones; decode
    # against prefill of one more token (S + 1 = 2049: B5's ragged edge).
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
    pool32 = ExecutorPool(cfg32, params32)
    b32 = pool32.bundle(1, LM_PROMPT, LM_PROMPT + LM_CHECK_STEPS)
    slot32 = pool32.acquire(b32)
    n0 = _kernel_fns()["flash_attention"].launches
    graph_outs = [slot32.prefill_fn({"tokens": toks})[1].clone()]
    graph_outs += [slot32.serve_fn(teacher[:, i:i + 1],
                                   LM_PROMPT + i)[1].clone()
                   for i in range(LM_CHECK_STEPS)]
    check(_kernel_fns()["flash_attention"].launches == n0 + layers,
          "serve_lm fp32: the graphed prefill did not count B5 once a layer")
    kernel_outs = run(None)
    check(_kernel_fns()["flash_attention"].launches == n0 + 2 * layers,
          "serve_lm fp32: the kernel path did not launch B5 once a layer")
    plain_outs = run("torch")
    torch.cuda.synchronize()
    step_errs = [_lm_logits_err(f"serve_lm fp32 logits step {i}", g, w)
                 for i, (g, w) in enumerate(zip(kernel_outs, plain_outs))]
    graph_errs = [_lm_logits_err(f"serve_lm fp32 graphed step {i}", g, w)
                  for i, (g, w) in enumerate(zip(graph_outs, kernel_outs))]
    _, longer = api.prefill(cfg32, params32, {"tokens": torch.cat(
        [toks, teacher[:, :1]], 1)})
    dec_err = _lm_logits_err("serve_lm fp32 decode(S) vs prefill(S+1)",
                             kernel_outs[1], longer)
    del params32, kernel_outs, plain_outs, graph_outs, longer, pool32, slot32
    torch.cuda.empty_cache()

    alone = _b5_alone(torch.bfloat16)
    alone_fp32 = _b5_alone(torch.float32)
    med = statistics.median
    rec = {"phase": "serve_lm", "arch": LM_ARCH, "params": n_params,
           "dtype": "bfloat16", "layers": layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "vocab": cfg.vocab_size, "requests": LM_BATCH,
           "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
           "bf16_reduced_precision_reduction": False,
           "init_s": init_s, "pool": pool_rec, "serve_s": serve_s,
           "prefill_calls": n_prefill,
           "prefill_ms": prefill_ms,
           "decode_steps": len(decode_ms),
           "decode_ms_median": med(decode_ms),
           "decode_ms": decode_ms,
           "ttft_ms": [r.wall_ttft_s * 1e3 for r in reqs],
           "tokens": n_tokens, "tokens_per_s": n_tokens / serve_s,
           "decode_tokens_per_s": LM_BATCH / (med(decode_ms) / 1e3),
           "peak_mem_gb": peak_gb, "peak_reserved_gb": peak_reserved_gb,
           "launches": counts,
           "graphed_vs_eager": {
               "prefill_ms": prefill_g, "eager_prefill_ms": prefill_e,
               "prefill_ms_median": med(prefill_g),
               "eager_prefill_ms_median": med(prefill_e),
               "decode_ms": decode_g, "eager_decode_ms": decode_e,
               "decode_ms_median": med(decode_g),
               "eager_decode_ms_median": med(decode_e)},
           "streams_equal_eager_bf16": True,
           "greedy_agreement_bf16_vs_eager": agree_eager,
           "greedy_agreement_bf16_vs_plain": agree,
           "fp32_logits_err_rel": step_errs,
           "fp32_graphed_vs_eager_err_rel": graph_errs,
           "fp32_decode_vs_prefill_err_rel": dec_err,
           "b5_alone": alone, "b5_alone_fp32": alone_fp32,
           "profiled_prefill": profile,
           "profiled_prefill_b5_device_ms": b5_share,
           "profiled_decode_step": profile_dec,
           "profiled_decode_replay": profile_rep}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 9: the launcher with --obs (obs/, the plan-cache warm-up, faults)
# ---------------------------------------------------------------------------

def _obs_value(recs, kind, metric, /, **labels):
    """A metric's value (a histogram's count) in a loaded capture, 0 when
    absent."""
    for r in recs:
        if r["kind"] == kind and r["metric"] == metric \
                and r["labels"] == {k: str(v) for k, v in labels.items()}:
            return r["count"] if kind == "hist" else r["value"]
    return 0


def _served(queue) -> dict:
    """Tokens and wall-clock numbers of a finished launcher run."""
    reqs = sorted(queue.completed, key=lambda r: r.rid)
    n_tokens = sum(r.tokens_generated for r in reqs)
    span = max(r.wall_finish_s for r in reqs) - min(r.wall_arrival_s
                                                    for r in reqs)
    return {"tokens": [list(map(int, r.tokens)) for r in reqs],
            "prefill_ms": [t * 1e3 for t in queue.engine_s["prefill"]],
            "decode_ms_median": statistics.median(
                queue.engine_s["decode"]) * 1e3,
            "ttft_ms": [r.wall_ttft_s * 1e3 for r in reqs],
            "tokens_per_s": n_tokens / span, "prefill_calls":
            queue.sched.counters["prefill_batches"],
            "decode_calls": len(queue.engine_s["decode"]),
            "pool_buckets": len(queue.pool), "pool_slots": queue.pool.slots}


def _warm_csr(w):
    """``warm_spmm_plan_cache``'s pruned CSR of one ``wi``ᵀ (host fp32)."""
    from repro_torch.core.formats import csr_from_dense
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.models.sparse_ffn import magnitude_prune
    from repro_torch.resilience.validate import validate_csr
    sparsity = warm_spmm_plan_cache.__kwdefaults__["sparsity"]
    csr, _ = validate_csr(csr_from_dense(magnitude_prune(w, sparsity)),
                          repair="drop")
    return csr


def _warm_key(csr) -> str:
    """The warm-up's plan-cache key of ``csr``."""
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.tune import cache_key, fingerprint
    n_cols = warm_spmm_plan_cache.__kwdefaults__["n_cols"]
    return cache_key(fingerprint(csr), n_cols=n_cols, dtype=csr.vals.dtype,
                     backend="cuda")


def _pool_plan_check(csr, rec) -> dict:
    """``csr`` converted with the serving pool's plan ``rec``, its
    ``loops_spmm`` on the card at the warm-up's N against the flat path at
    ``TOL`` of |A|·|B| and against a second call (bitwise equal); each
    kernel of the plan's parts must launch in both calls."""
    import torch
    from repro_torch.core import loops_spmm
    from repro_torch.core.formats import loops_from_csr
    from repro_torch.launch.serve import warm_spmm_plan_cache
    from repro_torch.tune import plan_from_record

    n_cols = warm_spmm_plan_cache.__kwdefaults__["n_cols"]
    plan = plan_from_record(rec, csr.nrows)
    fmt = loops_from_csr(csr, plan.r_boundary, plan.br, panel_g=plan.panel_g,
                         macro_m=plan.macro_m,
                         pipeline_depth=plan.pipeline_depth)
    fmt.on(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    b = torch.randn((csr.ncols, n_cols), generator=gen, device=DEVICE)
    _reset_counts()
    y = loops_spmm(fmt, b, device=DEVICE)
    again = loops_spmm(fmt, b, device=DEVICE)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = loops_spmm(fmt, b, device=DEVICE, backend="torch")
    absprod = loops_spmm(abs_format(fmt), b.abs(), device=DEVICE,
                         backend="torch")
    err, rel = sum_err(y, want, absprod)
    check(rel <= TOL["float32"], f"serve_obs: loops_spmm at the pool's plan "
          f"vs flat: err {err:.3g}, {rel:.3g} of |A||B| > {TOL['float32']:g}")
    check(torch.equal(y, again), "serve_obs: two loops_spmm calls at the "
          "pool's plan differ")
    for k, rows in (("csr_panels_spmm", plan.r_boundary),
                    ("bcsr_panels_spmm", csr.nrows - plan.r_boundary)):
        check(counts[k] == (2 if rows else 0), f"serve_obs: {k} launched "
              f"{counts[k]} times in two calls at {rows} rows of its part")
    return {"plan": plan_dict(plan), "n_cols": n_cols, "nnz": csr.nnz,
            "launches": {k: v for k, v in counts.items() if v},
            "max_abs_err": err, "max_err_of_absprod": rel,
            "bitwise_repeatable": True}


def phase_serve_obs(launches: dict, lm_rec: dict, out_dir,
                    work_dir) -> dict:
    """``python -m repro_torch.launch.serve --obs`` at phase serve_lm's
    model and batch (16 generated tokens): the plan-cache warm-up (layer 0
    searches, layers 1-15 hit; B1/B2 launch in its trials and validation
    SpMMs for the parts the plans have, every launch seen by a capture;
    the pool installs each distinct key once, a second warm-up none), the
    capture's histograms against the requests and calls, the tokens
    against a run without obs, and a run with one injected ``serve.step``
    fault (retried, counted, the same tokens); then layer 0's
    ``loops_spmm`` at the pool's plan against the flat path
    (:func:`_pool_plan_check`).  The plan caches live in ``work_dir``; the
    captures go to ``out_dir``, else ``work_dir``."""
    import os

    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import Obs, load_obs
    from repro_torch.resilience import inject

    os.environ["REPRO_TUNE_CACHE"] = str(pathlib.Path(work_dir) / "serve")
    cap_dir = pathlib.Path(out_dir or work_dir)
    argv = ["--arch", LM_ARCH, "--device", DEVICE, "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen-len", str(OBS_GEN),
            "--seed", str(LM_SEED), "--max-batch", "8", "--obs-dir",
            str(cap_dir)]
    _reset_counts()

    # 1. --obs: the warm-up, then serving under the capture
    t0 = time.perf_counter()
    q_obs = launch_serve.main(argv + ["--obs", "chip_smoke_serve_obs"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    recs = load_obs(cap_dir / "chip_smoke_serve_obs.jsonl")
    cfg = q_obs.cfg
    layers = cfg.num_layers
    served_obs = _served(q_obs)
    warm_spans = [r for r in recs if r["kind"] == "span"
                  and r["name"] == "serve.warm_plan"]
    warm = {k: _obs_value(recs, "gauge", f"tune.cache.{k}",
                          cache="serve-warm")
            for k in ("hits", "near_hits", "misses", "hit_rate")}
    installed = _obs_value(recs, "gauge", "serve.prewarmed_plans")
    check(len(warm_spans) == layers and warm["misses"] == 1
          and warm["hits"] + warm["near_hits"] == layers - 1,
          f"serve_obs: warm-up lookups {warm} over {layers} layers")
    check(installed >= 1 and _obs_value(
        recs, "gauge", "tune.cache.prewarmed", cache="serve-pool")
        == installed, f"serve_obs: the pool installed {installed}")
    n_req, n_pre = LM_BATCH, served_obs["prefill_calls"]
    n_dec = served_obs["decode_calls"]
    hists = {m: _obs_value(recs, "hist", m) for m in (
        "serve.prefill_us", "serve.ttft_us", "serve.request_us",
        "serve.decode_token_us")}
    check(hists["serve.prefill_us"] == hists["serve.ttft_us"]
          == hists["serve.request_us"] == n_req
          and hists["serve.decode_token_us"] == n_req * (OBS_GEN - 1)
          and _obs_value(recs, "hist", "step.wall_us", op="prefill") == n_pre
          and _obs_value(recs, "hist", "step.wall_us", op="decode") == n_dec
          and _obs_value(recs, "counter", "serve.requests") == n_req
          and _obs_value(recs, "counter", "serve.prefill_calls") == n_pre
          and _obs_value(recs, "counter", "serve.decode_calls") == n_dec,
          f"serve_obs: histograms {hists} against {n_req} requests, "
          f"{n_pre} prefill and {n_dec} decode calls")
    check(len(served_obs["tokens"]) == n_req
          and all(len(t) == OBS_GEN for t in served_obs["tokens"]),
          "serve_obs: not every request got its tokens")

    # 2. a second warm-up into the same pool installs nothing
    warm2 = Obs(source="chip_smoke_rewarm")
    t0 = time.perf_counter()
    with warm2.attach_engine():
        pool = launch_serve.warm_spmm_plan_cache(cfg, q_obs.params, warm2)
    torch.cuda.synchronize()
    rewarm_s = time.perf_counter() - t0
    pool_plans = [rec["plan"] for rec in pool._load().values()]
    # layer 0's wiᵀ and the pool's record of it, for the check of B1/B2 at
    # this path's plan and shapes below
    w0 = q_obs.params.layers[0].mlp.wi.detach().float().cpu().numpy().T
    csr0 = _warm_csr(w0)
    rec0 = pool.peek(_warm_key(csr0))
    check(rec0 is not None, "serve_obs: the pool holds no plan for layer 0")
    re_stats = {r["metric"]: r["value"] for r in warm2.records()
                if r["kind"] == "gauge"
                and r["labels"].get("cache") == "serve-warm"}
    check(pool.stats.prewarmed == 0
          and warm2.metrics.find("gauge", "serve.prewarmed_plans").value == 0
          and re_stats["tune.cache.misses"] == 0,
          f"serve_obs: the second warm-up installed {pool.stats.prewarmed}, "
          f"lookups {re_stats}")
    del q_obs, pool
    torch.cuda.empty_cache()

    # 3. the same run without obs (and without the warm-up): same tokens
    q_plain = launch_serve.main(argv)
    served_plain = _served(q_plain)
    check(served_plain["tokens"] == served_obs["tokens"],
          "serve_obs: the tokens with obs differ from those without")
    del q_plain
    torch.cuda.empty_cache()

    # 4. one injected serve.step fault: retried, counted, same tokens
    os.environ[inject.ENV_VAR] = OBS_FAULT_PLAN
    try:
        q_fault = launch_serve.main(argv + ["--obs", "chip_smoke_serve_fault",
                                            "--no-warm-spmm-cache"])
    finally:
        del os.environ[inject.ENV_VAR]
        inject.set_plan(None)
    served_fault = _served(q_fault)
    recs_f = load_obs(cap_dir / "chip_smoke_serve_fault.jsonl")
    retries = _obs_value(recs_f, "counter", "serve.retries")
    fired = _obs_value(recs_f, "counter", "inject.fired", site="serve.step",
                       kind="raise")
    check(retries == 1 and fired == 1
          and served_fault["tokens"] == served_obs["tokens"],
          f"serve_obs: the injected fault gave {retries} retries, {fired} "
          "fired faults, or other tokens")
    del q_fault
    torch.cuda.synchronize()
    counts = _read_counts()
    runs = n_pre + served_plain["prefill_calls"] + \
        served_fault["prefill_calls"]
    # each launcher run's pool built its slot on first need: one eager
    # prefill before the captures, then a replay per prefill call
    slots = served_obs["pool_slots"] + served_plain["pool_slots"] + \
        served_fault["pool_slots"]
    # B1/B2 run in the two warm-ups only (the trials and the validation
    # SpMMs), for the parts their plans have; the captures saw each launch.
    warm_disp = {part: _obs_value(recs, "counter", "engine.dispatch",
                                  backend="cuda", impl="panels", op="spmm",
                                  part=part)
                 + _dispatches(warm2)[part] for part in ("csr", "bcsr")}
    check(counts["csr_panels_spmm"] + counts["bcsr_panels_spmm"] > 0,
          "serve_obs: the warm-up launched no LOOPS kernel")
    for k, v in counts.items():
        launches[k] += v
        if k == "flash_attention":
            check(v == layers * (runs + slots), f"serve_obs: B5 launched "
                  f"{v} times for {runs} prefill calls and {slots} slots")
        elif k in ("csr_panels_spmm", "bcsr_panels_spmm"):
            part = k.split("_")[0]
            check(v == warm_disp[part], f"serve_obs: {k} launched {v} "
                  f"times, the warm-ups dispatched {warm_disp[part]}")
        else:
            check(v == 0, f"serve_obs: {k} launched {v} times off its path")
    # B1/B2 at this path's plan and N against the plain version (after the
    # counts are read: a comparison is no launch of the path)
    pool_check = _pool_plan_check(csr0, rec0)
    del csr0, w0
    rec = {"phase": "serve_obs", "arch": LM_ARCH, "requests": LM_BATCH,
           "prompt_len": LM_PROMPT, "gen_len": OBS_GEN, "layers": layers,
           "run_s": run_s, "warm_s": sum(r["dur"] for r in warm_spans) / 1e6,
           "warm_layer_s": [r["dur"] / 1e6 for r in warm_spans],
           "warm_lookups": warm, "pool_installed": installed,
           "pool_plans": pool_plans, "pool_plan_check": pool_check,
           "warm_dispatches": warm_disp,
           "rewarm_s": rewarm_s, "rewarm_lookups": re_stats,
           "histogram_counts": hists, "launches": counts,
           "with_obs": {k: v for k, v in served_obs.items() if k != "tokens"},
           "without_obs": {k: v for k, v in served_plain.items()
                           if k != "tokens"},
           "with_fault": {k: v for k, v in served_fault.items()
                          if k != "tokens"},
           "fault_plan": OBS_FAULT_PLAN, "retries": retries,
           "serve_lm": {k: lm_rec[k] for k in (
               "prefill_ms", "ttft_ms", "tokens_per_s", "decode_ms_median",
               "gen_len")},
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi"),
           "pool_slots_built": slots, "tokens_equal": True}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 10: the closed-loop serving load (batched against sequential)
# ---------------------------------------------------------------------------

TRAFFIC_KEYS = ("n_requests", "completed", "rejected", "evicted",
                "prefill_batches", "decode_steps", "engine_calls",
                "padded_slots", "tokens", "goodput_tok_s", "p50_ms",
                "p99_ms", "ttft_p50_ms", "ttft_p99_ms", "wall_s")


def phase_serve_traffic(launches: dict) -> dict:
    """``repro_torch.benchmarks.serve_traffic.main`` at phase serve_lm's
    model (full width, bf16), the reference's shapes and load (6 clients x
    3 rounds), both modes, two passes each through one pool; then two
    requests of one bucket in flight at once (max_batch 1, max_in_flight
    2), which must take two slots and emit what each emits alone."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import serve_traffic
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.queue import ExecutorPool, ServeQueue
    from repro_torch.serve.scheduler import SchedulerConfig

    cfg = get_config(LM_ARCH)
    layers = cfg.num_layers
    records, lines = [], []
    _reset_counts()
    t0 = time.perf_counter()
    res = serve_traffic.main(out=lines.append, record=records.append,
                             arch=LM_ARCH, reduced=False, device=DEVICE)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = _read_counts()
    b, s = res["batched"], res["sequential"]
    for mode, r in (("batched", b), ("sequential", s)):
        check(r["completed"] == r["n_requests"] and not r["rejected"],
              f"serve_traffic {mode}: {r['completed']} of {r['n_requests']} "
              f"requests completed, {r['rejected']} rejected")
    check(b["engine_calls"] <= s["engine_calls"], f"serve_traffic: batched "
          f"{b['engine_calls']} engine calls > sequential {s['engine_calls']}")
    # two passes a mode, the same schedule each (a pure function of the
    # seed); one eager prefill per slot before its captures
    prefills = 2 * (b["prefill_batches"] + s["prefill_batches"])
    slots = res["pool"]["slots"]
    for k, v in counts.items():
        launches[k] += v
        want = layers * (prefills + slots) if k == "flash_attention" else 0
        check(v == want, f"serve_traffic: {k} launched {v} times for "
              f"{prefills} prefill calls and {slots} slots")

    # Two groups of one bucket in flight at once.
    params = api.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED),
        device=DEVICE)
    rng = np.random.default_rng(LM_SEED + 2)
    prompts = rng.integers(0, cfg.vocab_size, (2, 32)).tolist()
    pool = ExecutorPool(cfg, params)

    def drive(in_flight, rows):
        q = ServeQueue(cfg, params, pool=pool, config=SchedulerConfig(
            max_in_flight=in_flight, max_batch=1, min_batch=1,
            max_wait_s=0.0))
        reqs = [q.submit(p, 8, now=0.0) for p in rows]
        t = 0.0
        while q.pending and q.step(now=t):
            t += 1.0
        return [r.tokens for r in reqs]
    both = drive(2, prompts)
    check(pool.slots == 2 and pool.peak_in_use == 2 and len(pool) == 1,
          f"serve_traffic: two groups of one bucket took {pool.slots} slots "
          f"of {len(pool)} buckets (peak {pool.peak_in_use} at once)")
    alone = [drive(1, [p])[0] for p in prompts]
    check(alone == both and all(len(t) == 8 for t in both),
          "serve_traffic: two groups in flight emitted other tokens than "
          "each alone")
    del params, pool
    torch.cuda.empty_cache()
    rec = {"phase": "serve_traffic", "arch": LM_ARCH, "dtype": "bfloat16",
           "shapes": serve_traffic.SHAPES, "clients": 6, "rounds": 3,
           "main_s": main_s, "lines": lines,
           "modes": {m: {k: res[m][k] for k in TRAFFIC_KEYS}
                     for m in ("batched", "sequential")},
           "pool": res["pool"], "launches": counts,
           "prefill_calls": prefills,
           "batched_peak_in_use": res["pool"]["peak_in_use"],
           "two_slot_run": {"slots": 2, "peak_in_use": 2,
                            "tokens_equal_alone": True},
           "nvidia_smi": RECORD["phases"][0].get("nvidia_smi")}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 11: the paper's operator evaluation
# ---------------------------------------------------------------------------

def _bench_run(out_dir) -> dict:
    """``python -m repro_torch.benchmarks.run --smoke`` on the card, in a
    process of its own (its serve_traffic suite runs B5, which is not on
    this phase's path, so its launches stay out of this process's counts),
    with a fresh plan cache; its records validated against the port's
    schema and gated against the committed CPU baseline with the wall
    columns off, so the exact columns are equal on the card and on the
    CPU."""
    import os
    from repro_torch.benchmarks import perf_gate
    from repro_torch.perf import schema
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TUNE_CACHE"}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--smoke",
         "--out", str(out_dir)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"benchmarks.run --smoke exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    current = pathlib.Path(out_dir) / "bench.json"
    records = json.loads(current.read_text())
    probs = schema.validate(records, {"$ref": "#/definitions/bench_file"},
                            schema.load_schema(perf_gate.SCHEMA_PATH))
    check(not probs, f"benchmarks.run --smoke records: {probs[:3]}")
    fails = perf_gate.run_gate(perf_gate.DEFAULT_BASELINE, current,
                               wall_tol=float("inf"))
    check(not fails, f"perf_gate against the CPU baseline: {fails[:3]}")
    return {"s": run_s, "records": len(records),
            "baseline": str(perf_gate.DEFAULT_BASELINE.relative_to(ROOT)),
            "gate": "OK (wall columns off)",
            "lines": [ln for ln in proc.stdout.splitlines()
                      if ln.count(",") >= 2]}


def _fig4_published(lines) -> list:
    """Fig. 4 at the published sizes (``fig4_throughput.published_rows``),
    N = 32, fp32 and ``FIG4_DTYPES``: the deterministic plan, each
    ``loops_spmm`` checked against the flat path and timed beside it,
    cuSPARSE and dense cuBLAS (or None with its reason)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import fig4_throughput as f4
    from repro_torch.benchmarks._util import time_fn
    from repro_torch.core import loops_spmm, suite
    out = []
    for mid in f4.MATRICES:
        rows, cut = f4.published_rows(mid)
        t0 = time.perf_counter()
        base = suite.table2_like(mid, scale_rows=rows, seed=3,
                                 dtype=np.float64)
        gen_s = time.perf_counter() - t0
        for dname in FIG4_DTYPES:
            dt = getattr(torch, dname)
            csr = base if dname == "float64" else base.astype(np.float32)
            gen = torch.Generator(device=DEVICE).manual_seed(3)
            b = torch.randn((csr.shape[1], f4.N), generator=gen,
                            device=DEVICE, dtype=dt)
            t0 = time.perf_counter()
            fmt, plan = f4.calibrated_plan(csr, b, deterministic=True)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            name_dt = {"float32": "fp32", "float64": "fp64"}[dname]
            res = f4.measure(csr, fmt, b, name_dt=name_dt)
            cell = {"matrix": mid, "name": suite.TABLE2_STATS[mid].name,
                    "rows": rows, "reduced": cut, "nnz": csr.nnz,
                    "dtype": dname, "r_boundary": plan.r_boundary,
                    "br": plan.br, "panel_g": plan.panel_g,
                    "generate_s": gen_s, "plan_s": plan_s, **res}
            if (mid, dname) == FIG4_CALIBRATED:
                # The calibrated plan once: its probes re-convert A.
                t0 = time.perf_counter()
                fmt_c, plan_c = f4.calibrated_plan(csr, b)
                torch.cuda.synchronize()
                cell["calibrated"] = {
                    "plan_s": time.perf_counter() - t0,
                    "r_boundary": plan_c.r_boundary,
                    "us_per_call": 1e6 * time_fn(
                        lambda: loops_spmm(fmt_c, b, device=DEVICE),
                        device=DEVICE)}
                del fmt_c
            lines.append(f"fig4 {mid} {dname}: {res['us_per_call']:.1f} us, "
                         f"cuSPARSE {res['cusparse_us']:.1f} us")
            out.append(cell)
            del fmt, b
            torch.cuda.empty_cache()
    return out


def phase_operator_bench(launches: dict, out_dir) -> dict:
    """The paper's operator evaluation on the card: the smoke run and its
    gate (``_bench_run``), Fig. 4 at the published sizes, the batched
    suite at pwtk's size (each strategy's launches in one call), Table 4
    with ogbn-arxiv's row, §4.3 at ``SEC43_ROWS`` rows and the autotune
    suite.  Only B1 and B2 may launch in it."""
    import os
    import numpy as np
    import torch
    from repro_torch.benchmarks import (autotune_suite, batched_spmm,
                                        sec43_scheduling, table4_gnn)
    from repro_torch.core import suite

    os.environ.pop("REPRO_TUNE_CACHE", None)   # the suite's own temp cache
    rec = {"phase": "operator_bench", "seconds": {}}
    secs = rec["seconds"]
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        rec["smoke"] = _bench_run(pathlib.Path(out_dir or tmp) / "bench")
    secs["smoke"] = rec["smoke"]["s"]

    _reset_counts()
    lines = []
    t0 = time.perf_counter()
    rec["fig4"] = _fig4_published(lines)
    secs["fig4"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m6 = suite.table2_like("m6", scale_rows=200_000, seed=3)
    fmt, fmt_piped = batched_spmm.formats(m6, DEVICE)
    batched = batched_spmm.run_matrix(
        fmt, fmt_piped, BATCHED_BATCHES, rng=np.random.default_rng(0),
        out=lines.append, device=DEVICE)
    # Each strategy's launches in one call, forward and forward+backward
    # (dB on Aᵀ, built by the suite's first backward).
    tl = fmt.transposed()
    fwd_parts = {"csr_panels_spmm": int(fmt.r_boundary > 0),
                 "bcsr_panels_spmm": int(fmt.r_boundary < fmt.nrows)}
    bwd_parts = {k: v + int(tl.fmt.r_boundary > 0 if k.startswith("csr")
                            else tl.fmt.r_boundary < tl.fmt.nrows)
                 for k, v in fwd_parts.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    per_call = {}
    for batch in BATCHED_BATCHES:
        b3 = torch.randn((batch, m6.shape[1], batched_spmm.N),
                         generator=gen, device=DEVICE)
        for name, fns in batched_spmm.strategies(fmt, batch,
                                                 DEVICE).items():
            calls = batch if name in ("loop", "vmap") else 1
            for fn, parts, what in zip(fns, (fwd_parts, bwd_parts),
                                       ("fwd", "fwdbwd")):
                before = _read_counts()
                fn(b3)
                torch.cuda.synchronize()
                after = _read_counts()
                n = {k: after[k] - before[k] for k in after}
                per_call[f"b{batch}_{name}_{what}"] = n
                for k, v in n.items():
                    want = parts.get(k, 0) * calls
                    check(v == want, f"batched b{batch} {name} {what}: {k} "
                          f"launched {v} times in one call (expected "
                          f"{want})")
        del b3
    rec["batched"] = {"rows": m6.nrows, "nnz": m6.nnz,
                      "r_boundary": fmt.r_boundary, "records": batched,
                      "launches_per_call": per_call}
    del fmt, m6
    torch.cuda.empty_cache()
    secs["batched"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec["table4"] = table4_gnn.main(
        out=lines.append, device=DEVICE,
        graphs=table4_gnn.GRAPHS + [table4_gnn.ARXIV])
    secs["table4"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec["sec43"] = sec43_scheduling.main(out=lines.append, rows=SEC43_ROWS,
                                         device=DEVICE)
    secs["sec43"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    auto = autotune_suite.main(out=lines.append, device=DEVICE)
    rec["autotune"] = {"cache": auto["cache"], "plans": {
        mid: {"model": plan_dict(p["model"]), "tuned": plan_dict(p["tuned"]),
              "gflops_model": p["gflops_model"],
              "gflops_tuned": p["gflops_tuned"]}
        for mid, p in auto["plans"].items()}}
    secs["autotune"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        on_path = k in ("csr_panels_spmm", "bcsr_panels_spmm")
        check(v > 0 if on_path else v == 0, f"operator_bench: {k} "
              f"launched {v} times (only B1 and B2 are on this path)")
    rec.update(launches=counts, lines=lines,
               nvidia_smi=RECORD["phases"][0].get("nvidia_smi"))
    phase(rec)
    return rec

# ---------------------------------------------------------------------------
# phase 12: LM training
# ---------------------------------------------------------------------------

def grad_row_err(got, want) -> float:
    """max over rows of |got - want| / max(|want|, 1e-3 max|want|), the
    norms over the last dimension, in float64: :func:`row_err` with a
    floor, since some gradient rows are zero in exact arithmetic (dQ of the
    first causal row, whose one key makes P = 1 and dS = 0) and hold only
    rounding."""
    w = want.double()
    norms = w.norm(dim=-1)
    floor = max(float(norms.max()) * 1e-3, 1e-300)
    d = (got.double() - w).norm(dim=-1)
    return float((d / norms.clamp_min(floor)).max())


def flash_bwd_bound(q, k) -> dict:
    """Least time of one B5 backward: Q, K, V, dO and the lse read once,
    dQ, dK, dV written once; the five products (QKᵀ recomputed, dV, dP,
    dQ, dK) over the (query, key) pairs the causal mask keeps, at the
    dtype's peak."""
    bsz, seq, heads, hd = q.shape
    pairs = seq * (seq + 1) / 2
    flops = 10.0 * hd * pairs * bsz * heads
    nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
              + 4 * bsz * heads * seq)
    return bound(bytes_moved=float(nbytes), flops=flops,
                 dtype=str(q.dtype).replace("torch.", ""))


def _b5_train(dt) -> dict:
    """B5 in training at llama3.2-1b's layer shape, causal: the kernel's
    log-sum-exp against the plain version's (``LSE_TOL`` of max(1, |lse|)),
    the Function's dQ, dK, dV against autograd through the plain forward
    run in fp32 on the same inputs (each row within ``FLASH_ROW_TOL`` of
    its norm, :func:`grad_row_err`), and the times of the forward (with
    the lse, and with a null lse as served), the backward alone and both,
    against ``scaled_dot_product_attention``'s forward and backward (the
    yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as b5
    dname = str(dt).replace("torch.", "")
    _, _, heads, kv, hd = FLASH_SHAPES[-1]
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    q, k, v = (torch.randn((LM_BATCH, LM_PROMPT, n, hd), generator=gen,
                           device=DEVICE).to(dt) for n in (heads, kv, kv))
    do = torch.randn(q.shape, generator=gen, device=DEVICE).to(dt)
    out, lse = b5.flash_attention(q, k, v, causal=True, return_lse=True)
    out_p, lse_p = b5.flash_attention_plain(q, k, v, causal=True,
                                            return_lse=True)
    null = b5.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    lse_err, lse_scale = max_err(lse, lse_p)
    check(lse_err <= LSE_TOL * lse_scale, f"B5 lse {dname}: err "
          f"{lse_err:.3g} > {LSE_TOL:g} * {lse_scale:.3g}")
    check(torch.equal(out, null), f"B5 {dname}: the output with an lse "
          "differs from the output without")
    del out_p, lse_p, null
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    y = b5.flash_attention_train(*ins, causal=True)
    grads = torch.autograd.grad(y, ins, do, retain_graph=True)
    ref_in = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref_g = torch.autograd.grad(
        b5.flash_attention_plain(*ref_in, causal=True), ref_in, do.float())
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), grads, ref_g):
        check(g.dtype == dt and g.shape == w.shape, f"B5 {name} {dname}: "
              f"{g.dtype} {tuple(g.shape)}")
        errs[name] = grad_row_err(g, w)
        check(errs[name] <= FLASH_ROW_TOL[dname], f"B5 {name} {dname}: row "
              f"err {errs[name]:.3g} > {FLASH_ROW_TOL[dname]:g}")
    del ref_in, ref_g
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)
    rec = {"dtype": dname, "shape": list(q.shape), "kv_heads": kv,
           "causal": True, "lse_max_abs_err": lse_err,
           "grad_row_err": errs,
           "fwd_ms": time_ms(lambda: b5.flash_attention(
               q, k, v, causal=True, return_lse=True)),
           "fwd_null_lse_ms": time_ms(lambda: b5.flash_attention(
               q, k, v, causal=True)),
           "bwd_ms": time_ms(lambda: torch.autograd.grad(
               y, ins, do, retain_graph=True), samples=5, reps=2),
           "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
               b5.flash_attention_train(*ins, causal=True), ins, do),
               samples=5, reps=2),
           "library_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt.detach(), kt.detach(), vt.detach(), is_causal=True,
               enable_gqa=True)),
           "library_bwd_ms": time_ms(lambda: torch.autograd.grad(
               sd, (qt, kt, vt), dot, retain_graph=True)),
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      "is_causal=True, enable_gqa=True), its autograd "
                      "backward",
           "bwd_bound": flash_bwd_bound(q, k)}
    rec["bwd_over_library"] = rec["bwd_ms"] / rec["library_bwd_ms"]
    del q, k, v, do, out, lse, ins, y, grads, qt, kt, vt, sd
    torch.cuda.empty_cache()
    return rec


def _train_cli(argv) -> dict:
    """``repro_torch.launch.train.main(argv)`` with the kernels' counts
    set to 0 just before and read just after, and the peak memory."""
    import torch
    from repro_torch.launch import train as train_cli
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rec = train_cli.main(argv)
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _read_counts()
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def _release() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _check_lm_launches(what: str, counts: dict, b5_want: int,
                       launches: dict) -> None:
    for k, v in counts.items():
        launches[k] += v
        want = b5_want if k == "flash_attention" else 0
        check(v == want, f"{what}: {k} launched {v} times (expected {want})")


def _plain_train_loss(cfg, params, mb):
    """The step-0 check's reference: ``train_loss`` with attention's plain
    version (``backend="torch"``, differentiated by autograd) and the
    cross-entropy over the whole fp32 ``(T, vocab)`` logits, also
    differentiated by autograd, so it shares neither B5's backward
    (``flash_attention_bwd``) nor ``_ChunkedCE``'s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    tokens, labels = mb["tokens"].long(), mb["labels"].long()
    x = tf._embed_inputs(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = tf._run_stack(cfg, params, x, positions, backend="torch")
    x = layers.norm_apply(cfg.norm, params.final_norm, x)
    logits = (x.reshape(-1, x.shape[-1]).float()
              @ tf._unembed_w(cfg, params).float().T)
    return F.cross_entropy(logits, labels.reshape(-1), ignore_index=-1)


def _lse_without_tile(q, k, lse, tile: int):
    """Planted fault: each row's log-sum-exp with the causal keys of the
    64-key tile ``tile`` left out (rows that see none of them keep it)."""
    import math

    import torch
    bsz, seq, heads, hd = q.shape
    k0, k1 = 64 * tile, 64 * (tile + 1)
    kt = k[:, k0:k1].float().repeat_interleave(heads // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kt) / math.sqrt(hd)
    qpos = torch.arange(seq, device=q.device)[:, None]
    kpos = torch.arange(k0, k1, device=q.device)[None, :]
    part = torch.logsumexp(s.masked_fill(kpos > qpos, float("-inf")), -1)
    share = torch.exp(part - lse).clamp(max=1.0 - 1e-6)
    return lse + torch.log1p(-share)


def _planted_bwd(fault: str, real):
    """``flash_attention_bwd`` with a planted fault: ``"lse_tile"`` reads
    an lse that left K/V tile 1 out; ``"bwd_tile"`` leaves tile 1 out of
    dK and dV."""
    def bwd(q, k, v, lse, dout, *, causal, **kw):
        if fault == "lse_tile":
            lse = _lse_without_tile(q, k, lse, 1)
        dq, dk, dv = real(q, k, v, lse, dout, causal=causal, **kw)
        if fault == "bwd_tile":
            dk[:, 64:128] = 0
            dv[:, 64:128] = 0
        return dq, dk, dv
    return bwd


def _step0_errors(names, loss, grads, ref_loss, ref_grads) -> dict:
    """The loss's relative difference, the global gradient norm's, and
    each leaf's ``|g - g_ref| / |g_ref|`` (Frobenius norms, float64)."""
    leaf = {}
    sq = sq_ref = 0.0
    for name, g, w in zip(names, grads, ref_grads):
        gd, wd = g.double(), w.double()
        n_ref = float(wd.norm())
        sq += float(gd.norm()) ** 2
        sq_ref += n_ref ** 2
        leaf[name] = float((gd - wd).norm()) / max(n_ref, 1e-300)
    worst = max(leaf, key=leaf.get)
    return {"loss": loss, "loss_ref": ref_loss,
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "grad_norm": sq ** 0.5, "grad_norm_ref": sq_ref ** 0.5,
            "grad_norm_rel": abs(sq ** 0.5 - sq_ref ** 0.5) / sq_ref ** 0.5,
            "leaf_max": leaf[worst], "leaf_worst": worst, "leaf": leaf}


def _step0_violations(e: dict) -> list:
    out = []
    for key, tol in (("loss_rel", TRAIN_LOSS_TOL),
                     ("grad_norm_rel", TRAIN_GNORM_TOL),
                     ("leaf_max", TRAIN_LEAF_TOL)):
        if not e[key] <= tol:
            out.append(f"{key} {e[key]:.3g} > {tol:g}")
    return out


def _train_step0_check(cfg, params, mb, launches: dict) -> dict:
    """Step 0's first microbatch at full width, grad on: ``train_loss``'s
    loss and every gradient leaf through B5's Function (its forward, the
    remat recompute, ``flash_attention_bwd``) and ``_ChunkedCE`` against
    :func:`_plain_train_loss` on the same weights and microbatch, within
    ``TRAIN_LOSS_TOL``, ``TRAIN_GNORM_TOL`` and ``TRAIN_LEAF_TOL``; then
    the same run with each planted fault of :func:`_planted_bwd`, which
    must break one of those limits."""
    import torch
    from repro_torch.kernels import flash_attention as b5
    from repro_torch.models import api
    names = [n for n, _ in params.named_parameters()]
    plist = [p for _, p in params.named_parameters()]

    def grads_of(loss_fn):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, plist)
        return float(loss.detach()), grads

    _reset_counts()
    t0 = time.perf_counter()
    ref_loss, ref_g = grads_of(lambda: _plain_train_loss(cfg, params, mb))
    ref_s = time.perf_counter() - t0
    _check_lm_launches("train_lm step-0 reference", _read_counts(), 0,
                       launches)
    loss, g = grads_of(lambda: api.train_loss(cfg, params, mb)[0])
    _check_lm_launches("train_lm step-0 gradients", _read_counts(),
                       2 * cfg.num_layers, launches)
    errs = _step0_errors(names, loss, g, ref_loss, ref_g)
    del g
    bad = _step0_violations(errs)
    check(not bad, f"train_lm step 0 through B5 against the plain "
          f"reference: {bad} (worst leaf {errs['leaf_worst']})")
    keep = [n for n in names if n == "embed" or n.startswith(
        ("layers.0.", f"layers.{cfg.num_layers - 1}."))]
    rec = {"loss_b5": loss, "ref_s": ref_s,
           "b5": {**{k: v for k, v in errs.items() if k != "leaf"},
                  "leaf": {n: errs["leaf"][n] for n in keep}},
           "planted": {}}
    real = b5.flash_attention_bwd
    for fault in ("lse_tile", "bwd_tile"):
        b5.flash_attention_bwd = _planted_bwd(fault, real)
        try:
            _reset_counts()
            f_loss, f_g = grads_of(lambda: api.train_loss(cfg, params,
                                                          mb)[0])
        finally:
            b5.flash_attention_bwd = real
        fe = _step0_errors(names, f_loss, f_g, ref_loss, ref_g)
        del f_g
        fbad = _step0_violations(fe)
        check(bool(fbad), f"train_lm step 0: planted fault {fault} passes "
              f"the limits (leaf_max {fe['leaf_max']:.3g}, grad_norm_rel "
              f"{fe['grad_norm_rel']:.3g})")
        rec["planted"][fault] = {
            "loss_rel": fe["loss_rel"], "grad_norm_rel": fe["grad_norm_rel"],
            "leaf_max": fe["leaf_max"], "leaf_worst": fe["leaf_worst"],
            "violations": fbad}
    del ref_g
    _release()
    return rec


def _train_full_width(launches: dict, rec: dict) -> None:
    """The launcher at llama3.2-1b's full width, bf16: run A trains 4
    steps with a checkpoint after step 2; run B resumes from that
    checkpoint, in a fresh model, for steps 3-4; then step 0 on the same
    weights and batch (:func:`_train_step0_check`) and one profiled
    step."""
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist.step import default_microbatches
    from repro_torch.models import api

    base = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(base, ignore_errors=True)
    dir_a, dir_b = base / "a", base / "b"
    argv = ["--arch", LM_ARCH, "--device", DEVICE, "--seq-len",
            str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH), "--steps",
            str(TRAIN_STEPS), "--log-every", "1", "--seed", str(LM_SEED)]
    n_mb = default_microbatches(ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"))
    cfg = get_config(LM_ARCH)
    per_step = cfg.num_layers * 2 * n_mb     # forward and remat recompute
    try:
        run_a = _train_cli(argv + ["--ckpt-every", str(TRAIN_CKPT_AT),
                                   "--ckpt-dir", str(dir_a)])
        _release()
        _check_lm_launches("train_lm run A", run_a["launches"],
                           per_step * TRAIN_STEPS, launches)
        ckpt = f"ckpt_{TRAIN_CKPT_AT:010d}.tensors"
        os.makedirs(dir_b)
        os.link(dir_a / ckpt, dir_b / ckpt)
        shutil.rmtree(dir_a)     # the disk holds two full checkpoints
        run_b = _train_cli(argv + ["--resume", "--ckpt-dir", str(dir_b)])
        _release()
        _check_lm_launches("train_lm run B", run_b["launches"],
                           per_step * (TRAIN_STEPS - TRAIN_CKPT_AT),
                           launches)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check(run_b["start_step"] == TRAIN_CKPT_AT,
          f"train_lm: resumed at {run_b['start_step']}")
    steps_a = run_a["steps"]
    for s in steps_a + run_b["steps"]:
        check(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]),
              f"train_lm: step {s['step']} loss {s['loss']} grad_norm "
              f"{s['grad_norm']}")
    same = [(a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
            for a, b in zip(steps_a[TRAIN_CKPT_AT:], run_b["steps"])]
    check(len(same) == TRAIN_STEPS - TRAIN_CKPT_AT and all(same),
          f"train_lm: resumed steps {run_b['steps']} differ from the "
          f"uninterrupted run's {steps_a[TRAIN_CKPT_AT:]}")
    for r in (run_a, run_b):
        check(r["peak_mem_gb"] < 80, f"train_lm: peak {r['peak_mem_gb']:.1f}"
              " GB")

    # Step 0 on the same weights and batch: the first microbatch's loss
    # and gradients through B5 against the plain reference (and against
    # two planted faults, which must fail the same limits), the second's
    # loss, and the mean of both against run A's step-0 loss.
    params = api.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        LM_SEED), device=DEVICE)
    batch = global_batch_at(DataConfig(seed=LM_SEED), cfg, ShapeConfig(
        "t", TRAIN_SEQ, TRAIN_BATCH, "train"), n_mb, 0, device=DEVICE)
    mbs = [{k: v[i] for k, v in batch.items()} for i in range(n_mb)]
    step0 = _train_step0_check(cfg, params, mbs[0], launches)
    _reset_counts()
    with torch.no_grad():
        kernel = [step0["loss_b5"]] + [float(api.train_loss(cfg, params,
                                                            mb)[0])
                                       for mb in mbs[1:]]
    _check_lm_launches("train_lm step-0 losses", _read_counts(),
                       cfg.num_layers * (n_mb - 1), launches)
    # One train step of the same model and batch under the profiler (after
    # one unprofiled): its kernels by device time and the idle share.
    from repro_torch.dist.step import build_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    train_step = build_train_step(cfg, params, OptConfig(
        lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS),
        n_microbatches=n_mb)
    state = init_opt_state(params, 1)
    _reset_counts()
    train_step(params, state, batch)
    profiled = profile_step(lambda: train_step(params, state, batch))
    _check_lm_launches("train_lm profiled steps", _read_counts(),
                       2 * per_step, launches)
    del params, batch, mbs, train_step, state
    _release()
    cli0 = steps_a[0]["loss"]
    mean0 = sum(kernel) / n_mb
    check(abs(mean0 - cli0) <= 1e-5 * abs(cli0), f"train_lm: step-0 loss "
          f"{cli0} in the run vs {mean0} recomputed")

    step_ms = [s["step_s"] * 1e3 for s in steps_a[1:]]
    med_s = statistics.median(step_ms) / 1e3
    n_params = run_a["params"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6.0 * n_params + 12.0 * cfg.num_layers * TRAIN_SEQ
             * cfg.d_model) * tokens
    rec["full_width"] = {
        "arch": LM_ARCH, "dtype": str(cfg.dtype), "seq_len": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH, "n_microbatches": n_mb,
        "params": n_params, "steps": steps_a, "resumed_steps":
        run_b["steps"], "resumed_equal_bitwise": all(same),
        "step0": step0, "step_ms_steps_2_to_4": step_ms,
        "median_step_ms": med_s * 1e3, "tokens_per_s": tokens / med_s,
        "peak_mem_gb": [run_a["peak_mem_gb"], run_b["peak_mem_gb"]],
        "ckpt_saves": run_a["ckpt"] + run_b["ckpt"],
        "restore_s": run_b["restore_s"],
        "run_s": [run_a["wall_s"], run_b["wall_s"]],
        "launches_per_step": {"flash_attention": per_step},
        "profiled_step": profiled,
        "model_flops_share": flops / (med_s * PEAK_FLOPS["bfloat16"]),
        "model_flops_share_formula":
            "(6 * params + 12 * layers * seq_len * d_model) * tokens / "
            "(median step s * 989e12)"}


def _train_reduced(launches: dict) -> dict:
    """30 steps of the reduced llama on the card (seq 32, batch 4, two
    microbatches, lr 1e-2, two alternating batches), as the reference's
    ``test_loss_decreases``: the loss falls by more than 0.5."""
    import numpy as np
    import torch
    from repro_torch.configs import REDUCED
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.dist.step import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = REDUCED[LM_ARCH]()
    params = api.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), device=DEVICE)
    train_step = build_train_step(cfg, params, OptConfig(
        lr=1e-2, warmup_steps=2, total_steps=50), n_microbatches=2)
    state = init_opt_state(params, 1)
    shape = ShapeConfig("t", 32, 4, "train")
    batches = [global_batch_at(DataConfig(seed=7), cfg, shape, 2, s,
                               device=DEVICE) for s in (0, 1)]
    _reset_counts()
    losses = []
    t0 = time.perf_counter()
    for step in range(REDUCED_STEPS):
        params, state, m = train_step(params, state, batches[step % 2])
        losses.append(float(m["loss"]))
    wall = time.perf_counter() - t0
    _check_lm_launches("train_lm reduced", _read_counts(),
                       cfg.num_layers * 2 * 2 * REDUCED_STEPS, launches)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5,
          f"train_lm reduced: losses {losses[::6]}")
    return {"config": cfg.name, "steps": REDUCED_STEPS, "losses": losses,
            "ms_per_step": wall / REDUCED_STEPS * 1e3}


def _example_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_defaults(ex, launches: dict) -> dict:
    """``examples/train_lm_torch.py`` at its defaults (the reference's):
    it learns, and its kernel logits equal the plain path's at 1e-3 (both
    asserted by the example)."""
    _reset_counts()
    t0 = time.perf_counter()
    rec = ex.main(["--device", DEVICE])
    rec["wall_s"] = time.perf_counter() - t0
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
    check(counts["flash_attention"] > 0
          and counts["csr_panels_spmm"] + counts["bcsr_panels_spmm"] > 0
          and counts["csr_sdd_panels"] + counts["bcsr_sdd_panels"] > 0,
          f"train_lm example: launches {counts}")
    return {"losses_first_last": [rec["losses"][0], rec["losses"][-1]],
            "median_step_ms": statistics.median(rec["step_s"]) * 1e3,
            "plan_s": rec["plan_s"], "transpose_s": rec["transpose_s"],
            "logits_max_abs_err": rec["logits_max_abs_err"],
            "n_params": rec["n_params"], "nnz": rec["nnz"],
            "launches": counts, "wall_s": rec["wall_s"]}


def _example_ffn_width(ex, launches: dict) -> dict:
    """The example's model at llama3.2-1b's FFN width (d 2048, d_ff 8192,
    32 heads, 90% sparsity, 2 layers, seq 512, batch 4), fp32: one step's
    value gradients of every sparse layer against the flat path on that
    layer's own input and output cotangent (each element within ``TOL``
    of its summation bound |dY|·|X|, as phase 7), then ``EX_STEPS`` SGD
    steps; B1-B5 must all launch."""
    import numpy as np
    import torch
    from repro_torch.models.sparse_ffn import sparse_linear_apply
    a = EX_FFN
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    params, structures = ex.build(a["d_model"], a["d_ff"], a["layers"],
                                  a["vocab"], a["sparsity"],
                                  np.random.default_rng(0), device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pair in structures:
        for layer in pair:
            layer.fmt.transposed(dtype=torch.float32).fmt.on(dev)
    torch.cuda.synchronize()
    transpose_s = time.perf_counter() - t0
    _reset_counts()
    toks, tgt = ex.batch_at(0, a["batch"], a["seq"], a["vocab"], dev)
    taps = []
    loss = ex.loss_fn(params, structures, toks, tgt, a["heads"], taps=taps)
    loss.backward()       # fills the taps' retained output gradients too
    checks = []
    for i, (layer, x, y) in enumerate(taps):
        # a part with no values (no CSR rows) takes no gradient
        names = [n for n in ("csr_vals", "bcsr_vals")
                 if getattr(layer, n).numel()]
        vals = [getattr(layer, n) for n in names]
        dy = y.grad
        flat = torch.autograd.grad(sparse_linear_apply(
            layer, x.detach(), backend="torch"), vals, dy)
        bnd = torch.autograd.grad(sparse_linear_apply(
            layer, x.detach().abs(), backend="torch"), vals, dy.abs())
        for name, v, f, b in zip(names, vals, flat, bnd):
            checks.append({"layer": i, "part": name, "numel": v.numel(),
                           **_grad_check(f"train_lm ffn-width layer {i} "
                                         f"{name}", v.grad, f, b,
                                         TOL["float32"])})
        del flat, bnd
    del taps, loss
    for p in ex.leaves(params):
        p.grad = None
    step_ms, losses = [], []
    for s in range(EX_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, tgt = ex.batch_at(s, a["batch"], a["seq"], a["vocab"], dev)
        losses.append(float(ex.sgd_step(params, structures, toks, tgt,
                                        a["heads"], a["lr"])))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    for k, v in counts.items():
        launches[k] += v
        check(v > 0, f"train_lm ffn-width: {k} never launched ({counts})")
    check(all(np.isfinite(losses)), f"train_lm ffn-width: losses {losses}")
    rec = {"config": a, "plan_s": plan_s, "transpose_s": transpose_s,
           "value_grad_checks": checks, "losses": losses,
           "step_ms": step_ms, "launches": counts,
           "nnz": sum(p.numel() for n, v in params.items()
                      if n.startswith("ffn") for p in v.values())}
    del params, structures
    _release()
    return rec


def phase_train_lm(launches: dict) -> dict:
    """Phase 12: B5 in training alone, the training launcher at full
    width with a checkpoint and a resume, the reduced llama's loss
    falling, and the sparse-FFN LM example at its defaults and at
    llama3.2-1b's FFN width."""
    import torch
    rec = {"phase": "train_lm"}
    t0 = time.perf_counter()
    rec["b5_train"] = [_b5_train(torch.bfloat16), _b5_train(torch.float32)]
    rec["b5_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _train_full_width(launches, rec)
    rec["full_width_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["reduced"] = _train_reduced(launches)
    ex = _example_module()
    rec["example_defaults"] = _example_defaults(ex, launches)
    rec["example_ffn_width"] = _example_ffn_width(ex, launches)
    rec["examples_s"] = time.perf_counter() - t0
    rec["nvidia_smi"] = RECORD["phases"][0].get("nvidia_smi")
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
                         "chip_smoke.json, and phases 4 and 9's obs "
                         "captures beside it")
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
    # The plan caches of phases 4 and 9 (and their captures without --out)
    # live in a directory removed at exit.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_tune(launches, args.out, work)
        phase_gcn(launches)
        phase_train_gcn(launches)
        ffn_recs = phase_train_ffn(launches)
        lm_rec = phase_serve_lm(launches)
        phase_serve_obs(launches, lm_rec, args.out, work)
        phase_serve_traffic(launches)
        phase_operator_bench(launches, args.out)
        phase_train_lm(launches)
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
