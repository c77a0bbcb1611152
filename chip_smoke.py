#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LOOPS (``src/repro_torch``) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each, ``{"phase": ...}``):

  1. env      -- card name and power limit, toolchain, the kernels' build
                 (``nvcc`` for sm_90a from ``src/repro_torch/csrc``) and its
                 time;
  2. kernels  -- the CUDA kernels B1 (CSR part) and B2 (BCSR part) against
                 their plain PyTorch versions on the card: fp32, fp64, bf16,
                 f16; adversarial panel shapes, batch 1/3/11, N 32/40/600,
                 and the fused buffer with a row offset;
  3. main     -- ``plan_and_convert`` -> ``loops_spmm`` at the published
                 sizes of pwtk (m6, 200k rows) and in-2004 (m4, 1.4M rows),
                 N=32, checked against the flat PyTorch path on the card,
                 with CUDA-event times of the whole call, of each kernel, of
                 its plain version and of cuSPARSE (``torch.sparse``), and
                 the bound from the bytes and operations the call needs;
  4. gcn      -- the 2-layer GCN at ogbn-arxiv's published widths answering
                 three requests, checked against the flat PyTorch path.

Each kernel's launch count is set to 0 just before phases 3 and 4 and read
just after; a kernel of the path that did not launch fails the run.  The
last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero with no
result.  ``--out DIR`` also writes the full record to
``DIR/chip_smoke.json``.

Tolerances: fp32 1e-5, fp64 1e-12, bf16/f16 1e-2 (the sums run in another
order; half inputs are exact in the fp32 accumulator).  In phase 2 they
bound max |kernel - plain| / max(1, max |plain|).  At the published sizes a
hub row sums ~1e5 products, so phase 3 bounds the error of each element by
the summation bound instead: |kernel - plain| / max(1, (|A|·|B|)) <= tol.
The GCN's logits: 1e-4 of max(1, max |logits|) in fp32 (two aggregations and
two matmuls deep).
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
    from repro_torch.kernels import bcsr_spmm, csr_spmm

    rng = np.random.default_rng(0)
    cases = _adversarial(rng)
    worst = {"csr_panels_spmm": 0.0, "bcsr_panels_spmm": 0.0}
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
    rec = {"phase": "kernels_vs_plain", "checks": ncheck,
           "kernels": [{"name": k, "launches_in_checks": getattr(
               csr_spmm if k.startswith("csr") else bcsr_spmm, k).launches,
               "max_rel_err": worst[k], "ms_300x257_fp32_n32": ms[k]}
               for k in worst]}
    phase(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 3: the main path at published sizes
# ---------------------------------------------------------------------------

def _reset_counts():
    from repro_torch.kernels import bcsr_spmm, csr_spmm
    csr_spmm.csr_panels_spmm.launches = 0
    bcsr_spmm.bcsr_panels_spmm.launches = 0


def _read_counts() -> dict:
    from repro_torch.kernels import bcsr_spmm, csr_spmm
    return {"csr_panels_spmm": csr_spmm.csr_panels_spmm.launches,
            "bcsr_panels_spmm": bcsr_spmm.bcsr_panels_spmm.launches}


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
                   "bcsr_panels_spmm": plan.r_boundary < csr.nrows}
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
        check(v == 6, f"gcn: {k} launched {v} times for 3 requests "
              "(expected 6)")

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

SOURCES = {
    "csr_panels_spmm": ("src/repro_torch/csrc/csr_spmm.cu",
                        "src/repro/kernels/csr_spmm.py:172"),
    "bcsr_panels_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu",
                         "src/repro/kernels/bcsr_spmm.py:177"),
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
    launches = {"csr_panels_spmm": 0, "bcsr_panels_spmm": 0}
    main_recs = phase_main(launches)
    phase_gcn(launches)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the main path")

    # The kernels line reports the pwtk (m6) fp32 main-path call.
    rep = next(r for r in main_recs
               if r["matrix"] == "m6" and r["dtype"] == "float32")
    line = []
    for name, (src, replaces) in SOURCES.items():
        k = rep["kernels"][name]
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
