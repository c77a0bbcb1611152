#!/usr/bin/env python3
"""Time the LOOPS SpMM kernels B1 and B2 on one GPU, by work-unit size, and
the kernels of another checkout beside them.

Run from the repository root, on a machine with an NVIDIA GPU:

    python3 spmm_sweep.py [--root DIR] [--unit-panels 8,16,32,64,128]
                          [--cases m6,m4,gcn] [--entry] [--out DIR]

Cases (the shapes of ``chip_smoke.py``'s phases): ``m6`` the pwtk-like
matrix (200,000 rows) in fp32/fp64/f16 and ``m4`` the in-2004-like matrix
(1,400,000 rows) in fp32/fp64, both at N=32; ``gcn`` the ogbn-arxiv-sized
adjacency Â and its transposed format Âᵀ (the training backward's dB) at
N=256 and N=40 in fp32.  For every case, kernel and unit size U it prints
one JSON line: the kernel's device time per call (``torch.profiler``, its
launches summed, both passes; ``chip_smoke.device_ms``), the CUDA-event
time of back-to-back calls (which includes the host's share of a call;
``chip_smoke.time_ms``), and the unit table's counts and workspace
bytes.  The kernels write into one buffer, as
``loops_spmm`` does.

``--entry`` times the product through its entry points instead of the
kernels: ``loops_spmm`` (checks, the autograd Function, both kernels) and,
below the Function, ``engine.loops_spmm_fused``, on a ``(K, N)`` operand
as ``chip_smoke.py``'s phase ``main`` calls it.  Besides the device and
back-to-back times, each line gives the host's time for one call with the
card idle (``host_us``, median of 50, the clock stopped when the call
returns) and the functions that took most of that host time under
``cProfile`` over 200 calls (``profile``: own µs a call;
``profile_cum``: with their callees).

``--cases gcn_request`` (with ``--entry``) times one request of the
2-layer GCN at ogbn-arxiv's widths (169,343 nodes, 128 -> 256 -> 40), as
``chip_smoke.py``'s phase ``gcn`` serves it.  ``--dispatch`` (a checkout
whose kernels launch through ``torch.ops.repro_torch`` operators) times
one B1 and one B2 launch at each fp32 case through the operator, through
a ``torch.library.custom_op`` twin of it and through its kernel function
called directly, in turns in one process: the registrations' own host
cost a launch, and the wrapper's whole call beside them.

``--root DIR`` imports ``repro_torch`` from another checkout, for instance
the parent commit unpacked with ``git archive`` into a git-ignored
directory, and times its kernels as they are; a checkout whose kernels take
no unit table is timed once per case (``"U": null``).  Run the two
checkouts in turns on one card (base, change, change, base) to compare
them.  ``--out DIR`` also writes the lines to ``DIR/spmm_sweep_<pid>.json``.
Exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pathlib
import pstats
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from chip_smoke import device_ms, time_ms  # noqa: E402


def cases(names):
    """(case, dtype, format, N) in the order of ``names``."""
    import numpy as np
    from repro_torch.core import plan_and_convert, suite
    for name in names:
        if name in ("m6", "m4"):
            rows, dts = ((200_000, ("float32", "float64", "float16"))
                         if name == "m6" else
                         (1_400_000, ("float32", "float64")))
            base = suite.table2_like(name, scale_rows=rows, seed=0,
                                     dtype=np.float32)
            for dname in dts:
                fmt, _ = plan_and_convert(base.astype(np.dtype(dname)),
                                          device="cuda")
                yield name, dname, fmt, 32
        elif name == "gcn_request":
            adj = suite.gcn_graph(169_343, 7, seed=0)
            fmt, _ = plan_and_convert(adj, device="cuda")
            yield name, "float32", fmt, None
        elif name == "gcn":
            adj = suite.gcn_graph(169_343, 7, seed=0)
            fmt, _ = plan_and_convert(adj, device="cuda")
            tl = fmt.transposed()
            for n in (256, 40):
                yield f"gcn_A_n{n}", "float32", fmt, n
                yield f"gcn_AT_n{n}", "float32", tl.fmt, n
        else:
            raise SystemExit(f"unknown case {name!r}")


def host_us(fn, *, calls: int = 50) -> float:
    """Median host time of one call of ``fn`` started on an idle card."""
    import torch
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def host_profile(fn, *, calls: int = 200, top: int = 8,
                 cumulative: bool = False) -> list:
    """The ``top`` functions by own (or ``cumulative``) host time under
    ``cProfile`` over ``calls`` calls of ``fn``: ``[name, µs a call]``."""
    import torch
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[3 if cumulative else 2], f"{pathlib.Path(k[0]).name}:{k[1]}:{k[2]}")
                   for k, v in stats.items()), reverse=True)[:top]
    return [[name, round(t / calls * 1e6, 2)] for t, name in rows]


def dispatch_us(fmt, *, blocks: int = 40, calls: int = 100) -> dict:
    """Host microseconds a launch of B1 and of B2 (``fmt``'s two parts,
    N 32, fp32) takes through its ``torch.ops.repro_torch`` operator,
    through a ``torch.library.custom_op`` twin of it, through its kernel
    function called directly (no dispatcher), and the wrapper's whole call
    (its checks, then the kernel function: nothing observes it), the four
    in turns: for each, the median over ``blocks`` blocks of ``calls``
    launches, each block timed from an idle card to the return of its last
    call."""
    import torch
    from repro_torch.kernels import bcsr_spmm, csr_spmm
    dev = fmt.on("cuda")
    b3 = torch.randn((1, fmt.ncols, 32), device="cuda")
    r_b, nb = fmt.r_boundary, fmt.bcsr_part.nblocks
    out = {}
    for name, p, kernel, rows, extra in (
            ("csr_panels_spmm", dev.csr, csr_spmm._launch_b1, r_b, ()),
            ("bcsr_panels_spmm", dev.bcsr, bcsr_spmm._launch_b2, nb * 8,
             (0,))):
        o3 = torch.empty((1, rows, 32), device="cuda")
        args = (p.units.units, p.units.splits, p.cols, p.vals, p.mask, b3,
                o3, p.units.nslots, p.units.max_slots, *extra, rows, p.live)
        schema = getattr(torch.ops.repro_torch, name).default._schema
        twin = torch.library.custom_op(
            f"repro_probe::{name}_dispatch", kernel, mutates_args=["out"],
            schema=str(schema)[str(schema).index("("):])
        wrapper = {
            "csr_panels_spmm": lambda: csr_spmm.csr_panels_spmm(
                p.rows, p.cols, p.vals, p.mask, b3, nrows=r_b, units=p.units,
                out=o3, live=p.live),
            "bcsr_panels_spmm": lambda: bcsr_spmm.bcsr_panels_spmm(
                p.rows, p.cols, p.vals, p.mask, b3, nblocks=nb,
                units=p.units, out=o3, live=p.live)}[name]
        fns = {"library": getattr(torch.ops.repro_torch, name).default,
               "custom_op": twin, "direct": kernel,
               "wrapper": lambda *a, w=wrapper: w()}
        times = {k: [] for k in fns}
        for _ in range(blocks):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                times[k].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        out[name] = {k: statistics.median(v) for k, v in times.items()}
    return out


def time_entries(fmt, dname: str, n, root) -> list:
    """``--entry``: one line each for ``loops_spmm`` and
    ``engine.loops_spmm_fused`` on a ``(K, n)`` operand, or for one GCN
    request when ``n`` is None."""
    import torch
    from repro_torch.core import loops_spmm
    from repro_torch.kernels import engine
    gen = torch.Generator(device="cuda").manual_seed(1)
    if n is None:
        from repro_torch.models import GCN
        w0 = torch.randn((128, 256), generator=gen, device="cuda") * 0.1
        w1 = torch.randn((256, 40), generator=gen, device="cuda") * 0.1
        model = GCN(fmt, w0, w1)
        x = torch.randn((fmt.ncols, 128), generator=gen, device="cuda")

        def request():
            with torch.inference_mode():
                return model(x)
        entries = (("gcn_request", request),)
    else:
        b = torch.randn((fmt.ncols, n), generator=gen, device="cuda",
                        dtype=torch.float32).to(getattr(torch, dname))
        entries = (("loops_spmm", lambda: loops_spmm(fmt, b)),
                   ("engine.loops_spmm_fused",
                    lambda: engine.loops_spmm_fused(fmt, b)))
    lines = []
    for entry, fn in entries:
        lines.append({"root": str(root), "dtype": dname, "n": n,
                      "entry": entry, "device_ms": device_ms(fn),
                      "event_ms": time_ms(fn), "host_us": host_us(fn),
                      "profile": host_profile(fn),
                      "profile_cum": host_profile(fn, cumulative=True)})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--unit-panels", default="",
                    help="comma-separated unit sizes to time besides each "
                         "kernel's own (UNIT_PANELS)")
    ap.add_argument("--cases", default="m6,m4,gcn")
    ap.add_argument("--entry", action="store_true",
                    help="time loops_spmm and engine.loops_spmm_fused, "
                         "with their host time, instead of the kernels")
    ap.add_argument("--dispatch", action="store_true",
                    help="time a B1 and a B2 launch at each case through "
                         "its operator, a custom_op twin and the kernel "
                         "function itself (m6, fp32)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spmm_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import bcsr_spmm, csr_spmm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    has_units = hasattr(csr_spmm, "unit_table_of")
    sizes = [int(u) for u in args.unit_panels.split(",") if u]
    lines = []
    for case, dname, fmt, n in cases(args.cases.split(",")):
        if args.dispatch:
            if dname == "float32" and n is not None:
                rec = {"case": case, "dispatch_us": dispatch_us(fmt)}
                print(json.dumps(rec), flush=True)
                lines.append(rec)
            continue
        if args.entry:
            for rec in time_entries(fmt, dname, n, args.root):
                rec["case"] = case
                print(json.dumps(rec), flush=True)
                lines.append(rec)
            del fmt
            continue
        dev = fmt.on("cuda")
        r_b, br = fmt.r_boundary, fmt.bcsr_part.br
        nb = fmt.bcsr_part.nblocks
        dt = getattr(torch, dname)
        acc = torch.float64 if dt == torch.float64 else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(1)
        b3 = torch.randn((1, fmt.ncols, n), generator=gen, device="cuda",
                         dtype=torch.float32).to(dt)
        buf = torch.empty((1, r_b + nb * br, n), dtype=acc, device="cuda")
        for kernel, mod, panels, kw in (
                ("csr_panels_spmm", csr_spmm, dev.csr, {"nrows": r_b}),
                ("bcsr_panels_spmm", bcsr_spmm, dev.bcsr,
                 {"nblocks": nb, "row_offset": r_b})):
            if (r_b if kernel.startswith("csr") else nb) == 0:
                continue
            fn = getattr(mod, kernel)
            own = getattr(mod, "UNIT_PANELS", None)
            for u in ([own] + [s for s in sizes if s != own]
                      if has_units else [None]):
                rec = {"root": str(args.root), "case": case, "dtype": dname,
                       "n": n, "kernel": kernel, "U": u}
                if u is not None:
                    t = csr_spmm.unit_table_of(panels.ptr, u)
                    kw["units"] = t
                    rec.update(units=t.nunits, split_groups=t.nsplit,
                               slots=t.nslots,
                               workspace_bytes=t.nslots * (
                                   br if kernel.startswith("bcsr") else 1)
                               * n * acc.itemsize)

                def call(fn=fn, panels=panels, kw=dict(kw)):
                    fn(panels.rows, panels.cols, panels.vals, panels.mask,
                       b3, panel_ptr=panels.ptr, out=buf, **kw)
                rec["device_ms"] = device_ms(call)
                rec["event_ms"] = time_ms(call)
                print(json.dumps(rec), flush=True)
                lines.append(rec)
        del fmt, dev, buf, b3
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"spmm_sweep_{os.getpid()}.json").write_text(
            json.dumps({"device": smi, "lines": lines}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
