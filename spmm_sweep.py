#!/usr/bin/env python3
"""Time the LOOPS SpMM kernels B1 and B2 on one GPU, by work-unit size, and
the kernels of another checkout beside them.

Run from the repository root, on a machine with an NVIDIA GPU:

    python3 spmm_sweep.py [--root DIR] [--unit-panels 8,16,32,64,128]
                          [--cases m6,m4,gcn] [--out DIR]

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
import json
import os
import pathlib
import subprocess
import sys

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
        elif name == "gcn":
            adj = suite.gcn_graph(169_343, 7, seed=0)
            fmt, _ = plan_and_convert(adj, device="cuda")
            tl = fmt.transposed()
            for n in (256, 40):
                yield f"gcn_A_n{n}", "float32", fmt, n
                yield f"gcn_AT_n{n}", "float32", tl.fmt, n
        else:
            raise SystemExit(f"unknown case {name!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--unit-panels", default="",
                    help="comma-separated unit sizes to time besides each "
                         "kernel's own (UNIT_PANELS)")
    ap.add_argument("--cases", default="m6,m4,gcn")
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
