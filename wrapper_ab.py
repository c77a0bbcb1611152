#!/usr/bin/env python3
"""Time this checkout's kernel wrappers against another checkout's, in
turns, in one process on one GPU.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 wrapper_ab.py --base DIR [--cases b5,wkv6_bwd] [--pairs 10]
                          [--out DIR]

``DIR`` is another checkout, for instance an earlier commit unpacked with
``git archive`` into a git-ignored directory such as ``build/parent``.  Its
``src/repro_torch`` is copied into ``build/wrapper_ab/`` as the package
``repro_torch_base``, with its operators defined in the namespace
``repro_torch_base`` so that both packages' operators coexist; each
package builds its own CUDA sources (both at once).  Each case runs both
wrappers on the same inputs, records the largest difference of their
outputs, then times each with ``chip_smoke.time_ms`` (the CUDA-event time
of back-to-back calls, the wrapper's host share included) ``--pairs``
times in turns: the base first in even pairs, the change first in odd
ones.  It prints one JSON line a case: the times, their medians, each
side's spread (max - min), and in how many pairs the change was faster.

Cases:

* ``b5``: ``flash_attention`` at the LM serving shape (4, 2048, 32 heads,
  8 kv-heads, hd 64), causal: bf16, bf16 with the log-sum-exp (phase 12's
  training forward), and fp32.
* ``wkv6_bwd``: ``wkv6_bwd`` at phase 22's microbatch (4, 2048, 40 heads,
  64) from a zero state, on each package's own forward snapshots.

Exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import threading

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402

CASES = ("b5", "wkv6_bwd")


def base_package(root: pathlib.Path):
    """``root``'s ``repro_torch`` imported as ``repro_torch_base`` (a copy
    under ``build/wrapper_ab/`` whose operators live in that namespace)."""
    tag = hashlib.sha1(str(root).encode()).hexdigest()[:8]
    work = HERE / "build" / "wrapper_ab" / tag
    pkg = work / "src" / "repro_torch_base"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(root / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    ops = pkg / "kernels" / "_ops.py"
    text = ops.read_text()
    if 'NAMESPACE = "repro_torch"' not in text:
        raise SystemExit(f"{ops}: no NAMESPACE line to rename")
    ops.write_text(text.replace('NAMESPACE = "repro_torch"',
                                'NAMESPACE = "repro_torch_base"'))
    sys.path.insert(0, str(work / "src"))
    return importlib.import_module("repro_torch_base.kernels")


def in_turns(fns: dict, pairs: int) -> dict:
    """``{"base": fn, "change": fn}`` timed ``pairs`` times in turns."""
    times = {"base": [], "change": []}
    for i in range(pairs):
        order = ("base", "change") if i % 2 == 0 else ("change", "base")
        for who in order:
            times[who].append(cs.time_ms(fns[who]))
    med = {who: statistics.median(t) for who, t in times.items()}
    return {"ms": times, "median_ms": med,
            "spread_ms": {who: max(t) - min(t) for who, t in times.items()},
            "change_over_base": med["change"] / med["base"],
            "change_faster_pairs": sum(c < b for b, c in
                                       zip(times["base"], times["change"]))}


def case_b5(pkgs: dict, pairs: int) -> list:
    import torch
    out = []
    for dt, lse in ((torch.bfloat16, False), (torch.bfloat16, True),
                    (torch.float32, False)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn((4, 2048, 32, 64), generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn((4, 2048, 8, 64), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        fns = {who: (lambda m=m: m.flash_attention.flash_attention(
            q, k, v, causal=True, return_lse=lse))
            for who, m in pkgs.items()}
        res = {who: fn() for who, fn in fns.items()}
        a, b = ((x if lse else (x,)) for x in res.values())
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
        out.append({"case": "b5", "shape": [4, 2048, 32, 8, 64],
                    "causal": True, "dtype": str(dt).split(".")[-1],
                    "return_lse": lse, "max_abs_diff": diff,
                    **in_turns(fns, pairs)})
    return out


def case_wkv6_bwd(pkgs: dict, pairs: int) -> list:
    import torch
    r, k, v, w, u, _ = cs._wkv6_inputs(4, 2048, 40, False, seed=31)
    gen = torch.Generator(device="cuda").manual_seed(32)
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    fns, res = {}, {}
    for who, m in pkgs.items():
        snap = m.wkv6.wkv6(r, k, v, w, u, snapshots=True)[2]
        fns[who] = (lambda m=m, snap=snap:
                    m.wkv6.wkv6_bwd(r, k, v, w, u, dy, snap))
        res[who] = fns[who]()
    diff = max(float((x - y).abs().max())
               for x, y in zip(res["base"], res["change"]))
    mag = max(float(x.abs().max()) for x in res["change"])
    return [{"case": "wkv6_bwd", "shape": [4, 2048, 40, 64], "s0": "zero",
             "max_abs_diff": diff, "max_abs": mag, **in_turns(fns, pairs)}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, required=True)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    for c in cases:
        if c not in CASES:
            raise SystemExit(f"unknown case {c!r}; cases: {CASES}")
    import torch
    if not torch.cuda.is_available():
        print("wrapper_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    import repro_torch.kernels as change
    pkgs = {"base": base_package(args.base.resolve()), "change": change}
    builds = [threading.Thread(target=importlib.import_module(
        f"{m.__name__}._build").build_all) for m in pkgs.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    records = []
    for c in cases:
        for rec in {"b5": case_b5, "wkv6_bwd": case_wkv6_bwd}[c](
                pkgs, args.pairs):
            rec.update(base=str(args.base.resolve()), nvidia_smi=smi)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        path = args.out / "wrapper_ab.json"
        old = json.loads(path.read_text()) if path.exists() else []
        path.write_text(json.dumps(old + records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
