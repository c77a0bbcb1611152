#!/usr/bin/env python3
"""Build variants of the CUDA kernels B5 (flash attention) and B4 (BCSR
SDD) and check and time them on one GPU.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 kernel_sweep.py b5 [--variants k64s3h2,...] [--check-only]
    python3 kernel_sweep.py b4 [--variants w8s2r4b2,...]
    (either also takes [--root DIR] [--out DIR])

A variant sets the tile constants of the kernel's source in a copy of it:

* B5 (``src/repro_torch/csrc/flash_attention.cu``, the bf16 / f16 body):
  ``k`` keys a K / V tile (``kKeys``, 64 or 128), ``s`` ring stages
  (``kStages``, 3 or more), ``h`` most q-heads a CTA serves
  (``kMaxHeads``).
* B4 (``src/repro_torch/csrc/bcsr_sdd.cu``): ``w`` warps a CTA
  (``kSddWarps``), ``s`` stages of each warp's ring of gathered tiles
  (``kBStages``), ``r`` quads a warp keeps sums for (``kMaxRounds``; a CTA
  takes w x r x 4 jobs a pass), ``b`` CTAs an SM must hold
  (``kMinBlocks``, ``__launch_bounds__``' second argument, which caps the
  registers).

The variants are compiled with the build's own flags (``_build.NVCC_FLAGS``)
into ``build/kernel_sweep/``, all at once, and loaded with ctypes beside the
port's wrapper.  Each prints one JSON line with its registers and spills
(``ptxas -v``) and:

* B5: the worst error against ``flash_attention_plain`` over
  ``chip_smoke.FLASH_SHAPES`` and the GPU tests' edge shapes (hd
  16/32/64/128, 1/3/4 q-heads a kv-head, S 1, 63, 65, 1000, 2049, causal
  and not, bf16 and f16), relative to max(1, max |plain|) as
  ``chip_smoke.FLASH_TOL`` bounds it and per row as ``FLASH_ROW_TOL``
  does; unless ``--check-only``, its CUDA-event time
  (``chip_smoke.time_ms``) at the serving shape (4, 2048, 32 heads, 8
  kv-heads, hd 64) causal and not, and at hd 128, each with its bound
  (``chip_smoke.flash_bound``) and ``scaled_dot_product_attention``'s time
  on the same tensors.
* B4, at ``chip_smoke.py``'s phase ``train_ffn`` shapes (llama3.2-1b's MLP
  up-projection, 8192 x 2048, 90% pruned; B the (2, 2048, 1024) transposed
  activation; dY the fp32 cotangent; fp32 at Br 8 and bf16 at Br 16, on
  the layer's uploaded unit table), for each dtype: the error against
  ``bcsr_sdd_panels_plain`` relative to the summation bound |dY|·|B| (at
  ``chip_smoke.TOL``), whether two calls are bitwise equal, the CUDA-event
  time, the device time (``chip_smoke.device_ms``) and the bound
  (``chip_smoke.sdd_bound``).

``--root DIR`` builds the kernel source of another checkout instead (for
instance an earlier commit unpacked with ``git archive`` into a git-ignored
directory); run the two in turns on one card to compare them.  ``--out
DIR`` also appends the lines to ``DIR/kernel_sweep.json``.  Exits 2
without a GPU, 1 if a variant fails to build or to check.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402

# kernel: (source, {variant letter: constant}, default variants)
KERNELS = {
    "b5": ("flash_attention.cu",
           {"k": "kKeys", "s": "kStages", "h": "kMaxHeads"},
           "k64s3h2,k64s4h2,k64s3h4,k64s4h4,k64s3h1,k128s3h2"),
    "b4": ("bcsr_sdd.cu",
           {"w": "kSddWarps", "s": "kBStages", "r": "kMaxRounds",
            "b": "kMinBlocks"},
           "w8s2r4b2,w8s3r4b1,w8s4r4b1,w4s4r8b2,w4s3r8b3"),
}
# B5, (B, S, H, KV, hd): the GPU tests' edges beside chip_smoke's shapes.
EDGE_SHAPES = ((1, 1, 4, 1, 64), (1, 63, 3, 1, 32), (2, 65, 4, 4, 16),
               (1, 1000, 12, 3, 128), (1, 2049, 8, 2, 64),
               (2, 200, 8, 2, 128), (1, 130, 4, 1, 16))
# B5, (B, S, H, KV, hd, causal) timed.
TIMED = ((4, 2048, 32, 8, 64, True), (4, 2048, 32, 8, 64, False),
         (4, 2048, 16, 4, 128, True))


def parse(kernel: str, name: str) -> dict:
    """{constant: value} of variant ``name``."""
    letters = KERNELS[kernel][1]
    pairs = re.findall(r"([a-z])(\d+)", name)
    if "".join(f"{a}{v}" for a, v in pairs) != name or \
            [a for a, _ in pairs] != list(letters):
        raise SystemExit(f"bad {kernel} variant {name!r}: want "
                         + "".join(f"{a}<n>" for a in letters))
    return {letters[a]: int(v) for a, v in pairs}


def variant_source(text: str, consts: dict) -> str:
    """``text`` with each ``constexpr int <name> = <n>;`` set to the
    variant's value; each constant must be defined exactly once."""
    for name, value in consts.items():
        text, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise SystemExit(f"{name} is defined {hits} times, not once")
    return text


def build(kernel: str, names, root: pathlib.Path):
    """Compile every variant of ``root``'s source at once; return
    {name: (library or None, ptxas log)}."""
    from repro_torch.kernels import _build
    csrc = root / "src" / "repro_torch" / "csrc"
    src_name = KERNELS[kernel][0]
    text = (csrc / src_name).read_text()
    tag = hashlib.sha1(str(root).encode()).hexdigest()[:8]
    out_dir = HERE / "build" / "kernel_sweep" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        stem = f"{src_name[:-3]}_{name}"
        src = out_dir / f"{stem}.cu"
        src.write_text(variant_source(text, parse(kernel, name)))
        lib = out_dir / f"{stem}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        built[name] = (lib if proc.returncode == 0 else None, log)
    return built


def regs(log: str, tag: str) -> dict:
    """{mangled kernel name: (registers, spill stores, spill loads)} of the
    kernels whose name contains ``tag``."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m[1]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m[1]), int(m[2]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and tag in name:
            out[name] = (int(m[1]),) + spill
    return out


def load(lib, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def sweep_b5(names, built, base: dict, check_only: bool):
    """One record a variant; returns (records, failed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as b5

    gen = torch.Generator(device="cuda").manual_seed(11)
    inputs = {}
    for dname in ("bfloat16", "float16"):
        dt = getattr(torch, dname)
        for shp in tuple(cs.FLASH_SHAPES) + EDGE_SHAPES:
            bsz, seq, heads, kv, hd = shp
            q, k, v = (torch.randn((bsz, seq, n, hd), generator=gen,
                                   device="cuda").to(dt)
                       for n in (heads, kv, kv))
            for causal in (True, False):
                inputs[(dname, shp, causal)] = (
                    q, k, v, b5.flash_attention_plain(q, k, v, causal=causal))
    records, failed = [], False
    for name in names:
        lib, log = built[name]
        rec = {"variant": name, **parse("b5", name), **base}
        if lib is None:
            rec["build_error"] = log[-3000:]
            failed = True
            records.append(rec)
            continue
        rec["registers_spills"] = regs(log, "flash_wgmma_kernel")
        fn = load(lib, "flash_attention_fwd", b5._ARGTYPES)

        def run(q, k, v, causal, fn=fn):
            out = torch.empty_like(q)
            bsz, seq, heads, hd = q.shape
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bsz, seq, heads, k.shape[2], hd, 1.0 / math.sqrt(hd),
                    int(causal), _build.DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream().cuda_stream)
            _build.check_launch("flash_attention variant", rc)
            return out
        worst, worst_row = {}, {}
        for (dname, shp, causal), (q, k, v, want) in inputs.items():
            got = run(q, k, v, causal)
            torch.cuda.synchronize()
            err, scale = cs.max_err(got, want)
            rerr = cs.row_err(got, want)
            key = f"{dname} hd{shp[4]}"
            worst[key] = max(worst.get(key, 0.0), err / scale)
            worst_row[key] = max(worst_row.get(key, 0.0), rerr)
            if err > cs.FLASH_TOL[dname] * scale or \
                    rerr > cs.FLASH_ROW_TOL[dname]:
                failed = True
                rec.setdefault("over_tolerance", []).append(
                    [dname, list(shp), causal, err, scale, rerr])
        rec["max_err_rel"] = worst
        rec["max_row_err"] = worst_row
        if not check_only:
            timed = []
            for bsz, seq, heads, kv, hd, causal in TIMED:
                q, k, v = (torch.randn((bsz, seq, n, hd), generator=gen,
                                       device="cuda").to(torch.bfloat16)
                           for n in (heads, kv, kv))
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                got = run(q, k, v, causal)
                want = b5.flash_attention_plain(q, k, v, causal=causal)
                lib_out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal,
                    enable_gqa=True).transpose(1, 2)
                timed.append({
                    "shape": [bsz, seq, heads, kv, hd], "causal": causal,
                    "ms": cs.time_ms(lambda: run(q, k, v, causal)),
                    "library_ms": cs.time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=True)),
                    "max_abs_err": cs.max_err(got, want)[0],
                    "library_max_abs_err": cs.max_err(lib_out, want)[0],
                    "max_row_err": cs.row_err(got, want),
                    "library_max_row_err": cs.row_err(lib_out, want),
                    "mean_abs_plain": float(want.double().abs().mean()),
                    **cs.flash_bound(q, k, causal=causal)})
                del q, k, v, qt, kt, vt, got, want, lib_out
            rec["timed"] = timed
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records, failed


def sweep_b4(names, built, base: dict):
    """One record a variant and dtype; returns (records, failed)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, spmm_sdd
    from repro_torch.models import sparse_linear_from_dense

    records, failed = [], False
    for name in names:
        if built[name][0] is None:
            failed = True
            records.append({"variant": name, **base,
                            "build_error": built[name][1][-3000:]})
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((cs.FFN_D_OUT, cs.FFN_D_IN)) * 0.02).astype(
        np.float32)
    gen = torch.Generator(device="cuda").manual_seed(30)
    for dname, tag in (("float32", "IffLi8"),
                       ("bfloat16", "If13__nv_bfloat16Li16")):
        dt = getattr(torch, dname)
        layer = sparse_linear_from_dense(torch.from_numpy(w).to(dt),
                                         cs.FFN_SPARSITY, device="cuda")
        fmt = layer.fmt
        p = fmt.on("cuda").bcsr
        r_b, br = fmt.r_boundary, fmt.bcsr_part.br
        nrows = fmt.nrows - r_b
        x = torch.randn(cs.FFN_X_SHAPE, generator=gen, device="cuda").to(dt)
        b3 = x.transpose(-1, -2).contiguous()
        dy3 = torch.randn((cs.FFN_X_SHAPE[0], cs.FFN_D_OUT,
                           cs.FFN_X_SHAPE[1]), generator=gen, device="cuda")
        kw = {"br": br, "row_offset": r_b, "nrows": nrows}
        want = spmm_sdd.bcsr_sdd_panels_plain(p.rows, p.cols, p.mask, dy3,
                                              b3, **kw)
        absprod = spmm_sdd.bcsr_sdd_panels_plain(p.rows, p.cols, p.mask,
                                                 dy3.abs(), b3.abs(), **kw)
        units = p.units
        for name in names:
            lib, log = built[name]
            if lib is None:
                continue
            fn = load(lib, "bcsr_sdd_panels", spmm_sdd._BCSR_ARGTYPES)

            def run(fn=fn):
                out = torch.empty(want.shape, dtype=want.dtype,
                                  device="cuda")
                rc = fn(units.units.data_ptr(), p.cols.data_ptr(),
                        p.mask.data_ptr(), dy3.data_ptr(), b3.data_ptr(),
                        out.data_ptr(), units.nunits, br, p.cols.shape[1],
                        dy3.shape[1], b3.shape[1], b3.shape[2], b3.shape[0],
                        r_b, nrows, _build.DTYPE_CODES[dy3.dtype],
                        _build.DTYPE_CODES[b3.dtype],
                        torch.cuda.current_stream().cuda_stream)
                _build.check_launch("bcsr_sdd variant", rc)
                return out
            got = run()
            again = run()
            torch.cuda.synchronize()
            err, rel = cs.sum_err(got, want, absprod)
            same = bool(torch.equal(got, again))
            failed |= not (rel <= cs.TOL[dname] and same)
            rec = {"variant": name, **parse("b4", name), **base,
                   "dtype": dname, "registers_spills": regs(log, tag),
                   "npanels": int(p.rows.numel()), "nunits": units.nunits,
                   "max_abs_err": err, "max_err_of_absprod": rel,
                   "bitwise_repeatable": same,
                   "ms": cs.time_ms(run), "device_ms": cs.device_ms(run),
                   **cs.sdd_bound(p, dy3, b3, got, br=br, dy_rows=nrows,
                                  dtype=dname)}
            rec.update(cs.rate(rec))
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del layer, fmt, p, x, b3, dy3, want, absprod
        torch.cuda.empty_cache()
    return records, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--variants", default=None)
    ap.add_argument("--check-only", action="store_true",
                    help="B5: skip the timings")
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose kernel source is built")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    names = (args.variants or KERNELS[args.kernel][2]).split(",")
    for name in names:
        parse(args.kernel, name)
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    root = args.root.resolve()
    built = build(args.kernel, names, root)
    base = {"kernel": args.kernel, "root": str(root), "nvidia_smi": smi}
    if args.kernel == "b5":
        records, failed = sweep_b5(names, built, base, args.check_only)
    else:
        records, failed = sweep_b4(names, built, base)
    for rec in records:
        if "build_error" in rec:
            print(json.dumps(rec), flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        path = args.out / "kernel_sweep.json"
        old = json.loads(path.read_text()) if path.exists() else []
        path.write_text(json.dumps(old + records, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
