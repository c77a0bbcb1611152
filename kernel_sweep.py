#!/usr/bin/env python3
"""Build variants of the CUDA kernels B5 (flash attention), B4 (BCSR SDD)
and B3 (CSR SDD) and check and time them on one GPU.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 kernel_sweep.py b5 [--variants k64s3h2,...] [--check-only]
    python3 kernel_sweep.py b4 [--variants w8s2r4b2,...]
    python3 kernel_sweep.py b3 [--variants t512k16s2c2r64b1d128j8e6,...]
                               [--base DIR] [--probe stage|compute]
    (each also takes [--root DIR] [--out DIR])

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
* B3 (``src/repro_torch/csrc/csr_sdd.cu``), staged blocks: ``t`` threads
  a CTA (``kThreads``), ``k`` outputs a lane group keeps (``kOuts``), ``s``
  buffers of the ring (``kStages``), ``c`` lines of a row a chunk holds
  (``kChunkLines``), ``r`` rows of a row group (the block table's
  ``BLOCK_ROWS``), ``b`` CTAs an SM must hold (``kMinBlocks``); direct
  blocks: ``d`` threads a CTA (``kDirectThreads``), ``j`` outputs a lane
  group keeps (``kDirectOuts``), ``e`` CTAs an SM must hold
  (``kDirectMinBlocks``).  The table's ``BLOCK_OUTS`` and ``DIRECT_OUTS``
  follow t / 8 x k and d / 8 x j.

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
* B3, at phase ``train_ffn``'s shapes (the layer's CSR part, fp32 and bf16
  as for B4) and on the CSR part of phase ``main``'s in-2004-like m4
  (1.4M rows, its hub rows; N = 32, fp32): for each variant its block
  table's counts, the error against ``csr_sdd_panels_plain`` relative to
  |dY|·|B| (at ``chip_smoke.TOL``), whether two calls are bitwise equal,
  two CUDA-event times taken in turns (every kernel once in order, then
  once in the reverse order), the device time, the bound and
  ``torch.sparse.sampled_addmm``'s time.  ``--base DIR`` also builds the
  B3 source of another checkout as it is (its own constants and C
  interface, the first design's included) and times it in the same turns.
  ``--probe stage`` builds the variants with the staged kernel's compute
  loop cut out (staging only), ``--probe compute`` with its staging cut
  out (compute on whatever shared memory holds): their times say which of
  the two bounds the staged blocks; their results are wrong by design and
  are not checked.

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
import statistics
import subprocess
import sys
import time

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
    # r is the block table's BLOCK_ROWS, not a constant of the source.
    "b3": ("csr_sdd.cu",
           {"t": "kThreads", "k": "kOuts", "s": "kStages",
            "c": "kChunkLines", "r": "BLOCK_ROWS", "b": "kMinBlocks",
            "d": "kDirectThreads", "j": "kDirectOuts",
            "e": "kDirectMinBlocks"},
           "t512k16s2c2r64b1d128j8e6,t512k16s2c2r64b1d128j8e5,"
           "t512k16s3c2r64b1d128j8e6,t256k16s2c2r64b2d128j8e6,"
           "t512k16s2c1r64b1d128j8e6,t512k16s2c2r96b1d128j8e6,"
           "t512k16s2c2r64b1d256j8e3"),
}
# B3's first design (before its block table): the C interface it had.
B3_FIRST_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6
                     + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    variant's value; each constant must be defined exactly once.  Names
    that are not the source's constants (``k...``) are skipped."""
    for name, value in consts.items():
        if not name.startswith("k"):
            continue
        text, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise SystemExit(f"{name} is defined {hits} times, not once")
    return text


# B3 probes: the staged kernel's source with one half cut out.
PROBES = {
    "stage": ("        for (int o = 0; o < kOuts; ++o) {\n          if (o == 0",
              "        for (int o = 0; o < 0; ++o) {\n          if (o == 0"),
    "compute": ("  auto stage = [&](int buf) {\n",
                "  auto stage = [&](int buf) {\n    return;\n"),
}


def probe_source(text: str, probe: str) -> str:
    """``text`` (csr_sdd.cu) with the probe's half of the staged kernel cut
    out; the cut must match exactly once."""
    old, new = PROBES[probe]
    if text.count(old) != 1:
        raise SystemExit(f"probe {probe}: the source does not match once")
    return text.replace(old, new)


def build(kernel: str, names, root: pathlib.Path, *, as_is: bool = False,
          probe: str | None = None):
    """Compile every variant of ``root``'s source at once (``as_is``: the
    source itself, under the first name; ``probe``: B3 with one half cut
    out); return {name: (library or None, ptxas log)}."""
    from repro_torch.kernels import _build
    csrc = root / "src" / "repro_torch" / "csrc"
    src_name = KERNELS[kernel][0]
    text = (csrc / src_name).read_text()
    if probe is not None:
        text = probe_source(text, probe)
    tag = hashlib.sha1(f"{root}{probe}".encode()).hexdigest()[:8]
    out_dir = HERE / "build" / "kernel_sweep" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        stem = f"{src_name[:-3]}_{name}"
        src = out_dir / f"{stem}.cu"
        src.write_text(text if as_is else
                       variant_source(text, parse(kernel, name)))
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
                    torch.cuda.current_stream().cuda_stream, None)
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


def _b3_shapes():
    """Yield (shape, dtype, panels, dy3, b3, part CSR, part rows) for B3:
    the sparse FFN's CSR part (fp32, bf16), then m4's (fp32, N 32)."""
    import numpy as np
    import torch
    from repro_torch.core import (csr_from_dense, plan_and_convert, suite)
    from repro_torch.core.formats import csr_slice_rows
    from repro_torch.models import magnitude_prune, sparse_linear_from_dense
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((cs.FFN_D_OUT, cs.FFN_D_IN)) * 0.02).astype(
        np.float32)
    gen = torch.Generator(device="cuda").manual_seed(30)
    for dname in cs.FFN_DTYPES:
        dt = getattr(torch, dname)
        wt = torch.from_numpy(w).to(dt)
        fmt = sparse_linear_from_dense(wt, cs.FFN_SPARSITY,
                                       device="cuda").fmt
        x = torch.randn(cs.FFN_X_SHAPE, generator=gen, device="cuda").to(dt)
        b3 = x.transpose(-1, -2).contiguous()
        dy3 = torch.randn((cs.FFN_X_SHAPE[0], cs.FFN_D_OUT,
                           cs.FFN_X_SHAPE[1]), generator=gen, device="cuda")
        csr = csr_from_dense(magnitude_prune(wt.float().numpy(),
                                             cs.FFN_SPARSITY))
        yield ("ffn", dname, fmt.on("cuda").csr, dy3, b3,
               csr_slice_rows(csr, 0, fmt.r_boundary), fmt.r_boundary)
    mid, rows, _ = next(m for m in cs.MAIN_MATRICES if m[0] == "m4")
    csr = suite.table2_like(mid, scale_rows=rows, seed=0, dtype=np.float32)
    fmt, _ = plan_and_convert(csr, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b3 = torch.randn((1, csr.shape[1], cs.MAIN_N), generator=gen,
                     device="cuda")
    dy3 = torch.randn((1, csr.nrows, cs.MAIN_N), generator=gen,
                      device="cuda")
    yield ("m4", "float32", fmt.on("cuda").csr, dy3, b3,
           csr_slice_rows(csr, 0, fmt.r_boundary), fmt.r_boundary)


def sweep_b3(names, built, base: dict, based, probe: str | None = None):
    """Records a variant (and the ``--base`` build, ``based``: (library,
    log) or None) and shape; returns (records, failed).  Under a probe the
    results are not checked."""
    import torch
    from repro_torch.kernels import _build, spmm_sdd
    records, failed = [], False
    entries = []                      # (label, parsed constants, fn, log)
    if based is not None:
        lib, log = based
        if lib is None:
            return [{"variant": "base", **base,
                     "build_error": log[-3000:]}], True
        text = (pathlib.Path(base["base"]) / "src" / "repro_torch" / "csrc"
                / "csr_sdd.cu").read_text()
        first = "kOuts" not in text     # the first design's interface
        entries.append(("base", None if first else {}, load(
            lib, "csr_sdd_panels",
            B3_FIRST_ARGTYPES if first else spmm_sdd._CSR_ARGTYPES), log))
    for name in names:
        lib, log = built[name]
        if lib is None:
            failed = True
            records.append({"variant": name, **base,
                            "build_error": log[-3000:]})
            continue
        entries.append((name, parse("b3", name), load(
            lib, "csr_sdd_panels", spmm_sdd._CSR_ARGTYPES), log))
    for shape, dname, p, dy3, b3, part, r_b in _b3_shapes():
        dt = getattr(torch, dname)
        want = spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask, dy3, b3)
        absprod = spmm_sdd.csr_sdd_panels_plain(p.rows, p.cols, p.mask,
                                                dy3.abs(), b3.abs())
        zn = b3.shape[0] * b3.shape[2]
        lib_ms, lib_what = cs.library_sdd_ms(
            part, dy3[:, :r_b].permute(1, 0, 2).reshape(r_b, zn),
            b3.permute(0, 2, 1).reshape(zn, b3.shape[1]), dt)
        npanels, g = p.cols.shape
        runs, recs = [], []
        for label, consts, fn, log in entries:
            table = None
            if consts is not None and "BLOCK_ROWS" in consts:
                table = spmm_sdd.sdd_block_table(
                    p.rows, p.cols, p.mask, block_rows=consts["BLOCK_ROWS"],
                    block_outs=consts["kThreads"] // 8 * consts["kOuts"],
                    direct_outs=consts["kDirectThreads"] // 8
                    * consts["kDirectOuts"])
            elif consts is not None:
                table = p.sdd_blocks

            def run(fn=fn, table=table):
                out = torch.empty(want.shape, dtype=want.dtype,
                                  device="cuda")
                args = [p.rows.data_ptr(), p.cols.data_ptr(),
                        p.mask.data_ptr(), dy3.data_ptr(), b3.data_ptr(),
                        out.data_ptr()]
                shape = [g, dy3.shape[1], b3.shape[1], b3.shape[2],
                         b3.shape[0]]
                if table is None:
                    args += [npanels] + shape
                else:
                    args = [table.blocks.data_ptr(), table.outs.data_ptr(),
                            table.info.data_ptr(), table.cols.data_ptr(),
                            *args, table.nblocks, table.nstaged,
                            table.max_rows, table.max_cols, *shape]
                rc = fn(*args, _build.DTYPE_CODES[dy3.dtype],
                        _build.DTYPE_CODES[b3.dtype],
                        torch.cuda.current_stream().cuda_stream)
                _build.check_launch("csr_sdd variant", rc)
                return out
            rec = {"variant": label, **base, "shape": shape, "dtype": dname,
                   "registers_spills": regs(log, "IffE" if dname ==
                                            "float32" else
                                            "If13__nv_bfloat16E"),
                   "npanels": npanels, "library_ms": lib_ms,
                   "library": lib_what}
            if consts:
                rec.update({k: v for k, v in consts.items()})
            if table is not None:
                rec.update(cs.block_counts(table))
            try:
                got = run()
                again = run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                failed = True
                rec["launch_error"] = str(e)[:300]
                records.append(rec)
                print(json.dumps(rec), flush=True)
                continue
            err, rel = cs.sum_err(got, want, absprod)
            same = bool(torch.equal(got, again))
            if probe is None:
                failed |= not (rel <= cs.TOL[dname] and same)
            rec.update({"max_abs_err": err, "max_err_of_absprod": rel,
                        "bitwise_repeatable": same,
                        **cs.sdd_bound(p, dy3, b3, got, br=1, dy_rows=r_b,
                                       dtype=dname)})
            runs.append(run)
            recs.append(rec)
            del got, again
        # In turns: each kernel once in order, then once in reverse.
        for i in list(range(len(runs))) + list(reversed(range(len(runs)))):
            recs[i].setdefault("ms_in_turns", []).append(cs.time_ms(runs[i]))
        for rec, run in zip(recs, runs):
            rec["ms"] = statistics.median(rec["ms_in_turns"])
            rec["device_ms"] = cs.device_ms(run)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                run()
            rec["host_issue_ms"] = (time.perf_counter() - t0) * 1e3 / 20
            torch.cuda.synchronize()
            rec.update(cs.rate(rec))
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del p, dy3, b3, want, absprod, runs
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
    ap.add_argument("--probe", choices=sorted(PROBES), default=None,
                    help="B3: time the staged kernel's staging or compute "
                         "alone")
    ap.add_argument("--base", type=pathlib.Path, default=None,
                    help="B3: a checkout whose source is built as it is "
                         "and timed in turns with the variants")
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
    if args.probe is not None and args.kernel != "b3":
        raise SystemExit("--probe is for b3")
    built = build(args.kernel, names, root, probe=args.probe)
    base = {"kernel": args.kernel, "root": str(root), "nvidia_smi": smi,
            "probe": args.probe}
    if args.kernel == "b5":
        records, failed = sweep_b5(names, built, base, args.check_only)
    elif args.kernel == "b4":
        records, failed = sweep_b4(names, built, base)
    else:
        based = None
        if args.base is not None:
            base["base"] = str(args.base.resolve())
            based = build("b3", ["base"], args.base.resolve(),
                          as_is=True)["base"]
        records, failed = sweep_b3(names, built, base, based, args.probe)
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
