"""Build the port's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into ``build/repro_torch/`` under the repository
root.  All sources are compiled at once, one ``nvcc`` process each.  A
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

The wrappers launch on ``torch.cuda.current_stream()`` and check the C
function's return value (``cudaGetLastError()`` after the launch): a launch
that the device refuses raises here instead of failing silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

import torch

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "DTYPE_CODES", "build_all",
           "build_log", "kernel_fn", "check_launch"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

# Must match csrc/panel_common.cuh::DType.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_UNSUPPORTED = -1

# Compiler output (ptxas register and spill report) per source, for logs.
build_log: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin); the CUDA kernels cannot be built")
    return path


def _library_path(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel;
    return ``{source stem: library path}``.  Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _library_path(src))
               for src in sorted(CSRC.glob("*.cu"))}
    nvcc = _nvcc()
    procs = {}
    for stem, (src, lib) in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for stem, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_log[stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in targets.items()}


def kernel_fn(source: str, symbol: str, argtypes: Sequence):
    """The C function ``symbol`` of ``csrc/<source>.cu``, built and loaded
    on first use, with ``argtypes`` declared and an ``int`` return (kept
    after the first call: a launch pays one dictionary lookup)."""
    fn = _FNS.get((source, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(str(build_all()[source]))
        fn = getattr(_LIBS[source], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(source, symbol)] = fn
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's C entry point reported a failed launch."""
    if rc == _UNSUPPORTED:
        raise ValueError(f"{name}: no kernel is built for this dtype pair "
                         "or tile height")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
