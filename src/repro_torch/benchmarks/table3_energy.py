"""Paper Table 3: energy efficiency (GFLOP/s per W), measured on the card.

Port of the reference's ``benchmarks/table3_energy.py``, which models
energy as roofline time x 170 W on a TPU v5e.  Here it is measured: for
each of Table 3's six matrices, a loop of ``loops_spmm`` (kernels B1/B2)
that lasts at least ``MIN_LOOP_S`` seconds, then the same loop of
cuSPARSE (``torch.sparse`` CSR @ B), each between two readings of NVML's
total-energy counter (``nvmlDeviceGetTotalEnergyConsumption``, through
``ctypes`` on ``libnvidia-ml.so.1``, which ships with the driver), each
reading taken where the counter changes (it is refreshed at an interval,
recorded as ``energy_refresh_ms``).  The board's power is also sampled with ``nvidia-smi --query-gpu=power.draw``
during each loop as a cross-check, and its idle power is read before the
loops.

Sizes: Table 2's (``fig4_throughput.published_rows``; the block family at
the rows that give the published nonzeros), N = 32, fp16 values and B
with fp32 accumulation (LOOPS writes fp32; the paper's A100 column is
cuSPARSE FP16).  Where this torch has no fp16 CSR product, cuSPARSE runs
in fp32 and its record says so.  The two paper columns (A100 cuSPARSE
FP16 and M4 Pro LOOPS, GFLOP/s per W) are the paper's own numbers,
labelled as such.

No reading, no number: on a CUDA device without NVML the suite raises and
never writes a modelled number in a measured column.  On the CPU it
computes the rows' names, shapes and flop counts at the reference's sizes
(``scale_rows=1024``, seed 6) and leaves the energy columns out, saying
so; ``--smoke`` on the card measures at those sizes with short loops.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only table3
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import time

import numpy as np
import torch

from ..core import loops_spmm, plan_and_convert, suite
from ..kernels.engine import resolve_device
from ._util import csv_row, sparse_operand
from .fig4_throughput import published_rows

N = 32
# (id, paper A100 cuSPARSE FP16 GFLOP/s per W, paper M4 Pro LOOPS GFLOP/s
# per W): the paper's Table 3, verbatim.
PAPER_TABLE3 = [
    ("m6", 2.30, 23.08), ("m8", 2.87, 84.70), ("m14", 2.69, 71.36),
    ("m17", 0.86, 8.53), ("m13", 1.70, 2.56), ("m10", 1.36, 2.76),
]
# The reference's matrices (its CPU sizes): rows and seed.
REFERENCE_ROWS, SEED = 1024, 6
# Each measured loop lasts at least this long (the energy counter counts
# millijoules; the board's power settles within a second).
MIN_LOOP_S = 2.0
SMOKE_LOOP_S = 0.25
# Calls enqueued between two looks at the clock.
LOOP_CHUNK = 16
IDLE_S = 1.0
SMI_PERIOD_MS = 100
# NVML refreshes its energy counter at an interval, not on every read: the
# window of a reading is taken from one change of the counter to another
# (``_tick``), polling every TICK_POLL_S, for at most TICK_WAIT_S.
TICK_POLL_S = 5e-4
TICK_WAIT_S = 5.0
# loops_spmm against the flat path: max |diff| / max(1, max |flat|); both
# accumulate exact fp16 products in fp32, in another order.
TOL = 1e-3

NVML_LIB = "libnvidia-ml.so.1"


class NvmlError(RuntimeError):
    pass


class Nvml:
    """NVML's energy counter and power limit of one card, through
    ``ctypes`` (every function's ``argtypes`` and ``restype`` declared).
    The card is found by its PCI bus id where torch gives one, else by its
    CUDA index; :meth:`close` shuts NVML down."""

    def __init__(self, device: torch.device):
        try:
            lib = ctypes.CDLL(NVML_LIB)
        except OSError as e:
            raise NvmlError(f"NVML ({NVML_LIB}) is not available: no energy "
                            "reading, so no Table 3 number") from e
        c_dev = ctypes.c_void_p
        sigs = {
            "nvmlInit_v2": ([], ctypes.c_int),
            "nvmlShutdown": ([], ctypes.c_int),
            "nvmlErrorString": ([ctypes.c_int], ctypes.c_char_p),
            "nvmlDeviceGetHandleByIndex_v2":
                ([ctypes.c_uint, ctypes.POINTER(c_dev)], ctypes.c_int),
            "nvmlDeviceGetHandleByPciBusId_v2":
                ([ctypes.c_char_p, ctypes.POINTER(c_dev)], ctypes.c_int),
            "nvmlDeviceGetName":
                ([c_dev, ctypes.c_char_p, ctypes.c_uint], ctypes.c_int),
            "nvmlDeviceGetTotalEnergyConsumption":
                ([c_dev, ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int),
            "nvmlDeviceGetEnforcedPowerLimit":
                ([c_dev, ctypes.POINTER(ctypes.c_uint)], ctypes.c_int),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        self._lib = lib
        self._ok(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = c_dev()
        self.pci_bus_id = _pci_bus_id(device)
        if self.pci_bus_id is not None:
            self._ok(lib.nvmlDeviceGetHandleByPciBusId_v2(
                self.pci_bus_id.encode(), ctypes.byref(self._handle)),
                "nvmlDeviceGetHandleByPciBusId_v2")
        else:
            self._ok(lib.nvmlDeviceGetHandleByIndex_v2(
                device.index or 0, ctypes.byref(self._handle)),
                "nvmlDeviceGetHandleByIndex_v2")
        buf = ctypes.create_string_buffer(96)
        self._ok(lib.nvmlDeviceGetName(self._handle, buf, 96),
                 "nvmlDeviceGetName")
        self.name = buf.value.decode()
        if self.name != torch.cuda.get_device_name(device):
            raise NvmlError(f"NVML's card {self.name!r} is not "
                            f"{torch.cuda.get_device_name(device)!r}")

    def _ok(self, ret: int, what: str) -> None:
        if ret != 0:
            raise NvmlError(f"{what} failed: "
                            f"{self._lib.nvmlErrorString(ret).decode()}")

    def energy_j(self) -> float:
        """The board's energy since the driver loaded, in joules."""
        mj = ctypes.c_ulonglong()
        self._ok(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._ok(self._lib.nvmlDeviceGetEnforcedPowerLimit(
            self._handle, ctypes.byref(mw)),
            "nvmlDeviceGetEnforcedPowerLimit")
        return mw.value / 1e3

    def close(self) -> None:
        self._lib.nvmlShutdown()


def _pci_bus_id(device: torch.device) -> str | None:
    """``domain:bus:device.0`` of ``device`` as NVML spells it, or None
    where this torch does not report it."""
    props = torch.cuda.get_device_properties(device)
    ids = [getattr(props, k, None)
           for k in ("pci_domain_id", "pci_bus_id", "pci_device_id")]
    if any(i is None for i in ids):
        return None
    return f"{ids[0]:08X}:{ids[1]:02X}:{ids[2]:02X}.0"


class PowerSampler:
    """``nvidia-smi --query-gpu=power.draw`` every ``SMI_PERIOD_MS`` in a
    process of its own, from :meth:`start` to :meth:`stop` (which ends the
    process and returns the watts it read)."""

    def __init__(self, card: str):
        self.card = card
        self.proc = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", self.card, "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", str(SMI_PERIOD_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list:
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        watts = []
        for line in out.splitlines():
            try:
                watts.append(float(line.strip()))
            except ValueError:
                pass          # "[N/A]" or a line cut by the termination
        return watts


def _tick(nvml: Nvml) -> tuple:
    """Wait for NVML's energy counter to change and return ``(joules,
    host time of the change)``.  The counter is refreshed at an interval,
    so a reading taken at an arbitrary moment is up to one interval old:
    right after heavy work it still lacks part of that work's energy,
    which a window opened there would credit to the window (a host-bound
    loop read 483 W against ``nvidia-smi``'s 164 W so)."""
    e0, t0 = nvml.energy_j(), time.perf_counter()
    while True:
        time.sleep(TICK_POLL_S)
        e, t = nvml.energy_j(), time.perf_counter()
        if e != e0:
            return e, t
        if t - t0 > TICK_WAIT_S:
            raise NvmlError(f"NVML's energy counter did not move in "
                            f"{TICK_WAIT_S} s")


def refresh_ms(nvml: Nvml) -> float:
    """The counter's refresh interval: ms between two of its changes."""
    _, t0 = _tick(nvml)
    _, t1 = _tick(nvml)
    return (t1 - t0) * 1e3


def _energy_loop(fn, nvml: Nvml, sampler: PowerSampler, device,
                 min_s: float) -> dict:
    """``fn`` called back to back, ``LOOP_CHUNK`` calls at a time, until
    ``min_s`` seconds have passed on the host clock, then synchronised.
    The energy window runs from a change of the counter just before the
    first call to the first change after the sync (:func:`_tick`), so it
    holds the loop and at most one refresh interval of the idle card on
    each side; power is sampled alongside.  ``seconds`` is the loop's own
    time (calls to the sync), ``window_s`` the energy window's."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize(device)
    sampler.start()
    e0, w0 = _tick(nvml)
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < min_s:
        for _ in range(LOOP_CHUNK):
            fn()
        calls += LOOP_CHUNK
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    e1, w1 = _tick(nvml)
    watts = sampler.stop()
    secs, joules, window = t1 - t0, e1 - e0, w1 - w0
    return {"calls": calls, "seconds": secs, "ms_per_call": secs / calls * 1e3,
            "window_s": window, "joules": joules, "mean_w": joules / window,
            "j_per_call": joules / calls,
            "smi_mean_w": statistics.fmean(watts) if watts else None,
            "smi_samples": len(watts)}


def _rate(loop: dict, flops: float) -> dict:
    gf = flops * loop["calls"] / loop["seconds"] / 1e9
    return {**loop, "gflops": gf, "gflops_per_w": gf / loop["mean_w"]}


def _matrix(mid: str, rows: int):
    csr = suite.table2_like(mid, scale_rows=rows, seed=SEED,
                            dtype=np.float32)
    return csr.astype(np.float16)


def main(out=print, device: str = "cuda", smoke: bool = False) -> list:
    """Table 3's rows: on a CUDA device measured (at Table 2's sizes, or
    the reference's with ``smoke``), on the CPU the names, shapes and flop
    counts alone.  Prints one CSV row per matrix and returns the records."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    nvml = Nvml(dev) if on_card else None
    records, card = [], {}
    try:
        if on_card:
            sampler = PowerSampler(nvml.pci_bus_id or str(dev.index or 0))
            torch.cuda.synchronize(dev)
            refresh = refresh_ms(nvml)
            e0, t0 = _tick(nvml)
            time.sleep(IDLE_S)
            e1, t1 = _tick(nvml)
            card = {"card": nvml.name, "power_limit_w": nvml.power_limit_w(),
                    "idle_w": (e1 - e0) / (t1 - t0),
                    "energy_refresh_ms": refresh}
        rng = np.random.default_rng(2)
        for mid, a100_eff, m4_eff in PAPER_TABLE3:
            if on_card and not smoke:
                rows, cut = published_rows(mid)
            else:
                rows, cut = REFERENCE_ROWS, None
            csr = _matrix(mid, rows)
            b_np = rng.standard_normal((csr.shape[1], N))
            flops = 2.0 * csr.nnz * N
            rec = {"suite": "table3", "matrix": mid,
                   "name": suite.TABLE2_STATS[mid].name, "rows": rows,
                   "reduced": cut, "nnz": csr.nnz, "n": N,
                   "dtype": "float16", "flops": flops,
                   "paper_a100_cusparse_fp16_gflops_per_w": a100_eff,
                   "paper_m4pro_loops_gflops_per_w": m4_eff, **card}
            if on_card:
                rec.update(_measure(csr, b_np, dev, nvml, sampler, flops,
                                    SMOKE_LOOP_S if smoke else MIN_LOOP_S))
                lp, cs = rec["loops"], rec["cusparse"]
                derived = (f"loops_GFLOPSperW={lp['gflops_per_w']:.2f};"
                           f"cusparse_GFLOPSperW={cs['gflops_per_w']:.2f};"
                           f"loops_W={lp['mean_w']:.1f};"
                           f"cusparse_W={cs['mean_w']:.1f}")
                us = lp["ms_per_call"] * 1e3
            else:
                rec["energy"] = (f"not measured: no card (device "
                                 f"{dev.type}); names, shapes and flop "
                                 "counts only")
                derived = "energy not measured (no card)"
                us = float("nan")
            out(csv_row(f"table3_{mid}_{rec['name']}", us,
                        f"{derived};flops={flops:.0f};"
                        f"paper_A100_cuSparse={a100_eff};"
                        f"paper_M4Pro={m4_eff}"))
            records.append(rec)
    finally:
        if nvml is not None:
            nvml.close()
    return records


def _measure(csr, b_np, dev, nvml, sampler, flops, min_s) -> dict:
    """One matrix on the card: ``loops_spmm`` checked against the flat
    path, then the LOOPS and cuSPARSE energy loops."""
    t0 = time.perf_counter()
    fmt, plan = plan_and_convert(csr, device=dev)
    b = torch.as_tensor(b_np, dtype=torch.float16, device=dev)
    got = loops_spmm(fmt, b, device=dev)
    flat = loops_spmm(fmt, b, device=dev, backend="torch")
    err = float((got - flat).abs().max()) / max(1.0, float(flat.abs().max()))
    if not err <= TOL:
        raise RuntimeError(f"loops_spmm against the flat path: {err:.3g} "
                           f"> {TOL}")
    del got
    torch.cuda.synchronize(dev)
    plan_s = time.perf_counter() - t0
    loops = _rate(_energy_loop(lambda: loops_spmm(fmt, b, device=dev), nvml,
                               sampler, dev, min_s), flops)
    cus = {"dtype": "float16"}
    try:
        a_sp = sparse_operand(csr, dev)
        a_sp @ b
    except RuntimeError as e:
        cus = {"dtype": "float32", "note": f"no fp16 CSR product in this "
               f"torch ({str(e).splitlines()[0][:120]}); cuSPARSE in fp32"}
        a_sp = sparse_operand(csr, dev, dtype=torch.float32)
        b = b.float()
    cus_err = float((a_sp @ b).float().sub(flat).abs().max()) / max(
        1.0, float(flat.abs().max()))
    cus.update(_rate(_energy_loop(lambda: a_sp @ b, nvml, sampler, dev,
                                  min_s), flops), max_err=cus_err)
    del fmt, a_sp, b, flat
    torch.cuda.empty_cache()
    return {"r_boundary": plan.r_boundary, "br": plan.br, "plan_s": plan_s,
            "max_err": err, "loops": loops, "cusparse": cus}

