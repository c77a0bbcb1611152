"""Production-mesh dry-run: trace one rank's step for every (arch x shape
x mesh) cell.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's jitted step against abstract inputs at 256 / 512 placeholder
devices; the port has no compiler to ask, so it runs rank 0's eager step
once (:func:`trace_cell`) on fake tensors (``FakeTensorMode``: nothing is
allocated, no kernel launches, B1-B5 run their operators' shape
functions) on the production mesh of ``launch/mesh.py::
make_production_mesh``, whose ``fake`` process group the process joins as
that rank.  A trace that completes shows that the step's shapes and its
collectives agree at production scale: every sharded matmul, the
``model`` splits of heads and vocabulary, the data rows of a batch (padded
where the data ranks do not divide it), the ZeRO reduce-scatter over all
ranks, the multi-pod ``pod`` axis folded into the data ranks.

The steps are the port's own: ``dist/step.py::build_train_step(mesh=)``
(``default_microbatches`` of them), ``build_prefill`` and
``build_serve_step``, on the rank's parameter shards
(``models/api.py::shard_params``) and cache shard
(``dist/step.py::local_cache``) from ``launch/specs.py``.  For each cell
this records, into ``build/dryrun/<arch>__<shape>__<mesh>.json`` (the
reference's keys):

  * ``hlo``: the per-device flops, HBM bytes, collective bytes (and by
    kind) that ``perf/hlo_analysis.py`` counts over the traced operators
    (the key keeps the reference's name; ``n_ops`` stands where the
    reference has the HLO text's length);
  * ``memory_analysis``: the rank's argument bytes (parameters, optimizer
    state, batch, cache), output bytes, and the peak of the storage the
    step allocated (``temp_size_in_bytes``);
  * ``trace_s``: the wall time of the trace, which stands where the
    reference has ``lower_s`` and ``compile_s``.

``--keep-trace`` also writes the traced operators (shapes, dtypes and
their counts, one JSON line each) beside the record, where the reference
keeps ``.hlo.txt``; ``benchmarks/reanalyze.py`` recounts them.  A failing
cell is recorded with its error and the run exits 1.

The traced tensors claim ``--device`` (default ``cuda``; the trace needs
no card, but this CPU-only PyTorch cannot fake a CUDA ``copy_``, so on a
machine without one pass ``--device meta``, which also runs B1-B5's
operators, or ``cpu``, where the wrappers take their plain versions).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ALL_ARCHS, SHAPES, applicable_shapes, get_config
from ..dist import step as step_lib
from ..models import api
from ..optim import adamw
from ..optim.adamw import OptConfig
from ..perf.hlo_analysis import StepTrace, hlo_of, save_ops
from . import specs
from .mesh import make_production_mesh

__all__ = ["RESULTS_DIR", "trace_cell", "run_cell", "fake_world", "fake_mode",
           "warm_mesh", "main"]

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A ``fake`` process group of ``world`` ranks joined as ``rank`` for
    the duration (torn down after, so the next cell may join another)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mode():
    """The trace's ``FakeTensorMode``.  A real tensor that the step makes
    from host data (an index built from a tuple, say) joins the trace as
    a fake one: nothing reads its values."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def warm_mesh(mesh) -> None:
    """Build ``mesh``'s flattened sub-meshes (the data axes, all axes)
    before a fake trace: ``DeviceMesh`` computes them with tensor ops on
    its real rank map, which a ``FakeTensorMode`` refuses, and keeps them
    once built."""
    from ..dist.sharding import worker_mesh
    from .mesh import dp_axes, flat_axes
    for axes in (dp_axes(mesh), flat_axes(mesh)):
        if len(axes) > 1:
            worker_mesh(mesh, axes)


def trace_cell(arch: str, shape_name: str, mesh, *, device="cuda",
               overrides: dict | None = None):
    """Trace this rank's step of one cell on ``mesh`` (a production or
    any other mesh on a ``fake`` group) with fake tensors on ``device``.
    Returns ``(trace, n_microbatches, memory)``: the
    :class:`~repro_torch.perf.hlo_analysis.StepTrace` (its ``stats`` and
    ``records``), and the memory record.  ``arch`` is a registered name
    or a ``ModelConfig``; ``overrides`` are ``dataclasses.replace`` fields
    on it."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    world = math.prod(tuple(mesh.shape))
    n_mb = 1
    warm_mesh(mesh)
    with fake_mode():
        params = api.shard_params(cfg, specs.abstract_params(cfg), mesh,
                                  device=device)
        if shape.kind == "train":
            n_mb = step_lib.default_microbatches(shape, mesh)
            batch = specs.train_batch_specs(cfg, shape, n_mb, device=device)
            opt_state = adamw.init_opt_state(
                params, world, param_specs=params.layout.specs, mesh=mesh)
            step = step_lib.build_train_step(cfg, params, OptConfig(),
                                             mesh=mesh, n_microbatches=n_mb)
            inputs, arguments = (params, opt_state, batch), None
        elif shape.kind == "prefill":
            batch = specs.prefill_batch_specs(cfg, shape, device=device)
            cache = step_lib.local_cache(cfg, mesh, shape.global_batch,
                                         shape.seq_len, device=device)
            step = step_lib.build_prefill(
                cfg, params, (shape.global_batch, shape.seq_len), mesh=mesh,
                cache=cache)
            inputs, arguments = (batch,), (params, cache, batch)
        else:
            cache, tokens, length = specs.decode_input_specs(
                cfg, shape, device=device, mesh=mesh)
            step = step_lib.build_serve_step(cfg, params, cache, mesh=mesh)
            inputs, arguments = (tokens, length), (params, cache, tokens)
        with StepTrace(arguments=arguments or inputs) as trace:
            out = step(*inputs)
        memory = trace.memory(out)
    return trace, n_mb, memory


def _record_path(out_dir, arch, shape_name, mesh_kind, tag="") -> pathlib.Path:
    suffix = f"__{tag}" if tag else ""
    return pathlib.Path(out_dir) / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             keep_trace: bool = False, overrides: dict | None = None,
             tag: str = "", device="cuda", out_dir=RESULTS_DIR) -> dict:
    """Trace one cell at the production mesh ``mesh_kind`` (``single``:
    16 x 16, ``multi``: 2 x 16 x 16) as rank 0 and return its record (the
    reference's keys; ``status`` ``ok`` or ``error`` with the error)."""
    t0 = time.time()
    multi = mesh_kind == "multi"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": {}, "status": "error",
           "overrides": overrides or {}, "tag": tag,
           "device": str(torch.device(device)), "rank": 0}
    try:
        world = 512 if multi else 256
        with fake_world(world, 0):
            mesh = make_production_mesh(multi_pod=multi,
                                        device_type=torch.device(device).type)
            rec["mesh_shape"] = dict(zip(mesh.mesh_dim_names,
                                         tuple(mesh.shape)))
            trace, n_mb, memory = trace_cell(arch, shape_name, mesh,
                                             device=device,
                                             overrides=overrides)
        st = trace.stats
        rec["n_microbatches"] = n_mb
        rec["memory_analysis"] = memory
        rec["cost_analysis"] = {"flops": st.flops,
                                "bytes accessed": st.hbm_bytes}
        rec["hlo"] = hlo_of(st, len(trace.records))
        if keep_trace:
            path = _record_path(out_dir, arch, shape_name, mesh_kind,
                                tag).with_suffix(".ops.jsonl")
            path.parent.mkdir(parents=True, exist_ok=True)
            save_ops(trace.records, path)
            rec["trace_path"] = str(path)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - a failed cell is recorded
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        out[key] = val
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--keep-trace", action="store_true",
                    help="also write the traced operators (.ops.jsonl)")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="",
                    help="suffix for result files (perf iterations)")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value, e.g. --set "
                         "ce_chunk=4096")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim: cuda "
                         "(default), meta or cpu")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help=f"records directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    overrides = _overrides(args.set)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ALL_ARCHS if args.all or not args.arch else [args.arch]

    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape
                  else list(applicable_shapes(cfg)))
        for shape_name in shapes:
            for mk in meshes:
                out_path = _record_path(out_dir, arch, shape_name, mk,
                                        args.tag)
                if args.skip_done and out_path.exists():
                    try:
                        if json.loads(out_path.read_text()).get(
                                "status") == "ok":
                            print(f"[skip] {arch} {shape_name} {mk}")
                            continue
                    except ValueError:
                        pass
                rec = run_cell(arch, shape_name, mk,
                               keep_trace=args.keep_trace,
                               overrides=overrides or None, tag=args.tag,
                               device=args.device, out_dir=out_dir)
                out_path.write_text(json.dumps(rec, indent=1))
                ok = rec["status"] == "ok"
                n_ok += ok
                n_fail += not ok
                msg = (f"trace={rec['trace_s']}s "
                       f"flops={rec['hlo']['flops_per_device']:.4g} "
                       f"bytes={rec['hlo']['hbm_bytes_per_device']:.4g} "
                       f"coll={rec['hlo']['collective_bytes_per_device']:.4g}"
                       if ok else rec.get("error", ""))
                print(f"[{'ok' if ok else 'FAIL'}] {arch} {shape_name} {mk} "
                      f"{msg}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
