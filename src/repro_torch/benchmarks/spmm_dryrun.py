"""The paper's operator at production scale: distributed LOOPS SpMM on the
full 16 x 16 mesh, traced.

Port of the reference's ``benchmarks/spmm_dryrun.py``: an in-2004-like web
matrix (1,400,000 rows, mean 12.23 nonzeros a row, Pareto 1.1 skew, seed
0, the reference's generator) with N = 32, over 256 SpMM workers (the
flattened ``("data", "model")`` axis).  The format's boundary is the
reference's (Eq. 1 at its 1:4 throughput ratio); the ranks are split by
``core/distributed.py::shard_loops_auto`` (the nnz split) unless
``--g-frac`` names the CSR group's share; ``--sorted`` builds the format
through ``core/formats.py::loops_from_csr_sorted``.

The reference compiles one SPMD program; here each rank runs its own chunk,
so two ranks are traced (``launch/dryrun.py``'s fake process group and
fake tensors: nothing is allocated or launched): the first rank of the
CSR group (B1) and the BCSR rank with the most tiles (B2), each through
``distributed_spmm``, the chunk's product and the ``all_gather`` of the
rows (none with ``--no-assemble``).  Both are recorded, and the record's
per-device figures are the larger of the two.  The record goes to
``build/dryrun/loops-spmm__<tag>__single.json`` like any dry-run cell.

Registered in ``benchmarks/run.py`` as suite ``spmm_dryrun`` (by name;
``--smoke`` runs 20,000 rows).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from ..launch.dryrun import RESULTS_DIR
from ..perf.hlo_analysis import hlo_of
from ._util import card_label, csv_row

__all__ = ["in2004_like", "build_sharded", "trace_rank", "merge_ranks",
           "main", "bench_main"]

D = 256
AXIS = ("data", "model")


def in2004_like(rows: int = 1_400_000, mean_nnz: float = 12.23,
                seed: int = 0):
    """The reference's in-2004-like matrix: Pareto(1.1) row counts scaled
    to ``mean_nnz``, uniform columns, normal values (fp32)."""
    from ..core import csr_from_coo
    rng = np.random.default_rng(seed)
    n = rows
    raw = rng.pareto(1.1, n) + 1.0
    counts = np.minimum((raw / raw.mean() * mean_nnz).astype(np.int64), n)
    r = np.repeat(np.arange(n, dtype=np.int64), counts)
    cols = rng.integers(0, n, r.shape[0])
    vals = rng.standard_normal(r.shape[0]).astype(np.float32)
    return csr_from_coo(r, cols, vals, (n, n))


def build_sharded(csr, num_devices: int = D, *, g_frac=None,
                  boundary_frac=None, sorted_rows: bool = False):
    """``(format, sharded)``: the reference's boundary (Eq. 1 with the
    CSR : BCSR throughput 1 : 4 over ``num_devices`` workers, or
    ``boundary_frac`` of the rows), Br 8, and the rank split of
    ``shard_loops_auto`` (or ``g_frac`` of the ranks in the CSR group)."""
    from ..core.distributed import shard_loops, shard_loops_auto
    from ..core.formats import loops_from_csr, loops_from_csr_sorted
    from ..core.partition import choose_r_boundary
    n = csr.shape[0]
    t_mxu = max(int(round(num_devices * 4.0 / 5.0)), 1)
    t_vpu = max(num_devices - t_mxu, 1)
    if boundary_frac is not None:
        r_b = int(boundary_frac * n) // 8 * 8
    else:
        r_b = choose_r_boundary(n, 1.0, 4.0, t_vpu, t_mxu, br=8)
    fmt = (loops_from_csr_sorted(csr, r_b, 8)[0] if sorted_rows
           else loops_from_csr(csr, r_b, 8))
    if g_frac is not None:
        return fmt, shard_loops(fmt, num_devices,
                                max(int(g_frac * num_devices), 1))
    return fmt, shard_loops_auto(fmt, num_devices)


def trace_rank(sharded, rank: int, n_cols: int, *, device="cuda",
               assemble: bool = True, world: int = D):
    """Trace rank ``rank``'s ``distributed_spmm`` of ``sharded`` against a
    fake (K, ``n_cols``) fp32 operand on a 16 x 16 mesh (or ``world`` ranks
    flattened on one axis when it is not 256).  Returns ``(trace,
    memory)``."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..core.distributed import distributed_spmm
    from ..launch.dryrun import fake_mode, fake_world, warm_mesh
    from ..kernels.engine import resolve_device
    from ..perf.hlo_analysis import StepTrace
    shape = (16, 16) if world == D else (world // 2, 2)
    with fake_world(world, rank):
        mesh = DeviceMesh(torch.device(device).type,
                          torch.arange(world).view(shape),
                          mesh_dim_names=AXIS)
        warm_mesh(mesh)
        with fake_mode():
            dev = resolve_device(device)
            chunk = sharded.chunk(rank)
            if chunk is not None:
                chunk.on(dev)       # the rank's panels: inputs, not work
            b = torch.empty((sharded.shape[1], n_cols), dtype=torch.float32,
                            device=dev)
            args = (b, chunk.on(dev) if chunk is not None else None)
            with StepTrace(arguments=args) as trace:
                out = distributed_spmm(sharded, b, mesh, axis=AXIS,
                                       assemble=assemble, device=dev)
            memory = trace.memory(out)
    return trace, memory


def merge_ranks(rec: dict) -> dict:
    """Set ``rec``'s per-device figures to the larger of its traced
    ranks'."""
    per = [v["hlo"] for v in rec["ranks"].values()]
    kinds = {k for h in per for k in h["collective_by_kind"]}
    rec["hlo"] = {k: max(h[k] for h in per) for k in per[0]
                  if k != "collective_by_kind"}
    rec["hlo"]["collective_by_kind"] = {
        k: max(h["collective_by_kind"].get(k, 0) for h in per)
        for k in sorted(kinds)}
    mems = [v["memory_analysis"] for v in rec["ranks"].values()]
    rec["memory_analysis"] = {k: max(m[k] for m in mems) for k in mems[0]}
    return rec


def main(argv=None, out=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_400_000)
    ap.add_argument("--mean-nnz", type=float, default=12.23)  # in-2004
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--g-frac", type=float, default=None,
                    help="fraction of ranks in the CSR group (default: "
                         "shard_loops_auto's nnz split)")
    ap.add_argument("--boundary-frac", type=float, default=None,
                    help="override r_boundary / nrows")
    ap.add_argument("--tag", default="spmm")
    ap.add_argument("--keep-trace", action="store_true")
    ap.add_argument("--no-assemble", action="store_true",
                    help="keep C row-sharded (no all_gather of the rows)")
    ap.add_argument("--sorted", action="store_true",
                    help="nnz-descending row sort before the split")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim: cuda "
                         "(default), meta or cpu")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    t0 = time.time()
    csr = in2004_like(args.rows, args.mean_nnz)
    out(f"matrix built: {csr.shape} nnz={csr.nnz} ({time.time() - t0:.1f}s)")
    fmt, sharded = build_sharded(csr, D, g_frac=args.g_frac,
                                 boundary_frac=args.boundary_frac,
                                 sorted_rows=args.sorted)
    g = sharded.g_vpu
    out(f"format: r_boundary={fmt.r_boundary} g_vpu={g} "
        f"({time.time() - t0:.1f}s)")
    ranks = {}
    if g > 0:
        ranks["csr"] = 0
    if g < D:
        ranks["bcsr"] = g + int(np.argmax(sharded.tile_count[g:]))
    rec = {"arch": "loops-spmm-in2004", "shape": f"spmm_n{args.n}",
           "mesh": "single", "mesh_shape": {"data": 16, "model": 16},
           "status": "ok", "tag": args.tag, "device": args.device,
           "overrides": {"g_frac": args.g_frac,
                         "boundary_frac": args.boundary_frac,
                         "sorted": args.sorted,
                         "r_boundary": int(fmt.r_boundary), "g_vpu": int(g),
                         "nnz": int(csr.nnz),
                         "rows_pad": int(sharded.rows_pad)},
           "ranks": {}}
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / f"loops-spmm__{args.tag}__single.json"
    t1 = time.time()
    for group, r in ranks.items():
        tr, mem = trace_rank(sharded, r, args.n, device=args.device,
                             assemble=not args.no_assemble)
        rec["ranks"][group] = {"rank": r, "nnz": int(sharded.nnz_count[r]),
                               "tiles": int(sharded.tile_count[r]),
                               "hlo": hlo_of(tr.stats, len(tr.records)),
                               "memory_analysis": mem}
        if args.keep_trace:
            from ..perf.hlo_analysis import save_ops
            tpath = path.with_name(f"{path.stem}__{group}.ops.jsonl")
            save_ops(tr.records, tpath)
            rec["ranks"][group]["trace_path"] = str(tpath)
    rec["trace_s"] = round(time.time() - t1, 2)
    merge_ranks(rec)
    path.write_text(json.dumps(rec, indent=1))
    useful = 2.0 * csr.nnz * args.n / D
    flops = rec["hlo"]["flops_per_device"]
    out(f"[ok] trace={rec['trace_s']}s flops/dev={flops:.3e} "
        f"useful/dev={useful:.3e} ratio={useful / max(flops, 1):.3f}")
    out(f"     hbm/dev={rec['hlo']['hbm_bytes_per_device'] / 1e9:.3f} GB  "
        f"coll/dev={rec['hlo']['collective_bytes_per_device'] / 1e6:.3f} MB"
        f" -> {path}")
    return rec


def bench_main(out=print, smoke: bool = False, device: str = "cuda"):
    """Suite ``spmm_dryrun`` of ``benchmarks/run.py``: the full-size cell
    (20,000 rows with ``smoke``), CSV rows with the card beside them."""
    argv = ["--device", device]
    if smoke:
        argv += ["--rows", "20000", "--tag", "spmm-smoke"]
    rec = main(argv, out=lambda line: None)
    h = rec["hlo"]
    out(csv_row(f"spmm_dryrun_{rec['tag']}", 0.0,
                f"flops={h['flops_per_device']:.4g};"
                f"hbm_bytes={h['hbm_bytes_per_device']:.4g};"
                f"collective_bytes={h['collective_bytes_per_device']:.4g};"
                f"g_vpu={rec['overrides']['g_vpu']};trace_s={rec['trace_s']};"
                f"card={card_label()}"))


if __name__ == "__main__":
    main(sys.argv[1:])
