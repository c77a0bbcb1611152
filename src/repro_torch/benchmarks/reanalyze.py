"""Recount kept dry-run traces and update their records in place.

Port of the reference's ``benchmarks/reanalyze.py``: where the reference
re-runs its HLO analyser over cached ``.hlo.txt`` files, this re-runs
``perf/hlo_analysis.py::analyze_ops`` over the operator records that
``launch/dryrun.py --keep-trace`` (and ``spmm_dryrun --keep-trace``) wrote
and each record names (``trace_path``), so an improved count needs no new
trace.

Registered in ``benchmarks/run.py`` as suite ``reanalyze`` (by name).
"""
from __future__ import annotations

import json
import pathlib

from ..launch.dryrun import RESULTS_DIR
from ._util import csv_row

__all__ = ["main"]


def main(out=print, results=None) -> int:
    """Recount every record under ``results`` (default: the dry-run's
    directory) that names kept traces (``trace_path``, or each traced
    rank's for the LOOPS cell)."""
    results = results or RESULTS_DIR
    from ..perf.hlo_analysis import analyze_ops, hlo_of, load_ops
    from .spmm_dryrun import merge_ranks
    n = 0
    for jpath in sorted(pathlib.Path(results).glob("*.json")):
        rec = json.loads(jpath.read_text())
        parts = list(rec.get("ranks", {}).values()) or [rec]
        if not all(pathlib.Path(p.get("trace_path", "")).is_file()
                   for p in parts):
            continue
        for part in parts:
            ops = load_ops(part["trace_path"])
            part["hlo"] = hlo_of(analyze_ops(ops), len(ops))
        if "ranks" in rec:
            merge_ranks(rec)
        jpath.write_text(json.dumps(rec, indent=1))
        n += 1
    out(csv_row("reanalyzed_cells", 0.0, str(n)))
    return n


if __name__ == "__main__":
    main()
