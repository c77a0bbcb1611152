"""Collective bytes of an fp32 all-reduce against ``compressed_psum``.

Port of the reference's ``benchmarks/compress_bytes.py``: the collective
operand bytes a rank moves for a gradient-sized block (2^22 fp32 a rank,
a ~16M-parameter shard) summed over a 16-rank axis, as a plain fp32
all-reduce and through ``dist/compress.py::compressed_psum`` in bf16 and
int8, counted by ``perf/hlo_analysis.py`` over one rank's calls.  The
ranks are a ``fake`` process group joined as rank 0 (its collectives move
nothing), so the counts need no second card; the block itself is a real
tensor (``compressed_psum`` reads its agreement flag on the host), 16 MB
on ``device``.

Registered in ``benchmarks/run.py`` as suite ``compress_bytes`` (by
name).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ._util import card_label, csv_row

__all__ = ["collective_bytes", "main", "RANKS", "N"]

RANKS = 16
N = 1 << 22   # fp32 grads per rank


def collective_bytes(fn, x) -> float:
    """Collective operand bytes of ``fn(x)`` on this rank."""
    from ..perf.hlo_analysis import StepTrace
    with StepTrace(arguments=x) as trace:
        fn(x)
    return trace.stats.collective_bytes


def main(out=print, record=None, device: str = "cuda", ranks: int = RANKS,
         n: int = N) -> dict:
    from ..dist.compress import compressed_psum
    from ..kernels.engine import resolve_device
    from ..launch.dryrun import fake_world
    dev = resolve_device(device)
    with fake_world(ranks, 0):
        group = dist.group.WORLD
        x = torch.randn(n, dtype=torch.float32, device=dev)

        def psum(t):
            t = t.clone()
            dist.all_reduce(t, group=group)
            return t
        got = {"fp32": collective_bytes(psum, x),
               "bf16": collective_bytes(
                   lambda t: compressed_psum(t, group, "bf16"), x),
               "int8": collective_bytes(
                   lambda t: compressed_psum(t, group, "int8"), x)}
    card = card_label()
    out(csv_row("compress_psum_fp32_bytes", 0.0,
                f"{got['fp32']:.3e};ranks={ranks};card={card}"))
    for prec in ("bf16", "int8"):
        out(csv_row(f"compress_psum_{prec}_bytes", 0.0,
                    f"{got[prec]:.3e};reduction="
                    f"{got['fp32'] / max(got[prec], 1):.2f}x;card={card}"))
    return got


if __name__ == "__main__":
    main()
