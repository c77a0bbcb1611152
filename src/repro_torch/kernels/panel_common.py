"""Structural helpers shared with the reference panel kernels.

Only :func:`default_bn` is ported: the reference's column-block width
enters the structural grid-step count (``core.spmm.loops_grid_steps``),
which the port reproduces exactly.  The CUDA kernels tile columns by 32
(one warp) whatever ``bn`` is.
"""
from __future__ import annotations

__all__ = ["default_bn"]


def default_bn(n: int) -> int:
    """Largest lane-aligned column-block width that tiles ``n`` exactly.

    ``n <= 512`` keeps the whole row in one block; above that, pick the
    largest divisor of ``n`` that is ``<= 512``, preferring multiples of
    128, then of 8, then any divisor (N=600 -> 200).
    """
    n = int(n)
    if n <= 512:
        return max(n, 1)
    divisors = [d for d in range(1, 513) if n % d == 0]
    for align in (128, 8, 1):
        aligned = [d for d in divisors if d % align == 0]
        if aligned:
            return max(aligned)
    return 1   # unreachable: 1 always divides n
