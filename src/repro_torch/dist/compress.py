"""Compressed cross-rank reductions (gradient all-reduce on a byte diet).

Port of ``repro/dist/compress.py``.  ``compressed_psum`` is an all-reduce
SUM over a ``torch.distributed`` group that moves int8 (or bf16) instead of
fp32.  The int8 path is the ZeRO++-style quantized all-reduce:

  1. share one symmetric scale across the group (an all-reduce MAX of one
     scalar -- the only fp32 on the wire besides the final gather),
  2. quantize to int8 and ``all_to_all_single`` so each rank receives every
     peer's slice of its own 1/D-th of the vector (int8 on the wire),
  3. accumulate locally in int32 -- an all-reduce of int8 operands would
     reduce in int8 and overflow at once,
  4. dequantize and ``all_gather`` the reduced fp32 slices (4/D of the
     fp32 all-reduce's bytes).

Wire bytes per rank: ``n`` (int8 all-to-all) + ``4n/D`` (fp32 gather)
against ``4n`` for an fp32 all-reduce.  Error: one rounding per element at
a shared scale, so the sum carries at most ``D * scale/2`` absolute error.

**Where it differs from the reference.**  The reference decides its
branch once, at trace time, for the whole SPMD program.  Here each rank
runs its own process, and a rank that failed and took the fp32 all-reduce
while its peers entered the all-to-all would deadlock the group.  So the
ranks agree first: one all-reduce MAX of a failure flag (carried with the
int8 path's scale, so that path pays no extra round trip).  A failure on
any rank -- the ``dist.psum.{precision}`` fault point -- then degrades
every rank to the fp32 sum when the caller opted in to the fallback policy
(``resilience/fallback.py``, off by default), with a ``dist.fallback``
count a rank; under the default policy every rank raises.  A collective
that fails after the agreement propagates.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["compressed_psum"]

F32 = torch.float32
PRECISIONS = ("none", "bf16", "int8")


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def compressed_psum(x: torch.Tensor, group=None,
                    precision: str = "int8") -> torch.Tensor:
    """All-reduce SUM of ``x`` over ``group`` (``None``: the world) with
    compressed communication; every rank gets the same result.

    ``precision``: ``"int8"`` (quantized all-to-all reduce, ~3-4x fewer
    bytes), ``"bf16"`` (cast, all-reduce, cast back) or ``"none"`` (the
    plain all-reduce -- the ablation baseline).  With one rank ``x`` comes
    back unchanged.  Each call reports its per-rank wire bytes -- ``4n``,
    ``2n``, ``n + 4n/D`` -- to the active obs capture
    (:func:`repro_torch.obs.runtime.note_collective`).  Every rank of the
    group must call it with the same shape and precision.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown compression precision: {precision!r}")
    from ..obs.runtime import note_collective
    world = dist.get_world_size(group)
    n = x.numel()
    note_collective(0 if world == 1 else
                    {"none": 4 * n, "bf16": 2 * n,
                     "int8": n + 4 * n // world}[precision],
                    kind="psum", precision=precision)
    if world == 1:
        return x
    if precision == "none":
        return _psum(x, group)
    from ..resilience.fallback import classify, get_policy
    from ..resilience.inject import fault_point, note_degraded
    err = None
    try:
        fault_point(f"dist.psum.{precision}")
    except Exception as e:    # noqa: BLE001 - agreed on across the group below
        err = e
    if precision == "int8":
        flat = torch.nn.functional.pad(x.reshape(-1).to(F32),
                                       (0, (-n) % world))
        amax = flat.abs().max()
    else:
        amax = x.new_zeros((), dtype=F32)
    # [failed on any rank, the shared amax]: one all-reduce MAX for both
    agree = torch.stack([amax.new_tensor(float(err is not None)), amax])
    dist.all_reduce(agree, op=dist.ReduceOp.MAX, group=group)
    if agree[0].item() > 0:
        if not get_policy().enabled:
            if err is not None:
                raise err
            raise RuntimeError(f"dist.psum.{precision} failed on another "
                               "rank of the group")
        note_degraded("dist.fallback", precision=precision,
                      reason=classify(err) if err is not None else "peer")
        return _psum(x, group)
    if precision == "bf16":
        out = x.to(torch.bfloat16, copy=True)
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)
    return _int8_psum(x, flat, agree[1], world, group)


def _int8_psum(x, flat, amax, world: int, group) -> torch.Tensor:
    # one shared symmetric scale per call: quantized values from different
    # ranks must be summable, so the scale cannot be per-rank
    scale = torch.clamp(amax, min=torch.finfo(F32).tiny) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    # row d of the (D, n/D) view is the slice rank d reduces
    q = q.view(world, -1)
    qx = torch.empty_like(q)
    dist.all_to_all_single(qx, q, group=group)
    part = qx.to(torch.int32).sum(0).to(F32) * scale
    parts = [torch.empty_like(part) for _ in range(world)]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts)[:x.numel()].reshape(x.shape).to(x.dtype)
