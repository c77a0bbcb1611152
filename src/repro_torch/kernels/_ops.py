"""B1-B5's, wkv6's and wkv6_bwd's launches as PyTorch operators,
``torch.ops.repro_torch.*``.

A kernel wrapper checks its inputs and allocates its outputs in Python;
the launch itself is an operator of the ``repro_torch`` namespace (defined
by :func:`define`) whose ``CUDA`` kernel makes the ctypes call of
``kernels/_build.py`` and counts the launch.  Each operator has

  * a fake function (``torch.library.register_fake``), which reads only
    shapes and dtypes, so a ``FakeTensorMode`` or ``meta`` trace passes
    through every LOOPS and attention call and launches nothing;
  * a flop formula (``torch.utils.flop_counter.register_flop_formula``):
    the flops the data needs, by PERF.md §3's rule (unmasked lanes, which
    the wrappers pass as ``live``; for B5 the pairs its mask keeps), so
    ``FlopCounterMode`` and :mod:`repro_torch.perf.hlo_analysis` count
    the kernels' work (wkv6: the recurrence's arithmetic, 5 flops a state
    element and step; wkv6_bwd 18);
  * a byte formula (:data:`BYTES`): each input read once and each output
    written once, the §3 bound's rule.  B1 and B2 write into a buffer
    they share, so theirs counts the rows the call writes; wkv6 updates
    its state in place (``Tensor(a!)``), read unless it starts from
    zeros and written once; the training forward's snapshots, the
    backward's workspace, are not counted.

The operators are defined with ``torch.library.Library`` (a schema and a
kernel for the ``CUDA`` key) rather than ``torch.library.custom_op``.
On the H100's host a launch through the dispatcher's Python-kernel round
trip costs 9-10 us more than the kernel function called directly, and
through ``custom_op`` 43-45 us more, against a 0.16-0.32 ms m6 call of two
launches (PERF.md, PR 26).  So :func:`dispatch` routes a call through the
operator whenever anything may observe it (a Python dispatch mode is
active: ``FakeTensorMode``, ``FlopCounterMode``, the analyser's
``StepTrace``; or the probed input is not a plain CUDA tensor: a fake,
``meta`` or subclass tensor), and otherwise calls the operator's own CUDA
kernel function, the one launch path either way.  Neither has an autograd
formula: the wrappers are called under the autograd Functions of
``core/spmm.py``, ``kernels/flash_attention.py`` and ``kernels/wkv6.py``
(whose backward is the operator ``wkv6_bwd``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["NAMESPACE", "BYTES", "define", "dispatch", "nbytes", "io_bytes"]

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")
# "repro_torch::<op>" -> byte formula, called as the flop formulas are but
# with the tensors themselves (or anything with ``shape`` and
# ``itemsize``) and ``out=`` the op's result.
BYTES: Dict[str, Callable] = {}


def nbytes(t) -> int:
    """Bytes of a tensor or of a spec with ``shape`` and ``itemsize``."""
    n = 1
    for d in t.shape:
        n *= int(d)
    return n * int(t.itemsize)


def io_bytes(*args, out=None) -> int:
    """Every tensor input once and the outputs once (B3, B4, B5)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(nbytes(t) for t in (*args, *outs) if hasattr(t, "shape"))


def define(name: str, schema: str, kernel: Callable, fake: Callable,
           flops: Callable, nbytes_fn: Callable):
    """Define ``repro_torch::<name><schema>`` with ``kernel`` for CUDA
    tensors, ``fake`` as its shape function, and its flop and byte
    formulas; return the operator's default overload."""
    _LIB.define(name + schema)
    _LIB.impl(name, kernel, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    BYTES[f"{NAMESPACE}::{name}"] = nbytes_fn
    return packet.default


def dispatch(op, kernel: Callable, probe: torch.Tensor, *args):
    """``op(*args)``, or ``kernel(*args)`` (the operator's CUDA kernel)
    when nothing observes the call: ``probe`` is a plain CUDA tensor and no
    Python dispatch mode is active (module docstring)."""
    if (type(probe) is torch.Tensor and probe.is_cuda
            and not torch._C._len_torch_dispatch_stack()):
        return kernel(*args)
    return op(*args)
