"""Per-device flops, HBM bytes and collective bytes of one traced step.

Port of ``repro/perf/hlo_analysis.py``.  The reference parses the
optimized HLO of a compiled step; eager PyTorch has no HLO, so here a
dispatch mode (:class:`StepTrace`) sits over one run of the step (on fake
tensors, in ``launch/dryrun.py``: nothing is allocated or launched) and
records every operator that reaches the dispatcher, with its operands'
shapes and dtypes.  :func:`analyze_ops` counts the records, per device
(the trace is one rank's), under the reference's field names
(:class:`HloStats`):

  * ``flops``: ``torch.utils.flop_counter``'s registry (matrix products,
    their fp32-out ``out_dtype`` overloads among them, convolutions,
    attention) plus the flop formulas of B1-B5's, wkv6's and wkv6_bwd's
    operators (``kernels/_ops.py``: the flops the data needs, unmasked
    lanes and the pairs B5's mask keeps; wkv6's recurrence and its
    backward, one operator each a layer where the reference's scan is a
    loop of T steps), as the reference counts its dots;
  * ``hbm_bytes``: the eager analogue of the reference's post-fusion
    traffic model, since in eager every operator is a kernel: each reads
    its tensor operands and writes its outputs.  Views and metadata
    operators are free, a ``copy_`` reads its source and writes its
    target, a fill or a random draw writes only, and B1-B5, wkv6 and
    wkv6_bwd count by their own byte formulas (each input once, each
    output once; B1 and B2 the rows they write; wkv6's state read unless
    it starts at zero, and written; not wkv6's snapshots);
  * ``collective_bytes`` (and ``collective_by_kind``): operand bytes of
    each ``c10d`` operator, from its result's bytes and its group's size
    as the reference's ``_group_size`` asymmetry has it (an all-gather's
    operand is its result over the group, a reduce-scatter's the result
    times the group); a collective also moves its result through HBM;
  * ``unknown_trip_loops``: always 0.  An eager trace runs every loop
    iteration, so nothing is multiplied by a trip count and nothing is
    unknown.

:class:`StepTrace` also keeps the analogue of XLA's ``memory_analysis()``
(:meth:`StepTrace.memory`, the reference's keys): the bytes of the step's
arguments, of its outputs (and of those that alias an argument), and the
peak of the live storage the step allocated.  The records (:func:`
save_ops`, one JSON line an operator) let ``benchmarks/reanalyze.py``
recount a kept trace without tracing again.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import weakref
from typing import Any, Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["HloStats", "StepTrace", "analyze_ops", "op_stats", "hlo_of",
           "save_ops", "load_ops", "COLLECTIVE_KINDS"]

# c10d operator -> the reference's collective kind
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "gather_": "gather", "scatter_": "scatter",
    "reduce_": "reduce",
}
# operators that move no bytes (metadata, allocation without a write)
_FREE = {"aten::detach", "aten::alias", "aten::lift_fresh", "aten::empty",
         "aten::_unsafe_view", "aten::_reshape_alias",
         "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
         "aten::empty_like", "aten::_local_scalar_dense", "aten::set_",
         "aten::resize_", "prim::device", "prim::layout", "c10d::barrier"}
# operators that write their outputs and read no tensor
_WRITE_ONLY = {"aten::fill_", "aten::zero_", "aten::normal_",
               "aten::uniform_", "aten::random_", "aten::bernoulli_",
               "aten::arange", "aten::full", "aten::zeros", "aten::ones",
               "aten::scalar_tensor", "aten::randn", "aten::rand",
               "aten::randint", "aten::new_zeros", "aten::new_ones",
               "aten::new_full", "aten::zeros_like", "aten::ones_like",
               "aten::full_like", "aten::randn_like", "aten::rand_like"}


@dataclasses.dataclass
class HloStats:
    """The reference's per-device counts (module docstring)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    unknown_trip_loops: int = 0

    def add(self, o: "HloStats"):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.collective_bytes += o.collective_bytes
        for k, v in o.collective_by_kind.items():
            self.collective_by_kind[k] = self.collective_by_kind.get(k, 0) + v
        self.unknown_trip_loops += o.unknown_trip_loops


# ---------------------------------------------------------------------------
# operator records
# ---------------------------------------------------------------------------

_ITEMSIZE = {str(d).split(".")[-1]: d.itemsize for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool, torch.complex64, torch.complex128)}
_DT_NAME = {getattr(torch, k): k for k in _ITEMSIZE}


@dataclasses.dataclass(frozen=True)
class _Spec:
    """A recorded tensor: what the formulas read of it."""

    shape: tuple
    dtype: str

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE.get(self.dtype) or getattr(torch,
                                                    self.dtype).itemsize


def _describe(x):
    """A JSON-able stand-in for an operator argument or result."""
    if isinstance(x, torch.Tensor):
        dt = x.dtype
        return {"t": list(x.shape),
                "dt": _DT_NAME.get(dt) or str(dt).split(".")[-1]}
    if isinstance(x, (list, tuple)):
        return [_describe(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.ScriptObject):
        if x._type().name() == "ProcessGroup":
            import torch.distributed as dist
            return {"pg": dist.ProcessGroup.unbox(x).size()}
        return {"obj": x._type().name()}
    if isinstance(x, torch.SymInt):
        return int(x)
    return {"repr": str(x)}


def _spec_tree(x, leaf):
    """``x`` (a recorded stand-in) with each tensor turned into ``leaf(
    shape, dtype)`` and each object into ``None``."""
    if isinstance(x, list):
        return [_spec_tree(v, leaf) for v in x]
    if isinstance(x, dict):
        if "t" in x:
            return leaf(tuple(x["t"]), x["dt"])
        return None
    return x


def _walk(x):
    """The dicts (recorded tensors and objects) inside a recorded value."""
    if isinstance(x, dict):
        yield x
    elif isinstance(x, list):
        for v in x:
            yield from _walk(v)


def _tensors(x) -> List[_Spec]:
    """Every recorded tensor in ``x``."""
    return [_Spec(tuple(d["t"]), d["dt"]) for d in _walk(x) if "t" in d]


def _bytes(specs: Iterable[_Spec]) -> int:
    n = 0
    for s in specs:
        k = s.itemsize
        for d in s.shape:
            k *= d
        n += k
    return n


def _group(x):
    """The process group size among recorded arguments (1: none)."""
    for d in _walk(x):
        if "pg" in d:
            return int(d["pg"])
    return 1


@functools.lru_cache(maxsize=None)
def _overload(name: str):
    """The ``OpOverload`` a record names (``aten::mm.default``), or None."""
    ns, _, rest = name.partition("::")
    packet, _, overload = rest.partition(".")
    try:
        return getattr(getattr(getattr(torch.ops, ns), packet),
                       overload or "default")
    except (AttributeError, RuntimeError):
        return None


def op_stats(rec: Dict[str, Any]) -> HloStats:
    """The counts of one operator record (module docstring's rules)."""
    name = rec["op"]
    base = name.split(".")[0]
    args, kwargs, out = rec["args"], rec["kwargs"], rec["out"]
    st = HloStats()
    ns, _, short = base.partition("::")
    if ns == "c10d":
        kind = COLLECTIVE_KINDS.get(short)
        if kind is None:
            return st
        g = max(_group(args), 1)
        # the result: the mutated operands (the op returns works)
        res = _bytes(_tensors(args[0]))
        if kind == "all-gather":
            operand = res / g
        elif kind == "reduce-scatter":
            operand = res * g
        else:
            operand = res
        st.collective_bytes = operand
        st.collective_by_kind[kind] = operand
        st.hbm_bytes = res
        return st
    op = _overload(name)
    if op is not None:
        packet = op._overloadpacket
        if packet in flop_registry:
            shapes = lambda x: _spec_tree(x, lambda s, d: torch.Size(s))
            fargs, fkw = list(args), dict(kwargs)
            names = [a.name for a in op._schema.arguments]
            if "out_dtype" in names:   # mm / bmm's fp32-out overloads
                fkw.pop("out_dtype", None)
                i = names.index("out_dtype")
                fargs = fargs[:i] + fargs[i + 1:]
            st.flops = float(flop_registry[packet](
                *shapes(fargs), **{k: shapes(v) for k, v in fkw.items()},
                out_val=shapes(out)))
        if ns == "repro_torch":
            from ..kernels import _ops
            spec = lambda x: _spec_tree(x, _Spec)
            st.hbm_bytes = float(_ops.BYTES[base](
                *spec(args), **{k: spec(v) for k, v in kwargs.items()},
                out=spec(out)))
            return st
        if op.is_view:
            return st
    if base in _FREE:
        return st
    outs = _bytes(_tensors(out))
    if base in _WRITE_ONLY:
        st.hbm_bytes = outs
    elif base == "aten::copy_":
        st.hbm_bytes = _bytes(_tensors(args[1])) + outs
    else:
        st.hbm_bytes = _bytes(_tensors([args, list(kwargs.values())])) + outs
    return st


def analyze_ops(records: Iterable[Dict[str, Any]]) -> HloStats:
    """Sum :func:`op_stats` over a trace's operator records."""
    total = HloStats()
    for rec in records:
        total.add(op_stats(rec))
    return total


def hlo_of(st: HloStats, n_ops: int) -> Dict[str, Any]:
    """A dry-run record's ``hlo`` entry (the reference's keys; ``n_ops``,
    the traced operators, where the reference has the HLO text's
    length)."""
    return {"flops_per_device": st.flops,
            "hbm_bytes_per_device": st.hbm_bytes,
            "collective_bytes_per_device": st.collective_bytes,
            "collective_by_kind": st.collective_by_kind,
            "unknown_trip_loops": st.unknown_trip_loops, "n_ops": n_ops}


def save_ops(records: Iterable[Dict[str, Any]], path) -> None:
    """Write records as JSON lines, each with its counts (``flops``,
    ``bytes``, ``collective_bytes``) beside the shapes they came from."""
    with open(path, "w") as f:
        for rec in records:
            st = op_stats(rec)
            f.write(json.dumps({**rec, "flops": st.flops,
                                "bytes": st.hbm_bytes,
                                "collective_bytes": st.collective_bytes,
                                "group": _group(rec["args"])}) + "\n")


def load_ops(path) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _storages(tree) -> Dict[int, int]:
    """``{storage key: bytes}`` of the tensors in ``tree`` (parameters of
    modules and fields of dataclasses included)."""
    found: Dict[int, int] = {}

    def visit(x):
        if isinstance(x, torch.nn.Module):
            for t in (*x.parameters(), *x.buffers()):
                visit(t)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            found[st._cdata] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                visit(getattr(x, f.name))
    visit(tree)
    return found


class StepTrace(TorchDispatchMode):
    """Record every operator of the calls made inside it (module
    docstring) and the live storage they allocate.

    ``arguments`` (any tree of tensors and modules) are the step's inputs,
    counted as ``argument_size_in_bytes`` and never as allocations.  Enter
    it inside the ``FakeTensorMode`` the step runs under."""

    def __init__(self, arguments=None):
        super().__init__()
        self.records: List[Dict[str, Any]] = []
        self.stats = HloStats()
        self._args = _storages(arguments)
        self._live: Dict[int, int] = {}
        self._now = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = {"op": func.name() if "." in func.name()
               else f"{func.name()}.{func._overloadname}",
               "args": _describe(args),
               "kwargs": {k: _describe(v) for k, v in kwargs.items()},
               "out": _describe(out)}
        self.records.append(rec)
        self.stats.add(op_stats(rec))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._allocated(t)
        return out

    def _allocated(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        self._live[key] = st.nbytes()
        self._now += self._live[key]
        self.peak = max(self.peak, self._now)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key):
        self._now -= self._live.pop(key, 0)

    def memory(self, outputs=None) -> Dict[str, int]:
        """The step's ``memory_analysis()`` under the reference's keys:
        its arguments, its outputs (``alias``: those that are arguments)
        and the peak of the storage it allocated (``temp``)."""
        outs = _storages(outputs)
        alias = {k: v for k, v in outs.items() if k in self._args}
        return {"argument_size_in_bytes": sum(self._args.values()),
                "output_size_in_bytes": sum(outs.values()),
                "alias_size_in_bytes": sum(alias.values()),
                "temp_size_in_bytes": self.peak}
