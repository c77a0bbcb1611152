"""Step functions: the grad-accumulating train step, and the serving
path's prefill and decode over static buffers, captured as CUDA graphs on
the card.

Port of ``repro/dist/step.py`` (:func:`build_train_step`,
:func:`default_microbatches`, :func:`build_prefill`,
:func:`build_serve_step`, :func:`_maybe_record` and
:func:`loops_cotangent_psum`, the distributed LOOPS operator's gradient
reduction).

Training (:func:`build_train_step`): one call takes the global batch
``(n_mb, mb, S)`` and, per microbatch, runs ``train_loss`` forward and
backward (each block rematerialised, attention on B5, the ssm family's
recurrence on wkv6 / wkv6_bwd), then adds the
gradients into an accumulator in the flat fp32 layout of
``optim/adamw.py``; the mean over microbatches goes to AdamW.  The
reference jits the step and donates the parameters and optimizer state;
here the state is updated in place.  On one device there is no
reduce-scatter (:data:`N_SHARDS` is 1).

On a ``data x model`` mesh (one process a rank, ``torch.distributed``) the
same step runs on the rank's shards (``models/transformer.py::
shard_params``): each rank takes its data index's rows of every
microbatch, and after each microbatch's backward one reduce-scatter over
all D ranks a parameter (one at a time, so no fp32 copy of the whole model
exists) sums the gradients into the rank's flat row: the ZeRO-1
reduce-scatter point of the reference's ``constrain`` to
:func:`repro_torch.dist.sharding.flat_grad_specs`.  A rank writes its
tensor-parallel shard of a gradient into a zero buffer of the full
parameter's size (the model ranks' slices are disjoint, so their sum is the
gathered gradient), and a whole parameter's gradient, the same on every
model rank, comes from the rank at ``model`` index 0 alone; the sum over
the data ranks is the batch's.  AdamW then updates the rows
(``adamw.apply_updates`` with the mesh).

Serving.  The reference jits
each step with the mesh's shardings and donates the KV cache; eager
PyTorch pays one launch per operation instead, which leaves the decode
step host-bound.  So on ``"cuda"`` a built function owns static buffers
and replays a ``torch.cuda.CUDAGraph`` captured over them:

  * its inputs (the tokens, and for decode a 0-d position) are static
    device buffers: each call copies the host values in, replays, and
    returns the static outputs -- the cache it was built over and the
    logits, which the graph wrote into the graph pool.  The next replay of
    the same function overwrites the logits, so a caller reads them first;
  * before capture the step runs once eagerly on a side stream (PyTorch's
    capture recipe), so that cuBLAS picks its algorithms and the kernel B5
    is built (``kernels/_build.py::kernel_fn``) and configured (its
    ``cudaFuncSetAttribute``) outside the capture.  Capture and replay
    errors raise: nothing falls back to eager on the card;
  * the kernel wrappers count a launch when Python calls them, which a
    replay does not: the capture's increments are taken back (the capture
    launches nothing) and added again on every replay, so B1-B5's
    ``launches`` count the kernels the device runs.

On ``"cpu"`` the same static-buffer function runs the step eagerly, so
the serving pool's bucket and slot logic (``serve/queue.py``) is one code
path on both devices.

Under a ``mesh`` the prefill and decode steps run eagerly (a CUDA graph
cannot capture a gloo collective): the batch is cut to the rank's data
rows, the cache holds the rank's shard of :func:`sharding.cache_specs`
(:func:`local_cache`), and the logits come back gathered along the
vocabulary and over the data ranks, the whole batch's on every rank (the
reference's one controller holds the global array of
:func:`sharding.logits_spec`).  A batch that the data ranks do not divide
is zero-padded to a multiple of them, ``ceil(B / D)`` rows a rank, the
pad rows take no place in a MoE layer's experts (the steps pass the real
row count as ``rows``), and their logits are dropped; the reference's
jit raises for it
(``in_shardings`` must divide), so its serving queue fails on a group of
3 at ``data = 2`` where the port's serves it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ShapeConfig
from ..data.pipeline import host_shard
from ..kernels.engine import resolve_device
from ..launch.mesh import all_gather_cat, flat_axes
from ..models import api
from ..optim import adamw
from ..optim.adamw import OptConfig
from . import sharding as shr

__all__ = ["default_microbatches", "build_train_step",
           "build_prefill", "build_serve_step", "loops_cotangent_psum",
           "local_cache", "gather_state", "load_state", "N_SHARDS"]

F32 = torch.float32
# Shards of the flat optimizer layout: one device, one shard.
N_SHARDS = 1


def loops_cotangent_psum(partial_db: torch.Tensor, mesh,
                         axis) -> torch.Tensor:
    """Row-shard-aware reduction of the dense-operand cotangent of a
    distributed LOOPS SpMM (``core/distributed.py``).

    Forward, ``B`` is replicated on every rank (``Replicate()`` in
    :func:`repro_torch.dist.sharding.loops_in_specs`) while the workload is
    row-sharded over the worker axis.  The transpose of "replicate, then use
    on every shard" is "sum the per-shard cotangents": each rank owns an
    exclusive row slice of ``dY`` (paper §3.4), computes its partial
    ``Aᵀ_chunk · dY_chunk``, and this all-reduce SUM over the worker group
    of ``mesh``'s ``axis`` (a name or a tuple of names) gives every rank the
    full ``dB``, replicated like ``B``.  ``partial_db`` is reduced in place
    and returned."""
    wm = shr.worker_mesh(mesh, axis)
    if wm.size() > 1:
        dist.all_reduce(partial_db, group=wm.get_group())
    return partial_db


def default_microbatches(shape: ShapeConfig, mesh=None,
                         per_device_batch: int = 4) -> int:
    """Pick a microbatch count for a train cell: ``per_device_batch``
    sequences per data-parallel worker per microbatch (one worker without
    a ``mesh``), walked down until the count divides the global batch and
    the microbatch divides evenly over the data axes."""
    dp = shr.dp_size(mesh) if mesh is not None else 1
    n_mb = max(shape.global_batch // max(dp * per_device_batch, 1), 1)
    while n_mb > 1 and (shape.global_batch % n_mb
                        or (shape.global_batch // n_mb) % dp):
        n_mb -= 1
    return n_mb


def _flat_zeros(params, n_shards: int) -> Dict[str, torch.Tensor]:
    """Zero accumulator in the flat fp32 layout (matches
    ``adamw.to_flat``), one per named parameter, on its device."""
    return {name: torch.zeros((n_shards, math.ceil(x.numel() / n_shards)),
                              dtype=F32, device=x.device)
            for name, x in params.named_parameters()}


def _maybe_record(fn, recorder, op: str, obs=None):
    """Wrap a step function with the perf-trace recorder and/or a live obs
    capture (no-op without either), as the reference does: obs wraps
    outermost, so its span brackets the recorder's timing too."""
    if recorder is not None:
        fn = recorder.wrap_step(fn, op=op)
    if obs is not None:
        fn = obs.wrap_step(fn, op=op)
    return fn


def _mesh_of(params, mesh):
    """``params``' :class:`~repro_torch.models.layers.MeshLayout`, checked
    to be ``mesh``'s."""
    layout = getattr(params, "layout", None)
    if layout is None or layout.mesh is not mesh:
        raise ValueError("the parameters are not sharded on this mesh: "
                         "build them with models.transformer.shard_params")
    return layout


def _zero_scatter(g: torch.Tensor, sharding, model_rank: int, group,
                  n_shards: int) -> torch.Tensor:
    """This rank's ``(1, cols)`` row of the flat fp32 gradient, summed
    over every rank (the module docstring's reduce-scatter point)."""
    shape = sharding.global_shape(g.shape)
    numel = math.prod(shape)
    cols = math.ceil(numel / n_shards)
    buf = torch.zeros(n_shards * cols, dtype=F32, device=g.device)
    full = buf[:numel].view(shape)
    if any(e is not None for e in sharding.spec):
        sharding.local(full).copy_(g)
    elif model_rank == 0:
        full.copy_(g)
    row = torch.empty((1, cols), dtype=F32, device=g.device)
    dist.reduce_scatter_tensor(row, buf.view(n_shards, cols), group=group)
    return row


def build_train_step(cfg, params, opt: OptConfig, *, mesh=None,
                     n_microbatches: int = 1,
                     loss_fn: Callable | None = None,
                     recorder=None, obs=None):
    """Build the grad-accumulating AdamW train step for ``cfg``:
    ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``,
    updating ``params`` and ``opt_state`` in place; ``metrics`` carries 0-d
    tensors ``loss``, ``grad_norm``, ``lr`` and ``tokens``.  The
    reference's bundle also carries spec trees; here they are the
    parameters' ``layout.specs`` and :func:`repro_torch.optim.adamw.
    opt_specs`, so this returns the function alone.

    With a ``mesh``, ``params`` are this rank's shards on it
    (``shard_params``), ``opt_state`` its rows
    (``init_opt_state(..., param_specs=, mesh=)``) and ``batch`` the
    global batch, of which the step takes the rank's data rows; the
    metrics are the global batch's, the same on every rank (module
    docstring).  ``loss_fn`` then returns the rank's share of the global
    mean, as ``train_loss`` does on a mesh.

    ``params`` is the model (an ``nn.Module``) the step will train; its
    named parameters fix the flat accumulator's keys.
    ``loss_fn(params, microbatch) -> (loss, aux)`` defaults to
    ``models.api.train_loss``.  Per microbatch the gradients (in the
    parameters' dtype, as the reference's ``value_and_grad``) are added
    into the flat fp32 accumulator; their mean goes to
    :func:`repro_torch.optim.apply_updates`.  ``recorder`` (a
    :class:`repro_torch.perf.trace.TraceRecorder`) and ``obs`` (a
    :class:`repro_torch.obs.Obs`) wrap the step as the reference's
    ``_maybe_record`` does (op ``train_step``).
    """
    loss_fn = loss_fn or (lambda p, mb: api.train_loss(cfg, p, mb))
    n_mb = n_microbatches
    names = [name for name, _ in params.named_parameters()]
    if mesh is not None:
        layout = _mesh_of(params, mesh)
        shr.constrain(dict(params.named_parameters()), mesh, layout.specs,
                      layout.shapes)
        shardings = shr.spec_to_sharding(layout.specs, mesh)
        flat = shr.worker_mesh(mesh, flat_axes(mesh))
        n_shards, group = flat.size(), flat.get_group()
        data = shr.worker_mesh(mesh, shr.dp_axes(mesh)) \
            if shr.dp_axes(mesh) else None

    def accumulate(g_acc, grads):
        for name, g in zip(names, grads):
            if mesh is None:
                g_acc[name].view(-1)[:g.numel()] += g.reshape(-1)
            else:
                g_acc[name] += _zero_scatter(g, shardings[name],
                                             layout.model_rank, group,
                                             n_shards)

    def step(params, opt_state, batch):
        plist = [p for _, p in params.named_parameters()]
        if mesh is None:
            g_acc = _flat_zeros(params, N_SHARDS)
        else:
            g_acc = {name: torch.zeros_like(tr["master"])
                     for name, tr in opt_state["flat"].items()}
            if data is not None:
                batch = host_shard(batch, data.get_local_rank(), data.size())
        loss_sum = tok_sum = None
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items()}
            loss, aux = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, plist)
            accumulate(g_acc, grads)
            loss = loss.detach()
            tokens = torch.as_tensor(aux.get("tokens", 0.0), dtype=F32,
                                     device=loss.device)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            tok_sum = tokens if tok_sum is None else tok_sum + tokens
            del loss, aux, grads
        for g in g_acc.values():
            g.div_(n_mb)
        if mesh is None:
            params, opt_state, gnorm = adamw.apply_updates(
                params, opt_state, g_acc, opt)
        else:
            params, opt_state, gnorm = adamw.apply_updates(
                params, opt_state, g_acc, opt, layout.specs, mesh)
            if layout.data_group is not None:   # the ranks' shares
                dist.all_reduce(loss_sum, group=layout.data_group)
        metrics = {"loss": loss_sum / n_mb, "grad_norm": gnorm,
                   "lr": adamw.lr_at(opt, opt_state["count"]),
                   "tokens": tok_sum}
        return params, opt_state, metrics

    return _maybe_record(step, recorder, "train_step", obs)


def _launch_counters() -> Tuple[Callable, ...]:
    """The kernel wrappers whose ``launches`` attribute counts launches:
    B1, B2, B3, B4, B5, wkv6 and wkv6_bwd."""
    from ..kernels import (bcsr_spmm, csr_spmm, flash_attention, spmm_sdd,
                           wkv6)
    return (csr_spmm.csr_panels_spmm, bcsr_spmm.bcsr_panels_spmm,
            spmm_sdd.csr_sdd_panels, spmm_sdd.bcsr_sdd_panels,
            flash_attention.flash_attention, wkv6.wkv6, wkv6.wkv6_bwd)


class _Static:
    """``body()`` over static buffers: eager on the CPU, a replayed CUDA
    graph on the card (see the module docstring)."""

    def __init__(self, body: Callable, device: torch.device, graph_pool):
        self._body = body
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._deltas: Tuple[Tuple[Callable, int], ...] = ()
        if device.type == "cuda":
            self._capture(graph_pool)

    def _capture(self, graph_pool) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream().wait_stream(side)
        counters = _launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=graph_pool):
                self._out = self._body()
        finally:
            deltas = []
            for fn, n in zip(counters, before):
                if fn.launches != n:
                    deltas.append((fn, fn.launches - n))
                    fn.launches = n      # captured, not launched
        self._deltas = tuple(deltas)
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            return self._body()
        self.graph.replay()
        for fn, n in self._deltas:
            fn.launches += n
        return self._out


def _data_rows(x, mesh):
    """The rank's data rows (dim 0) of a serving batch: the batch
    zero-padded to a multiple of the data ranks, ``ceil(B / D)`` rows a
    rank (module docstring)."""
    axes = shr.dp_axes(mesh)
    if not axes:
        return x
    data = shr.worker_mesh(mesh, axes)
    per = -(-x.shape[0] // data.size())
    pad = per * data.size() - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x[data.get_local_rank() * per:(data.get_local_rank() + 1) * per]


def _all_rows(logits: torch.Tensor, params, batch: int) -> torch.Tensor:
    """The global batch's ``(batch, vocab)`` logits on every rank: the
    data ranks' rows gathered (one all-gather), the pad rows dropped."""
    group = params.layout.data_group
    if group is None:
        return logits
    return all_gather_cat(logits, group, dim=0)[:batch]


def local_cache(cfg, mesh, batch: int, max_len: int, *, dtype=None,
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's zero shard of a ``(L, batch, max_len, KV, hd)`` decode
    cache under :func:`sharding.cache_specs` (its data rows, ``ceil(batch
    / D)`` of them; its kv heads when they are split over ``model``); for
    the ssm family, of the state ``{"x_tm", "s", "x_cm"}`` (its data rows,
    whole on ``model``; ``s`` fp32, ``max_len`` unused)."""
    dp = shr.dp_size(mesh)
    rows = -(-batch // dp) * dp
    whole = api.init_cache(cfg, rows, max_len, dtype=dtype, device="meta")
    shapes = {k: tuple(v.shape) for k, v in whole.items()}
    shardings = shr.spec_to_sharding(shr.cache_specs(shapes, mesh, cfg),
                                     mesh)
    return {k: torch.zeros(shardings[k].local_shape(shape),
                           dtype=whole[k].dtype,
                           device=resolve_device(device))
            for k, shape in shapes.items()}


def build_prefill(cfg, params, batch_shape: Tuple[int, int], *,
                  mesh=None, cache: Optional[Dict[str, torch.Tensor]] = None,
                  graph_pool=None, recorder=None, obs=None):
    """Static-buffer prefill: ``fn(batch) -> (cache, last_logits)``.

    ``batch_shape`` is ``(batch, prompt_len)``; ``batch["tokens"]`` (a
    numpy array or tensor of that shape) is copied into the static token
    buffer on every call.  ``cache`` is the static cache the k/v land in
    (positions ``[0, prompt_len)``; default: a new one of ``prompt_len``
    positions) and is what ``fn`` returns.  On ``"cuda"`` the step is
    captured at build time, after one eager run on a side stream, into
    ``graph_pool`` (a ``torch.cuda.graph_pool_handle()``; default: a
    private pool).  ``recorder`` / ``obs`` wrap ``fn`` as the reference's
    ``_maybe_record`` does.  Returns ``fn``; the reference's param and
    cache specs are ``params.layout.specs`` and :func:`sharding.
    cache_specs`.

    With a ``mesh`` (``params`` sharded on it), ``fn`` runs eagerly on the
    rank's data rows of ``batch``, into ``cache`` (default: a new
    :func:`local_cache` of ``prompt_len`` positions), and its logits are
    the whole batch's on every rank, gathered along the vocabulary and
    over the data ranks.
    """
    dev = params.embed.device
    bsz, seq = batch_shape
    if mesh is not None:
        _mesh_of(params, mesh)
        if cache is None:
            cache = local_cache(cfg, mesh, bsz, seq, device=dev)

        def prefill(batch):
            tokens = _data_rows(torch.as_tensor(batch["tokens"]), mesh)
            out, logits = api.prefill(cfg, params,
                                      {"tokens": tokens.to(dev)},
                                      cache=cache, rows=bsz)
            return out, _all_rows(logits, params, bsz)
        return _maybe_record(prefill, recorder, "prefill", obs)
    if cache is None:
        cache = api.init_cache(cfg, bsz, seq, device=dev)
    tokens = torch.zeros((bsz, seq), dtype=torch.long, device=dev)
    step = _Static(
        lambda: api.prefill(cfg, params, {"tokens": tokens}, cache=cache),
        dev, graph_pool)

    def prefill(batch):
        tokens.copy_(torch.as_tensor(batch["tokens"]))
        return step()
    return _maybe_record(prefill, recorder, "prefill", obs)


def build_serve_step(cfg, params, cache: Dict[str, torch.Tensor], *,
                     mesh=None, graph_pool=None, recorder=None, obs=None):
    """Static-buffer decode step over ``cache``:
    ``fn(tokens, length) -> (cache, logits)``.

    ``tokens`` is ``(batch, 1)`` (numpy or tensor) and ``length`` a host
    ``int``: the number of positions already in the cache, checked
    against the cache's capacity before anything runs (a ``ValueError``
    past it), then written into the static 0-d position that the step
    reads on the device (:func:`repro_torch.models.transformer.decode_step`),
    so one graph serves every position.  A state cache (the ssm family)
    has no capacity and its step reads no position, as the reference's.
    The step writes the new k/v (or state) into ``cache`` in place, as the
    reference's donated cache.  ``graph_pool``,
    ``recorder`` and ``obs`` as for :func:`build_prefill`.  Returns ``fn``.
    With a ``mesh``, ``cache`` is the rank's shard (:func:`local_cache`),
    ``tokens`` the global batch's, and ``fn`` runs eagerly as
    :func:`build_prefill`'s does, its logits the global batch's.
    """
    dev = params.embed.device
    bsz = next(iter(cache.values())).shape[1]
    capacity = cache["k"].shape[2] if "k" in cache else None

    def check(length: int) -> None:
        if capacity is not None and not 0 <= length < capacity:
            raise ValueError(f"position {length} is past the slot's "
                             f"{capacity} cache positions")
    if mesh is not None:
        _mesh_of(params, mesh)

        def decode(step_tokens, length: int):
            length = int(length)
            check(length)
            step_tokens = torch.as_tensor(step_tokens)
            tokens = _data_rows(step_tokens, mesh)
            out, logits = api.decode_step(cfg, params, cache,
                                          tokens.to(dev), length,
                                          rows=step_tokens.shape[0])
            return out, _all_rows(logits, params, step_tokens.shape[0])
        return _maybe_record(decode, recorder, "decode", obs)
    tokens = torch.zeros((bsz, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((), dtype=torch.long, device=dev)
    step = _Static(lambda: api.decode_step(cfg, params, cache, tokens, pos),
                   dev, graph_pool)

    def decode(step_tokens, length: int):
        length = int(length)
        check(length)
        tokens.copy_(torch.as_tensor(step_tokens))
        pos.fill_(length)
        return step()
    return _maybe_record(decode, recorder, "decode", obs)


# ---------------------------------------------------------------------------
# checkpoints on a mesh
# ---------------------------------------------------------------------------

def gather_state(params, mesh) -> Callable:
    """The ``gather`` of :meth:`repro_torch.checkpoint.Checkpointer.
    save_async` for ``{"params": params.state_dict(), "opt": opt_state}``
    on ``mesh``: each leaf's full tensor on the first rank (which writes),
    ``None`` elsewhere: a parameter gathered over its split, an optimizer
    leaf's ``(D, cols)`` rows over all ranks (the reference's unsharded
    tree).  Every rank calls it for every leaf, in the tree's order."""
    layout = _mesh_of(params, mesh)
    shardings = shr.spec_to_sharding(layout.specs, mesh)
    flat = shr.worker_mesh(mesh, flat_axes(mesh))
    group, first = flat.get_group(), flat.get_local_rank() == 0

    def gather(path: str, leaf: torch.Tensor):
        kind, _, rest = path.partition("/")
        if kind == "params":
            return shardings[rest].gather_first(leaf)
        if not rest.startswith("flat/"):
            return leaf if first else None
        rows = ([torch.empty_like(leaf) for _ in range(flat.size())]
                if first else None)
        dist.gather(leaf.contiguous(), rows,
                    dst=dist.get_global_rank(group, 0), group=group)
        return torch.cat(rows) if first else None
    return gather


@torch.no_grad()
def load_state(params, opt_state, tree, mesh) -> None:
    """Copy this rank's part of the unsharded checkpoint ``tree`` (CPU
    tensors, memory-mapped by :func:`repro_torch.checkpoint.restore`)
    into ``params`` (its shards) and ``opt_state`` (its rows): the
    restore's scatter.  The rows were saved by a mesh of the
    same number of ranks, at any shape."""
    layout = _mesh_of(params, mesh)
    shardings = shr.spec_to_sharding(layout.specs, mesh)
    flat = shr.worker_mesh(mesh, flat_axes(mesh))
    r, n = flat.get_local_rank(), flat.size()
    for name, p in params.named_parameters():
        p.copy_(shardings[name].local(tree["params"][name]))
    for name, tr in opt_state["flat"].items():
        for key, t in tr.items():
            saved = tree["opt"]["flat"][name][key]
            if saved.shape[0] != n:
                raise ValueError(f"{name}/{key}: the checkpoint holds "
                                 f"{saved.shape[0]} rows, the mesh has {n} "
                                 "ranks")
            t.copy_(saved[r:r + 1])
    opt_state["count"].copy_(tree["opt"]["count"])
