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
backward (each block rematerialised, attention on B5), then adds the
gradients into an accumulator in the flat fp32 layout of
``optim/adamw.py``; the mean over microbatches goes to AdamW.  The
reference jits the step and donates the parameters and optimizer state;
here the state is updated in place.  With one device there is no
reduce-scatter: :data:`N_SHARDS` is 1 and the flat layout is kept for the
sharding of ROADMAP A.13.

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

The train and serve steps take no mesh: sharding the model
(``dist/sharding.py``'s model half) is ROADMAP A.13.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ShapeConfig
from ..models import api
from ..optim import adamw
from ..optim.adamw import OptConfig

__all__ = ["default_microbatches", "build_train_step",
           "build_prefill", "build_serve_step", "loops_cotangent_psum",
           "N_SHARDS"]

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
    from .sharding import worker_mesh
    wm = worker_mesh(mesh, axis)
    if wm.size() > 1:
        dist.all_reduce(partial_db, group=wm.get_group())
    return partial_db


def default_microbatches(shape: ShapeConfig,
                         per_device_batch: int = 4) -> int:
    """Pick a microbatch count for a train cell: ``per_device_batch``
    sequences per microbatch on the one data-parallel worker, walked down
    until the count divides the global batch."""
    n_mb = max(shape.global_batch // max(per_device_batch, 1), 1)
    while n_mb > 1 and shape.global_batch % n_mb:
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


def build_train_step(cfg, params, opt: OptConfig, *, n_microbatches: int = 1,
                     loss_fn: Callable | None = None,
                     recorder=None, obs=None):
    """Build the grad-accumulating AdamW train step for ``cfg``:
    ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``,
    updating ``params`` and ``opt_state`` in place; ``metrics`` carries 0-d
    tensors ``loss``, ``grad_norm``, ``lr`` and ``tokens``.  The
    reference's bundle also carries spec trees, which have no counterpart
    without a mesh, so this returns the function alone.

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

    def step(params, opt_state, batch):
        plist = [p for _, p in params.named_parameters()]
        g_acc = _flat_zeros(params, N_SHARDS)
        loss_sum = tok_sum = None
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items()}
            loss, aux = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, plist)
            for name, g in zip(names, grads):
                g_acc[name].view(-1)[:g.numel()] += g.reshape(-1)
            loss = loss.detach()
            tokens = torch.as_tensor(aux.get("tokens", 0.0), dtype=F32,
                                     device=loss.device)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            tok_sum = tokens if tok_sum is None else tok_sum + tokens
            del loss, aux, grads
        for g in g_acc.values():
            g.div_(n_mb)
        params, opt_state, gnorm = adamw.apply_updates(params, opt_state,
                                                       g_acc, opt)
        metrics = {"loss": loss_sum / n_mb, "grad_norm": gnorm,
                   "lr": adamw.lr_at(opt, opt_state["count"]),
                   "tokens": tok_sum}
        return params, opt_state, metrics

    return _maybe_record(step, recorder, "train_step", obs)


def _launch_counters() -> Tuple[Callable, ...]:
    """The kernel wrappers whose ``launches`` attribute counts launches:
    B1, B2, B3, B4 and B5."""
    from ..kernels import bcsr_spmm, csr_spmm, flash_attention, spmm_sdd
    return (csr_spmm.csr_panels_spmm, bcsr_spmm.bcsr_panels_spmm,
            spmm_sdd.csr_sdd_panels, spmm_sdd.bcsr_sdd_panels,
            flash_attention.flash_attention)


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


def build_prefill(cfg, params, batch_shape: Tuple[int, int], *,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
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
    cache specs have no counterpart without a mesh.
    """
    dev = params.embed.device
    bsz, seq = batch_shape
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
                     graph_pool=None, recorder=None, obs=None):
    """Static-buffer decode step over ``cache``:
    ``fn(tokens, length) -> (cache, logits)``.

    ``tokens`` is ``(batch, 1)`` (numpy or tensor) and ``length`` a host
    ``int``: the number of positions already in the cache, checked
    against the cache's capacity before anything runs (a ``ValueError``
    past it), then written into the static 0-d position that the step
    reads on the device (:func:`repro_torch.models.transformer.decode_step`),
    so one graph serves every position.  The step writes the new k/v into
    ``cache`` in place, as the reference's donated cache.  ``graph_pool``,
    ``recorder`` and ``obs`` as for :func:`build_prefill`.  Returns ``fn``.
    """
    dev = params.embed.device
    bsz, capacity = cache["k"].shape[1:3]
    tokens = torch.zeros((bsz, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((), dtype=torch.long, device=dev)
    step = _Static(lambda: api.decode_step(cfg, params, cache, tokens, pos),
                   dev, graph_pool)

    def decode(step_tokens, length: int):
        length = int(length)
        if not 0 <= length < capacity:
            raise ValueError(f"position {length} is past the slot's "
                             f"{capacity} cache positions")
        tokens.copy_(torch.as_tensor(step_tokens))
        pos.fill_(length)
        return step()
    return _maybe_record(decode, recorder, "decode", obs)
