"""Step functions of the serving path: prefill and decode over static
buffers, captured as CUDA graphs on the card.

Port of the serve half of ``repro/dist/step.py`` (:func:`build_prefill`,
:func:`build_serve_step` and :func:`_maybe_record`).  The reference jits
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

No mesh and no sharding: the distributed operator is ROADMAP A.12.  The
training step (``build_train_step``) waits for A.13's training part.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models import api

__all__ = ["build_prefill", "build_serve_step"]


def _maybe_record(fn, recorder, op: str, obs=None):
    """Wrap a step function with the perf-trace recorder and/or a live obs
    capture (no-op without either), as the reference does: obs wraps
    outermost, so its span brackets the recorder's timing too."""
    if recorder is not None:
        fn = recorder.wrap_step(fn, op=op)
    if obs is not None:
        fn = obs.wrap_step(fn, op=op)
    return fn


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
