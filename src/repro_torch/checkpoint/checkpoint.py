"""Fault-tolerant checkpointing (port of ``repro/checkpoint/checkpoint.py``).

The reference's semantics, kept:
  * **atomicity**: write to ``<dir>/tmp.<step>`` then ``os.replace``: a
    crash mid-write never corrupts the latest checkpoint;
  * **async**: :meth:`Checkpointer.save_async` copies the tree to host
    memory on the caller's thread (training then mutates its tensors in
    place) and hands it to a writer thread behind a queue of depth 1, so
    checkpoint backpressure surfaces instead of silently eating RAM.  The
    host copies land in buffers the :class:`Checkpointer` owns (pinned for
    device tensors) and reuses once the writer is done with them, so a
    run holds one set per save in flight (at most three: one written, one
    queued, one being copied), not a fresh set per save;
  * **topology independence**: trees are saved unsharded, with the step
    and metadata, and :func:`restore` fills a template's structure with
    CPU tensors that the caller places where it wants;
  * **retention**: the newest ``keep`` checkpoints stay, older go.

Format (a deliberate divergence: the reference writes one msgpack file,
and the GPU machine has no msgpack).  One file ``ckpt_<step>.tensors``:
the 16 bytes :data:`MAGIC`, a little-endian uint64 header length, a UTF-8
JSON header ``{"step", "meta", "arrays": {path: [dtype, shape, offset,
nbytes]}}``, then each array's raw bytes at ``offset`` (64-byte aligned)
from the end of the header.  Paths join the tree's keys with ``/`` as the
reference's do; dtypes are torch's names (``bfloat16``, which numpy lacks,
is stored as its raw bytes like any other), so numpy and torch alone read
it back.
"""
from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["Checkpointer", "save", "restore", "latest_step", "MAGIC"]

MAGIC = b"REPROTORCHCKPT01"
_ALIGN = 64
_SUFFIX = ".tensors"


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of nested dicts / lists / tuples, depth first in
    insertion order; every other object is a leaf."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _map(tree, fn, prefix=()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {key: _map(sub, fn, prefix + (str(key),))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(sub, fn, prefix + (str(i),))
                          for i, sub in enumerate(tree))
    return fn("/".join(prefix), tree)


def _host(leaf, copy: bool = True, out: torch.Tensor | None = None
          ) -> torch.Tensor:
    """``leaf`` (a tensor, array or number) as a CPU tensor; with ``copy``
    one that never shares memory with it, written into ``out`` where
    ``out`` is a CPU tensor of the leaf's shape and dtype.  A device tensor
    is copied into pinned host memory without waiting: the caller
    synchronises."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        on_device = leaf.device.type != "cpu"
        if not (copy or on_device):
            return leaf
        if (out is None or out.shape != leaf.shape
                or out.dtype != leaf.dtype):
            out = torch.empty(leaf.shape, dtype=leaf.dtype,
                              pin_memory=on_device)
        return out.copy_(leaf, non_blocking=on_device)
    return torch.from_numpy(np.array(leaf) if copy
                            else np.ascontiguousarray(leaf))


def _on_device(tree) -> bool:
    return any(isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"
               for _, leaf in _leaves(tree))


def _host_tree(tree, buffers: Dict[str, torch.Tensor] | None = None):
    """A host copy of ``tree``; device-to-host copies run into pinned
    memory and are waited for once, at the end.  ``buffers`` (path ->
    tensor) supplies the tensors the copies land in, and takes any new
    one it lacked."""
    def copy(path, leaf):
        if buffers is None:
            return _host(leaf)
        out = _host(leaf, out=buffers.get(path))
        if isinstance(leaf, torch.Tensor):
            buffers[path] = out
        return out
    out = _map(tree, copy)
    if _on_device(tree):
        torch.cuda.synchronize()
    return out


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:010d}{_SUFFIX}")


def _write(path: str, step: int, tree, meta: Dict[str, Any]) -> None:
    """Write a host tree (CPU tensors, arrays or numbers) to ``path``."""
    arrays, blobs, offset = {}, [], 0
    for key, leaf in _leaves(tree):
        t = _host(leaf, copy=False).contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        arrays[key] = [str(t.dtype).replace("torch.", ""), list(t.shape),
                       offset, raw.nbytes]
        blobs.append((offset, raw))
        offset += -(-raw.nbytes // _ALIGN) * _ALIGN
    header = json.dumps({"step": step, "meta": meta,
                         "arrays": arrays}).encode()
    header += b" " * (-(len(MAGIC) + 8 + len(header)) % _ALIGN)
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<Q", len(header)) + header)
        base = f.tell()
        for off, raw in blobs:
            f.seek(base + off)
            f.write(memoryview(raw))


def save(directory: str, step: int, tree, meta: Dict[str, Any] | None = None,
         keep: int = 3) -> str:
    """Write ``tree`` (nested dicts / lists of tensors, arrays or numbers)
    as checkpoint ``step``, atomically; keep the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    if _on_device(tree):
        tree = _host_tree(tree)
    tmp = os.path.join(directory, f"tmp.{step}")
    _write(tmp, step, tree, meta or {})
    final = _ckpt_path(directory, step)
    os.replace(tmp, final)  # atomic on POSIX
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_"))
    for old in ckpts[:-keep]:
        try:
            os.remove(os.path.join(directory, old))
        except OSError:
            pass


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory) if f.startswith("ckpt_"))
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1].split(".")[0])


def _read(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a checkpoint of this format")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = f.tell()
        arrays = {}
        for key, (dtype, shape, off, nbytes) in header["arrays"].items():
            buf = torch.empty(nbytes, dtype=torch.uint8)
            f.seek(base + off)
            if f.readinto(buf.numpy()) != nbytes:
                raise ValueError(f"{path}: {key} is truncated")
            arrays[key] = buf.view(getattr(torch, dtype)).reshape(shape)
    return header, arrays


def restore(directory: str, template, step: int | None = None
            ) -> Tuple[int, Any, Dict[str, Any]]:
    """Returns (step, tree, meta): ``template``'s structure with each leaf
    the saved CPU tensor at its path.  The caller moves the tensors to its
    own device (this is what makes restore topology-independent)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    header, arrays = _read(_ckpt_path(directory, step))

    def rebuild(path, _leaf):
        if path not in arrays:
            raise KeyError(f"checkpoint {step} has no array {path!r}")
        return arrays[path]
    return header["step"], _map(template, rebuild), header["meta"]


class Checkpointer:
    """Bounded-queue async writer.  ``timings`` holds, per save, the
    seconds the caller spent handing the tree over (its copy to host
    memory) and the seconds the writer spent on the file.  The host
    buffers of a written save go back to a free list, and the next save
    copies into them."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.timings: list = []
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._free: list = []          # host buffer sets not in flight
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, meta, rec, buffers = item
            try:
                t0 = time.perf_counter()
                save(self.directory, step, tree, meta, keep=self.keep)
                rec["write_s"] = time.perf_counter() - t0
            except Exception as e:  # surfaced on next save/wait
                self._err = e
            finally:
                with self._lock:
                    self._free.append(buffers)
                self._q.task_done()

    def save_async(self, step: int, tree, meta=None):
        if self._err:
            raise self._err
        # the host copy on the caller's thread: the writer never touches
        # the device, and training may update the tensors in place after
        t0 = time.perf_counter()
        with self._lock:
            buffers = self._free.pop() if self._free else {}
        host_tree = _host_tree(tree, buffers)
        rec = {"step": step, "handoff_s": time.perf_counter() - t0}
        self.timings.append(rec)
        self._q.put((step, host_tree, meta or {}, rec, buffers))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()
        self._free.clear()
