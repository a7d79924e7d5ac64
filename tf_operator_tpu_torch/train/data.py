"""Input pipelines and host -> device batch feeding (port of
train/data.py).

``SyntheticLM`` and ``SyntheticImages`` draw each batch from the port's
copy of the native batch generator (``tf_operator_tpu_torch/native``) at
seed ``(seed << 20) + step``, and ``lm_pipeline``/``images_pipeline`` from
its prefetching C++ loader; all yield numpy batches, byte for byte the JAX
package's for the same arguments. A native library that does not build
raises: there is no Python fallback.

A batch is a dict of arrays (numpy or torch). ``prefetch_to_device`` keeps
``depth`` batches in flight to the device with no thread: on a CUDA device
each batch is copied into pinned host memory and from there with a
``non_blocking`` copy on a side stream, and the compute stream waits on
that copy's event when the batch is handed out, so the copy of batch N+1
overlaps the step that uses batch N. ``DeviceFeeder`` stages batches from
a thread instead, for a source that is slow to produce them.

Multi-process feeding: ``multihost_batch`` makes a global batch out of
this process's local slice without the global batch ever existing on one
host (a DTensor sharded over the mesh's data axes), and ``local_batch``
gives a trainer step the slice of a batch that is its rank's.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from collections import deque
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from tf_operator_tpu_torch import native
from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.native import prefetch
from tf_operator_tpu_torch.parallel.mesh import (
    batch_placements,
    data_index,
    data_parallel_size,
)

Batch = Dict[str, Any]


class SyntheticLM:
    """Deterministic token stream: [B, S+1] int32 batches."""

    def __init__(self, batch_size: int, seq_len: int, vocab_size: int,
                 seed: int = 0):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            step += 1
            yield {"inputs": native.fill_randint(
                (self.batch_size, self.seq_len + 1), 0, self.vocab_size,
                (self.seed << 20) + step)}


class SyntheticImages:
    """[B, H, W, 3] float32 images in [0, 1) and int32 labels."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            step += 1
            s = (self.seed << 20) + step
            yield {
                "inputs": native.fill_uniform(
                    (self.batch_size, self.image_size, self.image_size, 3),
                    s),
                "labels": native.fill_randint(
                    (self.batch_size,), 0, self.num_classes, s),
            }


def images_pipeline(batch_size: int, image_size: int = 224,
                    num_classes: int = 1000, seed: int = 0,
                    prefetch_depth: int = 4, threads: int = 2
                    ) -> prefetch.NativeLoader:
    """The native prefetching loader's images (producer threads and a ring
    of ``prefetch_depth`` batches, no GIL): {"inputs": f32 [B, H, W, 3],
    "labels": i32 [B]}. ``close()`` it to stop the threads."""
    return prefetch.create_images(batch_size, image_size, num_classes,
                                  depth=prefetch_depth, threads=threads,
                                  seed=seed)


def lm_pipeline(batch_size: int, seq_len: int, vocab_size: int,
                seed: int = 0, prefetch_depth: int = 4,
                threads: int = 2) -> prefetch.NativeLoader:
    """The native loader's tokens: {"inputs": i32 [B, S+1]}, S+1 so the
    trainer can shift."""
    return prefetch.create_tokens(batch_size, seq_len + 1, vocab_size,
                                  depth=prefetch_depth, threads=threads,
                                  seed=seed)


def _stage(batch: Batch, device: torch.device,
           stream: Optional["torch.cuda.Stream"]):
    """Start copying ``batch`` to ``device``: (the device batch, the event
    its copies complete at, or None where nothing is in flight)."""
    if stream is None:
        return {k: torch.as_tensor(v).to(device, copy=True)
                for k, v in batch.items()}, None
    with torch.cuda.stream(stream):
        placed = {k: torch.as_tensor(v).pin_memory().to(device,
                                                        non_blocking=True)
                  for k, v in batch.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return placed, done


def _hand_over(placed: Batch, done: Optional["torch.cuda.Event"]) -> Batch:
    """Make the current stream wait for the copies, and tell the caching
    allocator the tensors are used there (they were allocated on the side
    stream)."""
    if done is not None and placed:
        current = torch.cuda.current_stream(
            next(iter(placed.values())).device)
        current.wait_event(done)
        for tensor in placed.values():
            tensor.record_stream(current)
    return placed


def _side_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def prefetch_to_device(it: Iterator[Batch], device: DeviceLike = None,
                       depth: int = 2) -> Iterator[Batch]:
    """Yield the batches of ``it`` on ``device`` (the card by default),
    with up to ``depth`` more already staged (module docstring): never
    more than ``depth`` + 1 pulled ahead of the consumer, in order, and
    nothing lost at the end of a finite iterator. The consumer must use
    each batch before it pulls the next, as a training loop does."""
    device = resolve_device(device)
    stream = _side_stream(device)
    it = iter(it)
    buf: deque = deque()
    for batch in it:
        buf.append(_stage(batch, device, stream))
        if len(buf) >= max(1, depth):
            break
    while buf:
        staged = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(_stage(nxt, device, stream))
        yield _hand_over(*staged)


class DeviceFeeder:
    """Background thread that stages host batches onto ``device`` up to
    ``prefetch`` ahead (hides the host->device copy behind compute).
    Iterating ends with the source; ``stop()`` ends it early and frees a
    producer blocked on a full queue."""

    def __init__(self, it: Iterator[Batch], device: DeviceLike = None,
                 prefetch: int = 2):
        self._it = iter(it)
        self._device = resolve_device(device)
        self._stream = _side_stream(self._device)
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that honors stop() even when the queue is full."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _loop(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                if not self._put(_stage(batch, self._device, self._stream)):
                    return
            self._put(StopIteration())  # finite iterator: wake the consumer
        except Exception as e:  # surface in the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        while True:
            # Checked first: a producer blocked in _put may still land one
            # batch after stop() drained the queue.
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue_mod.Empty:
                continue
        if isinstance(item, StopIteration):
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return _hand_over(*item)

    def stop(self):
        self._stop.set()
        # Drain so a producer blocked in _put can observe the stop flag,
        # and wake any consumer blocked before the flag was set.
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass


def multihost_batch(local: Batch, mesh) -> Batch:
    """Assemble a global batch from this process's local slice (multihost
    feeding; each host makes only its own): each leaf becomes a DTensor on
    ``mesh`` sharded on dim 0 over the data axes and replicated over the
    others, on the mesh's device. Every rank passes slices of one size."""
    from torch.distributed.tensor import DTensor

    placements = batch_placements(mesh)
    return {k: DTensor.from_local(torch.as_tensor(v), mesh, placements,
                                  run_check=False)
            for k, v in local.items()}


def local_batch(batch: Batch, mesh, batch_dim: int = 0) -> Batch:
    """This rank's slice of ``batch`` along ``batch_dim`` over the mesh's
    data axes: a DTensor leaf (``multihost_batch``) gives its local shard,
    a whole batch (numpy or torch, the same on every rank) its
    ``data_index``-th of ``data_parallel_size`` equal slices."""
    from torch.distributed.tensor import DTensor

    n, i = data_parallel_size(mesh), data_index(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v.to_local()
            continue
        size = v.shape[batch_dim]
        if size % n:
            raise ValueError(f"batch {k!r} of {size} along dim {batch_dim} "
                             f"does not split over {n} data shards")
        step = size // n
        index = (slice(None),) * batch_dim + (slice(i * step,
                                                    (i + 1) * step),)
        out[k] = v[index]
    return out
