"""Host -> device batch feeding (port of the device half of train/data.py).

A batch is a dict of arrays (numpy or torch). ``prefetch_to_device`` keeps
``depth`` batches in flight to the device with no thread: on a CUDA device
each batch is copied into pinned host memory and from there with a
``non_blocking`` copy on a side stream, and the compute stream waits on
that copy's event when the batch is handed out, so the copy of batch N+1
overlaps the step that uses batch N. ``DeviceFeeder`` stages batches from
a thread instead, for a source that is slow to produce them.

The JAX module's synthetic generators, native loaders and
``multihost_batch`` are not ported yet.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from collections import deque
from typing import Any, Dict, Iterator, Optional

import torch

from tf_operator_tpu_torch._device import DeviceLike, resolve_device

Batch = Dict[str, Any]


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
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue_mod.Empty:
                if self._stop.is_set():
                    raise StopIteration
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
