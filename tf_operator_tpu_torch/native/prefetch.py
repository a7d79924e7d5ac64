"""ctypes bindings for the prefetching batch loader (``loader.cc``).

Producer threads in C++ synthesize batches into a ring ahead of the
consumer, so input generation overlaps the training step outside the GIL.
A batch depends only on (seed, batch index), whatever the thread count or
ring depth. The library is built as ``native/__init__.py`` says; a failed
build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Iterator

import numpy as np

from tf_operator_tpu_torch.native import load_library

KIND_IMAGES = 0
KIND_TOKENS = 1


def _load() -> ctypes.CDLL:
    lib = load_library("loader")
    if not hasattr(lib, "_tpuop_configured"):
        lib.tpuop_loader_create.restype = ctypes.c_void_p
        lib.tpuop_loader_create.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
        lib.tpuop_loader_next.restype = ctypes.c_int64
        lib.tpuop_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.tpuop_loader_produced.restype = ctypes.c_int64
        lib.tpuop_loader_produced.argtypes = [ctypes.c_void_p]
        lib.tpuop_loader_destroy.argtypes = [ctypes.c_void_p]
        lib._tpuop_configured = True
    return lib


class NativeLoader:
    """Iterator of prefetched numpy batches; ``close()`` (or the context
    manager) stops the producer threads."""

    def __init__(self, kind: int, dims, cardinality: int,
                 depth: int = 4, threads: int = 2, seed: int = 0):
        self._lib = _load()
        self.kind = kind
        self.dims = tuple(int(d) for d in dims)
        c_dims = (ctypes.c_int64 * 4)(*(list(self.dims) + [0] * 4)[:4])
        self._handle = self._lib.tpuop_loader_create(
            kind, c_dims, cardinality, depth, threads,
            ctypes.c_uint64(seed))
        self._closed = False
        # Serializes next/close so the handle is never used after free.
        self._call_lock = threading.Lock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # Dropped without close(): stop the producer threads rather than
        # leaking them (and the ring buffers) for the process lifetime.
        try:
            self.close()
        except Exception:
            pass

    def close(self) -> None:
        if getattr(self, "_closed", True):
            return
        with self._call_lock:
            if not self._closed and self._handle:
                self._lib.tpuop_loader_destroy(self._handle)
                self._closed = True

    def produced(self) -> int:
        return int(self._lib.tpuop_loader_produced(self._handle))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        with self._call_lock:
            if self._closed:
                raise StopIteration
            if self.kind == KIND_IMAGES:
                b, h, w, c = self.dims
                main = np.empty((b, h, w, c), np.float32)
                aux = np.empty((b,), np.int32)
                idx = self._lib.tpuop_loader_next(
                    self._handle, main.ctypes.data_as(ctypes.c_void_p),
                    aux.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if idx < 0:
                    raise StopIteration
                return {"inputs": main, "labels": aux}
            b, s = self.dims[:2]
            main = np.empty((b, s), np.int32)
            idx = self._lib.tpuop_loader_next(
                self._handle, main.ctypes.data_as(ctypes.c_void_p), None)
            if idx < 0:
                raise StopIteration
            return {"inputs": main}


def create_images(batch_size: int, image_size: int = 224,
                  num_classes: int = 1000, depth: int = 4,
                  threads: int = 2, seed: int = 0) -> NativeLoader:
    """{"inputs": f32 [B, H, W, 3] in [0, 1), "labels": i32 [B]}."""
    return NativeLoader(KIND_IMAGES,
                        (batch_size, image_size, image_size, 3),
                        num_classes, depth=depth, threads=threads, seed=seed)


def create_tokens(batch_size: int, seq_len: int, vocab_size: int,
                  depth: int = 4, threads: int = 2,
                  seed: int = 0) -> NativeLoader:
    """{"inputs": i32 [B, seq_len] in [0, vocab_size)}."""
    return NativeLoader(KIND_TOKENS, (batch_size, seq_len, 0, 0),
                        vocab_size, depth=depth, threads=threads, seed=seed)
