"""The port's copy of the native batch generator (``batchgen.cc``) and its
ctypes bindings; ``prefetch.py`` binds the prefetching loader
(``loader.cc``).

Each library is built on first use with g++ into ``build/torch_native/``
at the root of the checkout, or from an install into ``torch_native/`` of
the per-user cache (``_paths.py``), named by a hash of its source and
flags, so an edited source is rebuilt and an unchanged one reused. A
failed build raises: there is no numpy fallback, whose numbers for the
same seed would differ from the JAX package's native ones (the C++ here
is the same, so the same seed gives the same bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from tf_operator_tpu_torch import _paths

SRC = Path(__file__).resolve().parent
BUILD_DIR = _paths.build_dir("torch_native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the build of ``<name>.cc`` for the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SRC / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``<name>.cc``; raise if g++ fails."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        lib = library_path(name)
        if not lib.exists():
            _paths.make_dir(BUILD_DIR)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                   str(SRC / f"{name}.cc")]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name}.cc failed ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib)
        _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


def _load() -> ctypes.CDLL:
    lib = load_library("batchgen")
    if not hasattr(lib, "_tpuop_configured"):
        lib.tpuop_fill_uniform_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_uint64]
        lib.tpuop_fill_randint_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
        lib.tpuop_normalize_u8_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        lib._tpuop_configured = True
    return lib


def fill_uniform(shape, seed: int) -> np.ndarray:
    """float32 uniform in [0, 1) from splitmix64 streams of ``seed``."""
    out = np.empty(shape, np.float32)
    _load().tpuop_fill_uniform_f32(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size, ctypes.c_uint64(seed))
    return out


def fill_randint(shape, low: int, high: int, seed: int) -> np.ndarray:
    """int32 uniform in [low, high) from splitmix64 streams of ``seed``."""
    out = np.empty(shape, np.int32)
    _load().tpuop_fill_randint_i32(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.size, low, high, ctypes.c_uint64(seed))
    return out


def normalize_images(images_u8: np.ndarray, mean, std) -> np.ndarray:
    """[..., C] uint8 -> float32 (x/255 - mean)/std per channel."""
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    channels = images_u8.shape[-1]
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = np.empty(images_u8.shape, np.float32)
    _load().tpuop_normalize_u8_f32(
        images_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        images_u8.size // channels,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        channels)
    return out
