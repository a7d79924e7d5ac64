"""Build the CUDA sources under ``csrc/`` with nvcc and bind them by ctypes.

Each library (one ``csrc/<name>.cu`` and every ``.cuh``) is built on
first use into ``build/torch_kernels/`` at the root of the checkout, or
from an install into ``torch_kernels/`` of the per-user cache
(``_paths.py``), named by a hash of its sources and flags, so an edit to
a source rebuilds it and an unchanged tree reuses the last build. The sources have a plain C
interface (no PyTorch headers), which keeps one build to seconds or tens
of seconds. Two libraries build in parallel (one nvcc each, ``load_all``);
one library is built once however many threads ask for it. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

from tf_operator_tpu_torch import _paths

CSRC = _paths.PACKAGE / "csrc"
BUILD_DIR = _paths.build_dir("torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, path of the library, compiler output)
build_info: Dict[str, Tuple[float, str, str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built on the machine with "
                       "the card")


def _sources(name: str):
    main = CSRC / f"{name}.cu"
    headers = sorted(CSRC.glob("*.cuh"))
    return main, [main, *headers]


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` for the current sources lives."""
    _, files = _sources(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raise if nvcc fails."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        main, _ = _sources(name)
        lib = library_path(name)
        if not lib.exists():
            _paths.make_dir(BUILD_DIR)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(main)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {main}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib)
            build_info[name] = (seconds, str(lib), proc.stdout + proc.stderr)
        else:
            build_info[name] = (0.0, str(lib), "")
        _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build and load several libraries at once, one nvcc each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))
