"""Build the CUDA sources under ``csrc/`` with nvcc and bind them by ctypes.

The library is built on first use into ``build/torch_kernels/`` at the
root of the checkout, named by a hash of its sources and flags, so an edit
to a source rebuilds it and an unchanged tree reuses the last build. The
sources have a plain C interface (no PyTorch headers), which keeps one
build to seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
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
    with _lock:
        if name in _loaded:
            return _loaded[name]
        main, _ = _sources(name)
        lib = library_path(name)
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
