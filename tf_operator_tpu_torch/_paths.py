"""Where the port writes what it builds or runs at run time.

From a checkout (the package's parent holds this repo's
``pyproject.toml``) that is the checkout's ``build/``, as it always was.
From an install, whose directory may be read-only (a wheel under
``site-packages``, an image running as a non-root user), it is a per-user
cache: ``$XDG_CACHE_HOME/tf_operator_tpu_torch/``, else
``~/.cache/tf_operator_tpu_torch/``, created 0700. Nothing here is
created at import time.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

PACKAGE = Path(__file__).resolve().parent
# A line only this repo's pyproject.toml has: the port's console script.
_PYPROJECT_MARK = '"tf_operator_tpu_torch.cli:main"'


def checkout_root() -> Optional[Path]:
    """The checkout the package is imported from, or None from an
    install."""
    try:
        text = (PACKAGE.parent / "pyproject.toml").read_text()
    except OSError:
        return None
    return PACKAGE.parent if _PYPROJECT_MARK in text else None


def cache_root() -> Path:
    """The per-user cache of an installed port (the XDG base directory
    rule: a relative ``XDG_CACHE_HOME`` is ignored)."""
    base = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(base):
        base = os.path.join(os.path.expanduser("~"), ".cache")
    return Path(base) / PACKAGE.name


def base_dir() -> Path:
    """The checkout's ``build/``, else the cache."""
    root = checkout_root()
    return root / "build" if root else cache_root()


def build_dir(name: str) -> Path:
    """``build/<name>`` of the checkout, else ``<cache>/<name>``."""
    return base_dir() / name


def make_dir(path: Path) -> Path:
    """Create ``path`` and its parents; from an install the cache and
    ``path`` are made 0700."""
    if checkout_root() is None:
        cache_root().mkdir(mode=0o700, parents=True, exist_ok=True)
        path.mkdir(mode=0o700, parents=True, exist_ok=True)
    else:
        path.mkdir(parents=True, exist_ok=True)
    return path


def fresh_dir(prefix: str) -> str:
    """A new directory under the checkout's ``build/``, else under the
    cache."""
    return tempfile.mkdtemp(prefix=prefix, dir=make_dir(base_dir()))
