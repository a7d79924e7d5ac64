#!/usr/bin/env python3
"""Metric-catalog drift check: runtime/metrics.py vs docs/monitoring.md.

The port's copy of ``hack/verify-metrics-docs.py``: the same checks on
``tf_operator_tpu_torch.runtime.metrics.REGISTRY``, the one registry
the port's controllers and serving plane count into.

Every metric registered in the code must appear in the docs catalog
with the right type, and every documented metric must still exist in
the code — wired into tier-1 as tests/test_torch_metrics_docs.py so the
catalog cannot rot (an undocumented metric is invisible to operators;
a documented-but-deleted one sends them hunting for a series that will
never appear).

Usage: python hack/torch/verify-metrics-docs.py   # exit 0 clean, 1 on drift
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOC = os.path.join(REPO, "docs", "monitoring.md")

# | `tpu_operator_foo_total{label}` | counter | meaning... |
_ROW = re.compile(
    r"^\|\s*`(tpu_operator_[a-z0-9_]+)(?:\{[^}]*\})?`\s*\|\s*(\w+)\s*\|")


def registered_metrics() -> dict:
    """name -> type from the live registry (importing the module IS the
    registration)."""
    sys.path.insert(0, REPO)
    from tf_operator_tpu_torch.runtime.metrics import REGISTRY

    with REGISTRY._lock:
        return {name: m.kind for name, m in REGISTRY._metrics.items()}


def documented_metrics(path: str = DOC) -> dict:
    """name -> type from the docs/monitoring.md catalog tables."""
    out: dict = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            m = _ROW.match(line.strip())
            if m:
                out[m.group(1)] = m.group(2).lower()
    return out


def check() -> list:
    """All drift findings, empty when code and docs agree."""
    code = registered_metrics()
    docs = documented_metrics()
    problems = []
    for name in sorted(set(code) - set(docs)):
        problems.append(
            f"{name} ({code[name]}) is registered in runtime/metrics.py "
            "but missing from the docs/monitoring.md catalog")
    for name in sorted(set(docs) - set(code)):
        problems.append(
            f"{name} is documented in docs/monitoring.md but no longer "
            "registered in runtime/metrics.py")
    for name in sorted(set(code) & set(docs)):
        if code[name] != docs[name]:
            problems.append(
                f"{name}: registered as {code[name]} but documented as "
                f"{docs[name]}")
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(f"DRIFT: {p}")
    if problems:
        print(f"{len(problems)} metric-catalog drift problem(s)")
        return 1
    print(f"ok: {len(registered_metrics())} metrics, code and docs agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
