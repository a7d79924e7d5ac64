"""Metric-catalog drift gate: hack/torch/verify-metrics-docs.py under
tier-1, over the port's registry (``tf_operator_tpu_torch.runtime.metrics``).

Every metric registered in runtime/metrics.py must appear in the
docs/monitoring.md catalog with the right type, and vice versa — a new
metric without a docs row (or a doc row for a deleted metric) fails CI
here, so the catalog cannot rot.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hack", "torch",
    "verify-metrics-docs.py")


def _load():
    spec = importlib.util.spec_from_file_location("verify_metrics_docs",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metrics_and_docs_agree():
    mod = _load()
    assert mod.check() == []


def test_checker_parses_a_plausible_catalog():
    """The drift gate is only as good as its parser: it must actually
    see the registered metrics in the doc tables (an empty parse would
    make test_metrics_and_docs_agree pass vacuously)."""
    mod = _load()
    docs = mod.documented_metrics()
    code = mod.registered_metrics()
    assert len(docs) == len(code) >= 40
    assert docs["tpu_operator_jobs_created_total"] == "counter"
    assert docs["tpu_operator_is_leader"] == "gauge"
    assert docs["tpu_operator_reconcile_duration_seconds"] == "histogram"
    assert "tpu_operator_trace_spans_dropped_total" in docs


def test_port_registry_is_the_jax_catalogue():
    """One registry holds the port's whole catalogue, the serving plane's
    series included: the same names and kinds as the JAX registry's."""
    from tf_operator_tpu.runtime.metrics import REGISTRY as JAX_REGISTRY

    code = _load().registered_metrics()
    with JAX_REGISTRY._lock:
        jax = {name: m.kind for name, m in JAX_REGISTRY._metrics.items()}
    assert code == jax
    assert len(code) == 63
    assert {"tpu_operator_serving_ttft_seconds",
            "tpu_operator_serving_requests_total",
            "tpu_operator_gateway_requests_total"} <= set(code)


def test_checker_reports_drift(tmp_path):
    """A doctored doc (one missing row, one stale row, one wrong type)
    produces exactly the three findings."""
    mod = _load()
    lines = []
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(_SCRIPT))), "docs", "monitoring.md"),
              encoding="utf-8") as f:
        for line in f:
            if "tpu_operator_jobs_created_total" in line:
                continue  # registered but undocumented
            if "tpu_operator_is_leader" in line:
                line = line.replace("| gauge |", "| counter |")
            lines.append(line)
    lines.append("| `tpu_operator_ghost_total` | counter | gone |\n")
    doctored = tmp_path / "monitoring.md"
    doctored.write_text("".join(lines), encoding="utf-8")
    docs = mod.documented_metrics(str(doctored))
    code = mod.registered_metrics()
    assert "tpu_operator_jobs_created_total" in set(code) - set(docs)
    assert "tpu_operator_ghost_total" in set(docs) - set(code)
    assert docs["tpu_operator_is_leader"] == "counter" != \
        code["tpu_operator_is_leader"]


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
