"""The serving plane's metrics, under the JAX package's names.

Copy of the part of ``tf_operator_tpu/runtime/metrics.py`` the serving
modules use: labelled counters, gauges and histograms with ``inc``,
``set``, ``observe``, ``value`` and ``remove``, a registry that renders
the Prometheus text exposition (v0.0.4, the gateway's ``/metrics``), the
four ``tpu_operator_serving_*`` series (observed by the ``ServingEngine``
and ``RequestQueue`` of whichever process runs them) and the gateway's
two (``serve/gateway.py``). The operator's other metrics stay in the JAX
package.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != "
                f"declared {sorted(self.label_names)}")
        return tuple(labels[n] for n in self.label_names)

    def remove(self, **labels: str) -> None:
        """Drop one labelled series (a deleted tenant's lane must not stay
        in the exposition forever). No-op when it never existed."""
        key = self._key(labels)
        with self._lock:
            self._children.pop(key, None)
            self._drop_child(key)

    def _drop_child(self, key: Tuple[str, ...]) -> None:
        """Subclass hook: drop per-child state beyond ``_children``."""

    def _render_labels(self, values: Tuple[str, ...]) -> str:
        if not self.label_names:
            return ""
        inner = ",".join(
            f'{n}="{_escape(v)}"' for n, v in zip(self.label_names, values))
        return "{" + inner + "}"

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            samples = sorted(self._children.items())
        if not samples and not self.label_names:
            samples = [((), 0.0)]
        for values, v in samples:
            lines.append(f"{self.name}{self._render_labels(values)} "
                         f"{_fmt(v)}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, label_names: Sequence[str],
                 buckets: Sequence[float]):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def _drop_child(self, key: Tuple[str, ...]) -> None:
        self._counts.pop(key, None)
        self._sums.pop(key, None)
        self._totals.pop(key, None)

    def sum_value(self, **labels: str) -> float:
        """The series' cumulative _sum sample."""
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def count_value(self, **labels: str) -> int:
        """The series' cumulative _count sample."""
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                bounds = [_fmt(ub) for ub in self.buckets] + ["+Inf"]
                counts = self._counts[key] + [self._totals[key]]
                for le, count in zip(bounds, counts):
                    labels = dict(zip(self.label_names, key), le=le)
                    inner = ",".join(f'{n}="{_escape(v)}"'
                                     for n, v in labels.items())
                    lines.append(f"{self.name}_bucket{{{inner}}} {count}")
                base = self._render_labels(key)
                lines.append(f"{self.name}_sum{base} "
                             f"{_fmt(self._sums[key])}")
                lines.append(f"{self.name}_count{base} {self._totals[key]}")
        return lines


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Registry:
    """Metrics by name, rendered together (the JAX registry's exposition)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            return self._metrics.setdefault(metric.name, metric)

    def render_text(self) -> str:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out: List[str] = []
        for m in metrics:
            out.extend(m.render())
        return "\n".join(out) + "\n"


REGISTRY = Registry()

serving_tokens_per_second = REGISTRY.register(Gauge(
    "tpu_operator_serving_tokens_per_second",
    "Decode throughput of this serving replica over the last engine "
    "step window (generated tokens only; prompt tokens excluded)", ()))
serving_ttft_seconds = REGISTRY.register(Histogram(
    "tpu_operator_serving_ttft_seconds",
    "Time to first token: request enqueue to the prefill that emitted "
    "its first generated token (the serving SLO's head latency; p50/p99 "
    "via Histogram.quantile)", (),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0)))
serving_queue_depth = REGISTRY.register(Gauge(
    "tpu_operator_serving_queue_depth",
    "Requests waiting in a tenant's QoS lane of the serving request "
    "queue (admitted-to-slot requests excluded)", ("tenant",)))
serving_requests_total = REGISTRY.register(Counter(
    "tpu_operator_serving_requests_total",
    "Serving requests by terminal outcome: completed (response "
    "emitted), rejected (queue full at submit), requeued (drained "
    "mid-flight back to the spool for another replica)", ("outcome",)))
gateway_requests = REGISTRY.register(Counter(
    "tpu_operator_gateway_requests_total",
    "HTTP requests the serving gateway answered, by status code (200 "
    "accepted+streamed, 400 malformed, 401 unknown auth token, 429 "
    "spool backlog at maxQueueDepth — carries Retry-After)", ("code",)))
gateway_streaming_seconds = REGISTRY.register(Histogram(
    "tpu_operator_gateway_streaming_seconds",
    "Accepted gateway request admission to last streamed token (the "
    "full-response latency the TTFT histogram is the head of)", (),
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0)))
