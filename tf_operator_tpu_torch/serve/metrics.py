"""The serving plane's four SLO metrics, under the JAX package's names.

Copy of the part of ``tf_operator_tpu/runtime/metrics.py`` the serving
modules use: labelled counters, gauges and histograms with ``inc``,
``set``, ``observe``, ``value`` and ``remove``, and the four
``tpu_operator_serving_*`` series. The operator's other metrics, the
registry and the Prometheus text rendering stay in the JAX package.
Observed by the ``ServingEngine`` and ``RequestQueue`` of whichever process
runs them.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple


class _Metric:
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


class Counter(_Metric):
    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Gauge(_Metric):
    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram."""

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


serving_tokens_per_second = Gauge(
    "tpu_operator_serving_tokens_per_second",
    "Decode throughput of this serving replica over the last engine "
    "step window (generated tokens only; prompt tokens excluded)", ())
serving_ttft_seconds = Histogram(
    "tpu_operator_serving_ttft_seconds",
    "Time to first token: request enqueue to the prefill that emitted "
    "its first generated token (the serving SLO's head latency; p50/p99 "
    "via Histogram.quantile)", (),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
serving_queue_depth = Gauge(
    "tpu_operator_serving_queue_depth",
    "Requests waiting in a tenant's QoS lane of the serving request "
    "queue (admitted-to-slot requests excluded)", ("tenant",))
serving_requests_total = Counter(
    "tpu_operator_serving_requests_total",
    "Serving requests by terminal outcome: completed (response "
    "emitted), rejected (queue full at submit), requeued (drained "
    "mid-flight back to the spool for another replica)", ("outcome",))
