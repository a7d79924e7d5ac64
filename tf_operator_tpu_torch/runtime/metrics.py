"""Operator metrics: counters/gauges/histograms + Prometheus exposition.

Reference parity: the promauto counters sprinkled through the reference
controller (pkg/controller.v1/tensorflow/job.go:29-36 jobs created/
deleted/restarted, status.go:47-61 successful/failed, pod.go:56-63
restarted pods, vendored common/pod.go:57-70 created/deleted pods,
common/service.go:36-45 service creations, common/job_controller.go:41-57
PodGroups, cmd/tf-operator.v1/app/server.go:65-69 is_leader gauge) and
the /metrics endpoint (cmd/tf-operator.v1/main.go:39-50). The catalog is
documented in docs/monitoring.md, mirroring the reference's
docs/monitoring/README.md.

No prometheus_client dependency: the registry renders the text
exposition format (v0.0.4) itself, which is all a scraper needs.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], float] = {}

    kind = "untyped"

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != "
                f"declared {sorted(self.label_names)}")
        return tuple(labels[n] for n in self.label_names)

    def collect(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._children.items())

    def remove(self, **labels: str) -> None:
        """Drop one labeled child series so deleted objects stop
        occupying the exposition forever (job-labeled gauges are pruned
        by job GC — unbounded cardinality is a slow OOM on a
        long-running operator). No-op when the series never existed."""
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
        samples = self.collect()
        if not samples and not self.label_names:
            samples = [((), 0.0)]
        for values, v in samples:
            lines.append(f"{self.name}{self._render_labels(values)} {_fmt(v)}")
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

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (used for reconcile + ready latency)."""

    kind = "histogram"

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, name: str, help_: str, label_names: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
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

    def time(self, **labels: str) -> "_Timer":
        return _Timer(self, labels)

    def _drop_child(self, key: Tuple[str, ...]) -> None:
        self._counts.pop(key, None)
        self._sums.pop(key, None)
        self._totals.pop(key, None)

    def sum_value(self, **labels: str) -> float:
        """The series' cumulative _sum sample (benchmark artifacts read
        totals without scraping the exposition text)."""
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def count_value(self, **labels: str) -> int:
        """The series' cumulative _count sample."""
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """The ``q``-quantile (0 <= q <= 1) interpolated from the
        cumulative bucket counts — Prometheus ``histogram_quantile``
        semantics, computed locally so status/bench artifacts can report
        p50/p99 without a scrape+PromQL round trip:

        - linear interpolation inside the bucket the target rank lands
          in (lower bound = previous bucket's upper bound, 0.0 for the
          first bucket);
        - ranks falling in the +Inf overflow bucket clamp to the highest
          finite bound (the histogram cannot resolve beyond it);
        - None when the series has no observations.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        key = self._key(labels)
        with self._lock:
            total = self._totals.get(key, 0)
            if total == 0:
                return None
            counts = list(self._counts.get(key, ()))
        target = q * total
        prev_cum, lo = 0, 0.0
        for cum, hi in zip(counts, self.buckets):
            if cum >= target:
                in_bucket = cum - prev_cum
                frac = ((target - prev_cum) / in_bucket) if in_bucket else 1.0
                return lo + frac * (hi - lo)
            prev_cum, lo = cum, hi
        return float(self.buckets[-1])

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                counts = self._counts[key]
                for i, ub in enumerate(self.buckets):
                    labels = dict(zip(self.label_names, key))
                    labels["le"] = _fmt(ub)
                    inner = ",".join(f'{n}="{_escape(v)}"'
                                     for n, v in labels.items())
                    lines.append(
                        f"{self.name}_bucket{{{inner}}} {counts[i]}")
                base = self._render_labels(key)
                inf_labels = dict(zip(self.label_names, key))
                inf_labels["le"] = "+Inf"
                inner = ",".join(f'{n}="{_escape(v)}"'
                                 for n, v in inf_labels.items())
                lines.append(f"{self.name}_bucket{{{inner}}} "
                             f"{self._totals[key]}")
                lines.append(f"{self.name}_sum{base} "
                             f"{_fmt(self._sums[key])}")
                lines.append(f"{self.name}_count{base} {self._totals[key]}")
        return lines


class _Timer:
    def __init__(self, hist: Histogram, labels: Dict[str, str]):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, **self.labels)
        return False


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help_, labels))  # type: ignore

    def gauge(self, name: str, help_: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_, labels))  # type: ignore

    def histogram(self, name: str, help_: str, labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(
            Histogram(name, help_, labels, buckets))  # type: ignore

    def render_text(self) -> str:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out: List[str] = []
        for m in metrics:
            out.extend(m.render())
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Test helper: drop all recorded samples, keep registrations."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._children.clear()
                if isinstance(m, Histogram):
                    m._counts.clear()
                    m._sums.clear()
                    m._totals.clear()


REGISTRY = Registry()

# --- the catalog (docs/monitoring.md; names mirror the reference's) -------

jobs_created = REGISTRY.counter(
    "tpu_operator_jobs_created_total",
    "Counts number of TPU jobs created", ["job_namespace"])
jobs_deleted = REGISTRY.counter(
    "tpu_operator_jobs_deleted_total",
    "Counts number of TPU jobs deleted", ["job_namespace"])
jobs_successful = REGISTRY.counter(
    "tpu_operator_jobs_successful_total",
    "Counts number of TPU jobs successful", ["job_namespace"])
jobs_failed = REGISTRY.counter(
    "tpu_operator_jobs_failed_total",
    "Counts number of TPU jobs failed", ["job_namespace"])
jobs_restarted = REGISTRY.counter(
    "tpu_operator_jobs_restarted_total",
    "Counts number of TPU jobs restarted", ["job_namespace"])
created_pods = REGISTRY.counter(
    "tpu_operator_created_pods_total",
    "Counts number of pods created by the operator", ["job_namespace"])
deleted_pods = REGISTRY.counter(
    "tpu_operator_deleted_pods_total",
    "Counts number of pods deleted by the operator", ["job_namespace"])
restarted_pods = REGISTRY.counter(
    "tpu_operator_restarted_pods_total",
    "Counts number of pods restarted with identity", ["job_namespace"])
created_endpoints = REGISTRY.counter(
    "tpu_operator_created_endpoints_total",
    "Counts number of per-replica endpoints created", ["job_namespace"])
deleted_endpoints = REGISTRY.counter(
    "tpu_operator_deleted_endpoints_total",
    "Counts number of per-replica endpoints deleted", ["job_namespace"])
slicegroups_created = REGISTRY.counter(
    "tpu_operator_slicegroups_created_total",
    "Counts number of gang SliceGroups created", ["job_namespace"])
slicegroups_deleted = REGISTRY.counter(
    "tpu_operator_slicegroups_deleted_total",
    "Counts number of gang SliceGroups deleted", ["job_namespace"])
slicegroups_preempted = REGISTRY.counter(
    "tpu_operator_slicegroups_preempted_total",
    "Counts gang SliceGroups evicted back to Pending by higher-priority "
    "admission", ["job_namespace"])
gang_pods_bound = REGISTRY.counter(
    "tpu_operator_gang_pods_bound_total",
    "Counts pods the in-operator slice-gang binder bound to nodes",
    ["job_namespace"])
slice_drains = REGISTRY.counter(
    "tpu_operator_slice_drains_total",
    "Counts gang SliceGroups atomically drained off degraded nodes by "
    "the slice-health controller", ["job_namespace"])
nodes_cordoned = REGISTRY.counter(
    "tpu_operator_nodes_cordoned_total",
    "Counts nodes the slice-health controller cordoned on degradation "
    "signals", ["reason"])
drain_rebind_seconds = REGISTRY.histogram(
    "tpu_operator_drain_rebind_seconds",
    "Gang drain to fully-rebound-on-spare-capacity latency (slice-health "
    "auto-repair)", ["job_namespace"],
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
             300.0))
kube_client_throttled = REGISTRY.counter(
    "tpu_operator_kube_client_throttled_total",
    "Counts 429 responses the kube client honored (slept Retry-After "
    "and retried)")
is_leader = REGISTRY.gauge(
    "tpu_operator_is_leader",
    "1 while this operator replica holds the leader lease")
reconcile_seconds = REGISTRY.histogram(
    "tpu_operator_reconcile_duration_seconds",
    "Wall time of one job reconcile")
ready_latency_seconds = REGISTRY.histogram(
    "tpu_operator_all_replicas_ready_seconds",
    "Job creation to all-replicas-Running latency (BASELINE north star)",
    ["job_namespace"],
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0))
workqueue_depth = REGISTRY.gauge(
    "tpu_operator_workqueue_depth",
    "Items waiting in the controller workqueue")
workqueue_coalesced = REGISTRY.counter(
    "tpu_operator_workqueue_coalesced_total",
    "Enqueues coalesced into an already-pending key (event storms "
    "collapsed into one sync)")
workqueue_latency_seconds = REGISTRY.histogram(
    "tpu_operator_workqueue_latency_seconds",
    "Enqueue-to-dequeue wait of workqueue items (sync scheduling "
    "latency)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
             2.5, 5.0, 10.0, 30.0))
events_aggregated = REGISTRY.counter(
    "tpu_operator_events_aggregated_total",
    "Recorder events folded into an existing event (duplicate count "
    "bump or EventAggregator-style similar-event collapse) instead of "
    "stored/posted individually")
queue_pending_slices = REGISTRY.gauge(
    "tpu_operator_queue_pending_slices",
    "SliceGroups of a tenant queue waiting for quota or capacity",
    ["queue"])
queue_admitted_chips = REGISTRY.gauge(
    "tpu_operator_queue_admitted_chips",
    "Chips currently admitted through a ClusterQueue", ["queue"])
queue_borrowed_chips = REGISTRY.gauge(
    "tpu_operator_queue_borrowed_chips",
    "Portion of a ClusterQueue's admitted chips above its nominal quota "
    "(borrowed from idle cohort capacity)", ["queue"])
quota_reclaims = REGISTRY.counter(
    "tpu_operator_quota_reclaims_total",
    "Borrowed gangs displaced back to Pending so a cohort member could "
    "take its nominal quota back", ["queue"])
queue_admission_wait_seconds = REGISTRY.histogram(
    "tpu_operator_queue_admission_wait_seconds",
    "Pending to quota-admitted wait of gang SliceGroups, per tenant "
    "queue", ["queue"],
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
             300.0, 600.0, 1800.0))
checkpoint_save_seconds = REGISTRY.histogram(
    "tpu_operator_checkpoint_save_seconds",
    "Wall time of one replica checkpoint save, as reported through "
    "CheckpointRecords (periodic saves and barrier-forced saves alike)",
    ["job_namespace"],
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0))
checkpoint_barrier_acks = REGISTRY.counter(
    "tpu_operator_checkpoint_barrier_acks_total",
    "Per-replica save acks received inside save-before-evict barriers",
    ["job_namespace"])
checkpoint_barriers = REGISTRY.counter(
    "tpu_operator_checkpoint_barriers_total",
    "Save-before-evict barriers completed, by outcome (acked = every "
    "required replica saved; timeout = evicted at the deadline)",
    ["job_namespace", "outcome"])
steps_lost_per_disruption = REGISTRY.histogram(
    "tpu_operator_steps_lost_per_disruption",
    "Training steps lost to one planned disruption: last reported "
    "progress minus the step the barrier committed",
    ["job_namespace"],
    buckets=(0.0, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0))
job_goodput_ratio = REGISTRY.gauge(
    "tpu_operator_job_goodput_ratio",
    "Fraction of a job's training steps NOT lost to disruptions: "
    "(progress - cumulative steps lost) / progress, 1.0 until the "
    "first loss", ["job_namespace", "job"])
learner_goodput_ratio = REGISTRY.gauge(
    "tpu_operator_learner_goodput_ratio",
    "job_goodput_ratio restricted to heterogeneous (RolePolicy) jobs: "
    "fraction of the LEARNER gang's steps not lost to disruptions. "
    "Actor-only churn must not move it — that invariant is the point "
    "of the actor/learner split (docs/rl.md)", ["job_namespace", "job"])
actor_pool_replicas = REGISTRY.gauge(
    "tpu_operator_actor_pool_replicas",
    "Current replica count of an elastic RolePolicy role (an RL actor "
    "pool), updated at every applied role resize (docs/rl.md)",
    ["job_namespace", "job", "replica_type"])
actor_preemptions = REGISTRY.counter(
    "tpu_operator_actor_preemptions_total",
    "Evict-class (non-barrier) replicas evicted without a "
    "save-before-evict barrier, by reason (health|chaos|manual): the "
    "disruptions the learner gang is supposed to ride out (docs/rl.md)",
    ["job_namespace", "reason"])
gang_resizes = REGISTRY.counter(
    "tpu_operator_gang_resizes_total",
    "Elastic gang resizes applied by the control plane, by direction "
    "(grow|shrink) and reason (idle|reclaim|drain|manual|chaos|"
    "autoscale)",
    ["direction", "reason"])
job_slices = REGISTRY.gauge(
    "tpu_operator_job_slices",
    "Current slice count of an elastic gang, updated at every applied "
    "resize (docs/elastic.md)", ["job_namespace", "job"])
resize_barrier_seconds = REGISTRY.histogram(
    "tpu_operator_resize_barrier_seconds",
    "Shrink decision to save-barrier release: how long an elastic "
    "shrink waited for the gang's final checkpoint acks before the "
    "smaller world was rendered", ["job_namespace"],
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0))
api_retries = REGISTRY.counter(
    "tpu_operator_api_retries_total",
    "In-place retries of transient API failures (runtime/retry.py "
    "with_retries backoff), by the retrying component", ["component"])
controlplane_degraded = REGISTRY.gauge(
    "tpu_operator_controlplane_degraded",
    "1 while the API server has been failing past the degraded-mode "
    "threshold: the controller keeps reconciling but defers new "
    "drains/reclaims/preemptions (docs/robustness.md)")
degraded_entries = REGISTRY.counter(
    "tpu_operator_controlplane_degraded_entries_total",
    "Times the controller entered degraded mode (API server "
    "unreachable past the threshold)")
disruptions_deferred = REGISTRY.counter(
    "tpu_operator_disruptions_deferred_total",
    "Disruptive actions (drain/reclaim/preemption) NOT initiated "
    "because the control plane was degraded", ["action"])
store_watch_handler_errors = REGISTRY.counter(
    "tpu_operator_store_watch_handler_errors_total",
    "Exceptions raised by store watch handlers (swallowed so the "
    "dispatcher survives; traceback logged once per handler)", ["kind"])
bind_failures = REGISTRY.counter(
    "tpu_operator_bind_failures_total",
    "pods/binding POSTs that failed and will retry next binder pass, "
    "by failure category", ["reason"])
chaos_faults_injected = REGISTRY.counter(
    "tpu_operator_chaos_faults_injected_total",
    "Faults the chaos layer injected (runtime/chaos.py FaultProfile; "
    "test/bench harnesses only — always 0 in production)", ["fault"])
node_agent_heartbeats = REGISTRY.counter(
    "tpu_operator_node_agent_heartbeats_total",
    "Heartbeats a node agent successfully published to the control "
    "plane (served: NodeStatus.last_heartbeat write; kube: "
    "agent-heartbeat annotation PATCH)", ["node"])
node_agent_relay_errors = REGISTRY.counter(
    "tpu_operator_node_agent_relay_errors_total",
    "Node-agent relay operations that failed after retries, by kind "
    "(notice_write = preemption notice file, ckpt_read = worker "
    "checkpoint state file, ckpt_patch = ckpt-state annotation PATCH)",
    ["kind"])
trace_spans_dropped = REGISTRY.counter(
    "tpu_operator_trace_spans_dropped_total",
    "Spans of completed traces the flight recorder did NOT retain "
    "(neither slowest-N, errored, nor the sample ring — "
    "docs/observability.md); phase totals still count them")

# --- sharded control plane (runtime/leaderelection.py ShardMap,
# runtime/store.py watch log / pagination; docs/benchmarks.md).
shard_owner = REGISTRY.gauge(
    "tpu_operator_shard_owner",
    "1 while this replica holds the lease for control-plane shard "
    "<shard> (tpu-operator-shard-<i>); 0 after a release or stepdown",
    ["shard"])
shard_reassignments = REGISTRY.counter(
    "tpu_operator_shard_reassignments_total",
    "Shard leases this replica took over from another holder (lease "
    "transitions observed at acquire time — failover adoptions, not "
    "first acquisitions)")
watch_cache_hits = REGISTRY.counter(
    "tpu_operator_watch_cache_hits_total",
    "Watch registrations resumed from the store's per-kind event log "
    "(resourceVersion known and still in the log) instead of a full "
    "ADDED replay of every stored object", ["kind"])
list_pages = REGISTRY.counter(
    "tpu_operator_list_pages_total",
    "Paginated list pages served from the store (continue-token keyset "
    "walks; each page returns frozen snapshots, no payload deepcopy)",
    ["kind"])

# --- serving plane (tf_operator_tpu_torch/serve; docs/serving.md SLO catalog).
# Observed by the ServingEngine in whichever process runs it: each
# serving replica exposes its own /metrics in production; benchmarks and
# in-process tests read the ambient registry directly.
serving_tokens_per_second = REGISTRY.gauge(
    "tpu_operator_serving_tokens_per_second",
    "Decode throughput of this serving replica over the last engine "
    "step window (generated tokens only; prompt tokens excluded)")
serving_ttft_seconds = REGISTRY.histogram(
    "tpu_operator_serving_ttft_seconds",
    "Time to first token: request enqueue to the prefill that emitted "
    "its first generated token (the serving SLO's head latency; p50/p99 "
    "via Histogram.quantile)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
serving_queue_depth = REGISTRY.gauge(
    "tpu_operator_serving_queue_depth",
    "Requests waiting in a tenant's QoS lane of the serving request "
    "queue (admitted-to-slot requests excluded)", ["tenant"])
serving_requests_total = REGISTRY.counter(
    "tpu_operator_serving_requests_total",
    "Serving requests by terminal outcome: completed (response "
    "emitted), rejected (queue full at submit), requeued (drained "
    "mid-flight back to the spool for another replica)", ["outcome"])
gateway_requests = REGISTRY.counter(
    "tpu_operator_gateway_requests_total",
    "HTTP requests the serving gateway answered, by status code (200 "
    "accepted+streamed, 400 malformed, 401 unknown auth token, 429 "
    "spool backlog at maxQueueDepth — carries Retry-After)", ["code"])
gateway_streaming_seconds = REGISTRY.histogram(
    "tpu_operator_gateway_streaming_seconds",
    "Accepted gateway request admission to last streamed token (the "
    "full-response latency the TTFT histogram is the head of)",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0))

# --- serving replica autoscaler (controller/autoscaler.py;
# docs/serving.md autoscaler section).
autoscaler_target_slices = REGISTRY.gauge(
    "tpu_operator_autoscaler_target_slices",
    "The autoscaler's most recent numSlices target for a serving gang "
    "(post-clamp to minSlices/maxSlices; compare with job_slices to "
    "see convergence)", ["job_namespace", "job"])
autoscaler_holds = REGISTRY.counter(
    "tpu_operator_autoscaler_holds_total",
    "Autoscaler passes that wanted a different size but held, by "
    "reason (cooldown = shrink hysteresis window still open; settling "
    "= a prior resize has not completed; bounds = target clamped back "
    "to the current size)", ["reason"])
