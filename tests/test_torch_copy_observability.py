"""Copy of ``tests/test_observability.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Metrics registry, exposition endpoint, structured logging, leader
election, and the CLI server assembly.

Reference behaviors covered: promauto counter catalog (docs/monitoring/
README.md), /metrics endpoint (main.go:39-50), logrus JSON + contextual
fields (util/logger.go), leaderelection.RunOrDie semantics
(app/server.go:146-193), signal/flag surface (options.go:53-83).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request

import pytest

from tf_operator_tpu_torch.api.types import TPUJob
from tf_operator_tpu_torch.runtime import metrics as m
from tf_operator_tpu_torch.runtime.leaderelection import LEASES, LeaderElector
from tf_operator_tpu_torch.runtime.logconfig import JSONFormatter, logger_for_job
from tf_operator_tpu_torch.runtime.metrics import Registry
from tf_operator_tpu_torch.runtime.monitoring import MonitoringServer
from tf_operator_tpu_torch.runtime.store import Store


# --- registry ------------------------------------------------------------

def test_counter_inc_and_labels():
    r = Registry()
    c = r.counter("test_total", "help", ["ns"])
    c.inc(ns="a")
    c.inc(2, ns="a")
    c.inc(ns="b")
    assert c.value(ns="a") == 3
    assert c.value(ns="b") == 1
    assert c.value(ns="missing") == 0


def test_counter_label_mismatch_raises():
    r = Registry()
    c = r.counter("test_total", "help", ["ns"])
    with pytest.raises(ValueError):
        c.inc(wrong="x")


def test_gauge_set_inc_dec():
    r = Registry()
    g = r.gauge("test_gauge", "help")
    g.set(5)
    g.inc()
    g.dec(2)
    assert g.value() == 4


def test_registry_reregistration_returns_same_metric():
    r = Registry()
    a = r.counter("dup_total", "help", ["ns"])
    b = r.counter("dup_total", "help", ["ns"])
    assert a is b


def test_render_text_prometheus_format():
    r = Registry()
    c = r.counter("jobs_total", "Jobs seen", ["job_namespace"])
    c.inc(job_namespace="default")
    g = r.gauge("leader", "Leader flag")
    g.set(1)
    text = r.render_text()
    assert "# HELP jobs_total Jobs seen" in text
    assert "# TYPE jobs_total counter" in text
    assert 'jobs_total{job_namespace="default"} 1' in text
    assert "# TYPE leader gauge" in text
    assert "leader 1" in text


def test_render_escapes_label_values():
    r = Registry()
    c = r.counter("esc_total", "h", ["v"])
    c.inc(v='a"b\nc')
    assert 'esc_total{v="a\\"b\\nc"} 1' in r.render_text()


def test_histogram_buckets_and_sum():
    r = Registry()
    h = r.histogram("lat", "h", buckets=(0.1, 1.0, 10.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(100.0)
    text = r.render_text()
    assert 'lat_bucket{le="0.1"} 1' in text
    assert 'lat_bucket{le="1"} 2' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text


def test_histogram_timer():
    r = Registry()
    h = r.histogram("dur", "h", buckets=(10.0,))
    with h.time():
        pass
    assert "dur_count 1" in r.render_text()


# --- Histogram.quantile (serving SLO artifacts read p50/p99 locally) ----

def test_quantile_empty_series_is_none():
    h = Registry().histogram("q", "h", buckets=(1.0, 2.0))
    assert h.quantile(0.5) is None


def test_quantile_uniform_distribution_interpolates():
    # 100 observations spread uniformly over (0, 10]: every decile of
    # the data lands in a known bucket, and linear interpolation inside
    # the bucket recovers the value to within one observation's width.
    h = Registry().histogram("q", "h",
                             buckets=(2.0, 4.0, 6.0, 8.0, 10.0))
    for i in range(100):
        h.observe((i + 1) * 0.1)  # 0.1 .. 10.0
    assert h.quantile(0.0) == pytest.approx(0.0, abs=0.11)
    assert h.quantile(0.5) == pytest.approx(5.0, abs=0.11)
    assert h.quantile(0.9) == pytest.approx(9.0, abs=0.11)
    assert h.quantile(1.0) == pytest.approx(10.0, abs=1e-9)


def test_quantile_known_two_bucket_split():
    # 3 obs <= 1.0, 1 obs in (1.0, 3.0]: p50 = rank 2 of 4 -> 2/3 into
    # the first bucket; p99 = rank 3.96 -> 0.96 into the second.
    h = Registry().histogram("q", "h", buckets=(1.0, 3.0))
    for v in (0.2, 0.4, 0.9, 2.0):
        h.observe(v)
    assert h.quantile(0.5) == pytest.approx(2 / 3)
    assert h.quantile(0.99) == pytest.approx(1.0 + 0.96 * 2.0)


def test_quantile_overflow_bucket_clamps_to_highest_bound():
    # Prometheus histogram_quantile convention: ranks in +Inf clamp to
    # the highest finite bound — the histogram cannot resolve beyond it.
    h = Registry().histogram("q", "h", buckets=(1.0, 5.0))
    h.observe(0.5)
    h.observe(100.0)
    h.observe(200.0)
    assert h.quantile(0.99) == 5.0
    assert h.quantile(0.2) == pytest.approx(0.6)


def test_quantile_labeled_series_are_independent():
    r = Registry()
    h = r.histogram("q", "h", ["t"], buckets=(1.0, 10.0))
    h.observe(0.5, t="a")
    h.observe(9.0, t="b")
    assert h.quantile(1.0, t="a") <= 1.0
    assert h.quantile(1.0, t="b") > 1.0
    with pytest.raises(ValueError):
        h.quantile(1.5, t="a")


# --- monitoring endpoint -------------------------------------------------

@pytest.fixture()
def server():
    r = Registry()
    r.counter("up_total", "h").inc()
    s = MonitoringServer(port=0, registry=r)
    s.start()
    yield s
    s.stop()


def _get(server, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=5) as resp:
        return resp.status, resp.read().decode()


def test_metrics_endpoint(server):
    status, body = _get(server, "/metrics")
    assert status == 200
    assert "up_total 1" in body


def test_healthz_and_version(server):
    assert _get(server, "/healthz")[0] == 200
    status, body = _get(server, "/version")
    assert status == 200
    assert "tpu-operator" in json.loads(body)["version"]


def test_debug_stacks(server):
    status, body = _get(server, "/debug/stacks")
    assert status == 200
    assert "thread" in body


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/nope")
    assert ei.value.code == 404


# --- flight-recorder endpoints (runtime/trace.py; docs/observability.md) --

@pytest.fixture()
def trace_state():
    from tf_operator_tpu_torch.runtime import trace

    trace.reset_for_tests()
    yield trace
    trace.reset_for_tests()


def _get_raw(server, path):
    req = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}{path}", timeout=5)
    with req as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            resp.read().decode()


def test_debug_traces_empty_recorder_shape(server, trace_state):
    """Tracing off: /debug/traces stays served — enabled false, no
    traces, zero seen — with a JSON content type."""
    status, ctype, body = _get_raw(server, "/debug/traces")
    assert status == 200
    assert ctype == "application/json"
    payload = json.loads(body)
    assert payload["enabled"] is False
    assert payload["traces"] == []
    assert payload["traces_seen"] == 0
    assert payload["retained"] == {"slowest": 0, "errored": 0,
                                   "sampled": 0}
    assert payload["phase_totals_s"] == {}


def test_debug_traces_serves_slow_sync_retention(server, trace_state):
    """A deliberately slow sync is retained by the slowest-N policy and
    visible over HTTP with its child spans."""
    import time as _time

    trace_state.configure(True)
    with trace_state.span("sync", job="default/slow"):
        with trace_state.span("pods.list"):
            _time.sleep(0.02)
    for _ in range(5):
        with trace_state.span("sync", job="default/fast"):
            pass
    _, _, body = _get_raw(server, "/debug/traces")
    payload = json.loads(body)
    assert payload["enabled"] is True
    assert payload["traces_seen"] == 6
    slowest = payload["traces"][0]
    assert slowest["spans"][-1]["attrs"]["job"] == "default/slow"
    assert {s["name"] for s in slowest["spans"]} == {"sync", "pods.list"}
    assert slowest["duration_ms"] >= 20


def test_debug_jobs_unknown_job_404s(server, trace_state):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/debug/jobs/default/ghost")
    assert ei.value.code == 404
    assert "decision journal" in json.loads(ei.value.read().decode())[
        "error"]
    # Malformed paths 404 too (no namespace/name split).
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/debug/jobs/onlyns")
    assert ei.value.code == 404


def test_debug_jobs_serves_decision_journal_shape(server, trace_state):
    trace_state.JOURNAL.record("default", "j1", "admission.defer",
                               "capacity", "needs 8 chips; 4/4 in use")
    trace_state.JOURNAL.record("default", "j1", "admission.admit",
                               "admitted", "8 chips")
    status, ctype, body = _get_raw(server, "/debug/jobs/default/j1")
    assert status == 200
    assert ctype == "application/json"
    payload = json.loads(body)
    assert payload["namespace"] == "default"
    assert payload["name"] == "j1"
    assert [d["kind"] for d in payload["decisions"]] == [
        "admission.defer", "admission.admit"]
    for d in payload["decisions"]:
        assert {"seq", "time", "last_time", "kind", "reason", "message",
                "trace_id", "span", "count"} <= set(d)


def test_tracing_off_is_shared_noop_and_records_nothing(trace_state):
    """The zero-overhead contract: disabled, span() allocates nothing
    (it returns the one shared no-op object) and a full sync leaves the
    recorder untouched."""
    from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
    from tf_operator_tpu_torch.runtime import store as store_mod
    from tf_operator_tpu_torch.testutil import new_tpujob

    assert trace_state.span("sync") is trace_state.span("pods.list") \
        is trace_state.NOOP_SPAN
    store = Store()
    controller = GPUJobController(store)
    job = new_tpujob(worker=1, name="untraced")
    store.create(store_mod.TPUJOBS, job)
    controller.sync_tpujob("default/untraced")
    assert trace_state.RECORDER.snapshot()["traces_seen"] == 0
    assert trace_state.RECORDER.phase_totals() == {}
    store.stop_watchers()


# --- metric cardinality: job-labeled series pruned by job GC --------------

def test_metric_remove_drops_child_series():
    r = Registry()
    g = r.gauge("job_gauge", "h", ["job_namespace", "job"])
    g.set(0.5, job_namespace="ns", job="a")
    g.set(0.9, job_namespace="ns", job="b")
    g.remove(job_namespace="ns", job="a")
    g.remove(job_namespace="ns", job="never-existed")  # no-op
    text = r.render_text()
    assert 'job="a"' not in text
    assert 'job="b"' in text
    h = r.histogram("job_hist", "h", ["job"], buckets=(1.0,))
    h.observe(0.5, job="a")
    h.remove(job="a")
    assert 'job="a"' not in r.render_text()


def test_job_gc_prunes_job_labeled_series_and_journal(trace_state):
    """Create -> delete a job through the controller's watch path; its
    goodput/slices series must leave render_text() and its decision
    journal must forget it (unbounded cardinality fix)."""
    import time as _time

    from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
    from tf_operator_tpu_torch.runtime import metrics as mx
    from tf_operator_tpu_torch.runtime import store as store_mod
    from tf_operator_tpu_torch.runtime.metrics import REGISTRY
    from tf_operator_tpu_torch.testutil import new_tpujob

    store = Store()
    controller = GPUJobController(store)
    controller.start_watching()
    try:
        job = new_tpujob(worker=1, name="gc-job")
        store.create(store_mod.TPUJOBS, job)
        mx.job_goodput_ratio.set(0.75, job_namespace="default",
                                 job="gc-job")
        mx.job_slices.set(2, job_namespace="default", job="gc-job")
        trace_state.JOURNAL.record("default", "gc-job",
                                   "admission.admit", "admitted", "m")
        assert 'job="gc-job"' in REGISTRY.render_text()
        store.delete(store_mod.TPUJOBS, "default", "gc-job")
        deadline = _time.monotonic() + 5
        while _time.monotonic() < deadline:
            if ('job="gc-job"' not in REGISTRY.render_text()
                    and trace_state.JOURNAL.decisions(
                        "default", "gc-job") is None):
                break
            _time.sleep(0.01)
        assert 'job="gc-job"' not in REGISTRY.render_text()
        assert trace_state.JOURNAL.decisions("default", "gc-job") is None
    finally:
        controller.stop()
        store.stop_watchers()


# --- structured logging --------------------------------------------------

def test_json_formatter_fields():
    rec = logging.LogRecord("tpu_operator.test", logging.INFO, "f.py", 10,
                            "hello %s", ("world",), None)
    out = json.loads(JSONFormatter().format(rec))
    assert out["msg"] == "hello world"
    assert out["level"] == "info"
    assert out["filename"].startswith("f.py:")


def test_logger_for_job_attaches_context(caplog):
    job = TPUJob()
    job.metadata.name = "j1"
    job.metadata.namespace = "ns1"
    job.metadata.uid = "u-1"
    base = logging.getLogger("tpu_operator.testctx")
    adapter = logger_for_job(base, job, rtype="worker", index=3)
    with caplog.at_level(logging.INFO, logger="tpu_operator.testctx"):
        adapter.info("msg")
    rec = caplog.records[-1]
    out = json.loads(JSONFormatter().format(rec))
    assert out["job"] == "ns1.j1"
    assert out["replica_type"] == "worker"
    assert out["replica_index"] == 3


# --- leader election -----------------------------------------------------

def _elector(store, ident, **kw):
    kw.setdefault("lease_duration", 0.5)
    kw.setdefault("renew_deadline", 0.2)
    kw.setdefault("retry_period", 0.05)
    return LeaderElector(store, identity=ident, **kw)


def test_single_elector_acquires():
    store = Store()
    e = _elector(store, "a")
    e.start()
    assert e.wait_until_leading(timeout=5)
    assert m.is_leader.value() == 1
    e.stop()
    assert m.is_leader.value() == 0


def test_second_elector_blocked_until_release():
    store = Store()
    a = _elector(store, "a")
    a.start()
    assert a.wait_until_leading(timeout=5)
    b = _elector(store, "b")
    b.start()
    assert not b.wait_until_leading(timeout=0.3)
    a.stop()  # releases the lease
    assert b.wait_until_leading(timeout=5)
    b.stop()


def test_takeover_after_holder_expires():
    store = Store()
    a = _elector(store, "a")
    a.start()
    assert a.wait_until_leading(timeout=5)
    # Simulate a crashed holder: kill the thread without release.
    a._stop.set()
    a._thread.join(timeout=2)
    b = _elector(store, "b")
    b.start()
    assert b.wait_until_leading(timeout=5)  # takes over after expiry
    lease = store.get(LEASES, "default", "tpu-operator")
    assert lease.spec.holder_identity == "b"
    assert lease.spec.lease_transitions >= 1
    b.stop()


def test_on_started_leading_callback():
    store = Store()
    started = threading.Event()
    e = _elector(store, "a", on_started_leading=started.set)
    e.start()
    assert started.wait(timeout=5)
    e.stop()


def test_lost_lease_fires_on_stopped_leading():
    store = Store()
    stopped = threading.Event()
    a = _elector(store, "a", on_stopped_leading=stopped.set)
    a.start()
    assert a.wait_until_leading(timeout=5)
    # Usurp the lease out from under the holder.
    lease = store.get(LEASES, "default", "tpu-operator")
    lease.spec.holder_identity = "usurper"
    import datetime as dt
    lease.spec.renew_time = (dt.datetime.now(dt.timezone.utc)
                             + dt.timedelta(seconds=60))
    store.update(LEASES, lease)
    assert stopped.wait(timeout=5)
    a._stop.set()


# --- CLI server assembly -------------------------------------------------

def test_cli_version(capsys):
    from tf_operator_tpu_torch.cli import main
    assert main(["--version"]) == 0
    assert "tpu-operator" in capsys.readouterr().out


def test_cli_server_end_to_end(tmp_path):
    """Full process assembly: leader election -> controller -> a job runs
    to completion; metrics visible over HTTP."""
    import sys

    from tf_operator_tpu_torch.cli import Server, build_parser
    from tf_operator_tpu_torch.sdk.client import TPUJobClient
    from tf_operator_tpu_torch.testutil import new_tpujob

    args = build_parser().parse_args(
        ["--monitoring-port", "-1", "--threadiness", "1",
         "--resync-period", "0.2"])
    server = Server(args)
    try:
        server.start()
        assert server.elector is not None
        assert server.elector.wait_until_leading(timeout=10)

        client = TPUJobClient(server.store)
        job = new_tpujob(worker=1, name="cli-e2e",
                         command=[sys.executable, "-c", "pass"])
        client.create(job)
        client.wait_for_job("cli-e2e", timeout=30)

        status, body = _get(server.monitoring, "/metrics")
        assert status == 200
        assert 'tpu_operator_jobs_successful_total{job_namespace="default"}' \
            in body
        assert "tpu_operator_is_leader 1" in body
    finally:
        server.shutdown()


def test_event_store_mirror_capped():
    """Persisted events are labeled with their job name and the
    collection is pruned once it exceeds the cap (no unbounded growth
    on a long-running operator)."""
    from tf_operator_tpu_torch import operator as op_mod
    from tf_operator_tpu_torch.api import constants
    from tf_operator_tpu_torch.api.types import ObjectMeta, Pod
    from tf_operator_tpu_torch.operator import Operator
    from tf_operator_tpu_torch.runtime import store as store_mod

    op = Operator(backend=None)
    pod = Pod(metadata=ObjectMeta(
        name="capjob-worker-0",
        labels={constants.LABEL_JOB_NAME: "capjob"}))
    for _ in range(op_mod.MAX_STORED_EVENTS + 10):
        op.recorder.event(pod, "Normal", "Probe", "x")
    count = op.store.count(store_mod.EVENTS)
    assert count <= op_mod.MAX_STORED_EVENTS, count
    ev = op.store.list(store_mod.EVENTS)[0]
    assert ev.metadata.labels[constants.LABEL_JOB_NAME] == "capjob"

# --- event aggregation (EventCorrelator analog, ISSUE 2) -----------------

def _named(name="storm-job", ns="default"):
    from tf_operator_tpu_torch.api.types import ObjectMeta, TPUJob

    return TPUJob(metadata=ObjectMeta(name=name, namespace=ns))


def test_exact_duplicate_events_fold_into_count():
    from tf_operator_tpu_torch.runtime.events import Recorder

    sunk = []
    r = Recorder(sink=sunk.append)
    for _ in range(5):
        r.event(_named(), "Warning", "AbnormalPod", "same message")
    evs = r.events_for(reason="AbnormalPod")
    assert len(evs) == 1
    assert evs[0].count == 5
    assert len(sunk) == 1, "duplicates must not re-fan-out to the sink"


def test_similar_event_storm_collapses_past_threshold():
    """>threshold distinct-message events with the same (object, type,
    reason) collapse into one combined record — a 256-pod gang start is
    ~11 sink calls, not 256 API writes."""
    from tf_operator_tpu_torch.runtime.events import (
        SIMILAR_EVENTS_THRESHOLD,
        Recorder,
    )

    sunk = []
    r = Recorder(sink=sunk.append)
    for i in range(256):
        r.event(_named(), "Normal", "SuccessfulCreatePod",
                f"Created pod: w-{i}")
    evs = r.events_for(reason="SuccessfulCreatePod")
    assert len(evs) == SIMILAR_EVENTS_THRESHOLD + 1
    assert len(sunk) == SIMILAR_EVENTS_THRESHOLD
    combined = [e for e in evs
                if e.message.startswith("(combined from similar events)")]
    assert len(combined) == 1
    assert combined[0].count == 256


def test_distinct_reasons_do_not_aggregate():
    from tf_operator_tpu_torch.runtime.events import Recorder

    r = Recorder()
    r.event(_named(), "Normal", "ReasonA", "m")
    r.event(_named(), "Normal", "ReasonB", "m")
    assert len(r.events) == 2


def test_aggregated_events_counted_in_metric():
    from tf_operator_tpu_torch.runtime import metrics as mx
    from tf_operator_tpu_torch.runtime.events import Recorder

    before = mx.events_aggregated.value()
    r = Recorder()
    for _ in range(4):
        r.event(_named("metric-job"), "Normal", "Dup", "m")
    assert mx.events_aggregated.value() == before + 3


# --- workqueue instrumentation (gauge owned by the queue, ISSUE 2) --------

def test_workqueue_owns_depth_gauge_and_counts_coalesced():
    from tf_operator_tpu_torch.runtime import metrics as mx
    from tf_operator_tpu_torch.runtime.workqueue import RateLimitingQueue

    q = RateLimitingQueue()
    coalesced_before = mx.workqueue_coalesced.value()
    q.add("k1")
    q.add("k2")
    assert mx.workqueue_depth.value() == 2
    q.add("k1")  # already pending: coalesced, depth unchanged
    assert mx.workqueue_depth.value() == 2
    assert mx.workqueue_coalesced.value() == coalesced_before + 1
    assert q.get(timeout=1) == "k1"
    assert mx.workqueue_depth.value() == 1
    q.done("k1")
    q.shutdown()


def test_workqueue_latency_histogram_observes_wait():
    import time as _time

    from tf_operator_tpu_torch.runtime import metrics as mx
    from tf_operator_tpu_torch.runtime.workqueue import RateLimitingQueue

    count_before = sum(mx.workqueue_latency_seconds._totals.values())
    q = RateLimitingQueue()
    q.add("k")
    _time.sleep(0.01)
    q.get(timeout=1)
    q.done("k")
    q.shutdown()
    assert sum(mx.workqueue_latency_seconds._totals.values()) \
        == count_before + 1


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
