"""Copy of ``tests/test_trace.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Flight recorder (runtime/trace.py): span API, retention policy,
decision journal, retry-span integration, and the end-to-end decision
arc reconstructed from /debug/jobs/<ns>/<name>.

docs/observability.md is the behavior contract these tests pin.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request

import pytest

from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import trace


@pytest.fixture(autouse=True)
def _clean_trace_state():
    trace.reset_for_tests()
    yield
    trace.reset_for_tests()


def _enable():
    trace.configure(True)


# --- span API -------------------------------------------------------------


def test_disabled_span_is_shared_noop():
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b") is trace.NOOP_SPAN
    # The noop supports the full span surface.
    with trace.span("x") as s:
        assert s.set(attempts=3) is s
    assert trace.RECORDER.snapshot()["traces_seen"] == 0


def test_nested_spans_share_trace_and_chain_parent_ids():
    _enable()
    with trace.span("sync", job="ns/j") as root:
        tid = trace.current_ids()[0]
        with trace.span("pods.list") as child:
            assert trace.current_ids() == (tid, "pods.list")
            assert child.buf is root.buf
    snap = trace.RECORDER.snapshot()
    assert snap["traces_seen"] == 1
    (t,) = snap["traces"]
    assert t["trace_id"] == tid
    assert t["root"] == "sync"
    by_name = {s["name"]: s for s in t["spans"]}
    assert by_name["pods.list"]["parent_id"] == by_name["sync"]["span_id"]
    assert by_name["sync"]["parent_id"] == ""
    assert by_name["sync"]["attrs"] == {"job": "ns/j"}


def test_trace_ids_are_deterministic_and_ordered():
    _enable()
    with trace.span("a"):
        first = trace.current_ids()[0]
    with trace.span("b"):
        second = trace.current_ids()[0]
    assert first != second
    assert sorted([first, second]) == [first, second]  # creation order


def test_exception_marks_span_and_trace_errored():
    _enable()
    with pytest.raises(ValueError):
        with trace.span("sync"):
            raise ValueError("boom")
    snap = trace.RECORDER.snapshot()
    (t,) = snap["traces"]
    assert t["errored"]
    assert "ValueError: boom" in t["spans"][-1]["error"]
    assert snap["retained"]["errored"] == 1


def test_current_ids_empty_outside_spans():
    _enable()
    assert trace.current_ids() == ("", "")


# --- recorder retention ---------------------------------------------------


def _run_trace(name: str, seconds: float = 0.0) -> None:
    with trace.span(name):
        if seconds:
            time.sleep(seconds)


def test_recorder_keeps_slowest_errored_and_sample():
    rec = trace.FlightRecorder(keep_slowest=2, keep_errored=4,
                               sample_every=3, ring=8)
    tracer = trace.Tracer(rec)
    tracer.enabled = True
    dropped_before = metrics.trace_spans_dropped.value()
    # Two slow traces fill the slowest heap; the rest sample 1-in-3.
    for i in range(12):
        with tracer.span("sync", i=i):
            if i in (3, 7):
                time.sleep(0.03)
    snap = rec.snapshot()
    assert snap["traces_seen"] == 12
    slow = snap["traces"][:2]
    assert {s["spans"][0]["attrs"]["i"] for s in slow} == {3, 7}
    assert snap["retained"]["slowest"] == 2
    assert snap["retained"]["sampled"] >= 2
    # Everything not retained was counted as dropped.
    assert metrics.trace_spans_dropped.value() > dropped_before


def test_recorder_phase_totals_accumulate_spans_and_noted_phases():
    rec = trace.FlightRecorder()
    tracer = trace.Tracer(rec)
    tracer.enabled = True
    with tracer.span("sync"):
        with tracer.span("pods.list"):
            pass
    rec.note_phase("queue_wait", 1.5)
    rec.note_phase("queue_wait", 0.5)
    totals = rec.phase_totals()
    assert totals["queue_wait"] == 2.0
    assert totals["sync"] >= totals["pods.list"] >= 0.0


def test_trace_file_streams_every_trace_as_jsonl(tmp_path):
    path = tmp_path / "traces.jsonl"
    trace.configure(True, trace_file=str(path))
    _run_trace("sync")
    _run_trace("binder.pass")
    trace.configure(False)
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2
    roots = [json.loads(ln)["root"] for ln in lines]
    assert roots == ["sync", "binder.pass"]
    for ln in lines:
        t = json.loads(ln)
        assert {"trace_id", "duration_ms", "spans", "errored"} <= set(t)


# --- decision journal -----------------------------------------------------


def test_journal_coalesces_consecutive_identical_decisions():
    j = trace.DecisionJournal()
    for i in range(5):
        j.record("ns", "job", "admission.defer", "capacity",
                 f"needs 4 chips; pass {i}")
    j.record("ns", "job", "admission.admit", "admitted", "4 chips")
    records = j.decisions("ns", "job")
    assert [r["kind"] for r in records] == ["admission.defer",
                                           "admission.admit"]
    assert records[0]["count"] == 5
    assert records[0]["message"] == "needs 4 chips; pass 4"  # freshest
    assert records[0]["last_time"] >= records[0]["time"]


def test_journal_alternating_decisions_do_not_coalesce():
    j = trace.DecisionJournal()
    j.record("ns", "job", "admission.defer", "capacity", "m")
    j.record("ns", "job", "admission.admit", "admitted", "m")
    j.record("ns", "job", "admission.defer", "capacity", "m")
    assert len(j.decisions("ns", "job")) == 3


def test_journal_bounds_per_job_and_total_jobs():
    j = trace.DecisionJournal(per_job=4, max_jobs=2)
    for i in range(10):
        j.record("ns", "a", "k", f"r{i}", "m")  # distinct reasons: no fold
    assert len(j.decisions("ns", "a")) == 4
    j.record("ns", "b", "k", "r", "m")
    j.record("ns", "c", "k", "r", "m")  # evicts LRU job "a"
    assert j.decisions("ns", "a") is None
    assert j.decisions("ns", "b") is not None


def test_journal_unknown_job_is_none_and_prune_forgets():
    j = trace.DecisionJournal()
    assert j.decisions("ns", "ghost") is None
    j.record("ns", "job", "k", "r", "m")
    j.prune("ns", "job")
    assert j.decisions("ns", "job") is None


def test_journal_records_carry_ambient_trace_id():
    _enable()
    with trace.span("gang.admit_pass"):
        tid = trace.current_ids()[0]
        trace.JOURNAL.record("ns", "job", "admission.admit", "admitted",
                             "4 chips")
    (rec,) = trace.JOURNAL.decisions("ns", "job")
    assert rec["trace_id"] == tid
    assert rec["span"] == "gang.admit_pass"


# --- retry integration ----------------------------------------------------


def test_with_retries_emits_span_with_attempt_count():
    from tf_operator_tpu_torch.runtime import retry as retry_mod

    _enable()
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise retry_mod.TransientAPIError("blip")
        return "ok"

    assert retry_mod.with_retries(
        flaky, component="test.write", sleep=lambda s: None) == "ok"
    snap = trace.RECORDER.snapshot()
    (t,) = snap["traces"]
    (span,) = t["spans"]
    assert span["name"] == "retry.test.write"
    assert span["attrs"]["attempts"] == 3
    # The backoff sleeps were attributed to the api_retry phase.
    assert trace.RECORDER.phase_totals()["api_retry"] > 0


def test_workqueue_wait_lands_in_queue_wait_phase():
    from tf_operator_tpu_torch.runtime.workqueue import RateLimitingQueue

    _enable()
    q = RateLimitingQueue()
    q.add("k")
    time.sleep(0.01)
    q.get(timeout=1)
    q.done("k")
    q.shutdown()
    assert trace.RECORDER.phase_totals()["queue_wait"] > 0


# --- the acceptance arc ---------------------------------------------------


def _get_json(port: int, path: str):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_decision_arc_queued_admitted_drained_resized_from_endpoint():
    """The ISSUE-9 acceptance arc: one job goes queued -> admitted ->
    drained -> resized, and that exact decision sequence — with reasons
    and trace ids — is reconstructed from /debug/jobs/<ns>/<name>, not
    from logs."""
    from tf_operator_tpu_torch.controller.engine import EngineConfig
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_RUNNING,
        SliceGangScheduler,
    )
    from tf_operator_tpu_torch.runtime import store as store_mod
    from tf_operator_tpu_torch.runtime.monitoring import MonitoringServer
    from tf_operator_tpu_torch.runtime.store import Store
    from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
    from tf_operator_tpu_torch.testutil import new_tpujob

    _enable()
    store = Store()
    gang = SliceGangScheduler(store, total_chips=4, elastic=True)
    controller = GPUJobController(
        store, config=EngineConfig(enable_gang_scheduling=True),
        gang=gang)
    server = MonitoringServer(port=0)
    server.start()
    try:
        # arc-a occupies the whole 4-chip budget.
        a = new_tpujob(worker=1, name="arc-a")
        a.spec.slice.accelerator = "h100-4"
        store.create(store_mod.TPUJOBS, a)
        controller.sync_tpujob("default/arc-a")

        # arc-b: elastic, blocked behind arc-a -> admission.defer.
        b = new_tpujob(worker=1, name="arc-b")
        b.spec.slice.accelerator = "h100-4"
        b.spec.slice.min_slices = 1
        b.spec.slice.max_slices = 2
        store.create(store_mod.TPUJOBS, b)
        controller.sync_tpujob("default/arc-b")

        # arc-a deleted -> freed chips admit arc-b.
        store.delete(store_mod.TPUJOBS, "default", "arc-a")
        controller.sync_tpujob("default/arc-a")

        # Maintenance drain: displaced, then re-admitted (chips free).
        assert gang.displace("default", "arc-b",
                             "node degraded (maintenance)")

        # Idle capacity appears; the gang is Running -> grow to 2.
        group = store.get(store_mod.SLICEGROUPS, "default", "arc-b")
        group.status.phase = PHASE_RUNNING
        group.status.displaced_reason = ""
        store.update_status(store_mod.SLICEGROUPS, group)
        gang.total_chips = 8
        gang.readmit()

        status, payload = _get_json(server.port,
                                    "/debug/jobs/default/arc-b")
        assert status == 200
        assert payload["namespace"] == "default"
        assert payload["name"] == "arc-b"
        kinds = [(d["kind"], d["reason"])
                 for d in payload["decisions"]]
        assert kinds == [
            ("admission.defer", "capacity"),
            ("admission.admit", "admitted"),
            ("displaced", "drain"),
            ("admission.admit", "admitted"),
            ("resized", "idle"),
        ], kinds
        for d in payload["decisions"]:
            assert d["trace_id"], d  # every decision links to a trace
            assert d["message"]
        # The resize decision's trace is reconstructable at
        # /debug/traces (slowest-N retention holds everything at this
        # tiny scale).
        status, traces = _get_json(server.port, "/debug/traces")
        assert status == 200 and traces["enabled"]
        retained_ids = {t["trace_id"] for t in traces["traces"]}
        assert payload["decisions"][-1]["trace_id"] in retained_ids
        # ...and the journal names the new world.
        assert payload["decisions"][-1]["attrs"]["slices"] == 2
    finally:
        server.stop()
        store.stop_watchers()


def test_sdk_explain_renders_journal(caplog):
    from tf_operator_tpu_torch.runtime import store as store_mod
    from tf_operator_tpu_torch.runtime.store import Store
    from tf_operator_tpu_torch.sdk.client import TPUJobClient
    from tf_operator_tpu_torch.testutil import new_tpujob

    store = Store()
    client = TPUJobClient(store)
    job = new_tpujob(worker=1, name="exp")
    store.create(store_mod.TPUJOBS, job)
    trace.JOURNAL.record("default", "exp", "admission.defer", "capacity",
                         "needs 8 chips; 4/4 in use")
    info = client.explain("exp")
    assert info["name"] == "exp"
    assert info["decisions"][0]["reason"] == "capacity"
    text = client.explain_text("exp")
    assert "admission.defer/capacity" in text
    assert "needs 8 chips" in text
    store.stop_watchers()


def test_json_log_lines_carry_trace_ids_matching_recorded_trace():
    """Satellite: logs emitted inside a traced sync cross-reference the
    recorded trace — same trace_id in the JSONFormatter output and in
    the flight recorder."""
    from tf_operator_tpu_torch.runtime.logconfig import JSONFormatter

    _enable()
    logger = logging.getLogger("tpu_operator.test_trace_corr")
    captured = []

    class _Capture(logging.Handler):
        def emit(self, record):
            captured.append(self.format(record))

    handler = _Capture()
    handler.setFormatter(JSONFormatter())
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with trace.span("sync", job="default/corr"):
            tid = trace.current_ids()[0]
            with trace.span("pods.list"):
                logger.info("listing pods")
    finally:
        logger.removeHandler(handler)
    out = json.loads(captured[0])
    assert out["trace_id"] == tid
    assert out["span"] == "pods.list"
    recorded = {t["trace_id"]
                for t in trace.RECORDER.snapshot()["traces"]}
    assert tid in recorded


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
