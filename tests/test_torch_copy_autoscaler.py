"""Copy of ``tests/test_autoscaler.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Serving autoscaler: queue depth + TTFT burn -> numSlices through the
real elastic resize pass (controller/autoscaler.py; docs/serving.md).

Pins the policy (setpoint, band clamp, TTFT-burn grow), the hysteresis
contract (scale-up immediate, scale-down only after continuous
under-demand for the cooldown — a square wave produces at most one
resize per direction per period), every hold reason, and the decision
journal arc served at /debug/jobs/<ns>/<name>.
"""

import json
import urllib.request

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import set_defaults
from tf_operator_tpu_torch.api.types import (
    ServingPolicy,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.controller.autoscaler import (
    HOLD_BOUNDS,
    HOLD_COOLDOWN,
    HOLD_SETTLING,
    SIGNAL_QUEUE_DEPTH,
    SIGNAL_TTFT_P99,
    ServingAutoscaler,
    spool_pending_depth,
)
from tf_operator_tpu_torch.controller.gang import (
    PHASE_RUNNING,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.store import Store

NS = "default"


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_serving_job(store, name, num_slices=1, min_slices=1,
                     max_slices=3, target=4, cooldown=60.0, slo=None,
                     spool=None):
    job = testutil.new_tpujob(worker=num_slices, name=name, namespace=NS)
    job.spec.slice = TPUSliceSpec(accelerator="h100-4",
                                  num_slices=num_slices,
                                  min_slices=min_slices,
                                  max_slices=max_slices)
    job.spec.run_policy.serving_policy = ServingPolicy(
        enabled=True, spool_directory=spool or f"/tmp/spool-{name}",
        target_queue_depth_per_slice=target,
        scale_down_cooldown_seconds=cooldown,
        ttft_p99_slo_seconds=slo)
    set_defaults(job)
    store.create(store_mod.TPUJOBS, job)
    return job


def make_group(store, name, num_slices=1, min_slices=1, max_slices=3):
    import datetime as dt

    from tf_operator_tpu_torch.api import constants

    group = SliceGroup(
        spec=SliceGroupSpec(
            min_member=num_slices,
            slice=TPUSliceSpec(accelerator="h100-4",
                               num_slices=num_slices,
                               min_slices=min_slices,
                               max_slices=max_slices)),
        status=SliceGroupStatus(
            phase=PHASE_RUNNING,
            pending_since=dt.datetime.now(dt.timezone.utc)))
    group.metadata.name = name
    group.metadata.namespace = NS
    group.metadata.labels = {constants.LABEL_JOB_NAME: name}
    store.create(store_mod.SLICEGROUPS, group)
    return group


def harness(name, signals, clock=None, **job_kw):
    """Store + elastic gang + autoscaler around one serving job; the
    autoscaler is ALSO the gang's resize-signal provider, mirroring the
    operator wiring."""
    store = Store()
    make_serving_job(store, name, **job_kw)
    make_group(store, name,
               num_slices=job_kw.get("num_slices", 1),
               min_slices=job_kw.get("min_slices", 1),
               max_slices=job_kw.get("max_slices", 3))
    autoscaler = ServingAutoscaler(store, None, namespace=NS,
                                   signals=signals,
                                   clock=clock or FakeClock())
    gang = SliceGangScheduler(store, elastic=True,
                              resize_signals=autoscaler.signals)
    autoscaler.gang = gang
    return store, gang, autoscaler


def slices_of(store, name):
    return store.get(store_mod.TPUJOBS, NS, name).spec.slice.num_slices


def settle(store, name):
    """Clear the resizing marker like the engine finishing the world
    restart."""
    def clear(group):
        group.status.resizing_reason = ""

    from tf_operator_tpu_torch.runtime import retry as retry_mod

    retry_mod.update_with_conflict_retry(
        store, store_mod.SLICEGROUPS, NS, name, clear, status=True,
        component="test")


def journal_kinds(name):
    recs = trace_mod.JOURNAL.decisions(NS, name) or []
    return [(r["kind"], r["reason"]) for r in recs]


class TestPolicy:
    def test_no_setpoint_means_ignored(self):
        store, gang, asc = harness("as-ignored", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 100.0}, target=None)
        asc.evaluate_once()
        assert slices_of(store, "as-ignored") == 1
        assert trace_mod.JOURNAL.decisions(NS, "as-ignored") is None

    def test_grow_on_queue_depth_rides_resize_pass(self):
        grow0 = metrics.gang_resizes.value(direction="grow",
                                           reason="autoscale")
        store, gang, asc = harness("as-grow", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 12.0})  # ceil(12/4) = 3
        asc.evaluate_once()
        assert slices_of(store, "as-grow") == 3
        assert metrics.gang_resizes.value(
            direction="grow", reason="autoscale") == grow0 + 1
        assert metrics.autoscaler_target_slices.value(
            job_namespace=NS, job="as-grow") == 3
        kinds = journal_kinds("as-grow")
        assert ("autoscale.up", "queue-depth") in kinds
        assert ("resized", "autoscale") in kinds

    def test_resize_record_carries_the_signals_it_saw(self):
        store, gang, asc = harness("as-signals", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 12.0})
        asc.evaluate_once()
        recs = trace_mod.JOURNAL.decisions(NS, "as-signals")
        resized = [r for r in recs if r["kind"] == "resized"]
        assert "serving_queue_depth=12" in resized[0]["message"]

    def test_bounds_hold_when_clamped(self):
        holds0 = metrics.autoscaler_holds.value(reason=HOLD_BOUNDS)
        store, gang, asc = harness("as-bounds", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 999.0}, num_slices=3)  # already at max
        asc.evaluate_once()
        assert slices_of(store, "as-bounds") == 3
        assert metrics.autoscaler_holds.value(
            reason=HOLD_BOUNDS) == holds0 + 1
        assert ("autoscale.hold", HOLD_BOUNDS) in journal_kinds(
            "as-bounds")

    def test_ttft_burn_forces_one_slice(self):
        """p99 over the SLO with no backlog growth: latency can burn
        while depth looks fine (slots saturated by long generations)."""
        store, gang, asc = harness("as-ttft", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 0.0, SIGNAL_TTFT_P99: 2.0},
            num_slices=2, slo=0.5)
        asc.evaluate_once()
        assert slices_of(store, "as-ttft") == 3
        assert ("autoscale.up", "ttft-slo") in journal_kinds("as-ttft")

    def test_settling_hold_while_resize_in_flight(self):
        holds0 = metrics.autoscaler_holds.value(reason=HOLD_SETTLING)
        store, gang, asc = harness("as-settling", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 12.0})
        asc.evaluate_once()  # grow lands, resizing_reason set
        assert slices_of(store, "as-settling") == 3

        def more(ns, n):
            return {SIGNAL_QUEUE_DEPTH: 0.0}

        asc._signals = more  # demand collapses while still settling
        asc.evaluate_once()
        assert slices_of(store, "as-settling") == 3  # held
        assert metrics.autoscaler_holds.value(
            reason=HOLD_SETTLING) == holds0 + 1


class TestHysteresis:
    def test_shrink_waits_out_the_cooldown(self):
        clock = FakeClock()
        shrink0 = metrics.gang_resizes.value(direction="shrink",
                                             reason="autoscale")
        store, gang, asc = harness("as-cool", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 0.0}, clock=clock, num_slices=3,
            cooldown=10.0)
        asc.evaluate_once()  # opens the window, holds
        assert slices_of(store, "as-cool") == 3
        assert ("autoscale.hold", HOLD_COOLDOWN) in journal_kinds(
            "as-cool")
        clock.advance(9.0)
        asc.evaluate_once()  # still inside the window
        assert slices_of(store, "as-cool") == 3
        clock.advance(2.0)
        asc.evaluate_once()  # window elapsed: shrink lands
        assert slices_of(store, "as-cool") == 1
        assert metrics.gang_resizes.value(
            direction="shrink", reason="autoscale") == shrink0 + 1
        assert ("autoscale.down", "queue-depth") in journal_kinds(
            "as-cool")

    def test_demand_return_resets_the_window(self):
        """Under-demand must be CONTINUOUS: a burst inside the window
        restarts it, so a flapping trace never shrinks."""
        clock = FakeClock()
        sig = {SIGNAL_QUEUE_DEPTH: 0.0}
        store, gang, asc = harness("as-flap", lambda ns, n: dict(sig),
                                   clock=clock, num_slices=3,
                                   cooldown=10.0)
        asc.evaluate_once()  # window opens
        clock.advance(8.0)
        sig[SIGNAL_QUEUE_DEPTH] = 12.0  # demand covers 3 slices again
        asc.evaluate_once()  # window must reset
        sig[SIGNAL_QUEUE_DEPTH] = 0.0
        clock.advance(8.0)
        asc.evaluate_once()  # NEW window opens here — 16s since the
        assert slices_of(store, "as-flap") == 3  # first one, still held
        clock.advance(8.0)
        asc.evaluate_once()  # 8s of the new window: still held
        assert slices_of(store, "as-flap") == 3
        clock.advance(3.0)
        asc.evaluate_once()  # 11s: continuous under-demand at last
        assert slices_of(store, "as-flap") == 1

    def test_square_wave_one_resize_per_direction_per_period(self):
        """The acceptance shape (docs/serving.md): a square-wave load
        makes at most ONE resize per direction per period — up on the
        rising edge, down one cooldown into the trough — and the whole
        arc is reconstructable from the decision journal."""
        clock = FakeClock()
        sig = {SIGNAL_QUEUE_DEPTH: 0.0}
        grow0 = metrics.gang_resizes.value(direction="grow",
                                           reason="autoscale")
        shrink0 = metrics.gang_resizes.value(direction="shrink",
                                             reason="autoscale")
        store, gang, asc = harness("as-wave", lambda ns, n: dict(sig),
                                   clock=clock, cooldown=2.0)
        periods, period, step = 3, 10.0, 0.5
        t = 0.0
        while t < periods * period:
            sig[SIGNAL_QUEUE_DEPTH] = (
                12.0 if (t % period) < period / 2 else 0.0)
            asc.evaluate_once()
            settle(store, "as-wave")  # engine finishes each restart
            clock.advance(step)
            t += step
        grows = metrics.gang_resizes.value(
            direction="grow", reason="autoscale") - grow0
        shrinks = metrics.gang_resizes.value(
            direction="shrink", reason="autoscale") - shrink0
        assert grows == periods  # exactly one per rising edge
        assert shrinks == periods  # exactly one per trough
        # Journal reconstruction: alternating up/down arc, no other
        # applied decisions.
        decisions = [r for r in trace_mod.JOURNAL.decisions(NS, "as-wave")
                     if r["kind"] in ("autoscale.up", "autoscale.down")]
        arc = [r["kind"] for r in decisions]
        assert arc == ["autoscale.up", "autoscale.down"] * periods
        for r in decisions:
            assert "queue_depth=" in r["message"]  # inputs preserved

    def test_journal_served_at_debug_endpoint(self):
        """The operator-facing contract: the autoscale arc is readable
        from /debug/jobs/<ns>/<name> — no log archaeology."""
        from tf_operator_tpu_torch.runtime.monitoring import MonitoringServer

        store, gang, asc = harness("as-debug", lambda ns, n: {
            SIGNAL_QUEUE_DEPTH: 12.0})
        asc.evaluate_once()
        server = MonitoringServer(port=0)
        server.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}"
                    f"/debug/jobs/{NS}/as-debug") as resp:
                payload = json.loads(resp.read())
        finally:
            server.stop()
        kinds = [r["kind"] for r in payload["decisions"]]
        assert "autoscale.up" in kinds


class TestSignals:
    def test_spool_pending_depth(self, tmp_path):
        pending = tmp_path / "pending"
        pending.mkdir()
        for i in range(3):
            (pending / f"r{i}.json").write_text("{}")
        (pending / "ignored.tmp").write_text("")
        assert spool_pending_depth(str(tmp_path)) == 3.0
        assert spool_pending_depth(str(tmp_path / "missing")) == 0.0

    def test_default_provider_reads_job_spool(self, tmp_path):
        (tmp_path / "pending").mkdir()
        (tmp_path / "pending" / "a.json").write_text("{}")
        store = Store()
        make_serving_job(store, "as-sig", spool=str(tmp_path))
        asc = ServingAutoscaler(store, None, namespace=NS)
        sig = asc.signals(NS, "as-sig")
        assert sig[SIGNAL_QUEUE_DEPTH] == 1.0

    def test_injected_provider_failure_is_safe(self):
        def boom(ns, n):
            raise RuntimeError("scrape failed")

        store, gang, asc = harness("as-boom", boom)
        asc.evaluate_once()  # depth defaults to 0 -> no resize
        assert slices_of(store, "as-boom") == 1


pytestmark = pytest.mark.control_plane
