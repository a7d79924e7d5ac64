"""Copy of ``tests/test_elastic.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Elastic gangs: minSlices/maxSlices resize pass (docs/elastic.md).

Unit coverage of the SliceGangScheduler resize machinery:

- grow into idle capacity (job slice count + coupled worker replicas,
  biggest step that fits, self-serializing via the resizing marker);
- quota reclaim preferring shrink-to-min over displacement, and
  falling back to displacement at the floor;
- the shrink save-before-evict barrier gate (held until full-gang ack,
  `resize_barrier_seconds` observed, departed replicas' Checkpoint-
  Records pruned so they never pin committed_step);
- degraded-control-plane deferral, never-below-minSlices floors;
- slice-health drains preferring a shrink when only worker slices are
  doomed, with the atomic full drain as the fallback;
- the Resizing condition arc on the job and the resize-decision signal
  plumbing (serving_queue_depth, ROADMAP item 3a);
- flag-off parity: elastic=False never resizes anything.
"""

import datetime as dt
import json

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants, set_defaults
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    CheckpointRecord,
    CheckpointRecordStatus,
    ClusterQueue,
    ClusterQueueSpec,
    ConditionStatus,
    HealthPolicy,
    JobConditionType,
    Node,
    NodeSpec,
    NodeStatus,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TenantQueue,
    TenantQueueSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.api.validation import ValidationError, validate_job
from tf_operator_tpu_torch.controller.ckpt import CheckpointCoordinator
from tf_operator_tpu_torch.controller.engine import EngineConfig
from tf_operator_tpu_torch.controller.gang import (
    PHASE_INQUEUE,
    PHASE_PENDING,
    PHASE_RUNNING,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.controller.health import SliceHealthController
from tf_operator_tpu_torch.controller.quota import TenantQueueManager
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.store import Store

NS = "default"


def _now():
    return dt.datetime.now(dt.timezone.utc)


def make_elastic_job(store, name, num_slices=1, min_slices=1,
                     max_slices=3, accelerator="h100-4",
                     queue="", ckpt=False):
    """Job whose worker count tracks the slice count (h100-4 = one host
    per slice), mirroring what the resize pass scales."""
    job = testutil.new_tpujob(worker=num_slices, name=name, namespace=NS)
    job.spec.slice = TPUSliceSpec(accelerator=accelerator,
                                  num_slices=num_slices,
                                  min_slices=min_slices,
                                  max_slices=max_slices)
    if queue:
        job.spec.queue_name = queue
    if ckpt:
        job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
            enabled=True, directory="/tmp/ckpt",
            barrier_timeout_seconds=30.0)
    set_defaults(job)
    store.create(store_mod.TPUJOBS, job)
    return job


def make_group(store, name, num_slices=1, min_slices=1, max_slices=3,
               accelerator="h100-4", queue="", phase=PHASE_RUNNING,
               min_member=None):
    group = SliceGroup(
        spec=SliceGroupSpec(
            min_member=(num_slices if min_member is None else min_member),
            queue=queue,
            slice=TPUSliceSpec(accelerator=accelerator,
                               num_slices=num_slices,
                               min_slices=min_slices,
                               max_slices=max_slices)),
        status=SliceGroupStatus(phase=phase, pending_since=_now()))
    group.metadata.name = name
    group.metadata.namespace = NS
    group.metadata.labels = {constants.LABEL_JOB_NAME: name}
    store.create(store_mod.SLICEGROUPS, group)
    return group


def add_worker_pod(store, job_name, index, node="", phase="Running"):
    from tf_operator_tpu_torch.api.types import (
        ObjectMeta,
        Pod,
        PodSpec,
        PodStatus,
    )

    pod = Pod(
        metadata=ObjectMeta(
            name=f"{job_name}-worker-{index}", namespace=NS,
            labels={constants.LABEL_JOB_NAME: job_name,
                    constants.LABEL_GROUP_NAME: constants.GROUP,
                    constants.LABEL_REPLICA_TYPE: "worker",
                    constants.LABEL_REPLICA_INDEX: str(index)},
            annotations={constants.ANNOTATION_GANG_GROUP: job_name}),
        spec=PodSpec(node_name=node),
        status=PodStatus(phase=phase))
    store.create(store_mod.PODS, pod)
    return pod


def job_slices(store, name):
    return store.get(store_mod.TPUJOBS, NS, name).spec.slice.num_slices


def worker_replicas(store, name):
    job = store.get(store_mod.TPUJOBS, NS, name)
    return job.spec.replica_specs["worker"].replicas


# --- validation -----------------------------------------------------------

def test_min_max_slices_validation():
    job = testutil.new_tpujob(worker=1)
    job.spec.slice = TPUSliceSpec(accelerator="h100-4", num_slices=2,
                                  min_slices=1, max_slices=4)
    set_defaults(job)
    validate_job(job)  # valid elastic spec

    job.spec.slice.max_slices = 0
    with pytest.raises(ValidationError, match="maxSlices"):
        validate_job(job)

    job.spec.slice = TPUSliceSpec(accelerator="h100-4", num_slices=1,
                                  min_slices=3, max_slices=2)
    with pytest.raises(ValidationError, match="maxSlices"):
        validate_job(job)

    job.spec.slice = TPUSliceSpec(accelerator="h100-4", num_slices=1,
                                  min_slices=2)
    with pytest.raises(ValidationError, match="numSlices"):
        validate_job(job)

    job.spec.slice = TPUSliceSpec(num_slices=1, min_slices=1)
    with pytest.raises(ValidationError, match="accelerator"):
        validate_job(job)


# --- grow -----------------------------------------------------------------

def test_grow_into_idle_capacity_scales_job_and_workers():
    store = Store()
    make_elastic_job(store, "ela", num_slices=1, max_slices=3)
    group = make_group(store, "ela", num_slices=1, max_slices=3)
    gang = SliceGangScheduler(store, total_chips=12, elastic=True)
    before = metrics.gang_resizes.value(direction="grow", reason="idle")

    gang.readmit()

    # Biggest step that fits: 12 chips / 4 per slice -> straight to 3.
    assert job_slices(store, "ela") == 3
    assert worker_replicas(store, "ela") == 3
    group = store.get(store_mod.SLICEGROUPS, NS, "ela")
    assert group.status.resizing_reason.startswith("grow to 3")
    assert metrics.gang_resizes.value(direction="grow",
                                      reason="idle") == before + 1
    assert metrics.job_slices.value(job_namespace=NS, job="ela") == 3


def test_grow_held_while_previous_resize_settles():
    store = Store()
    make_elastic_job(store, "ela", num_slices=1, max_slices=3)
    group = make_group(store, "ela", num_slices=1, max_slices=3)
    group.status.resizing_reason = "grow to 2 slice(s): idle"
    store.update_status(store_mod.SLICEGROUPS, group)
    gang = SliceGangScheduler(store, total_chips=12, elastic=True)
    gang.readmit()
    assert job_slices(store, "ela") == 1  # held: still settling


def test_grow_stands_down_while_feasible_demand_waits():
    """Idle capacity is not idle when a feasible pending gang wants it:
    the grow pass must not starve admission."""
    store = Store()
    make_elastic_job(store, "ela", num_slices=1, max_slices=3)
    make_group(store, "ela", num_slices=1, max_slices=3)
    make_group(store, "pending", num_slices=2, min_slices=None,
               max_slices=None, phase=PHASE_PENDING)
    # Capacity fits the running gang + part of the pending one only.
    gang = SliceGangScheduler(store, total_chips=8, elastic=True)
    gang.readmit()
    assert job_slices(store, "ela") == 1
    # The pending group admitted instead (4+8 > 8 would not fit, so it
    # stays Pending — but the elastic gang must not have eaten the
    # chips it is waiting for).
    assert store.get(store_mod.SLICEGROUPS, NS,
                     "pending").status.phase == PHASE_PENDING


def test_elastic_off_never_resizes():
    store = Store()
    make_elastic_job(store, "ela", num_slices=1, max_slices=3)
    make_group(store, "ela", num_slices=1, max_slices=3)
    gang = SliceGangScheduler(store, total_chips=12, elastic=False)
    gang.readmit()
    assert job_slices(store, "ela") == 1
    assert worker_replicas(store, "ela") == 1


def test_grow_respects_degraded_control_plane():
    class DegradedHealth:
        degraded = True

        def allow_disruption(self, action):
            return False

    store = Store()
    make_elastic_job(store, "ela", num_slices=1, max_slices=3)
    make_group(store, "ela", num_slices=1, max_slices=3)
    gang = SliceGangScheduler(store, total_chips=12, elastic=True,
                              cp_health=DegradedHealth())
    gang.readmit()
    assert job_slices(store, "ela") == 1


def test_resize_signals_are_consulted_and_surfaced():
    """ROADMAP item 3a plumbing: the resize decision interface exposes
    provider signals (e.g. serving_queue_depth) on the resize record —
    the autoscaler policy itself is future work, the signal path is
    live."""
    store = Store()
    make_elastic_job(store, "ela", num_slices=1, max_slices=2)
    make_group(store, "ela", num_slices=1, max_slices=2)
    seen = []

    def signals(ns, name):
        seen.append((ns, name))
        return {"serving_queue_depth": 7.0}

    gang = SliceGangScheduler(store, total_chips=8, elastic=True,
                              resize_signals=signals)
    gang.readmit()
    assert seen == [(NS, "ela")]
    group = store.get(store_mod.SLICEGROUPS, NS, "ela")
    assert "serving_queue_depth=7" in group.status.resizing_reason


# --- shrink: quota reclaim ------------------------------------------------

def _quota_fixture(store, borrower_slices=2, borrower_min=1):
    """Cohort of two queues, nominal one slice each; the borrower gang
    holds the whole cohort, the demander's nominal demand is pending."""
    for qname in ("tenant-a", "tenant-b"):
        cq = ClusterQueue(spec=ClusterQueueSpec(nominal_chips=4,
                                                cohort="c"))
        cq.metadata.name = f"cq-{qname}"
        cq.metadata.namespace = ""
        store.create(store_mod.CLUSTERQUEUES, cq)
        tq = TenantQueue(spec=TenantQueueSpec(cluster_queue=f"cq-{qname}"))
        tq.metadata.name = qname
        tq.metadata.namespace = NS
        store.create(store_mod.TENANTQUEUES, tq)
    make_elastic_job(store, "borrower", num_slices=borrower_slices,
                     min_slices=borrower_min, max_slices=3,
                     queue="tenant-a")
    make_group(store, "borrower", num_slices=borrower_slices,
               min_slices=borrower_min, max_slices=3, queue="tenant-a")
    make_group(store, "demander", num_slices=1, min_slices=None,
               max_slices=None, queue="tenant-b", phase=PHASE_PENDING)


def test_reclaim_prefers_shrink_to_min_over_displacement():
    store = Store()
    _quota_fixture(store, borrower_slices=2, borrower_min=1)
    quota = TenantQueueManager(store)
    gang = SliceGangScheduler(store, total_chips=8, quota=quota,
                              elastic=True)
    before = metrics.gang_resizes.value(direction="shrink",
                                        reason="reclaim")

    gang.readmit()

    # The borrower was SHRUNK by exactly the demanded slice, not
    # displaced: it keeps running at the smaller size.
    assert job_slices(store, "borrower") == 1
    assert worker_replicas(store, "borrower") == 1
    group = store.get(store_mod.SLICEGROUPS, NS, "borrower")
    assert group.status.phase == PHASE_RUNNING
    assert group.status.displaced_reason == ""
    assert group.status.resizing_reason.startswith("shrink to 1")
    assert metrics.gang_resizes.value(
        direction="shrink", reason="reclaim") == before + 1


def test_reclaim_displaces_when_borrower_is_at_min_slices():
    store = Store()
    # Borrower already at its floor (min == current) but still over
    # nominal: shrink is not applicable, displacement proceeds.
    _quota_fixture(store, borrower_slices=2, borrower_min=2)
    quota = TenantQueueManager(store)
    gang = SliceGangScheduler(store, total_chips=8, quota=quota,
                              elastic=True)
    gang.readmit()
    assert job_slices(store, "borrower") == 2  # size untouched
    group = store.get(store_mod.SLICEGROUPS, NS, "borrower")
    assert group.status.phase == PHASE_PENDING  # displaced wholesale
    assert group.status.displaced_reason != ""


def test_try_shrink_refuses_below_floor():
    store = Store()
    make_elastic_job(store, "ela", num_slices=2, min_slices=2)
    make_group(store, "ela", num_slices=2, min_slices=2)
    gang = SliceGangScheduler(store, total_chips=8, elastic=True)
    assert gang.try_shrink(NS, "ela", 1, "drain", "test") is None
    assert job_slices(store, "ela") == 2


# --- shrink: save-before-evict barrier ------------------------------------

def test_shrink_waits_for_barrier_then_prunes_departed_records():
    store = Store()
    clock = [0.0]
    ckpt = CheckpointCoordinator(store, clock=lambda: clock[0])
    make_elastic_job(store, "ela", num_slices=2, min_slices=1,
                     ckpt=True)
    make_group(store, "ela", num_slices=2, min_slices=1)
    pods = [add_worker_pod(store, "ela", i) for i in range(2)]
    for i in range(2):
        rec = CheckpointRecord(status=CheckpointRecordStatus(
            step=10, progress_step=10))
        rec.metadata.name = f"ela-worker-{i}"
        rec.metadata.namespace = NS
        rec.metadata.labels = {constants.LABEL_JOB_NAME: "ela"}
        store.create(store_mod.CHECKPOINTRECORDS, rec)
    gang = SliceGangScheduler(store, total_chips=8, elastic=True,
                              ckpt=ckpt)
    barriers_before = metrics.resize_barrier_seconds.count_value(
        job_namespace=NS)

    # First ask opens the barrier: the shrink is HELD, the preemption
    # notice is stamped on the gang's pods.
    assert gang.try_shrink(NS, "ela", 1, "drain", "node doomed") is False
    assert job_slices(store, "ela") == 2
    stamped = store.get(store_mod.PODS, NS, "ela-worker-0")
    notice = stamped.metadata.annotations[
        constants.ANNOTATION_PREEMPT_NOTICE]
    barrier_id = json.loads(notice)["barrier"]

    # Full-gang ack at step 20 releases the shrink.
    for i in range(2):
        rec = store.get(store_mod.CHECKPOINTRECORDS, NS,
                        f"ela-worker-{i}")
        rec.status = CheckpointRecordStatus(step=20, progress_step=20,
                                            barrier_id=barrier_id)
        store.update_status(store_mod.CHECKPOINTRECORDS, rec)
    assert gang.try_shrink(NS, "ela", 1, "drain", "node doomed") is True
    assert job_slices(store, "ela") == 1
    assert worker_replicas(store, "ela") == 1
    assert metrics.resize_barrier_seconds.count_value(
        job_namespace=NS) == barriers_before + 1
    # The departed worker's record is pruned — left behind it would pin
    # committed_step at the shrink point forever; the survivor's stays.
    assert store.try_get(store_mod.CHECKPOINTRECORDS, NS,
                         "ela-worker-1") is None
    assert store.try_get(store_mod.CHECKPOINTRECORDS, NS,
                         "ela-worker-0") is not None
    assert ckpt.committed_step(NS, "ela") == 20


def test_out_of_world_records_never_pin_committed_step():
    """Zombie-record regression (docs/elastic.md): a doomed pod can
    publish its CheckpointRecord AFTER the shrink-time prune ran (the
    data plane races the prune), and an out-of-world record would drag
    committed_step back to the shrink point — every later restore
    would roll the surviving gang back. The coordinator must filter
    records to the job's CURRENT replica identities."""
    store = Store()
    ckpt = CheckpointCoordinator(store)
    make_elastic_job(store, "ela", num_slices=1, min_slices=1, ckpt=True)
    for name, step in (("ela-worker-0", 50), ("ela-worker-1", 20)):
        rec = CheckpointRecord(status=CheckpointRecordStatus(
            step=step, progress_step=step))
        rec.metadata.name = name
        rec.metadata.namespace = NS
        rec.metadata.labels = {constants.LABEL_JOB_NAME: "ela"}
        store.create(store_mod.CHECKPOINTRECORDS, rec)
    # worker-1 left the world (the job declares one worker): its stale
    # record must be invisible to the committed step and restore env.
    assert ckpt.committed_step(NS, "ela") == 50
    job = store.get(store_mod.TPUJOBS, NS, "ela")
    env = ckpt.bootstrap_env(job)
    assert env[constants.ENV_RESTORE_STEP] == "50"


# --- slice-health drain preference ----------------------------------------

def _health_fixture(store, num_slices=2, min_slices=1):
    job = make_elastic_job(store, "ela", num_slices=num_slices,
                           min_slices=min_slices)
    job = store.get(store_mod.TPUJOBS, NS, "ela")
    job.spec.run_policy.health_policy = HealthPolicy(enabled=True)
    store.update(store_mod.TPUJOBS, job)
    make_group(store, "ela", num_slices=num_slices,
               min_slices=min_slices)
    for name, healthy in (("node-ok", True), ("node-bad", False)):
        node = Node(spec=NodeSpec(chips=8),
                    status=NodeStatus(phase="Ready"))
        node.metadata.name = name
        if not healthy:
            node.status.conditions = {"MaintenancePending": "True"}
        store.create(store_mod.NODES, node)
    add_worker_pod(store, "ela", 0, node="node-ok")
    add_worker_pod(store, "ela", 1, node="node-bad")


def test_health_drain_prefers_shrink_for_doomed_worker_slice():
    store = Store()
    _health_fixture(store, num_slices=2, min_slices=1)
    gang = SliceGangScheduler(store, total_chips=8, elastic=True)
    health = SliceHealthController(store, gang=gang)

    health.health_pass()

    # Shrunk by the doomed slice, NOT drained: the healthy pod
    # survives, the gang stays admitted.
    assert job_slices(store, "ela") == 1
    group = store.get(store_mod.SLICEGROUPS, NS, "ela")
    assert group.status.phase == PHASE_RUNNING
    assert group.status.displaced_reason == ""
    assert store.try_get(store_mod.PODS, NS, "ela-worker-0") is not None


def test_health_drain_falls_back_when_shrink_would_break_floor():
    store = Store()
    # Both slices doomed... the floor (min=2) forbids shrinking, so the
    # atomic full drain takes over exactly as before elastic existed.
    _health_fixture(store, num_slices=2, min_slices=2)
    pod = store.get(store_mod.PODS, NS, "ela-worker-0")
    pod.spec.node_name = "node-bad"
    store.update(store_mod.PODS, pod)
    gang = SliceGangScheduler(store, total_chips=8, elastic=True)
    health = SliceHealthController(store, gang=gang)

    health.health_pass()

    assert job_slices(store, "ela") == 2  # never below the floor
    group = store.get(store_mod.SLICEGROUPS, NS, "ela")
    # Displaced wholesale (the displace may already have readmitted the
    # empty-handed group — Pending or Inqueue — but the repair arc is
    # marked and every pod was evicted).
    assert group.status.phase in (PHASE_PENDING, PHASE_INQUEUE)
    assert group.status.displaced_reason != ""
    assert store.try_get(store_mod.PODS, NS, "ela-worker-0") is None


# --- Resizing condition arc ----------------------------------------------

def test_resizing_condition_arc_on_job():
    store = Store()
    controller = GPUJobController(
        store, config=EngineConfig(enable_gang_scheduling=True),
        gang=None, namespace=NS)
    gang = SliceGangScheduler(store, total_chips=None, elastic=True)
    controller.engine.gang = gang
    gang.pod_control = controller.engine.pod_control
    job = testutil.new_tpujob(worker=1, name="ela", namespace=NS)
    job.spec.slice = TPUSliceSpec(accelerator="h100-4", num_slices=1,
                                  min_slices=1, max_slices=2)
    store.create(store_mod.TPUJOBS, job)
    # No watchers run in this unit test, so pod-creation expectations
    # would gate every re-sync; expire them immediately.
    controller.expectations._timeout = 0.0

    controller.sync_tpujob(f"{NS}/ela")
    group = store.get(store_mod.SLICEGROUPS, NS, "ela")
    group.status.resizing_reason = "grow to 2 slice(s): idle"
    store.update_status(store_mod.SLICEGROUPS, group)

    controller.sync_tpujob(f"{NS}/ela")
    job = store.get(store_mod.TPUJOBS, NS, "ela")
    resizing = [c for c in job.status.conditions
                if c.type == JobConditionType.RESIZING]
    assert resizing and resizing[0].status == ConditionStatus.TRUE
    assert resizing[0].reason == "GangResizing"

    group = store.get(store_mod.SLICEGROUPS, NS, "ela")
    group.status.resizing_reason = ""
    store.update_status(store_mod.SLICEGROUPS, group)
    controller.sync_tpujob(f"{NS}/ela")
    job = store.get(store_mod.TPUJOBS, NS, "ela")
    resizing = [c for c in job.status.conditions
                if c.type == JobConditionType.RESIZING]
    assert resizing and resizing[0].status == ConditionStatus.FALSE
    assert resizing[0].reason == "GangResizeComplete"


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
