"""Copy of ``tests/test_quota.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Tenant-queue quota admission (controller/quota.py): nominal quota,
cohort borrowing, reclaim preemption, and the job-facing arc (Queued
condition, terminal QuotaExceeded, QueueDeleted re-queueing).

Unit level drives SliceGangScheduler + TenantQueueManager directly on a
Store (the test_gang_admission idiom); e2e level runs the full local
Operator with --enable-tenant-queues semantics and real subprocess pods
— including the acceptance arc: two queues over one cohort, the
quota-exceeding tenant waits with QueuedWaitingForQuota while the other
admits, idle capacity is borrowable, and a reclaim preemption restores
nominal quota.
"""

import datetime as dt
import os
import sys
import time

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    ClusterQueue,
    ClusterQueueSpec,
    Container,
    JobConditionType,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReclaimPolicy,
    ReplicaSpec,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TenantQueue,
    TenantQueueSpec,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.api.validation import ValidationError
from tf_operator_tpu_torch.controller.gang import (
    PHASE_INQUEUE,
    PHASE_PENDING,
    PHASE_RUNNING,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.controller.quota import (
    TenantQueueManager,
    load_queue_config,
    seed_queues,
)
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime import metrics, store as store_mod
from tf_operator_tpu_torch.runtime.events import Recorder
from tf_operator_tpu_torch.runtime.store import Store
from tf_operator_tpu_torch.sdk import TPUJobClient

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _now():
    return dt.datetime.now(dt.timezone.utc)


def add_cluster_queue(store, name, nominal, borrowing_limit=None,
                      cohort="", reclaim_policy=""):
    cq = ClusterQueue(spec=ClusterQueueSpec(
        nominal_chips=nominal, borrowing_limit=borrowing_limit,
        cohort=cohort, reclaim_policy=reclaim_policy))
    cq.metadata.name = name
    cq.metadata.namespace = ""
    store.create(store_mod.CLUSTERQUEUES, cq)
    return cq


def add_tenant_queue(store, name, cluster_queue, namespace="default"):
    tq = TenantQueue(spec=TenantQueueSpec(cluster_queue=cluster_queue))
    tq.metadata.name = name
    tq.metadata.namespace = namespace
    store.create(store_mod.TENANTQUEUES, tq)
    return tq


def add_group(store, name, chips=8, queue="", priority="",
              phase=PHASE_PENDING, age_seconds=0.0):
    group = SliceGroup(
        spec=SliceGroupSpec(min_member=1, queue=queue,
                            priority_class=priority,
                            slice=TPUSliceSpec(accelerator=f"h100-{chips}")),
        status=SliceGroupStatus(
            phase=phase,
            pending_since=_now() - dt.timedelta(seconds=age_seconds)))
    group.metadata.name = name
    group.metadata.namespace = "default"
    group.metadata.creation_timestamp = \
        _now() - dt.timedelta(seconds=age_seconds)
    store.create(store_mod.SLICEGROUPS, group)
    return group


def phase_of(store, name):
    return store.get(store_mod.SLICEGROUPS, "default", name).status.phase


def quota_sched(store, total_chips=None, recorder=None, **gang_kwargs):
    mgr = TenantQueueManager(store, recorder=recorder)
    sched = SliceGangScheduler(store, total_chips=total_chips, quota=mgr,
                               **gang_kwargs)
    return sched, mgr


def wait_of(mgr, name, namespace="default"):
    return mgr.status_for(TPUJob(metadata=ObjectMeta(
        name=name, namespace=namespace)))


# --- nominal quota / borrowing (unit) --------------------------------------

def test_default_queue_is_quota_exempt():
    """Groups without a queueName keep pre-quota behavior even with the
    manager wired: the default queue is not metered."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=8)
    add_cluster_queue(store, "cq-a", nominal=0)
    add_tenant_queue(store, "team-a", "cq-a")
    add_group(store, "legacy", chips=8, queue="")
    sched._admit()
    assert phase_of(store, "legacy") == PHASE_INQUEUE
    assert wait_of(mgr, "legacy") is None


def test_nominal_quota_blocks_one_tenant_while_other_admits():
    """The acceptance core at unit level: two queues over one cohort,
    the quota-exceeding tenant waits (with a recorded wait state) while
    the other tenant admits — physical capacity alone would have fit
    both."""
    store = Store()
    rec = Recorder()
    sched, mgr = quota_sched(store, total_chips=32, recorder=rec)
    add_cluster_queue(store, "cq-a", nominal=8, borrowing_limit=0,
                      cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=8, borrowing_limit=0,
                      cohort="pool")
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=8, queue="team-a", age_seconds=30)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=20)
    add_group(store, "b1", chips=8, queue="team-b", age_seconds=10)
    sched._admit()
    assert phase_of(store, "a1") == PHASE_INQUEUE
    assert phase_of(store, "a2") == PHASE_PENDING  # over nominal, no borrow
    assert phase_of(store, "b1") == PHASE_INQUEUE  # own lane unaffected
    wait = wait_of(mgr, "a2")
    assert wait is not None and not wait.terminal
    assert "borrowingLimit" in wait.message
    assert rec.events_for("a2", reason="QueuedWaitingForQuota")


def test_idle_cohort_capacity_is_borrowable():
    store = Store()
    rec = Recorder()
    sched, mgr = quota_sched(store, total_chips=32, recorder=rec)
    add_cluster_queue(store, "cq-a", nominal=8, cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=8, cohort="pool")
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=8, queue="team-a", age_seconds=20)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=10)
    sched._admit()
    # a2 runs on cq-b's idle nominal share.
    assert phase_of(store, "a1") == PHASE_INQUEUE
    assert phase_of(store, "a2") == PHASE_INQUEUE
    assert rec.events_for("a2", reason="BorrowedCapacity")
    cq = store.get(store_mod.CLUSTERQUEUES, "", "cq-a")
    assert cq.status.admitted_chips == 16
    assert cq.status.borrowed_chips == 8
    assert metrics.queue_borrowed_chips.value(queue="cq-a") == 8


def test_borrowing_never_exceeds_cohort_capacity():
    """The subsystem's first invariant: even with unlimited
    borrowingLimit, admissions stop at the cohort's aggregate nominal."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=1024)
    add_cluster_queue(store, "cq-a", nominal=8, cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=8, cohort="pool")
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    for i in range(4):  # 32 chips requested over a 16-chip cohort
        add_group(store, f"a{i}", chips=8, queue="team-a",
                  age_seconds=40 - i)
    sched._admit()
    admitted = [f"a{i}" for i in range(4)
                if phase_of(store, f"a{i}") == PHASE_INQUEUE]
    assert admitted == ["a0", "a1"]  # FIFO, 16/16 cohort chips
    wait = wait_of(mgr, "a2")
    assert wait is not None and "no idle capacity" in wait.message


def test_borrowing_limit_caps_borrow_below_cohort_idle():
    store = Store()
    sched, mgr = quota_sched(store, total_chips=64)
    add_cluster_queue(store, "cq-a", nominal=8, borrowing_limit=4,
                      cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=16, cohort="pool")
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=8, queue="team-a", age_seconds=20)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=10)
    sched._admit()
    assert phase_of(store, "a1") == PHASE_INQUEUE
    # 8 over nominal > borrowingLimit 4, despite 16 idle cohort chips.
    assert phase_of(store, "a2") == PHASE_PENDING
    assert "borrowingLimit" in wait_of(mgr, "a2").message


def test_fifo_within_priority_preserved_inside_queue():
    """Starvation-freedom invariant: a quota-blocked group holds its
    FIFO slot — a younger same-queue group must not leapfrog it when
    quota frees (lane blocking applies to quota blocks too)."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=64, fairness="strict")
    add_cluster_queue(store, "cq-a", nominal=8, borrowing_limit=0)
    add_tenant_queue(store, "team-a", "cq-a")
    add_group(store, "hog", chips=8, queue="team-a", phase=PHASE_INQUEUE)
    add_group(store, "older", chips=8, queue="team-a", age_seconds=20)
    add_group(store, "younger", chips=4, queue="team-a", age_seconds=10)
    sched._admit()
    # Strict lane: younger (4 chips would fit nominal? no — hog holds
    # 8/8) must not admit past the blocked older group either way.
    assert phase_of(store, "older") == PHASE_PENDING
    assert phase_of(store, "younger") == PHASE_PENDING
    # Quota frees: the OLDER group takes the slot first.
    store.delete(store_mod.SLICEGROUPS, "default", "hog")
    sched._admit()
    assert phase_of(store, "older") == PHASE_INQUEUE
    assert phase_of(store, "younger") == PHASE_PENDING


# --- reclaim (unit) --------------------------------------------------------

def test_borrow_then_reclaim_restores_nominal_within_one_pass():
    """Borrow-then-reclaim convergence: a single admission pass issues
    the reclaim displacement AND (pod-free groups) admits the nominal
    demander — the cohort returns to nominal without waiting for a
    resync."""
    store = Store()
    rec = Recorder()
    sched, mgr = quota_sched(store, total_chips=16, recorder=rec)
    add_cluster_queue(store, "cq-a", nominal=8, cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=8, cohort="pool")
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=8, queue="team-a", age_seconds=30)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=20)
    sched._admit()
    assert phase_of(store, "a2") == PHASE_INQUEUE  # borrowed
    before = metrics.quota_reclaims.value(queue="team-a")

    add_group(store, "b1", chips=8, queue="team-b", age_seconds=10)
    sched._admit()  # ONE pass: reclaim a2, admit b1
    assert phase_of(store, "a2") == PHASE_PENDING
    assert phase_of(store, "b1") == PHASE_INQUEUE
    assert phase_of(store, "a1") == PHASE_INQUEUE  # never below nominal
    assert metrics.quota_reclaims.value(queue="team-a") == before + 1
    assert rec.events_for("a2", reason="QuotaReclaimed")
    cq_a = store.get(store_mod.CLUSTERQUEUES, "", "cq-a")
    assert cq_a.status.admitted_chips == 8
    assert cq_a.status.borrowed_chips == 0


def test_reclaim_never_takes_a_queue_below_nominal():
    """Only the borrowed portion is reclaimable: with one 8-chip
    borrower, a 16-chip nominal demand reclaims the borrower and then
    stops — the lender's within-nominal gang survives."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=32)
    add_cluster_queue(store, "cq-a", nominal=16, cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=16, cohort="pool")
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=16, queue="team-a", age_seconds=30)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=20)
    sched._admit()
    add_group(store, "b1", chips=16, queue="team-b", age_seconds=10)
    sched._admit()
    assert phase_of(store, "a1") == PHASE_INQUEUE  # within nominal: kept
    assert phase_of(store, "a2") == PHASE_PENDING  # the borrower: evicted
    assert phase_of(store, "b1") == PHASE_INQUEUE


def test_reclaim_policy_never_waits_for_voluntary_free():
    store = Store()
    sched, mgr = quota_sched(store, total_chips=16)
    add_cluster_queue(store, "cq-a", nominal=8, cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=8, cohort="pool",
                      reclaim_policy=ReclaimPolicy.NEVER)
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=8, queue="team-a", age_seconds=30)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=20)
    sched._admit()
    add_group(store, "b1", chips=8, queue="team-b", age_seconds=10)
    sched._admit()
    # b1's queue never reclaims: the borrower keeps running, b1 waits.
    assert phase_of(store, "a2") == PHASE_INQUEUE
    assert phase_of(store, "b1") == PHASE_PENDING
    # But the borrow freeze holds: a new borrow attempt is denied while
    # b1's nominal demand is outstanding.
    add_group(store, "a3", chips=8, queue="team-a", age_seconds=5)
    sched._admit()
    assert phase_of(store, "a3") == PHASE_PENDING


def test_reclaim_policy_lower_priority_spares_equal_priority():
    store = Store()
    sched, mgr = quota_sched(
        store, total_chips=16,
        priority_classes={"prod": 100, "batch": 10})
    add_cluster_queue(store, "cq-a", nominal=8, cohort="pool")
    add_cluster_queue(store, "cq-b", nominal=8, cohort="pool",
                      reclaim_policy=ReclaimPolicy.LOWER_PRIORITY)
    add_tenant_queue(store, "team-a", "cq-a")
    add_tenant_queue(store, "team-b", "cq-b")
    add_group(store, "a1", chips=8, queue="team-a", priority="prod",
              age_seconds=30)
    add_group(store, "a2", chips=8, queue="team-a", priority="prod",
              age_seconds=20)
    sched._admit()
    add_group(store, "b1", chips=8, queue="team-b", priority="prod",
              age_seconds=10)
    sched._admit()
    # The borrower is equal priority: LowerPriority reclaim spares it.
    assert phase_of(store, "a2") == PHASE_INQUEUE
    assert phase_of(store, "b1") == PHASE_PENDING
    # A lower-priority borrower in the same spot IS reclaimed.
    store.delete(store_mod.SLICEGROUPS, "default", "b1")
    store.delete(store_mod.SLICEGROUPS, "default", "a2")
    sched._admit()
    add_group(store, "a3", chips=8, queue="team-a", priority="batch",
              age_seconds=8)
    sched._admit()
    assert phase_of(store, "a3") == PHASE_INQUEUE  # borrows
    add_group(store, "b2", chips=8, queue="team-b", priority="prod",
              age_seconds=5)
    sched._admit()
    assert phase_of(store, "a3") == PHASE_PENDING
    assert phase_of(store, "b2") == PHASE_INQUEUE


# --- terminal / orphan edges (unit) ----------------------------------------

def test_zero_quota_queue_is_terminal():
    """A queue that can never hold the group (nominal 0, borrowing 0)
    reports a TERMINAL wait — the engine turns it into a Failed
    condition with reason QuotaExceeded rather than queueing forever."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=64)
    add_cluster_queue(store, "cq-zero", nominal=0, borrowing_limit=0)
    add_tenant_queue(store, "team-zero", "cq-zero")
    add_group(store, "z1", chips=8, queue="team-zero")
    sched._admit()
    assert phase_of(store, "z1") == PHASE_PENDING
    wait = wait_of(mgr, "z1")
    assert wait is not None and wait.terminal
    assert "can hold at most 0" in wait.message
    # Terminal groups must not block their lane: a sibling with real
    # quota behind them still admits.
    add_cluster_queue(store, "cq-real", nominal=8)
    add_tenant_queue(store, "team-real", "cq-real")
    add_group(store, "r1", chips=8, queue="team-real")
    sched._admit()
    assert phase_of(store, "r1") == PHASE_INQUEUE


def test_deleted_tenant_queue_requeues_to_default_with_event():
    """TenantQueue deleted with pending groups: the groups fall back to
    the default (quota-exempt) queue and a QueueDeleted event says so —
    once, not per pass."""
    store = Store()
    rec = Recorder()
    sched, mgr = quota_sched(store, total_chips=8, recorder=rec)
    add_cluster_queue(store, "cq-a", nominal=0, borrowing_limit=0)
    tq = add_tenant_queue(store, "team-a", "cq-a")
    add_group(store, "g1", chips=8, queue="team-a")
    sched._admit()
    assert phase_of(store, "g1") == PHASE_PENDING  # zero quota
    store.delete(store_mod.TENANTQUEUES, tq.metadata.namespace,
                 tq.metadata.name)
    sched._admit()
    # Default queue is quota-exempt: the group admits on capacity.
    assert phase_of(store, "g1") == PHASE_INQUEUE
    events = rec.events_for("g1", reason="QueueDeleted")
    assert len(events) == 1
    sched._admit()
    assert len(rec.events_for("g1", reason="QueueDeleted")) == 1


def test_dangling_cluster_queue_waits_non_terminally():
    """A TenantQueue whose ClusterQueue doesn't exist must HOLD its
    groups (not admit them unmetered) but non-terminally — creating
    the ClusterQueue later unblocks them."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=8)
    add_tenant_queue(store, "team-a", "cq-later")
    add_group(store, "g1", chips=8, queue="team-a")
    sched._admit()
    assert phase_of(store, "g1") == PHASE_PENDING
    wait = wait_of(mgr, "g1")
    assert wait is not None and not wait.terminal
    assert "does not exist" in wait.message
    add_cluster_queue(store, "cq-later", nominal=8)
    sched._admit()
    assert phase_of(store, "g1") == PHASE_INQUEUE
    assert wait_of(mgr, "g1") is None


def test_quota_applies_with_capacity_provider_unlimited_flag():
    """Quota gates even when the physical budget is unlimited (the
    total_chips=None observability mode): eligibility is orthogonal to
    fit."""
    store = Store()
    sched, mgr = quota_sched(store, total_chips=None)
    add_cluster_queue(store, "cq-a", nominal=8, borrowing_limit=0)
    add_tenant_queue(store, "team-a", "cq-a")
    add_group(store, "a1", chips=8, queue="team-a", age_seconds=20)
    add_group(store, "a2", chips=8, queue="team-a", age_seconds=10)
    sched._admit()
    assert phase_of(store, "a1") == PHASE_INQUEUE
    assert phase_of(store, "a2") == PHASE_PENDING


# --- config file / seeding -------------------------------------------------

def test_load_queue_config_roundtrip(tmp_path):
    path = tmp_path / "queues.yaml"
    path.write_text("""
clusterQueues:
  - name: pool-a
    nominalChips: 16
    borrowingLimit: 8
    cohort: research
  - name: pool-b
    nominalChips: 8
tenantQueues:
  - name: team-a
    namespace: ns1
    clusterQueue: pool-a
  - name: team-b
    clusterQueue: pool-b
""")
    cqs, tqs = load_queue_config(str(path))
    assert [c.metadata.name for c in cqs] == ["pool-a", "pool-b"]
    assert cqs[0].spec.borrowing_limit == 8
    assert cqs[0].spec.cohort == "research"
    # Defaults applied: cohort-of-one, reclaim Any.
    assert cqs[1].spec.cohort == "pool-b"
    assert cqs[1].spec.reclaim_policy == ReclaimPolicy.ANY
    assert cqs[1].spec.borrowing_limit is None
    assert [(t.metadata.namespace, t.metadata.name) for t in tqs] == [
        ("ns1", "team-a"), ("default", "team-b")]

    store = Store()
    seed_queues(store, cqs, tqs)
    seed_queues(store, cqs, tqs)  # idempotent
    assert store.count(store_mod.CLUSTERQUEUES) == 2
    assert store.count(store_mod.TENANTQUEUES) == 2


def test_load_queue_config_rejects_unknown_and_invalid(tmp_path):
    bad_key = tmp_path / "bad_key.yaml"
    bad_key.write_text("clusterQueues:\n  - name: a\n    nominalChip: 4\n")
    with pytest.raises(ValueError, match="nominalChip"):
        load_queue_config(str(bad_key))
    bad_ref = tmp_path / "bad_ref.yaml"
    bad_ref.write_text("tenantQueues:\n  - name: team-a\n")
    with pytest.raises(ValidationError, match="clusterQueue"):
        load_queue_config(str(bad_ref))
    bad_policy = tmp_path / "bad_policy.yaml"
    bad_policy.write_text("clusterQueues:\n  - name: a\n"
                          "    reclaimPolicy: Sometimes\n")
    with pytest.raises(ValidationError, match="reclaimPolicy"):
        load_queue_config(str(bad_policy))


def test_operator_requires_gang_scheduling_for_tenant_queues():
    with pytest.raises(ValueError, match="gang"):
        Operator(enable_tenant_queues=True, backend=None)


# --- e2e: full local operator ----------------------------------------------

def stub_command(*args):
    return [sys.executable, "-m", "tf_operator_tpu_torch.runtime.worker_stub",
            *args]


def queue_job(name, stub_dir, chips=8, queue="", args=()):
    spec = ReplicaSpec(
        replicas=1,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME,
            command=stub_command(*args),
            env={"TPUJOB_STUB_DIR": stub_dir},
        )])))
    job = TPUJob(metadata=ObjectMeta(name=name),
                 spec=TPUJobSpec(replica_specs={"worker": spec}))
    job.spec.slice.accelerator = f"h100-{chips}"
    job.spec.queue_name = queue
    job.spec.run_policy.clean_pod_policy = "None"
    return job


def tell(stub_dir, pod_name, command):
    os.makedirs(stub_dir, exist_ok=True)
    tmp = os.path.join(stub_dir, f".{pod_name}.cmd.tmp")
    with open(tmp, "w") as f:
        f.write(command)
    os.replace(tmp, os.path.join(stub_dir, f"{pod_name}.cmd"))


def wait_for(predicate, timeout=20.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    pytest.fail(f"timed out waiting for {message}")


def tenant_operator(total_chips, queues):
    """Operator.local with tenant queues on; ``queues`` is
    {tenant: (cluster_queue, nominal, borrowing_limit, cohort)}."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=total_chips,
                        enable_tenant_queues=True)
    for tenant, (cqn, nominal, bl, cohort) in queues.items():
        if op.store.try_get(store_mod.CLUSTERQUEUES, "", cqn) is None:
            add_cluster_queue(op.store, cqn, nominal=nominal,
                              borrowing_limit=bl, cohort=cohort)
        add_tenant_queue(op.store, tenant, cqn)
    return op


def test_e2e_two_tenants_one_cohort_quota_wait_and_release(tmp_path):
    """The acceptance arc minus reclaim: tenant A exceeds its quota and
    its second job carries QueuedWaitingForQuota while tenant B's job
    admits and runs; when A's first job finishes, the queued job admits
    and the Queued condition resolves to False."""
    op = tenant_operator(16, {
        "team-a": ("cq-a", 8, 0, "pool"),
        "team-b": ("cq-b", 8, 0, "pool"),
    })
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        client.create(queue_job("a1", stub_dir, chips=8, queue="team-a"))
        client.create(queue_job("a2", stub_dir, chips=8, queue="team-a"))
        client.create(queue_job("b1", stub_dir, chips=8, queue="team-b",
                                args=("--exit-after", "0.3")))

        # b1 admits and completes despite a2 queueing ahead of it.
        job = client.wait_for_job("b1", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)

        # a1 runs; a2 is quota-held with a live Queued condition.
        wait_for(lambda: any(p.status.phase == "Running"
                             for p in client.get_pods("a1")),
                 message="a1 running")
        wait_for(lambda: testutil.check_condition(
            client.get("a2"), JobConditionType.QUEUED,
            reason="QueuedWaitingForQuota"), message="a2 Queued condition")
        assert not any(p.status.phase == "Running"
                       for p in client.get_pods("a2"))

        # a1 finishes -> its chips return -> a2 admits, Queued resolves.
        tell(stub_dir, "a1-worker-0", "exit:0")
        client.wait_for_job("a1", timeout=30)
        wait_for(lambda: any(p.status.phase == "Running"
                             for p in client.get_pods("a2")),
                 timeout=30, message="a2 admitted after a1 freed quota")
        wait_for(lambda: testutil.get_condition(
            client.get("a2"), JobConditionType.QUEUED).status == "False",
            timeout=30, message="a2 Queued condition resolved to False")
        tell(stub_dir, "a2-worker-0", "exit:0")
        job = client.wait_for_job("a2", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    finally:
        op.stop()


def test_e2e_reclaim_preemption_evicts_borrowers_running_pods(tmp_path):
    """Full reclaim arc with real processes: tenant A borrows B's idle
    nominal share and RUNS on it; B's job arrives, the borrowed gang is
    displaced (its pod actually dies), B runs to completion on its
    reclaimed share, and the borrower re-admits afterwards."""
    op = tenant_operator(16, {
        "team-a": ("cq-a", 8, None, "pool"),
        "team-b": ("cq-b", 8, None, "pool"),
    })
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        client.create(queue_job("a1", stub_dir, chips=8, queue="team-a"))
        client.create(queue_job("a2", stub_dir, chips=8, queue="team-a"))
        # Both run: a2 on borrowed capacity.
        for name in ("a1", "a2"):
            wait_for(lambda n=name: any(
                p.status.phase == "Running"
                for p in client.get_pods(n)), message=f"{name} running")

        client.create(queue_job("b1", stub_dir, chips=8, queue="team-b",
                                args=("--exit-after", "0.5")))
        # The borrower's pod is evicted for the reclaim...
        wait_for(lambda: all(p.status.phase == "Pending"
                             for p in client.get_pods("a2")),
                 timeout=30, message="borrower a2 evicted")
        assert phase_of(op.store, "a1") in (PHASE_INQUEUE, PHASE_RUNNING)
        # ...and the demander completes on its reclaimed nominal share.
        job = client.wait_for_job("b1", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
        assert op.recorder.events_for("a2", reason="QuotaReclaimed")

        # Cohort idle again: the borrower re-admits and converges.
        wait_for(lambda: any(p.status.phase == "Running"
                             for p in client.get_pods("a2")),
                 timeout=30, message="borrower re-admitted")
        for name in ("a1", "a2"):
            tell(stub_dir, f"{name}-worker-0", "exit:0")
            job = client.wait_for_job(name, timeout=30)
            assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    finally:
        op.stop()


def test_e2e_zero_quota_queue_fails_job_terminally(tmp_path):
    op = tenant_operator(16, {"team-zero": ("cq-zero", 0, 0, "solo")})
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        client.create(queue_job("doomed", stub_dir, chips=8,
                                queue="team-zero"))
        job = client.wait_for_job("doomed", timeout=30)
        failed = testutil.get_condition(job, JobConditionType.FAILED)
        assert failed is not None and failed.reason == "QuotaExceeded"
        assert client.get_pods("doomed") == []
    finally:
        op.stop()


def test_e2e_queue_name_inert_without_tenant_queues(tmp_path):
    """Flag off = today's behavior: spec.queueName rides along as a
    fairness lane but nothing is metered and no Queued condition ever
    appears."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=8)
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        client.create(queue_job("plain", stub_dir, chips=8,
                                queue="team-a",
                                args=("--exit-after", "0.3")))
        job = client.wait_for_job("plain", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
        assert testutil.get_condition(job, JobConditionType.QUEUED) is None
        group_phases = [g.status.phase for g in
                        op.store.list(store_mod.SLICEGROUPS)]
        assert PHASE_PENDING not in group_phases
    finally:
        op.stop()


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
