"""Copy of ``tests/test_gang_admission.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Gang admission matrix: priority, queues, quotas, aging, preemption.

Unit-level coverage of every `SliceGangScheduler._admit` branch plus
e2e preemption where a victim group's pods are *actually evicted* (the
round-3 flaw: preemption flipped phase but running pods survived and
chips double-booked). Reference semantics: Volcano PodGroup admission
driven by the fields the reference forwards
(common/pkg/apis/common/v1/types.go:189-204 queue/priorityClassName/
minMember; common/job_controller.go:218-245 SyncPodGroup).
"""

import datetime as dt
import os
import sys
import time

import pytest

from tf_operator_tpu_torch.api.types import (
    Container,
    JobConditionType,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    SchedulingPolicy,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.controller.gang import (
    PHASE_INQUEUE,
    PHASE_PENDING,
    PHASE_RUNNING,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.store import Store
from tf_operator_tpu_torch.sdk import TPUJobClient

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _now():
    return dt.datetime.now(dt.timezone.utc)


def add_group(store, name, chips=8, queue="", priority="", phase=PHASE_PENDING,
              age_seconds=0.0, min_member=1):
    """Create a SliceGroup directly (what sync_slice_group would build)."""
    group = SliceGroup(
        spec=SliceGroupSpec(min_member=min_member, queue=queue,
                            priority_class=priority,
                            slice=TPUSliceSpec(accelerator=f"h100-{chips}")),
        status=SliceGroupStatus(
            phase=phase,
            pending_since=_now() - dt.timedelta(seconds=age_seconds)))
    group.metadata.name = name
    group.metadata.namespace = "default"
    # Older groups sort first on the FIFO tiebreak.
    group.metadata.creation_timestamp = \
        _now() - dt.timedelta(seconds=age_seconds)
    store.create(store_mod.SLICEGROUPS, group)
    return group


def phase_of(store, name):
    return store.get(store_mod.SLICEGROUPS, "default", name).status.phase


# --- priority ordering ----------------------------------------------------

def test_priority_admits_higher_first_despite_fifo():
    """A younger high-priority group beats an older low-priority one to
    the last chips (priority desc outranks creation asc)."""
    store = Store()
    sched = SliceGangScheduler(store, total_chips=8,
                               priority_classes={"prod": 100, "batch": 10})
    add_group(store, "old-batch", chips=8, priority="batch", age_seconds=60)
    add_group(store, "new-prod", chips=8, priority="prod", age_seconds=0)
    sched._admit()
    assert phase_of(store, "new-prod") == PHASE_INQUEUE
    assert phase_of(store, "old-batch") == PHASE_PENDING


def test_numeric_priority_class_is_its_own_value():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=8)
    add_group(store, "low", chips=8, priority="1", age_seconds=60)
    add_group(store, "high", chips=8, priority="50")
    sched._admit()
    assert phase_of(store, "high") == PHASE_INQUEUE
    assert phase_of(store, "low") == PHASE_PENDING


def test_unknown_priority_class_treated_as_zero():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=8,
                               priority_classes={"prod": 100})
    add_group(store, "mystery", chips=8, priority="no-such-class",
              age_seconds=60)
    add_group(store, "prod", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "prod") == PHASE_INQUEUE
    assert phase_of(store, "mystery") == PHASE_PENDING


def test_equal_priority_fifo_tiebreak():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=8)
    add_group(store, "younger", chips=8, age_seconds=1)
    add_group(store, "older", chips=8, age_seconds=60)
    sched._admit()
    assert phase_of(store, "older") == PHASE_INQUEUE
    assert phase_of(store, "younger") == PHASE_PENDING


# --- aged fairness × priority --------------------------------------------

def test_aged_grace_blocks_lower_priority_backfill_only():
    """While a skipped group waits in grace, equal-priority groups may
    backfill its lane; strictly lower-priority ones may not (no priority
    inversion against the waiting group)."""
    store = Store()
    sched = SliceGangScheduler(store, total_chips=10, fairness="aged",
                               aging_seconds=300,
                               priority_classes={"prod": 100, "batch": 10})
    add_group(store, "running", chips=8, phase=PHASE_INQUEUE)
    add_group(store, "waiting-prod", chips=8, priority="prod", age_seconds=5)
    add_group(store, "small-batch", chips=2, priority="batch")
    add_group(store, "small-prod", chips=2, priority="prod")
    sched._admit()
    assert phase_of(store, "waiting-prod") == PHASE_PENDING  # doesn't fit
    assert phase_of(store, "small-prod") == PHASE_INQUEUE    # equal pri: ok
    assert phase_of(store, "small-batch") == PHASE_PENDING   # lower pri: no


def test_aged_out_group_reserves_global_capacity_cross_queue():
    """Advisor r3 finding: an aged-out group blocks only its own lane,
    but the chip budget is global — without a reservation, backfill from
    *another queue* keeps eating freed capacity and starves it. The
    aged-out group must hold its chips out of the global pool."""
    store = Store()
    sched = SliceGangScheduler(store, total_chips=10, fairness="aged",
                               aging_seconds=10)
    add_group(store, "running", chips=6, phase=PHASE_INQUEUE, queue="a")
    # Aged out (waited >> aging_seconds) in queue "a": needs 8, only 4 free.
    add_group(store, "starved", chips=8, queue="a", age_seconds=600)
    # Fresh group in queue "b" that would fit the 4 free chips.
    add_group(store, "greedy", chips=4, queue="b")
    sched._admit()
    assert phase_of(store, "starved") == PHASE_PENDING
    # Without the reservation this would admit and re-starve "starved".
    assert phase_of(store, "greedy") == PHASE_PENDING


def test_aged_within_grace_allows_backfill():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=10, fairness="aged",
                               aging_seconds=300)
    add_group(store, "running", chips=6, phase=PHASE_INQUEUE)
    add_group(store, "waiting", chips=8, age_seconds=5)  # within grace
    add_group(store, "small", chips=4)
    sched._admit()
    assert phase_of(store, "small") == PHASE_INQUEUE  # backfill allowed


# --- strict fairness / queue lanes ---------------------------------------

def test_strict_head_of_line_blocks_own_queue_only():
    """Strict head-of-line: a non-fitting head stalls its own queue, but
    other queues keep admitting (lane isolation)."""
    store = Store()
    sched = SliceGangScheduler(store, total_chips=10, fairness="strict")
    add_group(store, "running", chips=6, phase=PHASE_INQUEUE, queue="a")
    add_group(store, "head-a", chips=8, queue="a", age_seconds=60)
    add_group(store, "behind-a", chips=2, queue="a", age_seconds=30)
    add_group(store, "other-b", chips=2, queue="b")
    sched._admit()
    assert phase_of(store, "head-a") == PHASE_PENDING
    assert phase_of(store, "behind-a") == PHASE_PENDING  # lane blocked
    assert phase_of(store, "other-b") == PHASE_INQUEUE   # lane isolated


def test_backfill_mode_skips_without_blocking():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=10, fairness="backfill")
    add_group(store, "running", chips=6, phase=PHASE_INQUEUE)
    add_group(store, "big", chips=8, age_seconds=600)
    add_group(store, "small", chips=4)
    sched._admit()
    assert phase_of(store, "big") == PHASE_PENDING
    assert phase_of(store, "small") == PHASE_INQUEUE


# --- queue quotas ---------------------------------------------------------

def test_queue_quota_caps_concurrent_chips():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=100,
                               queue_quotas={"batch": 8})
    add_group(store, "b1", chips=8, queue="batch", age_seconds=10)
    add_group(store, "b2", chips=8, queue="batch")
    add_group(store, "free", chips=8, queue="other")
    sched._admit()
    assert phase_of(store, "b1") == PHASE_INQUEUE
    assert phase_of(store, "b2") == PHASE_PENDING  # quota full
    assert phase_of(store, "free") == PHASE_INQUEUE  # unquota'd queue


def test_group_larger_than_quota_is_infeasible_not_blocking():
    """A group that can NEVER fit its queue quota is skipped (warned
    once) and must not stall the lane behind it."""
    store = Store()
    sched = SliceGangScheduler(store, total_chips=100, fairness="strict",
                               queue_quotas={"batch": 8})
    add_group(store, "whale", chips=16, queue="batch", age_seconds=60)
    add_group(store, "ok", chips=8, queue="batch")
    sched._admit()
    assert phase_of(store, "whale") == PHASE_PENDING
    assert phase_of(store, "ok") == PHASE_INQUEUE


def test_group_larger_than_cluster_is_infeasible_not_blocking():
    store = Store()
    sched = SliceGangScheduler(store, total_chips=8, fairness="strict")
    add_group(store, "whale", chips=16, age_seconds=60)
    add_group(store, "ok", chips=8)
    sched._admit()
    assert phase_of(store, "whale") == PHASE_PENDING
    assert phase_of(store, "ok") == PHASE_INQUEUE


# --- preemption -----------------------------------------------------------

def _preempt_sched(store, **kw):
    kw.setdefault("total_chips", 8)
    kw.setdefault("preemption", True)
    kw.setdefault("priority_classes", {"prod": 100, "batch": 10, "low": 1})
    return SliceGangScheduler(store, **kw)


def test_preemption_evicts_lower_priority_inqueue():
    store = Store()
    sched = _preempt_sched(store)
    add_group(store, "victim", chips=8, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert phase_of(store, "victim") == PHASE_PENDING


def test_preemption_never_evicts_running():
    store = Store()
    sched = _preempt_sched(store)
    add_group(store, "running", chips=8, priority="batch",
              phase=PHASE_RUNNING, age_seconds=60)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "running") == PHASE_RUNNING
    assert phase_of(store, "preemptor") == PHASE_PENDING


def test_preemption_never_evicts_equal_priority():
    store = Store()
    sched = _preempt_sched(store)
    add_group(store, "peer", chips=8, priority="prod",
              phase=PHASE_INQUEUE, age_seconds=60)
    add_group(store, "late-peer", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "peer") == PHASE_INQUEUE
    assert phase_of(store, "late-peer") == PHASE_PENDING


def test_preemption_chooses_lowest_priority_youngest_first():
    store = Store()
    sched = _preempt_sched(store, total_chips=12)
    add_group(store, "batch-old", chips=4, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    add_group(store, "batch-young", chips=4, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=5)
    add_group(store, "low", chips=4, priority="low",
              phase=PHASE_INQUEUE, age_seconds=120)
    # Needs 8 of 12; 12 in use -> must free 8: evict "low" (lowest
    # priority) then "batch-young" (youngest of the tied class).
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert phase_of(store, "low") == PHASE_PENDING
    assert phase_of(store, "batch-young") == PHASE_PENDING
    assert phase_of(store, "batch-old") == PHASE_INQUEUE


def test_preemption_all_or_nothing_when_eviction_cannot_help():
    """If evicting every eligible victim still wouldn't fit the
    preemptor, nothing is evicted (no pointless churn)."""
    store = Store()
    sched = _preempt_sched(store, total_chips=8)
    add_group(store, "running", chips=6, priority="prod",
              phase=PHASE_RUNNING)
    add_group(store, "small-victim", chips=2, priority="batch",
              phase=PHASE_INQUEUE)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    # 6 chips are held by a Running prod group; evicting the 2-chip
    # victim frees only 2 -> 8 never fits -> victim survives.
    assert phase_of(store, "small-victim") == PHASE_INQUEUE
    assert phase_of(store, "preemptor") == PHASE_PENDING


def test_preemption_resets_pending_since():
    store = Store()
    sched = _preempt_sched(store)
    v = add_group(store, "victim", chips=8, priority="batch",
                  phase=PHASE_INQUEUE, age_seconds=600)
    old_since = v.status.pending_since
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    fresh = store.get(store_mod.SLICEGROUPS, "default", "victim")
    assert fresh.status.pending_since > old_since  # fresh grace window


def test_preemption_deletes_victim_pods_then_admits_preemptor():
    """Eviction is real and level-triggered: pass 1 flips the victim
    Pending and deletes its live pods (unbound pod_control falls back
    to store deletes) while the victim's chips stay counted — the
    preemptor must NOT land on still-occupied chips; pass 2 (triggered
    by the pods' DELETED events in the real loop) admits the preemptor
    onto the confirmed-free chips."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store)
    add_group(store, "victim", chips=8, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    for i in range(2):
        pod = Pod(metadata=ObjectMeta(
            name=f"victim-worker-{i}", namespace="default",
            labels={constants.LABEL_JOB_NAME: "victim"}))
        pod.status = PodStatus(phase="Running")  # past the gate
        store.create(store_mod.PODS, pod)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "victim") == PHASE_PENDING
    left = store.list(store_mod.PODS, namespace="default")
    assert left == [], [p.metadata.name for p in left]
    # Chips were still held by the mid-eviction victim during pass 1.
    assert phase_of(store, "preemptor") == PHASE_PENDING
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE


def test_preemption_never_evicts_terminal_pods():
    """Succeeded pods hold no chips and carry the completion record —
    eviction must leave them alone (deleting one would re-run finished
    work on re-admission)."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store)
    add_group(store, "victim", chips=8, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    done = Pod(metadata=ObjectMeta(
        name="victim-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "victim"}))
    done.status = PodStatus(phase="Succeeded")
    store.create(store_mod.PODS, done)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "victim") == PHASE_PENDING
    # No live pods -> chips freed immediately, preemptor admits pass 1,
    # and the Succeeded pod survives.
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert [p.metadata.name
            for p in store.list(store_mod.PODS, namespace="default")] \
        == ["victim-worker-0"]


def test_failed_eviction_retries_and_never_double_books():
    """Advisor r3 core flaw, pinned: if a victim pod delete FAILS, the
    victim's chips must stay counted (no admission on occupied chips)
    and the delete must retry until it lands."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store)

    class FlakyControl:
        def __init__(self):
            self.calls = 0

        def delete_pod(self, ns, name, job):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("injected API timeout")
            store.try_delete(store_mod.PODS, ns, name)

    sched.pod_control = FlakyControl()
    add_group(store, "victim", chips=8, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    job = TPUJob(metadata=ObjectMeta(name="victim", namespace="default"),
                 spec=TPUJobSpec(replica_specs={}))
    store.create(store_mod.TPUJOBS, job)
    pod = Pod(metadata=ObjectMeta(
        name="victim-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "victim"}))
    pod.status = PodStatus(phase="Running")  # past the gate
    store.create(store_mod.PODS, pod)
    add_group(store, "preemptor", chips=8, priority="prod")

    sched._admit()  # delete fails -> victim still mid-eviction
    assert phase_of(store, "victim") == PHASE_PENDING
    assert len(store.list(store_mod.PODS, namespace="default")) == 1
    assert phase_of(store, "preemptor") == PHASE_PENDING  # chips held
    sched._admit()  # retry succeeds; chips stay held this pass
    assert store.list(store_mod.PODS, namespace="default") == []
    assert phase_of(store, "preemptor") == PHASE_PENDING
    sched._admit()  # eviction confirmed -> preemptor admits
    assert phase_of(store, "preemptor") == PHASE_INQUEUE


def test_preemption_quota_tight_prefers_same_queue_victims():
    """When only the queue quota (not the global budget) is violated,
    evicting a foreign-queue group frees nothing useful — victims must
    come from the preemptor's own queue."""
    store = Store()
    sched = _preempt_sched(store, total_chips=100,
                           queue_quotas={"q": 8})
    add_group(store, "foreign", chips=8, priority="low",
              phase=PHASE_INQUEUE, queue="other", age_seconds=60)
    add_group(store, "same-q", chips=8, priority="batch",
              phase=PHASE_INQUEUE, queue="q", age_seconds=30)
    add_group(store, "preemptor", chips=8, priority="prod", queue="q")
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert phase_of(store, "same-q") == PHASE_PENDING
    assert phase_of(store, "foreign") == PHASE_INQUEUE  # untouched


def test_aged_reservation_not_stolen_via_preemption():
    """A preemptor may not satisfy itself out of chips reserved for an
    aged-out group (the reservation is as hard as used capacity)."""
    store = Store()
    sched = _preempt_sched(store, total_chips=12, fairness="aged",
                           aging_seconds=10)
    add_group(store, "running", chips=6, priority="prod",
              phase=PHASE_RUNNING, queue="a")
    # Aged out: needs 8, only 6 free -> blocks lane "a", reserves 8...
    # (12 - 6 used = 6 < 8) -> reservation holds 8 against the budget.
    add_group(store, "starved", chips=8, queue="a", priority="prod",
              age_seconds=600)
    # batch group in queue "b" needing 4: 6 free minus 8 reserved -> no
    # capacity; and preemption finds no lower-priority Inqueue victims.
    add_group(store, "greedy", chips=4, queue="b", priority="batch")
    sched._admit()
    assert phase_of(store, "starved") == PHASE_PENDING
    assert phase_of(store, "greedy") == PHASE_PENDING


def test_evicted_victim_not_readmitted_in_same_pass():
    """A victim flipped Pending mid-pass must not be re-admitted later
    in the same admission walk onto the chips it just gave up (it sorts
    after the higher-priority preemptor) — otherwise eviction and
    re-admission livelock: the victim's gang is repeatedly killed while
    the preemptor never fits."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store, total_chips=16, fairness="backfill")
    add_group(store, "w-podless", chips=8, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    add_group(store, "v-running", chips=4, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=30)
    pod = Pod(metadata=ObjectMeta(
        name="v-running-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "v-running"}))
    pod.status = PodStatus(phase="Running")
    store.create(store_mod.PODS, pod)
    add_group(store, "preemptor", chips=16, priority="prod")
    sched._admit()
    # Both victims preempted; v-running's chips held pending eviction,
    # so the preemptor can't fit yet — and neither victim re-admits.
    assert phase_of(store, "preemptor") == PHASE_PENDING
    assert phase_of(store, "w-podless") == PHASE_PENDING
    assert phase_of(store, "v-running") == PHASE_PENDING
    assert store.list(store_mod.PODS, namespace="default") == []
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert phase_of(store, "w-podless") == PHASE_PENDING
    assert phase_of(store, "v-running") == PHASE_PENDING


def test_preempted_capacity_earmarked_for_preemptor():
    """Chips freed (or being freed) by a preemption belong to the
    preemptor that paid for them: a lower-priority group later in the
    same pass must not admit onto them, else the victims died for
    nothing and the preemptor must kill again next pass."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store, total_chips=8, fairness="backfill")
    add_group(store, "v-running", chips=4, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    pod = Pod(metadata=ObjectMeta(
        name="v-running-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "v-running"}))
    pod.status = PodStatus(phase="Running")
    store.create(store_mod.PODS, pod)
    add_group(store, "w-podless", chips=4, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=30)
    add_group(store, "preemptor", chips=8, priority="prod")
    add_group(store, "lowrider", chips=4, priority="low", queue="other")
    sched._admit()
    # Both victims flipped; W's 4 chips freed instantly but are
    # earmarked for the preemptor — the low-priority group gets nothing.
    assert phase_of(store, "preemptor") == PHASE_PENDING  # V in flight
    assert phase_of(store, "lowrider") == PHASE_PENDING
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert phase_of(store, "lowrider") == PHASE_PENDING


def test_no_over_preemption_while_eviction_in_flight():
    """If chips already in flight from an earlier eviction will fit the
    preemptor, no additional gang is killed while the deletes land."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store, total_chips=12)
    # Mid-eviction victim: Pending with a Running pod (4 chips inbound).
    add_group(store, "v-dying", chips=4, priority="low",
              phase=PHASE_PENDING, age_seconds=60)
    pod = Pod(metadata=ObjectMeta(
        name="v-dying-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "v-dying"}))
    pod.status = PodStatus(phase="Running")
    store.create(store_mod.PODS, pod)
    # Innocent bystander that would be the next preemption victim.
    add_group(store, "bystander", chips=4, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=30)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    # 4 in flight + 4 free will fit the preemptor: bystander survives.
    assert phase_of(store, "bystander") == PHASE_INQUEUE
    assert phase_of(store, "preemptor") == PHASE_PENDING
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE
    assert phase_of(store, "bystander") == PHASE_INQUEUE


def test_gate_released_pending_pod_occupies_chips():
    """A pod released past the gang gate but not yet written Running
    (mid-spawn) still occupies chips: the data plane stamps
    gang_released before spawning, and preemption both counts and
    evicts it — no admission into the spawn window."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    sched = _preempt_sched(store)
    add_group(store, "victim", chips=8, priority="batch",
              phase=PHASE_INQUEUE, age_seconds=60)
    pod = Pod(metadata=ObjectMeta(
        name="victim-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "victim"}))
    pod.status = PodStatus(phase="Pending", gang_released=True)
    store.create(store_mod.PODS, pod)
    add_group(store, "preemptor", chips=8, priority="prod")
    sched._admit()
    assert phase_of(store, "victim") == PHASE_PENDING
    # Mid-spawn pod held the chips through pass 1 and was evicted.
    assert phase_of(store, "preemptor") == PHASE_PENDING
    assert store.list(store_mod.PODS, namespace="default") == []
    sched._admit()
    assert phase_of(store, "preemptor") == PHASE_INQUEUE


def test_mid_eviction_state_survives_scheduler_restart():
    """Failover safety: mid-eviction is derived from persisted state
    (Pending group + Running pods), not process memory — a brand-new
    scheduler instance must keep the victim's chips counted and finish
    deleting its pods instead of double-booking."""
    from tf_operator_tpu_torch.api.types import Pod, PodStatus

    store = Store()
    # Simulates the old leader dying right after flipping the victim
    # Pending but before deleting its pods.
    add_group(store, "victim", chips=8, priority="batch",
              phase=PHASE_PENDING, age_seconds=1)
    pod = Pod(metadata=ObjectMeta(
        name="victim-worker-0", namespace="default",
        labels={constants.LABEL_JOB_NAME: "victim"}))
    pod.status = PodStatus(phase="Running")
    store.create(store_mod.PODS, pod)
    add_group(store, "newcomer", chips=8, priority="prod")

    fresh = _preempt_sched(store)  # new process: no in-memory state
    fresh._admit()
    # Chips still occupied by the orphaned pods -> newcomer waits, and
    # the new scheduler completes the eviction.
    assert phase_of(store, "newcomer") == PHASE_PENDING
    assert store.list(store_mod.PODS, namespace="default") == []
    fresh._admit()
    assert phase_of(store, "newcomer") == PHASE_INQUEUE


# --- phase sync from pod state -------------------------------------------

def _job_with_status(active, succeeded, min_member=2):
    from tf_operator_tpu_torch.api.types import ReplicaStatus

    job = TPUJob(metadata=ObjectMeta(name="j", namespace="default"),
                 spec=TPUJobSpec(replica_specs={}))
    job.status.replica_statuses = {
        "worker": ReplicaStatus(active=active, succeeded=succeeded)}
    return job


def test_promote_inqueue_to_running_at_min_member():
    store = Store()
    sched = SliceGangScheduler(store)
    g = add_group(store, "j", phase=PHASE_INQUEUE, min_member=2)
    sched._maybe_promote_running(g, _job_with_status(active=2, succeeded=0))
    assert phase_of(store, "j") == PHASE_RUNNING


def test_demote_running_below_min_member():
    """Advisor r3: a Running group whose pods die must not stay latched
    Running (and thus unpreemptible) forever."""
    store = Store()
    sched = SliceGangScheduler(store)
    g = add_group(store, "j", phase=PHASE_RUNNING, min_member=2)
    sched._maybe_promote_running(g, _job_with_status(active=1, succeeded=0))
    assert phase_of(store, "j") == PHASE_INQUEUE


def test_succeeded_pods_count_toward_gang_liveness():
    store = Store()
    sched = SliceGangScheduler(store)
    g = add_group(store, "j", phase=PHASE_INQUEUE, min_member=2)
    sched._maybe_promote_running(g, _job_with_status(active=1, succeeded=1))
    assert phase_of(store, "j") == PHASE_RUNNING


# --- e2e: preempted pods actually die ------------------------------------

def stub_command(*args):
    return [sys.executable, "-m", "tf_operator_tpu_torch.runtime.worker_stub",
            *args]


def gang_job(name, stub_dir, chips=8, priority="", min_available=None,
             args=()):
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
    sp = SchedulingPolicy(priority_class=priority)
    if min_available is not None:
        sp.min_available = min_available
    job.spec.run_policy.scheduling_policy = sp
    job.spec.run_policy.clean_pod_policy = "None"
    return job


def tell(stub_dir, pod_name, command):
    os.makedirs(stub_dir, exist_ok=True)
    tmp = os.path.join(stub_dir, f".{pod_name}.cmd.tmp")
    with open(tmp, "w") as f:
        f.write(command)
    os.replace(tmp, os.path.join(stub_dir, f"{pod_name}.cmd"))


def wait_for(predicate, timeout=15.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    pytest.fail(f"timed out waiting for {message}")


def test_e2e_preemption_evicts_running_victim_pods(tmp_path):
    """Over-subscribe with preemption on: the victim group's pod has
    passed the admission gate and is RUNNING; a higher-priority job
    arrives, the victim's pod is killed (not just re-phased), the
    preemptor runs to completion on the freed chips, and the victim is
    then re-admitted and converges to success — capacity never
    double-books. min_available=2 > replicas=1 keeps the victim
    deliberately in Inqueue (never 'fully up'), the preemptible set."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=8, gang_preemption=True,
                        gang_priority_classes={"prod": 100, "batch": 10})
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")

        client.create(gang_job("victim", stub_dir, chips=8,
                               priority="batch", min_available=2))
        # Victim's pod passes the gate and actually runs.
        wait_for(lambda: any(
            p.status.phase == "Running"
            for p in client.get_pods("victim")), message="victim running")
        group = op.store.get(store_mod.SLICEGROUPS, "default", "victim")
        assert group.status.phase == PHASE_INQUEUE  # preemptible

        client.create(gang_job("preemptor", stub_dir, chips=8,
                               priority="prod",
                               args=("--exit-after", "0.5")))
        # The victim's running pod must actually die and re-gate.
        wait_for(lambda: all(
            p.status.phase == "Pending"
            for p in client.get_pods("victim")),
            message="victim pods evicted back to Pending")
        assert op.store.get(store_mod.SLICEGROUPS, "default",
                            "victim").status.phase == PHASE_PENDING

        # Preemptor completes on the freed chips.
        job = client.wait_for_job("preemptor", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)

        # Victim re-admits once the chips free up, runs again, converges.
        wait_for(lambda: any(
            p.status.phase == "Running"
            for p in client.get_pods("victim")),
            timeout=30, message="victim re-admitted and running")
        tell(stub_dir, "victim-worker-0", "exit:0")
        job = client.wait_for_job("victim", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    finally:
        op.stop()


def test_preemptor_spawns_only_after_victim_exits(tmp_path):
    """Round-5 overlap pin (round-4 Weak #6): the victim's store
    delete precedes its processes' exit by up to the termination grace.
    The draining gate (LocalProcessBackend.draining_gang_groups wired
    into the scheduler) must keep the victim's chips counted through
    that window, so the preemptor's process SPAWNS strictly after the
    victim's process EXITED — measured with wall-clock markers written
    by the processes themselves."""
    import json as _json

    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=8, gang_preemption=True,
                        gang_priority_classes={"prod": 100, "batch": 10})
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")

        # Victim dies SLOWLY: 0.8 s between SIGTERM and actual exit.
        client.create(gang_job("victim", stub_dir, chips=8,
                               priority="batch", min_available=2,
                               args=("--term-grace", "0.8")))
        wait_for(lambda: any(p.status.phase == "Running"
                             for p in client.get_pods("victim")),
                 message="victim running")
        # Running is written at spawn; wait for the stub to be FULLY up
        # (env snapshot published => its SIGTERM handler is installed),
        # or the eviction could kill a half-started interpreter.
        wait_for(lambda: os.path.exists(os.path.join(
            stub_dir, "victim-worker-0.env.json")),
            message="victim stub fully started")

        client.create(gang_job("preemptor", stub_dir, chips=8,
                               priority="prod",
                               args=("--exit-after", "0.3")))
        job = client.wait_for_job("preemptor", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)

        exited_path = os.path.join(stub_dir, "victim-worker-0.exited")
        assert os.path.exists(exited_path), \
            "victim never wrote its graceful-exit marker (SIGKILLed?)"
        with open(exited_path) as f:
            victim_exit = _json.load(f)["exited_at"]
        # The preemptor's env snapshot is written at process startup;
        # its mtime is the spawn-side timestamp on the same clock.
        spawn_path = os.path.join(stub_dir, "preemptor-worker-0.env.json")
        preemptor_spawn = os.stat(spawn_path).st_mtime
        assert preemptor_spawn >= victim_exit, (
            f"preemptor spawned {victim_exit - preemptor_spawn:.3f}s "
            "INSIDE the victim's termination-grace window")
    finally:
        op.stop()


def test_successor_waits_for_deleted_jobs_dying_processes(tmp_path):
    """The drain gate must also cover plain JOB DELETION (not just
    preemption): deleting a running gang removes its SliceGroup and
    re-runs admission instantly, while its processes sit in the
    termination grace. A queued successor must not spawn until they
    actually exited — the dying chips stay booked against the global
    budget via the chip-weighted draining registry."""
    import json as _json

    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=8)
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")

        client.create(gang_job("holder", stub_dir, chips=8,
                               args=("--term-grace", "0.8")))
        wait_for(lambda: any(p.status.phase == "Running"
                             for p in client.get_pods("holder")),
                 message="holder running")
        wait_for(lambda: os.path.exists(os.path.join(
            stub_dir, "holder-worker-0.env.json")),
            message="holder stub fully started")

        # Successor queued behind the full cluster, then the holder's
        # JOB is deleted (not preempted).
        client.create(gang_job("succ", stub_dir, chips=8,
                               args=("--exit-after", "0.3")))
        time.sleep(0.3)  # successor visibly gated first
        assert all(p.status.phase == "Pending"
                   for p in client.get_pods("succ"))
        client.delete("holder")

        job = client.wait_for_job("succ", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)

        exited_path = os.path.join(stub_dir, "holder-worker-0.exited")
        assert os.path.exists(exited_path), \
            "holder never wrote its graceful-exit marker"
        with open(exited_path) as f:
            holder_exit = _json.load(f)["exited_at"]
        succ_spawn = os.stat(os.path.join(
            stub_dir, "succ-worker-0.env.json")).st_mtime
        assert succ_spawn >= holder_exit, (
            f"successor spawned {holder_exit - succ_spawn:.3f}s inside "
            "the deleted holder's termination-grace window")
    finally:
        op.stop()


def test_e2e_no_preemption_flag_means_no_eviction(tmp_path):
    """Without --gang-preemption the high-priority job waits instead of
    evicting (preemption is opt-in, as in Volcano)."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=8,
                        gang_priority_classes={"prod": 100, "batch": 10})
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        client.create(gang_job("holder", stub_dir, chips=8,
                               priority="batch", min_available=2))
        wait_for(lambda: any(p.status.phase == "Running"
                             for p in client.get_pods("holder")),
                 message="holder running")
        client.create(gang_job("prio", stub_dir, chips=8, priority="prod",
                               args=("--exit-after", "0.3")))
        time.sleep(0.8)
        pods = client.get_pods("prio")
        assert pods and all(p.status.phase == "Pending" for p in pods)
        assert any(p.status.phase == "Running"
                   for p in client.get_pods("holder"))
        tell(stub_dir, "holder-worker-0", "exit:0")
        client.wait_for_job("holder", timeout=30)
        job = client.wait_for_job("prio", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    finally:
        op.stop()

# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
