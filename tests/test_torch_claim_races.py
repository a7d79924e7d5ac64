"""Claim semantics and seeded claim races through the port's operator,
held to the JAX package's ``tests/test_claim_races.py`` (same scenarios,
same seeds, same invariants).

Deterministic tests pin the release path; the randomised ones drive
seeded interleavings of create, delete, fail, relabel and orphan
injection against a live ``GPUJobController`` (watch handlers,
workqueue, expectations all running), once with prompt watch delivery
and once with jittered delivery, and assert:

- exactly one pod a replica index, each owned by the job;
- a pod whose labels stop matching is released (its ownerReference
  dropped), never deleted by the releasing controller;
- no pod is ever owned by two controllers;
- another job's pods are never touched.

Two deterministic tests pin the out-of-range rule that the seeded
interleavings found missing (``TestOutOfRangeIndices``).

The waits are twice the JAX test's (convergence 90 s, the foreign-owned
release 60 s and its refill 120 s; others 20 s): the create-name
conflicts of the churn rack up per-key backoff, and the suite runs in six
worker processes.
"""

import queue
import random
import threading
import time

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    ContainerStatus,
    PodPhase,
    RestartPolicy,
)
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.store import Store

pytestmark = pytest.mark.control_plane


def wait_for(cond, timeout=20.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture()
def op():
    operator = Operator(backend=None)  # control plane only: pods stay Pending
    operator.start(threadiness=2)
    yield operator
    operator.stop()


def submit(op, name="rj", worker=2):
    job = testutil.new_tpujob(worker=worker)
    job.metadata.name = name
    return op.store.create(store_mod.TPUJOBS, job)


def job_pods(op, name):
    return [p for p in op.store.list(store_mod.PODS, namespace="default")
            if p.metadata.labels.get(constants.LABEL_JOB_NAME) == name]


def owned_by(pod, job):
    ref = pod.metadata.controller_ref()
    return ref is not None and ref.uid == job.metadata.uid


class TestReleasePath:
    def test_relabeled_pod_is_released_not_deleted(self, op):
        job = submit(op, worker=2)
        wait_for(lambda: len(job_pods(op, "rj")) == 2, msg="pods created")
        pod = op.store.get(store_mod.PODS, "default", "rj-worker-1")
        assert owned_by(pod, job)
        # Its labels stop matching the job's selector.
        pod.metadata.labels[constants.LABEL_JOB_NAME] = "quarantine"
        op.store.update(store_mod.PODS, pod)

        def released():
            p = op.store.try_get(store_mod.PODS, "default", "rj-worker-1")
            return p is not None and p.metadata.controller_ref() is None

        wait_for(released, msg="ownerReference dropped")
        # Release is not delete.
        assert op.store.try_get(store_mod.PODS, "default",
                                "rj-worker-1") is not None

    def test_released_pod_slot_recreates_after_pod_deleted(self, op):
        job = submit(op, worker=1)
        wait_for(lambda: len(job_pods(op, "rj")) == 1, msg="pod created")
        pod = op.store.get(store_mod.PODS, "default", "rj-worker-0")
        pod.metadata.labels[constants.LABEL_JOB_NAME] = "elsewhere"
        op.store.update(store_mod.PODS, pod)
        wait_for(lambda: op.store.get(store_mod.PODS, "default",
                                      "rj-worker-0")
                 .metadata.controller_ref() is None, msg="released")
        # The released pod blocks its name; once it is deleted the
        # controller refills the index with a fresh owned pod.
        op.store.delete(store_mod.PODS, "default", "rj-worker-0")

        def refilled():
            p = op.store.try_get(store_mod.PODS, "default", "rj-worker-0")
            return (p is not None and owned_by(p, job)
                    and p.metadata.labels[constants.LABEL_JOB_NAME] == "rj")

        wait_for(refilled, msg="index refilled with owned pod")

    def test_foreign_owned_pod_left_alone(self, op):
        job_a = submit(op, name="ja", worker=1)
        job_b = submit(op, name="jb", worker=1)
        wait_for(lambda: len(job_pods(op, "ja")) == 1
                 and len(job_pods(op, "jb")) == 1, msg="both jobs up")
        # jb's pod relabelled into ja at index 7, but still owned by jb:
        # ja must not adopt it and jb must release it.
        pod = op.store.get(store_mod.PODS, "default", "jb-worker-0")
        orig_uid = pod.metadata.uid
        pod.metadata.labels[constants.LABEL_JOB_NAME] = "ja"
        pod.metadata.labels[constants.LABEL_REPLICA_INDEX] = "7"
        op.store.update(store_mod.PODS, pod)

        def settled():
            p = op.store.try_get(store_mod.PODS, "default", "jb-worker-0")
            # Legal ends for the original pod: released by jb, gone (ja
            # adopted the orphan and deleted it as out of range), or
            # already replaced by a fresh jb pod.
            if p is None or p.metadata.uid != orig_uid:
                return True
            ref = p.metadata.controller_ref()
            return ref is None or ref.uid != job_b.metadata.uid

        wait_for(settled, timeout=60, msg="jb released its relabeled pod")
        p = op.store.try_get(store_mod.PODS, "default", "jb-worker-0")
        if p is not None and p.metadata.uid == orig_uid:
            op.store.delete(store_mod.PODS, "default", "jb-worker-0")

        def refilled():
            p = op.store.try_get(store_mod.PODS, "default", "jb-worker-0")
            return (p is not None and p.metadata.uid != orig_uid
                    and owned_by(p, job_b)
                    and p.metadata.labels[constants.LABEL_JOB_NAME] == "jb")

        # jb is re-synced only by its own rate-limited requeue, whose
        # name-conflict failures back off up to 30 s.
        wait_for(refilled, timeout=120, msg="jb index refilled")
        ja_pods = [p for p in job_pods(op, "ja") if owned_by(p, job_a)]
        assert [p.metadata.name for p in ja_pods] == ["ja-worker-0"]


class TestClaimRaceInvariants:
    """Seeded random interleavings against the live controller."""

    REPLICAS = 3

    def _converged(self, op, job):
        owned = [p for p in job_pods(op, job.metadata.name)
                 if owned_by(p, job)]
        if len(owned) != self.REPLICAS:
            return False
        indices = sorted(p.metadata.labels.get(constants.LABEL_REPLICA_INDEX)
                         for p in owned)
        return indices == [str(i) for i in range(self.REPLICAS)]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_interleavings_converge(self, op, seed):
        rng = random.Random(seed)
        job = testutil.new_tpujob(worker=self.REPLICAS)
        job.metadata.name = "cr"
        # ExitCode: a retryable failure restarts the replica in place,
        # so there is always a converged state to return to.
        job.spec.replica_specs["worker"].restart_policy = \
            RestartPolicy.EXIT_CODE
        job = op.store.create(store_mod.TPUJOBS, job)
        wait_for(lambda: len(job_pods(op, "cr")) == self.REPLICAS,
                 msg="initial pods")

        for _ in range(10):
            pods = job_pods(op, "cr")
            action = rng.choice(["delete", "fail", "relabel", "orphan",
                                 "pause"])
            if action == "delete" and pods:
                victim = rng.choice(pods)
                op.store.try_delete(store_mod.PODS, "default",
                                    victim.metadata.name)
            elif action == "fail" and pods:
                victim = rng.choice(pods)   # SIGKILL: retryable
                victim.status.phase = PodPhase.FAILED
                victim.status.container_statuses = [ContainerStatus(
                    name=constants.DEFAULT_CONTAINER_NAME,
                    state="Terminated", exit_code=137)]
                try:
                    op.store.update_status(store_mod.PODS, victim)
                except store_mod.NotFoundError:
                    pass
            elif action == "relabel" and pods:
                victim = rng.choice(pods)
                victim.metadata.labels[constants.LABEL_JOB_NAME] = "gone"
                try:
                    op.store.update(store_mod.PODS, victim)
                except (store_mod.ConflictError, store_mod.NotFoundError):
                    pass
                # Free the name so the index can refill.
                time.sleep(rng.uniform(0, 0.05))
                op.store.try_delete(store_mod.PODS, "default",
                                    victim.metadata.name)
            elif action == "orphan":
                # A matching orphan at an out-of-range index: adopted,
                # then deleted by the scale-down.
                idx = self.REPLICAS + rng.randrange(2)
                orphan = testutil.new_pod(job, "worker", idx,
                                          phase=PodPhase.PENDING)
                orphan.metadata.name = f"cr-orphan-{rng.randrange(10**6)}"
                orphan.metadata.owner_references = []
                try:
                    op.store.create(store_mod.PODS, orphan)
                except store_mod.AlreadyExistsError:
                    pass
            time.sleep(rng.uniform(0, 0.05))

        def check_then_converged():
            live = op.store.get(store_mod.TPUJOBS, "default", "cr")
            assert not any(c.type == "Failed" and c.status == "True"
                           for c in live.status.conditions), (
                "retryable failures must not fail the job")
            owned = [p for p in job_pods(op, "cr") if owned_by(p, job)]
            by_index = {}
            for p in owned:
                idx = p.metadata.labels.get(constants.LABEL_REPLICA_INDEX)
                if int(idx) >= self.REPLICAS:
                    continue
                assert idx not in by_index, (
                    f"duplicate replica index {idx}: "
                    f"{by_index[idx]} and {p.metadata.name}")
                by_index[idx] = p.metadata.name
            return self._converged(op, job)

        wait_for(check_then_converged, timeout=90,
                 msg=f"convergence (seed={seed})")

        for p in op.store.list(store_mod.PODS, namespace="default"):
            ctrl_refs = [r for r in p.metadata.owner_references
                         if r.controller]
            assert len(ctrl_refs) <= 1, p.metadata.name


class TestOutOfRangeIndices:
    """Pods at indices past ``replicas`` (an adopted orphan, a scale-down)
    all go, and none is created there. The JAX engine, as the reference's
    ``common/pod.go``, creates a pod in a gap below an adopted pod's
    index and keeps two pods at one such index for good, which the
    delayed-watch seed 1 above reaches under load (``ROADMAP.md`` C)."""

    def _sync(self, extra):
        from tf_operator_tpu_torch.controller.gpu_controller import (
            GPUJobController,
        )

        store = Store()
        controller = GPUJobController(store)
        job = store.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=3))
        for i in range(3):
            store.create(store_mod.PODS, testutil.new_pod(
                job, "worker", i, phase=PodPhase.RUNNING))
        for name, index in extra:
            pod = testutil.new_pod(job, "worker", index,
                                   phase=PodPhase.RUNNING)
            pod.metadata.name = name
            store.create(store_mod.PODS, pod)
        controller.sync_tpujob(job.key())
        return sorted(
            (p.metadata.labels[constants.LABEL_REPLICA_INDEX],
             p.metadata.name) for p in store.list(store_mod.PODS))

    def test_no_pod_is_created_below_an_adopted_out_of_range_index(self):
        left = self._sync([("adopted-4", 4)])
        assert left == [("0", "test-tpujob-worker-0"),
                        ("1", "test-tpujob-worker-1"),
                        ("2", "test-tpujob-worker-2")], left

    def test_two_pods_at_one_out_of_range_index_both_go(self):
        left = self._sync([("adopted-3a", 3), ("adopted-3b", 3)])
        assert [i for i, _ in left] == ["0", "1", "2"], left


class DelayedStore(Store):
    """Store whose watch deliveries lag 0-50 ms each, strictly in order
    (one drain thread): the stale-cache regime expectations exist
    for."""

    def __init__(self, seed: int):
        super().__init__()
        self._rng = random.Random(seed)
        self._delay_q: "queue.Queue" = queue.Queue()
        self._drain = threading.Thread(target=self._drain_loop, daemon=True)
        self._drain.start()

    def _notify(self, kind, event_type, obj):
        self._delay_q.put((self._rng.uniform(0, 0.05), kind, event_type,
                           obj))

    def _drain_loop(self):
        while True:
            delay, kind, event_type, obj = self._delay_q.get()
            time.sleep(delay)
            Store._notify(self, kind, event_type, obj)


class TestDelayedWatchRaces(TestClaimRaceInvariants):
    """The same seeded interleavings with jittered watch delivery: the
    expectation gate, not event order, must prevent duplicate creates."""

    @pytest.fixture()
    def op(self):
        operator = Operator(store=DelayedStore(seed=99), backend=None)
        operator.start(threadiness=2)
        yield operator
        operator.stop()
