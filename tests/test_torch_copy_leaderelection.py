"""Copy of ``tests/test_leaderelection.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Leader election under injected renew failures — the first slice of
ROADMAP item 4's failover arc.

The elector existed but had no coverage for the path that matters at
pod scale: the LEADER's lease renewals start failing (API-server storm,
partition) mid-reconcile, it must step down, a follower must take over
the expired lease, and the handoff must not converge any job twice
(duplicate pod creates, double-counted success) — the single-writer
guarantee leader election exists to provide.
"""

import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from bench_controlplane import NAMESPACE, FakeKubelet  # noqa: E402

from tf_operator_tpu_torch import testutil  # noqa: E402
from tf_operator_tpu_torch.controller import conditions as cond  # noqa: E402
from tf_operator_tpu_torch.controller.gpu_controller import (  # noqa: E402
    GPUJobController,
)
from tf_operator_tpu_torch.runtime import metrics  # noqa: E402
from tf_operator_tpu_torch.runtime import store as store_mod  # noqa: E402
from tf_operator_tpu_torch.runtime.leaderelection import (  # noqa: E402
    LEASES,
    LeaderElector,
    ShardMap,
    shard_for,
    shard_lock_name,
)
from tf_operator_tpu_torch.runtime.retry import TransientAPIError  # noqa: E402
from tf_operator_tpu_torch.runtime.store import Store  # noqa: E402


def wait_for(predicate, timeout=10.0, interval=0.02, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


class FlakyLeaseStore:
    """Store facade for one elector whose LEASE writes can be cut off —
    the injected-renew-failure seam (an API server that stops answering
    this replica's renewals while everything else still works)."""

    def __init__(self, inner: Store):
        self.inner = inner
        self.fail_lease_writes = False

    def try_get(self, kind, ns, name):
        return self.inner.try_get(kind, ns, name)

    def create(self, kind, obj):
        if kind == LEASES and self.fail_lease_writes:
            raise TransientAPIError("injected: lease write refused")
        return self.inner.create(kind, obj)

    def update(self, kind, obj):
        if kind == LEASES and self.fail_lease_writes:
            raise TransientAPIError("injected: lease write refused")
        return self.inner.update(kind, obj)


def _elector(store, identity, on_start=None, on_stop=None):
    return LeaderElector(store, identity=identity, namespace="default",
                         lease_duration=1.0, renew_deadline=0.4,
                         retry_period=0.05,
                         on_started_leading=on_start,
                         on_stopped_leading=on_stop)


def test_leader_steps_down_on_renew_failures_and_follower_takes_over():
    base = Store()
    flaky = FlakyLeaseStore(base)
    stopped = threading.Event()

    a = _elector(flaky, "replica-a", on_stop=stopped.set)
    b = _elector(base, "replica-b")
    a.start()
    assert a.wait_until_leading(timeout=5.0)
    b.start()
    time.sleep(0.2)
    assert not b.is_leader  # standby while the lease is live

    # The API server stops answering A's lease writes: A must step
    # down within its renew deadline, not keep acting as leader.
    flaky.fail_lease_writes = True
    assert stopped.wait(timeout=5.0), "leader never stepped down"
    assert not a.is_leader

    # B takes over the EXPIRED lease (duration 1s) and records the
    # transition on the lock object.
    wait_for(lambda: b.is_leader, timeout=5.0,
             message="follower to take over the expired lease")
    lease = base.try_get(LEASES, "default", "tpu-operator")
    assert lease.spec.holder_identity == "replica-b"
    assert lease.spec.lease_transitions >= 1
    a.stop()
    b.stop()


def test_failover_mid_reconcile_converges_each_job_exactly_once():
    """Leader loses the lease MID-RECONCILE (its jobs not yet
    converged), the follower takes over, and the fleet converges with
    exactly one success transition and exactly one pod-create per
    replica — the follower ADOPTS the surviving pods instead of
    re-creating them (crash-safe reconcile: all leader in-memory state
    is lost with the stepdown; the store is the only carryover)."""
    base = Store()
    flaky = FlakyLeaseStore(base)
    workers = 3

    gate = threading.Event()  # pods held Pending until failover

    controllers = {}

    def make(identity, lease_store):
        controller = GPUJobController(base, namespace=NAMESPACE)
        controllers[identity] = controller
        elector = _elector(
            lease_store, identity,
            on_start=lambda: controller.run(threadiness=2),
            on_stop=controller.stop)
        return elector

    a = make("replica-a", flaky)
    b = make("replica-b", base)
    kubelet = FakeKubelet(base, tick=0.01,
                          admitted=lambda ns, job: gate.is_set())

    succ_before = metrics.jobs_successful.value(job_namespace=NAMESPACE)
    created_before = metrics.created_pods.value(job_namespace=NAMESPACE)

    a.start()
    assert a.wait_until_leading(timeout=5.0)
    b.start()
    kubelet.start()
    try:
        job = testutil.new_tpujob(worker=workers, name="failover",
                                  namespace=NAMESPACE)
        base.create(store_mod.TPUJOBS, job)

        # Leader A creates the pods; the gate keeps them Pending so
        # the job is mid-reconcile when the lease is cut.
        wait_for(lambda: base.count(store_mod.PODS) == workers,
                 message="leader to create the gang's pods")
        flaky.fail_lease_writes = True
        wait_for(lambda: b.is_leader, timeout=5.0,
                 message="follower to take over")
        assert not a.is_leader

        # Now let the pods run to completion under the NEW leader.
        gate.set()
        wait_for(lambda: cond.is_succeeded(
            base.get(store_mod.TPUJOBS, NAMESPACE, "failover").status),
            timeout=15.0, message="job to converge under the follower")
    finally:
        kubelet.stop()
        # The port's order: controllers stop before their leases go.
        for c in controllers.values():
            try:
                c.stop()
            except Exception:
                pass
        a.stop()
        b.stop()
        base.stop_watchers()

    # Exactly ONE success transition and ONE create per replica: the
    # follower adopted A's pods, it did not double-create or
    # double-converge.
    assert metrics.jobs_successful.value(
        job_namespace=NAMESPACE) == succ_before + 1
    assert metrics.created_pods.value(
        job_namespace=NAMESPACE) == created_before + workers


def test_released_lease_hands_over_immediately():
    base = Store()
    a = _elector(base, "replica-a")
    b = _elector(base, "replica-b")
    a.start()
    assert a.wait_until_leading(timeout=5.0)
    b.start()
    a.stop()  # voluntary stop releases the lease
    wait_for(lambda: b.is_leader, timeout=5.0,
             message="follower takeover after voluntary release")
    b.stop()


# ---------------------------------------------------------------------------
# ShardMap: N-leader ownership (one lease per shard, jobs hashed by
# (namespace, uid)) — the sharded control plane's election layer.
# ---------------------------------------------------------------------------


def _shard_map(store, shards, identity, **kwargs):
    return ShardMap(store, shards, identity=identity, namespace="default",
                    lease_duration=1.0, renew_deadline=0.4,
                    retry_period=0.05, **kwargs)


def test_shard_map_acquires_every_shard_and_releases_on_stop():
    store = Store()
    acquired, lost = [], []
    a = _shard_map(store, 3, "replica-a",
                   on_shard_acquired=acquired.append,
                   on_shard_lost=lost.append)
    a.start()
    assert a.wait_until_held(3, timeout=5.0)
    assert sorted(acquired) == [0, 1, 2]
    assert a.held() == {0, 1, 2}
    for i in range(3):
        lease = store.try_get(LEASES, "default", shard_lock_name(i))
        assert lease is not None
        assert lease.spec.holder_identity == "replica-a"
    # Fresh acquisitions are not reassignments (no prior holder).
    assert a.reassignments == 0

    a.stop()
    assert a.held() == set()
    # Graceful stop tears down controllers via on_shard_lost? No — the
    # contract is that stop() does NOT fire on_shard_lost (the caller
    # is tearing everything down itself); it only releases the leases
    # so a successor can take over without waiting out the duration.
    assert lost == []
    b = _shard_map(store, 3, "replica-b")
    b.start()
    assert b.wait_until_held(3, timeout=5.0), \
        "released leases should hand over well inside the lease duration"
    b.stop()


def test_crashed_shard_reacquired_by_standby_after_expiry():
    """Kill-mid-reconcile analog at the lease layer: crash() kills one
    shard's elector WITHOUT releasing the lease. The standby must wait
    out the expiry, then take over exactly that shard — the survivor's
    other shards never change hands."""
    store = Store()
    a = _shard_map(store, 2, "replica-a")
    b = _shard_map(store, 2, "replica-b")
    a.start()
    assert a.wait_until_held(2, timeout=5.0)
    b.start()
    time.sleep(0.3)
    assert b.held() == set()  # standby while A renews

    a.crash(1)  # elector dead, lease NOT released
    wait_for(lambda: 1 in b.held(), timeout=5.0,
             message="standby to take over the expired shard lease")
    assert 0 not in b.held(), "shard 0 is still renewed by A"
    assert a.held() == {0}
    # The takeover of a previously-held lease is a reassignment.
    assert b.reassignments == 1
    lease = store.try_get(LEASES, "default", shard_lock_name(1))
    assert lease.spec.holder_identity == "replica-b"
    assert lease.spec.lease_transitions >= 1
    a.stop()
    b.stop()


def test_split_brain_each_job_reconciled_by_exactly_one_shard_holder():
    """Two full operator replicas, two shards, a mid-reconcile shard
    crash: replica A holds both shards and creates all pods (held
    Pending by the kubelet gate), then A's shard is killed WITHOUT
    releasing the lease — the split-brain window. B must take the
    expired shard and drive its jobs home, and the whole run must show
    single-writer semantics: every sync on the shard owning the job's
    (namespace, uid) hash, never two live controllers per shard, and
    exactly one pod-create per replica slot (B adopts A's pods)."""
    store = Store()
    shards = 2
    sync_log = {}    # job key -> list of (identity, shard_index)
    active = {}      # shard index -> identity
    violations = []
    lock = threading.Lock()
    gate = threading.Event()

    class Replica:
        def __init__(self, identity):
            self.identity = identity
            self.controllers = {}
            self.map = _shard_map(store, shards, identity,
                                  on_shard_acquired=self._up,
                                  on_shard_lost=self._down)

        def _up(self, index):
            with lock:
                if index in active:
                    violations.append(
                        f"shard {index} acquired by {self.identity} "
                        f"while {active[index]} still runs it")
                active[index] = self.identity
            c = GPUJobController(store, namespace=NAMESPACE,
                                 shard_index=index, shard_count=shards)
            inner = c.sync_tpujob

            def recorded(key, _inner=inner,
                         _ident=(self.identity, index)):
                with lock:
                    sync_log.setdefault(key, []).append(_ident)
                _inner(key)

            c.sync_tpujob = recorded
            c.run(threadiness=2)
            for ns, name, _ in store.keys(store_mod.TPUJOBS):
                snap = store.get_snapshot(store_mod.TPUJOBS, ns, name)
                if (snap is not None and shard_for(
                        ns, snap.metadata.uid, shards) == index):
                    c.enqueue(f"{ns}/{name}")
            self.controllers[index] = c

        def _down(self, index):
            c = self.controllers.pop(index, None)
            with lock:
                if active.get(index) == self.identity:
                    del active[index]
            if c is not None:
                c.stop()

        def crash(self, index):
            self.map.crash(index)
            c = self.controllers.pop(index, None)
            with lock:
                if active.get(index) == self.identity:
                    del active[index]
            if c is not None:
                c.stop()

        def stop(self):
            # The port's order (``ShardedOperator.stop``): controllers
            # stop before their shard leases are released.
            for index in list(self.controllers):
                self._down(index)
            self.map.stop()

    a = Replica("replica-a")
    b = Replica("replica-b")
    kubelet = FakeKubelet(store, tick=0.01,
                          admitted=lambda ns, job: gate.is_set())
    created_before = metrics.created_pods.value(job_namespace=NAMESPACE)

    jobs, workers = 6, 2
    a.map.start()
    assert a.map.wait_until_held(shards, timeout=5.0)
    b.map.start()
    kubelet.start()
    try:
        for i in range(jobs):
            store.create(store_mod.TPUJOBS,
                         testutil.new_tpujob(worker=workers,
                                             name=f"sb-{i}",
                                             namespace=NAMESPACE))
        wait_for(lambda: store.count(store_mod.PODS) == jobs * workers,
                 message="A to create every gang's pods")

        a.crash(1)  # lease NOT released: B must wait out the expiry
        wait_for(lambda: 1 in b.map.held(), timeout=5.0,
                 message="B to take over the crashed shard")
        gate.set()
        wait_for(
            lambda: sum(
                1 for j in store.list(store_mod.TPUJOBS,
                                      namespace=NAMESPACE)
                if cond.is_succeeded(j.status)) == jobs,
            timeout=20.0, message="fleet to converge across the split")
    finally:
        kubelet.stop()
        a.stop()
        b.stop()
        store.stop_watchers()

    assert not violations, violations
    assert sync_log
    for key, syncers in sync_log.items():
        ns, name = key.split("/", 1)
        snap = store.get_snapshot(store_mod.TPUJOBS, ns, name)
        owner = shard_for(ns, snap.metadata.uid, shards)
        # Every sync ran on the owning shard; on the crashed shard the
        # holder changed (A then B) but there was never a second
        # concurrent holder, so per-job writers stay serial.
        assert {s for _, s in syncers} == {owner}, (
            f"{key} synced on shards {sorted({s for _, s in syncers})}, "
            f"owned by {owner}")
        identities = [i for i, _ in syncers]
        assert len(set(identities)) <= 2
        # Serial handoff, not interleaving: once B syncs a key, A
        # never syncs it again.
        if "replica-b" in identities:
            first_b = identities.index("replica-b")
            assert "replica-a" not in identities[first_b:], (
                f"{key} synced by A after B took over: {identities}")
    # B adopted A's pods instead of re-creating them.
    assert metrics.created_pods.value(
        job_namespace=NAMESPACE) == created_before + jobs * workers


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
