"""Leader failover and the sharded control plane through the port, held
to the JAX package's ``tests/test_leaderelection.py``.

Each scenario is written once against a ``Pkg`` and run through both
packages: the port's ``LeaderElector``, ``ShardMap``, ``ShardedOperator``
and ``GPUJobController`` beside the JAX ones. Each reaches the outcome
the JAX test asserts, and the counts the two packages give are compared:
pod creates per replica slot (counted at the store), success
transitions, lease holders and transitions, and the jobs each shard
synced (the jobs' uids are fixed, so both packages hash them to the same
shards).

A graceful stop must stop a replica's controllers before it releases its
leases: the last tests hold the port's ``ShardedOperator.stop`` and the
command line's ``Server.shutdown`` to that (the JAX package's release
first, ``ROADMAP.md`` C).

Where the JAX test waits 5 s for a takeover or 15-20 s for convergence,
these wait 15 s and 60 s: the suite runs in six worker processes.
"""

import importlib
import os
import sys
import threading
import time
import uuid
from collections import Counter

import pytest

pytestmark = pytest.mark.control_plane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAKEOVER_S = 15.0
CONVERGE_S = 60.0


class Pkg:
    """One package's control-plane modules."""

    def __init__(self, port: bool):
        root = "tf_operator_tpu_torch" if port else "tf_operator_tpu"

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.name = "port" if port else "jax"
        self.testutil = mod("testutil")
        self.cond = mod("controller.conditions")
        self.const = mod("api.constants")
        self.metrics = mod("runtime.metrics")
        self.store_mod = mod("runtime.store")
        self.le = mod("runtime.leaderelection")
        self.retry = mod("runtime.retry")
        self.operator = mod("operator")
        if port:
            from tf_operator_tpu_torch.runtime import chaos_campaign

            self.controller_cls = mod(
                "controller.gpu_controller").GPUJobController
            self.kubelet_cls = chaos_campaign.FakeKubelet
            self.namespace = chaos_campaign.NAMESPACE
        else:
            sys.path.insert(0, os.path.join(REPO, "benchmarks"))
            import bench_controlplane

            self.controller_cls = mod(
                "controller.tpu_controller").TPUJobController
            self.kubelet_cls = bench_controlplane.FakeKubelet
            self.namespace = bench_controlplane.NAMESPACE

    def counting_store(self):
        """A Store that counts pod creates per (job, replica type,
        index) slot."""
        store_mod, const = self.store_mod, self.const

        class CountingStore(store_mod.Store):
            def __init__(self):
                super().__init__()
                self.creates = Counter()

            def create(self, kind, obj):
                out = super().create(kind, obj)
                if kind == store_mod.PODS:
                    labels = obj.metadata.labels
                    self.creates[(
                        labels.get(const.LABEL_JOB_NAME),
                        labels.get(const.LABEL_REPLICA_TYPE),
                        labels.get(const.LABEL_REPLICA_INDEX))] += 1
                return out

        return CountingStore()

    def job(self, name, workers, index=None):
        job = self.testutil.new_tpujob(worker=workers, name=name,
                                       namespace=self.namespace)
        if index is not None:   # a fixed uid: the same shard in both
            job.metadata.uid = str(uuid.UUID(int=index + 1))
        return job

    def succeeded(self, store):
        return sum(1 for j in store.list(self.store_mod.TPUJOBS,
                                         namespace=self.namespace)
                   if self.cond.is_succeeded(j.status))

    def successes(self):
        return self.metrics.jobs_successful.value(job_namespace=self.namespace)


JAX, PORT = Pkg(port=False), Pkg(port=True)
BOTH = (JAX, PORT)


def wait_for(predicate, timeout=TAKEOVER_S, interval=0.02,
             message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


class FlakyLeaseStore:
    """Store facade for one elector whose lease writes can be cut off
    (an API server that stops answering this replica's renewals while
    everything else still works)."""

    def __init__(self, pkg, inner):
        self.pkg = pkg
        self.inner = inner
        self.fail_lease_writes = False

    def try_get(self, kind, ns, name):
        return self.inner.try_get(kind, ns, name)

    def _guard(self, kind):
        if kind == self.pkg.le.LEASES and self.fail_lease_writes:
            raise self.pkg.retry.TransientAPIError(
                "injected: lease write refused")

    def create(self, kind, obj):
        self._guard(kind)
        return self.inner.create(kind, obj)

    def update(self, kind, obj):
        self._guard(kind)
        return self.inner.update(kind, obj)


def _elector(pkg, store, identity, on_start=None, on_stop=None):
    return pkg.le.LeaderElector(store, identity=identity,
                                namespace="default", lease_duration=1.0,
                                renew_deadline=0.4, retry_period=0.05,
                                on_started_leading=on_start,
                                on_stopped_leading=on_stop)


def _shard_map(pkg, store, shards, identity, **kwargs):
    return pkg.le.ShardMap(store, shards, identity=identity,
                           namespace="default", lease_duration=1.0,
                           renew_deadline=0.4, retry_period=0.05, **kwargs)


def both(scenario):
    """The scenario's outcome through each package; they must agree."""
    out = {pkg.name: scenario(pkg) for pkg in BOTH}
    assert out["port"] == out["jax"], out
    return out["port"]


# ---------------------------------------------------------------------------
# The singleton lease
# ---------------------------------------------------------------------------

def _stepdown(pkg):
    base = pkg.store_mod.Store()
    flaky = FlakyLeaseStore(pkg, base)
    stopped = threading.Event()
    a = _elector(pkg, flaky, "replica-a", on_stop=stopped.set)
    b = _elector(pkg, base, "replica-b")
    try:
        a.start()
        assert a.wait_until_leading(timeout=TAKEOVER_S)
        b.start()
        time.sleep(0.2)
        standby = b.is_leader
        # The API server stops answering A's lease writes: A must step
        # down within its renew deadline.
        flaky.fail_lease_writes = True
        assert stopped.wait(timeout=TAKEOVER_S), "leader never stepped down"
        wait_for(lambda: b.is_leader,
                 message="follower to take over the expired lease")
        lease = base.try_get(pkg.le.LEASES, "default",
                             pkg.le.DEFAULT_LOCK_NAME)
        return {"b_standby_while_a_renews": not standby,
                "a_leader": a.is_leader,
                "holder": lease.spec.holder_identity,
                "transitions": lease.spec.lease_transitions >= 1}
    finally:
        a.stop()
        b.stop()


def test_leader_steps_down_on_renew_failures_and_follower_takes_over():
    assert both(_stepdown) == {"b_standby_while_a_renews": True,
                               "a_leader": False, "holder": "replica-b",
                               "transitions": True}


def _failover_mid_reconcile(pkg, workers=3):
    base = pkg.counting_store()
    flaky = FlakyLeaseStore(pkg, base)
    gate = threading.Event()     # pods held Pending until the failover
    controllers = {}

    def make(identity, lease_store):
        controller = pkg.controller_cls(base, namespace=pkg.namespace)
        controllers[identity] = controller
        return _elector(pkg, lease_store, identity,
                        on_start=lambda: controller.run(threadiness=2),
                        on_stop=controller.stop)

    a = make("replica-a", flaky)
    b = make("replica-b", base)
    kubelet = pkg.kubelet_cls(base, tick=0.01,
                              admitted=lambda ns, job: gate.is_set())
    succ_before = pkg.successes()
    created_before = pkg.metrics.created_pods.value(
        job_namespace=pkg.namespace)
    a.start()
    assert a.wait_until_leading(timeout=TAKEOVER_S)
    b.start()
    kubelet.start()
    try:
        base.create(pkg.store_mod.TPUJOBS, pkg.job("failover", workers))
        # Leader A creates the pods; the gate keeps them Pending, so the
        # job is mid-reconcile when A's lease is cut.
        wait_for(lambda: base.count(pkg.store_mod.PODS) == workers,
                 message="leader to create the gang's pods")
        flaky.fail_lease_writes = True
        wait_for(lambda: b.is_leader, message="follower to take over")
        a_leads = a.is_leader
        gate.set()
        wait_for(lambda: pkg.cond.is_succeeded(base.get(
            pkg.store_mod.TPUJOBS, pkg.namespace, "failover").status),
            timeout=CONVERGE_S, message="job to converge under the follower")
    finally:
        kubelet.stop()
        a.stop()
        b.stop()
        for c in controllers.values():
            try:
                c.stop()
            except Exception:
                pass
        base.stop_watchers()
    return {"a_leader_after_takeover": a_leads,
            "success_transitions": pkg.successes() - succ_before,
            "created_pods": pkg.metrics.created_pods.value(
                job_namespace=pkg.namespace) - created_before,
            "creates_per_slot": dict(base.creates)}


def test_failover_mid_reconcile_converges_each_job_exactly_once():
    """The follower adopts the surviving pods: one create per replica
    slot and one success transition, through either package."""
    assert both(_failover_mid_reconcile) == {
        "a_leader_after_takeover": False, "success_transitions": 1,
        "created_pods": 3,
        "creates_per_slot": {("failover", "worker", str(i)): 1
                             for i in range(3)}}


def _released_lease(pkg):
    base = pkg.store_mod.Store()
    a = _elector(pkg, base, "replica-a")
    b = _elector(pkg, base, "replica-b")
    a.start()
    assert a.wait_until_leading(timeout=TAKEOVER_S)
    b.start()
    a.stop()   # a voluntary stop releases the lease
    t0 = time.monotonic()
    try:
        wait_for(lambda: b.is_leader,
                 message="follower takeover after voluntary release")
        waited = time.monotonic() - t0
        lease = base.try_get(pkg.le.LEASES, "default",
                             pkg.le.DEFAULT_LOCK_NAME)
        return {"holder": lease.spec.holder_identity,
                # well inside the 1 s lease: the release, not the expiry
                "before_expiry": waited < 1.0}
    finally:
        b.stop()


def test_released_lease_hands_over_immediately():
    assert both(_released_lease) == {"holder": "replica-b",
                                     "before_expiry": True}


# ---------------------------------------------------------------------------
# ShardMap: one lease a shard, jobs hashed by (namespace, uid)
# ---------------------------------------------------------------------------

def _shard_map_lifecycle(pkg):
    store = pkg.store_mod.Store()
    acquired, lost = [], []
    a = _shard_map(pkg, store, 3, "replica-a",
                   on_shard_acquired=acquired.append,
                   on_shard_lost=lost.append)
    a.start()
    assert a.wait_until_held(3, timeout=TAKEOVER_S)
    holders = [store.try_get(pkg.le.LEASES, "default",
                             pkg.le.shard_lock_name(i)).spec.holder_identity
               for i in range(3)]
    out = {"acquired": sorted(acquired), "held": sorted(a.held()),
           "holders": holders, "reassignments": a.reassignments}
    a.stop()
    out.update(held_after_stop=sorted(a.held()), lost=list(lost))
    # stop() released the leases: a successor takes them at once.
    b = _shard_map(pkg, store, 3, "replica-b")
    b.start()
    out["successor_holds_all"] = b.wait_until_held(3, timeout=TAKEOVER_S)
    b.stop()
    return out


def test_shard_map_acquires_every_shard_and_releases_on_stop():
    assert both(_shard_map_lifecycle) == {
        "acquired": [0, 1, 2], "held": [0, 1, 2],
        "holders": ["replica-a"] * 3, "reassignments": 0,
        "held_after_stop": [], "lost": [], "successor_holds_all": True}


def _crashed_shard(pkg):
    store = pkg.store_mod.Store()
    a = _shard_map(pkg, store, 2, "replica-a")
    b = _shard_map(pkg, store, 2, "replica-b")
    try:
        a.start()
        assert a.wait_until_held(2, timeout=TAKEOVER_S)
        b.start()
        time.sleep(0.3)
        standby_held = sorted(b.held())
        a.crash(1)  # the elector dies; the lease is NOT released
        wait_for(lambda: 1 in b.held(),
                 message="standby to take over the expired shard lease")
        lease = store.try_get(pkg.le.LEASES, "default",
                              pkg.le.shard_lock_name(1))
        return {"standby_held": standby_held, "a": sorted(a.held()),
                "b": sorted(b.held()), "b_reassignments": b.reassignments,
                "holder": lease.spec.holder_identity,
                "transitions": lease.spec.lease_transitions >= 1}
    finally:
        a.stop()
        b.stop()


def test_crashed_shard_reacquired_by_standby_after_expiry():
    assert both(_crashed_shard) == {
        "standby_held": [], "a": [0], "b": [1], "b_reassignments": 1,
        "holder": "replica-b", "transitions": True}


class Replica:
    """A full operator replica of the split-brain scenario: a ShardMap
    whose acquisitions start a shard-scoped controller that logs every
    sync. A graceful stop stops the controllers, then releases."""

    def __init__(self, pkg, store, shards, identity, log):
        self.pkg, self.store, self.shards = pkg, store, shards
        self.identity = identity
        self.log = log                  # shared: syncs, active, violations
        self.controllers = {}
        self.stopping = False
        self._life = threading.Lock()
        self.map = _shard_map(pkg, store, shards, identity,
                              on_shard_acquired=self._up,
                              on_shard_lost=self._down)

    def _up(self, index):
        with self._life:
            if self.stopping:
                return
            log = self.log
            with log["lock"]:
                if index in log["active"]:
                    log["violations"].append(
                        f"shard {index} acquired by {self.identity} "
                        f"while {log['active'][index]} still runs it")
                log["active"][index] = self.identity
            c = self.pkg.controller_cls(self.store,
                                        namespace=self.pkg.namespace,
                                        shard_index=index,
                                        shard_count=self.shards)
            inner = c.sync_tpujob

            def recorded(key, _inner=inner, _ident=(self.identity, index)):
                with log["lock"]:
                    log["syncs"].setdefault(key, []).append(_ident)
                _inner(key)

            c.sync_tpujob = recorded
            c.run(threadiness=2)
            for ns, name, _ in self.store.keys(self.pkg.store_mod.TPUJOBS):
                snap = self.store.get_snapshot(self.pkg.store_mod.TPUJOBS,
                                               ns, name)
                if snap is not None and self.pkg.le.shard_for(
                        ns, snap.metadata.uid, self.shards) == index:
                    c.enqueue(f"{ns}/{name}")
            self.controllers[index] = c

    def _down(self, index):
        # Waits for a controller still starting on the shard (``_up``
        # holds the lock), so a crash never misses it.
        with self._life:
            c = self.controllers.pop(index, None)
            if c is not None:
                c.stop()
            with self.log["lock"]:
                if self.log["active"].get(index) == self.identity:
                    del self.log["active"][index]

    def crash(self, index):
        self.map.crash(index)
        self._down(index)

    def stop(self):
        with self._life:
            self.stopping = True
        for index in list(self.controllers):
            self._down(index)
        self.map.stop()


def _split_brain(pkg, jobs=6, workers=2, shards=2):
    store = pkg.counting_store()
    log = {"lock": threading.Lock(), "active": {}, "violations": [],
           "syncs": {}}
    gate = threading.Event()
    a = Replica(pkg, store, shards, "replica-a", log)
    b = Replica(pkg, store, shards, "replica-b", log)
    kubelet = pkg.kubelet_cls(store, tick=0.01,
                              admitted=lambda ns, job: gate.is_set())
    created_before = pkg.metrics.created_pods.value(
        job_namespace=pkg.namespace)
    a.map.start()
    assert a.map.wait_until_held(shards, timeout=TAKEOVER_S)
    b.map.start()
    kubelet.start()
    try:
        for i in range(jobs):
            store.create(pkg.store_mod.TPUJOBS,
                         pkg.job(f"sb-{i}", workers, index=i))
        wait_for(lambda: store.count(pkg.store_mod.PODS) == jobs * workers,
                 message="A to create every gang's pods")
        a.crash(1)  # the lease is NOT released: B waits out the expiry
        wait_for(lambda: 1 in b.map.held(),
                 message="B to take over the crashed shard")
        gate.set()
        wait_for(lambda: pkg.succeeded(store) == jobs, timeout=CONVERGE_S,
                 message="fleet to converge across the split")
    finally:
        kubelet.stop()
        a.stop()
        b.stop()
        store.stop_watchers()

    assert not log["violations"], log["violations"]
    owner_of = {}
    for key, syncers in log["syncs"].items():
        ns, name = key.split("/", 1)
        snap = store.get_snapshot(pkg.store_mod.TPUJOBS, ns, name)
        owner_of[name] = pkg.le.shard_for(ns, snap.metadata.uid, shards)
        # Every sync on the owning shard; a serial handoff, never
        # interleaved: once B syncs a key, A never syncs it again.
        assert {s for _, s in syncers} == {owner_of[name]}, (key, syncers)
        identities = [i for i, _ in syncers]
        if "replica-b" in identities:
            first_b = identities.index("replica-b")
            assert "replica-a" not in identities[first_b:], (key, identities)
    # Which replica synced a job on its shard besides these depends on
    # timing (a starved elector may step down and hand over serially),
    # so only what both packages must give is returned.
    on_shard, b_took = {}, set()
    for key, syncers in log["syncs"].items():
        name = key.split("/", 1)[1]
        for identity, shard in syncers:
            on_shard.setdefault(shard, set()).add(name)
            if (identity, shard) == ("replica-b", 1):
                b_took.add(name)
    return {"shard_of": owner_of,
            "jobs_synced_on_shard": {k: sorted(v)
                                     for k, v in sorted(on_shard.items())},
            "b_synced_on_shard_1": sorted(b_took),
            "created_pods": pkg.metrics.created_pods.value(
                job_namespace=pkg.namespace) - created_before,
            "creates_per_slot": sorted(Counter(store.creates.values()).items())}


def test_split_brain_each_job_reconciled_by_exactly_one_shard_holder():
    """Replica A holds both shards and creates every pod (held Pending);
    A's shard 1 dies without releasing its lease. B takes it after the
    expiry and drives its jobs home: every sync on the owning shard,
    never two live controllers a shard, one pod create a replica slot."""
    out = both(_split_brain)
    assert out["created_pods"] == 12
    assert out["creates_per_slot"] == [(1, 12)]
    owners = Counter(out["shard_of"].values())
    assert set(owners) == {0, 1}, out["shard_of"]   # both shards have jobs
    on = {i: sorted(n for n, s in out["shard_of"].items() if s == i)
          for i in (0, 1)}
    assert out["jobs_synced_on_shard"] == on
    assert out["b_synced_on_shard_1"] == on[1]


# ---------------------------------------------------------------------------
# The port's ShardedOperator (operator.py)
# ---------------------------------------------------------------------------

def _sharded_operator(pkg, identity, store, shards=2):
    return pkg.operator.ShardedOperator(
        shards, store=store, backend=None, identity=identity,
        namespace=pkg.namespace, lease_duration=1.0, renew_deadline=0.4,
        retry_period=0.05)


def _sharded_operator_crash(pkg, jobs=4, workers=2):
    """Two ShardedOperators over one store; A holds both shards and the
    pods of every job; A's shard 1 dies (lease kept, engine gone); B
    takes it over after the expiry and the fleet converges."""
    store = pkg.counting_store()
    gate = threading.Event()
    a = _sharded_operator(pkg, "replica-a", store)
    b = _sharded_operator(pkg, "replica-b", store)
    kubelet = pkg.kubelet_cls(store, tick=0.01,
                              admitted=lambda ns, job: gate.is_set())
    succ_before = pkg.successes()
    a.start()
    try:
        assert a.shard_map.wait_until_held(2, timeout=TAKEOVER_S)
        b.start()
        kubelet.start()
        for i in range(jobs):
            store.create(pkg.store_mod.TPUJOBS,
                         pkg.job(f"so-{i}", workers, index=i))
        wait_for(lambda: store.count(pkg.store_mod.PODS) == jobs * workers,
                 message="A to create every gang's pods")
        a.shard_map.crash(1)
        op = a._shard_ops.pop(1)
        op.controller.stop()    # the engine dies with its process
        wait_for(lambda: 1 in b.held_shards,
                 message="B to take over the crashed shard")
        gate.set()
        wait_for(lambda: pkg.succeeded(store) == jobs, timeout=CONVERGE_S,
                 message="fleet to converge under the two replicas")
        return {"a": sorted(a.held_shards), "b": sorted(b.held_shards),
                "success_transitions": pkg.successes() - succ_before,
                "creates_per_slot": dict(store.creates)}
    finally:
        kubelet.stop()
        b.stop()
        a.stop()


def test_sharded_operator_failover_adopts_the_crashed_shards_pods():
    out = both(_sharded_operator_crash)
    assert out["a"] == [0] and out["b"] == [1]
    assert out["success_transitions"] == 4
    assert out["creates_per_slot"] == {
        (f"so-{i}", "worker", str(r)): 1 for i in range(4) for r in range(2)}


def _slow_stops(monkeypatch, cls, record):
    """Make every ``cls.stop`` take 0.3 s (an engine draining its syncs)
    and log when each ends."""
    inner = cls.stop

    def stop(self, *args, **kwargs):
        time.sleep(0.3)
        inner(self, *args, **kwargs)
        record.append((id(self), time.monotonic()))

    monkeypatch.setattr(cls, "stop", stop)


def test_sharded_operator_stops_its_engines_before_releasing_leases(
        monkeypatch):
    """A graceful stop hands over: B may take A's shards only once A's
    engine on each has stopped."""
    store = PORT.store_mod.Store()
    a = _sharded_operator(PORT, "replica-a", store)
    b = _sharded_operator(PORT, "replica-b", store)
    acquired = {}
    inner = b._on_shard_acquired

    def on_acquired(index):
        acquired[index] = time.monotonic()
        inner(index)

    b.shard_map.on_shard_acquired = on_acquired
    stopped = []
    a.start()
    try:
        assert a.shard_map.wait_until_held(2, timeout=TAKEOVER_S)
        b.start()
        engines = {a.operator_for(i): i for i in range(2)}
        _slow_stops(monkeypatch, PORT.operator.Operator, stopped)
        a.stop()
        wait_for(lambda: len(acquired) == 2, message="B to take both shards")
    finally:
        b.stop()
    ended = {engines[op]: t for op_id, t in stopped
             for op in engines if id(op) == op_id}
    assert sorted(ended) == [0, 1], stopped
    for index in (0, 1):
        assert acquired[index] >= ended[index], (
            f"shard {index} taken by B {ended[index] - acquired[index]:.3f}"
            " s before A's engine on it stopped")


def test_server_shutdown_stops_the_operator_before_releasing_the_lease(
        monkeypatch):
    """The command line's singleton lease: a standby starts reconciling
    only after the old leader's operator has stopped."""
    from tf_operator_tpu_torch import cli

    monkeypatch.setattr(cli, "LEASE_DURATION", 2.0)
    monkeypatch.setattr(cli, "RENEW_DEADLINE", 0.8)
    monkeypatch.setattr(cli, "RETRY_PERIOD", 0.05)
    store = PORT.store_mod.Store()

    def server(identity):
        args = cli.build_parser().parse_args([
            "--backend", "none", "--leader-elect",
            "--leader-elect-identity", identity, "--monitoring-port", "0",
            "--resync-period", "0"])
        return cli.Server(args, store=store)

    a, b = server("replica-a"), server("replica-b")
    started = []
    inner = b._start_reconciling

    def start_reconciling():
        started.append(time.monotonic())
        inner()

    b.elector.on_started_leading = start_reconciling
    a.start()
    try:
        assert a.elector.wait_until_leading(timeout=TAKEOVER_S)
        b.start()
        stopped = []
        _slow_stops(monkeypatch, type(a.operator), stopped)
        a.shutdown()
        wait_for(lambda: started, message="B to start reconciling")
    finally:
        b.shutdown()
        store.stop_watchers()
    a_stopped = next(t for op_id, t in stopped if op_id == id(a.operator))
    assert started[0] >= a_stopped, (
        f"B reconciling {a_stopped - started[0]:.3f} s before A's operator "
        "stopped")


@pytest.mark.parametrize("case", ["won_during_shutdown", "mid_start"])
def test_server_shutdown_leaves_no_operator_started_behind_it(monkeypatch,
                                                              case):
    """``won_during_shutdown``: the lease is won (the elector's leading
    thread calls ``_start_reconciling``) while shutdown stops the
    operator; ``mid_start``: shutdown comes while the operator is still
    starting. Either way no start may run into or after the stop, or the
    lease is released beside a running controller."""
    from tf_operator_tpu_torch import cli

    store = PORT.store_mod.Store()
    args = cli.build_parser().parse_args([
        "--backend", "none", "--leader-elect", "--leader-elect-identity",
        "replica-a", "--monitoring-port", "0", "--resync-period", "0"])
    srv = cli.Server(args, store=store)
    events = []
    start, stop = srv.operator.start, srv.operator.stop

    def slow(name, inner):
        def call(*a, **kw):
            events.append((name, "begin"))
            time.sleep(0.3)
            inner(*a, **kw)
            events.append((name, "end"))
        return call

    monkeypatch.setattr(srv.operator, "start", slow("start", start))
    monkeypatch.setattr(srv.operator, "stop", slow("stop", stop))
    if case == "won_during_shutdown":
        first = threading.Thread(target=srv.shutdown)
        second = threading.Thread(target=srv._start_reconciling)
    else:
        first = threading.Thread(target=srv._start_reconciling)
        second = threading.Thread(target=srv.shutdown)
    try:
        first.start()
        time.sleep(0.1)
        second.start()
        first.join(10)
        second.join(10)
    finally:
        srv.operator.stop()
        store.stop_watchers()
    stop_begin = events.index(("stop", "begin"))
    assert ("start", "begin") not in events[stop_begin:], (
        f"the operator started after its stop began: {events}")
    assert ("start", "end") not in events[stop_begin:], (
        f"the operator was still starting when its stop began: {events}")
