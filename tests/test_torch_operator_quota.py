"""The port's tenant queues, serving wiring and autoscaler against JAX's.

Scenarios run once per package on one fake clock (``World``, ``both``
and the ``clock`` fixture of ``tests/test_torch_operator_gang.py``),
mirroring ``tests/test_quota.py``, ``tests/test_serving.py`` and
``tests/test_autoscaler.py``: nominal quota, cohort borrowing, reclaim
and priority preemption through ``TenantQueueManager`` under the gang
scheduler (phases, ClusterQueue status, quota waits, event reasons);
``load_queue_config`` on ``examples/quota/queues.yaml``; the env
``ServingManager`` renders into serving pods (byte-equal, also through
each package's controller); and ``ServingAutoscaler``'s decisions on the
same queue-depth and TTFT sequences through the elastic resize pass.
"""

import json
import os
import sys

import pytest

from test_torch_operator_gang import JAX, NS, PORT, World, both, clock

pytestmark = pytest.mark.control_plane

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ = clock  # the shared fake-clock fixture
PRI = {"prod": 100, "batch": 10}


# ---------------------------------------------------------------------------
# Tenant queues
# ---------------------------------------------------------------------------

def cluster_queue(w, name, nominal, borrowing_limit=None, cohort="",
                  reclaim_policy=""):
    t = w.p.types
    cq = t.ClusterQueue(spec=t.ClusterQueueSpec(
        nominal_chips=nominal, borrowing_limit=borrowing_limit,
        cohort=cohort, reclaim_policy=reclaim_policy))
    cq.metadata.name, cq.metadata.namespace = name, ""
    return w.store.create(w.sm.CLUSTERQUEUES, cq)


def tenant_queue(w, name, cq):
    t = w.p.types
    tq = t.TenantQueue(spec=t.TenantQueueSpec(cluster_queue=cq))
    tq.metadata.name, tq.metadata.namespace = name, NS
    return w.store.create(w.sm.TENANTQUEUES, tq)


def cohort(w, nominal=8, borrowing_limit=None, b_policy=""):
    cluster_queue(w, "cq-a", nominal, borrowing_limit, cohort="pool")
    cluster_queue(w, "cq-b", nominal, borrowing_limit, cohort="pool",
                  reclaim_policy=b_policy)
    tenant_queue(w, "team-a", "cq-a")
    tenant_queue(w, "team-b", "cq-b")


def quota_sched(w, **kw):
    w.mgr = w.p.quota.TenantQueueManager(w.store, recorder=w.recorder)
    return w.scheduler(quota=w.mgr, **kw)


def quota_snap(w, label=""):
    """The gang snapshot plus ClusterQueue status and quota waits."""
    snap = w.snap(label)
    snap["queues"] = sorted(
        (cq.metadata.name, cq.status.admitted_chips,
         cq.status.borrowed_chips)
        for cq in w.store.list(w.sm.CLUSTERQUEUES))
    waits = {}
    for g in w.store.list(w.sm.SLICEGROUPS):
        wait = w.mgr.status_for(w.p.types.TPUJob(metadata=w.p.types.ObjectMeta(
            name=g.metadata.name, namespace=NS)))
        waits[g.metadata.name] = wait and (wait.queue, wait.message,
                                           wait.terminal)
    snap["waits"] = waits


def nominal_blocks_one_tenant(w):
    s = quota_sched(w, total_chips=32)
    cohort(w, borrowing_limit=0)
    w.group("a1", queue="team-a", age=30)
    w.group("a2", queue="team-a", age=20)
    w.group("b1", queue="team-b", age=10)
    w.group("legacy", age=5)
    s._admit()
    quota_snap(w)


def borrowing(w):
    s = quota_sched(w, total_chips=1024)
    cohort(w)
    for i in range(4):
        w.group(f"a{i}", queue="team-a", age=40 - i)
    s._admit()
    quota_snap(w)


def borrowing_limit(w):
    s = quota_sched(w, total_chips=64)
    cluster_queue(w, "cq-a", 8, borrowing_limit=4, cohort="pool")
    cluster_queue(w, "cq-b", 16, cohort="pool")
    tenant_queue(w, "team-a", "cq-a")
    tenant_queue(w, "team-b", "cq-b")
    w.group("a1", queue="team-a", age=20)
    w.group("a2", queue="team-a", age=10)
    s._admit()
    quota_snap(w)


def reclaim(w):
    s = quota_sched(w, total_chips=16)
    cohort(w)
    w.group("a1", queue="team-a", age=30)
    w.group("a2", queue="team-a", age=20)
    s._admit()
    quota_snap(w, "borrowed")
    w.group("b1", queue="team-b", age=10)
    s._admit()
    quota_snap(w, "reclaimed in one pass")


def reclaim_policies(w):
    s = quota_sched(w, total_chips=16, priority_classes=PRI)
    cohort(w, b_policy="LowerPriority")
    w.group("a1", queue="team-a", priority="prod", age=30)
    w.group("a2", queue="team-a", priority="prod", age=20)
    s._admit()
    w.group("b1", queue="team-b", priority="prod", age=10)
    s._admit()
    quota_snap(w, "equal priority spared")
    w.store.delete(w.sm.SLICEGROUPS, NS, "b1")
    w.group("a3", queue="team-a", priority="batch", age=8)
    s._admit()
    quota_snap(w, "borrow frozen")


def priority_preemption_in_queue(w):
    s = quota_sched(w, total_chips=8, preemption=True, priority_classes=PRI)
    cluster_queue(w, "cq-a", 16, borrowing_limit=0)
    tenant_queue(w, "team-a", "cq-a")
    w.group("low", queue="team-a", priority="batch", phase="Inqueue",
            age=60)
    w.pod("low")
    w.group("high", queue="team-a", priority="prod")
    s._admit()
    quota_snap(w, "victim evicted")
    s._admit()
    quota_snap(w, "preemptor admitted")


def zero_and_deleted_queues(w):
    s = quota_sched(w, total_chips=16)
    cluster_queue(w, "cq-zero", 0, borrowing_limit=0)
    tenant_queue(w, "team-zero", "cq-zero")
    tenant_queue(w, "team-later", "cq-later")
    w.group("z1", queue="team-zero", age=20)
    w.group("d1", queue="team-later", age=10)
    s._admit()
    quota_snap(w, "terminal and dangling")
    w.store.delete(w.sm.TENANTQUEUES, NS, "team-zero")
    cluster_queue(w, "cq-later", 8)
    s._admit()
    s._admit()
    quota_snap(w, "queue deleted, queue created")


QUOTA_SCENARIOS = {
    "nominal-blocks-one-tenant": nominal_blocks_one_tenant,
    "borrowing": borrowing,
    "borrowing-limit": borrowing_limit,
    "reclaim": reclaim,
    "reclaim-policies": reclaim_policies,
    "priority-preemption": priority_preemption_in_queue,
    "zero-and-deleted-queues": zero_and_deleted_queues,
}


@pytest.mark.parametrize("name", sorted(QUOTA_SCENARIOS))
def test_tenant_queues_match_jax(name, clock):
    jw, tw = both(QUOTA_SCENARIOS[name], clock)
    assert tw.trace == jw.trace
    phases = [dict((g[0], g[1]) for g in t["groups"])
              for t in jw.trace if "groups" in t]
    t = jw.trace
    if name == "nominal-blocks-one-tenant":
        assert phases[0] == {"a1": "Inqueue", "a2": "Pending",
                             "b1": "Inqueue", "legacy": "Inqueue"}
        assert "borrowingLimit" in t[0]["waits"]["a2"][1]
        assert ("a2", "QueuedWaitingForQuota") in t[0]["events"]
    if name == "borrowing":
        assert [n for n, p in sorted(phases[0].items())
                if p == "Inqueue"] == ["a0", "a1"]
        assert ("cq-a", 16, 8) in t[0]["queues"]
    if name == "borrowing-limit":
        assert phases[0] == {"a1": "Inqueue", "a2": "Pending"}
    if name == "reclaim":
        assert phases[0]["a2"] == "Inqueue"
        assert phases[1] == {"a1": "Inqueue", "a2": "Pending",
                             "b1": "Inqueue"}
        assert ("a2", "QuotaReclaimed") in t[1]["events"]
        assert ("cq-a", 8, 0) in t[1]["queues"]
    if name == "reclaim-policies":
        assert phases[0] == {"a1": "Inqueue", "a2": "Inqueue",
                             "b1": "Pending"}
        assert phases[1]["a3"] == "Pending"
    if name == "priority-preemption":
        assert phases[0] == {"low": "Pending", "high": "Pending"}
        assert phases[1] == {"low": "Pending", "high": "Inqueue"}
    if name == "zero-and-deleted-queues":
        assert t[0]["waits"]["z1"][2] is True
        assert t[0]["waits"]["d1"][2] is False
        assert phases[1] == {"z1": "Inqueue", "d1": "Inqueue"}
        assert [e for e in t[1]["events"] if e[1] == "QueueDeleted"] == [
            ("z1", "QueueDeleted")]


def test_queue_config_example_loads_as_jax_loads_it(clock):
    path = os.path.join(REPO_ROOT, "examples", "quota", "queues.yaml")
    seeded = []
    for pkg in (JAX, PORT):
        cqs, tqs = pkg.quota.load_queue_config(path)
        w = World(pkg, clock)
        pkg.quota.seed_queues(w.store, cqs, tqs)
        pkg.quota.seed_queues(w.store, cqs, tqs)  # idempotent
        seeded.append((
            [(q.metadata.name, q.spec.to_dict()) for q in cqs],
            [(q.metadata.namespace, q.metadata.name, q.spec.to_dict())
             for q in tqs],
            sorted((q.metadata.name, json.dumps(q.spec.to_dict(),
                                                sort_keys=True))
                   for q in w.store.list(w.sm.CLUSTERQUEUES)),
            sorted((q.metadata.namespace, q.metadata.name,
                    json.dumps(q.spec.to_dict(), sort_keys=True))
                   for q in w.store.list(w.sm.TENANTQUEUES))))
    assert seeded[1] == seeded[0]
    assert [q[1]["nominalChips"] for q in seeded[0][0]] == [16, 16]


def test_queue_config_without_pyyaml_names_it(tmp_path, monkeypatch):
    path = tmp_path / "queues.yaml"
    path.write_text("clusterQueues: []\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="needs pyyaml"):
        PORT.quota.load_queue_config(str(path))


# ---------------------------------------------------------------------------
# Serving wiring: the env of serving pods
# ---------------------------------------------------------------------------

SERVE_PREFIX = "TPUJOB_SERVE_"


def serving_env(w):
    t = w.p.types
    store = w.store
    cluster_queue(w, "gold", 8)
    tenant_queue(w, "team-a", "gold")
    tenant_queue(w, "team-b", "missing")
    manager = w.p.serving.ServingManager(store, recorder=w.recorder)
    jobs = {}
    for name, pol in (
            ("full", t.ServingPolicy(enabled=True, spool_directory="/spool",
                                     max_batch_slots=3, max_queue_depth=17,
                                     max_tokens_per_request=9)),
            ("defaults", t.ServingPolicy(enabled=True,
                                         spool_directory="/s")),
            ("disabled", t.ServingPolicy(enabled=False, max_batch_slots=4)),
            ("none", None)):
        job = w.p.testutil.new_tpujob(worker=0, name=name, namespace=NS)
        job.spec.replica_specs = {"serving": t.ReplicaSpec(
            replicas=2, template=t.PodTemplateSpec(spec=t.PodSpec(
                containers=[t.Container(
                    name=w.p.const.DEFAULT_CONTAINER_NAME)])))}
        job.spec.slice.accelerator = w.p.accel(16)
        job.spec.run_policy.serving_policy = pol
        w.p.api.set_defaults(job)
        jobs[name] = store.create(w.sm.TPUJOBS, job)
    envs = {(n, r): json.dumps(manager.bootstrap_env(j, r), sort_keys=True)
            for n, j in jobs.items() for r in ("serving", "worker")}
    controller = w.p.controller_cls(store, serving=manager)
    try:
        rendered = {}
        for n, j in jobs.items():
            pod = t.Pod(spec=t.PodSpec(containers=[t.Container(
                name=w.p.const.DEFAULT_CONTAINER_NAME)]))
            controller.set_cluster_spec(j, pod, "serving", 0)
            container = pod.spec.containers[0]
            rendered[n] = (json.dumps(
                {k: v for k, v in container.env.items()
                 if k.startswith(SERVE_PREFIX)}, sort_keys=True),
                container.resources.get(w.p.resource))
    finally:
        controller.stop()
    w.trace.append({"weights": manager.tenant_weights(NS), "env": envs,
                    "rendered": rendered,
                    "policy": w.p.serving.job_serving_policy(
                        jobs["full"]).to_dict()})


def test_serving_env_is_jax_env(clock):
    jw, tw = both(serving_env, clock)
    assert tw.trace == jw.trace
    t = jw.trace[0]
    assert t["weights"] == {"team-a": 8, "team-b": 1}
    full = json.loads(t["env"][("full", "serving")])
    assert full == {"TPUJOB_SERVE_SPOOL": "/spool",
                    "TPUJOB_SERVE_SLOTS": "3",
                    "TPUJOB_SERVE_MAX_QUEUE": "17",
                    "TPUJOB_SERVE_MAX_TOKENS": "9",
                    "TPUJOB_SERVE_TENANT_WEIGHTS": "team-a=8,team-b=1"}
    assert t["env"][("full", "worker")] == "{}"
    assert t["env"][("none", "serving")] == "{}"
    assert json.loads(t["rendered"]["full"][0]) == full
    assert t["rendered"]["full"][1] == "8"  # a host's devices, both ways


# ---------------------------------------------------------------------------
# The serving autoscaler
# ---------------------------------------------------------------------------

def autoscaled(w, name, signals, num_slices=1, target=4, cooldown=60.0,
               slo=None):
    t = w.p.types
    job = w.job(name, workers=num_slices, chips=4, num_slices=num_slices,
                min_slices=1, max_slices=3)
    job.spec.run_policy.serving_policy = t.ServingPolicy(
        enabled=True, spool_directory=f"/tmp/spool-{name}",
        target_queue_depth_per_slice=target,
        scale_down_cooldown_seconds=cooldown, ttft_p99_slo_seconds=slo)
    w.store.update(w.sm.TPUJOBS, job)
    w.group(name, chips=4, num_slices=num_slices, min_slices=1,
            max_slices=3, phase="Running", min_member=num_slices)
    a = w.p.autoscaler.ServingAutoscaler(w.store, None, namespace=NS,
                                         signals=signals, clock=w.clock)
    a.gang = w.scheduler(elastic=True, resize_signals=a.signals)
    return a


def settle(w, name):
    group = w.store.get(w.sm.SLICEGROUPS, NS, name)
    group.status.resizing_reason = ""
    w.store.update_status(w.sm.SLICEGROUPS, group)


def autoscale_run(w, name, schedule, **kw):
    """Evaluate once per (seconds to advance, depth, ttft p99) step; the
    group settles after every evaluation unless the step says not to."""
    sig = {}
    a = autoscaled(w, name, lambda ns, n: dict(sig), **kw)
    slices = []
    for advance, depth, ttft, settles in schedule:
        w.clock.advance(advance)
        sig.clear()
        sig["serving_queue_depth"] = depth
        if ttft is not None:
            sig["serving_ttft_p99_seconds"] = ttft
        a.evaluate_once()
        slices.append(w.store.get(w.sm.TPUJOBS, NS,
                                  name).spec.slice.num_slices)
        if settles:
            settle(w, name)
    w.trace.append({"slices": slices, "journal": [
        (r["kind"], r["reason"])
        for r in w.p.trace.JOURNAL.decisions(NS, name) or []]})
    w.snap()


AUTOSCALE_CASES = {
    "grow-on-depth": (dict(schedule=[(0, 12.0, None, True)]), [3]),
    "bounds-hold": (dict(schedule=[(0, 999.0, None, True)], num_slices=3),
                    [3]),
    "ttft-burn": (dict(schedule=[(0, 0.0, 2.0, True)], num_slices=2,
                       slo=0.5), [3]),
    "settling-hold": (dict(schedule=[(0, 12.0, None, False),
                                     (0, 0.0, None, False)]), [3, 3]),
    "cooldown": (dict(schedule=[(0, 0.0, None, True), (9, 0.0, None, True),
                                (2, 0.0, None, True)], num_slices=3,
                      cooldown=10.0), [3, 3, 1]),
    "flap-resets-window": (dict(schedule=[
        (0, 0.0, None, True), (8, 12.0, None, True), (8, 0.0, None, True),
        (8, 0.0, None, True), (3, 0.0, None, True)],
        num_slices=3, cooldown=10.0), [3, 3, 3, 3, 1]),
    "square-wave": (dict(schedule=[
        (0, 12.0, None, True), (5, 12.0, None, True), (5, 0.0, None, True),
        (5, 0.0, None, True), (6, 0.0, None, True), (5, 12.0, None, True),
        (5, 0.0, None, True), (11, 0.0, None, True)],
        cooldown=10.0), [3, 3, 3, 3, 1, 3, 3, 1]),
}


@pytest.mark.parametrize("name", sorted(AUTOSCALE_CASES))
def test_autoscaler_decisions_match_jax(name, clock):
    kw, want = AUTOSCALE_CASES[name]
    job = f"as-{name}"
    jw, tw = both(lambda w: autoscale_run(w, job, **kw), clock)
    assert tw.trace == jw.trace
    assert jw.trace[0]["slices"] == want
    kinds = jw.trace[0]["journal"]
    if name == "grow-on-depth":
        assert ("autoscale.up", "queue-depth") in kinds
        assert ("resized", "autoscale") in kinds
    if name == "ttft-burn":
        assert ("autoscale.up", "ttft-slo") in kinds
    if name == "bounds-hold":
        assert ("autoscale.hold", "bounds") in kinds


def test_spool_pending_depth_matches_jax(tmp_path):
    pending = tmp_path / "pending"
    pending.mkdir()
    for name in ("a.json", "b.json", "c.json.tmp", "d.txt"):
        (pending / name).write_text("{}")
    got = [pkg.autoscaler.spool_pending_depth(str(tmp_path))
           for pkg in (JAX, PORT)]
    missing = [pkg.autoscaler.spool_pending_depth(str(tmp_path / "none"))
               for pkg in (JAX, PORT)]
    assert got[1] == got[0] and missing[1] == missing[0]
