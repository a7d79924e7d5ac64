"""The port's role policies and tenant quotas against the JAX package's.

``tests/test_rl.py``'s actor-learner scenarios, written once against a
package (``test_torch_operator_gang``'s ``Pkg``: JAX ``v5e-N`` beside
port ``h100-N``, ``google.com/tpu`` beside ``nvidia.com/gpu``) and run
through both control planes on one fake clock, sync by sync with no
threads:

- ``chipConsuming``, not the role's name, decides the device: a CPU-only
  actor pool gets no ``nvidia.com/gpu`` and no toleration where the JAX
  one gets no ``google.com/tpu``, and an override flips either way;
- actors get ``TPUJOB_LEARNER_ENDPOINTS`` byte for byte as in JAX;
- an actor resize moves no bootstrap hash; a learner resize moves only
  the learners';
- on an ``h100-4`` slice the learners run one process a GPU (torchrun's
  ``GROUP_RANK``/``LOCAL_WORLD_SIZE``) while actors get no torchrun key;
- an actor kill storm, then a pool resize through the gang, leaves the
  learners' uids, bootstrap hashes and the committed step untouched.

Then ``hack/verify-quota-invariants.py``'s property check, the port's own
copy written against a package: random cohorts, queues and gangs under
GPU budgets, admitted GPUs never above a cohort's capacity, no queue
starved, and the same admissions step by step as the JAX package's.
"""

import importlib
import random

import pytest

from test_torch_operator_gang import JAX, PORT, clock  # noqa: F401

pytestmark = pytest.mark.control_plane

NS = "default"
TORCHRUN_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK",
                 "WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "GROUP_WORLD_SIZE")


def mod(pkg, name):
    root = "tf_operator_tpu_torch" if pkg.port else "tf_operator_tpu"
    return importlib.import_module(f"{root}.{name}")


def actor_policy(pkg, min_replicas=1, max_replicas=4, disruption=None):
    t = pkg.types
    return t.RolePolicy(chip_consuming=False, preemptible=True,
                        min_replicas=min_replicas, max_replicas=max_replicas,
                        disruption_class=disruption
                        or t.DisruptionClass.EVICT)


def rl_job(pkg, worker=2, actor=4, name="rl", namespace=NS, chips=4,
           policy=None, ckpt=False):
    """test_rl.py's make_rl_job on ``pkg``'s accelerator."""
    t = pkg.types
    job = pkg.testutil.new_tpujob(worker=worker, actor=actor, name=name,
                                  namespace=namespace,
                                  accelerator=pkg.accel(chips))
    job.spec.replica_specs["actor"].role_policy = (
        policy(pkg) if policy is not None
        else actor_policy(pkg, max_replicas=actor))
    if ckpt:
        job.spec.run_policy.checkpoint_policy = t.CheckpointPolicy(
            enabled=True, directory="/tmp/ckpt",
            barrier_timeout_seconds=30.0)
    pkg.api.set_defaults(job)
    return job


def pod_shape(pkg, job, rtype, index=0):
    """One pod as ``pkg``'s controller renders it: its device request,
    its tolerations (the device key as True), its env."""
    ctl = pkg.controller_cls(pkg.store_mod.Store())
    pod = pkg.testutil.new_pod(job, rtype, index)
    ctl.set_cluster_spec(job, pod, rtype, index)
    container = pod.spec.containers[0]
    return {"device": container.resources.get(pkg.resource),
            "tolerations": [(t.key == pkg.resource, t.operator)
                            for t in pod.spec.tolerations],
            "env": dict(container.env)}


# (worker policy, actor policy): test_rl.py's default RL job, a worker
# overridden off the device, an actor pool overridden onto it.
POLICIES = {
    "default": (None, None),
    "worker-off-device": (
        lambda p: p.types.RolePolicy(chip_consuming=False), None),
    "actor-on-device": (
        None, lambda p: p.types.RolePolicy(chip_consuming=True)),
}


def policied_job(pkg, case):
    worker, actor = POLICIES[case]
    job = rl_job(pkg, policy=actor)
    if worker is not None:
        job.spec.replica_specs["worker"].role_policy = worker(pkg)
    return job


@pytest.mark.parametrize("rtype", ["worker", "actor"])
@pytest.mark.parametrize("case", sorted(POLICIES))
def test_chip_consuming_decides_the_device(case, rtype):
    j = pod_shape(JAX, policied_job(JAX, case), rtype)
    t = pod_shape(PORT, policied_job(PORT, case), rtype)
    assert (t["device"] is None) == (j["device"] is None)
    assert t["tolerations"] == j["tolerations"]
    assert JAX.resource not in str(t)
    holds = {("default", "worker"), ("actor-on-device", "worker"),
             ("actor-on-device", "actor")}
    if (case, rtype) in holds:
        per_host = PORT.topology.parse_accelerator(
            PORT.accel(4)).devices_per_host
        assert t["device"] == str(per_host)
        assert t["tolerations"] == [(True, "Exists")]
    else:
        # A CPU-only role: no GPU request and no GPU-pool toleration.
        assert t["device"] is None and t["tolerations"] == []


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_learner_endpoints_are_byte_equal(workers):
    key = JAX.const.ENV_LEARNER_ENDPOINTS
    assert PORT.const.ENV_LEARNER_ENDPOINTS == key
    j = pod_shape(JAX, rl_job(JAX, worker=workers), "actor")["env"]
    t = pod_shape(PORT, rl_job(PORT, worker=workers), "actor")["env"]
    assert t[key] == j[key]
    assert t[key] == mod(PORT, "bootstrap").learner_endpoints(
        rl_job(PORT, worker=workers))
    assert len(t[key].split(",")) == workers
    # Learners discover each other through the world, not this key.
    w = pod_shape(PORT, rl_job(PORT, worker=workers), "worker")["env"]
    assert key not in w


def hash_moves(pkg):
    """Which roles' bootstrap hashes an actor resize, then a learner
    resize, moves."""
    ctl = pkg.controller_cls(pkg.store_mod.Store())
    job = rl_job(pkg, worker=2, actor=2)

    def hashes():
        return {(rt, i): ctl._compute_bootstrap_hash(job, rt, i)
                for rt in ("worker", "actor") for i in range(2)}

    before, moves = hashes(), []
    for rtype, replicas in (("actor", 4), ("actor", 1), ("worker", 3)):
        job.spec.replica_specs[rtype].replicas = replicas
        now = hashes()
        moves.append((rtype, replicas,
                      sorted(k for k in now if now[k] != before[k])))
    return moves


def test_actor_resizes_keep_learner_hashes():
    moves = hash_moves(PORT)
    assert moves == hash_moves(JAX)
    assert moves == [("actor", 4, []), ("actor", 1, []),
                     ("worker", 3, [("worker", 0), ("worker", 1)])]


def test_h100_4_learners_run_a_process_a_gpu():
    """On h100-4 each learner pod holds 4 GPUs and runs 4 processes
    (torchrun's group keys, no RANK); actors stay outside the world."""
    job = rl_job(PORT, worker=2, actor=2, chips=4)
    for index in range(2):
        env = pod_shape(PORT, job, "worker", index)["env"]
        assert (env["GROUP_RANK"], env["GROUP_WORLD_SIZE"],
                env["LOCAL_WORLD_SIZE"], env["WORLD_SIZE"]) == (
                    str(index), "2", "4", "8")
        assert "RANK" not in env and "LOCAL_RANK" not in env
    for index in range(2):
        env = pod_shape(PORT, job, "actor", index)["env"]
        assert not [k for k in env if k in TORCHRUN_KEYS]
        assert not [k for k in env if k.startswith(("JAX_", "TPU_"))]
        jenv = pod_shape(JAX, rl_job(JAX, worker=2, actor=2), "actor",
                         index)["env"]
        assert not [k for k in jenv if k.startswith("JAX_")]


def storm(pkg):
    """test_rl.py's actor kill storm, synced by hand, then the pool
    resized through the gang; returns what both planes must agree on."""
    t, c, sm = pkg.types, pkg.const, pkg.store_mod
    ns = "rl-e2e"
    store = sm.Store()
    ckpt = pkg.ckpt.CheckpointCoordinator(store)
    gang = pkg.gang.SliceGangScheduler(store, total_chips=None, ckpt=ckpt)
    ctl = pkg.controller_cls(
        store, config=mod(pkg, "controller.engine").EngineConfig(
            enable_gang_scheduling=True),
        gang=gang, namespace=ns, ckpt=ckpt)
    job = store.create(sm.TPUJOBS, rl_job(pkg, worker=2, actor=4,
                                          name="storm", namespace=ns,
                                          ckpt=True))

    def sync():
        ctl.expectations.delete_for_job(job.key())
        ctl.sync_tpujob(job.key())

    def pods(rtype):
        return {p.metadata.name: p for p in store.list(sm.PODS,
                                                       namespace=ns)
                if p.metadata.labels.get(c.LABEL_REPLICA_TYPE) == rtype}

    def world():
        return {name: (p.metadata.uid, p.metadata.annotations.get(
            c.ANNOTATION_BOOTSTRAP_HASH))
            for name, p in pods("worker").items()}

    trace = []
    sync()
    before = world()
    trace.append(("created", sorted(before), sorted(pods("actor")),
                  all(h for _, h in before.values())))
    for name in before:
        rec = t.CheckpointRecord(status=t.CheckpointRecordStatus(
            step=30, progress_step=30))
        rec.metadata.name = name
        rec.metadata.namespace = ns
        rec.metadata.labels = {c.LABEL_JOB_NAME: "storm"}
        store.create(sm.CHECKPOINTRECORDS, rec)
    trace.append(("committed", ckpt.committed_step(ns, "storm")))
    # The storm: half the pool at once.
    doomed = sorted(pods("actor"))[:2]
    killed = {n: pods("actor")[n].metadata.uid for n in doomed}
    for name in doomed:
        store.try_delete(sm.PODS, ns, name)
    for _ in range(2):
        sync()
    actors = pods("actor")
    trace.append((
        "healed", sorted(actors),
        all(actors[n].metadata.uid != killed[n] for n in doomed),
        world() == before, ckpt.committed_step(ns, "storm"),
        [sorted(k for k in p.spec.containers[0].env
                if k in TORCHRUN_KEYS or k.startswith("JAX_"))
         + [c.ENV_LEARNER_ENDPOINTS in p.spec.containers[0].env]
         for _, p in sorted(actors.items())]))
    # The pool shrunk through the gang's resize lane.
    resized = gang.resize_role(ns, "storm", "actor", 2, "scale", "demand")
    for _ in range(2):
        sync()
    trace.append(("resized", resized, sorted(pods("actor")),
                  world() == before, ckpt.committed_step(ns, "storm")))
    return trace


def test_actor_kill_storm_preserves_the_learner_world(clock):  # noqa: F811
    trace = storm(PORT)
    assert trace == storm(JAX)
    assert trace[0] == ("created", ["storm-worker-0", "storm-worker-1"],
                        [f"storm-actor-{i}" for i in range(4)], True)
    assert trace[1] == ("committed", 30)
    assert trace[2][:5] == ("healed", [f"storm-actor-{i}" for i in range(4)],
                            True, True, 30)
    # Recreated actors: the learner endpoints, no torchrun or JAX key.
    assert trace[2][5] == [[True]] * 4
    assert trace[3] == ("resized", True, ["storm-actor-0", "storm-actor-1"],
                        True, 30)


# ---------------------------------------------------------------------------
# Tenant quotas: the port's copy of hack/verify-quota-invariants.py
# ---------------------------------------------------------------------------

class QuotaTopology:
    """Random cohorts of tenant queues over one package's gang and
    quota, the device budget its chips (GPUs on the port)."""

    def __init__(self, pkg, rng: random.Random):
        t, sm = pkg.types, pkg.store_mod
        self.pkg, self.rng = pkg, rng
        self.store = sm.Store()
        mgr = pkg.quota.TenantQueueManager(self.store)
        self.queues = {}            # name -> (cohort, nominal, limit)
        self.cohort_nominal = {}
        qi = 0
        for ci in range(rng.randint(1, 2)):
            cohort = f"cohort-{ci}"
            for _ in range(rng.randint(2, 4)):
                name = f"q{qi}"
                qi += 1
                nominal = rng.choice([4, 8, 16, 32])
                limit = rng.choice([None, None, 0, 4, 8])
                policy = rng.choice([t.ReclaimPolicy.ANY, t.ReclaimPolicy.ANY,
                                     t.ReclaimPolicy.LOWER_PRIORITY])
                cq = t.ClusterQueue(spec=t.ClusterQueueSpec(
                    nominal_chips=nominal, borrowing_limit=limit,
                    cohort=cohort, reclaim_policy=policy))
                cq.metadata.name = f"cq-{name}"
                cq.metadata.namespace = ""
                self.store.create(sm.CLUSTERQUEUES, cq)
                tq = t.TenantQueue(spec=t.TenantQueueSpec(
                    cluster_queue=f"cq-{name}"))
                tq.metadata.name = name
                self.store.create(sm.TENANTQUEUES, tq)
                self.queues[name] = (cohort, nominal, limit)
                self.cohort_nominal[cohort] = (
                    self.cohort_nominal.get(cohort, 0) + nominal)
        self.sched = pkg.gang.SliceGangScheduler(
            self.store, total_chips=sum(self.cohort_nominal.values()),
            quota=mgr, fairness=rng.choice(["aged", "strict", "backfill"]),
            priority_classes={"hi": 100, "lo": 10})
        self.groups_made = 0

    def ceiling(self, qname):
        cohort, nominal, limit = self.queues[qname]
        cap = self.cohort_nominal[cohort]
        return min(nominal + limit, cap) if limit is not None else cap

    def add_group(self, qname):
        t = self.pkg.types
        sizes = [n for n in (4, 8, 16, 32) if n <= self.ceiling(qname)]
        if not sizes:
            return
        group = t.SliceGroup(spec=t.SliceGroupSpec(
            min_member=1, queue=qname,
            priority_class=self.rng.choice(["", "hi", "lo"]),
            slice=t.TPUSliceSpec(
                accelerator=self.pkg.accel(self.rng.choice(sizes)))))
        group.metadata.name = f"g{self.groups_made}"
        self.groups_made += 1
        self.store.create(self.pkg.store_mod.SLICEGROUPS, group)

    def groups(self):
        return self.store.list(self.pkg.store_mod.SLICEGROUPS)

    def admitted(self):
        g = self.pkg.gang
        return [x for x in self.groups()
                if x.status.phase in (g.PHASE_INQUEUE, g.PHASE_RUNNING)]

    def over_capacity(self):
        used = {}
        for x in self.admitted():
            cohort = self.queues[x.spec.queue][0]
            used[cohort] = used.get(cohort, 0) + self.pkg.topology \
                .parse_accelerator(x.spec.slice.accelerator).chips
        return [(c, n) for c, n in sorted(used.items())
                if n > self.cohort_nominal[c]]

    def complete_one(self):
        admitted = self.admitted()
        if not admitted:
            return False
        victim = self.rng.choice(admitted)
        self.store.delete(self.pkg.store_mod.SLICEGROUPS,
                          victim.metadata.namespace, victim.metadata.name)
        self.sched.readmit()
        return True

    def phases(self):
        return sorted((x.metadata.name, x.status.phase)
                      for x in self.groups())


def quota_round(pkg, seed, steps=30):
    """(violations, the groups' phases after every step): arrivals and
    completions, then drain rounds until nothing is pending."""
    rng = random.Random(seed)
    topo = QuotaTopology(pkg, rng)
    errors, trace = [], []
    for step in range(steps):
        action = rng.random()
        if action < 0.6:
            topo.add_group(rng.choice(list(topo.queues)))
        elif action < 0.9:
            topo.complete_one()
        topo.sched.readmit()
        trace.append(topo.phases())
        if topo.over_capacity():
            errors.append((step, topo.over_capacity()))
    for _ in range(len(topo.groups()) + 5):
        topo.sched.readmit()
        trace.append(topo.phases())
        if topo.over_capacity():
            errors.append(("drain", topo.over_capacity()))
        pending = [x.metadata.name for x in topo.groups()
                   if x.status.phase == pkg.gang.PHASE_PENDING]
        if not pending:
            break
        if not topo.complete_one():
            errors.append(("starved", pending))
            break
    else:
        errors.append(("never admitted", pending))
    return errors, trace


@pytest.mark.parametrize("seed", [1234, 1237, 1282, 4242])
def test_quota_invariants_hold_on_gpu_budgets(clock, seed):  # noqa: F811
    errors, trace = quota_round(PORT, seed)
    assert not errors, f"seed {seed}: {errors}"
    assert trace == quota_round(JAX, seed)[1]
    assert any(phase == PORT.gang.PHASE_INQUEUE
               for phases in trace for _, phase in phases)
