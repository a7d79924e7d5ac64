"""The port's gang scheduler, slice health and binder against the JAX ones.

Each scenario below is written once against a ``World``: one package's
store, recorder and control-plane modules, with the accelerator, the
device resource and the fabric-domain label of that package (JAX
``v5e-N`` beside port ``h100-N``, which have the same chips, hosts and
chips a host; ``google.com/tpu`` beside ``nvidia.com/gpu``; the ICI-domain
label beside the NVLink one). Both packages run the scenario on one fake
clock: the gang's wall clock (``_now``, group ages and aging windows), its
and slice health's monotonic clock (grace windows, time to rebind) and the
checkpoint coordinator's clock. Their traces — SliceGroup phases,
displacement and resize records, admission order, preemption victims,
journal decisions, event reasons, pods, bindings, cordons and jobs — must
be equal, and each scenario also reaches the outcome the JAX package's
own test asserts. The scenarios mirror ``tests/test_gang_admission.py``,
``tests/test_elastic.py``, ``tests/test_health.py`` and
``tests/test_binder.py``.
"""

import datetime as dt
import importlib
import types

import pytest

pytestmark = pytest.mark.control_plane

NS = "default"
SAME_SHAPE = (1, 4, 8, 16)  # v5e-N and h100-N: same chips, hosts, per host
EPOCH = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


class Pkg:
    """One package's control-plane modules and device names."""

    def __init__(self, port: bool):
        root = "tf_operator_tpu_torch" if port else "tf_operator_tpu"

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.port = port
        self.api = mod("api")
        self.types = mod("api.types")
        self.const = mod("api.constants")
        self.testutil = mod("testutil")
        self.store_mod = mod("runtime.store")
        self.events = mod("runtime.events")
        self.metrics = mod("runtime.metrics")
        self.trace = mod("runtime.trace")
        self.topology = mod("bootstrap.topology")
        self.gang = mod("controller.gang")
        self.binder = mod("controller.binder")
        self.health = mod("controller.health")
        self.ckpt = mod("controller.ckpt")
        self.quota = mod("controller.quota")
        self.serving = mod("controller.serving")
        self.autoscaler = mod("controller.autoscaler")
        self.conditions = mod("controller.conditions")
        self.worker_stub = mod("runtime.worker_stub")
        self.checkpoint = mod("train.checkpoint")
        if port:
            self.controller_cls = mod(
                "controller.gpu_controller").GPUJobController
            self.resource = self.const.RESOURCE_GPU
            self.domain_label = self.const.LABEL_NVLINK_DOMAIN
            self.node_domain = self.binder.node_nvlink_domain
        else:
            self.controller_cls = mod(
                "controller.tpu_controller").TPUJobController
            self.resource = self.const.RESOURCE_TPU
            self.domain_label = self.const.LABEL_ICI_DOMAIN
            self.node_domain = self.binder.node_ici_domain

    def accel(self, chips: int) -> str:
        return f"{'h100' if self.port else 'v5e'}-{chips}"


JAX, PORT = Pkg(port=False), Pkg(port=True)


class FakeClock:
    """Monotonic seconds (``clock()``) and the wall clock beside them."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def wall(self) -> dt.datetime:
        return EPOCH + dt.timedelta(seconds=self.t)

    def advance(self, seconds: float) -> None:
        self.t += seconds


@pytest.fixture
def clock(monkeypatch):
    """One fake clock installed in both packages' gang, slice health and
    checkpoint coordinator."""
    c = FakeClock()
    fake_time = types.SimpleNamespace(monotonic=c)
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.gang, "_now", c.wall)
        monkeypatch.setattr(pkg.gang, "time", fake_time)
        monkeypatch.setattr(pkg.health, "time", fake_time)
        monkeypatch.setattr(pkg.ckpt, "_now_wall", c.wall)
    return c


class World:
    """One package's store, recorder and objects for one scenario."""

    def __init__(self, pkg: Pkg, clock: FakeClock):
        self.p = pkg
        self.clock = clock
        self.sm = pkg.store_mod
        self.store = pkg.store_mod.Store()
        self.recorder = pkg.events.Recorder()
        self.names = set()
        self.trace = []
        self._seen_events = 0

    # -- objects -------------------------------------------------------

    def group(self, name, chips=8, queue="", priority="", phase="Pending",
              age=0.0, min_member=1, num_slices=1, min_slices=None,
              max_slices=None, labels=True):
        t = self.p.types
        self.names.add(name)
        self.p.trace.JOURNAL.prune(NS, name)
        born = self.clock.wall() - dt.timedelta(seconds=age)
        group = t.SliceGroup(
            spec=t.SliceGroupSpec(
                min_member=min_member, queue=queue, priority_class=priority,
                slice=t.TPUSliceSpec(accelerator=self.p.accel(chips),
                                     num_slices=num_slices,
                                     min_slices=min_slices,
                                     max_slices=max_slices)),
            status=t.SliceGroupStatus(phase=phase, pending_since=born))
        group.metadata.name = name
        group.metadata.namespace = NS
        group.metadata.creation_timestamp = born
        if labels:
            group.metadata.labels = {self.p.const.LABEL_JOB_NAME: name}
        return self.store.create(self.sm.SLICEGROUPS, group)

    def job(self, name, workers=1, chips=8, num_slices=1, min_slices=None,
            max_slices=None, queue="", health=None, ckpt=None):
        t = self.p.types
        self.names.add(name)
        # As group(): the process-wide journal may hold another test's
        # decisions for this name.
        self.p.trace.JOURNAL.prune(NS, name)
        job = self.p.testutil.new_tpujob(worker=workers, name=name,
                                         namespace=NS)
        job.spec.slice = t.TPUSliceSpec(accelerator=self.p.accel(chips),
                                        num_slices=num_slices,
                                        min_slices=min_slices,
                                        max_slices=max_slices)
        if queue:
            job.spec.queue_name = queue
        job.spec.run_policy.health_policy = health
        job.spec.run_policy.checkpoint_policy = ckpt
        self.p.api.set_defaults(job)
        return self.store.create(self.sm.TPUJOBS, job)

    def pod(self, job, index=0, rtype="worker", chips=8, node="",
            phase="Running", released=False, gang=True):
        t, c = self.p.types, self.p.const
        resources = {self.p.resource: str(chips)} if chips else {}
        pod = t.Pod(spec=t.PodSpec(
            containers=[t.Container(name=c.DEFAULT_CONTAINER_NAME,
                                    resources=resources)],
            scheduler_name=c.DEFAULT_GANG_SCHEDULER if gang else "",
            node_name=node))
        pod.metadata.name = f"{job}-{rtype}-{index}"
        pod.metadata.namespace = NS
        pod.metadata.labels = {c.LABEL_JOB_NAME: job,
                               c.LABEL_REPLICA_TYPE: rtype,
                               c.LABEL_REPLICA_INDEX: str(index)}
        if gang:
            pod.metadata.annotations = {c.ANNOTATION_GANG_GROUP: job,
                                        c.ANNOTATION_GANG_TASK: rtype}
        pod.status.phase = phase
        pod.status.gang_released = released
        return self.store.create(self.sm.PODS, pod)

    def node(self, name, chips=8, domain="", phase="Ready",
             unschedulable=False, conditions=None, taints=(),
             node_labels=None):
        t = self.p.types
        labels = {self.p.domain_label: domain} if domain else {}
        labels.update(node_labels or {})
        node = t.Node(
            metadata=t.ObjectMeta(name=name, namespace="", labels=labels),
            spec=t.NodeSpec(chips=chips, unschedulable=unschedulable,
                            taints=[t.Taint(**kw) for kw in taints]),
            status=t.NodeStatus(phase=phase,
                                conditions=dict(conditions or {})))
        return self.store.create(self.sm.NODES, node)

    def set_node(self, name, **conditions):
        node = self.store.get(self.sm.NODES, "", name)
        node.status.conditions.update(conditions)
        for k, v in list(node.status.conditions.items()):
            if v is None:
                del node.status.conditions[k]
        self.store.update(self.sm.NODES, node)

    def scheduler(self, **kw):
        kw.setdefault("recorder", self.recorder)
        return self.p.gang.SliceGangScheduler(self.store, **kw)

    # -- observations ----------------------------------------------------

    def snap(self, label=""):
        """Append one comparable record of the store and the recorder."""
        sm = self.sm
        groups = sorted(
            (g.metadata.name, g.status.phase, g.status.displaced_reason,
             g.status.resizing_reason)
            for g in self.store.list(sm.SLICEGROUPS))
        pods = sorted(
            (p.metadata.name, p.spec.node_name, p.status.phase,
             self.p.const.ANNOTATION_PREEMPT_NOTICE
             in p.metadata.annotations)
            for p in self.store.list(sm.PODS))
        nodes = sorted((n.metadata.name, n.spec.unschedulable)
                       for n in self.store.list(sm.NODES))
        jobs = []
        for j in sorted(self.store.list(sm.TPUJOBS),
                        key=lambda j: j.metadata.name):
            worker = j.spec.replica_specs.get("worker")
            jobs.append((j.metadata.name, j.spec.slice.num_slices,
                         worker.replicas if worker else None))
        events = self.recorder.events
        new = [(e.object_name, e.reason)
               for e in events[self._seen_events:]]
        self._seen_events = len(events)
        self.trace.append({"at": label, "groups": groups, "pods": pods,
                           "nodes": nodes, "jobs": jobs, "events": new})
        return self.trace[-1]

    def phase(self, name):
        return self.store.get(self.sm.SLICEGROUPS, NS, name).status.phase

    def decisions(self, kinds=("admission.admit", "preempted",
                               "displaced", "resized")):
        """Journal decisions of this world's groups in the order taken:
        admission order, preemption victims, displacements, resizes."""
        out = []
        for name in self.names:
            for rec in self.p.trace.JOURNAL.decisions(NS, name) or []:
                if rec["kind"] in kinds:
                    out.append((rec["seq"], name, rec["kind"],
                                rec["reason"]))
        return [rec[1:] for rec in sorted(out)]


def both(scenario, clock):
    """Run ``scenario`` on the JAX package, then on the port, from the
    same clock reading; return both worlds."""
    start = clock.t
    worlds = []
    for pkg in (JAX, PORT):
        clock.t = start
        w = World(pkg, clock)
        scenario(w)
        w.trace.append({"decisions": w.decisions()})
        worlds.append(w)
    return worlds


def assert_same(scenario, clock):
    jw, tw = both(scenario, clock)
    assert tw.trace == jw.trace
    return jw


# ---------------------------------------------------------------------------
# The device names pair up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SAME_SHAPE)
def test_v5e_and_h100_slices_have_the_same_shape(n):
    j = JAX.topology.parse_accelerator(JAX.accel(n))
    t = PORT.topology.parse_accelerator(PORT.accel(n))
    assert (t.chips, t.hosts_per_slice, t.devices_per_host) == (
        j.chips, j.hosts_per_slice, j.devices_per_host)


# ---------------------------------------------------------------------------
# Gang admission: fairness, priority classes, queue quotas, preemption,
# multislice, the draining-provider window
# ---------------------------------------------------------------------------

PRI = {"prod": 100, "batch": 10, "low": 1}


def fifo_tiebreak(w):
    s = w.scheduler(total_chips=8)
    w.group("younger", age=1)
    w.group("older", age=60)
    s._admit()
    w.snap()


def priority_beats_fifo(w):
    s = w.scheduler(total_chips=8, priority_classes=PRI)
    w.group("old-batch", priority="batch", age=60)
    w.group("new-prod", priority="prod")
    w.group("numeric", priority="50", age=90)
    w.group("unknown", priority="no-such-class", age=120)
    s._admit()
    w.snap()


def aged_grace_backfill(w):
    s = w.scheduler(total_chips=10, fairness="aged", aging_seconds=300,
                    priority_classes=PRI)
    w.group("running", phase="Inqueue")
    w.group("waiting-prod", priority="prod", age=5)
    w.group("small-batch", chips=1, priority="batch")
    w.group("small-prod", chips=1, priority="prod")
    s._admit()
    w.snap("within grace")
    # Past the grace window the waiting group reserves the freed chips
    # against every later group, whichever its queue.
    w.clock.advance(400)
    w.group("late", chips=1, queue="b")
    s._admit()
    w.snap("aged out")


def aged_reservation_cross_queue(w):
    s = w.scheduler(total_chips=10, fairness="aged", aging_seconds=10)
    w.group("running", chips=4, phase="Inqueue", queue="a")
    w.group("starved", chips=8, queue="a", age=600)
    w.group("greedy", chips=4, queue="b")
    s._admit()
    w.snap()


def strict_head_of_line(w):
    s = w.scheduler(total_chips=10, fairness="strict")
    w.group("running", chips=4, phase="Inqueue", queue="a")
    w.group("head-a", chips=8, queue="a", age=60)
    w.group("behind-a", chips=1, queue="a", age=30)
    w.group("other-b", chips=1, queue="b")
    s._admit()
    w.snap()


def backfill_skips(w):
    s = w.scheduler(total_chips=10, fairness="backfill")
    w.group("running", chips=4, phase="Inqueue")
    w.group("big", chips=8, age=600)
    w.group("small", chips=4)
    s._admit()
    w.snap()


def queue_quotas(w):
    s = w.scheduler(total_chips=100, fairness="strict",
                    queue_quotas={"batch": 8})
    w.group("whale", chips=16, queue="batch", age=60)
    w.group("b1", chips=8, queue="batch", age=10)
    w.group("b2", chips=8, queue="batch")
    w.group("free", chips=8, queue="other")
    s._admit()
    w.snap()


def preemption_victims(w):
    s = w.scheduler(total_chips=24, preemption=True, priority_classes=PRI)
    w.group("batch-old", chips=4, priority="batch", phase="Inqueue", age=60)
    w.group("batch-young", chips=4, priority="batch", phase="Inqueue",
            age=5)
    w.group("low", chips=4, priority="low", phase="Inqueue", age=120)
    w.group("running", chips=8, priority="low", phase="Running", age=200)
    w.group("peer", chips=4, priority="prod", phase="Inqueue", age=300)
    w.pod("low", chips=4)
    w.group("preemptor", chips=8, priority="prod")
    s._admit()
    w.snap("victims flipped, one still dying")
    s._admit()
    w.snap("preemptor admitted")


def preemption_all_or_nothing(w):
    s = w.scheduler(total_chips=8, preemption=True, priority_classes=PRI)
    w.group("running", chips=4, priority="prod", phase="Running")
    w.group("small-victim", chips=1, priority="batch", phase="Inqueue")
    w.group("preemptor", chips=8, priority="prod")
    s._admit()
    w.snap()


def preemption_same_queue_and_earmark(w):
    s = w.scheduler(total_chips=100, preemption=True, fairness="backfill",
                    priority_classes=PRI, queue_quotas={"q": 8})
    w.group("foreign", chips=8, priority="low", phase="Inqueue",
            queue="other", age=60)
    w.group("same-q", chips=8, priority="batch", phase="Inqueue",
            queue="q", age=30)
    w.pod("same-q")
    w.group("preemptor", chips=8, priority="prod", queue="q")
    w.group("lowrider", chips=4, priority="low", queue="q")
    s._admit()
    w.snap()
    s._admit()
    w.snap()


def failed_eviction_retries(w):
    s = w.scheduler(total_chips=8, preemption=True, priority_classes=PRI)
    calls = []

    class FlakyControl:
        def delete_pod(self, ns, name, job):
            calls.append(name)
            if len(calls) == 1:
                raise RuntimeError("injected API timeout")
            w.store.try_delete(w.sm.PODS, ns, name)

    s.pod_control = FlakyControl()
    w.group("victim", priority="batch", phase="Inqueue", age=60)
    w.job("victim")
    w.pod("victim")
    w.group("preemptor", priority="prod")
    for _ in range(3):
        s._admit()
        w.snap()
    w.trace.append({"deletes": calls})


def multislice_budget(w):
    s = w.scheduler(total_chips=32)
    w.group("two-slices", chips=8, num_slices=2, age=30)
    w.group("three-slices", chips=8, num_slices=3, age=20)
    w.group("one-slice", chips=16, age=10)
    s._admit()
    w.snap()


def draining_window(w):
    """Chips of deleted pods stay counted while their processes die:
    the successor waits for the drain, then readmit lets it in."""
    dying = {}
    s = w.scheduler(total_chips=8,
                    draining_provider=lambda: dict(dying))
    w.group("successor")
    dying[(NS, "gone")] = {"pods": 1, "chips": 8}
    s._admit()
    w.snap("victim still dying")
    dying.clear()
    s.readmit()
    w.snap("drained")


def domain_infeasible(w):
    s = w.scheduler(total_chips=64, domain_capacity_provider=lambda: 8)
    w.group("wide", chips=16, age=30)
    w.group("fits", chips=8)
    s._admit()
    w.snap()


def gate_released_pod_occupies(w):
    s = w.scheduler(total_chips=8, preemption=True, priority_classes=PRI)
    w.group("victim", priority="batch", phase="Inqueue", age=60)
    w.pod("victim", phase="Pending", released=True)
    w.group("preemptor", priority="prod")
    s._admit()
    w.snap()
    s._admit()
    w.snap()


GANG_SCENARIOS = {
    "fifo-tiebreak": (fifo_tiebreak, {"older": "Inqueue",
                                      "younger": "Pending"}),
    "priority-beats-fifo": (priority_beats_fifo, {"new-prod": "Inqueue",
                                                  "numeric": "Pending"}),
    "aged-grace-backfill": (aged_grace_backfill, {"small-prod": "Inqueue",
                                                  "small-batch": "Pending",
                                                  "late": "Pending"}),
    "aged-reservation": (aged_reservation_cross_queue,
                         {"starved": "Pending", "greedy": "Pending"}),
    "strict-head-of-line": (strict_head_of_line,
                            {"behind-a": "Pending", "other-b": "Inqueue"}),
    "backfill": (backfill_skips, {"big": "Pending", "small": "Inqueue"}),
    "queue-quotas": (queue_quotas, {"whale": "Pending", "b1": "Inqueue",
                                    "b2": "Pending", "free": "Inqueue"}),
    "preemption-victims": (preemption_victims,
                           {"preemptor": "Inqueue", "low": "Pending",
                            "batch-young": "Pending",
                            "batch-old": "Inqueue", "running": "Running",
                            "peer": "Inqueue"}),
    "preemption-all-or-nothing": (preemption_all_or_nothing,
                                  {"small-victim": "Inqueue",
                                   "preemptor": "Pending"}),
    "preemption-same-queue": (preemption_same_queue_and_earmark,
                              {"foreign": "Inqueue", "same-q": "Pending",
                               "preemptor": "Inqueue",
                               "lowrider": "Pending"}),
    "failed-eviction-retries": (failed_eviction_retries,
                                {"preemptor": "Inqueue"}),
    "multislice-budget": (multislice_budget, {"two-slices": "Inqueue",
                                              "three-slices": "Pending",
                                              "one-slice": "Inqueue"}),
    "draining-window": (draining_window, {"successor": "Inqueue"}),
    "domain-infeasible": (domain_infeasible, {"wide": "Pending",
                                              "fits": "Inqueue"}),
    "gate-released-pod": (gate_released_pod_occupies,
                          {"preemptor": "Inqueue"}),
}


@pytest.mark.parametrize("name", sorted(GANG_SCENARIOS))
def test_gang_admission_matches_jax(name, clock):
    scenario, want = GANG_SCENARIOS[name]
    jw = assert_same(scenario, clock)
    assert {n: jw.phase(n) for n in want} == want


def test_admission_order_and_victims_are_jax_order(clock):
    jw = assert_same(preemption_victims, clock)
    decisions = jw.trace[-1]["decisions"]
    assert [d[0] for d in decisions if d[1] == "preempted"] == [
        "low", "batch-young"]
    assert [d[0] for d in decisions if d[1] == "admission.admit"] == [
        "preemptor"]


def test_draining_window_holds_then_releases(clock):
    jw = assert_same(draining_window, clock)
    assert [g[1] for t in jw.trace[:2] for g in t["groups"]] == [
        "Pending", "Inqueue"]


# ---------------------------------------------------------------------------
# Elastic: min/max slices, resize signals, reclaim shrink
# ---------------------------------------------------------------------------

def elastic_grow(w):
    seen = []

    def signals(ns, name):
        seen.append(name)
        return {"serving_queue_depth": 7.0}

    w.job("ela", workers=1, chips=4, max_slices=3)
    w.group("ela", chips=4, phase="Running", max_slices=3, min_slices=1)
    s = w.scheduler(total_chips=12, elastic=True, resize_signals=signals)
    s.readmit()
    w.snap("grown")
    s.readmit()
    w.snap("held while settling")
    w.trace.append({"signals": seen})


def elastic_stands_down(w):
    w.job("ela", workers=1, chips=4, max_slices=3)
    w.group("ela", chips=4, phase="Running", max_slices=3, min_slices=1)
    w.group("pending", chips=4, num_slices=2)
    s = w.scheduler(total_chips=8, elastic=True)
    s.readmit()
    w.snap()


def _quota_cohort(w, borrower_min):
    t = w.p.types
    for q in ("tenant-a", "tenant-b"):
        cq = t.ClusterQueue(spec=t.ClusterQueueSpec(nominal_chips=4,
                                                    cohort="c"))
        cq.metadata.name, cq.metadata.namespace = f"cq-{q}", ""
        w.store.create(w.sm.CLUSTERQUEUES, cq)
        tq = t.TenantQueue(spec=t.TenantQueueSpec(cluster_queue=f"cq-{q}"))
        tq.metadata.name, tq.metadata.namespace = q, NS
        w.store.create(w.sm.TENANTQUEUES, tq)
    w.job("borrower", workers=2, chips=4, num_slices=2,
          min_slices=borrower_min, max_slices=3, queue="tenant-a")
    w.group("borrower", chips=4, num_slices=2, min_slices=borrower_min,
            max_slices=3, queue="tenant-a", phase="Running", min_member=2)
    w.group("demander", chips=4, queue="tenant-b")


def elastic_reclaim_shrinks(w):
    _quota_cohort(w, borrower_min=1)
    s = w.scheduler(total_chips=8, elastic=True,
                    quota=w.p.quota.TenantQueueManager(w.store))
    s.readmit()
    w.snap()


def elastic_reclaim_at_floor_displaces(w):
    _quota_cohort(w, borrower_min=2)
    s = w.scheduler(total_chips=8, elastic=True,
                    quota=w.p.quota.TenantQueueManager(w.store))
    s.readmit()
    w.snap()


def elastic_shrink_floor(w):
    w.job("ela", workers=2, chips=4, num_slices=2, min_slices=2)
    w.group("ela", chips=4, num_slices=2, min_slices=2, phase="Running")
    s = w.scheduler(total_chips=8, elastic=True)
    w.trace.append({"shrink": s.try_shrink(NS, "ela", 1, "drain", "test")})
    w.snap()


ELASTIC_SCENARIOS = {
    "grow": (elastic_grow, {"ela": 3}),
    "stands-down": (elastic_stands_down, {"ela": 1}),
    "reclaim-shrinks": (elastic_reclaim_shrinks, {"borrower": 1}),
    "reclaim-at-floor": (elastic_reclaim_at_floor_displaces,
                         {"borrower": 2}),
    "shrink-floor": (elastic_shrink_floor, {"ela": 2}),
}


@pytest.mark.parametrize("name", sorted(ELASTIC_SCENARIOS))
def test_elastic_resizes_match_jax(name, clock):
    scenario, want = ELASTIC_SCENARIOS[name]
    jw = assert_same(scenario, clock)
    last = [t for t in jw.trace if "jobs" in t][-1]
    slices = {j[0]: j[1] for j in last["jobs"]}
    assert {n: slices[n] for n in want} == want
    if name == "grow":
        ela = [g for g in jw.trace[0]["groups"] if g[0] == "ela"][0]
        assert ela[3].startswith("grow to 3")
        assert "serving_queue_depth=7" in ela[3]
        assert ("ela", "GangResized") in jw.trace[0]["events"]
    if name == "reclaim-at-floor":
        borrower = [g for g in jw.trace[0]["groups"]
                    if g[0] == "borrower"][0]
        assert borrower[1] == "Pending" and borrower[2]


# ---------------------------------------------------------------------------
# Slice health: cordons, grace, drains, elastic shrink, rebind
# ---------------------------------------------------------------------------

def _health(w, grace=0.0, gang_kw=None, ckpt=None):
    s = w.scheduler(total_chips=None, ckpt=ckpt, **(gang_kw or {}))
    h = w.p.health.SliceHealthController(
        w.store, client=None, gang=s, recorder=w.recorder,
        default_grace_seconds=grace, ckpt=ckpt)
    return s, h


def health_cordon_and_drain(w):
    s, h = _health(w)
    hp = w.p.types.HealthPolicy
    w.job("opted", health=hp(enabled=True))
    w.group("opted", phase="Inqueue")
    w.pod("opted", node="n1")
    w.job("plain")
    w.group("plain", phase="Inqueue")
    w.pod("plain", node="n2")
    w.node("n1", conditions={"Ready": "True", "MaintenancePending": "True"})
    w.node("n2", conditions={"Ready": "True", "MaintenancePending": "True"})
    w.node("n3", phase="NotReady")
    w.node("spare", domain="d2")
    h.health_pass()
    w.snap("drained")
    h.health_pass()
    w.snap("idempotent")


def health_grace_then_drain(w):
    s, h = _health(w, grace=30.0)
    w.job("j", health=w.p.types.HealthPolicy(enabled=True))
    w.group("j", phase="Inqueue")
    w.pod("j", node="n1")
    w.node("n1", conditions={"Ready": "True", "TerminationScheduled": "True"})
    h.health_pass()
    w.snap("in grace")
    w.clock.advance(31.0)
    h.health_pass()
    w.snap("grace over")


def health_signal_clears_in_grace(w):
    s, h = _health(w)
    w.job("j", health=w.p.types.HealthPolicy(enabled=True,
                                             drain_grace_seconds=60.0))
    w.group("j", phase="Inqueue")
    w.pod("j", node="n1")
    w.node("n1", conditions={"Ready": "True", "MaintenancePending": "True"})
    h.health_pass()
    w.snap("in grace")
    w.set_node("n1", MaintenancePending=None)
    w.clock.advance(61.0)
    h.health_pass()
    w.snap("healed")


def health_maintenance_ignored_by_policy(w):
    s, h = _health(w)
    w.job("j", health=w.p.types.HealthPolicy(enabled=True,
                                             handle_maintenance=False))
    w.group("j", phase="Inqueue")
    w.pod("j", node="n1")
    w.pod("j", index=1, node="n2")
    w.node("n1", conditions={"Ready": "True", "MaintenancePending": "True"})
    w.node("n2", conditions={"Ready": "True"})
    h.health_pass()
    w.snap("notice ignored")
    w.set_node("n2", TerminationScheduled="True")
    h.health_pass()
    w.snap("termination drains")


def health_rebind_observed(w):
    s, h = _health(w)
    w.job("j", health=w.p.types.HealthPolicy(enabled=True))
    w.group("j", phase="Inqueue")
    w.pod("j", node="n1")
    w.node("n1", conditions={"Ready": "True", "MaintenancePending": "True"})
    h.health_pass()
    w.snap("drained")
    s._admit()
    w.clock.advance(7.5)
    w.pod("j", node="n2")
    group = w.store.get(w.sm.SLICEGROUPS, NS, "j")
    group.status.phase = "Running"
    w.store.update_status(w.sm.SLICEGROUPS, group)
    h.health_pass()
    w.snap("rebound")
    w.trace.append({"rebind": w.p.metrics.drain_rebind_seconds.sum_value(
        job_namespace=NS) - w.rebind_before})


def health_elastic_shrink(w):
    s, h = _health(w, gang_kw={"elastic": True})
    w.job("ela", workers=2, chips=4, num_slices=2, min_slices=1,
          max_slices=2, health=w.p.types.HealthPolicy(enabled=True))
    w.group("ela", chips=4, num_slices=2, min_slices=1, max_slices=2,
            phase="Running", min_member=2)
    w.pod("ela", index=0, chips=4, node="n1")
    w.pod("ela", index=1, chips=4, node="n2")
    w.node("n1")
    w.node("n2", conditions={"Ready": "True", "MaintenancePending": "True"})
    h.health_pass()
    w.snap()


def health_displaced_readmits_first(w):
    s, h = _health(w)
    s.total_chips = 8
    w.group("displaced", phase="Inqueue", age=600)
    w.group("newcomer", age=1)
    w.trace.append({"displace": s.displace(NS, "displaced",
                                           "node degraded")})
    w.snap()
    s._admit()
    w.snap()


HEALTH_SCENARIOS = {
    "cordon-and-drain": health_cordon_and_drain,
    "grace-then-drain": health_grace_then_drain,
    "signal-clears-in-grace": health_signal_clears_in_grace,
    "maintenance-ignored": health_maintenance_ignored_by_policy,
    "rebind-observed": health_rebind_observed,
    "elastic-shrink": health_elastic_shrink,
    "displaced-readmits-first": health_displaced_readmits_first,
}


class LaggingPodControl:
    """Evictions as on the kube backend: the API server deletes the pod,
    and the store, an informer cache, lists it until the watch event
    arrives."""

    def __init__(self):
        self.deleted = []

    def delete_pod(self, namespace, name, job):
        self.deleted.append(name)


def test_a_drain_is_not_repeated_before_its_evictions_reach_the_store(
        clock):
    """One maintenance episode is one drain: a pass that still lists the
    evicted pods (their deletions not yet watched) leaves the gang alone,
    and a new pod on the degraded node is drained again. The JAX package
    drains twice here, which its kube e2e case sees as a flaky
    ``slice_drains`` count."""
    w = World(PORT, clock)
    lag = LaggingPodControl()
    health = PORT.health.SliceHealthController(
        w.store, client=None, gang=w.scheduler(total_chips=None),
        pod_control=lag, recorder=w.recorder)
    w.job("j", health=PORT.types.HealthPolicy(enabled=True))
    w.group("j", phase="Inqueue")
    w.pod("j", node="n1")
    w.node("n1", conditions={"Ready": "True", "MaintenancePending": "True"})
    drains = PORT.metrics.slice_drains.value(job_namespace=NS)
    health.health_pass()
    health.health_pass()
    assert lag.deleted == ["j-worker-0"]
    assert PORT.metrics.slice_drains.value(job_namespace=NS) == drains + 1
    # The informer sees the deletion; the engine's new pod lands on the
    # still degraded node: a new episode.
    w.store.delete(w.sm.PODS, NS, "j-worker-0")
    w.pod("j", node="n1")
    health.health_pass()
    assert lag.deleted == ["j-worker-0", "j-worker-0"]
    assert PORT.metrics.slice_drains.value(job_namespace=NS) == drains + 2


@pytest.mark.parametrize("name", sorted(HEALTH_SCENARIOS))
def test_slice_health_matches_jax(name, clock):
    def scenario(w):
        w.rebind_before = w.p.metrics.drain_rebind_seconds.sum_value(
            job_namespace=NS)
        HEALTH_SCENARIOS[name](w)

    jw = assert_same(scenario, clock)
    t = jw.trace
    if name == "cordon-and-drain":
        assert dict(t[0]["nodes"]) == {"n1": True, "n2": True, "n3": False,
                                       "spare": False}
        assert ("opted", "SliceDrained") in t[0]["events"]
        assert [p[0] for p in t[0]["pods"]] == ["plain-worker-0"]
        assert t[1]["events"] == []
    if name == "grace-then-drain":
        assert len(t[0]["pods"]) == 1 and t[1]["pods"] == []
    if name == "signal-clears-in-grace":
        assert len(t[1]["pods"]) == 1
    if name == "maintenance-ignored":
        assert len(t[0]["pods"]) == 2 and t[1]["pods"] == []
    if name == "rebind-observed":
        assert ("j", "SliceRebound") in t[1]["events"]
        assert t[2] == {"rebind": 7.5}
    if name == "elastic-shrink":
        assert t[0]["jobs"] == [("ela", 1, 1)]
    if name == "displaced-readmits-first":
        assert dict((g[0], g[1]) for g in t[2]["groups"]) == {
            "displaced": "Inqueue", "newcomer": "Pending"}


@pytest.mark.parametrize("conditions, phase, unschedulable", [
    ({"Ready": "True"}, "Ready", False),
    ({}, "NotReady", False),
    ({"Ready": "True", "MaintenancePending": "True"}, "Ready", False),
    ({"MaintenancePending": "True", "TerminationScheduled": "True"},
     "Ready", False),
    ({"MaintenancePending": "True"}, "Ready", True),
    ({}, "Ready", True),
])
def test_classify_node_matches_jax(conditions, phase, unschedulable, clock):
    got = []
    for pkg in (JAX, PORT):
        w = World(pkg, clock)
        node = w.node("n", phase=phase, unschedulable=unschedulable,
                      conditions=conditions)
        got.append((pkg.health.classify_node(node),
                    pkg.health.node_maintenance_pending(node)))
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# Binder: placement, 409s, predicates
# ---------------------------------------------------------------------------

class StubGang:
    """The binder's two touchpoints on the scheduler."""

    def __init__(self):
        self.readmits = 0

    def _priority_of(self, sg):
        try:
            return int(sg.spec.priority_class or 0)
        except ValueError:
            return 0

    def readmit(self):
        self.readmits += 1


class StubBindClient:
    """pods/binding against the same store: the first bind wins, a second
    one is a 409; names can be set to fail or to conflict."""

    def __init__(self, w):
        self.w = w
        self.binds = []
        self.fail = set()
        self.conflict = set()

    def bind_pod(self, ns, name, node):
        sm = self.w.sm
        if name in self.fail:
            raise OSError("injected bind transport failure")
        if name in self.conflict:
            raise sm.ConflictError(f"pod {ns}/{name} is already assigned")
        pod = self.w.store.get(sm.PODS, ns, name)
        if pod.spec.node_name:
            raise sm.ConflictError(f"pod {ns}/{name} is already assigned "
                                   f"to node {pod.spec.node_name}")
        pod.spec.node_name = node
        self.w.store.update(sm.PODS, pod)
        self.binds.append((name, node))


def _binder(w):
    w.client = StubBindClient(w)
    w.stub_gang = StubGang()
    return w.p.binder.SliceGangBinder(w.store, w.client, w.stub_gang,
                                      recorder=w.recorder)


def bind_whole_slice_one_domain(w):
    b = _binder(w)
    for i in range(2):
        w.node(f"a{i}", domain="dom-a")
    for i in range(2):
        w.node(f"b{i}", domain="dom-b", chips=4)
    w.group("g", chips=16, phase="Inqueue")
    w.job("g", workers=2, chips=16)
    for i in range(2):
        w.pod("g", index=i, phase="Pending")
    b.bind_pass()
    w.snap()


def bind_no_domain_fits(w):
    b = _binder(w)
    w.node("a0", domain="dom-a")
    w.node("b0", domain="dom-b")
    w.group("g", chips=16, phase="Inqueue")
    w.job("g", workers=2, chips=16)
    for i in range(2):
        w.pod("g", index=i, phase="Pending")
    b.bind_pass()
    w.snap()


def bind_multislice_and_pins(w):
    b = _binder(w)
    w.node("a0", domain="dom-a")
    w.node("b0", domain="dom-b")
    w.node("c0", domain="dom-c", unschedulable=True)
    w.group("ms", chips=8, num_slices=2, phase="Inqueue")
    w.job("ms", workers=2, chips=8, num_slices=2)
    for i in range(2):
        w.pod("ms", index=i, phase="Pending")
    w.group("pinned", chips=16, phase="Inqueue")
    w.job("pinned", workers=2, chips=16)
    w.pod("pinned", index=0, node="c0")
    w.pod("pinned", index=1, phase="Pending")
    b.bind_pass()
    w.snap()


def bind_admission_gate_and_priority(w):
    b = _binder(w)
    w.node("n0")
    w.group("held", phase="Pending", priority="1")
    w.pod("held", phase="Pending")
    w.group("low", phase="Inqueue", priority="1")
    w.pod("low", phase="Pending")
    w.group("high", phase="Inqueue", priority="9")
    w.pod("high", phase="Pending")
    w.pod("foreign", phase="Pending", gang=False)
    b.bind_pass()
    w.snap()


def bind_conflicts_and_failures(w):
    b = _binder(w)
    w.node("n0", chips=16)
    w.group("g", chips=1, phase="Inqueue")
    w.job("g", chips=1)
    w.pod("g", index=0, chips=1, phase="Pending")
    w.group("h", chips=1, phase="Inqueue")
    w.job("h", chips=1)
    w.pod("h", index=0, chips=1, phase="Pending")
    w.client.conflict.add("g-worker-0")
    w.client.fail.add("h-worker-0")
    for _ in range(3):
        b.bind_pass()
        w.snap()
    w.client.fail.clear()
    b.bind_pass()
    w.snap()
    w.trace.append({"binds": w.client.binds,
                    "failures": sorted(b._bind_failures.items())})


def bind_predicates(w):
    b = _binder(w)
    r = w.p.resource
    w.node("tainted", chips=8, taints=[{"key": "dedicated", "value": "x",
                                        "effect": "NoSchedule"}])
    w.node("pool", chips=8, taints=[{"key": r, "value": "present",
                                     "effect": "NoSchedule"}],
           node_labels={"pool": "gpu"})
    w.node("cpu-only", chips=0)
    w.group("g", chips=8, phase="Inqueue")
    pod = w.pod("g", phase="Pending")
    pod.spec.tolerations = [w.p.types.Toleration(key=r, operator="Exists")]
    pod.spec.node_selector = {"pool": "gpu"}
    w.store.update(w.sm.PODS, pod)
    w.group("c", chips=8, phase="Inqueue")
    coord = w.pod("c", rtype="chief", chips=0, phase="Pending")
    coord.spec.containers[0].resources = {"cpu": "500m", "memory": "1Gi"}
    w.store.update(w.sm.PODS, coord)
    w.group("u", chips=8, phase="Inqueue")
    w.pod("u", phase="Pending")
    b.bind_pass()
    w.snap()
    nodes = {n.metadata.name: n for n in w.store.list(w.sm.NODES)}
    pods = {p.metadata.name: p for p in w.store.list(w.sm.PODS)}
    rejects = []
    for p in sorted(pods):
        for n in sorted(nodes):
            why = w.p.binder.node_rejects_pod(pods[p], nodes[n])
            rejects.append((p, n, why and why.replace(w.p.resource,
                                                      "<device>")))
    w.trace.append({"rejects": rejects})


def bind_prefers_clean_domain(w):
    b = _binder(w)
    w.node("m0", domain="dom-m", conditions={"Ready": "True",
                                             "MaintenancePending": "True"})
    w.node("c0", domain="dom-c", chips=16)
    w.group("g", chips=8, phase="Inqueue")
    w.pod("g", phase="Pending")
    b.bind_pass()
    w.snap()


BINDER_SCENARIOS = {
    "whole-slice-one-domain": bind_whole_slice_one_domain,
    "no-domain-fits": bind_no_domain_fits,
    "multislice-and-pins": bind_multislice_and_pins,
    "admission-gate-and-priority": bind_admission_gate_and_priority,
    "conflicts-and-failures": bind_conflicts_and_failures,
    "predicates": bind_predicates,
    "prefers-clean-domain": bind_prefers_clean_domain,
}


@pytest.mark.parametrize("name", sorted(BINDER_SCENARIOS))
def test_binder_matches_jax(name, clock):
    jw = assert_same(BINDER_SCENARIOS[name], clock)
    bound = {p[0]: p[1] for p in jw.trace[0]["pods"]}
    if name == "whole-slice-one-domain":
        assert bound == {"g-worker-0": "a0", "g-worker-1": "a1"} or \
            bound == {"g-worker-0": "a1", "g-worker-1": "a0"}
    if name == "no-domain-fits":
        assert set(bound.values()) == {""}
        assert ("g", "GangBindUnsatisfiable") in jw.trace[0]["events"]
    if name == "multislice-and-pins":
        assert {bound["ms-worker-0"], bound["ms-worker-1"]} == {"a0", "b0"}
        assert bound["pinned-worker-1"] == ""  # pinned to cordoned dom-c
    if name == "admission-gate-and-priority":
        assert bound == {"held-worker-0": "", "low-worker-0": "",
                         "high-worker-0": "n0", "foreign-worker-0": ""}
    if name == "conflicts-and-failures":
        last = {p[0]: p[1] for p in jw.trace[3]["pods"]}
        assert last == {"g-worker-0": "", "h-worker-0": "n0"}
        assert ("h", "BindFailing") in jw.trace[2]["events"]
    if name == "predicates":
        assert bound == {"g-worker-0": "pool", "c-chief-0": "cpu-only",
                         "u-worker-0": ""}
    if name == "prefers-clean-domain":
        assert bound == {"g-worker-0": "c0"}


@pytest.mark.parametrize("labels, want", [
    ({"first": "dom-a", "pool": "pool-b"}, "dom-a"),
    ({"pool": "pool-b"}, "pool-b"),
    ({}, "n"),
])
def test_nvlink_domain_reads_labels_in_jax_order(labels, want):
    got = []
    for pkg in (JAX, PORT):
        t = pkg.types
        keys = {"first": pkg.domain_label,
                "pool": pkg.const.LABEL_GKE_NODEPOOL}
        node = t.Node(metadata=t.ObjectMeta(
            name="n", labels={keys[k]: v for k, v in labels.items()}))
        got.append(pkg.node_domain(node))
    assert got == [want, want]
    assert PORT.const.LABEL_NVLINK_DOMAIN == "tpu-operator.dev/nvlink-domain"
    assert PORT.const.LABEL_GKE_NODEPOOL == JAX.const.LABEL_GKE_NODEPOOL


def test_pod_demand_counts_gpus_where_jax_counts_chips():
    got = []
    for pkg in (JAX, PORT):
        t = pkg.types
        pod = t.Pod(spec=t.PodSpec(containers=[
            t.Container(resources={pkg.resource: "4"}),
            t.Container(resources={pkg.resource: "2.0", "cpu": "1"}),
            t.Container(resources={pkg.resource: "garbage"})]))
        got.append(pkg.binder.pod_chip_demand(pod))
    assert got == [6, 6]
