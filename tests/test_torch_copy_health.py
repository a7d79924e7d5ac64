"""Copy of ``tests/test_health.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Slice-health & auto-repair tests (controller/health.py).

Unit level drives ``health_pass`` directly against the Store (cordon,
grace windows, policy gating, atomic drain, displaced re-queue
ordering); the e2e tier runs the full repair loop on the kube backend
against the fake apiserver: injected maintenance event under a running
1c+4w gang -> cordon -> atomic slice drain -> re-admission -> rebind on
spare capacity -> resume via restart-with-identity, with the drain
events and slice_drains/time-to-rebind metrics observable. A control
test pins that a job without a HealthPolicy is left untouched.
"""

import datetime as dt
import time

import pytest

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    Container,
    HealthPolicy,
    JobConditionType,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    RunPolicy,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.controller.gang import (
    PHASE_INQUEUE,
    PHASE_PENDING,
    PHASE_RUNNING,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.controller.health import (
    COND_MAINTENANCE,
    COND_TERMINATION,
    NODE_DEGRADED,
    NODE_DRAINING,
    NODE_HEALTHY,
    SliceHealthController,
    classify_node,
    node_maintenance_pending,
)
from tf_operator_tpu_torch.runtime import metrics, store as store_mod
from tf_operator_tpu_torch.runtime.events import (
    REASON_NODE_CORDONED,
    REASON_SLICE_DRAIN_PENDING,
    REASON_SLICE_DRAINED,
    REASON_SLICE_REBOUND,
    Recorder,
)
from tf_operator_tpu_torch.runtime.store import Store


def _now():
    return dt.datetime.now(dt.timezone.utc)


def make_node(name, chips=8, domain="", phase="Ready", unschedulable=False,
              conditions=None) -> Node:
    labels = {constants.LABEL_NVLINK_DOMAIN: domain} if domain else {}
    return Node(
        metadata=ObjectMeta(name=name, namespace="", labels=labels),
        spec=NodeSpec(chips=chips, unschedulable=unschedulable),
        status=NodeStatus(phase=phase, conditions=dict(conditions or {})))


def add_node(store, **kw) -> Node:
    return store.create(store_mod.NODES, make_node(**kw))


def add_job(store, name, health=None, accelerator="h100-8",
            workers=1) -> TPUJob:
    job = TPUJob(metadata=ObjectMeta(name=name, namespace="default"))
    job.spec = TPUJobSpec(
        replica_specs={"worker": ReplicaSpec(
            replicas=workers,
            template=PodTemplateSpec(spec=PodSpec(containers=[
                Container(name=constants.DEFAULT_CONTAINER_NAME)])),
            restart_policy=RestartPolicy.NEVER)},
        run_policy=RunPolicy(health_policy=health),
        slice=TPUSliceSpec(accelerator=accelerator))
    return store.create(store_mod.TPUJOBS, job)


def add_group(store, name, chips=8, phase=PHASE_PENDING,
              age_seconds=0.0, min_member=1) -> SliceGroup:
    group = SliceGroup(
        spec=SliceGroupSpec(min_member=min_member,
                            slice=TPUSliceSpec(
                                accelerator=f"h100-{chips}")),
        status=SliceGroupStatus(
            phase=phase,
            pending_since=_now() - dt.timedelta(seconds=age_seconds)))
    group.metadata.name = name
    group.metadata.namespace = "default"
    group.metadata.creation_timestamp = \
        _now() - dt.timedelta(seconds=age_seconds)
    return store.create(store_mod.SLICEGROUPS, group)


def add_pod(store, group, index=0, node="", phase="Running",
            chips=8) -> Pod:
    pod = Pod(spec=PodSpec(
        containers=[Container(
            resources={constants.RESOURCE_GPU: str(chips)})],
        scheduler_name=constants.DEFAULT_GANG_SCHEDULER,
        node_name=node))
    pod.metadata.name = f"{group}-worker-{index}"
    pod.metadata.namespace = "default"
    pod.metadata.labels = {
        constants.LABEL_JOB_NAME: group,
        constants.LABEL_REPLICA_TYPE: "worker",
        constants.LABEL_REPLICA_INDEX: str(index),
    }
    pod.metadata.annotations = {
        constants.ANNOTATION_GANG_GROUP: group,
        constants.ANNOTATION_GANG_TASK: "worker",
    }
    pod.status.phase = phase
    return store.create(store_mod.PODS, pod)


@pytest.fixture
def store():
    return Store()


@pytest.fixture
def gang(store):
    return SliceGangScheduler(store, total_chips=None)


@pytest.fixture
def recorder():
    return Recorder()


@pytest.fixture
def health(store, gang, recorder):
    # client=None: cordon via the store; pod_control=None: store deletes.
    return SliceHealthController(store, client=None, gang=gang,
                                 recorder=recorder)


def node_of(store, name):
    return store.get(store_mod.NODES, "", name)


def group_phase(store, name):
    return store.get(store_mod.SLICEGROUPS, "default", name).status.phase


def pod_names(store):
    return {p.metadata.name for p in store.list(store_mod.PODS)}


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

class TestClassification:
    def test_healthy_node(self):
        n = make_node(name="n1", conditions={"Ready": "True"})
        assert classify_node(n) == (NODE_HEALTHY, "")
        assert not node_maintenance_pending(n)

    def test_not_ready_is_degraded(self):
        n = make_node(name="n1", phase="NotReady")
        assert classify_node(n) == (NODE_DEGRADED, "NotReady")

    def test_maintenance_pending_is_degraded(self):
        n = make_node(name="n1",
                      conditions={"Ready": "True",
                                  COND_MAINTENANCE: "True"})
        assert classify_node(n) == (NODE_DEGRADED, COND_MAINTENANCE)
        assert node_maintenance_pending(n)

    def test_termination_outranks_maintenance(self):
        n = make_node(name="n1",
                      conditions={COND_MAINTENANCE: "True",
                                  COND_TERMINATION: "True"})
        assert classify_node(n) == (NODE_DEGRADED, COND_TERMINATION)

    def test_cordoned_with_signal_is_draining(self):
        n = make_node(name="n1", unschedulable=True,
                      conditions={COND_MAINTENANCE: "True"})
        assert classify_node(n) == (NODE_DRAINING, COND_MAINTENANCE)

    def test_admin_cordon_without_signal_stays_healthy(self):
        n = make_node(name="n1", unschedulable=True,
                      conditions={"Ready": "True"})
        assert classify_node(n) == (NODE_HEALTHY, "")


# ---------------------------------------------------------------------------
# Cordoning
# ---------------------------------------------------------------------------

class TestCordon:
    def test_maintenance_node_cordoned_with_event_and_metric(
            self, store, health, recorder):
        before = metrics.nodes_cordoned.value(reason=COND_MAINTENANCE)
        add_node(store, name="n1",
                 conditions={"Ready": "True", COND_MAINTENANCE: "True"})
        health.health_pass()
        assert node_of(store, "n1").spec.unschedulable
        assert metrics.nodes_cordoned.value(
            reason=COND_MAINTENANCE) == before + 1
        assert recorder.events_for("n1", REASON_NODE_CORDONED)

    def test_cordon_is_idempotent_across_passes(self, store, health):
        before = metrics.nodes_cordoned.value(reason=COND_TERMINATION)
        add_node(store, name="n1",
                 conditions={"Ready": "True", COND_TERMINATION: "True"})
        health.health_pass()
        health.health_pass()
        # Second pass sees Draining (already cordoned): no re-cordon.
        assert metrics.nodes_cordoned.value(
            reason=COND_TERMINATION) == before + 1

    def test_not_ready_node_is_not_cordoned(self, store, health):
        # A kubelet blip must not leave a permanent cordon; NotReady is
        # already out of capacity via the schedulability predicate.
        add_node(store, name="n1", phase="NotReady")
        health.health_pass()
        assert not node_of(store, "n1").spec.unschedulable

    def test_healthy_node_untouched(self, store, health):
        add_node(store, name="n1", conditions={"Ready": "True"})
        health.health_pass()
        assert not node_of(store, "n1").spec.unschedulable


# ---------------------------------------------------------------------------
# Gang drain
# ---------------------------------------------------------------------------

def _gang_on_degraded_node(store, policy, group="j1",
                           signal=COND_MAINTENANCE):
    """A 2-worker gang running across one degraded + one healthy node."""
    add_node(store, name="bad", domain="d1",
             conditions={"Ready": "True", signal: "True"})
    add_node(store, name="ok", domain="d1",
             conditions={"Ready": "True"})
    add_node(store, name="spare", domain="d2",
             conditions={"Ready": "True"})
    add_job(store, group, health=policy, accelerator="h100-16", workers=2)
    add_group(store, group, chips=16, phase=PHASE_RUNNING, min_member=2)
    add_pod(store, group, index=0, node="bad")
    add_pod(store, group, index=1, node="ok")


class TestDrain:
    def test_atomic_drain_evicts_whole_gang_and_displaces(
            self, store, health, recorder):
        drains = metrics.slice_drains.value(job_namespace="default")
        _gang_on_degraded_node(store, HealthPolicy(enabled=True))
        health.health_pass()
        # BOTH pods evicted — the member on the healthy node too (it
        # would pin the slice to the degraded domain otherwise).
        assert pod_names(store) == set()
        sg = store.get(store_mod.SLICEGROUPS, "default", "j1")
        # Displaced through Pending; the fixture's unlimited capacity
        # re-admits it in the same displace() call, so Inqueue is the
        # legal steady state here — Running is not.
        assert sg.status.phase in (PHASE_PENDING, PHASE_INQUEUE)
        assert COND_MAINTENANCE in sg.status.displaced_reason
        assert sg.status.pending_since is not None
        assert metrics.slice_drains.value(
            job_namespace="default") == drains + 1
        assert recorder.events_for("j1", REASON_SLICE_DRAINED)

    def test_no_policy_leaves_gang_untouched(self, store, health):
        _gang_on_degraded_node(store, None)
        health.health_pass()
        assert pod_names(store) == {"j1-worker-0", "j1-worker-1"}
        assert group_phase(store, "j1") == PHASE_RUNNING
        # The node still gets cordoned (operator-wide hygiene).
        assert node_of(store, "bad").spec.unschedulable

    def test_disabled_policy_leaves_gang_untouched(self, store, health):
        _gang_on_degraded_node(store, HealthPolicy(enabled=False))
        health.health_pass()
        assert pod_names(store) == {"j1-worker-0", "j1-worker-1"}
        assert group_phase(store, "j1") == PHASE_RUNNING

    def test_handle_maintenance_off_ignores_advance_notice(
            self, store, health):
        _gang_on_degraded_node(
            store, HealthPolicy(enabled=True, handle_maintenance=False))
        health.health_pass()
        assert pod_names(store) == {"j1-worker-0", "j1-worker-1"}
        assert group_phase(store, "j1") == PHASE_RUNNING

    def test_handle_maintenance_off_still_drains_termination(
            self, store, health):
        _gang_on_degraded_node(
            store, HealthPolicy(enabled=True, handle_maintenance=False),
            signal=COND_TERMINATION)
        health.health_pass()
        assert pod_names(store) == set()
        assert group_phase(store, "j1") in (PHASE_PENDING, PHASE_INQUEUE)

    def test_not_ready_node_drains_opted_in_gang(self, store, health):
        add_node(store, name="bad", domain="d1", phase="NotReady")
        add_job(store, "j1", health=HealthPolicy(enabled=True))
        add_group(store, "j1", phase=PHASE_RUNNING)
        add_pod(store, "j1", index=0, node="bad")
        health.health_pass()
        assert pod_names(store) == set()
        assert group_phase(store, "j1") in (PHASE_PENDING, PHASE_INQUEUE)

    def test_grace_window_delays_then_drains(self, store, health,
                                             recorder):
        _gang_on_degraded_node(
            store,
            HealthPolicy(enabled=True, drain_grace_seconds=60.0))
        health.health_pass()
        # In grace: warned once, nothing evicted.
        assert pod_names(store) == {"j1-worker-0", "j1-worker-1"}
        assert recorder.events_for("j1", REASON_SLICE_DRAIN_PENDING)
        # Age the episode past the grace and pass again: drains.
        health._drain_first_seen[("default", "j1")] -= 120.0
        health.health_pass()
        assert pod_names(store) == set()
        assert group_phase(store, "j1") in (PHASE_PENDING, PHASE_INQUEUE)

    def test_signal_clearing_in_grace_cancels_drain(self, store, health):
        _gang_on_degraded_node(
            store,
            HealthPolicy(enabled=True, drain_grace_seconds=60.0))
        health.health_pass()
        assert ("default", "j1") in health._drain_first_seen
        # Maintenance cancelled: condition clears before the grace ends.
        node = node_of(store, "bad")
        node.status.conditions[COND_MAINTENANCE] = "False"
        store.update(store_mod.NODES, node)
        health.health_pass()
        assert ("default", "j1") not in health._drain_first_seen
        assert pod_names(store) == {"j1-worker-0", "j1-worker-1"}

    def test_operator_default_grace_applies_when_policy_unset(
            self, store, gang, recorder):
        health = SliceHealthController(store, gang=gang,
                                       recorder=recorder,
                                       default_grace_seconds=60.0)
        _gang_on_degraded_node(store, HealthPolicy(enabled=True))
        health.health_pass()
        assert pod_names(store) == {"j1-worker-0", "j1-worker-1"}

    def test_rebind_observed_with_histogram_and_event(
            self, store, health, gang, recorder):
        hist_before = metrics.drain_rebind_seconds._totals.get(
            ("default",), 0)
        _gang_on_degraded_node(store, HealthPolicy(enabled=True))
        health.health_pass()
        assert group_phase(store, "j1") in (PHASE_PENDING, PHASE_INQUEUE)
        # Repair arc: group re-admitted, pods recreated AND bound on the
        # spare domain (what engine + binder do on the real backends).
        sg = store.get(store_mod.SLICEGROUPS, "default", "j1")
        sg.status.phase = PHASE_INQUEUE
        store.update_status(store_mod.SLICEGROUPS, sg)
        add_pod(store, "j1", index=0, node="spare", phase="Pending")
        add_pod(store, "j1", index=1, node="spare", phase="Pending")
        health.health_pass()
        assert ("default", "j1") not in health._rebind_started
        assert metrics.drain_rebind_seconds._totals.get(
            ("default",), 0) == hist_before + 1
        assert recorder.events_for("j1", REASON_SLICE_REBOUND)

    def test_rebind_not_observed_while_gated_or_on_degraded(
            self, store, health):
        _gang_on_degraded_node(store, HealthPolicy(enabled=True))
        health.health_pass()
        # Still Pending: stopwatch stays open.
        health.health_pass()
        assert ("default", "j1") in health._rebind_started


# ---------------------------------------------------------------------------
# Displaced re-queue ordering (gang.displace contract)
# ---------------------------------------------------------------------------

class TestDisplacedOrdering:
    def test_displaced_group_readmits_ahead_of_equal_priority_newcomer(
            self, store):
        """A drained group keeps its creation timestamp, so when
        capacity fits only one group it wins the FIFO tiebreak against
        an equal-priority newcomer that arrived while it ran."""
        gang = SliceGangScheduler(store, total_chips=8)
        add_group(store, "displaced", chips=8, phase=PHASE_RUNNING,
                  age_seconds=600.0)
        assert gang.displace("default", "displaced", "node degraded")
        # Newcomer appeared after the original admission.
        add_group(store, "newcomer", chips=8, age_seconds=1.0)
        gang.readmit()
        assert group_phase(store, "displaced") == PHASE_INQUEUE
        assert group_phase(store, "newcomer") == PHASE_PENDING

    def test_displace_resets_pending_since_for_fresh_aging(self, store):
        gang = SliceGangScheduler(store, total_chips=8)
        add_group(store, "g", chips=8, phase=PHASE_RUNNING,
                  age_seconds=600.0)
        before = _now()
        assert gang.displace("default", "g", "why")
        sg = store.get(store_mod.SLICEGROUPS, "default", "g")
        assert sg.status.pending_since >= before
        assert sg.status.displaced_reason == "why"

    def test_displace_pending_group_is_noop(self, store):
        gang = SliceGangScheduler(store, total_chips=8)
        add_group(store, "g", chips=8, phase=PHASE_PENDING)
        assert not gang.displace("default", "g", "why")

    def test_promotion_clears_displaced_reason(self, store):
        """Once the rebound gang is fully up, the displaced marker (and
        with it the job's Restarting condition) clears."""
        gang = SliceGangScheduler(store, total_chips=16)
        add_group(store, "g", chips=8, phase=PHASE_RUNNING, min_member=1)
        gang.displace("default", "g", "node degraded")
        gang.readmit()
        assert group_phase(store, "g") == PHASE_INQUEUE
        # Promotion of a displaced group verifies LIVE pod state (the
        # job tallies are stale right after an eviction), so a real
        # Running pod must exist in the store.
        add_pod(store, "g", index=0, node="n1", phase="Running")
        job = add_job(store, "g")
        job.status.replica_statuses = {}
        from tf_operator_tpu_torch.api.types import ReplicaStatus

        job.status.replica_statuses["worker"] = ReplicaStatus(active=1)
        sg = store.get(store_mod.SLICEGROUPS, "default", "g")
        gang._maybe_promote_running(sg, job)
        sg = store.get(store_mod.SLICEGROUPS, "default", "g")
        assert sg.status.phase == PHASE_RUNNING
        assert sg.status.displaced_reason == ""
        assert gang.displaced_reason(job) is None


# ---------------------------------------------------------------------------
# E2E on the kube backend: the full repair loop
# ---------------------------------------------------------------------------

from tf_operator_tpu_torch.runtime.kube import (  # noqa: E402
    KubeClient,
    KubeConfig,
    KubeOperator,
)
from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer  # noqa: E402


def wait_for(cond, timeout=20.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def fake():
    with FakeKubeApiServer() as server:
        yield server


@pytest.fixture
def client(fake):
    return KubeClient(KubeConfig(server=fake.url))


def kube_gang_job(name, health=None):
    """1 chief + 4 workers over a h100-16 x 2 multislice (2 hosts x 8
    chips per slice)."""
    job = TPUJob(metadata=ObjectMeta(name=name, namespace="default"))
    template = PodTemplateSpec(spec=PodSpec(containers=[
        Container(name=constants.DEFAULT_CONTAINER_NAME,
                  image="tpu-worker:latest",
                  command=["python", "-m", "train"])]))
    job.spec = TPUJobSpec(
        replica_specs={
            "chief": ReplicaSpec(replicas=1,
                                 template=template.deepcopy(),
                                 restart_policy=RestartPolicy.NEVER),
            "worker": ReplicaSpec(replicas=4,
                                  template=template.deepcopy(),
                                  restart_policy=RestartPolicy.NEVER),
        },
        run_policy=RunPolicy(health_policy=health),
        slice=TPUSliceSpec(accelerator="h100-16", num_slices=2))
    from tf_operator_tpu_torch.runtime.kube import tpujob_to_k8s

    return tpujob_to_k8s(job)


def _node_of(fake, ns, name):
    pod = fake.state.objects["pods"].get((ns, name))
    return ((pod or {}).get("spec") or {}).get("nodeName", "")


def _pod_uid(fake, ns, name):
    pod = fake.state.objects["pods"].get((ns, name))
    return ((pod or {}).get("metadata") or {}).get("uid", "")


ALL_PODS = [f"hj-worker-{i}" for i in range(4)] + ["hj-chief-0"]


class TestHealthE2E:
    """The acceptance loop: injected maintenance event under a running
    1c+4w gang -> cordon -> atomic slice drain -> re-admission -> rebind
    on spare nodes -> resume, with no pod left on the degraded node."""

    def _cluster(self, fake):
        # Three ICI domains x two 8-chip hosts: 48 chips; the job uses
        # 32, leaving one spare domain to absorb a drained slice.
        for dom in ("dom-a", "dom-b", "dom-c"):
            for i in range(2):
                fake.state.add_node(f"{dom}-n{i}", chips=8,
                                    nvlink_domain=dom)

    def _wait_all_bound(self, fake, msg):
        def all_bound():
            nodes = [_node_of(fake, "default", n) for n in ALL_PODS]
            return nodes if all(nodes) else None
        return wait_for(all_bound, timeout=25, msg=msg)

    def test_maintenance_event_cordon_drain_rebind_resume(
            self, client, fake):
        drains = metrics.slice_drains.value(job_namespace="default")
        hist = metrics.drain_rebind_seconds._totals.get(("default",), 0)
        self._cluster(fake)
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=10)
        try:
            assert op.health is not None  # wired by default
            fake.state.create(
                constants.PLURAL, "default",
                kube_gang_job("hj", health=HealthPolicy(enabled=True)))
            self._wait_all_bound(fake, "gang bound")
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "hj"})
            wait_for(lambda: (op.store.try_get(
                store_mod.SLICEGROUPS, "default", "hj") or
                SliceGroup()).status.phase == PHASE_RUNNING,
                msg="gang promoted Running")

            # A worker's node gets a maintenance notice.
            victim_node = _node_of(fake, "default", "hj-worker-0")
            assert victim_node
            old_uids = {n: _pod_uid(fake, "default", n) for n in ALL_PODS}
            fake.state.inject_maintenance(victim_node)

            # Cordon lands on the API server.
            wait_for(lambda: (fake.state.objects["nodes"]
                              [("", victim_node)].get("spec") or {})
                     .get("unschedulable"), msg="node cordoned")

            # Atomic drain + rebind: every pod recreated (fresh uid) and
            # bound, none on the degraded node.
            def rebound():
                for n in ALL_PODS:
                    node = _node_of(fake, "default", n)
                    if (not node or node == victim_node
                            or _pod_uid(fake, "default", n)
                            == old_uids[n]):
                        return False
                return True
            wait_for(rebound, timeout=25,
                     msg="gang rebound on spare capacity")

            # Slices stayed whole per ICI domain after the rebind.
            doms = [
                _node_of(fake, "default",
                         f"hj-worker-{i}").rsplit("-n", 1)[0]
                for i in range(4)]
            assert len({doms[0], doms[1]}) == 1, doms
            assert len({doms[2], doms[3]}) == 1, doms

            # Restart-with-identity surfaced on the job while rebinding.
            wait_for(lambda: any(
                c.get("type") == JobConditionType.RESTARTING
                and c.get("status") == "True"
                for c in (client.get(store_mod.TPUJOBS, "default", "hj")
                          .get("status") or {}).get("conditions") or []),
                msg="Restarting condition on job")

            # Kubelet reports the rebound gang Running: job resumes.
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "hj"})
            wait_for(lambda: any(
                c.get("type") == JobConditionType.RUNNING
                and c.get("status") == "True"
                for c in (client.get(store_mod.TPUJOBS, "default", "hj")
                          .get("status") or {}).get("conditions") or []),
                msg="job Running again after repair")

            # Drain observability: metric bumped, rebind latency
            # histogram closed, events recorded.
            assert metrics.slice_drains.value(
                job_namespace="default") == drains + 1
            wait_for(lambda: metrics.drain_rebind_seconds._totals.get(
                ("default",), 0) == hist + 1,
                msg="time-to-rebind observed")
            reasons = {e.reason for e in
                       op.controller.recorder.events}
            assert REASON_NODE_CORDONED in reasons
            assert REASON_SLICE_DRAINED in reasons
        finally:
            op.stop()

    def test_control_disabled_policy_gang_untouched(self, client, fake):
        """Same maintenance event, no HealthPolicy: the node is
        cordoned (operator-wide hygiene) but the gang keeps running,
        bound where it was."""
        self._cluster(fake)
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=10)
        try:
            fake.state.create(constants.PLURAL, "default",
                              kube_gang_job("hj", health=None))
            before = self._wait_all_bound(fake, "gang bound")
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "hj"})
            victim_node = _node_of(fake, "default", "hj-worker-0")
            old_uids = {n: _pod_uid(fake, "default", n) for n in ALL_PODS}
            fake.state.inject_maintenance(victim_node)
            wait_for(lambda: (fake.state.objects["nodes"]
                              [("", victim_node)].get("spec") or {})
                     .get("unschedulable"), msg="node cordoned")
            time.sleep(2.0)  # give a wrong drain time to land
            after = [_node_of(fake, "default", n) for n in ALL_PODS]
            assert after == before
            assert all(_pod_uid(fake, "default", n) == old_uids[n]
                       for n in ALL_PODS)
            sg = op.store.try_get(store_mod.SLICEGROUPS, "default", "hj")
            assert sg is not None and sg.status.phase == PHASE_RUNNING
        finally:
            op.stop()

    def test_slice_health_can_be_disabled(self, client, fake):
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True,
                          slice_health=False)
        try:
            assert op.health is None
        finally:
            op.stop()


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
