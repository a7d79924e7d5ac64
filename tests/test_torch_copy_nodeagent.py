"""Copy of ``tests/test_nodeagent.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Node-agent plane (runtime/nodeagent.py) + the kube flags it lifts.

The agent is the DaemonSet analog that closes the process-supervision
gap on --backend kube (docs/node-agent.md): it relays preemption
notices (pod annotation -> TPUJOB_PREEMPT_FILE), mirrors worker
checkpoint state (TPUJOB_CKPT_FILE -> ckpt-state annotation), and
heartbeats its Node so the operator knows which gangs are
barrier-capable. These tests pin:

- the relay contract against the hermetic fake apiserver (notice file,
  ckpt mirror, cleanup, node scoping, heartbeats);
- bind validation: the fake 422s placements a real kubelet would
  reject (taints / nodeSelector / cpu fit), and the in-operator binder
  never proposes one;
- the lifted-flag e2e arcs: drain mid-train resolves the save barrier
  through the agent relay with restoredFromStep == lastCheckpointStep,
  tenant-queue reclaim evicts a borrower on kube, a serving gang rides
  a drain with its spool intact, and the no-agent control degrades to
  plain eviction (flag semantics identical to agentless today);
- the CLI accepting --enable-tenant-queues / --enable-ckpt-coordination
  / --enable-serving with --backend kube.
"""

from __future__ import annotations

import json
import os
import time

import pytest

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    Container,
    HealthPolicy,
    JobConditionType,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    RunPolicy,
    ServingPolicy,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.controller.ckpt import JOB_CKPT_BARRIER_SAVED_REASON
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.events import (
    REASON_CKPT_BARRIER_REQUESTED,
    REASON_CKPT_BARRIER_SAVED,
)
from tf_operator_tpu_torch.runtime.kube import (
    KubeApiError,
    KubeClient,
    KubeConfig,
    KubeOperator,
    node_from_k8s,
    tpujob_to_k8s,
)
from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer
from tf_operator_tpu_torch.runtime.nodeagent import KubeNodeAgent

pytestmark = pytest.mark.control_plane


def wait_for(cond, timeout=25.0, interval=0.05, msg="condition"):
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


def make_agent(fake, node, relay_dir, **kw):
    kw.setdefault("heartbeat_seconds", 1.0)
    kw.setdefault("ckpt_poll_seconds", 0.05)
    return KubeNodeAgent(KubeClient(KubeConfig(server=fake.url)), node,
                         str(relay_dir), **kw)


def raw_pod(name, node="", relay_dir="", token="tok1", annotations=None,
            resources=None, node_selector=None, tolerations=None,
            ns="default"):
    """A plain (non-job) pod in wire form, optionally relay-wired."""
    ann = dict(annotations or {})
    if relay_dir:
        ann.setdefault(constants.ANNOTATION_RELAY_TOKEN, token)
    d = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": ns, "annotations": ann},
        "spec": {
            "containers": [{"name": constants.DEFAULT_CONTAINER_NAME,
                            "image": "w:latest",
                            "command": ["sleep", "1"]}],
            "restartPolicy": "Never",
        },
    }
    if node:
        d["spec"]["nodeName"] = node
    if relay_dir:
        d["spec"]["volumes"] = [{
            "name": "tpu-operator-relay",
            "hostPath": {"path": str(relay_dir),
                         "type": "DirectoryOrCreate"}}]
        d["spec"]["containers"][0]["volumeMounts"] = [{
            "name": "tpu-operator-relay", "mountPath": str(relay_dir)}]
    if resources:
        d["spec"]["containers"][0]["resources"] = {"limits": dict(resources)}
    if node_selector:
        d["spec"]["nodeSelector"] = dict(node_selector)
    if tolerations:
        d["spec"]["tolerations"] = list(tolerations)
    return d


def env_of(fake, ns, name):
    pod = fake.state.objects["pods"].get((ns, name)) or {}
    cont = ((pod.get("spec") or {}).get("containers") or [{}])[0]
    return {e["name"]: e.get("value", "") for e in cont.get("env") or []}


def annotations_of(fake, ns, name):
    pod = fake.state.objects["pods"].get((ns, name)) or {}
    return (pod.get("metadata") or {}).get("annotations") or {}


def _node_of(fake, ns, name):
    pod = fake.state.objects["pods"].get((ns, name))
    return ((pod or {}).get("spec") or {}).get("nodeName", "")


def _pod_uid(fake, ns, name):
    pod = fake.state.objects["pods"].get((ns, name))
    return ((pod or {}).get("metadata") or {}).get("uid", "")


def _atomic_write(path, payload):
    with open(path + ".tmp", "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)


def relay_paths(fake, base_dir, ns, name):
    """(preempt, ckpt) paths for a pod as the relay module renders them."""
    from tf_operator_tpu_torch.runtime import relay as relay_mod
    from tf_operator_tpu_torch.runtime.kube import pod_from_k8s

    pod = pod_from_k8s(fake.state.objects["pods"][(ns, name)])
    return (relay_mod.preempt_path(str(base_dir), pod),
            relay_mod.ckpt_path(str(base_dir), pod))


def kube_ckpt_job(name, ckpt_dir, workers=2, queue="", serving=False,
                  spool=""):
    """Wire-form TPUJob: h100-8 per slice, one replica per slice, opted
    into health drains + coordinated checkpoints (interval_steps huge so
    the barrier save is the ONLY save — keeps restoredFromStep ==
    lastCheckpointStep race-free)."""
    job = TPUJob(metadata=ObjectMeta(name=name, namespace="default"))
    template = PodTemplateSpec(spec=PodSpec(containers=[
        Container(name=constants.DEFAULT_CONTAINER_NAME,
                  image="tpu-worker:latest",
                  command=["python", "-m", "train"])]))
    rtype = "serving" if serving else "worker"
    run_policy = RunPolicy(
        health_policy=HealthPolicy(enabled=True),
        checkpoint_policy=CheckpointPolicy(
            enabled=True, directory=ckpt_dir, interval_steps=100000,
            barrier_timeout_seconds=20.0))
    if serving:
        run_policy.serving_policy = ServingPolicy(
            enabled=True, spool_directory=spool)
    job.spec = TPUJobSpec(
        replica_specs={rtype: ReplicaSpec(
            replicas=workers, template=template,
            restart_policy=RestartPolicy.NEVER)},
        run_policy=run_policy,
        slice=TPUSliceSpec(accelerator="h100-8", num_slices=workers),
        queue_name=queue)
    return tpujob_to_k8s(job)


def kube_plain_job(name, workers, queue=""):
    job = TPUJob(metadata=ObjectMeta(name=name, namespace="default"))
    template = PodTemplateSpec(spec=PodSpec(containers=[
        Container(name=constants.DEFAULT_CONTAINER_NAME,
                  image="tpu-worker:latest",
                  command=["python", "-m", "train"])]))
    job.spec = TPUJobSpec(
        replica_specs={"worker": ReplicaSpec(
            replicas=workers, template=template,
            restart_policy=RestartPolicy.NEVER)},
        slice=TPUSliceSpec(accelerator="h100-8", num_slices=workers),
        queue_name=queue)
    return tpujob_to_k8s(job)


# ---------------------------------------------------------------------------
# Relay contract: one agent, one node, raw pods
# ---------------------------------------------------------------------------


class TestNodeAgentRelay:
    def test_requires_node_name(self, client, tmp_path):
        with pytest.raises(ValueError):
            KubeNodeAgent(client, "", str(tmp_path))

    def test_heartbeat_lands_and_parses(self, fake, client, tmp_path):
        fake.state.add_node("n1", chips=8)
        agent = make_agent(fake, "n1", tmp_path, heartbeat_seconds=0.2)
        agent.start()
        try:
            def beat():
                raw = fake.state.objects["nodes"].get(("", "n1")) or {}
                ann = (raw.get("metadata") or {}).get("annotations") or {}
                return ann.get(constants.ANNOTATION_AGENT_HEARTBEAT)
            stamp = wait_for(beat, msg="heartbeat annotation")
            # The informer-side parser must read it back as a timestamp
            # (this is what _barrier_capable consumes).
            node = node_from_k8s(fake.state.objects["nodes"][("", "n1")])
            assert node.status.last_heartbeat is not None
            # And it keeps beating: a later stamp supersedes.
            wait_for(lambda: beat() != stamp, msg="second heartbeat")
        finally:
            agent.stop()

    def test_notice_annotation_becomes_preempt_file(self, fake, client,
                                                    tmp_path):
        fake.state.add_node("n1", chips=8)
        fake.state.create("pods", "default",
                          raw_pod("p1", node="n1", relay_dir=tmp_path))
        agent = make_agent(fake, "n1", tmp_path)
        agent.start()
        try:
            notice = {"barrier": "b1", "deadline": 123.0,
                      "reason": "maintenance"}
            client.patch(store_mod.PODS, "default", "p1", {"metadata": {
                "annotations": {constants.ANNOTATION_PREEMPT_NOTICE:
                                json.dumps(notice, sort_keys=True)}}})
            path, _ = relay_paths(fake, tmp_path, "default", "p1")
            wait_for(lambda: os.path.exists(path), msg="preempt file")
            with open(path, encoding="utf-8") as f:
                assert json.load(f) == notice
            # An updated notice rewrites the file.
            notice2 = dict(notice, barrier="b2")
            client.patch(store_mod.PODS, "default", "p1", {"metadata": {
                "annotations": {constants.ANNOTATION_PREEMPT_NOTICE:
                                json.dumps(notice2, sort_keys=True)}}})

            def updated():
                with open(path, encoding="utf-8") as f:
                    return json.load(f).get("barrier") == "b2"
            wait_for(updated, msg="notice rewrite")
        finally:
            agent.stop()

    def test_ckpt_file_mirrors_to_annotation(self, fake, client, tmp_path):
        fake.state.add_node("n1", chips=8)
        fake.state.create("pods", "default",
                          raw_pod("p1", node="n1", relay_dir=tmp_path))
        agent = make_agent(fake, "n1", tmp_path)
        agent.start()
        try:
            _, path = relay_paths(fake, tmp_path, "default", "p1")
            payload = {"step": 3, "barrier": "b1"}
            _atomic_write(path, payload)
            wait_for(lambda: annotations_of(fake, "default", "p1").get(
                constants.ANNOTATION_CKPT_STATE), msg="ckpt-state annotation")
            mirrored = annotations_of(fake, "default", "p1")[
                constants.ANNOTATION_CKPT_STATE]
            assert json.loads(mirrored) == payload
        finally:
            agent.stop()

    def test_pod_delete_cleans_relay_files(self, fake, client, tmp_path):
        fake.state.add_node("n1", chips=8)
        fake.state.create("pods", "default",
                          raw_pod("p1", node="n1", relay_dir=tmp_path))
        agent = make_agent(fake, "n1", tmp_path)
        agent.start()
        try:
            ppath, cpath = relay_paths(fake, tmp_path, "default", "p1")
            client.patch(store_mod.PODS, "default", "p1", {"metadata": {
                "annotations": {constants.ANNOTATION_PREEMPT_NOTICE:
                                json.dumps({"barrier": "b1"})}}})
            _atomic_write(cpath, {"step": 1})
            wait_for(lambda: os.path.exists(ppath), msg="preempt file")
            client.delete(store_mod.PODS, "default", "p1")
            wait_for(lambda: not os.path.exists(ppath)
                     and not os.path.exists(cpath),
                     msg="relay files unlinked on delete")
        finally:
            agent.stop()

    def test_ignores_pods_on_other_nodes(self, fake, client, tmp_path):
        fake.state.add_node("n1", chips=8)
        fake.state.add_node("n2", chips=8)
        fake.state.create(
            "pods", "default",
            raw_pod("p2", node="n2", relay_dir=tmp_path,
                    annotations={constants.ANNOTATION_PREEMPT_NOTICE:
                                 json.dumps({"barrier": "bx"})}))
        agent = make_agent(fake, "n1", tmp_path)  # agent for n1, pod on n2
        agent.start()
        try:
            time.sleep(0.6)
            path, _ = relay_paths(fake, tmp_path, "default", "p2")
            assert not os.path.exists(path)
        finally:
            agent.stop()


# ---------------------------------------------------------------------------
# Bind validation: the fake rejects what a kubelet would reject
# ---------------------------------------------------------------------------


class TestFakeBindValidation:
    def test_taint_without_toleration_is_422(self, fake, client):
        fake.state.add_node("t1", chips=8, taints=[
            {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}])
        fake.state.create("pods", "default", raw_pod("p1"))
        with pytest.raises(KubeApiError) as err:
            client.bind_pod("default", "p1", "t1")
        assert err.value.code == 422

    def test_matching_toleration_binds(self, fake, client):
        fake.state.add_node("t1", chips=8, taints=[
            {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}])
        fake.state.create("pods", "default", raw_pod(
            "p1", tolerations=[{"key": "dedicated", "operator": "Equal",
                                "value": "ml", "effect": "NoSchedule"}]))
        client.bind_pod("default", "p1", "t1")
        assert _node_of(fake, "default", "p1") == "t1"

    def test_node_selector_mismatch_is_422(self, fake, client):
        fake.state.add_node("n1", chips=8, labels={"pool": "cpu"})
        fake.state.create("pods", "default", raw_pod(
            "p1", node_selector={"pool": "tpu"}))
        with pytest.raises(KubeApiError) as err:
            client.bind_pod("default", "p1", "n1")
        assert err.value.code == 422
        # ... and a matching label set binds.
        fake.state.add_node("n2", chips=8, labels={"pool": "tpu"})
        client.bind_pod("default", "p1", "n2")
        assert _node_of(fake, "default", "p1") == "n2"

    def test_cpu_overcommit_is_422(self, fake, client):
        fake.state.add_node("n1", chips=8, cpu="1")
        fake.state.create("pods", "default",
                          raw_pod("p1", resources={"cpu": "600m"}))
        fake.state.create("pods", "default",
                          raw_pod("p2", resources={"cpu": "600m"}))
        client.bind_pod("default", "p1", "n1")
        with pytest.raises(KubeApiError) as err:
            client.bind_pod("default", "p2", "n1")
        assert err.value.code == 422

    def test_unreported_allocatable_skips_fit(self, fake, client):
        # A node that reports no cpu/memory must not reject on fit.
        fake.state.add_node("n1", chips=8)
        fake.state.create("pods", "default",
                          raw_pod("p1", resources={"cpu": "64",
                                                   "memory": "1Ti"}))
        client.bind_pod("default", "p1", "n1")
        assert _node_of(fake, "default", "p1") == "n1"


@pytest.mark.e2e
class TestBinderHonorsNodeInventory:
    def test_binder_avoids_tainted_node(self, fake, client):
        """Two candidate nodes, one carrying a NoSchedule taint the
        worker does not tolerate: the gang binder must place on the
        clean one (a taint miss would 422 at the fake and the pod
        would never bind)."""
        fake.state.add_node("dom-a-n0", chips=8, nvlink_domain="dom-a",
                            taints=[{"key": "dedicated", "value": "infra",
                                     "effect": "NoSchedule"}])
        fake.state.add_node("dom-b-n0", chips=8, nvlink_domain="dom-b")
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=10)
        try:
            fake.state.create(constants.PLURAL, "default",
                              kube_plain_job("tj", workers=1))
            node = wait_for(
                lambda: _node_of(fake, "default", "tj-worker-0"),
                msg="worker bound")
            assert node == "dom-b-n0"
        finally:
            op.stop()


# ---------------------------------------------------------------------------
# E2E: drain mid-train rides the agent relay end to end
# ---------------------------------------------------------------------------


def _cluster(fake, domains=("dom-a", "dom-b", "dom-c")):
    for dom in domains:
        fake.state.add_node(f"{dom}-n0", chips=8, nvlink_domain=dom)
    return [f"{dom}-n0" for dom in domains]


def _start_agents(fake, relay_dir, nodes):
    agents = []
    for n in nodes:
        a = make_agent(fake, n, relay_dir)
        a.start()
        agents.append(a)
    return agents


@pytest.mark.e2e
class TestCkptDrainE2E:
    def test_drain_resolves_barrier_and_restores(self, fake, client,
                                                 tmp_path):
        """Maintenance on a worker's node: notice reaches the worker's
        TPUJOB_PREEMPT_FILE through its node agent, the final-save acks
        flow back through TPUJOB_CKPT_FILE, the gang drains only after
        the barrier resolves, and the rebound pods restore from exactly
        the step the barrier committed."""
        relay_dir = tmp_path / "relay"
        relay_dir.mkdir()
        nodes = _cluster(fake)
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True,
                          enable_ckpt_coordination=True,
                          relay_dir=str(relay_dir))
        op.start(threadiness=1, sync_timeout=10)
        agents = _start_agents(fake, relay_dir, nodes)
        names = ["cj-worker-0", "cj-worker-1"]
        try:
            fake.state.create(constants.PLURAL, "default",
                              kube_ckpt_job("cj", str(tmp_path / "ckpt")))
            wait_for(lambda: all(_node_of(fake, "default", n)
                                 for n in names), msg="gang bound")
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "cj"})
            old_uids = {n: _pod_uid(fake, "default", n) for n in names}
            old_envs = {n: env_of(fake, "default", n) for n in names}
            for n in names:  # relay env rendered at create time
                assert old_envs[n][constants.ENV_PREEMPT_FILE]
                assert old_envs[n][constants.ENV_CKPT_FILE]

            victim = _node_of(fake, "default", "cj-worker-0")
            fake.state.inject_maintenance(victim)

            # 1. The barrier notice lands in every worker's preempt file.
            def notices():
                out = {}
                for n in names:
                    path = old_envs[n][constants.ENV_PREEMPT_FILE]
                    if not os.path.exists(path):
                        return None
                    with open(path, encoding="utf-8") as f:
                        out[n] = json.load(f)
                return out
            got = wait_for(notices, msg="preemption notices relayed")
            barrier = got["cj-worker-0"]["barrier"]
            assert barrier
            assert got["cj-worker-1"]["barrier"] == barrier
            assert "deadline" in got["cj-worker-0"]
            # The drain is gated: pods still alive while unacked.
            assert _pod_uid(fake, "default", "cj-worker-0") == \
                old_uids["cj-worker-0"]

            # 2. Workers ack with their final save.
            for n in names:
                _atomic_write(old_envs[n][constants.ENV_CKPT_FILE],
                              {"step": 5, "progress_step": 7,
                               "barrier": barrier,
                               "directory": str(tmp_path / "ckpt"),
                               "save_seconds": 0.1})

            # 3. Barrier resolves -> atomic drain -> rebind off victim.
            def rebound():
                for n in names:
                    node = _node_of(fake, "default", n)
                    if (not node or node == victim
                            or _pod_uid(fake, "default", n) == old_uids[n]):
                        return False
                return True
            wait_for(rebound, timeout=30, msg="gang rebound off victim")

            # 4. Restore-with-identity: fresh incarnation, fresh relay
            #    token, committed step in env.
            for n in names:
                env = env_of(fake, "default", n)
                assert env[constants.ENV_RESTORE_STEP] == "5"
                assert env[constants.ENV_CKPT_FILE] != \
                    old_envs[n][constants.ENV_CKPT_FILE]
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "cj"})

            # 5. A rebound worker confirms its restore over the relay...
            env0 = env_of(fake, "default", "cj-worker-0")
            _atomic_write(env0[constants.ENV_CKPT_FILE],
                          {"step": 5, "restored_from_step": 5})

            # ...and the job status closes the loop.
            def status():
                raw = client.get(store_mod.TPUJOBS, "default", "cj")
                st = raw.get("status") or {}
                return st if st.get("restoredFromStep") is not None else None
            st = wait_for(status, msg="restoredFromStep on job status")
            assert st["lastCheckpointStep"] == 5
            assert st["restoredFromStep"] == st["lastCheckpointStep"]
            conds = [c for c in st.get("conditions") or []
                     if c.get("type") == JobConditionType.CHECKPOINT_BARRIER]
            assert conds and conds[0].get("status") == "False"
            assert conds[0].get("reason") == JOB_CKPT_BARRIER_SAVED_REASON
            reasons = {e.reason for e in op.controller.recorder.events}
            assert REASON_CKPT_BARRIER_SAVED in reasons
        finally:
            for a in agents:
                a.stop()
            op.stop()

    def test_no_agent_heartbeat_degrades_to_plain_eviction(
            self, fake, client, tmp_path):
        """No agents running: the gang is not barrier-capable, so a
        drain must evict immediately — never hang on acks that cannot
        arrive — and no relay artifacts may appear (flag-on behavior
        with a dead agent == flag-off behavior)."""
        relay_dir = tmp_path / "relay"
        relay_dir.mkdir()
        _cluster(fake)
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True,
                          enable_ckpt_coordination=True,
                          relay_dir=str(relay_dir))
        op.start(threadiness=1, sync_timeout=10)
        names = ["nj-worker-0", "nj-worker-1"]
        try:
            fake.state.create(constants.PLURAL, "default",
                              kube_ckpt_job("nj", str(tmp_path / "ckpt")))
            wait_for(lambda: all(_node_of(fake, "default", n)
                                 for n in names), msg="gang bound")
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "nj"})
            old_uids = {n: _pod_uid(fake, "default", n) for n in names}
            victim = _node_of(fake, "default", "nj-worker-0")
            fake.state.inject_maintenance(victim)

            def rebound():
                for n in names:
                    node = _node_of(fake, "default", n)
                    if (not node or node == victim
                            or _pod_uid(fake, "default", n) == old_uids[n]):
                        return False
                return True
            wait_for(rebound, timeout=30, msg="plain drain rebound")

            assert os.listdir(relay_dir) == []
            reasons = {e.reason for e in op.controller.recorder.events}
            assert REASON_CKPT_BARRIER_REQUESTED not in reasons
            for n in names:
                assert constants.ANNOTATION_PREEMPT_NOTICE not in \
                    annotations_of(fake, "default", n)
                assert constants.ENV_RESTORE_STEP not in \
                    env_of(fake, "default", n)
        finally:
            op.stop()


# ---------------------------------------------------------------------------
# E2E: tenant-queue reclaim on kube
# ---------------------------------------------------------------------------


QUEUE_YAML = """\
clusterQueues:
  - name: cq-a
    nominalChips: 8
    cohort: pool
  - name: cq-b
    nominalChips: 8
    cohort: pool
tenantQueues:
  - name: team-a
    clusterQueue: cq-a
  - name: team-b
    clusterQueue: cq-b
"""


@pytest.mark.e2e
class TestTenantReclaimE2E:
    def test_reclaim_evicts_borrower(self, fake, client, tmp_path):
        """team-b borrows cq-a's idle nominal to run 16 chips; when a
        team-a job shows up, reclaim displaces the borrower's gang (its
        bound pods are deleted; the engine's replacements queue unbound
        because borrowing is frozen) and the owner binds."""
        qcfg = tmp_path / "queues.yaml"
        qcfg.write_text(QUEUE_YAML, encoding="utf-8")
        fake.state.add_node("dom-a-n0", chips=8, nvlink_domain="dom-a")
        fake.state.add_node("dom-b-n0", chips=8, nvlink_domain="dom-b")
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True,
                          enable_tenant_queues=True,
                          queue_config=str(qcfg))
        op.start(threadiness=1, sync_timeout=10)
        borrower = ["bj-worker-0", "bj-worker-1"]
        try:
            fake.state.create(constants.PLURAL, "default",
                              kube_plain_job("bj", workers=2,
                                             queue="team-b"))
            wait_for(lambda: all(_node_of(fake, "default", n)
                                 for n in borrower),
                     msg="borrower bound via cohort borrowing")
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "bj"})
            old_uids = {n: _pod_uid(fake, "default", n) for n in borrower}

            fake.state.create(constants.PLURAL, "default",
                              kube_plain_job("aj", workers=1,
                                             queue="team-a"))
            # Reclaim: the borrower's bound incarnations are evicted
            # (any replacement pod is a fresh, unbound incarnation —
            # its borrowing is frozen while the nominal demand is
            # unmet), and the owner binds onto the freed chips.
            def borrower_evicted():
                for n in borrower:
                    uid = _pod_uid(fake, "default", n)
                    if uid == old_uids[n] or _node_of(fake, "default", n):
                        return False
                return True
            wait_for(borrower_evicted, timeout=30,
                     msg="borrower evicted by reclaim")
            node = wait_for(
                lambda: _node_of(fake, "default", "aj-worker-0"),
                timeout=30, msg="owner bound after reclaim")
            assert node
            reasons = {e.reason for e in op.controller.recorder.events}
            assert "QuotaReclaimed" in reasons
        finally:
            op.stop()


# ---------------------------------------------------------------------------
# E2E: serving gang rides a drain, spool intact
# ---------------------------------------------------------------------------


@pytest.mark.e2e
class TestServingDrainE2E:
    def test_serving_gang_survives_drain_with_spool_intact(
            self, fake, client, tmp_path):
        """Serving replicas gate the barrier like workers (their ack is
        'requests re-spooled'); after the drain the gang is rebound off
        the victim and every pending request file is still there —
        nothing in flight was dropped at the spool."""
        relay_dir = tmp_path / "relay"
        relay_dir.mkdir()
        spool = tmp_path / "spool"
        (spool / "pending").mkdir(parents=True)
        nodes = _cluster(fake)
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True,
                          enable_ckpt_coordination=True,
                          enable_serving=True,
                          relay_dir=str(relay_dir))
        op.start(threadiness=1, sync_timeout=10)
        agents = _start_agents(fake, relay_dir, nodes)
        names = ["sj-serving-0", "sj-serving-1"]
        try:
            fake.state.create(
                constants.PLURAL, "default",
                kube_ckpt_job("sj", str(spool), serving=True,
                              spool=str(spool)))
            wait_for(lambda: all(_node_of(fake, "default", n)
                                 for n in names), msg="serving gang bound")
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "sj"})
            old_envs = {n: env_of(fake, "default", n) for n in names}
            old_uids = {n: _pod_uid(fake, "default", n) for n in names}
            for n in names:
                assert old_envs[n][constants.ENV_SERVE_SPOOL] == str(spool)
                assert old_envs[n][constants.ENV_PREEMPT_FILE]

            pending = []
            for i in range(6):
                path = spool / "pending" / f"r{i}.json"
                _atomic_write(str(path), {"id": f"r{i}", "prompt": "hi"})
                pending.append(path)

            victim = _node_of(fake, "default", "sj-serving-0")
            fake.state.inject_maintenance(victim)

            def notices():
                out = {}
                for n in names:
                    path = old_envs[n][constants.ENV_PREEMPT_FILE]
                    if not os.path.exists(path):
                        return None
                    with open(path, encoding="utf-8") as f:
                        out[n] = json.load(f)
                return out
            got = wait_for(notices, msg="serving notices relayed")
            barrier = got["sj-serving-0"]["barrier"]
            # Replica ack = "claimed requests re-spooled, safe to evict".
            for n in names:
                _atomic_write(old_envs[n][constants.ENV_CKPT_FILE],
                              {"step": 0, "barrier": barrier})

            def rebound():
                for n in names:
                    node = _node_of(fake, "default", n)
                    if (not node or node == victim
                            or _pod_uid(fake, "default", n) == old_uids[n]):
                        return False
                return True
            wait_for(rebound, timeout=30, msg="serving gang rebound")

            assert all(p.exists() for p in pending), \
                "pending requests dropped across the drain"
            reasons = {e.reason for e in op.controller.recorder.events}
            assert REASON_CKPT_BARRIER_SAVED in reasons
        finally:
            for a in agents:
                a.stop()
            op.stop()


# ---------------------------------------------------------------------------
# CLI: the lifted flags are accepted on --backend kube
# ---------------------------------------------------------------------------


KUBECONFIG = """\
apiVersion: v1
kind: Config
current-context: test
contexts:
  - name: test
    context:
      cluster: test
      user: test
clusters:
  - name: test
    cluster:
      server: {server}
users:
  - name: test
    user: {{}}
"""


class TestLiftedFlagsOnKube:
    def test_server_constructs_with_all_lifted_flags(self, fake, tmp_path):
        from tf_operator_tpu_torch.cli import Server, build_parser

        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text(KUBECONFIG.format(server=fake.url),
                              encoding="utf-8")
        qcfg = tmp_path / "queues.yaml"
        qcfg.write_text(QUEUE_YAML, encoding="utf-8")
        args = build_parser().parse_args([
            "--monitoring-port", "0", "--no-leader-elect",
            "--backend", "kube", "--kubeconfig", str(kubeconfig),
            "--enable-gang-scheduling",
            "--enable-tenant-queues", "--queue-config", str(qcfg),
            "--enable-ckpt-coordination",
            "--enable-serving",
            "--agent-relay-dir", str(tmp_path / "relay")])
        server = Server(args)
        try:
            assert server.operator.quota is not None
            assert server.operator.ckpt is not None
            assert server.operator.serving is not None
        finally:
            server.shutdown()
