"""Copy of ``tests/test_kube.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Kubernetes backend tests: translation, client, informer, controller.

The seam is the fake K8s API server (runtime/kube_fake.py) — a real HTTP
server speaking the API subset the production client uses, so
KubeClient/KubeInformer/KubePodControl are exercised byte-for-byte (the
reference tests the same layers with generated fake clientsets,
pkg/client/clientset/versioned/fake/, and real GKE e2e).
"""

import base64
import os
import time

import pytest

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    Container,
    Endpoint,
    EndpointSpec,
    JobConditionType,
    ObjectMeta,
    Pod,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    TPUJob,
    TPUJobSpec,
)
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.kube import (
    KubeClient,
    KubeConfig,
    KubeOperator,
    check_crd_exists,
    endpoint_from_k8s_service,
    pod_from_k8s,
    pod_to_k8s,
    service_to_k8s,
    tpujob_from_k8s,
    tpujob_to_k8s,
)
from tf_operator_tpu_torch.runtime.kube_fake import (
    FakeKubeApiServer,
    merge_patch,
)


def make_job(name="kj", workers=2, **spec_kwargs) -> dict:
    """A TPUJob CR body in K8s wire form."""
    job = TPUJob(metadata=ObjectMeta(name=name, namespace="default"))
    job.spec = TPUJobSpec(replica_specs={
        "worker": ReplicaSpec(
            replicas=workers,
            template=PodTemplateSpec(spec=PodSpec(containers=[
                Container(name=constants.DEFAULT_CONTAINER_NAME,
                          image="tpu-worker:latest",
                          command=["python", "-m", "train"])])),
            restart_policy=RestartPolicy.NEVER),
    }, **spec_kwargs)
    return tpujob_to_k8s(job)


def wait_for(cond, timeout=10.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# Translation round-trips
# ---------------------------------------------------------------------------

class TestTranslation:
    def test_pod_round_trip(self):
        pod = Pod(metadata=ObjectMeta(
            name="j-worker-0", namespace="ns1",
            labels={"replica-type": "worker", "replica-index": "0"},
            annotations={"a": "b"}))
        pod.spec = PodSpec(containers=[Container(
            name="jax", image="img:1", command=["python", "x.py"],
            args=["--flag"], env={"RANK": "0", "B": "2"},
            ports={"tpujob-port": 8470}, resources={"nvidia.com/gpu": "4"},
            working_dir="/app")],
            restart_policy="OnFailure", scheduler_name="gang",
            node_selector={"tpu": "v5p"}, node_name="node-1")
        k = pod_to_k8s(pod)
        assert k["spec"]["containers"][0]["env"] == [
            {"name": "B", "value": "2"},
            {"name": "RANK", "value": "0"}]
        assert k["spec"]["containers"][0]["resources"]["limits"] == {
            "nvidia.com/gpu": "4"}
        back = pod_from_k8s(k)
        assert back.spec.containers[0].env == pod.spec.containers[0].env
        assert back.spec.containers[0].ports == pod.spec.containers[0].ports
        assert back.spec.node_name == "node-1"
        assert back.metadata.labels == pod.metadata.labels

    def test_pod_toleration_round_trip(self):
        from tf_operator_tpu_torch.api.types import Toleration

        pod = Pod(spec=PodSpec(
            containers=[Container()],
            tolerations=[Toleration(key="nvidia.com/gpu",
                                    operator="Exists"),
                         Toleration(key="dedicated", operator="Equal",
                                    value="ml", effect="NoSchedule",
                                    toleration_seconds=60)]))
        k = pod_to_k8s(pod)
        assert k["spec"]["tolerations"] == [
            {"key": "nvidia.com/gpu", "operator": "Exists"},
            {"key": "dedicated", "operator": "Equal", "value": "ml",
             "effect": "NoSchedule", "tolerationSeconds": 60}]
        back = pod_from_k8s(k)
        assert back.spec.tolerations == pod.spec.tolerations

    def test_pod_exitcode_restart_policy_maps_to_never(self):
        pod = Pod(spec=PodSpec(containers=[Container()],
                               restart_policy=RestartPolicy.EXIT_CODE))
        assert pod_to_k8s(pod)["spec"]["restartPolicy"] == "Never"

    def test_container_status_terminated(self):
        k = {"metadata": {"name": "p", "namespace": "d"},
             "spec": {"containers": [{"name": "jax"}]},
             "status": {"phase": "Failed", "containerStatuses": [
                 {"name": "jax", "restartCount": 2,
                  "state": {"terminated": {"exitCode": 137,
                                           "reason": "OOMKilled"}}}]}}
        pod = pod_from_k8s(k)
        cs = pod.status.container_statuses[0]
        assert (cs.state, cs.exit_code, cs.restart_count) == (
            "Terminated", 137, 2)
        assert cs.message == "OOMKilled"

    def test_service_round_trip_headless(self):
        ep = Endpoint(metadata=ObjectMeta(name="j-worker-0",
                                          labels={"replica-index": "0"}),
                      spec=EndpointSpec(selector={"job-name": "j"},
                                        ports={"tpujob-port": 8470}))
        k = service_to_k8s(ep)
        assert k["spec"]["clusterIP"] == "None"  # headless, per-replica
        back = endpoint_from_k8s_service(k)
        assert back.spec.selector == {"job-name": "j"}
        assert back.spec.ports == {"tpujob-port": 8470}

    def test_tpujob_round_trip(self):
        raw = make_job(workers=3)
        raw["metadata"]["resourceVersion"] = "41"
        raw["metadata"]["uid"] = "u-1"
        job = tpujob_from_k8s(raw)
        assert job.spec.replica_specs["worker"].replicas == 3
        # Opaque string, preserved verbatim (never int-coerced).
        assert job.metadata.resource_version == "41"
        assert job.metadata.uid == "u-1"
        assert (job.spec.replica_specs["worker"].template.spec
                .containers[0].image == "tpu-worker:latest")


# ---------------------------------------------------------------------------
# Fake apiserver + client
# ---------------------------------------------------------------------------

class TestMergePatch:
    def test_rfc7386(self):
        assert merge_patch({"a": 1, "b": {"c": 2, "d": 3}},
                           {"b": {"c": 9, "d": None}, "e": 4}) == {
            "a": 1, "b": {"c": 9}, "e": 4}

    def test_list_replaced_whole(self):
        assert merge_patch({"x": [1, 2]}, {"x": [3]}) == {"x": [3]}


@pytest.fixture()
def fake():
    with FakeKubeApiServer() as server:
        yield server


@pytest.fixture()
def client(fake):
    return KubeClient(KubeConfig(server=fake.url))


class TestClient:
    def test_crud_pods(self, client):
        body = pod_to_k8s(Pod(metadata=ObjectMeta(name="p1"),
                              spec=PodSpec(containers=[Container()])))
        created = client.create(store_mod.PODS, "default", body)
        assert created["metadata"]["uid"]
        assert client.get(store_mod.PODS, "default", "p1")
        with pytest.raises(store_mod.AlreadyExistsError):
            client.create(store_mod.PODS, "default", body)
        client.delete(store_mod.PODS, "default", "p1")
        with pytest.raises(store_mod.NotFoundError):
            client.get(store_mod.PODS, "default", "p1")

    def test_list_label_selector(self, client):
        for i, labels in enumerate([{"group-name": constants.GROUP},
                                    {"group-name": "other"}]):
            client.create(store_mod.PODS, "default", pod_to_k8s(
                Pod(metadata=ObjectMeta(name=f"p{i}", labels=labels),
                    spec=PodSpec(containers=[Container()]))))
        items = client.list(store_mod.PODS, "default",
                            {"group-name": constants.GROUP})["items"]
        assert [i["metadata"]["name"] for i in items] == ["p0"]

    def test_status_subresource_patch(self, client):
        client.create(store_mod.TPUJOBS, "default", make_job())
        client.patch(store_mod.TPUJOBS, "default", "kj",
                     {"status": {"conditions": [{"type": "Created"}]},
                      "spec": {"successPolicy": "clobbered?"}},
                     subresource="status")
        raw = client.get(store_mod.TPUJOBS, "default", "kj")
        # /status must not touch spec.
        assert raw["spec"].get("successPolicy", "") != "clobbered?"
        assert raw["status"]["conditions"][0]["type"] == "Created"

    def test_watch_streams_events(self, client, fake):
        seen = []
        import threading

        def consume():
            for etype, obj in client.watch(store_mod.PODS, "default",
                                           None, "0"):
                seen.append((etype, obj["metadata"]["name"]))
                if len(seen) >= 2:
                    return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.2)
        client.create(store_mod.PODS, "default", pod_to_k8s(
            Pod(metadata=ObjectMeta(name="w1"),
                spec=PodSpec(containers=[Container()]))))
        fake.state.set_pod_phase("default", "w1", "Running")
        t.join(timeout=5)
        assert ("ADDED", "w1") in seen
        assert ("MODIFIED", "w1") in seen

    def test_crd_probe(self, client):
        assert check_crd_exists(client)

    def test_kubeconfig_parse(self, tmp_path):
        ca = base64.b64encode(b"fake-ca").decode()
        cfg_path = tmp_path / "config"
        cfg_path.write_text(f"""
apiVersion: v1
kind: Config
current-context: test
contexts:
  - name: test
    context: {{cluster: c1, user: u1, namespace: ml}}
clusters:
  - name: c1
    cluster:
      server: https://1.2.3.4:6443
      certificate-authority-data: {ca}
users:
  - name: u1
    user: {{token: secret-token}}
""")
        cfg = KubeConfig.from_kubeconfig(str(cfg_path))
        assert cfg.server == "https://1.2.3.4:6443"
        assert cfg.token == "secret-token"
        assert cfg.namespace == "ml"
        with open(cfg.ca_file, "rb") as f:
            assert f.read() == b"fake-ca"
        os.unlink(cfg.ca_file)


class TestRbacEnforcement:
    """The fake apiserver enforces manifests/gpu/rbac.yaml (VERDICT
    round-5 #6): any operator request outside the deployed ClusterRole's
    verbs answers 403, so manifest/RBAC drift fails hermetic e2e instead
    of surfacing on a real cluster."""

    def test_rules_loaded_by_default(self, fake):
        rules = fake.state.rbac_rules
        assert rules, "checked-in ClusterRole must load by default"
        assert "create" in rules[("", "pods")]
        assert "patch" in rules[(constants.GROUP, constants.PLURAL
                                 + "/status")]

    def test_ungranted_verb_403s(self, client, fake):
        # The role grants nodes get/list/watch/patch — never delete
        # (the operator cordons, it does not remove cluster nodes).
        fake.state.add_node("doomed")
        from tf_operator_tpu_torch.runtime.kube import KubeApiError

        with pytest.raises(KubeApiError) as exc:
            client.delete(store_mod.NODES, "", "doomed")
        assert exc.value.code == 403
        # The 403 names the missing grant, for drift debuggability.
        assert "delete" in str(exc.value) and "nodes" in str(exc.value)
        # The node survived the denied request.
        assert client.get(store_mod.NODES, "", "doomed")

    def test_tightened_role_fails_write_paths(self, tmp_path):
        # A role missing the pods create verb (the drift this guards
        # against: someone trims rbac.yaml without knowing the
        # controller creates pods) 403s the controller's write.
        role = tmp_path / "rbac.yaml"
        role.write_text("""\
apiVersion: rbac.authorization.k8s.io/v1
kind: ClusterRole
metadata: {name: tpu-operator}
rules:
  - apiGroups: [""]
    resources: ["pods"]
    verbs: ["get", "list", "watch"]
""")
        from tf_operator_tpu_torch.runtime.kube import KubeApiError

        with FakeKubeApiServer(rbac_path=str(role)) as server:
            c = KubeClient(KubeConfig(server=server.url))
            assert c.list(store_mod.PODS, "default")["items"] == []
            with pytest.raises(KubeApiError) as exc:
                c.create(store_mod.PODS, "default", pod_to_k8s(
                    Pod(metadata=ObjectMeta(name="px"),
                        spec=PodSpec(containers=[Container()]))))
            assert exc.value.code == 403

    def test_permissive_without_rules(self):
        with FakeKubeApiServer(rbac_path=None) as server:
            c = KubeClient(KubeConfig(server=server.url))
            fake_node = c.request("POST", "/api/v1/nodes",
                                  body={"apiVersion": "v1", "kind": "Node",
                                        "metadata": {"name": "n1"}})
            assert fake_node["metadata"]["name"] == "n1"


# ---------------------------------------------------------------------------
# Operator against the fake cluster: the engine unchanged, reconciling
# real (fake-served) pods. Reference analog: TestNormalPath +
# simple_tfjob_tests.py run-to-completion, but against the K8s path.
# ---------------------------------------------------------------------------

@pytest.fixture()
def operator(client):
    op = KubeOperator(client, post_events=False)
    op.start(threadiness=1, sync_timeout=10)
    yield op
    op.stop()


class TestKubeOperator:
    def _pods(self, fake, ns="default"):
        return fake.state.list("pods", ns, "")["items"]

    def test_job_runs_to_succeeded(self, client, fake, operator):
        client.create(store_mod.TPUJOBS, "default", make_job(workers=2))

        pods = wait_for(lambda: len(self._pods(fake)) == 2
                        and self._pods(fake), msg="2 pods created")
        names = sorted(p["metadata"]["name"] for p in pods)
        assert names == ["kj-worker-0", "kj-worker-1"]
        # Pods carry the controller ownerRef + bootstrap env.
        pod0 = fake.state.get("pods", "default", "kj-worker-0")
        ref = pod0["metadata"]["ownerReferences"][0]
        assert (ref["kind"], ref["controller"]) == (constants.KIND, True)
        env = {e["name"]: e["value"]
               for e in pod0["spec"]["containers"][0]["env"]}
        assert env.get("RANK") == "0"
        # Per-replica headless services exist too (created later in the
        # same sync pass as the pods).
        wait_for(lambda: sorted(
            s["metadata"]["name"]
            for s in fake.state.list("services", "default", "")["items"])
            == names, msg="per-replica services")

        fake.state.set_all_pods_phase("default", "Running")
        wait_for(lambda: any(
            c["type"] == JobConditionType.RUNNING and c["status"] == "True"
            for c in (client.get(store_mod.TPUJOBS, "default", "kj")
                      .get("status") or {}).get("conditions") or []),
            msg="job Running")

        fake.state.set_all_pods_phase("default", "Succeeded")
        wait_for(lambda: any(
            c["type"] == JobConditionType.SUCCEEDED and c["status"] == "True"
            for c in (client.get(store_mod.TPUJOBS, "default", "kj")
                      .get("status") or {}).get("conditions") or []),
            msg="job Succeeded")

    def test_retryable_exit_restarts_pod_in_cluster(self, client, fake,
                                                    operator):
        body = make_job(name="rj", workers=1)
        body["spec"]["replicaSpecs"]["worker"]["restartPolicy"] = "ExitCode"
        client.create(store_mod.TPUJOBS, "default", body)
        wait_for(lambda: len(self._pods(fake)) == 1, msg="pod created")
        first_uid = fake.state.get("pods", "default",
                                   "rj-worker-0")["metadata"]["uid"]
        # SIGKILL (137) is retryable -> delete + recreate same index.
        fake.state.set_pod_phase("default", "rj-worker-0", "Failed",
                                 exit_code=137)
        wait_for(lambda: (self._pods(fake) and
                          self._pods(fake)[0]["metadata"]["uid"] != first_uid),
                 msg="pod recreated with fresh uid")
        again = fake.state.get("pods", "default", "rj-worker-0")
        assert again["metadata"]["name"] == "rj-worker-0"  # same identity

    def test_orphan_pod_adopted_via_patch(self, client, fake, operator):
        client.create(store_mod.TPUJOBS, "default", make_job(name="aj",
                                                             workers=1))
        wait_for(lambda: len(self._pods(fake)) == 1, msg="pod created")
        # Plant an orphan that matches the job's selector at index 1...
        orphan = pod_to_k8s(Pod(
            metadata=ObjectMeta(name="aj-worker-extra", labels={
                constants.LABEL_GROUP_NAME: constants.GROUP,
                constants.LABEL_JOB_NAME: "aj",
                constants.LABEL_REPLICA_TYPE: "worker",
                constants.LABEL_REPLICA_INDEX: "1"}),
            spec=PodSpec(containers=[Container()])))
        client.create(store_mod.PODS, "default", orphan)
        # ...the controller adopts it (ownership patch) and, as an
        # out-of-range index, scales it down.
        wait_for(lambda: fake.state.objects["pods"].get(
            ("default", "aj-worker-extra")) is None,
            msg="adopted orphan deleted as out-of-range")

    def test_relabeled_pod_released_via_patch(self, client, fake, operator):
        client.create(store_mod.TPUJOBS, "default", make_job(name="rl",
                                                             workers=1))
        wait_for(lambda: len(self._pods(fake)) == 1, msg="pod created")
        # The pod's labels stop matching the job selector: the controller
        # must patch its ownerReference away (release), not delete it.
        client.patch(store_mod.PODS, "default", "rl-worker-0",
                     {"metadata": {"labels": {"job-name": "quarantine"}}})

        def released():
            raw = fake.state.get("pods", "default", "rl-worker-0")
            return not (raw.get("metadata") or {}).get("ownerReferences")

        wait_for(released, msg="ownerReferences patched away")
        assert fake.state.get("pods", "default", "rl-worker-0")  # not deleted

    def test_job_delete_cascades(self, client, fake, operator):
        client.create(store_mod.TPUJOBS, "default", make_job(name="dj",
                                                             workers=2))
        wait_for(lambda: len(self._pods(fake)) == 2, msg="pods created")
        client.delete(store_mod.TPUJOBS, "default", "dj")
        wait_for(lambda: not self._pods(fake), timeout=20,
                 msg="pods garbage-collected")
        assert not fake.state.list("services", "default", "")["items"]


class TestKubeLeaderElection:
    def test_lease_cas_and_failover(self, client):
        from tf_operator_tpu_torch.runtime.kube import KubeLeaseStore
        from tf_operator_tpu_torch.runtime.leaderelection import LeaderElector

        # Whole-second durations: K8s LeaseSpec carries an integer.
        a = LeaderElector(KubeLeaseStore(client), identity="a",
                          lease_duration=2.0, renew_deadline=0.5,
                          retry_period=0.1)
        b = LeaderElector(KubeLeaseStore(client), identity="b",
                          lease_duration=2.0, renew_deadline=0.5,
                          retry_period=0.1)
        a.start()
        assert a.wait_until_leading(timeout=5)
        b.start()
        assert not b.wait_until_leading(timeout=0.6)  # lease held by a
        a.stop()  # releases -> b takes over
        assert b.wait_until_leading(timeout=5)
        b.stop()


class TestKubeSdk:
    """TPUJobClient directly against the (fake) cluster: the reference
    SDK deployment shape (kubernetes-client from kubeconfig)."""

    @pytest.fixture()
    def sdk(self, client):
        from tf_operator_tpu_torch.runtime.kube import KubeSdkStore
        from tf_operator_tpu_torch.sdk import TPUJobClient

        return TPUJobClient(KubeSdkStore(client), namespace="default")

    @pytest.fixture()
    def operator_with_events(self, client):
        op = KubeOperator(client, post_events=True)
        op.start(threadiness=1, sync_timeout=10)
        yield op
        op.stop()

    def test_full_lifecycle_surface(self, sdk, fake, operator_with_events):
        job = sdk.create(make_job(name="sdkjob", workers=2))
        assert job.metadata.uid

        # Watch: replay + live condition events through the K8s stream.
        events = []
        for etype, j in sdk.watch(name="sdkjob", timeout=20,
                                  until_finished=True):
            events.append((etype, [c.type for c in j.status.conditions]))
            pods = fake.state.list("pods", "default", "")["items"]
            phases = {p["status"]["phase"] for p in pods}
            # Drive the fake kubelet only once the FULL gang exists: a
            # watch event can legally arrive mid-creation (the
            # workqueue's lost-wakeup fix made syncs prompt enough to
            # observe it), and flipping a partial pod set would strand
            # the late-created pod Pending forever.
            if len(pods) == 2 and phases == {"Pending"}:
                fake.state.set_all_pods_phase("default", "Running")
            elif len(pods) == 2 and phases == {"Running"}:
                fake.state.set_all_pods_phase("default", "Succeeded")
        assert any("Succeeded" in conds for _, conds in events)
        assert sdk.is_job_succeeded("sdkjob")

        # Pod surface.
        assert sdk.get_pod_names("sdkjob") == ["sdkjob-worker-0",
                                               "sdkjob-worker-1"]
        assert sdk.get_pod_names("sdkjob", replica_index=1) == [
            "sdkjob-worker-1"]

        # Logs through the kubelet log API (fake log store).
        fake.state.set_pod_log("default", "sdkjob-worker-0",
                               "line1\nline2\nline3")
        assert sdk.get_logs("sdkjob-worker-0").endswith("line3")
        assert sdk.get_logs("sdkjob-worker-0", tail_lines=1) == "line3"

        # Events posted by the operator as core/v1 Events, recovered
        # through the job-name attribution.
        evs = sdk.get_events("sdkjob")
        assert any(e.reason == "SuccessfulCreatePod" for e in evs)
        assert sdk.get_creation_failures("sdkjob") == []

        # Delete + wait_for_delete.
        sdk.delete("sdkjob")
        sdk.wait_for_delete("sdkjob", timeout=10)

    def test_patch_read_modify_write_cas(self, sdk, fake, operator):
        sdk.create(make_job(name="patchjob", workers=1))

        def bump(job):
            job.spec.run_policy.backoff_limit = 7

        updated = sdk.patch("patchjob", bump)
        assert updated.spec.run_policy.backoff_limit == 7
        raw = fake.state.get(constants.PLURAL, "default", "patchjob")
        assert raw["spec"]["runPolicy"]["backoffLimit"] == 7

    def test_stream_logs_follow(self, sdk, fake, operator):
        sdk.create(make_job(name="streamjob", workers=1))
        wait_for(lambda: fake.state.list("pods", "default", "")["items"],
                 msg="pod created")
        fake.state.set_pod_phase("default", "streamjob-worker-0", "Running")
        fake.state.set_pod_log("default", "streamjob-worker-0", "early\n")

        chunks = []
        import threading

        def consume():
            for chunk in sdk.stream_logs("streamjob-worker-0"):
                chunks.append(chunk)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.3)
        fake.state.append_pod_log("default", "streamjob-worker-0", "late\n")
        time.sleep(0.3)
        fake.state.set_pod_phase("default", "streamjob-worker-0",
                                 "Succeeded")
        t.join(timeout=10)
        assert not t.is_alive(), "follow stream never terminated"
        text = "".join(chunks)
        assert "early" in text and "late" in text


class TestKubeScale:
    def test_scale_up_and_down_via_cr_patch(self, client, fake, operator):
        client.create(store_mod.TPUJOBS, "default", make_job(name="sc",
                                                             workers=2))
        wait_for(lambda: len(self._pods(fake)) == 2, msg="2 pods")
        # Scale up 2 -> 3 via a spec merge patch on the CR.
        client.patch(store_mod.TPUJOBS, "default", "sc",
                     {"spec": {"replicaSpecs": {"worker": {"replicas": 3}}}})
        wait_for(lambda: len(self._pods(fake)) == 3, msg="scaled to 3")
        names = sorted(p["metadata"]["name"] for p in self._pods(fake))
        assert names == [f"sc-worker-{i}" for i in range(3)]
        # Scale down 3 -> 1: out-of-range indices deleted.
        client.patch(store_mod.TPUJOBS, "default", "sc",
                     {"spec": {"replicaSpecs": {"worker": {"replicas": 1}}}})
        wait_for(lambda: len(self._pods(fake)) == 1, msg="scaled to 1")
        assert self._pods(fake)[0]["metadata"]["name"] == "sc-worker-0"
        # The port's engine deletes every pod and service past replicas
        # and creates none there (the JAX engine can keep a pod at an
        # out-of-range index for good).
        wait_for(lambda: [s["metadata"]["name"] for s in fake.state.list(
            "services", "default", "")["items"]] == ["sc-worker-0"],
            msg="services past replicas deleted")
        time.sleep(0.5)
        assert [p["metadata"]["name"]
                for p in self._pods(fake)] == ["sc-worker-0"]

    def _pods(self, fake, ns="default"):
        return fake.state.list("pods", ns, "")["items"]


# ---------------------------------------------------------------------------
# Reflector chaos hardening (round-4): watch-resume, 410/compaction,
# dropped + reordered events, backoff, RV opacity, key-material cleanup,
# status-clear patches. Reference semantics: client-go
# tools/cache/reflector.go:166-302 (resume from lastSyncResourceVersion,
# relist on 410, backoff on failure).
# ---------------------------------------------------------------------------

from tf_operator_tpu_torch.runtime.kube import (  # noqa: E402
    KubeInformer,
    _meta_from_k8s,
    pod_to_k8s,
)
from tf_operator_tpu_torch.runtime.store import Store  # noqa: E402


def _mk_pod(name, labels=None):
    return pod_to_k8s(Pod(metadata=ObjectMeta(name=name,
                                              labels=dict(labels or {})),
                          spec=PodSpec(containers=[Container()])))


class TestReflectorChaos:
    @pytest.fixture()
    def env(self, fake):
        client = KubeClient(KubeConfig(server=fake.url),
                            watch_timeout_seconds=1.0)
        store = Store()
        inf = KubeInformer(client, store, store_mod.PODS)
        inf.start()
        assert inf.synced.wait(5)
        yield fake, client, store, inf
        inf.stop()

    def test_watch_resume_without_relist(self, env):
        """Normal stream expiry (timeoutSeconds) must RESUME from the
        last delivered RV — not relist: events across several stream
        generations arrive with exactly ONE list request ever issued."""
        fake, client, store, inf = env
        assert fake.state.list_counts.get("pods") == 1
        client.create(store_mod.PODS, "default", _mk_pod("p1"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "p1"),
                 msg="p1 mirrored")
        time.sleep(2.5)  # at least two 1s stream expiries
        client.create(store_mod.PODS, "default", _mk_pod("p2"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "p2"),
                 msg="p2 mirrored after stream recycles")
        assert fake.state.list_counts.get("pods") == 1, \
            "reflector relisted instead of resuming from last RV"

    def test_mid_stream_410_relists_and_converges(self, env):
        """An ERROR 410 mid-watch swallows the event it replaced; the
        reflector must relist (history unknowable) and converge."""
        fake, client, store, inf = env
        client.create(store_mod.PODS, "default", _mk_pod("a"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "a"),
                 msg="a mirrored")
        before = fake.state.list_counts.get("pods")
        fake.state.inject_watch_errors = 1
        client.create(store_mod.PODS, "default", _mk_pod("b"))  # swallowed
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "b"),
                 msg="b recovered via relist")
        assert fake.state.list_counts.get("pods") > before

    def test_non_410_watch_error_backs_off_then_recovers(self, env):
        """A 500-class watch error takes the failure path (backoff,
        relist) instead of a hot loop, and the mirror still converges."""
        fake, client, store, inf = env
        fake.state.watch_error_code = 500
        fake.state.inject_watch_errors = 1
        client.create(store_mod.PODS, "default", _mk_pod("c"))  # swallowed
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "c"),
                 timeout=15, msg="c recovered after backoff+relist")
        # A relist alone must NOT clear the failure counter (a
        # list-ok/watch-fails loop has to keep escalating); only a
        # delivered watch event proves the stream healthy again.
        assert inf._failures >= 1
        client.create(store_mod.PODS, "default", _mk_pod("c2"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "c2"),
                 timeout=15, msg="c2 delivered on the recovered stream")
        assert inf._failures == 0

    def test_compacted_rv_at_watch_start_relists(self, env):
        """Watch from an RV older than the compaction horizon gets an
        immediate 410 (etcd compaction): relist, then converge once the
        RV catches up."""
        fake, client, store, inf = env
        with fake.state.lock:
            fake.state.compact_rv = fake.state._rv + 2
        client.create(store_mod.PODS, "default", _mk_pod("d1"))
        client.create(store_mod.PODS, "default", _mk_pod("d2"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "d1")
                 and store.try_get(store_mod.PODS, "default", "d2"),
                 timeout=15, msg="mirror converges past compaction")

    def test_dropped_delete_reconciled_by_relist(self, env):
        """A DELETED event silently lost on the wire leaves a ghost in
        the cache; the next relist (here forced via 410) must remove it
        (_on_list's unseen-key sweep)."""
        fake, client, store, inf = env
        client.create(store_mod.PODS, "default", _mk_pod("keep"))
        client.create(store_mod.PODS, "default", _mk_pod("ghost"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "ghost"),
                 msg="ghost mirrored")
        fake.state.drop_events = 1
        client.delete(store_mod.PODS, "default", "ghost")  # event lost
        time.sleep(0.3)
        assert store.try_get(store_mod.PODS, "default", "ghost"), \
            "precondition: the delete event really was dropped"
        fake.state.inject_watch_errors = 1
        client.create(store_mod.PODS, "default", _mk_pod("trigger"))
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "ghost")
                 is None, msg="ghost swept by relist")
        assert store.try_get(store_mod.PODS, "default", "keep")

    def test_cross_object_reorder_converges(self, env):
        """Events of different objects delivered out of order (the only
        reorder a real apiserver can produce is cross-object) must leave
        both objects at their correct final state."""
        fake, client, store, inf = env
        fake.state.reorder_events = 1
        client.create(store_mod.PODS, "default", _mk_pod("r1"))  # held
        client.create(store_mod.PODS, "default", _mk_pod("r2"))  # first
        wait_for(lambda: store.try_get(store_mod.PODS, "default", "r1")
                 and store.try_get(store_mod.PODS, "default", "r2"),
                 msg="both pods mirrored despite reorder")

    def test_backoff_grows_exponentially(self, fake):
        client = KubeClient(KubeConfig(server=fake.url))
        inf = KubeInformer(client, Store(), store_mod.PODS)
        delays = []
        for n in (1, 2, 3, 6, 50):
            inf._failures = n
            delays.append(inf._backoff_seconds())
        # jittered exponential: each sample in [base/2, base]
        assert 0.25 <= delays[0] <= 0.5
        assert 0.5 <= delays[1] <= 1.0
        assert 1.0 <= delays[2] <= 2.0
        assert 8.0 <= delays[3] <= 16.0
        assert delays[4] <= 30.0  # capped


class TestAdvisorKubeFixes:
    def test_resource_version_is_opaque_string(self):
        meta = _meta_from_k8s({"name": "x", "resourceVersion": "abc-123"})
        assert meta.resource_version == "abc-123"  # no int coercion to 0
        meta2 = _meta_from_k8s({"name": "x", "resourceVersion": "999"})
        assert meta2.resource_version == "999"
        assert _meta_from_k8s({"name": "x"}).resource_version == 0

    def test_kubeconfig_temp_key_files_cleaned_up(self, tmp_path):
        """Inline key material materialized to temp files is tracked
        and deleted by close() (and at interpreter exit), never left
        behind in the tempdir."""
        ca = base64.b64encode(b"fake-ca").decode()
        key = base64.b64encode(b"fake-client-key").decode()
        cert = base64.b64encode(b"fake-client-cert").decode()
        cfg_path = tmp_path / "config"
        cfg_path.write_text(f"""
apiVersion: v1
kind: Config
current-context: test
contexts:
  - name: test
    context: {{cluster: c1, user: u1}}
clusters:
  - name: c1
    cluster:
      server: https://1.2.3.4:6443
      certificate-authority-data: {ca}
users:
  - name: u1
    user:
      client-certificate-data: {cert}
      client-key-data: {key}
""")
        cfg = KubeConfig.from_kubeconfig(str(cfg_path))
        files = list(cfg.temp_key_files)
        assert len(files) == 3
        assert all(os.path.exists(p) for p in files)
        # 0600: the key file must not be world/group readable.
        for p in files:
            assert (os.stat(p).st_mode & 0o077) == 0, oct(os.stat(p).st_mode)
        cfg.close()
        assert not any(os.path.exists(p) for p in files)
        assert cfg.temp_key_files == ()

    def test_status_patch_clears_omitted_fields(self, client, fake,
                                                operator):
        """A merge patch can only clear what it names: the controller's
        status writer must send explicit nulls for unset fields."""
        client.create(store_mod.TPUJOBS, "default", make_job(name="clr"))
        # Server-side status with a field the controller will not set.
        client.patch(store_mod.TPUJOBS, "default", "clr",
                     {"status": {"completionTime": "2020-01-01T00:00:00Z"}},
                     subresource="status")
        job = TPUJob(metadata=ObjectMeta(name="clr", namespace="default"))
        job.status.start_time = None
        job.status.completion_time = None
        operator.controller.update_job_status_in_api(job)
        raw = client.get(store_mod.TPUJOBS, "default", "clr")
        assert "completionTime" not in (raw.get("status") or {}), \
            "omitted field survived the status patch"

    def test_node_missing_ready_condition_is_not_ready(self):
        """kube-scheduler convention: a Node whose kubelet never
        heartbeated (NO Ready condition at all) is NotReady — its chips
        must not enter the gang-admission budget."""
        from tf_operator_tpu_torch.controller.binder import node_is_schedulable
        from tf_operator_tpu_torch.runtime.kube import node_from_k8s

        raw = {"metadata": {"name": "cold"},
               "spec": {},
               "status": {"allocatable": {constants.RESOURCE_GPU: "8"}}}
        node = node_from_k8s(raw)
        assert node.status.phase == "NotReady"
        assert not node_is_schedulable(node)

    def test_node_ready_condition_parsed(self):
        from tf_operator_tpu_torch.runtime.kube import node_from_k8s

        raw = {"metadata": {"name": "warm"}, "spec": {},
               "status": {"conditions": [
                   {"type": "Ready", "status": "True"},
                   {"type": "MaintenancePending", "status": "True"}]}}
        node = node_from_k8s(raw)
        assert node.status.phase == "Ready"
        assert node.status.conditions == {"Ready": "True",
                                          "MaintenancePending": "True"}

    def test_never_heartbeated_node_excluded_from_capacity(
            self, client, fake):
        """End to end through the informer: a conditions-less node
        contributes nothing to the admission chip budget."""
        fake.state.add_node("cold", chips=8, nvlink_domain="d1", ready=None)
        fake.state.add_node("warm", chips=8, nvlink_domain="d1")
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=10)
        try:
            wait_for(lambda: len(op.store.list(store_mod.NODES)) == 2,
                     msg="nodes mirrored")
            assert op._cluster_chip_capacity() == 8
        finally:
            op.stop()


class TestGangPdb:
    def test_gang_job_gets_pdb_and_cleanup(self, client, fake):
        """Reference SyncPdb parity: a gang-scheduled job gets a PDB
        named after it (minAvailable = gang minMember, selecting the
        job's pods, owner-referenced), and job deletion removes it."""
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True, total_chips=64)
        op.start(threadiness=1, sync_timeout=10)
        try:
            raw = make_job(name="gj", workers=3)
            raw["spec"]["runPolicy"] = {
                "schedulingPolicy": {"minAvailable": 2}}
            client.create(store_mod.TPUJOBS, "default", raw)
            pdb = wait_for(lambda: fake.state.objects[
                "poddisruptionbudgets"].get(("default", "gj")),
                msg="pdb created")
            assert pdb["spec"]["minAvailable"] == 2
            assert pdb["spec"]["selector"]["matchLabels"] == {
                constants.LABEL_JOB_NAME: "gj"}
            ref = pdb["metadata"]["ownerReferences"][0]
            assert ref["kind"] == constants.KIND and ref["name"] == "gj"

            # Level-triggered reconcile: minAvailable follows the gang
            # threshold, and an out-of-band PDB deletion is repaired.
            client.patch(store_mod.TPUJOBS, "default", "gj",
                         {"spec": {"runPolicy": {
                             "schedulingPolicy": {"minAvailable": 3}}}})
            wait_for(lambda: fake.state.objects[
                "poddisruptionbudgets"].get(("default", "gj"), {})
                .get("spec", {}).get("minAvailable") == 3,
                msg="pdb minAvailable patched to 3")
            with fake.state.lock:
                del fake.state.objects["poddisruptionbudgets"][
                    ("default", "gj")]
            # PDBs are not watched; repair rides the next job sync
            # (any event or the periodic resync) — nudge one here.
            client.patch(store_mod.TPUJOBS, "default", "gj",
                         {"metadata": {"annotations": {"nudge": "1"}}})
            wait_for(lambda: fake.state.objects[
                "poddisruptionbudgets"].get(("default", "gj")),
                msg="out-of-band-deleted pdb recreated on next sync")

            client.delete(store_mod.TPUJOBS, "default", "gj")
            wait_for(lambda: ("default", "gj") not in fake.state.objects[
                "poddisruptionbudgets"], msg="pdb deleted with job")
        finally:
            op.stop()



class TestKubeGangPreemption:
    def test_preemption_evicts_via_api_and_converges(self, client, fake):
        """Gang preemption on the KUBE backend: the victim's running pod
        is deleted through the API server (KubePodControl, not store
        bookkeeping), the engine recreates it, the preemptor runs on
        the freed chips, and after it finishes the victim re-admits —
        with a mid-flow injected watch error to prove the store-derived
        eviction state survives a relist."""
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True, total_chips=8,
                          gang_preemption=True,
                          gang_priority_classes={"prod": 100, "batch": 10})
        op.start(threadiness=1, sync_timeout=10)
        try:
            victim = make_job(name="vic", workers=1)
            victim["spec"]["slice"] = {"accelerator": "h100-8"}
            victim["spec"]["runPolicy"] = {"schedulingPolicy": {
                "minAvailable": 2, "priorityClass": "batch"}}
            client.create(store_mod.TPUJOBS, "default", victim)
            wait_for(lambda: fake.state.objects["pods"].get(
                ("default", "vic-worker-0")), msg="victim pod created")
            fake.state.set_pod_phase("default", "vic-worker-0", "Running")
            first_uid = fake.state.objects["pods"][
                ("default", "vic-worker-0")]["metadata"]["uid"]

            # Chaos: the next watch event is swallowed behind an ERROR;
            # the reflector relists and the preemption flow continues.
            fake.state.inject_watch_errors = 1

            pre = make_job(name="pre", workers=1)
            pre["spec"]["slice"] = {"accelerator": "h100-8"}
            pre["spec"]["runPolicy"] = {"schedulingPolicy": {
                "priorityClass": "prod"}}
            client.create(store_mod.TPUJOBS, "default", pre)

            # The victim's RUNNING pod must be deleted via the API and
            # recreated by the engine with a fresh uid.
            def evicted():
                pod = fake.state.objects["pods"].get(
                    ("default", "vic-worker-0"))
                return pod and pod["metadata"]["uid"] != first_uid
            wait_for(evicted, timeout=20,
                     msg="victim pod evicted + recreated via API")

            # Preemptor runs on the freed chips to completion.
            wait_for(lambda: fake.state.objects["pods"].get(
                ("default", "pre-worker-0")), msg="preemptor pod")
            fake.state.set_pod_phase("default", "pre-worker-0", "Running")
            fake.state.set_pod_phase("default", "pre-worker-0",
                                     "Succeeded")
            wait_for(lambda: any(
                c["type"] == JobConditionType.SUCCEEDED
                for c in (client.get(store_mod.TPUJOBS, "default", "pre")
                          .get("status") or {}).get("conditions") or []),
                timeout=20, msg="preemptor Succeeded")

            # Victim re-admits once the chips free: its SliceGroup
            # re-enters the admitted set (Inqueue — its recreated pod
            # is Pending until the fake marks phases, so it never
            # promotes to Running here).
            def readmitted():
                sg = op.store.try_get(store_mod.SLICEGROUPS, "default",
                                      "vic")
                return sg is not None and sg.status.phase in (
                    "Inqueue", "Running")
            wait_for(readmitted, timeout=20, msg="victim re-admitted")
        finally:
            op.stop()


class TestRateLimiting:
    """Round-5 client-side throttling (reference --kube-api-qps 5 /
    --kube-api-burst 10, options.go:81-82) + the fake's meanness taps."""

    def test_token_bucket_paces_requests(self, fake):
        limited = KubeClient(KubeConfig(server=fake.url), qps=50.0,
                             burst=2)
        start = time.monotonic()
        for _ in range(6):
            limited.list(store_mod.PODS, "default")
        elapsed = time.monotonic() - start
        # 2 burst tokens + 4 paced at 50/s >= 80ms of enforced wait.
        assert elapsed >= 0.07, f"bucket did not pace: {elapsed:.3f}s"

    def test_429_retry_after_honored(self, client, fake):
        fake.state.retry_after_seconds = 0  # fast test; header honored
        fake.state.inject_429 = 2
        assert client.list(store_mod.PODS, "default")["kind"] == "List"
        assert fake.state.throttled_requests == 2
        assert fake.state.inject_429 == 0

    def test_429_storm_eventually_surfaces(self, client, fake):
        from tf_operator_tpu_torch.runtime.kube import KubeApiError

        fake.state.retry_after_seconds = 0
        fake.state.inject_429 = 50
        with pytest.raises(KubeApiError) as err:
            client.list(store_mod.PODS, "default")
        assert err.value.code == 429

    def test_5xx_surfaces_unretried(self, client, fake):
        """500s are the reflector's to back off on — the client must
        not hide them behind silent retries."""
        from tf_operator_tpu_torch.runtime.kube import KubeApiError

        fake.state.inject_5xx = 1
        with pytest.raises(KubeApiError) as err:
            client.list(store_mod.PODS, "default")
        assert err.value.code == 500
        assert client.list(store_mod.PODS, "default")["kind"] == "List"

    def test_latency_injection_slows_but_works(self, client, fake):
        fake.state.latency_seconds = 0.02
        start = time.monotonic()
        client.list(store_mod.PODS, "default")
        assert time.monotonic() - start >= 0.02
        fake.state.latency_seconds = 0.0


class TestThrottledApiserverChaos:
    def test_gang_preemption_converges_under_throttled_apiserver(
            self, client, fake):
        """The round-4 preemption flow with a MEAN apiserver: every
        request pays injected latency, and 429 bursts hit mid-flow.
        The operator (QPS-limited like the reference deployment) must
        still evict the victim and run the preemptor to completion."""
        fake.state.latency_seconds = 0.01
        fake.state.retry_after_seconds = 0
        limited = KubeClient(KubeConfig(server=fake.url), qps=100.0,
                             burst=20)
        op = KubeOperator(limited, post_events=False,
                          enable_gang_scheduling=True, total_chips=8,
                          gang_preemption=True,
                          gang_priority_classes={"prod": 100, "batch": 10})
        op.start(threadiness=1, sync_timeout=15)
        try:
            victim = make_job(name="vic", workers=1)
            victim["spec"]["slice"] = {"accelerator": "h100-8"}
            victim["spec"]["runPolicy"] = {"schedulingPolicy": {
                "minAvailable": 2, "priorityClass": "batch"}}
            client.create(store_mod.TPUJOBS, "default", victim)
            wait_for(lambda: fake.state.objects["pods"].get(
                ("default", "vic-worker-0")), timeout=20,
                msg="victim pod created under latency")
            fake.state.set_pod_phase("default", "vic-worker-0", "Running")
            first_uid = fake.state.objects["pods"][
                ("default", "vic-worker-0")]["metadata"]["uid"]

            pre = make_job(name="pre", workers=1)
            pre["spec"]["slice"] = {"accelerator": "h100-8"}
            pre["spec"]["runPolicy"] = {"schedulingPolicy": {
                "priorityClass": "prod"}}
            client.create(store_mod.TPUJOBS, "default", pre)
            # 429 burst lands on the OPERATOR's preemption work (after
            # our own create returned — the test client retries at most
            # 6 attempts and must not race the injected budget).
            fake.state.inject_429 = 5

            def evicted():
                pod = fake.state.objects["pods"].get(
                    ("default", "vic-worker-0"))
                return pod and pod["metadata"]["uid"] != first_uid
            wait_for(evicted, timeout=30,
                     msg="victim evicted despite 429s + latency")

            wait_for(lambda: fake.state.objects["pods"].get(
                ("default", "pre-worker-0")), timeout=30,
                msg="preemptor pod")
            fake.state.set_pod_phase("default", "pre-worker-0", "Running")
            fake.state.set_pod_phase("default", "pre-worker-0",
                                     "Succeeded")
            wait_for(lambda: any(
                c["type"] == JobConditionType.SUCCEEDED
                for c in (client.get(store_mod.TPUJOBS, "default", "pre")
                          .get("status") or {}).get("conditions") or []),
                timeout=30, msg="preemptor Succeeded under chaos")
            assert fake.state.throttled_requests > 0
        finally:
            fake.state.latency_seconds = 0.0
            op.stop()


class TestLeaderFailoverDuringPreemption:
    def test_failover_mid_eviction_converges(self, client, fake):
        """Two operator replicas, Lease-elected; the leader dies right
        after preemption starts (victim flipped Pending, deletes in
        flight). The standby must finish the eviction and place the
        preemptor with no double-booked chips and no lost eviction —
        the mid-eviction state is store-derived, not leader memory."""
        from tf_operator_tpu_torch.runtime.kube import KubeLeaseStore
        from tf_operator_tpu_torch.runtime.leaderelection import LeaderElector

        fake.state.latency_seconds = 0.005  # widen the in-flight window
        for i in range(2):
            fake.state.add_node(f"n{i}", chips=8, nvlink_domain="dom-a")
        ops = [KubeOperator(KubeClient(KubeConfig(server=fake.url)),
                            post_events=False,
                            enable_gang_scheduling=True,
                            gang_preemption=True,
                            gang_priority_classes={"prod": 100,
                                                   "batch": 10})
               for _ in range(2)]
        electors = [
            LeaderElector(KubeLeaseStore(ops[i].client),
                          identity=f"op-{i}", lease_duration=2.0,
                          renew_deadline=0.8, retry_period=0.1,
                          on_started_leading=(
                              lambda op=ops[i]: op.start(
                                  threadiness=1, sync_timeout=15)))
            for i in range(2)]
        try:
            electors[0].start()
            assert electors[0].wait_until_leading(timeout=10)
            electors[1].start()

            victim = make_job(name="vic", workers=2)
            victim["spec"]["slice"] = {"accelerator": "h100-16"}
            victim["spec"]["runPolicy"] = {"schedulingPolicy": {
                "priorityClass": "batch"}}
            client.create(store_mod.TPUJOBS, "default", victim)

            def victim_bound():
                pods = [fake.state.objects["pods"].get(
                    ("default", f"vic-worker-{i}")) for i in range(2)]
                return all(p and (p["spec"].get("nodeName"))
                           for p in pods)
            wait_for(victim_bound, timeout=30, msg="victim bound")
            fake.state.set_pod_phase("default", "vic-worker-0", "Running")
            uids = {fake.state.objects["pods"][
                ("default", f"vic-worker-{i}")]["metadata"]["uid"]
                for i in range(2)}

            pre = make_job(name="pre", workers=2)
            pre["spec"]["slice"] = {"accelerator": "h100-16"}
            pre["spec"]["runPolicy"] = {"schedulingPolicy": {
                "priorityClass": "prod"}}
            client.create(store_mod.TPUJOBS, "default", pre)

            # The instant the victim's group is flipped back to Pending
            # (preemption decided, deletes possibly in flight), crash
            # the leader without releasing the lease.
            def preemption_started():
                sg = ops[0].store.try_get(store_mod.SLICEGROUPS,
                                          "default", "vic")
                return sg is not None and sg.status.phase == "Pending"
            wait_for(preemption_started, timeout=30,
                     msg="preemption decided")
            electors[0]._stop.set()
            electors[0]._thread.join(timeout=5)
            ops[0].stop()

            wait_for(lambda: electors[1].is_leader, timeout=15,
                     msg="standby acquired the lease")

            # Standby completes: victim evicted (fresh uids or gone,
            # unbound), preemptor bound on distinct nodes.
            def converged():
                vic = [fake.state.objects["pods"].get(
                    ("default", f"vic-worker-{i}")) for i in range(2)]
                if any(p and p["metadata"]["uid"] in uids for p in vic):
                    return False  # old victim pod still alive
                pre_pods = [fake.state.objects["pods"].get(
                    ("default", f"pre-worker-{i}")) for i in range(2)]
                return all(p and p["spec"].get("nodeName")
                           for p in pre_pods)
            wait_for(converged, timeout=40,
                     msg="standby finished eviction + placed preemptor")

            # No double-booking: per-node bound chip demand <= capacity.
            usage = {}
            for (ns, name), pod in fake.state.objects["pods"].items():
                node = (pod.get("spec") or {}).get("nodeName")
                phase = (pod.get("status") or {}).get("phase", "Pending")
                if not node or phase in ("Succeeded", "Failed"):
                    continue
                limits = ((pod["spec"]["containers"][0].get("resources")
                           or {}).get("limits") or {})
                usage[node] = usage.get(node, 0) + int(
                    limits.get(constants.RESOURCE_GPU, 0))
            assert all(v <= 8 for v in usage.values()), usage
            # And the victim stayed unbound while gated.
            for i in range(2):
                pod = fake.state.objects["pods"].get(
                    ("default", f"vic-worker-{i}"))
                assert pod is None or not pod["spec"].get("nodeName")
        finally:
            fake.state.latency_seconds = 0.0
            # The port's order: operators stop before their leases go.
            for op in ops:
                try:
                    op.stop()
                except Exception:
                    pass
            for e in electors:
                e.stop()


class TestGangBinderE2E:
    """Self-contained gang scheduling on the kube backend: the operator
    both gates (SliceGroup admission) and BINDS (controller/binder.py)
    — no external Volcano-class scheduler exists in this test, which is
    exactly the configuration the reference deadlocks on
    (common/job_controller.go:218-245 only creates a PodGroup and hopes
    a scheduler acts on it)."""

    @staticmethod
    def _node_of(fake, ns, name):
        pod = fake.state.objects["pods"].get((ns, name))
        return ((pod or {}).get("spec") or {}).get("nodeName", "")

    def test_binding_api(self, client, fake):
        fake.state.add_node("n1", chips=8, nvlink_domain="d1")
        body = pod_to_k8s(Pod(metadata=ObjectMeta(name="bp"),
                              spec=PodSpec(containers=[Container()])))
        client.create(store_mod.PODS, "default", body)
        client.bind_pod("default", "bp", "n1")
        assert self._node_of(fake, "default", "bp") == "n1"
        with pytest.raises(store_mod.ConflictError):
            client.bind_pod("default", "bp", "n2")  # second bind loses

    def test_full_gang_lifecycle_admit_bind_preempt_evict_rebind(
            self, client, fake):
        """admission -> topology-aware bind -> run -> preemption ->
        eviction -> preemptor binds onto freed chips -> victim rebinds,
        with a chaos watch error mid-flow. Capacity comes from node
        inventory (no --total-chips), placement from the ICI-domain
        labels."""
        # Two ICI domains x two 8-chip hosts: 32 chips total.
        for dom in ("dom-a", "dom-b"):
            for i in range(2):
                fake.state.add_node(f"{dom}-n{i}", chips=8, nvlink_domain=dom)
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True,
                          gang_preemption=True,
                          gang_priority_classes={"prod": 100, "batch": 10})
        op.start(threadiness=1, sync_timeout=10)
        try:
            # Victim: whole h100-16 slice (2 hosts x 8 chips), batch.
            victim = make_job(name="vic", workers=2)
            victim["spec"]["slice"] = {"accelerator": "h100-16"}
            victim["spec"]["runPolicy"] = {"schedulingPolicy": {
                "priorityClass": "batch"}}
            client.create(store_mod.TPUJOBS, "default", victim)

            # Both workers bind — into ONE ICI domain — with the chip
            # request stamped from the slice topology.
            def victim_bound():
                nodes = [self._node_of(fake, "default", f"vic-worker-{i}")
                         for i in range(2)]
                return nodes if all(nodes) else None
            nodes = wait_for(victim_bound, timeout=20,
                             msg="victim workers bound")
            assert len({n.rsplit("-n", 1)[0] for n in nodes}) == 1, \
                f"slice split across ICI domains: {nodes}"
            pod = fake.state.objects["pods"][("default", "vic-worker-0")]
            limits = pod["spec"]["containers"][0]["resources"]["limits"]
            assert limits[constants.RESOURCE_GPU] == "8"

            # Kubelet reports one worker Running (gang not fully up:
            # group stays Inqueue = preemptible).
            fake.state.set_pod_phase("default", "vic-worker-0", "Running")
            first_uid = fake.state.objects["pods"][
                ("default", "vic-worker-0")]["metadata"]["uid"]

            # Another h100-16 x2-slice job needs 32 chips; only 16 free.
            # Chaos: swallow the next watch event behind an ERROR.
            fake.state.inject_watch_errors = 1
            pre = make_job(name="pre", workers=4)
            pre["spec"]["slice"] = {"accelerator": "h100-16",
                                    "numSlices": 2}
            pre["spec"]["runPolicy"] = {"schedulingPolicy": {
                "priorityClass": "prod"}}
            client.create(store_mod.TPUJOBS, "default", pre)

            # Victim evicted via the API (fresh uid) and left UNBOUND:
            # its group is Pending again, so the binder must not place
            # the recreated pods.
            def evicted():
                pod = fake.state.objects["pods"].get(
                    ("default", "vic-worker-0"))
                return pod and pod["metadata"]["uid"] != first_uid
            wait_for(evicted, timeout=20, msg="victim evicted via API")

            # All four preemptor workers bind, each slice whole within
            # one domain.
            def pre_bound():
                nodes = [self._node_of(fake, "default", f"pre-worker-{i}")
                         for i in range(4)]
                return nodes if all(nodes) else None
            nodes = wait_for(pre_bound, timeout=20,
                             msg="preemptor workers bound")
            doms = [n.rsplit("-n", 1)[0] for n in nodes]
            assert len({doms[0], doms[1]}) == 1, f"slice 0 split: {nodes}"
            assert len({doms[2], doms[3]}) == 1, f"slice 1 split: {nodes}"
            assert len(set(nodes)) == 4, f"double-booked node: {nodes}"
            # And the victim stayed unbound while gated.
            assert not self._node_of(fake, "default", "vic-worker-0")

            # Preemptor runs to completion; chips free; victim
            # re-admits and REBINDS.
            fake.state.set_all_pods_phase(
                "default", "Running",
                selector={constants.LABEL_JOB_NAME: "pre"})
            fake.state.set_all_pods_phase(
                "default", "Succeeded",
                selector={constants.LABEL_JOB_NAME: "pre"})
            wait_for(lambda: any(
                c["type"] == JobConditionType.SUCCEEDED
                for c in (client.get(store_mod.TPUJOBS, "default", "pre")
                          .get("status") or {}).get("conditions") or []),
                timeout=20, msg="preemptor Succeeded")
            wait_for(victim_bound, timeout=20,
                     msg="victim rebound after chips freed")
        finally:
            op.stop()

    def test_slice_no_domain_can_hold_is_infeasible_not_blocking(
            self, client, fake):
        """Aggregate capacity fits a h100-16 slice (8+8 chips), but no
        single ICI domain does — structurally unplaceable. It must be
        skipped as infeasible (not admitted-and-stuck booking budget),
        and a placeable job behind it must still run."""
        fake.state.add_node("a0", chips=8, nvlink_domain="dom-a")
        fake.state.add_node("b0", chips=8, nvlink_domain="dom-b")
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=10)
        try:
            big = make_job(name="big", workers=2)
            big["spec"]["slice"] = {"accelerator": "h100-16"}
            client.create(store_mod.TPUJOBS, "default", big)
            small = make_job(name="small", workers=1)
            small["spec"]["slice"] = {"accelerator": "h100-8"}
            client.create(store_mod.TPUJOBS, "default", small)

            wait_for(lambda: self._node_of(fake, "default",
                                           "small-worker-0"),
                     timeout=20, msg="placeable job bound behind "
                                     "infeasible one")
            sg = op.store.try_get(store_mod.SLICEGROUPS, "default", "big")
            assert sg is not None and sg.status.phase == "Pending"
            assert not self._node_of(fake, "default", "big-worker-0")
        finally:
            op.stop()

    def test_binder_converges_under_throttled_apiserver(self, client,
                                                        fake):
        """The self-contained bind path under a MEAN apiserver: every
        request pays latency and a 429 burst lands mid-flow; admission
        (node-derived capacity) and binding still converge with the
        slice whole in one domain."""
        fake.state.latency_seconds = 0.01
        fake.state.retry_after_seconds = 0
        for dom in ("dom-a", "dom-b"):
            for i in range(2):
                fake.state.add_node(f"{dom}-n{i}", chips=8,
                                    nvlink_domain=dom)
        limited = KubeClient(KubeConfig(server=fake.url), qps=100.0,
                             burst=20)
        op = KubeOperator(limited, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=15)
        try:
            raw = make_job(name="cj", workers=2)
            raw["spec"]["slice"] = {"accelerator": "h100-16"}
            client.create(store_mod.TPUJOBS, "default", raw)
            fake.state.inject_429 = 5  # lands on the operator's work

            def bound():
                nodes = [self._node_of(fake, "default",
                                       f"cj-worker-{i}")
                         for i in range(2)]
                return nodes if all(nodes) else None
            nodes = wait_for(bound, timeout=30,
                             msg="gang bound under 429s + latency")
            assert len({n.rsplit("-n", 1)[0] for n in nodes}) == 1
            assert fake.state.throttled_requests > 0
        finally:
            fake.state.latency_seconds = 0.0
            op.stop()

    def test_capacity_follows_cordon(self, client, fake):
        """Node-derived admission capacity: cordoning the only TPU node
        blocks admission (pods stay unbound); uncordoning admits and
        binds — the binder's readmit hook closes the loop with no job
        nudge."""
        fake.state.add_node("n1", chips=8, nvlink_domain="d1")
        op = KubeOperator(client, post_events=False,
                          enable_gang_scheduling=True)
        op.start(threadiness=1, sync_timeout=10)
        try:
            fake.state.cordon_node("n1")
            raw = make_job(name="cj", workers=1)
            raw["spec"]["slice"] = {"accelerator": "h100-8"}
            client.create(store_mod.TPUJOBS, "default", raw)
            wait_for(lambda: fake.state.objects["pods"].get(
                ("default", "cj-worker-0")), msg="pod created")
            time.sleep(1.0)  # give a wrong admission/bind time to land
            sg = op.store.try_get(store_mod.SLICEGROUPS, "default", "cj")
            assert sg is not None and sg.status.phase == "Pending"
            assert not self._node_of(fake, "default", "cj-worker-0")

            fake.state.cordon_node("n1", unschedulable=False)
            wait_for(lambda: self._node_of(fake, "default",
                                           "cj-worker-0") == "n1",
                     timeout=20, msg="pod bound after uncordon")
        finally:
            op.stop()


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
