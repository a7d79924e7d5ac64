"""The port's Kubernetes plane against the JAX package's, on the CPU,
each package against its own fake API server (``runtime/kube_fake.py``).

- Schema: the port's schema of the port's types is the JAX schema of
  JAX's types, and ``manifests/gpu/`` holds its generated copies.
- Converters: pods, services, TPUJobs and nodes convert as JAX's do,
  round trips included; the device resource and the fabric-domain label
  are the only differences (``nvidia.com/gpu`` and
  ``tpu-operator.dev/nvlink-domain`` where JAX has ``google.com/tpu``
  and ``tpu-operator.dev/ici-domain``).
- The kube backend: each package's ``KubeOperator`` runs a 2-worker job
  created as a CR; its slice-gang binder binds the pods to the fake's
  node, the fake kubelet sets them Running then Succeeded, and the job
  ends Succeeded. The pods', services' and job status's wire bodies match
  after masking uids, resourceVersions, timestamps, the bootstrap hash,
  the device names and the bootstrap env (JAX's keys against the torch
  env, held against each package's ``render_worker_env``).
- A leader-election lease through ``KubeLeaseStore``, and the SDK's
  ``connect_kube`` CRUD and logs, as JAX's.
- The fake enforces the port's own ClusterRole (``manifests/gpu/rbac.yaml``).

One fake server serves each package for the whole module; each scenario
uses its own names.
"""

import importlib.util
import json
import os
import time
import types

import pytest
import yaml

from tf_operator_tpu import testutil as jtestutil
from tf_operator_tpu.api import constants as jconst
from tf_operator_tpu.api import schema as jschema
from tf_operator_tpu.api import types as jtypes
from tf_operator_tpu.bootstrap import render_worker_env as j_render
from tf_operator_tpu.runtime import kube as jkube
from tf_operator_tpu.runtime import kube_fake as jfake
from tf_operator_tpu.runtime import leaderelection as jle
from tf_operator_tpu.runtime import store as jstore
from tf_operator_tpu.sdk import TPUJobClient as JClient
from tf_operator_tpu_torch import testutil as ttestutil
from tf_operator_tpu_torch.api import constants as tconst
from tf_operator_tpu_torch.api import schema as tschema
from tf_operator_tpu_torch.api import types as ttypes
from tf_operator_tpu_torch.bootstrap import render_worker_env as t_render
from tf_operator_tpu_torch.runtime import kube as tkube
from tf_operator_tpu_torch.runtime import kube_fake as tfake
from tf_operator_tpu_torch.runtime import leaderelection as tle
from tf_operator_tpu_torch.runtime import store as tstore
from tf_operator_tpu_torch.sdk import TPUJobClient as TClient

pytestmark = pytest.mark.control_plane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_MANIFESTS = os.path.join(REPO, "manifests", "gpu")

PK = {
    "jax": types.SimpleNamespace(
        kube=jkube, fake=jfake, store=jstore, types=jtypes, const=jconst,
        le=jle, client=JClient, testutil=jtestutil, render=j_render,
        device=jconst.RESOURCE_TPU, domain=jconst.LABEL_ICI_DOMAIN,
        accelerator="v5e-8", domain_kw="ici_domain"),
    "torch": types.SimpleNamespace(
        kube=tkube, fake=tfake, store=tstore, types=ttypes, const=tconst,
        le=tle, client=TClient, testutil=ttestutil, render=t_render,
        device=tconst.RESOURCE_GPU, domain=tconst.LABEL_NVLINK_DOMAIN,
        accelerator="h100-8", domain_kw="nvlink_domain"),
}
VOLATILE = {"uid", "resourceVersion", "creationTimestamp",
            "deletionTimestamp", "lastTransitionTime", "lastUpdateTime",
            "startTime", "completionTime", "lastReconcileTime",
            "allReplicasReadyTime", "renewTime", "acquireTime",
            "lastHeartbeatTime"}
KUBECONFIG = """\
apiVersion: v1
kind: Config
current-context: test
contexts:
  - name: test
    context:
      cluster: test
      user: test
      namespace: {namespace}
clusters:
  - name: test
    cluster:
      server: {server}
users:
  - name: test
    user: {{}}
"""


def mask(obj, pk=None):
    """``obj`` with the fields two runs cannot share masked, and the
    package's device and domain names made generic."""
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if pk is not None:
                key = {pk.device: "<device>",
                       pk.domain: "<domain>"}.get(key, key)
            if key in VOLATILE:
                value = "*"
            elif key == tconst.ANNOTATION_BOOTSTRAP_HASH:
                value = "*"
            else:
                value = mask(value, pk)
            out[key] = value
        return out
    if isinstance(obj, list):
        return [mask(v, pk) for v in obj]
    if pk is not None and obj in (pk.device, pk.domain, pk.accelerator):
        return {pk.device: "<device>", pk.domain: "<domain>",
                pk.accelerator: "<accelerator>"}[obj]
    return obj


def wait_for(cond, what: str, timeout: float = 20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.03)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def fakes():
    servers = {name: pk.fake.FakeKubeApiServer().start()
               for name, pk in PK.items()}
    yield servers
    for server in servers.values():
        server.stop()


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def test_schema_is_the_jax_schema():
    assert tschema.generate_schema() == jschema.generate_schema()
    assert tschema.generate_crd_schema() == jschema.generate_crd_schema()


@pytest.mark.parametrize("name", ["tpujob.schema.json", "crd.yaml"])
def test_checked_in_gpu_manifests_are_generated(name):
    # Loaded under its own name: manifests/gen.py is the JAX one's "gen".
    spec = importlib.util.spec_from_file_location(
        "gpu_manifests_gen", os.path.join(GPU_MANIFESTS, "gen.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    want = {"tpujob.schema.json": gen.render_schema,
            "crd.yaml": gen.render_crd}[name]()
    with open(os.path.join(GPU_MANIFESTS, name)) as f:
        assert f.read() == want, (
            f"manifests/gpu/{name} is stale; run python manifests/gpu/gen.py")


def test_schema_takes_a_gpu_job():
    import jsonschema

    job = ttestutil.new_tpujob(worker=2, ps=1, name="gpu-schema")
    job.spec.slice.accelerator = "h100-16"
    jsonschema.validate(job.to_dict(), tschema.generate_schema())
    with pytest.raises(jsonschema.ValidationError):
        jsonschema.validate({"spec": {"replicaSpecs": "not-a-map"}},
                            tschema.generate_schema())


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _pod_dict(pk):
    return {
        "metadata": {"name": "j-worker-0", "namespace": "ns1",
                     "labels": {"replica-type": "worker",
                                "replica-index": "0"},
                     "annotations": {"a": "b"}},
        "spec": {
            "containers": [{
                "name": "jax", "image": "img:1", "command": ["python", "x.py"],
                "args": ["--flag"], "env": {"B": "2", "WORLD_SIZE": "2"},
                "ports": {"tpujob-port": 8470},
                "resources": {pk.device: "4"}, "workingDir": "/app"}],
            "restartPolicy": "ExitCode", "schedulerName": "gang",
            "nodeSelector": {pk.domain: "d1"}, "nodeName": "node-1",
            "tolerations": [{"key": pk.device, "operator": "Exists"},
                            {"key": "dedicated", "operator": "Equal",
                             "value": "ml", "effect": "NoSchedule",
                             "tolerationSeconds": 60}],
            "relayDir": "/var/run/relay"},
        "status": {"phase": "Running", "host": "10.0.0.1"}}


def _k8s_node(pk, chips="8", ready="True", unschedulable=False):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "node-a", "labels": {pk.domain: "dom-1"},
                         "annotations": {
                             pk.const.ANNOTATION_AGENT_HEARTBEAT:
                             "2026-01-02T03:04:05+00:00"}},
            "spec": {"unschedulable": unschedulable,
                     "taints": [{"key": pk.device, "value": "present",
                                 "effect": "NoSchedule"}]},
            "status": {"allocatable": {pk.device: chips, "cpu": "3500m",
                                       "memory": "16Gi"},
                       "addresses": [{"type": "InternalIP",
                                      "address": "10.1.2.3"}],
                       "conditions": [{"type": "Ready", "status": ready}]}}


CONVERTERS = {
    "pod_to_k8s": lambda pk: pk.kube.pod_to_k8s(
        pk.types.Pod.from_dict(_pod_dict(pk))),
    "pod_round_trip": lambda pk: pk.kube.pod_from_k8s(pk.kube.pod_to_k8s(
        pk.types.Pod.from_dict(_pod_dict(pk)))).to_dict(),
    "pod_from_k8s_terminated": lambda pk: pk.kube.pod_from_k8s(
        {"metadata": {"name": "p", "namespace": "d", "resourceVersion": "9"},
         "spec": {"containers": [{"name": "jax"}]},
         "status": {"phase": "Failed", "containerStatuses": [
             {"name": "jax", "restartCount": 2,
              "state": {"terminated": {"exitCode": 137,
                                       "reason": "OOMKilled"}}}]}}
    ).to_dict(),
    "service_round_trip": lambda pk: [
        pk.kube.service_to_k8s(ep),
        pk.kube.endpoint_from_k8s_service(
            pk.kube.service_to_k8s(ep)).to_dict()]
    if (ep := pk.types.Endpoint(
        metadata=pk.types.ObjectMeta(name="j-worker-0",
                                     labels={"replica-index": "0"}),
        spec=pk.types.EndpointSpec(selector={"job-name": "j"},
                                   ports={"tpujob-port": 8470}))) else None,
    "tpujob_round_trip": lambda pk: [
        pk.kube.tpujob_to_k8s(job),
        pk.kube.tpujob_from_k8s(dict(pk.kube.tpujob_to_k8s(job),
                                     metadata={"name": "t", "uid": "u",
                                               "resourceVersion": "41"})
                                ).to_dict()]
    if (job := _slice_job(pk, "conv", workers=3)) else None,
    "node_ready": lambda pk: pk.kube.node_from_k8s(_k8s_node(pk)).to_dict(),
    "node_cordoned_not_ready": lambda pk: pk.kube.node_from_k8s(_k8s_node(
        pk, chips="16", ready="False", unschedulable=True)).to_dict(),
    "node_no_device": lambda pk: pk.kube.node_from_k8s(
        {"metadata": {"name": "cpu-node"},
         "status": {"allocatable": {"cpu": "4"}}}).to_dict(),
}


@pytest.mark.parametrize("case", sorted(CONVERTERS))
def test_converter_matches_jax(case):
    got = {name: mask(CONVERTERS[case](pk), pk) for name, pk in PK.items()}
    assert got["torch"] == got["jax"]


def test_node_reads_allocatable_gpus():
    node = tkube.node_from_k8s(_k8s_node(PK["torch"], chips="8"))
    assert node.spec.chips == 8
    assert node.metadata.labels[tconst.LABEL_NVLINK_DOMAIN] == "dom-1"
    # A TPU node's chips are not GPUs.
    assert tkube.node_from_k8s(_k8s_node(PK["jax"])).spec.chips == 0


# ---------------------------------------------------------------------------
# The kube backend: a CR-submitted job through binder, kubelet, Succeeded
# ---------------------------------------------------------------------------

def _slice_job(pk, name: str, workers: int = 2):
    job = pk.testutil.new_tpujob(worker=workers, name=name)
    job.spec.slice.accelerator = pk.accelerator
    job.spec.replica_specs["worker"].template.spec.containers[0].command = [
        "python", "-m", "train"]
    return job


def _run_job_through_kube(pk, fake, name: str):
    client = pk.kube.KubeClient(pk.kube.KubeConfig(server=fake.url))
    fake.state.add_node(f"{name}-node", chips=16, **{pk.domain_kw: name})
    op = pk.kube.KubeOperator(client, post_events=False,
                              enable_gang_scheduling=True)
    op.start(threadiness=1, sync_timeout=10)
    try:
        client.create(pk.store.TPUJOBS, "default",
                      pk.kube.tpujob_to_k8s(_slice_job(pk, name)))

        def pods():
            return [p for p in fake.state.list("pods", "default", "")["items"]
                    if p["metadata"]["name"].startswith(f"{name}-")]

        wait_for(lambda: len(pods()) == 2 and all(
            p["spec"].get("nodeName") for p in pods()), "both pods bound")
        for phase, ctype in (("Running", "Running"),
                             ("Succeeded", "Succeeded")):
            for pod in sorted(p["metadata"]["name"] for p in pods()):
                fake.state.set_pod_phase("default", pod, phase)
            wait_for(lambda: any(
                c["type"] == ctype and c["status"] == "True"
                for c in (client.get(pk.store.TPUJOBS, "default", name)
                          .get("status") or {}).get("conditions") or []),
                f"{name} {ctype}")
        job = client.get(pk.store.TPUJOBS, "default", name)
        services = [s for s in fake.state.list("services", "default",
                                               "")["items"]
                    if s["metadata"]["name"].startswith(f"{name}-")]
        return sorted(pods(), key=lambda p: p["metadata"]["name"]), \
            sorted(services, key=lambda s: s["metadata"]["name"]), job
    finally:
        op.stop()


def _without_env(pod: dict) -> dict:
    pod = json.loads(json.dumps(pod))
    envs = []
    for c in pod["spec"]["containers"]:
        envs.append({e["name"]: e.get("value", "") for e in c.pop("env", [])})
    return pod, envs


def test_kube_operator_runs_a_cr_job_as_jax(fakes):
    got = {}
    for name, pk in PK.items():
        got[name] = _run_job_through_kube(pk, fakes[name], "kjob")
    (jpods, jsvcs, jjob), (tpods, tsvcs, tjob) = got["jax"], got["torch"]
    assert [p["spec"]["nodeName"] for p in tpods] == ["kjob-node"] * 2
    jbodies = [_without_env(p) for p in jpods]
    tbodies = [_without_env(p) for p in tpods]
    assert [mask(b, PK["torch"]) for b, _ in tbodies] == \
        [mask(b, PK["jax"]) for b, _ in jbodies]
    assert mask(tsvcs, PK["torch"]) == mask(jsvcs, PK["jax"])
    assert mask(tjob["status"], PK["torch"]) == \
        mask(jjob["status"], PK["jax"])
    # The env: each package's own bootstrap contract, the cluster spec
    # byte-equal between them, 8 GPUs a pod and 16 ranks.
    tjobobj = tkube.tpujob_from_k8s(tjob)
    for i, ((_, [tenv]), (_, [jenv])) in enumerate(zip(tbodies, jbodies)):
        want = t_render(tjobobj, "worker", i)
        assert {k: tenv[k] for k in want} == want
        assert tenv["TPUJOB_CLUSTER_SPEC"] == jenv["TPUJOB_CLUSTER_SPEC"]
        assert (tenv["WORLD_SIZE"], tenv["LOCAL_WORLD_SIZE"],
                tenv["GROUP_RANK"]) == ("16", "8", str(i))
        assert tpods[i]["spec"]["containers"][0]["resources"]["limits"] == {
            tconst.RESOURCE_GPU: "8"}


def test_kube_lease_as_jax(fakes):
    leases = {}
    for name, pk in PK.items():
        store = pk.kube.KubeLeaseStore(pk.kube.KubeClient(
            pk.kube.KubeConfig(server=fakes[name].url)))
        a = pk.le.LeaderElector(store, identity="a", name="lease-parity",
                                lease_duration=2.0, renew_deadline=0.5,
                                retry_period=0.1)
        b = pk.le.LeaderElector(store, identity="b", name="lease-parity",
                                lease_duration=2.0, renew_deadline=0.5,
                                retry_period=0.1)
        a.start()
        assert a.wait_until_leading(timeout=5)
        b.start()
        assert not b.wait_until_leading(timeout=0.4)
        held = fakes[name].state.get("leases", "default", "lease-parity")
        a.stop()
        assert b.wait_until_leading(timeout=5)
        b.stop()
        leases[name] = mask(held)
    assert leases["torch"] == leases["jax"]
    assert leases["torch"]["spec"]["holderIdentity"] == "a"


def test_sdk_connect_kube_as_jax(fakes, tmp_path):
    seen = {}
    for name, pk in PK.items():
        path = tmp_path / f"kubeconfig-{name}"
        path.write_text(KUBECONFIG.format(server=fakes[name].url,
                                          namespace="sdk"))
        client = pk.client.connect_kube(str(path))
        job = _slice_job(pk, "sdkjob", workers=1)
        job.metadata.namespace = "sdk"
        created = client.create(job)
        listed = [j.metadata.name for j in client.list()]

        def bump(j):
            j.spec.run_policy.backoff_limit = 7

        patched = client.patch("sdkjob", bump)
        pod = pk.kube.pod_to_k8s(pk.types.Pod.from_dict(dict(
            _pod_dict(pk), metadata={
                "name": "sdkjob-worker-0", "namespace": "sdk",
                "labels": {pk.const.LABEL_JOB_NAME: "sdkjob"}})))
        fakes[name].state.create("pods", "sdk", pod)
        fakes[name].state.set_pod_log("sdk", "sdkjob-worker-0",
                                      "line1\nline2\nline3")
        logs = (client.get_logs("sdkjob-worker-0"),
                client.get_logs("sdkjob-worker-0", tail_lines=1),
                client.get_pod_names("sdkjob"))
        client.delete("sdkjob")
        client.wait_for_delete("sdkjob", timeout=10)
        seen[name] = mask([created.to_dict(), listed, patched.to_dict(),
                           logs, [j.metadata.name for j in client.list()]],
                          pk)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][2]["spec"]["runPolicy"]["backoffLimit"] == 7
    assert seen["torch"][3][1] == "line3"


def test_the_fake_enforces_the_gpu_cluster_role(fakes):
    with open(tfake.DEFAULT_RBAC_PATH) as f:
        roles = [d for d in yaml.safe_load_all(f)
                 if (d or {}).get("kind") == "ClusterRole"]
    assert tfake.DEFAULT_RBAC_PATH.endswith(
        os.path.join("manifests", "gpu", "rbac.yaml"))
    assert roles and fakes["torch"].state.rbac_rules == \
        tfake.load_rbac_rules(tfake.DEFAULT_RBAC_PATH)
    client = tkube.KubeClient(tkube.KubeConfig(server=fakes["torch"].url))
    # Nodes are get/list/watch/patch for the operator: never delete.
    fakes["torch"].state.add_node("rbac-node", chips=1)
    with pytest.raises(Exception) as err:
        client.delete(tstore.NODES, "", "rbac-node")
    assert "403" in str(err.value) or "Forbidden" in str(err.value)


def test_fake_node_reports_gpus_and_nvlink_domain(fakes):
    raw = fakes["torch"].state.add_node("gpu-node", chips=4,
                                        nvlink_domain="nv-1")
    assert raw["status"]["allocatable"] == {tconst.RESOURCE_GPU: "4"}
    assert raw["metadata"]["labels"] == {tconst.LABEL_NVLINK_DOMAIN: "nv-1"}
    node = tkube.node_from_k8s(raw)
    assert (node.spec.chips, node.status.phase) == (4, "Ready")
