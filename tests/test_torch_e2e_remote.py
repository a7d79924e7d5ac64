"""Three-process e2e of the port's served plane: served operator + node
agent + remote SDK, as ``tests/test_e2e_remote.py`` runs the JAX one.

- process 1: the port's operator (``python -m tf_operator_tpu_torch
  --api-port ... --backend none``) with TLS (self-signed bootstrap) and
  bearer tokens;
- process 2: the port's node agent (``python -m
  tf_operator_tpu_torch.runtime.agent --chips 1``), which claims pods and
  runs them;
- process 3: this test, the SDK user, through ``TPUJobClient.connect``.

The torch.distributed env resolves through the placement records in the
control plane: ``MASTER_ADDR``/``MASTER_PORT`` become rank 0's published
host and coordinator port, and a two-process gloo world meets there.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    Container,
    JobConditionType,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    TPUJob,
    TPUJobSpec,
)
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.apiserver import wait_for_server
from tf_operator_tpu_torch.sdk import TPUJobClient

pytestmark = pytest.mark.e2e

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT_NAME = "torch-e2e-agent"
ADMIN_TOKEN = "torch-e2e-admin"
READ_TOKEN = "torch-e2e-read"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path, n: int = 3000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The port's operator and agent as processes, TLS and tokens on;
    yields (url, ca_file)."""
    tmp = tmp_path_factory.mktemp("torch-remote-e2e")
    port = _free_port()
    url = f"https://127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    tokens_file = tmp / "tokens"
    tokens_file.write_text(f"{ADMIN_TOKEN} admin\n{READ_TOKEN} read-only\n")
    ca_file = str(tmp / "tls" / "cert.pem")
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch",
             "--api-port", str(port), "--backend", "none",
             "--api-tokens-file", str(tokens_file),
             "--api-self-signed-tls-dir", str(tmp / "tls"),
             "--no-leader-elect", "--monitoring-port", "0",
             "--resync-period", "2"],
            env=env, cwd=REPO_ROOT, stdout=open(tmp / "operator.log", "wb"),
            stderr=subprocess.STDOUT))
        try:
            wait_for_server(url, timeout=30, ca_file=ca_file)
        except TimeoutError:
            pytest.fail("the port's operator never answered /healthz: "
                        + _tail(tmp / "operator.log"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.runtime.agent",
             "--server", url, "--name", AGENT_NAME, "--chips", "1",
             "--token-file", str(tokens_file), "--ca-cert", ca_file,
             "--address", "127.0.0.1", "--workdir", REPO_ROOT,
             "--extra-env", json.dumps({"PYTHONPATH": env["PYTHONPATH"]})],
            env=env, cwd=REPO_ROOT, stdout=open(tmp / "agent.log", "wb"),
            stderr=subprocess.STDOUT))
        client = TPUJobClient.connect(url, token=ADMIN_TOKEN, ca_file=ca_file)
        deadline = time.monotonic() + 30
        node = None
        while node is None and time.monotonic() < deadline:
            node = client.store.try_get(store_mod.NODES, "default",
                                        AGENT_NAME)
            time.sleep(0.05)
        assert node is not None, _tail(tmp / "agent.log")
        assert node.spec.chips == 1
        yield url, ca_file
    finally:
        for proc in reversed(procs):
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


@pytest.fixture
def client(cluster):
    url, ca_file = cluster
    c = TPUJobClient.connect(url, token=ADMIN_TOKEN, ca_file=ca_file)
    yield c
    for job in c.list():
        c.delete(job.metadata.name)
        c.wait_for_delete(job.metadata.name, timeout=20)
    c.store.stop_watchers()


def job_of(name, command, replicas=2, rtype="worker", env=None,
           accelerator=""):
    spec = ReplicaSpec(
        replicas=replicas,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=command,
            env=dict(env or {}))])))
    job = TPUJob(metadata=ObjectMeta(name=name),
                 spec=TPUJobSpec(replica_specs={rtype: spec}))
    job.spec.slice.accelerator = accelerator
    job.spec.run_policy.clean_pod_policy = "None"
    return job


def module_cmd(module, *args):
    return [sys.executable, "-m", f"tf_operator_tpu_torch.{module}", *args]


def bootstrap_env(log: str) -> dict:
    text = log.split("bootstrap env:", 1)[1]
    return json.JSONDecoder().raw_decode(text.lstrip())[0]


def test_remote_submit_to_success(client, tmp_path):
    """Create over HTTPS, run on the agent's node, and read back the
    torch env each stub saw: rank 0's published placement."""
    stub_dir = tmp_path / "stub"
    client.create(job_of("served", module_cmd(
        "runtime.worker_stub", "--exit-after", "0.3"),
        env={"TPUJOB_STUB_DIR": str(stub_dir)}))
    got = client.wait_for_job("served", timeout=60)
    assert testutil.check_condition(got, JobConditionType.SUCCEEDED)
    pods = client.get_pods("served")
    assert sorted(p.metadata.name for p in pods) == [
        "served-worker-0", "served-worker-1"]
    assert {(p.spec.node_name, p.status.host) for p in pods} == {
        (AGENT_NAME, "127.0.0.1")}
    w0 = next(p for p in pods if p.metadata.name.endswith("worker-0"))
    port = w0.status.ports["coordinator"]
    for idx in (0, 1):
        snap = json.loads(
            (stub_dir / f"served-worker-{idx}.env.json").read_text())
        assert snap["MASTER_ADDR"] == "127.0.0.1"
        assert snap["MASTER_PORT"] == str(port)
        assert (snap["RANK"], snap["WORLD_SIZE"]) == (str(idx), "2")
        assert not any(k.startswith(("JAX_", "TPU_", "MEGASCALE_"))
                       for k in snap)
    text = client.get_logs("served-worker-0")
    assert "worker stub served-worker-0 started" in text
    tail = client.get_logs("served-worker-0", tail_lines=1)
    assert tail and len(tail.splitlines()) == 1


def test_remote_gpu_smoke_is_stamped_and_resolved(client):
    """The chip phase's job on the host: a 2-pod ``gpu_smoke`` of an
    ``h100-1`` slice; both pods carry ``nvidia.com/gpu: 1`` and print
    rank 0's published rendezvous through the log proxy."""
    job = job_of("smoke", module_cmd("train.gpu_smoke", "--device", "cpu"),
                 accelerator="h100-1")
    # The agent's one card runs the two pods one after the other: the
    # job is done when both are.
    job.spec.success_policy = "AllWorkers"
    client.create(job)
    got = client.wait_for_job("smoke", timeout=60)
    assert testutil.check_condition(got, JobConditionType.SUCCEEDED)
    pods = client.get_pods("smoke")
    w0 = next(p for p in pods if p.metadata.name.endswith("worker-0"))
    logs = client.get_job_logs("smoke")
    assert len(pods) == 2 and sorted(logs) == ["smoke-worker-0",
                                                "smoke-worker-1"]
    for pod in pods:
        assert pod.spec.node_name == AGENT_NAME
        assert pod.spec.containers[0].resources[constants.RESOURCE_GPU] == "1"
        env = bootstrap_env(logs[pod.metadata.name])
        assert env["MASTER_ADDR"] == "127.0.0.1"
        assert env["MASTER_PORT"] == str(w0.status.ports["coordinator"])
        assert "smoke OK on 1 device(s)" in logs[pod.metadata.name]


def test_remote_gloo_rendezvous(client):
    """Two payload processes form one gloo world at the address the
    agent resolved: it only meets if the resolution is live and the
    same for both."""
    client.create(job_of("rdist", module_cmd(
        "train.dist_mnist", "--device", "cpu", "--steps", "2",
        "--batch-size", "16"), env={"TPUJOB_JAX_DISTRIBUTED": "1"}))
    got = client.wait_for_job("rdist", timeout=120)
    logs = client.get_job_logs("rdist")
    assert testutil.check_condition(got, JobConditionType.SUCCEEDED), logs
    assert "distributed: 2 processes" in logs["rdist-worker-0"]
    assert "done:" in logs["rdist-worker-0"]
    assert "done:" in logs["rdist-worker-1"]


def test_remote_ps_job_trains_through_agent(client):
    """The ps topology through the served data plane: the resolver maps
    the cluster spec's ps entry to the ps pod's published placement and
    the worker dials it."""
    ps = job_of("psagent", module_cmd("train.ps", "--lr", "0.2", "--device",
                                      "cpu"), replicas=1, rtype="ps")
    ps.spec.replica_specs["worker"] = job_of(
        "w", module_cmd("train.dist_mnist_ps", "--steps", "15", "--device",
                        "cpu"), replicas=1).spec.replica_specs["worker"]
    client.create(ps)
    got = client.wait_for_job("psagent", timeout=120)
    logs = client.get_job_logs("psagent")
    assert testutil.check_condition(got, JobConditionType.SUCCEEDED), logs
    w0 = logs["psagent-worker-0"]
    first, last = testutil.parse_ps_worker_log(w0)
    assert last < first, (first, last)
    ps_pod = next(p for p in client.get_pods("psagent")
                  if "-ps-" in p.metadata.name)
    dialed = w0.split("ps addrs: ")[1].splitlines()[0].split(",")
    assert dialed == [
        f"{ps_pod.status.host}:{ps_pod.status.ports['coordinator']}"]


def test_remote_follow_job_logs(client, tmp_path):
    """A live follow of both pods through the API server's proxy."""
    client.create(job_of("tailme", module_cmd(
        "runtime.worker_stub", "--exit-after", "1.0"),
        env={"TPUJOB_STUB_DIR": str(tmp_path / "stub")}))
    client.wait_for_condition("tailme", JobConditionType.RUNNING, timeout=30)
    chunks = {}
    for pod_name, chunk in client.follow_job_logs("tailme", timeout=30):
        chunks[pod_name] = chunks.get(pod_name, "") + chunk
    assert sorted(chunks) == ["tailme-worker-0", "tailme-worker-1"]
    for name, text in chunks.items():
        assert f"worker stub {name} started" in text
    client.wait_for_job("tailme", timeout=30)


def test_remote_invalid_spec_fails(client):
    """Validation runs behind the served API: a job with no containers
    goes Failed."""
    client.create(TPUJob(metadata=ObjectMeta(name="badjob"),
                         spec=TPUJobSpec(replica_specs={
                             "worker": ReplicaSpec(
                                 replicas=1, template=PodTemplateSpec())})))
    got = client.wait_for_job("badjob", timeout=30)
    assert testutil.check_condition(got, JobConditionType.FAILED)


def test_remote_auth_enforced(cluster):
    """No token: 401 on reads and writes; the read-only token reads and
    gets 403 on a create."""
    url, ca_file = cluster
    anon = TPUJobClient.connect(url, ca_file=ca_file)
    with pytest.raises(RuntimeError, match="401"):
        anon.store.list(store_mod.TPUJOBS)
    with pytest.raises(RuntimeError, match="401"):
        anon.store.create(store_mod.TPUJOBS,
                          testutil.new_tpujob(worker=1, name="anon"))
    viewer = TPUJobClient.connect(url, token=READ_TOKEN, ca_file=ca_file)
    assert viewer.store.list(store_mod.TPUJOBS) == []
    with pytest.raises(RuntimeError, match="403"):
        viewer.store.create(store_mod.TPUJOBS,
                            testutil.new_tpujob(worker=1, name="ro"))


def test_remote_tls_requires_ca(cluster):
    """A client without the CA bundle fails verification; the dev
    opt-out works."""
    url, _ = cluster
    bad = TPUJobClient.connect(url, token=ADMIN_TOKEN)
    with pytest.raises((OSError, urllib.error.URLError)):
        bad.store.list(store_mod.TPUJOBS)
    skip = TPUJobClient.connect(url, token=ADMIN_TOKEN,
                                insecure_skip_verify=True)
    assert isinstance(skip.store.list(store_mod.TPUJOBS), list)
