"""Copy of ``tests/test_e2e_local.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The payload cases run the port's MNIST payload
(``-m tf_operator_tpu_torch.train.dist_mnist --device cpu``). Three
cases that the port's e2e files already run are not copied:
``test_gang_scheduling_capacity_gate``
(``test_torch_e2e_operator.py::test_second_gang_waits_for_the_first``),
``test_restart_resumes_from_checkpoint``
(``test_torch_e2e_resume.py``, ``test_torch_e2e_operator.py::
test_crash_restarts_and_resumes``) and
``test_distributed_jax_two_process_training``
(``test_torch_e2e_distributed.py::test_port_payload_two_process_training``).

The JAX suite's own description follows.

Hermetic end-to-end tests: real controller loop + subprocess data plane.

Reference analog: the Python e2e suites under py/kubeflow/tf_operator/
(simple_tfjob_tests, replica_restart_policy_tests, shutdown_policy_tests,
invalid_tfjob_tests, cleanpod_policy_tests) driven against a live cluster
with the test-server payload; here the whole stack runs in-process with
subprocess pods and the file-based worker stub.
"""

import json
import os
import sys
import threading
import time

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    Container,
    JobConditionType,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    TPUJob,
    TPUJobSpec,
    ObjectMeta,
)
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.sdk import TPUJobClient

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stub_command(*args):
    return [sys.executable, "-m", "tf_operator_tpu_torch.runtime.worker_stub",
            *args]


def stub_job(name, stub_dir, worker=1, args=(), restart_policy="",
             chief=0, accelerator=""):
    def spec(n):
        return ReplicaSpec(
            replicas=n,
            restart_policy=restart_policy,
            template=PodTemplateSpec(spec=PodSpec(containers=[Container(
                name=constants.DEFAULT_CONTAINER_NAME,
                command=stub_command(*args),
                env={"TPUJOB_STUB_DIR": stub_dir},
            )])))

    replica_specs = {"worker": spec(worker)}
    if chief:
        replica_specs["chief"] = spec(chief)
    job = TPUJob(metadata=ObjectMeta(name=name),
                 spec=TPUJobSpec(replica_specs=replica_specs))
    if accelerator:
        job.spec.slice.accelerator = accelerator
    return job


@pytest.fixture
def operator(tmp_path):
    op = Operator.local(workdir=REPO_ROOT)
    op.start(threadiness=2)
    yield op
    op.stop()


@pytest.fixture
def client(operator):
    return TPUJobClient(operator.store)


def tell(stub_dir, pod_name, command):
    os.makedirs(stub_dir, exist_ok=True)
    # Atomic write: the stub polls concurrently.
    tmp = os.path.join(stub_dir, f".{pod_name}.cmd.tmp")
    with open(tmp, "w") as f:
        f.write(command)
    os.replace(tmp, os.path.join(stub_dir, f"{pod_name}.cmd"))


def wait_for(predicate, timeout=15.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


# ---------------------------------------------------------------------------


def test_simple_job_lifecycle(operator, client, tmp_path):
    """simple_tfjob_tests analog: create -> Running -> Succeeded; no
    creation-failure events; bootstrap env visible to every replica."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("smoke", stub_dir, worker=2,
                           args=("--exit-after", "0.5")))
    client.wait_for_condition("smoke", JobConditionType.RUNNING, timeout=10)
    # endpoints exist per replica while the job runs (they may be reaped
    # with their pods once worker-0's completion ends the job)
    wait_for(lambda: sorted(
        e.metadata.name for e in operator.store.list(store_mod.ENDPOINTS)) ==
        ["smoke-worker-0", "smoke-worker-1"], message="both endpoints")
    job = client.wait_for_job("smoke", timeout=15)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    assert not operator.recorder.events_for(reason="FailedCreatePod")

    # env snapshots: both workers saw their identity + full cluster view
    for idx in (0, 1):
        with open(os.path.join(stub_dir, f"smoke-worker-{idx}.env.json")) as f:
            snap = json.load(f)
        assert snap["RANK"] == str(idx)
        assert snap["WORLD_SIZE"] == "2"
        assert snap["MASTER_ADDR"] == "127.0.0.1"
        assert snap["MASTER_PORT"].isdigit()
        cluster = json.loads(snap["TPUJOB_CLUSTER_SPEC"])
        assert cluster["task"] == {"type": "worker", "index": idx}
        assert len(cluster["cluster"]["worker"]) == 2


def test_pod_names_contract(operator, client, tmp_path):
    """pod_names_validation_tests analog: {job}-{type}-{index}."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("names", stub_dir, worker=2, chief=1,
                           args=("--exit-after", "0.4")))
    wait_for(lambda: len(client.get_pod_names("names")) == 3,
             message="3 pods")
    assert client.get_pod_names("names") == [
        "names-chief-0", "names-worker-0", "names-worker-1"]
    assert client.get_pod_names("names", replica_type="chief") == ["names-chief-0"]
    client.wait_for_job("names", timeout=15)


def test_pod_logs_captured(operator, client, tmp_path):
    """get_logs parity: stdout of each replica is retrievable through
    the SDK (reference tf_job_client get_logs, sdk :380-446)."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("logs", stub_dir, worker=2,
                   args=("--exit-after", "0.3"))
    # Retain every pod at completion: under the default cleanPodPolicy
    # (Running) a still-running sibling is deleted when worker-0's exit
    # ends the job, and log retention follows the pod object.
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    client.wait_for_job("logs", timeout=15)
    def banners_present():
        logs = client.get_job_logs("logs")
        return (sorted(logs) == ["logs-worker-0", "logs-worker-1"]
                and all(f"worker stub {name} started" in text
                        for name, text in logs.items()))
    wait_for(banners_present, message="all pod log banners")
    assert client.get_logs("logs-worker-0", tail_lines=1).count("\n") == 0
    assert client.get_logs("logs-worker-0", tail_lines=0) == ""


def test_restart_policy_exit_code_retryable(operator, client, tmp_path):
    """replica_restart_policy_tests analog: retryable exit -> same-identity
    restart (new pod uid, same name), then clean completion."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("restart", stub_dir, worker=2,
                           restart_policy=RestartPolicy.EXIT_CODE))
    client.wait_for_condition("restart", JobConditionType.RUNNING, timeout=10)

    pods = {p.metadata.name: p for p in client.get_pods("restart")}
    old_uid = pods["restart-worker-1"].metadata.uid

    tell(stub_dir, "restart-worker-1", "exit:137")  # SIGKILL-class: retryable

    def restarted():
        for p in client.get_pods("restart"):
            if (p.metadata.name == "restart-worker-1"
                    and p.metadata.uid != old_uid):
                return p
        return None

    wait_for(restarted, message="worker-1 restart with fresh uid")
    job = client.get("restart")
    assert not testutil.get_condition(job, JobConditionType.FAILED)

    # drive both workers to success
    wait_for(lambda: all(p.status.phase == "Running"
                         for p in client.get_pods("restart")),
             message="both running again")
    tell(stub_dir, "restart-worker-0", "exit:0")
    tell(stub_dir, "restart-worker-1", "exit:0")
    job = client.wait_for_job("restart", timeout=15)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)


def test_restart_policy_exit_code_permanent(operator, client, tmp_path):
    """Permanent exit code under ExitCode policy -> job Failed, no restart."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("permfail", stub_dir, worker=1,
                           restart_policy=RestartPolicy.EXIT_CODE))
    client.wait_for_condition("permfail", JobConditionType.RUNNING, timeout=10)
    tell(stub_dir, "permfail-worker-0", "exit:1")
    job = client.wait_for_job("permfail", timeout=15)
    assert testutil.check_condition(job, JobConditionType.FAILED)


def test_shutdown_policy_chief(operator, client, tmp_path):
    """shutdown_policy_tests analog: chief completing ends the job even
    with workers still running; running workers are cleaned up."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("chiefdone", stub_dir, worker=2, chief=1))
    client.wait_for_condition("chiefdone", JobConditionType.RUNNING, timeout=10)
    tell(stub_dir, "chiefdone-chief-0", "exit:0")
    job = client.wait_for_job("chiefdone", timeout=15)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    # CleanPodPolicy default Running: worker pods deleted after finish
    wait_for(lambda: client.get_pod_names("chiefdone", replica_type="worker") == [],
             message="workers cleaned up")


def test_invalid_job_marked_failed(operator, client, tmp_path):
    """invalid_tfjob_tests analog: bad spec -> Failed condition, no pods."""
    job = stub_job("badjob", str(tmp_path), worker=1)
    job.spec.replica_specs["worker"].template.spec.containers[0].name = "oops"
    client.create(job)
    failed = client.wait_for_condition("badjob", JobConditionType.FAILED,
                                       timeout=10)
    assert failed.status.conditions[-1].reason == "InvalidTPUJobSpec"
    assert client.get_pod_names("badjob") == []


def test_scale_down_live_job(operator, client, tmp_path):
    """Dynamic scale-down: replicas 3 -> 1 deletes out-of-range pods."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("scale", stub_dir, worker=3))
    wait_for(lambda: len(client.get_pod_names("scale")) == 3, message="3 pods")

    def shrink(job):
        job.spec.replica_specs["worker"].replicas = 1

    client.patch("scale", shrink)
    wait_for(lambda: client.get_pod_names("scale") == ["scale-worker-0"],
             message="scale down to worker-0")
    # The port's engine deletes every pod and endpoint past replicas and
    # creates none there (the JAX engine can keep a pod at an
    # out-of-range index for good).
    wait_for(lambda: sorted(
        e.metadata.name for e in operator.store.list(store_mod.ENDPOINTS)
        if e.metadata.name.startswith("scale-")) == ["scale-worker-0"],
        message="endpoints past replicas deleted")
    time.sleep(0.5)
    assert client.get_pod_names("scale") == ["scale-worker-0"]
    tell(stub_dir, "scale-worker-0", "exit:0")
    client.wait_for_job("scale", timeout=15)


def test_job_deletion_cascades_to_pods(operator, client, tmp_path):
    """Deleting a TPUJob reaps owned pods (ownerReference GC analog) and
    terminates their processes."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("reap", stub_dir, worker=2))
    client.wait_for_condition("reap", JobConditionType.RUNNING, timeout=10)
    client.delete("reap")
    client.wait_for_delete("reap", timeout=10)
    wait_for(lambda: client.get_pod_names("reap") == [],
             message="owned pods garbage-collected")
    assert operator.store.list(store_mod.ENDPOINTS) == []


def test_sdk_watch_streams_job_events(operator, client, tmp_path):
    """TFJobWatch analog: the watch generator streams the job's
    lifecycle and terminates on the terminal condition."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("watched", stub_dir, worker=1,
                           args=("--exit-after", "0.3")))
    seen = [job for _, job in client.watch("watched", timeout=15,
                                           until_finished=True)]
    assert seen, "watch yielded no events"
    assert testutil.check_condition(seen[-1], JobConditionType.SUCCEEDED)
    # lifecycle progressed: some earlier event lacked the terminal state
    assert any(not testutil.check_condition(j, JobConditionType.SUCCEEDED)
               for j in seen[:-1]) or len(seen) == 1


def test_sdk_watch_terminates_on_deletion(operator, client, tmp_path):
    """A watched job deleted mid-run is terminal for until_finished —
    no further events will ever arrive for it."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("shortlived", stub_dir, worker=1,
                           args=("--exit-after", "30")))
    client.wait_for_condition("shortlived", JobConditionType.RUNNING,
                              timeout=10)

    def delete_soon():
        time.sleep(0.3)
        client.delete("shortlived")

    t = threading.Thread(target=delete_soon)
    t.start()
    events = list(client.watch("shortlived", timeout=10,
                               until_finished=True))
    t.join()
    assert events and events[-1][0] == store_mod.DELETED


def test_runconfig_golden_full_topology(operator, client, tmp_path):
    """estimator_runconfig_tests analog: every replica's effective
    bootstrap config (cluster spec, task identity, rank, coordinator)
    matches expectations built from the naming contract."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("golden", stub_dir, worker=2, chief=1,
                   args=("--exit-after", "0.5"))
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    client.wait_for_job("golden", timeout=15)

    def snap(rtype, idx):
        with open(os.path.join(stub_dir,
                               f"golden-{rtype}-{idx}.env.json")) as f:
            return json.load(f)

    expected_hosts = {
        "chief": ["golden-chief-0.default.svc"],
        "worker": ["golden-worker-0.default.svc",
                   "golden-worker-1.default.svc"],
    }
    # chief is process 0; workers follow (bootstrap/cluster.py ranks)
    expected_rank = {("chief", 0): 0, ("worker", 0): 1, ("worker", 1): 2}
    for (rtype, idx), rank in expected_rank.items():
        env = snap(rtype, idx)
        spec = json.loads(env["TPUJOB_CLUSTER_SPEC"])
        assert spec["task"] == {"type": rtype, "index": idx}
        got_hosts = {t: [h.rsplit(":", 1)[0] for h in hosts]
                     for t, hosts in spec["cluster"].items()}
        assert got_hosts == expected_hosts
        assert env["RANK"] == str(rank)
        assert env["WORLD_SIZE"] == "3"
        # the master is the chief's replica-0 DNS name for every replica
        assert env["MASTER_ADDR"] == "127.0.0.1"  # localized by the backend


def test_cleanpod_policy_all_removes_pods_e2e(operator, client, tmp_path):
    """cleanpod_policy_tests analog (All): completion deletes every pod
    and endpoint."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("cleanall", stub_dir, worker=2,
                   args=("--exit-after", "0.3"))
    job.spec.run_policy.clean_pod_policy = "All"
    client.create(job)
    client.wait_for_job("cleanall", timeout=15)
    wait_for(lambda: client.get_pod_names("cleanall") == [],
             message="pods cleaned")
    wait_for(lambda: not [
        e for e in operator.store.list(store_mod.ENDPOINTS)
        if e.metadata.name.startswith("cleanall-")],
        message="endpoints cleaned")


def test_elastic_worker_sparse_cluster_spec_e2e(operator, client, tmp_path):
    """Dynamic-worker analog (enableDynamicWorker sparse TF_CONFIG,
    reference tensorflow.go:64-83): each elastic worker sees only
    itself in the cluster view."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("elastic", stub_dir, worker=2,
                   args=("--exit-after", "0.5"))
    job.spec.enable_elastic_worker = True
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    client.wait_for_job("elastic", timeout=15)
    for idx in (0, 1):
        with open(os.path.join(stub_dir,
                               f"elastic-worker-{idx}.env.json")) as f:
            env = json.load(f)
        spec = json.loads(env["TPUJOB_CLUSTER_SPEC"])
        workers = spec["cluster"]["worker"]
        assert len(workers) == 1, workers  # sparse: only itself
        assert f"elastic-worker-{idx}." in workers[0]
        assert spec["task"] == {"type": "worker", "index": idx}


def test_sparse_elastic_resize_does_not_restart_workers(operator, client,
                                                        tmp_path):
    """Reference enableDynamicWorker semantics: in sparse-elastic mode
    a worker resize must NOT restart the running workers (their sparse
    world never embedded the peers), unlike the dense-mode world
    restart. Pins the digest's resize-stability for sparse workers."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("spel", stub_dir, worker=2)
    job.spec.enable_elastic_worker = True
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    client.wait_for_condition("spel", JobConditionType.RUNNING, timeout=10)
    uids_before = {p.metadata.name: p.metadata.uid
                   for p in client.get_pods("spel")}

    def grow(j):
        j.spec.replica_specs["worker"].replicas = 3

    client.patch("spel", grow)
    wait_for(lambda: len(client.get_pod_names("spel")) == 3,
             message="scaled to 3")
    time.sleep(0.5)  # give any (wrong) restart a chance to happen
    after = {p.metadata.name: p.metadata.uid
             for p in client.get_pods("spel")}
    for name, uid in uids_before.items():
        assert after.get(name) == uid, \
            f"sparse-elastic worker {name} was restarted on resize"
    assert not operator.recorder.events_for(reason="WorldResized")
    for i in range(3):
        tell(stub_dir, f"spel-worker-{i}", "exit:0")
    client.wait_for_job("spel", timeout=15)





def test_shutdown_policy_worker0_chiefless(operator, client, tmp_path):
    """shutdown_policy_tests analog, chiefless half: with no chief,
    worker-0's completion decides job success (reference status.go
    worker-0 semantics) while siblings still run; they are then reaped
    under the default CleanPodPolicy (Running)."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("w0done", stub_dir, worker=3))
    client.wait_for_condition("w0done", JobConditionType.RUNNING, timeout=10)
    tell(stub_dir, "w0done-worker-0", "exit:0")
    job = client.wait_for_job("w0done", timeout=15)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    # CleanPodPolicy Running deletes the still-running siblings but keeps
    # the completed worker-0 pod (finished pods survive for log retrieval).
    wait_for(lambda: client.get_pod_names("w0done") == ["w0done-worker-0"],
             message="running siblings cleaned up")


def test_concurrent_jobs_no_duplicate_creates(operator, client, tmp_path):
    """Stress the expectations/workqueue machinery (the reference's
    subtlest code, SURVEY §7 hard part (a)): many jobs reconciled
    concurrently must create exactly one pod per replica index — a sync
    racing a stale cache would double-create without the in-flight
    expectations gate."""
    from tf_operator_tpu_torch.runtime import metrics

    jobs, workers = 6, 3
    before = metrics.created_pods.value(job_namespace="default")
    stub_dir = str(tmp_path / "stub")
    for i in range(jobs):
        client.create(stub_job(f"burst-{i}", stub_dir, worker=workers,
                               args=("--exit-after", "0.2")))
    for i in range(jobs):
        job = client.wait_for_job(f"burst-{i}", timeout=30)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    after = metrics.created_pods.value(job_namespace="default")
    assert after - before == jobs * workers, \
        f"expected {jobs * workers} creates, saw {after - before}"
    assert not operator.recorder.events_for(reason="FailedCreatePod")


def test_sdk_events_visible(operator, client, tmp_path):
    """Events persist to the store and are readable through the SDK
    (reference get_creation_failures_from_tfjob scans K8s Events)."""
    stub_dir = str(tmp_path / "stub")
    client.create(stub_job("events", stub_dir, worker=1,
                           args=("--exit-after", "0.2")))
    client.wait_for_job("events", timeout=15)
    reasons = {e.reason for e in client.get_events("events")}
    assert "SuccessfulCreatePod" in reasons or "Created" in reasons, reasons
    assert client.get_creation_failures("events") == []


def test_scale_up_live_job_elastic_env(operator, client, tmp_path):
    """Dynamic scale-up on a running elastic job: new indices appear and
    the new pod's sparse cluster spec names only itself (+ ps), the
    enableDynamicWorker contract (reference tensorflow.go:64-83)."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("grow", stub_dir, worker=1)
    job.spec.enable_elastic_worker = True
    client.create(job)
    wait_for(lambda: len(client.get_pod_names("grow")) == 1, message="1 pod")

    client.patch("grow", lambda j: setattr(
        j.spec.replica_specs["worker"], "replicas", 3))
    wait_for(lambda: len(client.get_pod_names("grow")) == 3,
             message="scale up to 3 pods")

    def snap_exists():
        path = os.path.join(stub_dir, "grow-worker-2.env.json")
        return os.path.exists(path) and path
    path = wait_for(snap_exists, message="worker-2 env snapshot")
    with open(path) as f:
        snap = json.load(f)
    cluster = json.loads(snap["TPUJOB_CLUSTER_SPEC"])
    # sparse: the worker entry carries only this replica's own address
    assert len(cluster["cluster"]["worker"]) == 1
    assert cluster["task"] == {"type": "worker", "index": 2}

    for i in range(3):
        tell(stub_dir, f"grow-worker-{i}", "exit:0")
    job = client.wait_for_job("grow", timeout=15)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)


def test_leader_failover_completes_job(tmp_path):
    """Operator HA e2e: two control-plane instances share one store with
    leader election (reference server.go:168-193 — exactly one of N
    replicas reconciles); pods run on a separate backend (the kubelet
    analog). When the leader dies without releasing its lease, the
    standby takes over after expiry and drives a new job to completion."""
    from tf_operator_tpu_torch.runtime.leaderelection import LeaderElector
    from tf_operator_tpu_torch.runtime.local import LocalProcessBackend

    store = store_mod.Store()
    backend = LocalProcessBackend(
        store=store, workdir=REPO_ROOT,
        extra_env={"PYTHONPATH": REPO_ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", "")})
    backend.start()
    ops = [Operator(store=store, backend=None) for _ in range(2)]
    electors = []
    for i, op in enumerate(ops):
        electors.append(LeaderElector(
            store, identity=f"op-{i}", lease_duration=4.0,
            renew_deadline=1.0, retry_period=0.2,
            on_started_leading=lambda op=op: op.controller.run(
                threadiness=2)))
    client = TPUJobClient(store)
    stub_dir = str(tmp_path / "stub")
    try:
        electors[0].start()
        assert electors[0].wait_until_leading(timeout=5)
        electors[1].start()
        client.create(stub_job("ha-1", stub_dir, worker=1,
                               args=("--exit-after", "0.2")))
        job = client.wait_for_job("ha-1", timeout=15)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
        assert not electors[1].is_leader

        # Crash the leader (no release): stop its controller + thread.
        electors[0]._stop.set()
        electors[0]._thread.join(timeout=2)
        ops[0].controller.stop()

        wait_for(lambda: electors[1].is_leader, timeout=10,
                 message="standby acquires the lease")
        client.create(stub_job("ha-2", stub_dir, worker=1,
                               args=("--exit-after", "0.2")))
        job = client.wait_for_job("ha-2", timeout=15)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    finally:
        # The port's order: controllers stop before their leases go.
        for op in ops:
            op.controller.stop()
        for e in electors:
            e.stop()
        backend.stop()
        store.stop_watchers()


def test_backoff_limit_exhaustion_fails_job_e2e(operator, client, tmp_path):
    """backoffLimit at the e2e level: an OnFailure replica crash-looping
    in place accumulates container restart counts until the limit, then
    the job fails (reference PastBackoffLimit, job.go:359-396 — only
    kubelet-restarted policies count toward the limit)."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("backoff", stub_dir, worker=1,
                   restart_policy=RestartPolicy.ON_FAILURE,
                   args=("--exit-after", "0.15", "--exit-code", "1"))
    job.spec.run_policy.backoff_limit = 2
    client.create(job)
    job = client.wait_for_job("backoff", timeout=30)
    assert testutil.check_condition(job, JobConditionType.FAILED)
    cond_failed = testutil.get_condition(job, JobConditionType.FAILED)
    assert "backoff" in (cond_failed.message or "").lower() or \
           "backoff" in (cond_failed.reason or "").lower()


def test_active_deadline_fails_running_job_e2e(operator, client, tmp_path):
    """activeDeadlineSeconds at the e2e level: a healthy but slow job is
    failed once the deadline passes and its pods are torn down."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("deadline", stub_dir, worker=1)  # runs until told
    job.spec.run_policy.active_deadline_seconds = 1
    client.create(job)
    job = client.wait_for_job("deadline", timeout=30)
    assert testutil.check_condition(job, JobConditionType.FAILED)
    wait_for(lambda: client.get_pod_names("deadline") == [],
             message="pods torn down after deadline")


def test_gang_multislice_capacity_accounting(tmp_path):
    """Multislice gangs claim num_slices x slice chips: a 2-slice h100-8
    job (16 chips) fills a 16-chip pool, gating a single-slice job until
    the multislice gang completes."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=16)
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        multi = stub_job("ms-a", stub_dir, worker=2, accelerator="h100-8")
        multi.spec.slice.num_slices = 2
        client.create(multi)
        client.wait_for_condition("ms-a", JobConditionType.RUNNING,
                                  timeout=10)
        client.create(stub_job("ms-b", stub_dir, worker=1,
                               accelerator="h100-8",
                               args=("--exit-after", "0.3")))
        time.sleep(0.6)
        pods_b = client.get_pods("ms-b")
        assert pods_b and all(p.status.phase == "Pending" for p in pods_b), \
            "ms-b must wait while the multislice gang holds all 16 chips"
        for i in range(2):
            tell(stub_dir, f"ms-a-worker-{i}", "exit:0")
        client.wait_for_job("ms-a", timeout=15)
        job_b = client.wait_for_job("ms-b", timeout=15)
        assert testutil.check_condition(job_b, JobConditionType.SUCCEEDED)
    finally:
        op.stop()


def test_ps_job_schedules_without_warning(operator, client, tmp_path):
    """ps is a REAL role now (tf_operator_tpu_torch.train.ps serves sharded
    async params — round-3 verdict missing-item #1 resolved by
    implementation, not deprecation): scheduling one must NOT surface
    the old no-runtime ValidationWarning. Full training coverage lives
    in tests/test_ps.py::test_e2e_ps_job_trains_async."""
    stub_dir = str(tmp_path / "stub")
    job = stub_job("ps-ok", stub_dir, worker=1)
    job.spec.replica_specs["ps"] = ReplicaSpec(
        replicas=1,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME,
            command=stub_command("--exit-after", "0.2"),
            env={"TPUJOB_STUB_DIR": stub_dir})])))
    client.create(job)
    tell(stub_dir, "ps-ok-worker-0", "exit:0")
    client.wait_for_job("ps-ok", timeout=15)
    warnings = operator.recorder.events_for(reason="ValidationWarning")
    assert not any("parameter-server" in ev.message for ev in warnings)


def test_elastic_resize_resumes_training(operator, client, tmp_path):
    """Elastic resize with REAL training (round-3 verdict ask #7): a
    2-worker jax.distributed job is scaled to 4 mid-training; the
    bootstrap-hash world restart recreates every worker with the
    4-process env, training resumes from the latest orbax checkpoint
    (not step 0), and the global batch is re-sharded across the new
    world. Reference surface: enableDynamicWorker (types.go:66-67,
    tensorflow.go:64-83) — but for the sync SPMD path, where a resize
    necessarily restarts the world."""
    ckpt_dir = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist",
           "--steps", "60", "--batch-size", "32",
           "--checkpoint-dir", ckpt_dir, "--device", "cpu"]
    spec = ReplicaSpec(
        replicas=2, restart_policy=RestartPolicy.ON_FAILURE,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=cmd,
            env={"TPUJOB_JAX_DISTRIBUTED": "1"})])))
    job = TPUJob(metadata=ObjectMeta(name="resize"),
                 spec=TPUJobSpec(replica_specs={"worker": spec}))
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)

    # Resize only once real training progress is durably checkpointed.
    def checkpointed():
        try:
            return any(p.is_dir() and p.name.isdigit()
                       for p in __import__("pathlib").Path(ckpt_dir)
                       .iterdir())
        except OSError:
            return False

    wait_for(checkpointed, timeout=120,
             message="first checkpoint from the 2-worker world")

    def grow(j):
        j.spec.replica_specs["worker"].replicas = 4

    client.patch("resize", grow)
    wait_for(lambda: len(client.get_pod_names("resize")) == 4,
             timeout=30, message="4 worker pods after resize")

    job = client.wait_for_job("resize", timeout=300)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    logs = client.get_job_logs("resize")
    w0 = logs["resize-worker-0"]
    # The post-resize incarnation joined a 4-process world and resumed
    # from the checkpoint instead of step 0.
    assert "distributed: 4 processes" in w0, w0[-800:]
    assert "resumed from checkpoint at step" in w0, w0[-800:]
    assert "done:" in w0
    # World-restart surfaced as an event, not silence.
    evs = operator.recorder.events_for(reason="WorldResized")
    assert evs, "no WorldResized event recorded"


def test_gang_aged_fairness_admits_large_job_under_churn(tmp_path):
    """Round-2 verdict item #9: a large job behind a stream of small
    jobs must eventually admit. With aged fairness (tiny aging window
    here), the starved large group blocks backfill, capacity drains,
    and the large job runs."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=16, gang_fairness="aged",
                        gang_aging_seconds=0.5)
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        # Two small jobs hold the whole 16-chip budget.
        client.create(stub_job("small-0", stub_dir, worker=1,
                               accelerator="h100-8"))
        client.create(stub_job("small-1", stub_dir, worker=1,
                               accelerator="h100-8"))
        for name in ("small-0", "small-1"):
            client.wait_for_condition(name, JobConditionType.RUNNING,
                                      timeout=10)
        # The big job wants the entire budget: cannot backfill.
        client.create(stub_job("big", stub_dir, worker=2,
                               accelerator="h100-16",
                               args=("--exit-after", "0.3")))
        # Aging is measured from the scheduler first SEEING the group
        # unadmittable, so anchor on the group's existence (the
        # controller may sync the job a beat after create).
        wait_for(lambda: op.store.try_get(store_mod.SLICEGROUPS,
                                          "default", "big") is not None,
                 message="big slice group")
        time.sleep(0.7)  # > aging window: big is now head-of-line
        pods_big = client.get_pods("big")
        assert pods_big and all(p.status.phase == "Pending"
                                for p in pods_big)
        # Churn: more small jobs arrive — they must NOT be admitted past
        # the aged big job even as capacity frees.
        client.create(stub_job("small-2", stub_dir, worker=1,
                               accelerator="h100-8",
                               args=("--exit-after", "0.3")))
        tell(stub_dir, "small-0-worker-0", "exit:0")
        client.wait_for_job("small-0", timeout=15)
        time.sleep(0.5)
        pods_s2 = client.get_pods("small-2")
        assert pods_s2 and all(p.status.phase == "Pending"
                               for p in pods_s2), \
            "small-2 must not backfill past the aged big job"
        # Freeing the rest admits big; when big finishes, small-2 runs.
        tell(stub_dir, "small-1-worker-0", "exit:0")
        client.wait_for_job("small-1", timeout=15)
        job_big = client.wait_for_job("big", timeout=20)
        assert testutil.check_condition(job_big, JobConditionType.SUCCEEDED)
        job_s2 = client.wait_for_job("small-2", timeout=20)
        assert testutil.check_condition(job_s2, JobConditionType.SUCCEEDED)
    finally:
        op.stop()


def test_gang_strict_head_of_line_blocks_backfill(tmp_path):
    """strict fairness: nothing admits behind a non-fitting head."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=16, gang_fairness="strict")
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        client.create(stub_job("holder", stub_dir, worker=1,
                               accelerator="h100-8"))
        client.wait_for_condition("holder", JobConditionType.RUNNING,
                                  timeout=10)
        # Head of queue: needs 16 chips, only 8 free. Wait for its
        # SliceGroup to exist before submitting the next job — FIFO
        # order is group-creation order, and group creation rides the
        # controller sync, not job submission.
        client.create(stub_job("head", stub_dir, worker=2,
                               accelerator="h100-16"))
        wait_for(lambda: op.store.try_get(store_mod.SLICEGROUPS,
                                          "default", "head") is not None,
                 message="head slice group")
        # Would fit (8 chips free) but must not jump the queue.
        client.create(stub_job("jumper", stub_dir, worker=1,
                               accelerator="h100-8"))
        # Wait for the pods to EXIST (creation can lag under load),
        # then give admission a settle window before asserting gating.
        wait_for(lambda: client.get_pods("head")
                 and client.get_pods("jumper"), message="gated pods exist")
        time.sleep(0.8)
        for name in ("head", "jumper"):
            pods = client.get_pods(name)
            assert pods and all(p.status.phase == "Pending" for p in pods), \
                f"{name} must stay Pending under strict head-of-line"
    finally:
        op.stop()


def test_gang_infeasible_group_does_not_block_queue(tmp_path):
    """A request larger than the whole cluster can never be satisfied;
    under aged/strict fairness it must not deadlock later jobs."""
    op = Operator.local(workdir=REPO_ROOT, enable_gang_scheduling=True,
                        total_chips=8, gang_fairness="aged",
                        gang_aging_seconds=0.1)
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        stub_dir = str(tmp_path / "stub")
        # Infeasible: wants 16 chips on an 8-chip cluster.
        client.create(stub_job("toobig", stub_dir, worker=2,
                               accelerator="h100-16"))
        time.sleep(0.4)  # > aging window
        client.create(stub_job("fits", stub_dir, worker=1,
                               accelerator="h100-8",
                               args=("--exit-after", "0.3")))
        job = client.wait_for_job("fits", timeout=15)
        assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
        pods_toobig = client.get_pods("toobig")
        assert pods_toobig and all(p.status.phase == "Pending"
                                   for p in pods_toobig)
    finally:
        op.stop()

# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.e2e
