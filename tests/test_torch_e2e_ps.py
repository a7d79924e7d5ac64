"""End to end: the port's parameter-server job under the local operator.

The arcs of ``tests/test_ps.py``'s ``test_e2e_ps_job_trains_async`` and
``test_e2e_ps_restart_mid_training_resumes`` with the port's commands:
``ps`` pods run ``python -m tf_operator_tpu_torch.train.ps --lr 0.2
--device cpu`` and workers ``python -m
tf_operator_tpu_torch.train.dist_mnist_ps --device cpu``. The operator
renders the cluster spec, the local backend rewrites it to loopback, the
workers train async against the sharded servers, the job Succeeds and the
ps pods are reaped; a ps shard killed mid-training comes back from its
state file.
"""

import os
import sys
import time

import pytest

from tf_operator_tpu import testutil
from tf_operator_tpu.api import constants
from tf_operator_tpu.api.types import (
    Container,
    JobConditionType,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    TPUJob,
    TPUJobSpec,
)
from tf_operator_tpu.operator import Operator
from tf_operator_tpu.sdk import TPUJobClient

pytestmark = pytest.mark.e2e

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = [sys.executable, "-m", "tf_operator_tpu_torch.train.ps", "--lr", "0.2",
      "--device", "cpu"]
WORKER = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist_ps",
          "--device", "cpu"]


@pytest.fixture
def op():
    operator = Operator.local(workdir=REPO_ROOT)
    operator.start(threadiness=2)
    yield operator
    operator.stop()


def spec(command, n):
    return ReplicaSpec(
        replicas=n,
        template=PodTemplateSpec(spec=PodSpec(containers=[
            Container(name=constants.DEFAULT_CONTAINER_NAME,
                      command=command)])))


def test_port_ps_job_trains_async(op):
    client = TPUJobClient(op.store)
    job = TPUJob(
        metadata=ObjectMeta(name="torch-psmnist"),
        spec=TPUJobSpec(replica_specs={
            "ps": spec(PS, 2),
            "worker": spec(WORKER + ["--steps", "30"], 2),
        }))
    client.create(job)
    job = client.wait_for_job("torch-psmnist", timeout=180)
    logs = client.get_job_logs("torch-psmnist")
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED), logs
    w0 = logs.get("torch-psmnist-worker-0", "")
    assert "ps addrs: 127.0.0.1:" in w0, w0[-500:]
    assert "worker 0 step 29: loss=" in w0, w0[-500:]
    first, last = testutil.parse_ps_worker_log(w0)
    assert last < first, (first, last)
    # ps pods were reaped on completion (CleanPodPolicy Running).
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        pods = client.get_pods("torch-psmnist")
        if not any(p.metadata.name.startswith("torch-psmnist-ps-")
                   and p.status.phase == "Running" for p in pods):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("ps pods still running after success")


def test_port_ps_restart_mid_training_resumes(op, tmp_path):
    """Kill ps shard 0 mid-training: the engine recreates it, the revived
    shard restores its state file, the worker rides its retry loop
    through the gap, and the job still converges."""
    client = TPUJobClient(op.store)
    state_dir = str(tmp_path / "ps-state")
    job = TPUJob(
        metadata=ObjectMeta(name="torch-psrestart"),
        spec=TPUJobSpec(replica_specs={
            "ps": spec(PS + ["--state-dir", state_dir,
                             "--save-interval", "1"], 2),
            "worker": spec(WORKER + ["--steps", "60"], 1),
        }))
    # Keep pods (and their logs) after success: the assertion reads the
    # revived ps shard's log, which CleanPodPolicy would reap.
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)

    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        logs = client.get_job_logs("torch-psrestart")
        if "step 5:" in logs.get("torch-psrestart-worker-0", ""):
            break
        time.sleep(0.2)
    else:
        raise AssertionError("training never reached step 5")
    assert op.store.try_delete(
        "pods", "default", "torch-psrestart-ps-0"), "ps pod not found"

    got = client.wait_for_job("torch-psrestart", timeout=180)
    logs = client.get_job_logs("torch-psrestart")
    assert testutil.check_condition(got, JobConditionType.SUCCEEDED), logs
    first, last = testutil.parse_ps_worker_log(
        logs.get("torch-psrestart-worker-0", ""))
    assert last < first, (first, last)
    ps0 = logs.get("torch-psrestart-ps-0", "")
    assert "restored shard state" in ps0, ps0[-400:]
    assert os.path.exists(os.path.join(state_dir, "ps-shard-0.ckpt"))
