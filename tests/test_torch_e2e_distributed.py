"""End to end: the port's MNIST payload, its pipeline-parallel Llama
payload and its BERT payload train as two processes under the local
operator.

The arc of tests/test_e2e_local.py's
``test_distributed_jax_two_process_training`` with ``python -m
tf_operator_tpu_torch.train.dist_mnist --device cpu`` as the pod command:
two worker pods join one ``torch.distributed`` run (gloo) through the
env the operator renders (``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), each drawing its local slice
of the global batch. ``python -m tf_operator_tpu_torch.train.train_llama_pp
--pp 2 --dp 1 --device cpu`` runs the same way, each pod one pipeline
stage, and ``python -m tf_operator_tpu_torch.train.train_bert --size tiny
--device cpu`` with the batch over the two pods (dp=2).
"""

import os
import sys

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


@pytest.fixture
def client():
    op = Operator.local(workdir=REPO_ROOT)
    op.start(threadiness=2)
    yield TPUJobClient(op.store)
    op.stop()


def test_port_payload_two_process_training(client):
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist",
           "--device", "cpu", "--steps", "3", "--batch-size", "16"]
    spec = ReplicaSpec(
        replicas=2,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=cmd,
            env={"TPUJOB_JAX_DISTRIBUTED": "1"})])))
    job = TPUJob(metadata=ObjectMeta(name="torch-distmnist"),
                 spec=TPUJobSpec(replica_specs={"worker": spec}))
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    job = client.wait_for_job("torch-distmnist", timeout=180)
    logs = client.get_job_logs("torch-distmnist")
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED), logs
    assert sorted(logs) == ["torch-distmnist-worker-0",
                            "torch-distmnist-worker-1"]
    # Both processes joined one run; worker 0 logs the training.
    assert "distributed: 2 processes" in logs["torch-distmnist-worker-0"]
    assert "step 2: loss=" in logs["torch-distmnist-worker-0"]
    assert "step 2: loss=" not in logs["torch-distmnist-worker-1"]
    assert "done:" in logs["torch-distmnist-worker-0"]
    assert "done:" in logs["torch-distmnist-worker-1"]


def test_port_pipeline_payload_two_stages(client):
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.train_llama_pp",
           "--device", "cpu", "--pp", "2", "--dp", "1", "--steps", "3",
           "--schedule", "1f1b"]
    spec = ReplicaSpec(
        replicas=2,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=cmd,
            env={"TPUJOB_JAX_DISTRIBUTED": "1"})])))
    job = TPUJob(metadata=ObjectMeta(name="torch-llama-pp"),
                 spec=TPUJobSpec(replica_specs={"worker": spec}))
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    job = client.wait_for_job("torch-llama-pp", timeout=180)
    logs = client.get_job_logs("torch-llama-pp")
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED), logs
    assert sorted(logs) == ["torch-llama-pp-worker-0",
                            "torch-llama-pp-worker-1"]
    # Both stages joined one pipeline and report the same loss.
    for log in logs.values():
        assert "'pp': 2" in log, log
        assert "resolved=1f1b" in log, log
        assert "llama 1f1b pipeline training OK" in log, log
    losses = [[line for line in log.splitlines() if line.startswith("step")]
              for log in logs.values()]
    assert len(losses[0]) == 3 and losses[0] == losses[1], losses


def test_port_bert_payload_two_processes(client):
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.train_bert",
           "--size", "tiny", "--steps", "2", "--device", "cpu"]
    spec = ReplicaSpec(
        replicas=2,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=cmd,
            env={"TPUJOB_JAX_DISTRIBUTED": "1"})])))
    job = TPUJob(metadata=ObjectMeta(name="torch-bert"),
                 spec=TPUJobSpec(replica_specs={"worker": spec}))
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    job = client.wait_for_job("torch-bert", timeout=180)
    logs = client.get_job_logs("torch-bert")
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED), logs
    assert sorted(logs) == ["torch-bert-worker-0", "torch-bert-worker-1"]
    # Both processes joined one dp=2 mesh and report the same global loss.
    for log in logs.values():
        assert "'dp': 2" in log, log
        assert "bert training OK" in log, log
    losses = [[line for line in log.splitlines() if line.startswith("step")]
              for log in logs.values()]
    assert len(losses[0]) == 2 and losses[0] == losses[1], losses
