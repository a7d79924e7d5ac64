"""End to end: the port's MNIST payload restarts and resumes under the
local operator.

The arc of tests/test_e2e_local.py's ``test_restart_resumes_from_checkpoint``
with ``python -m tf_operator_tpu_torch.train.dist_mnist --device cpu`` as
the pod command: a retryable crash (exit 137) at step 3 under the ExitCode
restart policy restarts the replica at the same index, and the fresh pod
resumes from the port's checkpoint at step 3 instead of step 0.
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
    RestartPolicy,
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


def test_port_payload_restart_resumes_from_checkpoint(client, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist",
           "--device", "cpu", "--steps", "6", "--batch-size", "16",
           "--checkpoint-dir", ckpt_dir, "--crash-at-step", "3"]
    spec = ReplicaSpec(
        replicas=1, restart_policy=RestartPolicy.EXIT_CODE,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=cmd)])))
    job = TPUJob(metadata=ObjectMeta(name="torch-resume"),
                 spec=TPUJobSpec(replica_specs={"worker": spec}))
    job.spec.run_policy.clean_pod_policy = "None"
    client.create(job)
    job = client.wait_for_job("torch-resume", timeout=180)
    assert testutil.check_condition(job, JobConditionType.SUCCEEDED)
    text = client.get_job_logs("torch-resume")["torch-resume-worker-0"]
    assert "injected crash at step 3" not in text  # fresh pod's log only
    assert "resumed from checkpoint at step 3" in text
    assert "done:" in text
    assert sorted(os.listdir(ckpt_dir)) == ["4", "5", "6"]
