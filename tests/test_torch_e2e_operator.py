"""End to end: the port's own operator runs the port's payloads on the CPU.

``Operator.local`` of ``tf_operator_tpu_torch`` (the GPU controller and
the local pod backend) runs, as subprocess pods with ``--device cpu``:
the smoke payload as two workers, checked as ``chip_smoke.py``'s
``operator`` phase checks it on the card (one ``nvidia.com/gpu`` and its
toleration a pod, a two-process world at one loopback rendezvous, no key
of the TPU contract); the MNIST payload as two processes joined by gloo
through ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``
alone; and the MNIST crash-and-resume arc under the ``ExitCode`` restart
policy. The loopback resolver gives every pod of a job one rendezvous
port and each job its own.

One process a GPU: two pods requesting ``nvidia.com/gpu: 2`` run the
MNIST payload as four gloo ranks (each pod's local launch starting two),
trained as one process over the global batch is; the launch gives its
processes their ranks and the relay files and stops them all at the
first failure; on a node of 8 cards (``Operator.local(chips=8)``) pods
get disjoint ``CUDA_VISIBLE_DEVICES`` and a card is reused only after its
pod exits.

With every plane on (gang scheduling, slice health, checkpoint
coordination, serving), the same operator runs the three arcs of
``chip_smoke.py``'s ``operator_planes`` phase and of the JAX package's
e2e tests: a training gang of the port's ``worker_stub`` drained off a
maintenance node resumes at its barrier step
(``tests/test_ckpt_coordination.py``); a serving gang of the ``fake``
runner drained mid-traffic answers every request exactly once
(``tests/test_serving.py``); and of two ``h100-8`` jobs on an 8-GPU
budget the second waits for the first.
"""

import os
import sys

import pytest

import chip_smoke
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    Container,
    HealthPolicy,
    JobConditionType,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodSpec,
)
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime.local import LoopbackEnvResolver
from tf_operator_tpu_torch.sdk import TPUJobClient

pytestmark = pytest.mark.e2e

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def operator():
    op = Operator.local(workdir=REPO_ROOT)
    op.start(threadiness=2)
    yield op, TPUJobClient(op.store)
    op.stop()


def cpu_job(name, module, *args, replicas=1, restart_policy="", env=None):
    job = chip_smoke.operator_job(
        name, [sys.executable, "-m", module, *args, "--device", "cpu"],
        replicas=replicas, restart_policy=restart_policy)
    job.spec.replica_specs["worker"].template.spec.containers[0].env.update(
        env or {})
    return job


def test_smoke_pods_get_the_gpu_contract(operator):
    op, client = operator
    logs, restarts = chip_smoke.run_operator_job(
        op, client, cpu_job("gpu-smoke", "tf_operator_tpu_torch.train."
                            "gpu_smoke", replicas=2), card="cpu")
    assert restarts == 0
    chip_smoke.check_smoke_pods(client, logs, "cpu")


def test_two_processes_join_from_the_torch_env_alone(operator):
    op, client = operator
    logs, _ = chip_smoke.run_operator_job(op, client, cpu_job(
        "torch-world", "tf_operator_tpu_torch.train.dist_mnist", "--steps",
        "3", "--batch-size", "16", replicas=2,
        env={"TPUJOB_JAX_DISTRIBUTED": "1"}), card="cpu")
    for pod in client.get_pods("torch-world"):
        env = pod.spec.containers[0].env
        assert not [k for k in env if k.startswith(("JAX_", "TPU_"))]
        assert {"MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"} <= set(
            env)
    assert "distributed: 2 processes" in logs["torch-world-worker-0"]
    assert "step 2: loss=" in logs["torch-world-worker-0"]
    assert "step 2: loss=" not in logs["torch-world-worker-1"]
    assert all("done:" in log for log in logs.values())


def test_crash_restarts_and_resumes(operator, tmp_path):
    op, client = operator
    logs, restarts = chip_smoke.run_operator_job(op, client, cpu_job(
        "torch-resume", "tf_operator_tpu_torch.train.dist_mnist", "--steps",
        "6", "--batch-size", "16", "--checkpoint-dir", str(tmp_path),
        "--crash-at-step", "3", restart_policy="ExitCode"), card="cpu")
    log = logs["torch-resume-worker-0"]
    assert restarts == 1
    assert "injected crash at step 3" not in log  # the new pod's log only
    assert "resumed from checkpoint at step 3" in log
    assert sorted(os.listdir(tmp_path)) == ["4", "5", "6"]


def test_pods_see_the_cards_the_operator_sees(operator, monkeypatch):
    """CUDA_VISIBLE_DEVICES reaches a pod as the device plugin would set
    it; the rest of the host env stays out."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    monkeypatch.setenv("TPUJOB_TEST_HOST_ONLY", "1")
    op, client = operator
    job = chip_smoke.operator_job("env-probe", [
        sys.executable, "-c", "import os; print(os.environ.get("
        "'CUDA_VISIBLE_DEVICES'), os.environ.get('TPUJOB_TEST_HOST_ONLY'))"])
    logs, _ = chip_smoke.run_operator_job(op, client, job, card="cpu")
    assert logs["env-probe-worker-0"].split() == ["3", "None"]


MNIST_TOL = 1e-5      # tests/test_torch_distributed.py's MNIST parity
MNIST_STEPS = 2
MNIST_BATCH = 16


def test_two_pods_of_two_gpus_train_as_four_ranks(operator, tmp_path):
    """Two pods requesting ``nvidia.com/gpu: 2`` each run two processes
    (the payload's local launch), one gloo world of 4 ranks: every rank
    logs, and the trained parameters and rank 0's losses are those of
    one process stepping over the global batch."""
    import numpy as np
    import torch

    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.train import trainer as ttr
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer
    from tf_operator_tpu_torch.train.dist_mnist import local_shard

    op, client = operator
    job = cpu_job("four-ranks", "tf_operator_tpu_torch.train.dist_mnist",
                  "--steps", str(MNIST_STEPS), "--batch-size",
                  str(MNIST_BATCH), "--checkpoint-dir", str(tmp_path),
                  replicas=2, env={"TPUJOB_JAX_DISTRIBUTED": "1"})
    job.spec.slice.accelerator = ""
    job.spec.replica_specs["worker"].template.spec.containers[
        0].resources["nvidia.com/gpu"] = "2"
    logs, restarts = chip_smoke.run_operator_job(op, client, job, "cpu")
    assert restarts == 0
    for pod in client.get_pods("four-ranks"):
        env = pod.spec.containers[0].env
        assert (env["WORLD_SIZE"], env["LOCAL_WORLD_SIZE"],
                env["GROUP_WORLD_SIZE"]) == ("4", "2", "2")
        assert "RANK" not in env and "LOCAL_RANK" not in env
    text = "".join(logs.values())
    assert text.count("distributed: 4 processes") == 4
    assert text.count("done: loss") == 4
    assert [line for line in logs["four-ranks-worker-1"].splitlines()
            if line.startswith("step")] == []

    model = MnistCNN(device="cpu")
    trainer = ttr.Trainer(model=model, optimizer=ttr.adam(1e-3),
                          loss_fn=ttr.classification_loss, device="cpu")
    state, step = trainer.init(), trainer.make_train_step()
    losses = []
    for i in range(MNIST_STEPS):
        shards = [local_shard(i + 1, 4, r, MNIST_BATCH) for r in range(4)]
        state, metrics = step(state, {k: torch.cat([s[k] for s in shards])
                                      for k in shards[0]})
        losses.append(float(metrics["loss"]))
    printed = [float(line.split("loss=")[1]) for line in
               logs["four-ranks-worker-0"].splitlines()
               if line.startswith("step")]
    # The payload prints 4 decimals.
    np.testing.assert_allclose(printed, losses[::5][:len(printed)] + (
        [losses[-1]] if (MNIST_STEPS - 1) % 5 else []), atol=5e-5 + MNIST_TOL)
    saved = MnistCNN(device="meta")
    restored = Checkpointer(str(tmp_path)).restore(ttr.Trainer(
        model=saved, optimizer=ttr.adam(1e-3),
        loss_fn=ttr.classification_loss, device="cpu").abstract_state())
    assert restored.step == MNIST_STEPS
    for (name, got), (_, want) in zip(saved.named_parameters(),
                                      model.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), atol=MNIST_TOL,
                                   rtol=0, err_msg=name)


LAUNCH_PROBE = """
import os, signal, sys, time
out = os.path.join(sys.argv[1], os.environ["LOCAL_RANK"])
with open(out, "w") as f:
    f.write(" ".join(os.environ.get(k, "-") for k in (
        "RANK", "WORLD_SIZE", "TPUJOB_CKPT_FILE", "TPUJOB_PREEMPT_FILE")))
if os.environ["LOCAL_RANK"] == "1":
    time.sleep(0.3)
    sys.exit(3)
signal.signal(signal.SIGTERM, lambda *_: (open(out + ".term", "w").close(),
                                          sys.exit(143)))
time.sleep(30)
"""


def test_local_launch_ranks_relay_and_first_failure(tmp_path, monkeypatch):
    """A pod of three local processes: RANK from the pod's place, the
    checkpoint relay file for local rank 0 alone, the notice file for
    all; local rank 1 exits 3, so the launch stops the others (SIGTERM)
    and exits 3, well inside the grace period."""
    import time

    from tf_operator_tpu_torch.parallel.distributed import (
        launch_local_processes,
    )

    (tmp_path / "launch_probe.py").write_text(LAUNCH_PROBE)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    for key, value in {"WORLD_SIZE": "7", "LOCAL_WORLD_SIZE": "3",
                       "GROUP_RANK": "2", "GROUP_WORLD_SIZE": "3",
                       "TPUJOB_CKPT_FILE": "ckpt.json",
                       "TPUJOB_PREEMPT_FILE": "notice"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    started = time.monotonic()
    assert launch_local_processes("launch_probe", [str(tmp_path)]) == 3
    assert time.monotonic() - started < 10
    seen = {i: (tmp_path / str(i)).read_text().split() for i in range(3)}
    assert seen == {0: ["4", "7", "ckpt.json", "notice"],
                    1: ["5", "7", "-", "notice"],
                    2: ["6", "7", "-", "notice"]}
    assert (tmp_path / "0.term").exists() and (tmp_path / "2.term").exists()
    # One process a pod: nothing to launch, the caller is that process.
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert launch_local_processes("launch_probe", [str(tmp_path)]) is None


def test_pods_on_one_node_get_disjoint_cards(tmp_path):
    """On a node of 8 cards, three pods of 4 GPUs: two run at once on
    disjoint halves; the third waits until one of them has exited and
    takes its cards."""
    op = Operator.local(workdir=REPO_ROOT, chips=8)
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        job = chip_smoke.operator_job("cards", [
            sys.executable, "-c", "import os, time; t = time.time(); "
            "time.sleep(1.0); print(os.environ['CUDA_VISIBLE_DEVICES'], t, "
            "time.time())"], replicas=3, accelerator="")
        job.spec.success_policy = "AllWorkers"
        job.spec.replica_specs["worker"].template.spec.containers[
            0].resources["nvidia.com/gpu"] = "4"
        logs, _ = chip_smoke.run_operator_job(op, client, job, "cpu")
    finally:
        op.stop()
    runs = sorted((float(t0), float(t1), cards.split(","))
                  for cards, t0, t1 in (log.split() for log in logs.values()))
    (a0, a1, a), (b0, b1, b), (c0, _, c) = runs
    assert sorted(a + b) == [str(i) for i in range(8)]
    # The cards it took were free: their pod had exited.
    assert (c, c0 >= a1) == (a, True) or (c, c0 >= b1) == (b, True)
    assert op.backend.cards._held == {}


def _pod(job_uid: str, name: str) -> Pod:
    pod = Pod(spec=PodSpec(containers=[Container(name="jax")]))
    pod.metadata = ObjectMeta(name=name, owner_references=[OwnerReference(
        kind="TPUJob", name="job", uid=job_uid, controller=True)])
    return pod


def test_loopback_resolver_gives_a_job_one_rendezvous_port():
    resolver = LoopbackEnvResolver()
    env = {"MASTER_ADDR": "job-worker-0.default.svc", "MASTER_PORT": "8476",
           "RANK": "1", "WORLD_SIZE": "2"}
    a0 = resolver.resolve(_pod("uid-a", "a-worker-0"), env)
    a1 = resolver.resolve(_pod("uid-a", "a-worker-1"), env)
    b0 = resolver.resolve(_pod("uid-b", "b-worker-0"), env)
    assert a0["MASTER_ADDR"] == a1["MASTER_ADDR"] == "127.0.0.1"
    assert a0["MASTER_PORT"] == a1["MASTER_PORT"] != "8476"
    assert b0["MASTER_PORT"] != a0["MASTER_PORT"]
    assert (a1["RANK"], a1["WORLD_SIZE"]) == ("1", "2")


# ---------------------------------------------------------------------------
# Every plane on: gang queue, training drain, serving drain
# ---------------------------------------------------------------------------

@pytest.fixture
def planes():
    op = chip_smoke.planes_operator(total_chips=8)
    yield op, TPUJobClient(op.store)
    op.stop()


def test_second_gang_waits_for_the_first(planes):
    op, client = planes
    result = chip_smoke.run_gang_queue(op, client, [
        sys.executable, "-m", "tf_operator_tpu_torch.train.gpu_smoke",
        "--device", "cpu"], "h100-8", "8", "cpu", "cpu")
    assert result["admission_order"] == ["gpu-gang-a", "gpu-gang-b"]
    assert result["b_ready_after_a_done_seconds"] >= 0


def test_serving_gang_drains_mid_traffic_dropping_nothing(planes, tmp_path):
    op, client = planes
    result = chip_smoke.run_serving_drain(
        op, client, str(tmp_path / "spool"),
        [sys.executable, "-m", "tf_operator_tpu_torch.serve.worker"],
        "h100-8", "cpu")
    assert result["responses"] == chip_smoke.PLANES_REQUESTS
    assert result["responses_before_ack"] >= chip_smoke.PLANES_DRAIN_AFTER
    assert result["responses_after_ack"] > 0
    assert result["drain_rebind_observations"] == 1


def test_drained_training_gang_resumes_at_its_barrier_step(planes,
                                                           tmp_path):
    """Two workers of the port's worker_stub train; a maintenance notice
    under them opens the barrier, both save and ack, the gang is evicted
    and recreated, and the new pods restore the barrier step
    (restoredFromStep == lastCheckpointStep > 0) and train on from it."""
    op, client = planes
    job = chip_smoke.operator_job("ckptjob", [
        sys.executable, "-m", "tf_operator_tpu_torch.runtime.worker_stub",
        "--train-steps", "300", "--step-seconds", "0.02"], replicas=2,
        accelerator="h100-8")
    job.spec.replica_specs["worker"].restart_policy = "Never"
    job.spec.run_policy.health_policy = HealthPolicy(enabled=True)
    # No periodic cadence: the only save is the barrier's, so
    # lastCheckpointStep == restoredFromStep holds to the end.
    job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
        enabled=True, directory=str(tmp_path / "ckpt"),
        interval_steps=100000, barrier_timeout_seconds=20.0)
    client.create(job)
    client.wait_for_condition("ckptjob", JobConditionType.RUNNING,
                              timeout=chip_smoke.PLANES_WAIT_S)
    def logs():
        return client.get_job_logs("ckptjob").values()

    chip_smoke.wait_until(lambda: len(logs()) == 2 and all(
        "step 3 " in text for text in logs()), "both workers training")
    chip_smoke.inject_maintenance(op.store, "ckptjob")
    chip_smoke.wait_until(lambda: any(
        "resumed from checkpoint at step" in text for text in logs()),
        "a rebound worker resumed")
    done = client.wait_for_job("ckptjob", timeout=chip_smoke.PLANES_WAIT_S)
    status = done.status
    assert any(c.type == JobConditionType.SUCCEEDED and c.status == "True"
               for c in status.conditions)
    assert status.restored_from_step is not None
    assert status.restored_from_step > 0
    assert status.restored_from_step == status.last_checkpoint_step
    barrier = [c for c in status.conditions
               if c.type == JobConditionType.CHECKPOINT_BARRIER]
    assert [(c.status, c.reason) for c in barrier] == [
        ("False", "CheckpointBarrierSaved")]
    restored = status.restored_from_step
    resumed = [t for t in logs() if "resumed from checkpoint at step" in t]
    assert resumed
    for text in resumed:
        assert "step 1 " not in text
        assert f"step {restored + 1} " in text
    for pod in client.get_pods("ckptjob"):
        env = pod.spec.containers[0].env
        assert env["TPUJOB_RESTORE_STEP"] == str(restored)
        assert pod.spec.containers[0].resources["nvidia.com/gpu"] == "8"
