"""A pod of several GPUs outside the job-wide world trains as one world of
its own, as the JAX payload trains one mesh over its host's chips.

The JAX payloads (``examples/llama_spmd/train_llama.py``,
``examples/resnet_dp/train_resnet.py``) build their mesh over every local
device, so one process drives all of its host's chips. The port runs one
process a GPU; without ``TPUJOB_JAX_DISTRIBUTED=1`` a pod's processes are
a world of their own (``parallel/distributed.py``
``launch_local_processes``: ``RANK`` = ``LOCAL_RANK``, ``WORLD_SIZE`` =
the pod's GPUs, the store at 127.0.0.1). Pods of 2 GPUs, their env as the
port's controller renders it:

- the one pod of a one-replica job, whose env names no job-wide world;
- worker 1 of a two-replica job, whose env names the job-wide world at a
  cluster DNS name that resolves nowhere here, so a process that went
  there would fail.

Each runs a port payload with that env. Its 2 processes join one gloo
world; their ``mesh:`` line is the JAX payload's on 2 forced host
devices, and their per-step losses are the port's one-process run over
the same global batch: within 5e-4 for the Llama payload (the
Trainer-step tolerance); the bf16 ResNet's first loss, whose BatchNorm
statistics are the global batch's, within 1e-5, its steps (bf16 sums
split over ranks round apart) held instead in f32: ResNet-tiny at dp=2,
two SGD steps, every parameter and BatchNorm statistic within 1e-5 of one
process (the SGD-step tolerance).
"""

import contextlib
import dataclasses
import importlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tf_operator_tpu_torch import testutil as t_testutil
from tf_operator_tpu_torch.api import set_defaults as t_set_defaults
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.runtime.store import Store as TStore

pytestmark = pytest.mark.e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# payload -> (its JAX file, its arguments, (steps compared, tolerance)).
PAYLOADS = {
    "train_llama": ("llama_spmd", ["--size", "tiny", "--steps", "2",
                                   "--batch-size", "4", "--seq-len", "32"],
                    (2, 5e-4)),
    "train_resnet": ("resnet_dp", ["--size", "tiny", "--steps", "2",
                                   "--batch-size", "4"], (1, 1e-5)),
}
# The payloads print losses to 4 decimals.
PRINTED = 5e-5
SGD_TOL = 1e-5
RUN_TIMEOUT_S = 180
STEP = re.compile(r"step (\d+): loss=(\S+)")


def pod_env(replicas: int, index: int) -> dict:
    """The env the controller renders into worker ``index`` of a job of
    ``replicas`` workers, each requesting 2 GPUs, no flag."""
    job = t_testutil.new_tpujob(worker=replicas, name="lw")
    job.spec.replica_specs["worker"].template.spec.containers[
        0].resources["nvidia.com/gpu"] = "2"
    t_set_defaults(job)
    pod = t_testutil.new_pod(job, "worker", index)
    GPUJobController(TStore()).set_cluster_spec(job, pod, "worker", index)
    return dict(pod.spec.containers[0].env)


def run_pod(payload: str, env: dict) -> str:
    """The payload as the pod runs it; its processes' combined output."""
    proc = subprocess.run(
        [sys.executable, "-m", f"tf_operator_tpu_torch.train.{payload}",
         *PAYLOADS[payload][1], "--device", "cpu"],
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"), "PYTHONPATH": REPO,
             **env},
        cwd=REPO, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def losses(out: str, processes: int):
    """Step -> its loss, every process having printed the same one."""
    by_step = {}
    for m in STEP.finditer(out):
        by_step.setdefault(int(m[1]), []).append(float(m[2]))
    assert sorted(by_step) == list(range(2)), out
    assert all(len(v) == processes and len(set(v)) == 1
               for v in by_step.values()), by_step
    return [by_step[i][0] for i in sorted(by_step)]


@pytest.fixture(scope="module")
def jax_mesh_lines():
    """Each JAX payload's ``mesh:`` line on 2 forced host devices (it is
    printed before the model is built, so each run stops there)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    lines = {}
    for payload, (example, args, _) in PAYLOADS.items():
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples", example,
                                          f"{payload}.py"), *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        try:
            lines[payload] = next((line.strip() for line in proc.stdout
                                   if line.startswith("mesh:")), None)
        finally:
            proc.kill()
            proc.wait()
            proc.stdout.close()
        assert lines[payload], f"{payload}: no mesh line"
    return lines


@pytest.fixture(scope="module")
def one_process():
    """Each port payload's one-process run over the same global batch."""
    runs = {}
    for payload in PAYLOADS:
        module = importlib.import_module(
            f"tf_operator_tpu_torch.train.{payload}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert module.main([*PAYLOADS[payload][1], "--device",
                                "cpu"]) == 0
        runs[payload] = losses(out.getvalue(), 1)
    return runs


@pytest.mark.parametrize("payload, replicas, index", [
    ("train_llama", 1, 0), ("train_llama", 2, 1), ("train_resnet", 1, 0)],
    ids=["llama-one-pod-job", "llama-pod-of-a-two-pod-job",
         "resnet-one-pod-job"])
def test_a_pod_of_two_gpus_is_one_world_of_two(payload, replicas, index,
                                                jax_mesh_lines,
                                                one_process):
    env = pod_env(replicas, index)
    assert env["LOCAL_WORLD_SIZE"] == "2"
    assert "TPUJOB_JAX_DISTRIBUTED" not in env
    if replicas > 1:
        # The job-wide world the flag would turn on, at a cluster name.
        assert (env["WORLD_SIZE"], env["GROUP_RANK"]) == ("4", "1")
        assert env["MASTER_ADDR"].endswith(".svc")
    out = run_pod(payload, env)
    meshes = [line for line in out.splitlines() if line.startswith("mesh:")]
    assert meshes == [jax_mesh_lines[payload]] * 2, out
    assert out.count("training OK") == 2
    steps, tol = PAYLOADS[payload][2]
    np.testing.assert_allclose(losses(out, 2)[:steps],
                               one_process[payload][:steps],
                               atol=tol + PRINTED, rtol=0)


def _resnet_f32_steps(mesh, steps: int = 2):
    """ResNet-tiny in f32 on ``mesh`` (None: one process), ``steps`` SGD
    steps on one global batch of 4: its parameters and buffers after."""
    import torch

    from tf_operator_tpu_torch.models import resnet as rn
    from tf_operator_tpu_torch.parallel.sharding import CNN_RULES
    from tf_operator_tpu_torch.train.trainer import (
        Trainer,
        classification_loss,
        sgd,
    )

    cfg = dataclasses.replace(rn.resnet_tiny(), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    model = rn.ResNet(cfg, device="meta" if mesh is not None else "cpu",
                      generator=gen)
    trainer = Trainer(model=model, optimizer=sgd(0.1, momentum=0.9),
                      loss_fn=classification_loss, device="cpu", mesh=mesh,
                      rules=CNN_RULES, param_axes_fn=rn.param_logical_axes)
    state, step = trainer.init(), trainer.make_train_step()
    batch = rn.synthetic_batch(gen, batch_size=4, image_size=32,
                               num_classes=cfg.num_classes)
    for _ in range(steps):
        state, _ = step(state, batch)
    return {name: (t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().clone()
            for name, t in [*model.named_parameters(),
                            *model.named_buffers()]}


def _resnet_rank(out: str) -> None:
    """One rank of the pod's world of 2 (``LOCAL_RANK`` from the launch)."""
    import torch
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    with process_group_scope():
        rank = maybe_init_distributed("cpu")
        assert dist.is_initialized() and dist.get_world_size() == 2
        got = _resnet_f32_steps(make_mesh(MeshConfig(dp=-1), device="cpu"))
        if rank == 0:
            torch.save(got, out)


def test_resnet_steps_at_dp2_are_one_process_steps(tmp_path):
    """The launch's world of 2 trains f32 ResNet-tiny as one process does
    over the same global batch: BatchNorm statistics and their gradients
    over the global batch, parameters replicated."""
    import torch

    out = tmp_path / "dp2.pt"
    launch = ("import sys; from tf_operator_tpu_torch.parallel.distributed "
              "import launch_local_processes as launch; "
              "sys.exit(launch('test_torch_local_world', sys.argv[1:]))")
    proc = subprocess.run(
        [sys.executable, "-c", launch, str(out)], cwd=REPO,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"),
             "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "tests"),
                                            REPO]),
             "LOCAL_WORLD_SIZE": "2", "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = torch.load(out, weights_only=False)
    want = _resnet_f32_steps(None)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=SGD_TOL, rtol=0, err_msg=name)


if __name__ == "__main__":
    # A rank of test_resnet_steps_at_dp2_are_one_process_steps's world.
    _resnet_rank(sys.argv[1])
