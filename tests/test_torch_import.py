"""The PyTorch port imports without JAX and runs on the card by default.

A subprocess imports every module of ``tf_operator_tpu_torch`` (and
``chip_smoke.py``) behind a meta-path finder that refuses ``jax``,
``flax``, ``optax`` and the JAX package itself, so a GPU worker image
needs none of them.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

pytestmark = pytest.mark.compute

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, runpy, sys

    BLOCKED = ("jax", "flax", "optax", "orbax", "tf_operator_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import tf_operator_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    runpy.run_path("chip_smoke.py", run_name="chip_smoke_import")
    leaked = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not leaked, leaked
    print(" ".join(names))
    print("imported", len(names))
""")


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[-1])
    assert count >= 97, proc.stdout
    for module in ("parallel.distributed", "parallel.mesh",
                   "parallel.sharding", "models.mixtral", "serve.gateway",
                   "train.train_mixtral", "ops.ring_attention",
                   "parallel.pipeline", "parallel.llama_pp",
                   "train.train_llama_pp", "models.bert", "train.train_bert",
                   "train.ps", "train.dist_mnist_ps", "operator",
                   "run_local", "controller.gpu_controller", "runtime.local",
                   "bootstrap.cluster", "sdk.client", "train.gpu_smoke",
                   "controller.gang", "controller.binder",
                   "controller.health", "controller.ckpt",
                   "controller.quota", "controller.serving",
                   "controller.autoscaler", "runtime.worker_stub",
                   "version", "runtime.logconfig", "runtime.tlsutil",
                   "runtime.apiserver", "runtime.remote", "runtime.agent",
                   "runtime.monitoring", "cli", "__main__",
                   "api.schema", "runtime.chaos", "runtime.kube_fake",
                   "runtime.kube", "runtime.nodeagent",
                   "runtime.chaos_campaign"):
        assert f"tf_operator_tpu_torch.{module}" in proc.stdout.split()


_NO_TORCH = textwrap.dedent("""
    import runpy, sys

    BLOCKED = ("torch", "jax", "flax", "optax", "orbax", "tf_operator_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    if sys.argv[1] == "version":
        sys.argv[1:] = ["--version"]
        runpy.run_module("tf_operator_tpu_torch", run_name="__main__",
                         alter_sys=True)
    if sys.argv[1] == "kube":
        # --backend kube and the kube node agent, started against the
        # port's fake API server.
        import json, os, tempfile
        from tf_operator_tpu_torch import cli
        from tf_operator_tpu_torch.runtime.kube import KubeClient, KubeConfig
        from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer
        from tf_operator_tpu_torch.runtime.nodeagent import KubeNodeAgent
        from tf_operator_tpu_torch.sdk.client import TPUJobClient
        fake = FakeKubeApiServer().start()
        fake.state.add_node("n1", chips=1)
        work = tempfile.mkdtemp()
        kubeconfig = os.path.join(work, "kubeconfig")
        with open(kubeconfig, "w") as f:  # JSON is YAML
            json.dump({"apiVersion": "v1", "kind": "Config",
                       "current-context": "t",
                       "contexts": [{"name": "t", "context": {
                           "cluster": "t", "user": "t"}}],
                       "clusters": [{"name": "t",
                                     "cluster": {"server": fake.url}}],
                       "users": [{"name": "t", "user": {}}]}, f)
        server = cli.Server(cli.build_parser().parse_args([
            "--backend", "kube", "--kubeconfig", kubeconfig,
            "--monitoring-port", "0", "--no-leader-elect"]))
        server.operator.start(threadiness=1, sync_timeout=10)
        agent = KubeNodeAgent(KubeClient(KubeConfig(server=fake.url)), "n1",
                              os.path.join(work, "relay"),
                              heartbeat_seconds=0.2).start()
        TPUJobClient.connect_kube(kubeconfig).list()
        agent.stop()
        server.operator.stop()
        fake.stop()
        import shutil
        shutil.rmtree(work)
        print(type(server.operator).__name__)
    if sys.argv[1] == "campaign":
        # One sharded chaos round: two replicas, shard leases, a kill.
        from tf_operator_tpu_torch.runtime import chaos_campaign
        assert chaos_campaign.main(["--sharded", "--rounds", "1",
                                    "--seed", "3000"]) == 0
    import tf_operator_tpu_torch.runtime.agent as agent
    import tf_operator_tpu_torch.runtime.nodeagent as nodeagent
    import tf_operator_tpu_torch.cli
    import tf_operator_tpu_torch.runtime.monitoring
    import tf_operator_tpu_torch.sdk.client
    for main in (agent.main, nodeagent.main):
        try:
            main(["--help"])
        except SystemExit as exit:
            assert exit.code == 0
    assert not [m for m in sys.modules if m == "torch"
                or m.startswith("torch.")]
    print("imported without torch")
""")


@pytest.mark.parametrize("what", ["version", "agent", "kube", "campaign"])
def test_served_processes_start_without_torch(what):
    """``python -m tf_operator_tpu_torch --version``, the node agents'
    modules (API server, remote store, command line, monitoring, SDK
    client) and, for ``kube``, the operator on ``--backend kube``, the
    kube node agent and ``connect_kube`` started against the port's fake
    API server, and for ``campaign`` one sharded round of the chaos
    campaign, load and run with torch, JAX and the JAX package blocked:
    the control plane never pays for a torch import."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH, what], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=60)
    if what == "version":
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.startswith("tpu-operator-torch v"), proc.stdout
    else:
        assert proc.returncode == 0, proc.stderr
        assert "--chips" in proc.stdout and "--relay-dir" in proc.stdout
        assert proc.stdout.endswith("imported without torch\n")
        assert ("KubeOperator" in proc.stdout.split()) == (what == "kube")


def test_blocker_matches_exact_package_name():
    """The finder's rule blocks tf_operator_tpu and its submodules but not
    tf_operator_tpu_torch (a bare prefix match would)."""
    blocked = ("tf_operator_tpu",)
    rule = lambda n: any(n == b or n.startswith(b + ".") for b in blocked)
    assert rule("tf_operator_tpu")
    assert rule("tf_operator_tpu.ops.layers")
    assert not rule("tf_operator_tpu_torch")
    assert not rule("tf_operator_tpu_torch.ops")


@pytest.mark.parametrize("entry", ["llama", "trainer", "payload", "runner",
                                   "worker", "mnist", "mnist_payload",
                                   "resnet", "resnet_payload",
                                   "native_pipeline", "mesh",
                                   "distributed", "sharded_payload",
                                   "mixtral", "mixtral_runner",
                                   "mixtral_payload", "pipeline_trainer",
                                   "pipeline_payload", "bert",
                                   "bert_payload", "ps_server", "ps_main",
                                   "ps_worker", "gpu_smoke"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """With no device and no card, each entry point raises instead of
    running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from tf_operator_tpu_torch.models.llama import Llama, llama_tiny
    from tf_operator_tpu_torch.models.mixtral import Mixtral, mixtral_tiny
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.models.resnet import ResNet, resnet_tiny
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
    )
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.serve import worker
    from tf_operator_tpu_torch.serve.runner import LlamaRunner, MixtralRunner
    from tf_operator_tpu_torch.parallel.llama_pp import LlamaPipelineTrainer
    from tf_operator_tpu_torch.train import (
        data,
        dist_mnist,
        train_llama,
        train_llama_pp,
        train_mixtral,
        train_resnet,
    )
    from tf_operator_tpu_torch.train.trainer import Trainer, adamw
    from tf_operator_tpu_torch.models.bert import Bert, bert_tiny
    from tf_operator_tpu_torch.train import dist_mnist_ps, ps, train_bert
    from tf_operator_tpu_torch.train import gpu_smoke

    monkeypatch.setenv(ps.ENV_CLUSTER_SPEC,
                       '{"cluster": {"ps": ["127.0.0.1:0"]}, '
                       '"task": {"type": "ps", "index": 0}}')

    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "llama":
            Llama(llama_tiny())
        elif entry == "trainer":
            Trainer(model=Llama(llama_tiny(), device="cpu"),
                    optimizer=adamw(1e-3))
        elif entry == "payload":
            train_llama.main(["--steps", "1"])
        elif entry == "runner":
            LlamaRunner()
        elif entry == "mnist":
            MnistCNN()
        elif entry == "mnist_payload":
            dist_mnist.main(["--steps", "1",
                             "--checkpoint-dir", str(tmp_path)])
        elif entry == "resnet":
            ResNet(resnet_tiny())
        elif entry == "resnet_payload":
            train_resnet.main(["--steps", "1"])
        elif entry == "native_pipeline":
            with data.images_pipeline(2, 8) as loader:
                next(data.prefetch_to_device(loader))
        elif entry == "mesh":
            make_mesh()
        elif entry == "distributed":
            maybe_init_distributed(environ={
                "TPUJOB_JAX_DISTRIBUTED": "1", "JAX_NUM_PROCESSES": "2",
                "JAX_COORDINATOR_ADDRESS": "127.0.0.1:1"})
        elif entry == "sharded_payload":
            train_llama.main(["--steps", "1", "--fsdp", "1", "--tp", "1"])
        elif entry == "mixtral":
            Mixtral(mixtral_tiny())
        elif entry == "mixtral_runner":
            MixtralRunner()
        elif entry == "mixtral_payload":
            train_mixtral.main(["--steps", "1"])
        elif entry == "pipeline_trainer":
            LlamaPipelineTrainer(llama_tiny(), None, adamw(1e-3), 2)
        elif entry == "pipeline_payload":
            train_llama_pp.main(["--steps", "1", "--pp", "1", "--dp", "1"])
        elif entry == "bert":
            Bert(bert_tiny())
        elif entry == "bert_payload":
            train_bert.main(["--steps", "1"])
        elif entry == "ps_server":
            ps.ParameterServer()
        elif entry == "ps_main":
            ps.main([])
        elif entry == "ps_worker":
            dist_mnist_ps.main(["--steps", "1"])
        elif entry == "gpu_smoke":
            gpu_smoke.main([])
        else:
            worker.main(["--runner", "llama", "--spool", str(tmp_path)])


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
