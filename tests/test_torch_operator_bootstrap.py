"""The port's GPU bootstrap contract against the JAX package's TPU one.

For the same job, every replica's env from the port's
``render_worker_env`` is an exact map of the JAX package's: the cluster
spec byte-equal, ``JAX_COORDINATOR_ADDRESS`` split into ``MASTER_ADDR`` /
``MASTER_PORT``, the slice keys renamed, and the libtpu / DCN keys
(``TPU_WORKER_*``, ``MEGASCALE_*``) gone. A JAX process drives every chip
of its host; the port runs one process a GPU, so a pod holding g GPUs
(the host's GPUs on a slice worker, one process on any other ranked pod)
is g processes: ``WORLD_SIZE`` counts them, ``LOCAL_WORLD_SIZE`` is g,
and ``JAX_PROCESS_ID`` becomes ``RANK`` (with ``LOCAL_RANK`` 0) where g is
1 and ``GROUP_RANK`` (with ``GROUP_WORLD_SIZE`` = ``JAX_NUM_PROCESSES``)
where it is more; a job of one pod holding g > 1 GPUs, for which JAX
renders no process keys, gets ``LOCAL_WORLD_SIZE`` = g alone. A slice job
is compared across accelerators of the same host count. The bootstrap digest differs from JAX's, but a resize changes
it for exactly the pods whose JAX digest it changes.
"""

import json
import os

import pytest
import torch
import yaml

from tf_operator_tpu import testutil as jtestutil
from tf_operator_tpu.api import set_defaults as j_set_defaults
from tf_operator_tpu.bootstrap import render_worker_env as j_render
from tf_operator_tpu.controller.tpu_controller import TPUJobController
from tf_operator_tpu.runtime.store import Store as JStore
from tf_operator_tpu_torch import testutil as t_testutil
from tf_operator_tpu_torch._device import resolve_device
from tf_operator_tpu_torch.api import constants as tconst
from tf_operator_tpu_torch.api import set_defaults as t_set_defaults
from tf_operator_tpu_torch.api.types import RolePolicy
from tf_operator_tpu_torch.api.types import TPUJob as TJob
from tf_operator_tpu_torch.bootstrap import parse_accelerator
from tf_operator_tpu_torch.bootstrap import render_worker_env as t_render
from tf_operator_tpu_torch.bootstrap.cluster import pod_gpus
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.parallel.distributed import local_ranks
from tf_operator_tpu_torch.runtime.store import Store as TStore

pytestmark = pytest.mark.control_plane

# JAX accelerator -> port accelerator with the same hosts a slice.
SAME_HOSTS = {"v5e-8": "h100-8", "v5p-32": "h100-32", "v5e-16": "h100-16"}
TPU_PREFIXES = ("JAX_", "TPU_", "MEGASCALE_")


def _job(accelerator="", num_slices=1, elastic=False, **replicas):
    job = jtestutil.new_tpujob(name="boot", accelerator=accelerator,
                               **replicas)
    job.spec.slice.num_slices = num_slices
    job.spec.enable_elastic_worker = elastic
    j_set_defaults(job)
    return job


def _port_job(jjob):
    """The same job in the port's types, on the port's accelerator."""
    tjob = TJob.from_dict(jjob.to_dict())
    if jjob.spec.slice.accelerator:
        tjob.spec.slice.accelerator = SAME_HOSTS[jjob.spec.slice.accelerator]
    t_set_defaults(tjob)
    return tjob


def pod_processes(tjob, rtype: str) -> int:
    """Processes a ``rtype`` pod of ``tjob`` runs: the host's GPUs on a
    slice worker, else one."""
    sl = tjob.spec.slice
    if sl.accelerator and rtype == "worker":
        return parse_accelerator(sl.accelerator, sl.topology,
                                 sl.num_slices).devices_per_host
    return 1


def world_of(tjob, rtype: str, place: int, pods: int):
    """(WORLD_SIZE, the first RANK) of the pod at JAX process id ``place``
    among ``pods`` ranked pods: every process listed by its pod's place,
    places past the job's pods (a transient render) running as many as
    this pod."""
    order = [t for t in ("chief", "master", "worker")
             if t in tjob.spec.replica_specs]
    places = [p for t in order
              for _ in range(tjob.spec.replica_specs[t].replicas)
              for p in [pod_processes(tjob, t)]]
    places += [pod_processes(tjob, rtype)] * (pods - len(places))
    processes = [p for p, n in enumerate(places) for _ in range(n)]
    return len(processes), processes.index(place)


def mapped(jenv: dict, tjob, rtype: str) -> dict:
    """The port env the GPU contract makes of JAX's env ``jenv``."""
    out = {}
    own = pod_processes(tjob, rtype)
    for key, value in jenv.items():
        if key == "TPUJOB_CLUSTER_SPEC":
            out[key] = value
        elif key in ("TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY"):
            sl = tjob.spec.slice
            topo = parse_accelerator(sl.accelerator, sl.topology,
                                     sl.num_slices)
            out["TPUJOB_ACCELERATOR_TYPE"] = topo.accelerator
            out["TPUJOB_TOPOLOGY"] = topo.topology_str
        elif key == "JAX_COORDINATOR_ADDRESS":
            out["MASTER_ADDR"], out["MASTER_PORT"] = value.rsplit(":", 1)
        elif key == "JAX_NUM_PROCESSES":
            world, first = world_of(tjob, rtype,
                                    int(jenv["JAX_PROCESS_ID"]), int(value))
            out["WORLD_SIZE"] = str(world)
            if own == 1:
                out["RANK"] = str(first)
                out["LOCAL_RANK"] = "0"
            else:
                out["GROUP_WORLD_SIZE"] = value
        elif key == "JAX_PROCESS_ID":
            if own > 1:
                out["GROUP_RANK"] = value
            out["LOCAL_WORLD_SIZE"] = str(own)
        else:
            assert key.startswith(("TPU_WORKER_", "MEGASCALE_")), key
    if "TPUJOB_CLUSTER_SPEC" not in jenv and own > 1:
        # One pod: its processes are one world, the pod's own.
        out["LOCAL_WORLD_SIZE"] = str(own)
    return out


CASES = {
    "chief-workers-ps": dict(chief=1, worker=3, ps=2),
    "workers-only": dict(worker=4),
    "master-worker": dict(master=1, worker=2),
    "evaluator": dict(chief=1, worker=2, evaluator=1),
    "elastic-sparse": dict(worker=3, ps=2, elastic=True),
    "single-process": dict(worker=1),
    "slice-v5e-8": dict(worker=2, accelerator="v5e-8"),
    "slice-v5p-32": dict(worker=4, accelerator="v5p-32"),
    "slice-v5p-32-chief-ps": dict(chief=1, worker=4, ps=1,
                                  accelerator="v5p-32"),
    "multislice-v5e-16": dict(worker=4, accelerator="v5e-16", num_slices=2),
    "multislice-elastic": dict(chief=1, worker=4, accelerator="v5e-16",
                               num_slices=2, elastic=True),
    "single-slice-process": dict(worker=1, accelerator="v5e-8"),
}


@pytest.mark.parametrize("domain", ["", "cluster.local"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_env_is_the_exact_map_of_jax(case, domain):
    jjob = _job(**CASES[case])
    tjob = _port_job(jjob)
    indices = [(rt, i) for rt, spec in jjob.spec.replica_specs.items()
               for i in range(spec.replicas)]
    # Out-of-range renders (an elastic grow before the spec settles).
    indices += [(rt, spec.replicas + 2)
                for rt, spec in jjob.spec.replica_specs.items()]
    for rt, index in indices:
        jenv = j_render(jjob, rt, index, domain=domain)
        tenv = t_render(tjob, rt, index, domain=domain)
        assert tenv == mapped(jenv, tjob, rt), (rt, index)
        assert not [k for k in tenv if k.startswith(TPU_PREFIXES)]
        assert tenv.get("TPUJOB_CLUSTER_SPEC") == jenv.get(
            "TPUJOB_CLUSTER_SPEC")


def test_world_keys_of_a_distributed_job():
    # h100-32: 4 hosts of 8 GPUs; a coordinator-only chief runs one
    # process, each worker 8.
    tjob = _port_job(_job(chief=1, worker=2, ps=1, accelerator="v5p-32"))
    chief = t_render(tjob, "chief", 0, domain="")
    assert chief["MASTER_ADDR"] == "boot-chief-0.default.svc"
    assert chief["MASTER_PORT"] == "8476"
    workers = [t_render(tjob, "worker", i, domain="") for i in (0, 1)]
    assert (chief["RANK"], chief["LOCAL_WORLD_SIZE"],
            chief["WORLD_SIZE"]) == ("0", "1", "17")
    assert [(w["GROUP_RANK"], w["GROUP_WORLD_SIZE"], w["LOCAL_WORLD_SIZE"],
             w["WORLD_SIZE"]) for w in workers] == [("1", "3", "8", "17"),
                                                    ("2", "3", "8", "17")]
    # The job-wide world (TPUJOB_JAX_DISTRIBUTED=1) ranks every process;
    # without it each worker's 8 processes are a world of their own.
    assert [list(local_ranks(dict(w, TPUJOB_JAX_DISTRIBUTED="1")))
            for w in workers] == [list(range(1, 9)), list(range(9, 17))]
    assert [list(local_ranks(w)) for w in workers] == [list(range(8))] * 2
    assert all("RANK" not in w and "LOCAL_RANK" not in w for w in workers)
    assert t_render(tjob, "worker", 5, domain="")["WORLD_SIZE"] == "49"
    ps = t_render(tjob, "ps", 0, domain="")
    assert "RANK" not in ps and "MASTER_ADDR" not in ps
    assert ps["TPUJOB_ACCELERATOR_TYPE"] == "h100-32"
    assert ps["TPUJOB_TOPOLOGY"] == "32"


def _gpu_job(accelerator, gpus=None, **replicas):
    """A port job on ``accelerator``, its templates requesting ``gpus``
    (``nvidia.com/gpu``) where given."""
    tjob = _port_job(_job(**replicas))
    tjob.spec.slice.accelerator = accelerator
    if gpus is not None:
        for spec in tjob.spec.replica_specs.values():
            spec.template.spec.containers[0].resources[
                "nvidia.com/gpu"] = str(gpus)
    t_set_defaults(tjob)
    return tjob


def test_h100_16_names_16_ranks():
    tjob = _gpu_job("h100-16", worker=2)
    envs = [t_render(tjob, "worker", i, domain="") for i in (0, 1)]
    assert {(e["WORLD_SIZE"], e["LOCAL_WORLD_SIZE"], e["GROUP_WORLD_SIZE"])
            for e in envs} == {("16", "8", "2")}
    ranks = [r for e in envs
             for r in local_ranks(dict(e, TPUJOB_JAX_DISTRIBUTED="1"))]
    assert ranks == list(range(16))
    # The controller stamps the number the env counts processes by.
    assert pod_gpus(tjob, "worker") == 8


def test_explicit_gpu_request_sets_the_local_world():
    tjob = _gpu_job("", gpus=2, worker=2)
    envs = [t_render(tjob, "worker", i, domain="") for i in (0, 1)]
    assert [(e["WORLD_SIZE"], e["GROUP_RANK"], e["LOCAL_WORLD_SIZE"])
            for e in envs] == [("4", "0", "2"), ("4", "1", "2")]
    flagged = [dict(e, TPUJOB_JAX_DISTRIBUTED="1") for e in envs]
    assert [list(local_ranks(e)) for e in flagged] == [[0, 1], [2, 3]]
    # Without the flag each pod's two processes are a world of their own.
    assert [list(local_ranks(e)) for e in envs] == [[0, 1], [0, 1]]
    # A child of the launch is one process: it launches nothing more.
    assert local_ranks(dict(flagged[1], LOCAL_RANK="1", RANK="3")) is None


# What render_worker_env gave a 2-worker h100-1 job before pods ran one
# process a GPU: the env of an h100-1 pod stays byte-equal to it.
H100_1_WORKER_1 = (
    '{"TPUJOB_ACCELERATOR_TYPE": "h100-1", "TPUJOB_TOPOLOGY": "1", '
    '"TPUJOB_CLUSTER_SPEC": "{\\"cluster\\": {\\"worker\\": '
    '[\\"boot-worker-0.default.svc:8470\\", '
    '\\"boot-worker-1.default.svc:8470\\"]}, \\"environment\\": '
    '\\"cloud\\", \\"task\\": {\\"index\\": 1, \\"type\\": '
    '\\"worker\\"}}", "MASTER_ADDR": "boot-worker-0.default.svc", '
    '"MASTER_PORT": "8476", "WORLD_SIZE": "2", "RANK": "1", '
    '"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}')


def test_h100_1_env_is_byte_equal_to_the_one_process_contract():
    tjob = _gpu_job("h100-1", worker=2)
    assert json.dumps(t_render(tjob, "worker", 1, domain="")) == \
        H100_1_WORKER_1
    assert local_ranks(t_render(tjob, "worker", 0, domain="")) is None


# (before, after) resizes of a job: which pods restart.
RESIZES = {
    "grow-workers": (dict(worker=2, ps=1), dict(worker=4, ps=1)),
    "grow-ps": (dict(worker=2, ps=1), dict(worker=2, ps=2)),
    "grow-sparse-workers": (dict(worker=2, ps=1, elastic=True),
                            dict(worker=4, ps=1, elastic=True)),
    "grow-sparse-ps": (dict(worker=2, ps=1, elastic=True),
                       dict(worker=2, ps=3, elastic=True)),
    "add-chief": (dict(worker=2, ps=1), dict(chief=1, worker=2, ps=1)),
    "grow-evaluator": (dict(chief=1, worker=2, evaluator=1),
                       dict(chief=1, worker=2, evaluator=2)),
    "grow-slices": (dict(worker=4, accelerator="v5e-16", num_slices=2),
                    dict(worker=8, accelerator="v5e-16", num_slices=4)),
    "slices-same-workers": (
        dict(chief=1, worker=4, accelerator="v5e-16", num_slices=2),
        dict(chief=1, worker=4, accelerator="v5e-16", num_slices=4)),
    "grow-sparse-slices": (
        dict(worker=4, ps=1, accelerator="v5e-16", num_slices=2,
             elastic=True),
        dict(worker=8, ps=1, accelerator="v5e-16", num_slices=4,
             elastic=True)),
    "slices-to-one": (dict(worker=4, accelerator="v5e-16", num_slices=2),
                      dict(worker=4, accelerator="v5e-16", num_slices=1)),
}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_restarts_the_pods_jax_restarts(case):
    before, after = (_job(**kw) for kw in RESIZES[case])
    jctl = TPUJobController(JStore())
    tctl = GPUJobController(TStore())
    for rt in after.spec.replica_specs:
        if rt not in before.spec.replica_specs:
            continue
        jchanged = (jctl._compute_bootstrap_hash(before, rt, 0)
                    != jctl._compute_bootstrap_hash(after, rt, 0))
        tchanged = (tctl._compute_bootstrap_hash(_port_job(before), rt, 0)
                    != tctl._compute_bootstrap_hash(_port_job(after), rt, 0))
        assert tchanged == jchanged, rt


# ---------------------------------------------------------------------------
# The device of a pod that holds no GPU
# ---------------------------------------------------------------------------

PORT_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tf_operator_tpu_torch", "examples")


def _example(rel, accelerator=None):
    """A file of the port's catalogue as a job, on ``accelerator`` where
    given (a node of one card sets ``h100-1``)."""
    with open(os.path.join(PORT_EXAMPLES, rel)) as f:
        raw = yaml.safe_load(f)
    if accelerator:
        raw["spec"].setdefault("slice", {})["accelerator"] = accelerator
    tjob = TJob.from_dict(raw)
    t_set_defaults(tjob)
    return tjob


def _pod_env(tjob, rtype, index=0):
    """The env of ``rtype`` pod ``index`` as the controller renders it."""
    pod = t_testutil.new_pod(tjob, rtype, index)
    GPUJobController(TStore()).set_cluster_spec(tjob, pod, rtype, index)
    return dict(pod.spec.containers[0].env)


# (file, accelerator, role) -> whether its pods are named the host: every
# role that holds no GPU (chief and ps, as in JAX), and every pod of a
# job with neither a slice nor an nvidia.com/gpu request.
NO_GPU_PODS = {
    ("resnet_dp/tpujob_resnet.yaml", None, "chief"): True,
    ("resnet_dp/tpujob_resnet.yaml", None, "worker"): False,
    ("resnet_dp/tpujob_resnet.yaml", "h100-1", "chief"): True,
    ("resnet_dp/tpujob_resnet.yaml", "h100-1", "worker"): False,
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", None, "ps"): True,
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", None, "worker"): True,
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", "h100-1", "ps"): True,
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", "h100-1", "worker"): False,
    ("dist_mnist/tpujob_dist_mnist.yaml", "h100-1", "chief"): True,
    ("dist_mnist/tpujob_dist_mnist.yaml", "h100-1", "worker"): False,
    ("llama_spmd/tpujob_llama.yaml", None, "worker"): False,
}
# The bootstrap digests of those pods before the device key existed: it
# is rendered outside the hash, so none moves.
NO_GPU_HASHES = {
    ("resnet_dp/tpujob_resnet.yaml", None, "chief"):
        "1994dba10970c9286a27ed5ced7ec5f56ea48f47",
    ("resnet_dp/tpujob_resnet.yaml", None, "worker"):
        "26153be37e3ea6c39347c5628855b461bdd46ef4",
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", None, "ps"):
        "aa1c456d36e7198ad7fd0baad1aba0b6369d8684",
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", None, "worker"):
        "5388c8e5e87842865f54fdba634c1a8493573a1c",
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", "h100-1", "ps"):
        "fc38816caebaf5824744a3b82936061fc08c429d",
    ("dist_mnist/tpujob_dist_mnist_ps.yaml", "h100-1", "worker"):
        "e03a6fdb3c740b8e4dfd71db529a546dd8730194",
    ("llama_spmd/tpujob_llama.yaml", None, "worker"):
        "2a3986082cc84a2b4fbf0084290b24a5b3bb0b79",
}


@pytest.mark.parametrize(
    "case", sorted(NO_GPU_PODS, key=str),
    ids=lambda c: f"{os.path.basename(c[0])[7:-5]}-{c[1] or 'as-is'}-{c[2]}")
def test_a_pod_that_holds_no_gpu_is_named_the_host(case):
    rel, accelerator, rtype = case
    tjob = _example(rel, accelerator)
    env = _pod_env(tjob, rtype)
    if NO_GPU_PODS[case]:
        assert pod_gpus(tjob, rtype) == 0
        assert env[tconst.ENV_DEVICE] == "cpu"
    else:
        assert pod_gpus(tjob, rtype) > 0
        assert tconst.ENV_DEVICE not in env
    # Outside the bootstrap env and its digest.
    assert tconst.ENV_DEVICE not in t_render(tjob, rtype, 0)
    if case in NO_GPU_HASHES:
        assert GPUJobController(TStore())._compute_bootstrap_hash(
            tjob, rtype, 0) == NO_GPU_HASHES[case]


def test_a_role_off_the_device_and_a_job_without_one_run_on_the_host():
    """chipConsuming: false takes a worker off the card, and a job with
    no slice and no request holds no GPU anywhere; an explicit request
    puts a pod back on the card."""
    tjob = _gpu_job("h100-8", worker=2)
    assert tconst.ENV_DEVICE not in _pod_env(tjob, "worker", 1)
    tjob.spec.replica_specs["worker"].role_policy = RolePolicy(
        chip_consuming=False)
    assert _pod_env(tjob, "worker", 1)[tconst.ENV_DEVICE] == "cpu"
    bare = _gpu_job("", chief=1, worker=2, ps=1, evaluator=1)
    for rtype, spec in bare.spec.replica_specs.items():
        for i in range(spec.replicas):
            assert _pod_env(bare, rtype, i)[tconst.ENV_DEVICE] == "cpu"
    requested = _gpu_job("", gpus=1, worker=2)
    assert tconst.ENV_DEVICE not in _pod_env(requested, "worker", 0)


def test_resolve_device_takes_the_host_only_when_named(monkeypatch):
    """The operator's key makes ``resolve_device(None)`` the host; an
    explicit device still wins; without the key a process with no card
    raises, an empty ``CUDA_VISIBLE_DEVICES`` or key included."""
    monkeypatch.setenv(tconst.ENV_DEVICE, "cpu")
    assert resolve_device(None) == torch.device("cpu")
    assert resolve_device("meta") == torch.device("meta")
    if torch.cuda.is_available():
        return  # the rest is about a process with no card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    for key, value in ((tconst.ENV_DEVICE, None),
                       ("CUDA_VISIBLE_DEVICES", ""),
                       (tconst.ENV_DEVICE, "")):
        if value is None:
            monkeypatch.delenv(key)
        else:
            monkeypatch.setenv(key, value)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def test_gpu_smoke_on_a_pod_without_gpus_runs_on_its_host(monkeypatch,
                                                          capsys):
    """The smoke payload given no ``--device`` in a pod that holds no
    GPU: one device, the host, as the JAX smoke runs on its host's CPU."""
    from tf_operator_tpu_torch.train import gpu_smoke

    monkeypatch.setenv(tconst.ENV_DEVICE, "cpu")
    assert gpu_smoke.main([]) == 0
    out = capsys.readouterr().out
    assert "cpu (cpu): matmul sum = 16777216.0" in out
    assert out.rstrip().endswith("smoke OK on 1 device(s)")
