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
where it is more. A slice job is compared across accelerators of the same
host count. The bootstrap digest differs from JAX's, but a resize changes
it for exactly the pods whose JAX digest it changes.
"""

import json

import pytest

from tf_operator_tpu import testutil as jtestutil
from tf_operator_tpu.api import set_defaults as j_set_defaults
from tf_operator_tpu.bootstrap import render_worker_env as j_render
from tf_operator_tpu.controller.tpu_controller import TPUJobController
from tf_operator_tpu.runtime.store import Store as JStore
from tf_operator_tpu_torch.api import set_defaults as t_set_defaults
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
    assert [list(local_ranks(w)) for w in workers] == [
        list(range(1, 9)), list(range(9, 17))]
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
    ranks = [r for e in envs for r in local_ranks(e)]
    assert ranks == list(range(16))
    # The controller stamps the number the env counts processes by.
    assert pod_gpus(tjob, "worker") == 8


def test_explicit_gpu_request_sets_the_local_world():
    tjob = _gpu_job("", gpus=2, worker=2)
    envs = [t_render(tjob, "worker", i, domain="") for i in (0, 1)]
    assert [(e["WORLD_SIZE"], e["GROUP_RANK"], e["LOCAL_WORLD_SIZE"])
            for e in envs] == [("4", "0", "2"), ("4", "1", "2")]
    assert [list(local_ranks(e)) for e in envs] == [[0, 1], [2, 3]]
    # A child of the launch is one process: it launches nothing more.
    assert local_ranks(dict(envs[1], LOCAL_RANK="1", RANK="3")) is None


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
