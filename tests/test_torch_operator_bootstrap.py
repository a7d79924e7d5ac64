"""The port's GPU bootstrap contract against the JAX package's TPU one.

For the same job, every replica's env from the port's
``render_worker_env`` is an exact map of the JAX package's: the cluster
spec byte-equal, ``JAX_COORDINATOR_ADDRESS`` split into ``MASTER_ADDR`` /
``MASTER_PORT``, ``JAX_NUM_PROCESSES`` -> ``WORLD_SIZE``,
``JAX_PROCESS_ID`` -> ``RANK`` (with ``LOCAL_RANK`` 0 and
``LOCAL_WORLD_SIZE`` 1), the slice keys renamed, and the libtpu / DCN keys
(``TPU_WORKER_*``, ``MEGASCALE_*``) gone. A slice job is compared across
accelerators of the same host count. The bootstrap digest differs from
JAX's, but a resize changes it for exactly the pods whose JAX digest it
changes.
"""

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
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
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


def mapped(jenv: dict, tjob) -> dict:
    """The port env the GPU contract makes of JAX's env ``jenv``."""
    out = {}
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
            out["WORLD_SIZE"] = value
        elif key == "JAX_PROCESS_ID":
            out["RANK"] = value
            out["LOCAL_RANK"] = "0"
            out["LOCAL_WORLD_SIZE"] = "1"
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
        assert tenv == mapped(jenv, tjob), (rt, index)
        assert not [k for k in tenv if k.startswith(TPU_PREFIXES)]
        assert tenv.get("TPUJOB_CLUSTER_SPEC") == jenv.get(
            "TPUJOB_CLUSTER_SPEC")


def test_world_keys_of_a_distributed_job():
    tjob = _port_job(_job(chief=1, worker=2, ps=1, accelerator="v5p-32"))
    chief = t_render(tjob, "chief", 0, domain="")
    assert chief["MASTER_ADDR"] == "boot-chief-0.default.svc"
    assert chief["MASTER_PORT"] == "8476"
    ranks = [t_render(tjob, "worker", i, domain="")["RANK"] for i in (0, 1)]
    assert (chief["RANK"], ranks, chief["WORLD_SIZE"]) == ("0", ["1", "2"],
                                                           "3")
    assert t_render(tjob, "worker", 5, domain="")["WORLD_SIZE"] == "7"
    ps = t_render(tjob, "ps", 0, domain="")
    assert "RANK" not in ps and "MASTER_ADDR" not in ps
    assert ps["TPUJOB_ACCELERATOR_TYPE"] == "h100-32"
    assert ps["TPUJOB_TOPOLOGY"] == "32"


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
