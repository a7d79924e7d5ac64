"""The port's API package against the JAX package's.

Every example job file loads through both ``api`` packages to the same
wire dict, before and after defaulting; validation gives the same errors
and warnings on a table of invalid specs; the port's slice topology is
the GPU one (``h100-<gpus>``, 8 GPUs a host) and refuses TPU names.
"""

import copy
import glob
import os

import pytest
import yaml

from tf_operator_tpu import api as japi
from tf_operator_tpu.api.validation import (
    ValidationError as JValidationError,
    validation_warnings as j_warnings,
)
from tf_operator_tpu_torch import api as tapi
from tf_operator_tpu_torch.api.validation import (
    ValidationError as TValidationError,
    validation_warnings as t_warnings,
)
from tf_operator_tpu_torch.bootstrap import parse_accelerator

pytestmark = pytest.mark.control_plane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*",
                                         "tpujob_*.yaml")))


def test_examples_are_found():
    assert len(EXAMPLES) >= 12


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_jobs_load_the_same(path):
    with open(path) as f:
        raw = yaml.safe_load(f)
    jjob = japi.TPUJob.from_dict(copy.deepcopy(raw))
    tjob = tapi.TPUJob.from_dict(copy.deepcopy(raw))
    assert tjob.to_dict() == jjob.to_dict()
    japi.set_defaults(jjob)
    tapi.set_defaults(tjob)
    assert tjob.to_dict() == jjob.to_dict()
    assert t_warnings(tapi.TPUJob.from_dict(tjob.to_dict())) == []


def _base() -> dict:
    container = {"name": "jax", "command": ["python", "-c", "pass"]}
    return {
        "apiVersion": "tpu-operator.dev/v1", "kind": "TPUJob",
        "metadata": {"name": "job", "namespace": "default"},
        "spec": {"replicaSpecs": {
            "worker": {"replicas": 2, "template": {"spec": {
                "containers": [dict(container)]}}},
            "ps": {"replicas": 1, "template": {"spec": {
                "containers": [dict(container)]}}}}},
    }


def _set(path: str, value):
    def mutate(d):
        keys = path.split(".")
        node = d
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return mutate


def _drop(path: str):
    def mutate(d):
        keys = path.split(".")
        node = d
        for k in keys[:-1]:
            node = node[k]
        del node[keys[-1]]
    return mutate


def _containers(rtype: str, containers):
    return _set(f"spec.replicaSpecs.{rtype}.template.spec.containers",
                containers)


INVALID = {
    "bad-name": [_set("metadata.name", "Bad_Name")],
    "no-name": [_set("metadata.name", "")],
    "no-replica-specs": [_set("spec.replicaSpecs", {})],
    "unknown-type": [_set("spec.replicaSpecs.gpu",
                          _base()["spec"]["replicaSpecs"]["ps"])],
    "negative-replicas": [_set("spec.replicaSpecs.worker.replicas", -1)],
    "bad-restart": [_set("spec.replicaSpecs.worker.restartPolicy",
                         "Sometimes")],
    "two-chiefs": [_set("spec.replicaSpecs.chief",
                        _base()["spec"]["replicaSpecs"]["ps"]),
                   _set("spec.replicaSpecs.master",
                        _base()["spec"]["replicaSpecs"]["ps"])],
    "no-containers": [_containers("worker", [])],
    "no-default-container": [_containers("worker", [
        {"name": "main", "command": ["true"]}])],
    "no-command": [_containers("ps", [{"name": "jax"}])],
    "inverted-band": [_set("spec.replicaSpecs.ps.rolePolicy",
                           {"minReplicas": 3, "maxReplicas": 1})],
    "bad-success-policy": [_set("spec.successPolicy", "Some")],
    "bad-clean-pod": [_set("spec.runPolicy.cleanPodPolicy", "Most")],
    "negative-backoff": [_set("spec.runPolicy.backoffLimit", -1)],
    "negative-deadline": [_set("spec.runPolicy.activeDeadlineSeconds", -5)],
    "negative-ttl": [_set("spec.runPolicy.ttlSecondsAfterFinished", -1)],
    "ckpt-no-dir": [_set("spec.runPolicy.checkpointPolicy",
                         {"enabled": True, "maxToKeep": 0})],
    "serving-no-role": [_set("spec.runPolicy.servingPolicy",
                             {"enabled": True, "spoolDirectory": "/s"})],
    "bad-queue": [_set("spec.queueName", "Queue!")],
    "bad-topology": [_set("spec.slice.topology", "2by2")],
    "zero-slices": [_set("spec.slice.numSlices", 0)],
    "actor-band-on-worker": [_set("spec.replicaSpecs.worker.rolePolicy",
                                  {"minReplicas": 1, "maxReplicas": 4})],
    "half-band": [_set("spec.replicaSpecs.ps.rolePolicy",
                       {"minReplicas": 1})],
    "many-at-once": [_set("metadata.name", "X"), _drop("spec.replicaSpecs.ps"),
                     _set("spec.runPolicy.backoffLimit", -2),
                     _set("spec.slice.numSlices", -1)],
}


def _errors(api_pkg, error_cls, raw) -> list:
    job = api_pkg.TPUJob.from_dict(raw)
    try:
        api_pkg.set_defaults(job)
        api_pkg.validate_job(job)
    except error_cls as e:
        return e.errors
    return []


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_match(case):
    raw = _base()
    for mutate in INVALID[case]:
        mutate(raw)
    want = _errors(japi, JValidationError, copy.deepcopy(raw))
    assert want, case
    assert _errors(tapi, TValidationError, copy.deepcopy(raw)) == want


# JAX accelerator -> port accelerator of the same host count.
SAME_HOSTS = {"v5e-8": "h100-8", "v5e-16": "h100-16", "v5p-32": "h100-32"}


@pytest.mark.parametrize("jax_accel,workers,slices", [
    ("v5e-16", 3, 2), ("v5e-16", 4, 2), ("v5p-32", 5, 3), ("v5e-8", 1, 2)])
def test_multislice_warnings_match(jax_accel, workers, slices):
    raw = _base()
    raw["spec"]["replicaSpecs"]["worker"]["replicas"] = workers
    raw["spec"]["slice"] = {"accelerator": jax_accel, "numSlices": slices}
    want = j_warnings(japi.TPUJob.from_dict(copy.deepcopy(raw)))
    raw["spec"]["slice"]["accelerator"] = SAME_HOSTS[jax_accel]
    assert t_warnings(tapi.TPUJob.from_dict(copy.deepcopy(raw))) == want
    assert _errors(tapi, TValidationError, raw) == []


def test_accelerator_errors():
    raw = _base()
    raw["spec"]["slice"] = {"accelerator": "h100"}
    assert _errors(tapi, TValidationError, copy.deepcopy(raw)) == [
        "spec.slice.accelerator 'h100' invalid; expected e.g. 'h100-8'"]
    raw["spec"]["slice"] = {"accelerator": "h100-0"}
    assert _errors(tapi, TValidationError, copy.deepcopy(raw)) == [
        "spec.slice.accelerator chip count must be >= 1"]
    # A TPU name is well formed for the JAX package and refused here.
    raw["spec"]["slice"] = {"accelerator": "v5p-32"}
    assert _errors(japi, JValidationError, copy.deepcopy(raw)) == []
    assert _errors(tapi, TValidationError, copy.deepcopy(raw)) == [
        "spec.slice.accelerator 'v5p-32': unknown GPU generation 'v5p'; "
        "known: h100"]


@pytest.mark.parametrize("accel,gpus,hosts,per_host,mesh", [
    ("h100-1", 1, 1, 1, (1,)),
    ("h100-2", 2, 1, 2, (2,)),
    ("h100-8", 8, 1, 8, (8,)),
    ("h100-16", 16, 2, 8, (16,)),
    ("h100-32", 32, 4, 8, (32,)),
    ("h100-64", 64, 8, 8, (64,)),
])
def test_h100_topology(accel, gpus, hosts, per_host, mesh):
    t = parse_accelerator(accel)
    assert (t.generation, t.chips, t.hosts_per_slice, t.devices_per_host,
            t.topology, t.topology_str) == (
        "h100", gpus, hosts, per_host, mesh, "x".join(map(str, mesh)))
    two = parse_accelerator(accel, num_slices=2)
    assert (two.num_hosts, two.total_chips) == (2 * hosts, 2 * gpus)


@pytest.mark.parametrize("accel,match", [
    ("v5p-32", "unknown GPU generation 'v5p'"),
    ("v5e-8", "unknown GPU generation 'v5e'"),
    ("a100-8", "unknown GPU generation 'a100'"),
    ("h100", "invalid accelerator"),
    ("h100-0", "zero chips"),
])
def test_tpu_and_unknown_names_rejected(accel, match):
    with pytest.raises(ValueError, match=match):
        parse_accelerator(accel)


def test_topology_override_must_cover_the_gpus():
    assert parse_accelerator("h100-16", topology="2x8").topology == (2, 8)
    with pytest.raises(ValueError, match="has 8 chips"):
        parse_accelerator("h100-16", topology="8")


def test_run_local_loads_json_and_yaml(tmp_path, monkeypatch):
    """``run_local`` reads JSON always and YAML through pyyaml, and says
    so where pyyaml is missing."""
    import json
    import sys

    from tf_operator_tpu_torch.run_local import load_job

    raw = _base()
    (tmp_path / "job.json").write_text(json.dumps(raw))
    (tmp_path / "job.yaml").write_text(yaml.safe_dump(raw))
    want = tapi.TPUJob.from_dict(copy.deepcopy(raw)).to_dict()
    assert load_job(str(tmp_path / "job.json")).to_dict() == want
    assert load_job(str(tmp_path / "job.yaml")).to_dict() == want
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert load_job(str(tmp_path / "job.json")).to_dict() == want
    with pytest.raises(SystemExit, match="needs pyyaml"):
        load_job(str(tmp_path / "job.yaml"))
