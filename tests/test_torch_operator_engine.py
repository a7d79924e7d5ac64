"""The port's reconcile engine and GPU controller against the JAX ones.

Both control planes are driven over the same jobs and the same scripted
pod phases, one sync at a time and with no threads: the normal-path
matrix of ``tests/test_engine.py`` through each package's engine and stub
plugin, then arcs through each package's real controller over its own
store (exit codes 137 and 1 under ``ExitCode``, the clean-pod policies,
the backoff limit, a slice job). They must give the same pod and endpoint
names, labels and annotations (bootstrap hash aside), creations and
deletions, events, condition sequence, restart counts and replica
tallies; ``nvidia.com/gpu`` and its toleration must stand where
``google.com/tpu`` and its toleration stand, with the port topology's
GPUs a host. Every operator flag builds the planes the JAX operator's
builds, and the invalid flag combinations raise the JAX operator's
``ValueError``.
"""

import copy
import datetime as dt
import os

import pytest

from test_engine import NORMAL_PATH_CASES

from tf_operator_tpu import testutil as jtestutil
from tf_operator_tpu.api import constants as jconst
from tf_operator_tpu.api import set_defaults as j_set_defaults
from tf_operator_tpu.api.types import (
    ContainerStatus as JContainerStatus,
    PodStatus as JPodStatus,
    TPUJob as JJob,
)
from tf_operator_tpu.controller import control as jcontrol
from tf_operator_tpu.controller.engine import JobEngine as JEngine
from tf_operator_tpu.controller.tpu_controller import TPUJobController
from tf_operator_tpu.operator import Operator as JOperator
from tf_operator_tpu.runtime import store as jstore
from tf_operator_tpu_torch import testutil as ttestutil
from tf_operator_tpu_torch.api import constants as tconst
from tf_operator_tpu_torch.api import set_defaults as t_set_defaults
from tf_operator_tpu_torch.api.types import (
    ContainerStatus as TContainerStatus,
    PodStatus as TPodStatus,
    TPUJob as TJob,
)
from tf_operator_tpu_torch.bootstrap import parse_accelerator
from tf_operator_tpu_torch.controller import control as tcontrol
from tf_operator_tpu_torch.controller.engine import JobEngine as TEngine
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime import store as tstore

pytestmark = pytest.mark.control_plane

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAME_HOSTS = {"v5e-8": "h100-8", "v5p-32": "h100-32", "v5e-16": "h100-16"}


# ---------------------------------------------------------------------------
# The normal-path matrix through each package's engine and stub plugin
# ---------------------------------------------------------------------------

def _stub_sync(testutil, engine_cls, control, set_defaults, job, phases):
    pods = []
    for rtype, (pending, active, succeeded, failed) in phases.items():
        testutil.set_pod_statuses(pods, job, rtype, pending=pending,
                                  active=active, succeeded=succeeded,
                                  failed=failed)
    plugin = testutil.StubPlugin(pods=pods)
    engine = engine_cls(plugin=plugin, pod_control=control.FakePodControl(),
                        endpoint_control=control.FakeEndpointControl())
    plugin.workqueue = engine.workqueue
    set_defaults(job)
    engine.reconcile_jobs(job)
    created = [(p.metadata.name, p.metadata.labels,
                {k: v for k, v in p.metadata.annotations.items()
                 if k != jconst.ANNOTATION_BOOTSTRAP_HASH})
               for p in engine.pod_control.templates]
    endpoints = [(e.metadata.name, e.metadata.labels, e.spec.to_dict())
                 for e in engine.endpoint_control.templates]
    status = job.status.to_dict()
    for key in ("startTime", "completionTime", "allReplicasReadyTime"):
        status.pop(key, None)
    for c in status.get("conditions", []):
        c.pop("lastUpdateTime"), c.pop("lastTransitionTime")
    return (sorted(created, key=str), sorted(endpoints, key=str),
            sorted(engine.pod_control.delete_pod_names), status,
            plugin.cluster_spec_calls)


@pytest.mark.parametrize("case", NORMAL_PATH_CASES,
                         ids=[c[0] for c in NORMAL_PATH_CASES])
def test_normal_path_matrix_matches(case):
    _, worker, ps, phases, want_creates, want_deletes, _ = case
    jjob = jtestutil.new_tpujob(worker=worker, ps=ps)
    tjob = TJob.from_dict(copy.deepcopy(jjob.to_dict()))
    want = _stub_sync(jtestutil, JEngine, jcontrol, j_set_defaults, jjob,
                      phases)
    got = _stub_sync(ttestutil, TEngine, tcontrol, t_set_defaults, tjob,
                     phases)
    assert got == want
    assert (len(got[0]), len(got[2])) == (want_creates, want_deletes)


# ---------------------------------------------------------------------------
# Arcs through each package's real controller over its own store
# ---------------------------------------------------------------------------

class World:
    """One package's controller over its own store, synced by hand."""

    def __init__(self, port: bool):
        self.port = port
        store_mod = tstore if port else jstore
        self.store_mod = store_mod
        self.store = store_mod.Store()
        self.ctl = (GPUJobController if port else TPUJobController)(
            self.store)
        self.key = ""

    def submit(self, wire: dict) -> None:
        job = (TJob if self.port else JJob).from_dict(copy.deepcopy(wire))
        if self.port and job.spec.slice.accelerator:
            job.spec.slice.accelerator = SAME_HOSTS[
                job.spec.slice.accelerator]
        self.store.create(self.store_mod.TPUJOBS, job)
        self.key = job.key()

    def sync(self) -> None:
        # Every create and delete of the last sync has been observed.
        self.ctl.expectations.delete_for_job(self.key)
        self.ctl.sync_tpujob(self.key)

    def set_phase(self, name: str, phase: str, exit_code=None,
                  restart_count: int = 0) -> None:
        pod_status = TPodStatus if self.port else JPodStatus
        container_status = TContainerStatus if self.port \
            else JContainerStatus
        pod = self.store.get(self.store_mod.PODS, "default", name)
        state = "Running" if exit_code is None else "Terminated"
        pod.status = pod_status(
            phase=phase, start_time=dt.datetime.now(dt.timezone.utc),
            container_statuses=[container_status(
                name=jconst.DEFAULT_CONTAINER_NAME, state=state,
                exit_code=exit_code, restart_count=restart_count)])
        self.store.update_status(self.store_mod.PODS, pod)

    def pods(self) -> dict:
        return {p.metadata.name: p for p in
                self.store.list(self.store_mod.PODS, namespace="default")}

    def observed(self) -> dict:
        """What both control planes must agree on."""
        job = self.store.get(self.store_mod.TPUJOBS, "default",
                             self.key.split("/")[1])
        resource = tconst.RESOURCE_GPU if self.port \
            else jconst.RESOURCE_TPU
        pods = {}
        for name, p in sorted(self.pods().items()):
            c = p.spec.containers[0]
            pods[name] = {
                "labels": p.metadata.labels,
                "annotations": {
                    k: v for k, v in p.metadata.annotations.items()
                    if k != jconst.ANNOTATION_BOOTSTRAP_HASH},
                "owner": [r.name for r in p.metadata.owner_references],
                "restart_policy": p.spec.restart_policy,
                "device_request": resource in c.resources,
                "device_toleration": [(t.key == resource, t.operator)
                                      for t in p.spec.tolerations],
                "other_resources": {k: v for k, v in c.resources.items()
                                    if k != resource},
            }
        endpoints = sorted(
            (e.metadata.name, e.metadata.labels, e.spec.to_dict())
            for e in self.store.list(self.store_mod.ENDPOINTS,
                                     namespace="default"))
        status = job.status.to_dict()
        for key in ("startTime", "completionTime", "allReplicasReadyTime"):
            status.pop(key, None)
        for c in status.get("conditions", []):
            c.pop("lastUpdateTime"), c.pop("lastTransitionTime")
        events = [(e.type, e.reason, e.message, e.count)
                  for e in self.ctl.recorder.events]
        return {"pods": pods, "endpoints": endpoints, "status": status,
                "events": events}


def _wire(restart_policy="", accelerator="", clean_pod_policy=None,
          backoff_limit=None, **replicas) -> dict:
    job = jtestutil.new_tpujob(name="arc", accelerator=accelerator,
                               **replicas)
    for spec in job.spec.replica_specs.values():
        spec.restart_policy = restart_policy
    job.spec.run_policy.clean_pod_policy = clean_pod_policy
    job.spec.run_policy.backoff_limit = backoff_limit
    wire = job.to_dict()
    wire["metadata"].pop("uid")
    wire["metadata"].pop("creationTimestamp", None)
    return wire


# Steps: None = one sync; (pod, phase[, exit code[, restart count]]).
ARCS = {
    "exit-137-restarts-in-place": (
        _wire(worker=2, restart_policy="ExitCode"),
        [None, ("arc-worker-0", "Running"), ("arc-worker-1", "Running"),
         None, ("arc-worker-1", "Failed", 137), None, None,
         ("arc-worker-1", "Running"), None,
         ("arc-worker-0", "Succeeded", 0), ("arc-worker-1", "Succeeded", 0),
         None, None]),
    "exit-1-fails-the-job": (
        _wire(worker=2, restart_policy="ExitCode"),
        [None, ("arc-worker-0", "Running"), ("arc-worker-1", "Running"),
         None, ("arc-worker-0", "Failed", 1), None, None]),
    "clean-pod-running": (
        _wire(chief=1, worker=2, ps=1, clean_pod_policy="Running"),
        [None, ("arc-chief-0", "Running"), ("arc-worker-0", "Running"),
         ("arc-worker-1", "Running"), ("arc-ps-0", "Running"), None,
         ("arc-worker-1", "Succeeded", 0), ("arc-chief-0", "Succeeded", 0),
         None, None]),
    "clean-pod-all": (
        _wire(chief=1, worker=2, ps=1, clean_pod_policy="All"),
        [None, ("arc-chief-0", "Running"), ("arc-worker-0", "Running"),
         ("arc-worker-1", "Running"), ("arc-ps-0", "Running"), None,
         ("arc-chief-0", "Succeeded", 0), None, None]),
    "clean-pod-none": (
        _wire(chief=1, worker=2, ps=1, clean_pod_policy="None"),
        [None, ("arc-chief-0", "Running"), ("arc-worker-0", "Running"),
         None, ("arc-chief-0", "Succeeded", 0), None, None]),
    "backoff-limit": (
        _wire(worker=2, restart_policy="OnFailure", backoff_limit=2),
        [None, ("arc-worker-0", "Running", None, 1),
         ("arc-worker-1", "Running"), None,
         ("arc-worker-1", "Running", None, 1), None, None]),
    "worker-failure-never": (
        _wire(worker=3, ps=1),
        [None, ("arc-worker-0", "Running"), ("arc-worker-2", "Failed", 2),
         None, None]),
    "slice-v5p-32": (
        _wire(chief=1, worker=4, ps=1, evaluator=1, accelerator="v5p-32"),
        [None, ("arc-worker-0", "Running"), None]),
    "slice-v5e-8": (
        _wire(worker=1, accelerator="v5e-8", restart_policy="ExitCode"),
        [None, ("arc-worker-0", "Failed", 143), None, None,
         ("arc-worker-0", "Succeeded", 0), None]),
}


def _run(world: World, wire: dict, steps) -> list:
    world.submit(wire)
    seen = []
    for step in steps:
        if step is None:
            world.sync()
            seen.append(world.observed())
        else:
            world.set_phase(*step)
    return seen


@pytest.mark.parametrize("arc", sorted(ARCS))
def test_controller_arcs_match(arc):
    wire, steps = ARCS[arc]
    want = _run(World(port=False), wire, steps)
    got = _run(World(port=True), wire, steps)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (arc, i)


def test_arcs_reach_their_outcomes():
    """The arcs above do what their names say (both planes agree, so one
    side is enough)."""
    outcomes = {}
    for arc, (wire, steps) in ARCS.items():
        world = World(port=True)
        last = _run(world, wire, steps)[-1]
        outcomes[arc] = (
            [c["type"] for c in last["status"]["conditions"]
             if c["status"] == "True"],
            sorted(last["pods"]),
            sum(n for _, reason, _, n in last["events"]
                if reason == "SuccessfulCreatePod"))
    assert outcomes["exit-137-restarts-in-place"] == (
        ["Created", "Succeeded"], ["arc-worker-0", "arc-worker-1"], 3)
    assert outcomes["exit-1-fails-the-job"][0] == ["Created", "Failed"]
    assert outcomes["clean-pod-running"][1] == ["arc-chief-0",
                                                "arc-worker-1"]
    assert outcomes["clean-pod-all"][1] == []
    assert outcomes["clean-pod-none"][1] == [
        "arc-chief-0", "arc-ps-0", "arc-worker-0", "arc-worker-1"]
    assert outcomes["backoff-limit"][0] == ["Created", "Failed"]
    assert outcomes["worker-failure-never"][0] == ["Created", "Failed"]
    # Recreated and done with no Running phase seen: Restarting stays.
    assert outcomes["slice-v5e-8"] == (["Created", "Restarting",
                                        "Succeeded"], ["arc-worker-0"], 2)


@pytest.mark.parametrize("jax_accel", sorted(SAME_HOSTS))
def test_gpus_stamped_where_tpus_are(jax_accel):
    wire = _wire(chief=1, worker=2, ps=1, evaluator=1,
                 accelerator=jax_accel)
    jworld, tworld = World(port=False), World(port=True)
    for world in (jworld, tworld):
        world.submit(wire)
        world.sync()
    per_host = str(parse_accelerator(SAME_HOSTS[jax_accel])
                   .devices_per_host)
    jpods, tpods = jworld.pods(), tworld.pods()
    assert sorted(tpods) == sorted(jpods) and len(tpods) == 5
    for name, jpod in jpods.items():
        tpod = tpods[name]
        jres = jpod.spec.containers[0].resources
        tres = tpod.spec.containers[0].resources
        assert (tconst.RESOURCE_GPU in tres) == (jconst.RESOURCE_TPU in jres)
        assert jconst.RESOURCE_TPU not in tres
        if tconst.RESOURCE_GPU in tres:
            assert tres[tconst.RESOURCE_GPU] == per_host
        assert [(t.key, t.operator) for t in tpod.spec.tolerations] == [
            (tconst.RESOURCE_GPU, t.operator)
            for t in jpod.spec.tolerations
            if t.key == jconst.RESOURCE_TPU]
        env = tpod.spec.containers[0].env
        assert not [k for k in env if k.startswith(("JAX_", "TPU_",
                                                    "MEGASCALE_"))]
    stamped = sorted(n for n, p in tpods.items()
                     if tconst.RESOURCE_GPU in p.spec.containers[0].resources)
    assert stamped == ["arc-worker-0", "arc-worker-1"]


def test_template_gpu_request_is_kept():
    """A template that already declares GPUs keeps its own count, as a
    TPU template keeps its chips."""
    wire = _wire(worker=1, accelerator="v5e-8")
    container = wire["spec"]["replicaSpecs"]["worker"]["template"]["spec"][
        "containers"][0]
    container["resources"] = {tconst.RESOURCE_GPU: "2"}
    world = World(port=True)
    world.submit(wire)
    world.sync()
    pod = world.pods()["arc-worker-0"]
    assert pod.spec.containers[0].resources == {tconst.RESOURCE_GPU: "2"}


# Each operator flag with the flags it requires.
PLANE_FLAGS = {
    "enable_gang_scheduling": {},
    "enable_slice_health": {"enable_gang_scheduling": True},
    "enable_ckpt_coordination": {},
    "enable_tenant_queues": {"enable_gang_scheduling": True},
    "enable_serving": {},
    "enable_elastic": {"enable_gang_scheduling": True},
    "enable_serving_autoscaler": {"enable_gang_scheduling": True,
                                  "enable_serving": True,
                                  "enable_elastic": True},
}
# Every plane at once: the cross-plane wiring (barrier acks poke
# admission, health drains through the barrier, the autoscaler feeds the
# resize signals, the data plane's drain window gates admission).
EVERY_PLANE = "every-plane"
PLANE_FLAGS[EVERY_PLANE] = {flag: True for flag in list(PLANE_FLAGS)}
# The plane each flag builds (elastic resize is a pass of the gang).
PLANE_OF = {"enable_gang_scheduling": "gang", "enable_slice_health": "health",
            "enable_ckpt_coordination": "ckpt",
            "enable_tenant_queues": "quota", "enable_serving": "serving",
            "enable_elastic": "gang",
            "enable_serving_autoscaler": "autoscaler"}
INVALID_FLAGS = (
    {"enable_tenant_queues": True},
    {"enable_slice_health": True},
    {"enable_elastic": True},
    {"enable_serving_autoscaler": True, "enable_serving": True,
     "enable_gang_scheduling": True},
)


def _planes(op):
    """Which planes an operator built and how they are wired."""
    gang = op.controller.engine.gang
    return {
        "gang": gang is not None and (gang.total_chips, gang.fairness,
                                      gang.aging_seconds, gang.elastic,
                                      gang.preemption),
        "quota": op.quota is not None,
        "ckpt": op.ckpt is not None,
        "serving": op.serving is not None,
        "health": op.health is not None and op.health.default_grace_seconds,
        "autoscaler": (op.autoscaler is not None
                       and op.autoscaler.interval_seconds),
        "gang_ckpt": gang is not None and gang.ckpt is not None,
        "gang_quota": gang is not None and gang.quota is not None,
        "ckpt_acks_readmit": (op.ckpt is not None and gang is not None
                              and op.ckpt.on_ack == gang.readmit),
        "controller_ckpt": op.controller.ckpt is not None,
        "controller_serving": op.controller.serving is not None,
        "gang_config": op.controller.engine.config.enable_gang_scheduling,
        "health_ckpt": op.health is not None and op.health.ckpt is not None,
        "resize_signals": (gang is not None and op.autoscaler is not None
                           and gang.resize_signals == op.autoscaler.signals
                           and op.autoscaler.gang is gang),
        "drain_window": (gang is not None
                         and gang.draining_provider
                         == op.backend.draining_gang_groups
                         and op.backend.on_gang_drained == gang.readmit),
    }


@pytest.mark.parametrize("flag", sorted(PLANE_FLAGS))
def test_flags_build_the_planes_jax_builds(flag):
    kwargs = dict(PLANE_FLAGS[flag], total_chips=16,
                  health_drain_grace_seconds=2.5,
                  autoscale_interval_seconds=0.5)
    if flag != EVERY_PLANE:
        kwargs[flag] = True
    built = []
    for cls in (JOperator, Operator):
        op = cls.local(workdir=REPO_ROOT, **kwargs)
        try:
            built.append(_planes(op))
        finally:
            op.stop()
    assert built[1] == built[0]
    for on in PLANE_FLAGS[flag] if flag == EVERY_PLANE else (flag,):
        assert built[1][PLANE_OF[on]]
    if flag == EVERY_PLANE:
        assert all(built[1].values()), built[1]
    for bad in INVALID_FLAGS:
        errors = []
        for cls in (JOperator, Operator):
            with pytest.raises(ValueError) as err:
                cls(backend=None, **bad)
            errors.append(str(err.value))
        assert errors[1] == errors[0]


def test_operator_without_flags_builds_the_gpu_controller():
    op = Operator(backend=None)
    try:
        assert isinstance(op.controller, GPUJobController)
        assert op.controller.engine.gang is None
    finally:
        op.stop()
