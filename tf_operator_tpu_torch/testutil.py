"""Shared test fixtures: TPUJob/pod/endpoint builders (port of
tf_operator_tpu/testutil.py; the stub plugin stamps ``RANK``).

Reference: pkg/common/util/v1/testutil/ (tfjob.go:27-247 builders for every
topology/policy combo; pod.go:38-95 phase-stamped fake pods; service.go).
Shipped in-package, like the reference, so SDK/e2e tests can reuse it.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import uuid
from typing import Dict, List, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.controller.engine import JobPlugin
from tf_operator_tpu_torch.api.types import (
    Container,
    Endpoint,
    EndpointSpec,
    ContainerStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
    PodTemplateSpec,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
    gen_general_name,
)

TEST_JOB_NAME = "test-tpujob"
TEST_NAMESPACE = "default"
_seq = itertools.count()


def now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def new_pod_template(command: Optional[List[str]] = None) -> PodTemplateSpec:
    return PodTemplateSpec(
        spec=PodSpec(
            containers=[
                Container(
                    name=constants.DEFAULT_CONTAINER_NAME,
                    command=command or ["python", "-c", "pass"],
                )
            ]
        )
    )


def new_replica_spec(replicas: int,
                     restart_policy: str = "",
                     command: Optional[List[str]] = None) -> ReplicaSpec:
    return ReplicaSpec(replicas=replicas, template=new_pod_template(command),
                       restart_policy=restart_policy)


def new_tpujob(worker: int = 0,
               ps: int = 0,
               chief: int = 0,
               evaluator: int = 0,
               master: int = 0,
               actor: int = 0,
               name: str = TEST_JOB_NAME,
               namespace: str = TEST_NAMESPACE,
               command: Optional[List[str]] = None,
               accelerator: str = "") -> TPUJob:
    """Builder covering the reference's NewTFJob* matrix (testutil/tfjob.go).

    ``actor`` adds a bare actor replica spec (docs/rl.md); attach a
    RolePolicy to it yourself — the builder stamps none so role-policy
    defaults stay byte-identical to a policy-free job."""
    specs: Dict[str, ReplicaSpec] = {}
    for rtype, n in ((ReplicaType.WORKER, worker), (ReplicaType.PS, ps),
                     (ReplicaType.CHIEF, chief), (ReplicaType.EVALUATOR, evaluator),
                     (ReplicaType.MASTER, master), (ReplicaType.ACTOR, actor)):
        if n > 0:
            specs[rtype] = new_replica_spec(n, command=command)
    job = TPUJob(
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            uid=str(uuid.uuid4()),
            creation_timestamp=now(),
        ),
        spec=TPUJobSpec(replica_specs=specs,
                        slice=TPUSliceSpec(accelerator=accelerator)),
    )
    return job


def owner_ref(job: TPUJob) -> OwnerReference:
    return OwnerReference(api_version=job.api_version, kind=job.kind,
                          name=job.metadata.name, uid=job.metadata.uid,
                          controller=True)


def replica_labels(job: TPUJob, rtype: str, index: int) -> Dict[str, str]:
    return {
        constants.LABEL_GROUP_NAME: constants.GROUP,
        constants.LABEL_JOB_NAME: job.metadata.name,
        constants.LABEL_REPLICA_TYPE: rtype.lower(),
        constants.LABEL_REPLICA_INDEX: str(index),
    }


def new_pod(job: TPUJob, rtype: str, index: int,
            phase: str = PodPhase.PENDING,
            exit_code: Optional[int] = None,
            owned: bool = True) -> Pod:
    """Phase-stamped fake pod (reference testutil/pod.go:38-95)."""
    meta = ObjectMeta(
        name=gen_general_name(job.metadata.name, rtype, index),
        namespace=job.metadata.namespace,
        uid=str(uuid.uuid4()),
        labels=replica_labels(job, rtype, index),
        creation_timestamp=now(),
        resource_version=next(_seq),
    )
    if owned:
        meta.owner_references = [owner_ref(job)]
    pod = Pod(metadata=meta,
              spec=job.spec.replica_specs[rtype].template.spec.deepcopy()
              if rtype in job.spec.replica_specs else PodSpec(
                  containers=[Container()]),
              status=PodStatus(phase=phase))
    if phase in (PodPhase.RUNNING, PodPhase.SUCCEEDED, PodPhase.FAILED):
        pod.status.start_time = now()
    if exit_code is not None or phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
        code = exit_code if exit_code is not None else (
            0 if phase == PodPhase.SUCCEEDED else 1)
        pod.status.container_statuses = [ContainerStatus(
            name=constants.DEFAULT_CONTAINER_NAME, state="Terminated",
            exit_code=code)]
    return pod


def new_pod_list(job: TPUJob, rtype: str, count: int,
                 phase: str = PodPhase.PENDING, start: int = 0) -> List[Pod]:
    return [new_pod(job, rtype, i, phase=phase)
            for i in range(start, start + count)]


def set_pod_statuses(pods: List[Pod], job: TPUJob, rtype: str,
                     pending: int = 0, active: int = 0, succeeded: int = 0,
                     failed: int = 0) -> None:
    """Bulk phase stamping (reference testutil/pod.go:67 SetPodsStatuses):
    appends pods of the given phases with consecutive indices."""
    idx = len([p for p in pods
               if p.metadata.labels.get(constants.LABEL_REPLICA_TYPE) == rtype.lower()])
    for phase, n in ((PodPhase.PENDING, pending), (PodPhase.RUNNING, active),
                     (PodPhase.SUCCEEDED, succeeded), (PodPhase.FAILED, failed)):
        for _ in range(n):
            pods.append(new_pod(job, rtype, idx, phase=phase))
            idx += 1


def new_endpoint(job: TPUJob, rtype: str, index: int) -> Endpoint:
    return Endpoint(
        metadata=ObjectMeta(
            name=gen_general_name(job.metadata.name, rtype, index),
            namespace=job.metadata.namespace,
            uid=str(uuid.uuid4()),
            labels=replica_labels(job, rtype, index),
            owner_references=[owner_ref(job)],
        ),
        spec=EndpointSpec(selector=replica_labels(job, rtype, index),
                          ports={constants.DEFAULT_PORT_NAME: constants.DEFAULT_PORT}),
    )


class StubPlugin(JobPlugin):
    """In-memory JobPlugin for engine tests: observed state is whatever the
    test stuffs into .pods/.endpoints; API writes are recorded. This is the
    reference's fake-clientset + AlwaysReady informer seam
    (testutil/util.go:46-95) collapsed into one object."""

    def __init__(self, pods=None, endpoints=None):
        self.pods = list(pods or [])
        self.endpoints = list(endpoints or [])
        self.status_writes = []
        self.deleted_jobs = []
        self.cluster_spec_calls = []
        self.workqueue = None  # optionally set by tests

    def get_pods_for_job(self, job):
        return list(self.pods)

    def get_endpoints_for_job(self, job):
        return list(self.endpoints)

    def delete_job(self, job):
        self.deleted_jobs.append(job.metadata.name)

    def update_job_status(self, job, replica_specs, pods=None):
        from tf_operator_tpu_torch.controller import status as status_mod

        pods = self.pods if pods is None else pods
        w0 = status_mod.is_worker0_completed(
            job, replica_specs, pods, self.get_default_container_name())
        status_mod.update_job_status(job, replica_specs, w0,
                                     workqueue=self.workqueue)

    def update_job_status_in_api(self, job):
        self.status_writes.append(job.status.deepcopy())

    def set_cluster_spec(self, job, pod, rtype, index):
        self.cluster_spec_calls.append((rtype, index))
        container = pod.spec.container(self.get_default_container_name())
        if container is not None:
            container.env["RANK"] = str(index)


def get_condition(job: TPUJob, cond_type: str):
    for c in job.status.conditions:
        if c.type == cond_type:
            return c
    return None


def check_condition(job: TPUJob, cond_type: str, reason: str = "") -> bool:
    """Reference testutil/util.go CheckCondition: condition present, True,
    and (optionally) with the given reason."""
    c = get_condition(job, cond_type)
    if c is None or c.status != "True":
        return False
    return (not reason) or c.reason == reason


def parse_ps_worker_log(text: str):
    """(first, last) windowed loss means from a dist_mnist_ps worker log
    ('done: first=X last=Y') — the ONE parser for every suite that
    asserts async-PS convergence."""
    first = float(text.split("first=")[1].split(" ")[0])
    last = float(text.split("last=")[1].splitlines()[0])
    return first, last
