"""Pod/Endpoint control: the engine's only write path, and its test seam.

Reference: vendor/.../controller.v1/control/pod_control.go:51-64
(PodControlInterface), service_control.go, and the Fake* variants the unit
tests lean on (pod_control.go:191, service_control.go:137). Creates stamp
controller owner references; every mutation emits an event.
"""

from __future__ import annotations

import abc
from typing import List, Optional

from tf_operator_tpu_torch.api.types import Endpoint, OwnerReference, Pod, TPUJob


def controller_owner_ref(job: TPUJob) -> OwnerReference:
    """Reference GenOwnerReference (common/job_controller.go:194-206)."""
    return OwnerReference(api_version=job.api_version, kind=job.kind,
                          name=job.metadata.name, uid=job.metadata.uid,
                          controller=True)


class PodControl(abc.ABC):
    @abc.abstractmethod
    def create_pod(self, namespace: str, pod: Pod, job: TPUJob) -> None:
        ...

    @abc.abstractmethod
    def delete_pod(self, namespace: str, name: str, job: TPUJob) -> None:
        ...


class EndpointControl(abc.ABC):
    @abc.abstractmethod
    def create_endpoint(self, namespace: str, endpoint: Endpoint,
                        job: TPUJob) -> None:
        ...

    @abc.abstractmethod
    def delete_endpoint(self, namespace: str, name: str, job: TPUJob) -> None:
        ...


class FakePodControl(PodControl):
    """Records intents instead of mutating a cluster; can inject errors
    (reference FakePodControl, control/pod_control.go:191)."""

    def __init__(self):
        self.templates: List[Pod] = []
        self.delete_pod_names: List[str] = []
        self.create_error: Optional[Exception] = None
        self.delete_error: Optional[Exception] = None

    def create_pod(self, namespace: str, pod: Pod, job: TPUJob) -> None:
        if self.create_error is not None:
            raise self.create_error
        pod.metadata.namespace = namespace
        pod.metadata.owner_references = [controller_owner_ref(job)]
        self.templates.append(pod)

    def delete_pod(self, namespace: str, name: str, job: TPUJob) -> None:
        if self.delete_error is not None:
            raise self.delete_error
        self.delete_pod_names.append(name)

    def clear(self) -> None:
        self.templates = []
        self.delete_pod_names = []


class FakeEndpointControl(EndpointControl):
    def __init__(self):
        self.templates: List[Endpoint] = []
        self.delete_endpoint_names: List[str] = []
        self.create_error: Optional[Exception] = None

    def create_endpoint(self, namespace: str, endpoint: Endpoint,
                        job: TPUJob) -> None:
        if self.create_error is not None:
            raise self.create_error
        endpoint.metadata.namespace = namespace
        endpoint.metadata.owner_references = [controller_owner_ref(job)]
        self.templates.append(endpoint)

    def delete_endpoint(self, namespace: str, name: str, job: TPUJob) -> None:
        self.delete_endpoint_names.append(name)
