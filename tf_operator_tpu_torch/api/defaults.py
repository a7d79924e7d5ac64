"""Defaulting for TPUJob specs.

Reference: pkg/apis/tensorflow/v1/defaults.go:
- SetDefaults_TFJob (:92-113): replicas->1, restartPolicy->Never, port
  injection, cleanPodPolicy->Running, key canonicalization.
- setDefaultPort (:36-58): ensure the default container exposes the named
  rendezvous port.
- setTypeNamesToCamelCase (:70-89): canonicalize replica-type keys (we
  normalize to lowercase instead).
"""

from __future__ import annotations

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CleanPodPolicy,
    ClusterQueue,
    ReclaimPolicy,
    ReplicaSpec,
    RestartPolicy,
    TPUJob,
)

DEFAULT_RESTART_POLICY = RestartPolicy.NEVER
DEFAULT_REPLICAS = 1


def _set_default_port(spec: ReplicaSpec) -> None:
    """Inject the rendezvous port on the default container if absent
    (reference defaults.go:36-58)."""
    container = spec.template.spec.container(constants.DEFAULT_CONTAINER_NAME)
    if container is None:
        return
    if constants.DEFAULT_PORT_NAME not in container.ports:
        container.ports[constants.DEFAULT_PORT_NAME] = constants.DEFAULT_PORT


def _normalize_replica_type_keys(job: TPUJob) -> None:
    """Lowercase replica-type keys so 'Worker'/'WORKER'/'worker' are one type
    (reference canonicalizes to CamelCase, defaults.go:70-89)."""
    specs = job.spec.replica_specs
    normalized = {}
    for key, spec in specs.items():
        low = key.lower()
        if low in normalized:
            from tf_operator_tpu_torch.api.validation import ValidationError

            raise ValidationError([
                f"spec.replicaSpecs: duplicate replica type {low!r} "
                f"(keys differing only in case)"])
        normalized[low] = spec
    job.spec.replica_specs = normalized


def set_defaults(job: TPUJob) -> TPUJob:
    """Mutates ``job`` in place and returns it (reference defaults.go:92-113)."""
    _normalize_replica_type_keys(job)

    if job.spec.run_policy.clean_pod_policy is None:
        job.spec.run_policy.clean_pod_policy = CleanPodPolicy.RUNNING

    for spec in job.spec.replica_specs.values():
        if spec.replicas is None:
            spec.replicas = DEFAULT_REPLICAS
        if not spec.restart_policy:
            spec.restart_policy = DEFAULT_RESTART_POLICY
        _set_default_port(spec)
    return job


def set_cluster_queue_defaults(cq: ClusterQueue) -> ClusterQueue:
    """Mutates ``cq`` in place and returns it (controller/quota.py):
    a queue with no cohort is a cohort of one (no lending, no
    borrowing), and reclaim defaults to Any — borrowed capacity is a
    loan, not a grant."""
    if not cq.spec.cohort:
        cq.spec.cohort = cq.metadata.name
    if not cq.spec.reclaim_policy:
        cq.spec.reclaim_policy = ReclaimPolicy.ANY
    return cq
