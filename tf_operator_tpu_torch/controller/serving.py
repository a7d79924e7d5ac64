"""ServingManager: control-plane wiring for the serving plane (port of
tf_operator_tpu/controller/serving.py, copied).

Gated behind ``--enable-serving`` (operator.py). What the control plane
actually does for a serving gang is deliberately small — the serving
data path lives in tf_operator_tpu_torch/serve and rides subsystems that
already exist:

- **admission**: serving gangs admit through the ordinary SliceGroup
  gang scheduler (serving replicas hold chips like workers — the
  engine stamps nvidia.com/gpu resources/tolerations for the role);
- **QoS**: per-tenant request fairness reuses the TenantQueue handle —
  this manager renders each TenantQueue in the job's namespace into a
  lane weight (the backing ClusterQueue's nominal chips) so request
  fair share follows chip fair share (docs/quota.md);
- **drain**: a drain mid-traffic is a slice-health drain behind a
  save-before-evict barrier; the serving worker's "save" is re-spooling
  its in-flight sequences (serve/worker.py), so eviction drops zero
  requests;
- **env**: the job's ServingPolicy is rendered into serving-role pods
  at create time (bootstrap_env below), OUTSIDE the bootstrap hash —
  a policy edit or quota-weight change must not restart live replicas.

Without the flag, none of this runs and the ``serving`` role is inert:
its pods are reconciled like any other replica type, byte-identical to
a generic role (pinned by the control test in tests/test_serving.py).

Role-policy note (docs/rl.md): the serving role's former special cases
— chip stamping, bootstrap-hash membership, barrier gating — are now
resolved through ``api/types.effective_role_policy``, whose DEFAULTS
for ``serving`` (chipConsuming=True, disruptionClass=barrier,
dataPlane=False) reproduce the old hardcoded behavior exactly; a
RolePolicy on the serving replica spec can override them like any
other role's.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import ReplicaType, ServingPolicy, TPUJob
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.serving")


def job_serving_policy(job: TPUJob) -> Optional[ServingPolicy]:
    policy = job.spec.run_policy.serving_policy
    if policy is None or not policy.enabled:
        return None
    return policy


class ServingManager:
    def __init__(self, store: Store, recorder=None,
                 namespace: Optional[str] = None):
        self.store = store
        self.recorder = recorder
        self.namespace = namespace

    def bootstrap_env(self, job: TPUJob, rtype: str) -> Dict[str, str]:
        """Serving env for a pod being created NOW; empty for non-serving
        replica types and for jobs without an enabled ServingPolicy."""
        if rtype.lower() != ReplicaType.SERVING:
            return {}
        policy = job_serving_policy(job)
        if policy is None:
            return {}
        env = {
            constants.ENV_SERVE_SPOOL: policy.spool_directory,
            constants.ENV_SERVE_SLOTS: str(policy.max_batch_slots),
            constants.ENV_SERVE_MAX_QUEUE: str(policy.max_queue_depth),
            constants.ENV_SERVE_MAX_TOKENS: str(
                policy.max_tokens_per_request),
        }
        # The weight derivation scans TenantQueues + their backing
        # ClusterQueues per serving-pod create — attributable store
        # cost inside the sync, so it gets its own child span.
        with trace_mod.span("serving.tenant_weights"):
            weights = self.tenant_weights(job.metadata.namespace)
        if weights:
            env[constants.ENV_SERVE_TENANT_WEIGHTS] = ",".join(
                f"{name}={weight}"
                for name, weight in sorted(weights.items()))
        return env

    def tenant_weights(self, namespace: str) -> Dict[str, int]:
        """TenantQueue name -> QoS lane weight. The weight is the
        backing ClusterQueue's nominal chip count (floored at 1 so a
        zero-quota queue still gets a lane): the fairness knob the
        cluster operator already maintains for chip admission doubles
        as the request-level fairness knob. Queues whose ClusterQueue
        is missing weigh 1."""
        weights: Dict[str, int] = {}
        try:
            queues = self.store.list(store_mod.TENANTQUEUES,
                                     namespace=namespace)
        except Exception:
            log.debug("tenant-weight listing failed", exc_info=True)
            return weights
        for tq in queues:
            weight = 1
            cq = self.store.try_get(store_mod.CLUSTERQUEUES, "",
                                    tq.spec.cluster_queue)
            if cq is not None:
                weight = max(1, cq.spec.nominal_chips)
            weights[tq.metadata.name] = weight
        return weights
