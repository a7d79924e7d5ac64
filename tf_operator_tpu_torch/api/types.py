"""TPUJob API types.

TPU-native rebuild of the TFJob CRD object model:

- reference pkg/apis/tensorflow/v1/types.go:27-108 (TFJob/TFJobSpec, replica
  type constants PS/Worker/Chief/Master/Evaluator)
- reference vendor/.../kubeflow/common/pkg/apis/common/v1/types.go:24-204
  (ReplicaSpec, JobStatus, JobCondition, RunPolicy, RestartPolicy,
  CleanPodPolicy, SchedulingPolicy)

Differences are deliberate and TPU-first:

- ``TPUJobSpec.slice`` declares accelerator type / slice topology / slice
  count so the scheduler can do ICI-topology-aware gang placement (the
  reference had no device topology concept; Volcano PodGroups were shape
  blind).
- Replica env bootstrap targets ``jax.distributed`` (coordinator + worker
  ranks) instead of TF_CONFIG; see tf_operator_tpu_torch/bootstrap/.
- Pods model *processes* (command/env/ports), so the same engine drives a
  subprocess backend locally and a real cluster backend in deployment.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from dataclasses import field
from typing import Dict, List, Optional, Union

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.serde import ApiObject


# ---------------------------------------------------------------------------
# Replica types (reference: types.go:73-92)
# ---------------------------------------------------------------------------

class ReplicaType:
    """Replica roles. Keys in TPUJobSpec.replica_specs (normalized lowercase).

    The reference camel-cased these ("Worker"); we canonicalize to lowercase
    on defaulting, mirroring setTypeNamesToCamelCase (defaults.go:70-89).
    """

    CHIEF = "chief"
    MASTER = "master"
    WORKER = "worker"
    PS = "ps"
    EVALUATOR = "evaluator"
    # TPU extension (tf_operator_tpu_torch/serve, docs/serving.md): an online-
    # inference replica. Holds chips like a worker (it runs the model's
    # decode path on the slice) but never joins a jax.distributed world
    # — each serving replica is an independent model server behind the
    # shared request spool. No reference analog (TFJob had no serving
    # workload kind).
    SERVING = "serving"
    # TPU extension (docs/rl.md): an RL actor — a CPU-only replica that
    # generates experience for the job's learner gang (Podracer-style
    # actor–learner topology). Never joins the jax.distributed world and
    # holds no chips; typically carries a RolePolicy making it freely
    # preemptible and elastically resizable. No reference analog.
    ACTOR = "actor"

    ALL = (CHIEF, MASTER, WORKER, PS, EVALUATOR, SERVING, ACTOR)


def is_chief_or_master(rtype: str) -> bool:
    """Reference: pkg/apis/tensorflow/v1/util.go:22-27."""
    return rtype.lower() in (ReplicaType.CHIEF, ReplicaType.MASTER)


def is_worker(rtype: str) -> bool:
    return rtype.lower() == ReplicaType.WORKER


def is_evaluator(rtype: str) -> bool:
    return rtype.lower() == ReplicaType.EVALUATOR


def is_serving(rtype: str) -> bool:
    return rtype.lower() == ReplicaType.SERVING


# ---------------------------------------------------------------------------
# Policies (reference: common/v1/types.go:107-204, tensorflow/v1/common.go)
# ---------------------------------------------------------------------------

class RestartPolicy:
    ALWAYS = "Always"
    ON_FAILURE = "OnFailure"
    NEVER = "Never"
    # Restart decision depends on the container exit code; retryable codes
    # restart the replica in place (same index), permanent codes fail it.
    EXIT_CODE = "ExitCode"

    ALL = (ALWAYS, ON_FAILURE, NEVER, EXIT_CODE)


class CleanPodPolicy:
    ALL = "All"
    RUNNING = "Running"
    NONE = "None"


class SuccessPolicy:
    """Reference: pkg/apis/tensorflow/v1/common.go:17-23."""

    DEFAULT = ""          # chief (or worker-0 when chiefless) decides
    ALL_WORKERS = "AllWorkers"


class JobConditionType:
    CREATED = "Created"
    # TPU extension (controller/quota.py): the job's gang is held by
    # tenant-queue quota, not by physical capacity. Flips to status
    # False on admission; no reference analog (the reference had no
    # admission control of its own).
    QUEUED = "Queued"
    # TPU extension (controller/ckpt.py): a save-before-evict barrier is
    # in flight for this job's gang — a planned disruption (drain or
    # quota reclaim) is waiting for the final checkpoint acks before
    # evicting. Flips to status False on full-gang ack or barrier
    # timeout. No reference analog.
    CHECKPOINT_BARRIER = "CheckpointBarrier"
    # TPU extension (runtime/retry.py ControlPlaneHealth): the
    # operator's API server has been unreachable past the degraded
    # threshold — reconciling continues, but new drains/reclaims/
    # preemptions are deferred until it answers again (flips to status
    # False on recovery). No reference analog.
    CONTROLPLANE_DEGRADED = "ControlPlaneDegraded"
    # TPU extension (controller/gang.py resize pass, docs/elastic.md):
    # an elastic resize (grow into idle capacity, or shrink under
    # quota-reclaim/maintenance pressure) has been applied and the gang
    # is restarting into the new world. Flips to status False once the
    # gang is fully up at the new size. No reference analog.
    RESIZING = "Resizing"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class ConditionStatus:
    TRUE = "True"
    FALSE = "False"
    UNKNOWN = "Unknown"


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


# ---------------------------------------------------------------------------
# Object metadata (subset of K8s ObjectMeta the engine actually uses)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OwnerReference(ApiObject):
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = True


@dataclasses.dataclass
class ObjectMeta(ApiObject):
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: Optional[_dt.datetime] = None
    deletion_timestamp: Optional[_dt.datetime] = None
    # Opaque CAS token (K8s API conventions): compared for equality,
    # never ordered or parsed. The local Store issues ints; the kube
    # informer mirror preserves the server's string verbatim.
    resource_version: Union[int, str] = 0
    owner_references: List[OwnerReference] = field(default_factory=list)

    def controller_ref(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None


# ---------------------------------------------------------------------------
# Pod model (process spec; subset of core/v1 Pod the framework needs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Container(ApiObject):
    """One process in a pod. ``command`` is the argv the runtime execs.

    ``image`` is carried for cluster backends; the local subprocess backend
    ignores it. The bootstrap layer injects env into the container whose
    name is constants.DEFAULT_CONTAINER_NAME (reference: the "tensorflow"
    container, defaults.go:36-58).
    """

    name: str = constants.DEFAULT_CONTAINER_NAME
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    ports: Dict[str, int] = field(default_factory=dict)  # name -> port
    resources: Dict[str, str] = field(default_factory=dict)
    working_dir: str = ""


@dataclasses.dataclass
class Toleration(ApiObject):
    """core/v1 Toleration subset the binder/taint machinery needs.

    Immutable after pod creation (K8s semantics), so the controller
    stamps it at CREATE time — on GKE a bound TPU pod without the
    ``google.com/tpu`` toleration is evicted by the nodepool taint
    manager even though the binder placed it correctly."""

    key: str = ""
    operator: str = "Exists"       # Exists|Equal
    value: str = ""
    effect: str = ""               # ""=all, NoSchedule|NoExecute|...
    toleration_seconds: Optional[int] = None


@dataclasses.dataclass
class PodSpec(ApiObject):
    containers: List[Container] = field(default_factory=list)
    restart_policy: str = RestartPolicy.NEVER
    scheduler_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    # Taints this pod tolerates (core/v1). Gang worker pods get the
    # google.com/tpu toleration stamped at create time
    # (tpu_controller.set_cluster_spec) — GKE TPU nodepools taint their
    # nodes with the resource name.
    tolerations: List[Toleration] = field(default_factory=list)
    # Which node agent runs this pod. Empty = unscheduled; agents claim
    # pending pods by CAS-ing their own name in (pull scheduling — the
    # kube-scheduler binding analog for the served control plane).
    node_name: str = ""
    # Host directory the node-agent relay shares with this pod's
    # containers (docs/node-agent.md). When set, the kube renderer
    # mounts it as a hostPath volume at the same path in every
    # container, and TPUJOB_PREEMPT_FILE / TPUJOB_CKPT_FILE env point
    # into it (relay-token-keyed; runtime/relay.py). Empty = no relay
    # (the local backend injects its own file paths at spawn time).
    relay_dir: str = ""

    def container(self, name: str) -> Optional[Container]:
        for c in self.containers:
            if c.name == name:
                return c
        return None


@dataclasses.dataclass
class ContainerStatus(ApiObject):
    name: str = ""
    state: str = ""                 # Waiting|Running|Terminated
    exit_code: Optional[int] = None
    restart_count: int = 0
    message: str = ""


@dataclasses.dataclass
class PodStatus(ApiObject):
    phase: str = PodPhase.PENDING
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    start_time: Optional[_dt.datetime] = None
    host: str = ""
    message: str = ""
    # Where the runtime captured this pod's combined stdout/stderr (the
    # kubelet-log analog the SDK's get_logs reads).
    log_path: str = ""
    # Host ports the running node allocated for this pod (name -> port);
    # "coordinator" is the jax.distributed rendezvous port. Peers resolve
    # cluster DNS names to (status.host, status.ports[...]) through the
    # control plane instead of kube-dns.
    ports: Dict[str, int] = field(default_factory=dict)
    # Set by the data plane the moment a gang-gated pod is released past
    # admission, BEFORE its processes spawn. Closes the eviction race:
    # gang preemption treats a released-but-not-yet-Running pod as
    # occupying chips (gang.py _pods_occupying), so a preemptor can
    # never be admitted into the spawn window.
    gang_released: bool = False

    def container_status(self, name: str) -> Optional[ContainerStatus]:
        for cs in self.container_statuses:
            if cs.name == name:
                return cs
        return None


@dataclasses.dataclass
class PodTemplateSpec(ApiObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclasses.dataclass
class Pod(ApiObject):
    api_version: str = "v1"
    kind: str = "Pod"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclasses.dataclass
class EndpointSpec(ApiObject):
    """Discovery record for one replica (analog of the per-replica headless
    Service, reference common/service.go:277-339). Maps a stable DNS-ish
    name to the selected pod's host/ports."""

    selector: Dict[str, str] = field(default_factory=dict)
    ports: Dict[str, int] = field(default_factory=dict)


@dataclasses.dataclass
class Endpoint(ApiObject):
    api_version: str = "v1"
    kind: str = "Endpoint"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: EndpointSpec = field(default_factory=EndpointSpec)


@dataclasses.dataclass
class EventRecord(ApiObject):
    """Lifecycle event persisted to the store so clients can read it
    (K8s Event analog; the reference harness scans Events for
    FailedCreate, py/kubeflow/tf_operator/tf_job_client.py:363)."""

    api_version: str = "v1"
    kind: str = "Event"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_name: str = ""
    type: str = ""
    reason: str = ""
    message: str = ""


# ---------------------------------------------------------------------------
# Job spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchedulingPolicy(ApiObject):
    """Gang scheduling knobs (reference common/v1/types.go:193-204)."""

    min_available: Optional[int] = None
    queue: str = ""
    min_resources: Dict[str, str] = field(default_factory=dict)
    priority_class: str = ""


@dataclasses.dataclass
class HealthPolicy(ApiObject):
    """Slice-health / auto-repair knobs (controller/health.py).

    No reference analog: the reference delegated node lifecycle to the
    cluster (kubelet NotReady taints, external drain tooling). TPU gangs
    need operator-owned handling — one degraded chip stalls the whole
    gang, so the unit of repair is the slice, not the pod.

    enabled:               opt this job into gang drain/rebind when a
                           node hosting it degrades (cordoning of
                           maintenance-pending nodes is operator-wide
                           and independent of any job's policy).
    drain_grace_seconds:   observed-degraded to gang-evict delay (a
                           checkpoint window); None = the operator's
                           --health-drain-grace-seconds default.
    handle_maintenance:    react to advance maintenance notices
                           (MaintenancePending). Off = drain only on
                           hard signals (NotReady, TerminationScheduled).
    prefer_spare_capacity: steer this job's (re)binds away from
                           maintenance-pending nodes while they are
                           still schedulable.
    """

    enabled: bool = False
    drain_grace_seconds: Optional[float] = None
    handle_maintenance: bool = True
    prefer_spare_capacity: bool = True


@dataclasses.dataclass
class CheckpointPolicy(ApiObject):
    """Checkpoint-coordination knobs (controller/ckpt.py).

    No reference analog: the reference delegated checkpoints entirely to
    user containers (SURVEY §5), so a drain or quota reclaim threw away
    every step since the user's last periodic save. With this policy the
    control plane turns every PLANNED disruption into a save-then-evict
    barrier and every rebind into a restore (docs/checkpoint.md).

    enabled:                 opt this job into coordinated checkpoints.
    directory:               checkpoint root the training loop saves to /
                             restores from (rendered into pod env as
                             TPUJOB_CKPT_DIR).
    interval_steps:          periodic-save cadence in optimizer steps
                             (None = no step-based cadence).
    interval_seconds:        periodic-save cadence in wall seconds
                             (None = no time-based cadence).
    max_to_keep:             retained checkpoints (Checkpointer GC).
    barrier_timeout_seconds: how long a drain/reclaim waits for the
                             full-gang save ack before evicting anyway —
                             the barrier bounds eviction latency, never
                             blocks it forever.
    """

    enabled: bool = False
    directory: str = ""
    interval_steps: Optional[int] = None
    interval_seconds: Optional[float] = None
    max_to_keep: int = 3
    barrier_timeout_seconds: float = 30.0


@dataclasses.dataclass
class ServingPolicy(ApiObject):
    """Online-inference knobs for ``serving``-role replicas
    (controller/serving.py renders them into pod env when
    --enable-serving is on; tf_operator_tpu_torch/serve consumes them).

    No reference analog: TFJob orchestrated batch training only.

    enabled:                opt this job's serving replicas into the
                            serving plane (without it — or without the
                            operator flag — the role is inert: pods run
                            their command like any other replica type).
    spool_directory:        shared request spool root (pending/claimed/
                            done; docs/serving.md) every replica of the
                            gang can reach.
    max_batch_slots:        concurrent decode slots per replica (the KV
                            cache's batch dimension).
    max_queue_depth:        per-replica request-queue bound; submits
                            beyond it are rejected, not buffered — the
                            backpressure signal autoscaling reads off
                            serving_queue_depth.
    max_tokens_per_request: generation cap (prompt + output must fit
                            the model's max_seq_len).
    ttft_p99_slo_seconds:   optional p99 time-to-first-token target,
                            recorded in bench/status artifacts next to
                            the measured quantile (the operator never
                            throttles on it).
    tokens_per_second_slo:  optional per-replica decode-throughput
                            target, same artifact-only semantics.
    target_queue_depth_per_slice: optional autoscaler setpoint
                            (controller/autoscaler.py): desired slices =
                            ceil(total queue depth / this), clamped to
                            the elastic minSlices/maxSlices band. Unset
                            = the autoscaler ignores this job.
    scale_down_cooldown_seconds: hysteresis window for the autoscaler's
                            shrink leg — demand must sit below the
                            current size continuously this long before
                            a scale-down is proposed (scale-UP is
                            immediate; docs/serving.md).
    """

    enabled: bool = False
    spool_directory: str = ""
    max_batch_slots: int = 8
    max_queue_depth: int = 256
    max_tokens_per_request: int = 64
    ttft_p99_slo_seconds: Optional[float] = None
    tokens_per_second_slo: Optional[float] = None
    target_queue_depth_per_slice: Optional[int] = None
    scale_down_cooldown_seconds: float = 60.0


class DisruptionClass:
    """How the control plane may disrupt pods of a role (RolePolicy).

    BARRIER: planned disruptions open the save-before-evict checkpoint
             barrier and wait for the gang's acks before evicting
             (controller/ckpt.py) — the learner/worker default.
    EVICT:   pods may be evicted individually at any time with no
             barrier, no drain episode, and no world restart — the
             actor-pool semantics (the rest of the gang keeps running).
    IGNORE:  the operator never disrupts these pods itself (health
             drains skip them); only job teardown removes them.
    """

    BARRIER = "barrier"
    EVICT = "evict"
    IGNORE = "ignore"

    ALL = (BARRIER, EVICT, IGNORE)


@dataclasses.dataclass
class RolePolicy(ApiObject):
    """Per-replica-role scheduling/elasticity/QoS policy (docs/rl.md).

    No reference analog: every TFJob knob was job-global. Heterogeneous
    gangs (RL actor–learner, ROADMAP item 4) need per-role rules — the
    job-global RunPolicy knobs remain the defaults that this policy
    overrides for one role. Unset fields resolve to the role's
    historical behavior (api/types.py effective_role_policy), so a job
    with no rolePolicy is byte-identical to one from before this field
    existed.

    chip_consuming:   does this role hold TPU chips? Drives the
                      google.com/tpu resource/toleration stamping and
                      slice placement. None = derived from the role
                      (worker/serving hold chips; everything else not).
    preemptible:      advisory QoS marker: this role tolerates being
                      disrupted freely (surfaced in status/docs; the
                      enforcement lever is disruption_class).
    min_replicas:     elastic floor for the role's replica count. With
                      max_replicas it opts the role into replica-count
                      resizes (gang.py resize_role): no bootstrap-hash
                      change, no world restart — only for roles that
                      resolve chip_consuming=False (chip holders resize
                      in whole slices via slice.minSlices/maxSlices).
    max_replicas:     elastic ceiling for the role's replica count.
    disruption_class: see DisruptionClass. "" = derived from the role
                      (worker/serving ride the barrier; the rest
                      default to plain eviction).
    """

    chip_consuming: Optional[bool] = None
    preemptible: Optional[bool] = None
    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    disruption_class: str = ""


@dataclasses.dataclass
class RunPolicy(ApiObject):
    """Reference common/v1/types.go:107-148."""

    clean_pod_policy: Optional[str] = None
    ttl_seconds_after_finished: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    backoff_limit: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None
    # TPU extension: maintenance-aware slice health (controller/health.py).
    health_policy: Optional[HealthPolicy] = None
    # TPU extension: save-before-evict barriers + restore-with-identity
    # (controller/ckpt.py).
    checkpoint_policy: Optional[CheckpointPolicy] = None
    # TPU extension: online-inference serving knobs for serving-role
    # replicas (controller/serving.py, tf_operator_tpu_torch/serve).
    serving_policy: Optional[ServingPolicy] = None


@dataclasses.dataclass
class ReplicaSpec(ApiObject):
    """Reference common/v1/types.go:24-55."""

    replicas: Optional[int] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    restart_policy: str = ""
    # TPU extension: per-role scheduling/elasticity/QoS overrides
    # (docs/rl.md). None = the role behaves exactly as it always has.
    role_policy: Optional[RolePolicy] = None


@dataclasses.dataclass
class TPUSliceSpec(ApiObject):
    """TPU slice topology request — first-class in the TPU-native API.

    accelerator: e.g. "v5p-32", "v5e-16", "v4-8" (chips = suffix).
    topology:    optional explicit ICI mesh, e.g. "2x2x4"; derived from the
                 accelerator when omitted (bootstrap/topology.py).
    num_slices:  >1 = multislice over DCN (megascale). For an elastic gang
                 this is the CURRENT/desired size, owned by the resize
                 pass once minSlices/maxSlices opt in.
    min_slices:  elastic floor (docs/elastic.md): the control plane may
                 shrink the gang down to this many slices under quota
                 reclaim or maintenance pressure instead of displacing
                 it wholesale. None = not elastic-shrinkable.
    max_slices:  elastic ceiling: the control plane may grow the gang
                 into idle capacity up to this many slices. None = not
                 elastic-growable. Both knobs require an accelerator
                 (resizing is defined in whole slices) and take effect
                 only under --enable-elastic.
    """

    accelerator: str = ""
    topology: str = ""
    num_slices: int = 1
    min_slices: Optional[int] = None
    max_slices: Optional[int] = None


@dataclasses.dataclass
class TPUJobSpec(ApiObject):
    """Reference pkg/apis/tensorflow/v1/types.go:47-68."""

    replica_specs: Dict[str, ReplicaSpec] = field(default_factory=dict)
    run_policy: RunPolicy = field(default_factory=RunPolicy)
    success_policy: str = SuccessPolicy.DEFAULT
    # Elastic membership: workers get sparse cluster views so membership can
    # change without restarting the world (reference enableDynamicWorker,
    # types.go:66-67).
    enable_elastic_worker: bool = False
    slice: TPUSliceSpec = field(default_factory=TPUSliceSpec)
    # Multi-tenant admission: the TenantQueue (same namespace) this job's
    # SliceGroup admits through (controller/quota.py; Kueue
    # workload-queueing analog). '' = the default queue — quota-exempt,
    # preserving pre-quota admission behavior. With tenant queues
    # disabled the field is carried but inert.
    queue_name: str = ""


# ---------------------------------------------------------------------------
# Role-policy resolution (docs/rl.md). The single place the per-role
# defaults live: every consumer (chip stamping, bootstrap-hash scope,
# barrier membership, health drains, gang admission floors) resolves a
# role through here instead of matching role names, so a new role — or
# an override on an old one — changes behavior in exactly one place.
# ---------------------------------------------------------------------------

# Roles that join the jax.distributed data plane (receive process
# ranks; bootstrap/cluster.py _RANKED_TYPES mirrors this). Everything
# else — ps/evaluator/serving/actor — is outside the learner world:
# its membership is stripped from bootstrap hashes so satellite churn
# never restarts the ranked world.
_DATA_PLANE_TYPES = (ReplicaType.CHIEF, ReplicaType.MASTER,
                     ReplicaType.WORKER)

# Historical chip holders / barrier riders. These ARE the old
# hardcoded role checks (tpu_controller chip stamping, ckpt
# _required_acks), now expressed once as resolver defaults.
_DEFAULT_CHIP_TYPES = (ReplicaType.WORKER, ReplicaType.SERVING)
_DEFAULT_BARRIER_TYPES = (ReplicaType.WORKER, ReplicaType.SERVING)


@dataclasses.dataclass(frozen=True)
class EffectiveRolePolicy:
    """A role's RolePolicy with every unset field resolved to the
    role's historical default. ``explicit``/``explicit_disruption``
    record whether the spec actually carried the override — consumers
    that relax legacy behavior (health's evict-only lane, notice-stamp
    skipping) gate on explicitness so defaulted roles keep their exact
    pre-RolePolicy treatment."""

    replica_type: str = ""
    chip_consuming: bool = False
    preemptible: bool = False
    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    disruption_class: str = DisruptionClass.EVICT
    # Spec carried a rolePolicy block at all / carried disruptionClass.
    explicit: bool = False
    explicit_disruption: bool = False
    # Role joins the ranked jax.distributed world (never overridable:
    # it is a property of what the role runs, not a policy choice).
    data_plane: bool = False

    @property
    def elastic(self) -> bool:
        """Role opted into replica-count resizes (gang.py resize_role)."""
        return (self.explicit and self.min_replicas is not None
                and self.max_replicas is not None)

    @property
    def barrier(self) -> bool:
        return self.disruption_class == DisruptionClass.BARRIER


def effective_role_policy(job: "TPUJob",
                          rtype: str) -> EffectiveRolePolicy:
    """Resolve ``rtype``'s RolePolicy against the role defaults. With
    no rolePolicy in the spec this reproduces today's behavior exactly
    (the flag-off parity contract, tests/test_rl.py)."""
    rt = rtype.lower()
    spec = job.spec.replica_specs.get(rt) or job.spec.replica_specs.get(
        rtype)
    rp = spec.role_policy if spec is not None else None
    chip_default = rt in _DEFAULT_CHIP_TYPES
    barrier_default = rt in _DEFAULT_BARRIER_TYPES
    return EffectiveRolePolicy(
        replica_type=rt,
        chip_consuming=(rp.chip_consuming
                        if rp is not None and rp.chip_consuming is not None
                        else chip_default),
        preemptible=(rp.preemptible
                     if rp is not None and rp.preemptible is not None
                     else False),
        min_replicas=rp.min_replicas if rp is not None else None,
        max_replicas=rp.max_replicas if rp is not None else None,
        disruption_class=(rp.disruption_class
                          if rp is not None and rp.disruption_class
                          else (DisruptionClass.BARRIER if barrier_default
                                else DisruptionClass.EVICT)),
        explicit=rp is not None,
        explicit_disruption=rp is not None and bool(rp.disruption_class),
        data_plane=rt in _DATA_PLANE_TYPES,
    )


def elastic_role_types(job: "TPUJob") -> List[str]:
    """Replica types that opted into replica-count elasticity (an
    explicit rolePolicy with both minReplicas and maxReplicas). Their
    cluster membership is outside every bootstrap hash — resizing them
    restarts nothing (tpu_controller._compute_bootstrap_hash)."""
    return [rt for rt in job.spec.replica_specs
            if effective_role_policy(job, rt).elastic]


# ---------------------------------------------------------------------------
# Job status (reference common/v1/types.go:56-106)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JobCondition(ApiObject):
    type: str = ""
    status: str = ConditionStatus.TRUE
    reason: str = ""
    message: str = ""
    last_update_time: Optional[_dt.datetime] = None
    last_transition_time: Optional[_dt.datetime] = None


@dataclasses.dataclass
class ReplicaStatus(ApiObject):
    active: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclasses.dataclass
class JobStatus(ApiObject):
    conditions: List[JobCondition] = field(default_factory=list)
    replica_statuses: Dict[str, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[_dt.datetime] = None
    completion_time: Optional[_dt.datetime] = None
    last_reconcile_time: Optional[_dt.datetime] = None
    # TPU-native extension (no reference analog): when every desired
    # replica first became Running/Succeeded — the latch behind the
    # pod-to-AllReplicasReady latency metric (BASELINE north star).
    all_replicas_ready_time: Optional[_dt.datetime] = None
    # Checkpoint coordination (controller/ckpt.py): the newest step every
    # checkpointing replica has durably saved (the committed step a
    # rebind restores from), and the step the CURRENT incarnation
    # actually restored from after the last disruption. None until the
    # first save / first restore.
    last_checkpoint_step: Optional[int] = None
    restored_from_step: Optional[int] = None


@dataclasses.dataclass
class TPUJob(ApiObject):
    api_version: str = constants.API_VERSION
    kind: str = constants.KIND
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TPUJobSpec = field(default_factory=TPUJobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# ---------------------------------------------------------------------------
# SliceGroup: gang-scheduling unit (reference: Volcano PodGroup,
# common/job_controller.go:218-322)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SliceGroupSpec(ApiObject):
    min_member: int = 0
    queue: str = ""
    priority_class: str = ""
    min_resources: Dict[str, str] = field(default_factory=dict)
    # TPU extension: the slice shape this gang must land on, all-or-nothing.
    slice: TPUSliceSpec = field(default_factory=lambda: TPUSliceSpec())


@dataclasses.dataclass
class SliceGroupStatus(ApiObject):
    phase: str = "Pending"  # Pending|Inqueue|Running|Unknown
    # When the group last entered Pending (set at creation and again on
    # preemption). Gang aging anchors here, so a re-queued group gets a
    # fresh backfill grace window instead of blocking instantly off its
    # old creationTimestamp.
    pending_since: Optional[_dt.datetime] = None
    # Why the slice-health controller displaced this group (e.g.
    # "MaintenancePending on node-3"); non-empty from drain until the
    # gang is fully back up. The engine rolls it into the job's
    # Restarting condition so restart-with-identity is visible on the
    # job; promotion back to Running clears it.
    displaced_reason: str = ""
    # Why the resize pass last resized this group (e.g. "shrink to 2
    # slice(s): QuotaReclaimed ..."); non-empty from the applied resize
    # until the gang is fully up at the new size. The engine rolls it
    # into the job's Resizing condition; it also serializes resizes —
    # no second resize is applied while one is settling (gang.py).
    resizing_reason: str = ""


@dataclasses.dataclass
class SliceGroup(ApiObject):
    api_version: str = constants.API_VERSION
    kind: str = "SliceGroup"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: SliceGroupSpec = field(default_factory=SliceGroupSpec)
    status: SliceGroupStatus = field(default_factory=SliceGroupStatus)


# ---------------------------------------------------------------------------
# TenantQueue / ClusterQueue: multi-tenant quota & fair-share queueing
# (controller/quota.py). Kueue LocalQueue/ClusterQueue analog, collapsed
# to the chip-count resource model the gang scheduler already admits in:
# a TenantQueue is the namespaced handle jobs reference via
# spec.queueName; a ClusterQueue carries the chip quota and cohort
# membership that decide admission *eligibility* (the gang scheduler
# still decides physical fit, the binder still places).
# ---------------------------------------------------------------------------

class ReclaimPolicy:
    """How a ClusterQueue gets its nominal quota back from cohort
    borrowers when its own workloads demand it (Kueue
    reclaimWithinCohort analog).

    NEVER:          wait for borrowers to finish voluntarily.
    LOWER_PRIORITY: reclaim only from borrowed groups with strictly
                    lower priority than the demanding group.
    ANY (default):  reclaim from any borrowed group, lowest priority /
                    youngest first.
    """

    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"
    ANY = "Any"

    ALL = (NEVER, LOWER_PRIORITY, ANY)


@dataclasses.dataclass
class TenantQueueSpec(ApiObject):
    # Name of the cluster-scoped ClusterQueue this queue admits through.
    cluster_queue: str = ""


@dataclasses.dataclass
class TenantQueueStatus(ApiObject):
    # Groups of this queue currently waiting for quota or capacity.
    pending_groups: int = 0
    # Chips currently admitted through this queue.
    admitted_chips: int = 0


@dataclasses.dataclass
class TenantQueue(ApiObject):
    api_version: str = constants.API_VERSION
    kind: str = "TenantQueue"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TenantQueueSpec = field(default_factory=TenantQueueSpec)
    status: TenantQueueStatus = field(default_factory=TenantQueueStatus)


@dataclasses.dataclass
class ClusterQueueSpec(ApiObject):
    # Chips this queue owns outright: admission below nominal is always
    # quota-eligible (physical fit permitting).
    nominal_chips: int = 0
    # Extra chips this queue may hold ABOVE nominal by borrowing idle
    # cohort capacity. None = unlimited borrowing (bounded by the
    # cohort's aggregate nominal); 0 = borrowing off.
    borrowing_limit: Optional[int] = None
    # See ReclaimPolicy; defaulted to ANY (api/defaults.py).
    reclaim_policy: str = ""
    # Queues sharing a cohort lend each other idle nominal capacity.
    # Defaulted to the queue's own name (a cohort of one = no sharing).
    cohort: str = ""


@dataclasses.dataclass
class ClusterQueueStatus(ApiObject):
    admitted_chips: int = 0
    # Portion of admitted_chips above nominal (borrowed from the cohort).
    borrowed_chips: int = 0
    pending_groups: int = 0


@dataclasses.dataclass
class ClusterQueue(ApiObject):
    """Cluster-scoped (the store files it under the reserved namespace
    '' — no user namespace owns a ClusterQueue)."""

    api_version: str = constants.API_VERSION
    kind: str = "ClusterQueue"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(
        namespace=""))
    spec: ClusterQueueSpec = field(default_factory=ClusterQueueSpec)
    status: ClusterQueueStatus = field(default_factory=ClusterQueueStatus)


# ---------------------------------------------------------------------------
# CheckpointRecord: one replica's durable-checkpoint state, reported by
# the data plane (controller/ckpt.py). The record is the ack channel of
# the save-before-evict barrier: the training loop publishes each save
# (and each barrier ack) through its node's data plane, the coordinator
# reads the gang's records to decide when eviction may proceed and what
# step a rebind restores from. Named after the pod, labeled job-name so
# the store's label index serves per-job listing. No reference analog.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointRecordStatus(ApiObject):
    # Newest step this replica has DURABLY saved (-1 = none yet).
    step: int = -1
    # Newest step the replica reported reaching (>= step); the
    # steps-lost-per-disruption accounting reads progress - committed.
    progress_step: int = -1
    # Barrier id this record acks: set when the save was forced by a
    # preemption notice (controller/ckpt.py stamps the id on the pod).
    barrier_id: str = ""
    # Where the checkpoint landed (the restore dir a rebind receives).
    directory: str = ""
    # Wall seconds the last save took (checkpoint_save_seconds metric).
    save_seconds: float = 0.0
    # Step this incarnation restored from at startup (None = cold start).
    restored_from_step: Optional[int] = None
    updated_at: Optional[_dt.datetime] = None


@dataclasses.dataclass
class CheckpointRecord(ApiObject):
    api_version: str = constants.API_VERSION
    kind: str = "CheckpointRecord"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: CheckpointRecordStatus = field(
        default_factory=CheckpointRecordStatus)


# ---------------------------------------------------------------------------
# Node: a host registered with the served control plane (kubelet-node
# analog). Agents self-register, heartbeat, and claim pending pods.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Taint(ApiObject):
    """core/v1 Taint subset the binder filters on. A NoSchedule or
    NoExecute taint excludes the node for pods that don't carry a
    matching Toleration (PreferNoSchedule stays advisory)."""

    key: str = ""
    value: str = ""
    effect: str = ""               # NoSchedule|PreferNoSchedule|NoExecute


@dataclasses.dataclass
class NodeSpec(ApiObject):
    # Address peers dial to reach pods on this node (TPU worker host IP).
    address: str = "127.0.0.1"
    # Chip capacity this node contributes to gang admission accounting.
    chips: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    # Cordoned (core/v1 Node.spec.unschedulable): the gang binder skips
    # the node and its chips leave the admission capacity.
    unschedulable: bool = False
    # core/v1 Node.spec.taints — hard placement exclusions the binder
    # honors (a bind violating them would be rejected or the pod evicted
    # by kubelet/the taint manager anyway).
    taints: List[Taint] = field(default_factory=list)


@dataclasses.dataclass
class NodeStatus(ApiObject):
    phase: str = "Ready"
    last_heartbeat: Optional[_dt.datetime] = None
    # Base URL of the node agent's log server; the API server proxies
    # pod-log reads here (kubelet log API analog).
    log_url: str = ""
    # Node conditions by type -> status ("True"/"False"/"Unknown"), the
    # core/v1 NodeCondition subset the slice-health controller keys on:
    # Ready plus degradation signals (MaintenancePending,
    # TerminationScheduled — TPU maintenance events / spot preemption
    # notices surfaced as conditions, node-problem-detector style).
    conditions: Dict[str, str] = field(default_factory=dict)
    # Allocatable cpu/memory (core/v1 Node.status.allocatable, parsed
    # from quantity strings). None = unreported — the binder skips the
    # fit check rather than rejecting every node on a sparse inventory.
    allocatable_cpu_millis: Optional[int] = None
    allocatable_memory_bytes: Optional[int] = None


@dataclasses.dataclass
class Node(ApiObject):
    api_version: str = "v1"
    kind: str = "Node"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


def gen_general_name(job_name: str, rtype: str, index: int) -> str:
    """Stable replica identity: ``{job}-{rtype}-{index}``.

    Reference: vendor/.../common/pkg/controller.v1/common/util.go:47-50.
    """
    return f"{job_name}-{rtype.lower()}-{index}"
