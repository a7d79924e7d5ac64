"""Generic job reconcile engine.

TPU-native rebuild of the reference's core runtime — the vendored
kubeflow/common JobController:

- ReconcileJobs master loop: common/job.go:124-343
- Pod index-slice diffing:   common/pod.go:281-408
- Endpoint reconcile:        common/service.go:206-339
- Cleanup / TTL / deadlines: common/job.go:21-47, 345-421
- Restart-with-identity + ExitCode policy + Restarting condition:
  the TF-specific override pkg/controller.v1/tensorflow/pod.go:67-163,
  folded in as the default behavior here.

The engine is deliberately cluster-agnostic: observed state comes from a
``JobPlugin`` (informer-cache analog), mutations go through Pod/Endpoint
control objects, and gang placement is delegated to an optional
``gang`` hook. It raises on errors; the controller loop catches and
requeues rate-limited, exactly like the reference's workqueue contract.
"""

from __future__ import annotations

import abc
import datetime as _dt
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CleanPodPolicy,
    Endpoint,
    EndpointSpec,
    Pod,
    PodPhase,
    ReplicaSpec,
    ReplicaStatus,
    RestartPolicy,
    TPUJob,
    JobConditionType,
    gen_general_name,
)
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.controller.control import (
    EndpointControl,
    PodControl,
)
from tf_operator_tpu_torch.controller.exit_codes import is_retryable_exit_code
from tf_operator_tpu_torch.controller.expectations import (
    ControllerExpectations,
    expectation_key,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import retry as retry_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.events import EVENT_TYPE_NORMAL, EVENT_TYPE_WARNING, Recorder
from tf_operator_tpu_torch.runtime.workqueue import RateLimitingQueue

log = logging.getLogger("tpu_operator.engine")

# Sentinel exit code meaning "no terminated default container observed"
# (reference pod.go:347-356 uses 0xbeef).
EXIT_CODE_UNSET = 0xBEEF

EXITED_WITH_CODE_REASON = "ExitedWithCode"
JOB_TERMINATED_REASON = "JobTerminated"


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


class JobPlugin(abc.ABC):
    """Job-kind-specific callbacks (reference ControllerInterface,
    common/interface.go:10-73)."""

    @abc.abstractmethod
    def get_pods_for_job(self, job: TPUJob) -> List[Pod]:
        ...

    @abc.abstractmethod
    def get_endpoints_for_job(self, job: TPUJob) -> List[Endpoint]:
        ...

    @abc.abstractmethod
    def delete_job(self, job: TPUJob) -> None:
        ...

    @abc.abstractmethod
    def update_job_status(self, job: TPUJob,
                          replica_specs: Dict[str, ReplicaSpec],
                          pods: Optional[List[Pod]] = None) -> None:
        """Roll replica tallies into job conditions (success semantics).
        ``pods`` is the engine's already-listed+claimed snapshot —
        implementations must use it instead of re-listing (one pod
        list+claim per sync); None only for standalone callers."""

    @abc.abstractmethod
    def update_job_status_in_api(self, job: TPUJob) -> None:
        """Persist job.status (reference UpdateJobStatusInApiServer)."""

    @abc.abstractmethod
    def set_cluster_spec(self, job: TPUJob, pod: Pod, rtype: str,
                         index: int) -> None:
        """Inject distributed-bootstrap env into the pod (reference
        SetClusterSpec -> TF_CONFIG; here -> jax.distributed env)."""

    def bootstrap_hash(self, job: TPUJob, rtype: str, index: int) -> str:
        """Digest of the bootstrap env set_cluster_spec would render for
        (rtype, index) NOW. Stamped on pods at creation and compared on
        every sync: a mismatch means the world this pod joined no
        longer exists (elastic resize) and it must restart into the new
        one. '' disables the check (plugins without bootstrap env)."""
        return ""

    def is_master_role(self, replica_specs: Dict[str, ReplicaSpec],
                       rtype: str, index: int) -> bool:
        """Reference tensorflow/controller.go:418-425: chief/master pods,
        or worker-0 when no chief/master type exists."""
        from tf_operator_tpu_torch.api.types import ReplicaType, is_chief_or_master

        if is_chief_or_master(rtype):
            return True
        if ReplicaType.CHIEF in replica_specs or ReplicaType.MASTER in replica_specs:
            return False
        return rtype.lower() == ReplicaType.WORKER and index == 0

    def get_default_container_name(self) -> str:
        return constants.DEFAULT_CONTAINER_NAME


class GangScheduler(abc.ABC):
    """SliceGroup lifecycle hook (reference SyncPodGroup/DeletePodGroup,
    common/job_controller.go:218-304)."""

    @abc.abstractmethod
    def sync_slice_group(self, job: TPUJob,
                         replica_specs: Dict[str, ReplicaSpec]) -> None:
        ...

    @abc.abstractmethod
    def delete_slice_group(self, job: TPUJob) -> None:
        ...

    @abc.abstractmethod
    def annotate_pod(self, job: TPUJob, pod: Pod, rtype: str) -> None:
        ...

    def displaced_reason(self, job: TPUJob) -> Optional[str]:
        """Non-empty while the job's gang is displaced by a slice-health
        drain (controller/health.py) and not yet fully back up; the
        engine rolls it into the job's Restarting condition. Schedulers
        without a health subsystem report None."""
        return None

    def quota_status(self, job: TPUJob):
        """Non-None (controller/quota.py QuotaWait) while the job's
        gang is held by tenant-queue quota; the engine rolls it into
        the job's Queued condition — or fails the job terminally when
        the wait can never end (zero-quota queue). Schedulers without
        a quota subsystem report None."""
        return None

    def resize_reason(self, job: TPUJob) -> Optional[str]:
        """Non-empty while an elastic resize (controller/gang.py,
        docs/elastic.md) has been applied to the job's gang and the new
        world has not fully settled; the engine rolls it into the job's
        Resizing condition. Schedulers without elastic resize report
        None."""
        return None


@dataclass
class EngineConfig:
    enable_gang_scheduling: bool = False
    # Idle resync period (reference controller.go:126: 15s).
    reconciler_sync_period: float = 15.0


class JobEngine:
    """The generic reconcile engine (reference JobController)."""

    def __init__(self,
                 plugin: JobPlugin,
                 pod_control: PodControl,
                 endpoint_control: EndpointControl,
                 recorder: Optional[Recorder] = None,
                 workqueue: Optional[RateLimitingQueue] = None,
                 expectations: Optional[ControllerExpectations] = None,
                 gang: Optional[GangScheduler] = None,
                 config: Optional[EngineConfig] = None,
                 ckpt=None,
                 cp_health=None):
        self.plugin = plugin
        self.pod_control = pod_control
        self.endpoint_control = endpoint_control
        self.recorder = recorder or Recorder()
        self.workqueue = workqueue or RateLimitingQueue()
        self.expectations = expectations or ControllerExpectations()
        self.gang = gang
        self.config = config or EngineConfig()
        # Optional checkpoint coordinator (controller/ckpt.py): each
        # sync rolls the save-before-evict barrier arc into the job's
        # CheckpointBarrier condition and mirrors lastCheckpointStep /
        # restoredFromStep onto the status. None = no checkpoint fields
        # ever touched.
        self.ckpt = ckpt
        # Optional ControlPlaneHealth (runtime/retry.py): control writes
        # report success/failure into it (degraded-mode tracking), and
        # each sync surfaces/clears the ControlPlaneDegraded condition.
        # None = conditions never touched, writes fail un-tracked.
        self.cp_health = cp_health
        # In-place retry for transient control-write failures: a single
        # 500 blip no longer aborts the whole sync; exhausted retries
        # still raise into the workqueue's rate-limited requeue (the
        # long-haul retry loop).
        self.retry_policy = retry_mod.DEFAULT_POLICY

    def _control_write(self, component: str, fn) -> None:
        """Run a pod/endpoint control mutation with transient-failure
        retries (runtime/retry.py), feeding degraded-mode tracking."""
        retry_mod.with_retries(fn, policy=self.retry_policy,
                               component=component,
                               health=self.cp_health)

    # ------------------------------------------------------------------
    # Master reconcile (reference common/job.go:124-343)
    # ------------------------------------------------------------------

    def reconcile_jobs(self, job: TPUJob) -> None:
        replica_specs = job.spec.replica_specs
        run_policy = job.spec.run_policy
        job_key = job.key()

        # Flight-recorder phases (runtime/trace.py): the sync's store
        # reads, gang/quota pass, replica diffing, and status writes
        # are each a child span of the sync root, so a slow sync at
        # /debug/traces says WHICH leg was slow.
        with trace_mod.span("pods.list"):
            pods = self.plugin.get_pods_for_job(job)
            endpoints = self.plugin.get_endpoints_for_job(job)
        # Change detection wants the dict form anyway (see status.diff
        # below), so capture it directly — a status deepcopy per sync
        # bought nothing over the serialized snapshot.
        old_status_dict = job.status.to_dict()

        if cond.is_finished(job.status):
            with trace_mod.span("finalize"):
                self._finalize_finished_job(job, pods)
                if job.status.to_dict() != old_status_dict:
                    self.plugin.update_job_status_in_api(job)
            return

        previous_retry = self.workqueue.num_requeues(job_key)
        active_pods = [p for p in pods if p.status.phase in
                       (PodPhase.PENDING, PodPhase.RUNNING)]
        self._record_abnormal_pods(active_pods, job)

        active = len(active_pods)
        failed = sum(1 for p in pods if p.status.phase == PodPhase.FAILED)
        total_replicas = sum(s.replicas or 0 for s in replica_specs.values())
        prev_failed = sum(rs.failed for rs in
                          job.status.replica_statuses.values())

        failure_message = ""
        job_exceeds_limit = False
        if run_policy.backoff_limit is not None:
            job_has_new_failure = failed > prev_failed
            exceeds_backoff = (job_has_new_failure
                               and active != total_replicas
                               and previous_retry + 1 > run_policy.backoff_limit)
            past_backoff = self._past_backoff_limit(job, replica_specs, pods)
            if exceeds_backoff or past_backoff:
                job_exceeds_limit = True
                failure_message = (f"TPUJob {job.metadata.name} has failed "
                                   "because it has reached the specified "
                                   "backoff limit")
        if not job_exceeds_limit and self._past_active_deadline(job):
            job_exceeds_limit = True
            failure_message = (f"TPUJob {job.metadata.name} has failed because "
                               "it was active longer than specified deadline")

        if job_exceeds_limit:
            if job.status.completion_time is None:
                job.status.completion_time = _now()
            self._delete_pods_and_endpoints(job, pods)
            self._cleanup_job_if_ttl(job)
            if self.config.enable_gang_scheduling and self.gang:
                self.recorder.event(job, EVENT_TYPE_NORMAL,
                                    JOB_TERMINATED_REASON,
                                    "Job has been terminated. Deleting SliceGroup")
                self.gang.delete_slice_group(job)
            self.recorder.event(job, EVENT_TYPE_NORMAL, cond.JOB_FAILED_REASON,
                                failure_message)
            cond.update_job_conditions(job.status, JobConditionType.FAILED,
                                       cond.JOB_FAILED_REASON, failure_message)
            self.plugin.update_job_status_in_api(job)
            return

        # General path.
        if self.config.enable_gang_scheduling and self.gang:
            with trace_mod.span("gang.sync"):
                self.gang.sync_slice_group(job, replica_specs)
            # Tenant-queue quota arc (controller/quota.py): while the
            # gang is quota-held, the job carries a Queued condition;
            # on admission it resolves to False; a wait that can never
            # end (zero-quota queue) fails the job terminally, exactly
            # like the backoff/deadline path above.
            quota_wait = self.gang.quota_status(job)
            if quota_wait is not None and quota_wait.terminal:
                msg = (f"TPUJob {job.metadata.name} has failed because "
                       f"its queue can never admit it: "
                       f"{quota_wait.message}")
                if job.status.completion_time is None:
                    job.status.completion_time = _now()
                self._delete_pods_and_endpoints(job, pods)
                self._cleanup_job_if_ttl(job)
                self.recorder.event(job, EVENT_TYPE_NORMAL,
                                    JOB_TERMINATED_REASON,
                                    "Job has been terminated. "
                                    "Deleting SliceGroup")
                self.gang.delete_slice_group(job)
                self.recorder.event(job, EVENT_TYPE_WARNING,
                                    cond.JOB_QUOTA_EXCEEDED_REASON, msg)
                cond.update_job_conditions(
                    job.status, JobConditionType.FAILED,
                    cond.JOB_QUOTA_EXCEEDED_REASON, msg)
                self.plugin.update_job_status_in_api(job)
                return
            if quota_wait is not None:
                cond.update_job_conditions(
                    job.status, JobConditionType.QUEUED,
                    cond.JOB_QUEUED_REASON,
                    f"TPUJob {job.metadata.name} is queued: "
                    f"{quota_wait.message}")
            else:
                cond.mark_condition_false(
                    job.status, JobConditionType.QUEUED,
                    cond.JOB_QUOTA_ADMITTED_REASON,
                    f"TPUJob {job.metadata.name} was admitted by its "
                    "queue")
            # Slice-health drain in progress: surface restart-with-
            # identity on the job — Restarting until the gang is fully
            # back up, then the status machine flips it to Running (the
            # marker is cleared on the group's promotion, gang.py).
            # Level-triggered and quiet: update_job_conditions no-ops
            # when already set, and the one-shot SliceDrained event +
            # slice_drains_total metric fire at the drain edge in
            # controller/health.py — re-asserting here must not spam.
            displaced = self.gang.displaced_reason(job)
            if displaced:
                cond.update_job_conditions(
                    job.status, JobConditionType.RESTARTING,
                    cond.JOB_RESTARTING_REASON,
                    f"TPUJob {job.metadata.name} is restarting: gang "
                    f"drained ({displaced}); replicas will rebind on "
                    "spare capacity and resume from the latest "
                    "checkpoint")
            # Elastic-resize arc (controller/gang.py, docs/elastic.md):
            # Resizing while an applied grow/shrink is settling, then
            # resolved to False once the gang is fully up at the new
            # size. Level-triggered and quiet like the arcs above — the
            # GangResized event and gang_resizes metric fire once at
            # the resize edge in the scheduler.
            resizing = self.gang.resize_reason(job)
            if resizing:
                cond.update_job_conditions(
                    job.status, JobConditionType.RESIZING,
                    cond.JOB_RESIZING_REASON,
                    f"TPUJob {job.metadata.name} is resizing "
                    f"({resizing}); replicas will rejoin the new world "
                    "and resume from the latest checkpoint")
            else:
                cond.mark_condition_false(
                    job.status, JobConditionType.RESIZING,
                    cond.JOB_RESIZED_REASON,
                    f"TPUJob {job.metadata.name} is fully up at its "
                    "new size")

        # Checkpoint-coordination arc (controller/ckpt.py): surface an
        # in-flight save-before-evict barrier as a CheckpointBarrier
        # condition (resolved to False on full-gang ack or timeout) and
        # mirror the committed/restored steps onto the status. Level-
        # triggered and quiet like the displaced/quota arcs above: the
        # condition machinery no-ops on re-assert and the change diff
        # below decides whether anything is written.
        if self.ckpt is not None:
            with trace_mod.span("ckpt.sync"):
                self.ckpt.sync_job_status(job)

        # Degraded-mode surfacing (runtime/retry.py ControlPlaneHealth):
        # while the API server has been failing past the threshold, the
        # controller keeps reconciling but defers new drains/reclaims/
        # preemptions — say so ON the job, level-triggered (the
        # condition machinery no-ops on re-assert; the change diff
        # below decides whether anything is written, and the write
        # itself retries like any other — surfacing when the API server
        # answers again is exactly when an operator reads it).
        if self.cp_health is not None:
            if self.cp_health.degraded:
                cond.update_job_conditions(
                    job.status, JobConditionType.CONTROLPLANE_DEGRADED,
                    cond.JOB_CONTROLPLANE_DEGRADED_REASON,
                    "The operator's API server has been unreachable "
                    "past the degraded threshold; reconciling continues "
                    "but new drains/reclaims/preemptions are deferred")
            else:
                cond.mark_condition_false(
                    job.status, JobConditionType.CONTROLPLANE_DEGRADED,
                    cond.JOB_CONTROLPLANE_RECOVERED_REASON,
                    "The operator's API server is reachable again; "
                    "disruptive actions resumed")

        with trace_mod.span("reconcile.replicas"):
            for rtype, spec in replica_specs.items():
                self.reconcile_pods(job, pods, rtype, spec, replica_specs)
                self.reconcile_endpoints(job, endpoints, rtype, spec)

        # Thread the snapshot this sync already listed+claimed through
        # the status roll-up — update_job_status used to re-list and
        # re-claim, doubling the per-sync store cost for nothing.
        with trace_mod.span("status.rollup"):
            self.plugin.update_job_status(job, replica_specs, pods)
        with trace_mod.span("status.diff"):
            changed = job.status.to_dict() != old_status_dict
        if changed:
            self.plugin.update_job_status_in_api(job)

    def _finalize_finished_job(self, job: TPUJob, pods: List[Pod]) -> None:
        self._delete_pods_and_endpoints(job, pods)
        self._cleanup_job_if_ttl(job)
        if self.config.enable_gang_scheduling and self.gang:
            self.recorder.event(job, EVENT_TYPE_NORMAL, JOB_TERMINATED_REASON,
                                "Job has been terminated. Deleting SliceGroup")
            self.gang.delete_slice_group(job)
        # Roll still-active replicas into succeeded on success
        # (reference job.go:180-188).
        if cond.is_succeeded(job.status):
            for rs in job.status.replica_statuses.values():
                rs.succeeded += rs.active
                rs.active = 0

    # ------------------------------------------------------------------
    # Pod reconcile (reference tensorflow/pod.go:67-163 + common/pod.go)
    # ------------------------------------------------------------------

    @staticmethod
    def filter_pods_for_replica_type(pods: List[Pod], rtype: str) -> List[Pod]:
        rt = rtype.lower()
        return [p for p in pods
                if p.metadata.labels.get(constants.LABEL_REPLICA_TYPE) == rt]

    @staticmethod
    def get_pod_slices(pods: List[Pod], replicas: int) -> List[List[Pod]]:
        """Bucket pods by replica-index; slice length covers max(index)+1 and
        the desired count so callers see both missing and out-of-range
        indices (reference common/pod.go:281-318)."""
        size = replicas
        indexed: List[tuple] = []
        for pod in pods:
            raw = pod.metadata.labels.get(constants.LABEL_REPLICA_INDEX)
            if raw is None:
                log.warning("pod %s has no replica-index label",
                            pod.metadata.name)
                continue
            try:
                index = int(raw)
            except ValueError:
                log.warning("pod %s bad replica-index %r", pod.metadata.name, raw)
                continue
            size = max(size, index + 1)
            indexed.append((index, pod))
        slices: List[List[Pod]] = [[] for _ in range(size)]
        for index, pod in indexed:
            if index >= 0:
                slices[index].append(pod)
        return slices

    def reconcile_pods(self, job: TPUJob, pods: List[Pod], rtype: str,
                       spec: ReplicaSpec,
                       replica_specs: Dict[str, ReplicaSpec]) -> None:
        rt = rtype.lower()
        pods = self.filter_pods_for_replica_type(pods, rt)
        num_replicas = spec.replicas or 0

        # Reset tallies for this type (reference status.go:243-249).
        job.status.replica_statuses[rt] = ReplicaStatus()

        # World digest for this rtype, computed lazily ONCE per sync
        # (bootstrap_hash is index-invariant by contract).
        want_hash: Optional[str] = None

        for index, pod_slice in enumerate(self.get_pod_slices(pods, num_replicas)):
            if index >= num_replicas:
                # Scale-down: every pod at an out-of-range index goes,
                # however many share it, and none is created there (the
                # reference, pod.go:121-127, deletes only a lone pod, so
                # a gap below an adopted pod's index got a new pod and
                # two pods at one such index stayed for good).
                for pod in pod_slice:
                    self._delete_pod(job, pod, rt)
                continue
            if len(pod_slice) > 1:
                log.warning("too many pods for %s %s index %d", job.key(), rt,
                            index)
            elif not pod_slice:
                master_role = self.plugin.is_master_role(replica_specs, rt, index)
                self._create_new_pod(job, rt, index, spec, master_role)
            else:
                pod = pod_slice[0]

                # Elastic world restart: a live pod whose stamped
                # bootstrap digest no longer matches the job's current
                # topology is running in a world that no longer exists
                # (resize changed the dense cluster spec). Restart it —
                # the recreated pod rejoins the new world and resumes
                # from the latest checkpoint. Sparse-elastic workers'
                # digests don't change on resize, so they keep running
                # (reference enableDynamicWorker, tensorflow.go:64-83).
                have = pod.metadata.annotations.get(
                    constants.ANNOTATION_BOOTSTRAP_HASH, "")
                if have and pod.status.phase not in (PodPhase.SUCCEEDED,
                                                     PodPhase.FAILED):
                    if want_hash is None:
                        want_hash = self.plugin.bootstrap_hash(job, rt,
                                                               index)
                    want = want_hash
                    if want and want != have:
                        self.recorder.event(
                            job, EVENT_TYPE_NORMAL, "WorldResized",
                            f"Pod {pod.metadata.name} restarting: "
                            "cluster topology changed "
                            "(elastic resize); will rejoin the new "
                            "world from the latest checkpoint")
                        self._delete_pod(job, pod, rt)
                        metrics.restarted_pods.inc(
                            job_namespace=job.metadata.namespace)
                        continue

                exit_code = self._container_exit_code(pod)
                if exit_code not in (None, 0):
                    self.recorder.event(
                        job, EVENT_TYPE_NORMAL, EXITED_WITH_CODE_REASON,
                        f"Pod: {pod.metadata.namespace}.{pod.metadata.name} "
                        f"exited with code {exit_code}")

                if (spec.restart_policy == RestartPolicy.EXIT_CODE
                        and pod.status.phase == PodPhase.FAILED
                        and exit_code is not None
                        and is_retryable_exit_code(exit_code)):
                    # Restart with identity: delete the pod; the next sync
                    # recreates the same index (reference pod.go:138-157).
                    log.info("restarting pod %s (exit code %d)",
                             pod.metadata.name, exit_code)
                    self._delete_pod(job, pod, rt)
                    metrics.restarted_pods.inc(
                        job_namespace=job.metadata.namespace)
                    if cond.get_condition(job.status,
                                          JobConditionType.RESTARTING) is None:
                        # One job-restart event per Restarting transition,
                        # not per restarted pod (reference tfJobsRestartCount).
                        metrics.jobs_restarted.inc(
                            job_namespace=job.metadata.namespace)
                    msg = (f"TPUJob {job.metadata.name} is restarting because "
                           f"{rt} replica(s) failed.")
                    self.recorder.event(job, EVENT_TYPE_WARNING,
                                        cond.JOB_RESTARTING_REASON, msg)
                    cond.update_job_conditions(job.status,
                                               JobConditionType.RESTARTING,
                                               cond.JOB_RESTARTING_REASON, msg)

                self._update_replica_statuses(job, rt, pod)

    def _expect(self, exp_key: str, adds: int = 0, dels: int = 0) -> None:
        """Record one expected create/delete, accumulating within a sync."""
        if self.expectations.get_expectations(exp_key) is None:
            self.expectations.set_expectations(exp_key, adds, dels)
        else:
            self.expectations.raise_expectations(exp_key, adds, dels)

    def _create_new_pod(self, job: TPUJob, rt: str, index: int,
                        spec: ReplicaSpec, master_role: bool) -> None:
        """Reference tensorflow/pod.go:166-256."""
        exp_key = expectation_key(job.key(), "pods", rt)
        self._expect(exp_key, adds=1)

        pod = Pod(spec=spec.template.spec.deepcopy())
        pod.metadata.name = gen_general_name(job.metadata.name, rt, index)
        pod.metadata.namespace = job.metadata.namespace
        pod.metadata.labels = dict(spec.template.metadata.labels)
        pod.metadata.labels.update(self.gen_labels(job.metadata.name))
        pod.metadata.labels[constants.LABEL_REPLICA_TYPE] = rt
        pod.metadata.labels[constants.LABEL_REPLICA_INDEX] = str(index)
        if master_role:
            pod.metadata.labels[constants.LABEL_JOB_ROLE] = constants.JOB_ROLE_MASTER
        pod.metadata.annotations = dict(spec.template.metadata.annotations)

        # Cluster bootstrap env (reference SetClusterSpec, pod.go:205).
        self.plugin.set_cluster_spec(job, pod, rt, index)
        digest = self.plugin.bootstrap_hash(job, rt, index)
        if digest:
            pod.metadata.annotations[
                constants.ANNOTATION_BOOTSTRAP_HASH] = digest

        # ExitCode policy is operator-level; the backend must not restart
        # the process itself (reference setRestartPolicy, pod.go:319-326).
        if spec.restart_policy == RestartPolicy.EXIT_CODE:
            pod.spec.restart_policy = RestartPolicy.NEVER
        else:
            pod.spec.restart_policy = spec.restart_policy

        if self.config.enable_gang_scheduling and self.gang:
            self.gang.annotate_pod(job, pod, rt)

        try:
            self._control_write(
                "engine.create_pod",
                lambda: self.pod_control.create_pod(
                    job.metadata.namespace, pod, job))
        except Exception:
            # Roll back the expectation so the next sync retries
            # (reference pod.go:243-255).
            self.expectations.creation_observed(exp_key)
            raise

    def _delete_pod(self, job: TPUJob, pod: Pod, rt: str) -> None:
        exp_key = expectation_key(job.key(), "pods", rt)
        self._expect(exp_key, dels=1)
        try:
            self._control_write(
                "engine.delete_pod",
                lambda: self.pod_control.delete_pod(
                    pod.metadata.namespace, pod.metadata.name, job))
        except Exception:
            self.expectations.deletion_observed(exp_key)
            raise

    def _container_exit_code(self, pod: Pod) -> Optional[int]:
        """Exit code of the default container, None when not terminated
        (reference getContainerExitCode, pod.go:347-356)."""
        name = self.plugin.get_default_container_name()
        for cs in pod.status.container_statuses:
            if cs.name == name and cs.state == "Terminated":
                return cs.exit_code
        return None

    def _update_replica_statuses(self, job: TPUJob, rt: str, pod: Pod) -> None:
        """Reference updateJobReplicaStatuses (status.go:252-261)."""
        rs = job.status.replica_statuses[rt]
        if pod.status.phase == PodPhase.RUNNING:
            rs.active += 1
        elif pod.status.phase == PodPhase.SUCCEEDED:
            rs.succeeded += 1
        elif pod.status.phase == PodPhase.FAILED:
            rs.failed += 1

    # ------------------------------------------------------------------
    # Endpoint reconcile (reference common/service.go:206-339)
    # ------------------------------------------------------------------

    @staticmethod
    def filter_endpoints_for_replica_type(endpoints: List[Endpoint],
                                          rtype: str) -> List[Endpoint]:
        rt = rtype.lower()
        return [e for e in endpoints
                if e.metadata.labels.get(constants.LABEL_REPLICA_TYPE) == rt]

    def reconcile_endpoints(self, job: TPUJob, endpoints: List[Endpoint],
                            rtype: str, spec: ReplicaSpec) -> None:
        rt = rtype.lower()
        endpoints = self.filter_endpoints_for_replica_type(endpoints, rt)
        num_replicas = spec.replicas or 0
        slices = self._endpoint_slices(endpoints, num_replicas)
        for index, ep_slice in enumerate(slices):
            if index >= num_replicas:
                # As for pods: every endpoint at an out-of-range index
                # goes, and none is created there.
                for ep in ep_slice:
                    exp_key = expectation_key(job.key(), "endpoints", rt)
                    self._expect(exp_key, dels=1)
                    try:
                        self._control_write(
                            "engine.delete_endpoint",
                            lambda ep=ep:
                            self.endpoint_control.delete_endpoint(
                                ep.metadata.namespace,
                                ep.metadata.name, job))
                    except Exception:
                        self.expectations.deletion_observed(exp_key)
                        raise
            elif len(ep_slice) > 1:
                log.warning("too many endpoints for %s %s index %d",
                            job.key(), rt, index)
            elif not ep_slice:
                self._create_new_endpoint(job, rt, index, spec)

    def _endpoint_slices(self, endpoints: List[Endpoint],
                         replicas: int) -> List[List[Endpoint]]:
        size = replicas
        indexed = []
        for ep in endpoints:
            raw = ep.metadata.labels.get(constants.LABEL_REPLICA_INDEX)
            if raw is None:
                continue
            try:
                index = int(raw)
            except ValueError:
                continue
            size = max(size, index + 1)
            indexed.append((index, ep))
        slices: List[List[Endpoint]] = [[] for _ in range(size)]
        for index, ep in indexed:
            if index >= 0:
                slices[index].append(ep)
        return slices

    def _create_new_endpoint(self, job: TPUJob, rt: str, index: int,
                             spec: ReplicaSpec) -> None:
        """Per-replica discovery record, headless-service analog (reference
        CreateNewService, common/service.go:277-339)."""
        container = spec.template.spec.container(
            self.plugin.get_default_container_name())
        ports = dict(container.ports) if container else {}
        labels = self.gen_labels(job.metadata.name)
        labels[constants.LABEL_REPLICA_TYPE] = rt
        labels[constants.LABEL_REPLICA_INDEX] = str(index)
        ep = Endpoint(
            spec=EndpointSpec(selector=dict(labels), ports=ports),
        )
        ep.metadata.name = gen_general_name(job.metadata.name, rt, index)
        ep.metadata.namespace = job.metadata.namespace
        ep.metadata.labels = labels

        exp_key = expectation_key(job.key(), "endpoints", rt)
        self._expect(exp_key, adds=1)
        try:
            self._control_write(
                "engine.create_endpoint",
                lambda: self.endpoint_control.create_endpoint(
                    job.metadata.namespace, ep, job))
        except Exception:
            self.expectations.creation_observed(exp_key)
            raise

    # ------------------------------------------------------------------
    # Policies (reference common/job.go:21-47, 345-421)
    # ------------------------------------------------------------------

    def _delete_pods_and_endpoints(self, job: TPUJob, pods: List[Pod]) -> None:
        if not pods:
            return
        policy = job.spec.run_policy.clean_pod_policy or CleanPodPolicy.RUNNING
        if policy == CleanPodPolicy.NONE:
            return
        for pod in pods:
            # Pending pods become running once schedulable; treat them as
            # running for cleanup (reference job.go:32-36).
            if (policy == CleanPodPolicy.RUNNING
                    and pod.status.phase not in (PodPhase.RUNNING,
                                                 PodPhase.PENDING)):
                continue
            self._control_write(
                "engine.cleanup",
                lambda pod=pod: self.pod_control.delete_pod(
                    pod.metadata.namespace, pod.metadata.name, job))
            # Pod and endpoint share a name (reference job.go:41-44).
            self._control_write(
                "engine.cleanup",
                lambda pod=pod: self.endpoint_control.delete_endpoint(
                    pod.metadata.namespace, pod.metadata.name, job))

    def _cleanup_job_if_ttl(self, job: TPUJob) -> None:
        ttl = job.spec.run_policy.ttl_seconds_after_finished
        if ttl is None:
            return
        completion = job.status.completion_time
        if completion is None:
            log.warning("job %s finished but has no completion time", job.key())
            return
        expiry = completion + _dt.timedelta(seconds=ttl)
        if _now() >= expiry:
            self.plugin.delete_job(job)
        else:
            # Requeue after exactly the remaining TTL (reference
            # job.go:345-357). add_rate_limited was wrong twice over:
            # exponential backoff fires early-and-often (wasted syncs)
            # and, past the cap, late (TTL overshoot) — and it grew the
            # key's failure counter, eating into BackoffLimit.
            remaining = (expiry - _now()).total_seconds()
            self.workqueue.add_after(job.key(), remaining)

    def _past_active_deadline(self, job: TPUJob) -> bool:
        ads = job.spec.run_policy.active_deadline_seconds
        if ads is None or job.status.start_time is None:
            return False
        return (_now() - job.status.start_time).total_seconds() >= ads

    def _past_backoff_limit(self, job: TPUJob,
                            replica_specs: Dict[str, ReplicaSpec],
                            pods: List[Pod]) -> bool:
        """Sum of container restart counts vs backoff limit; only counted
        for OnFailure/Always replicas (reference job.go:359-396)."""
        limit = job.spec.run_policy.backoff_limit
        if limit is None:
            return False
        total_restarts = 0
        for rtype, spec in replica_specs.items():
            if spec.restart_policy not in (RestartPolicy.ON_FAILURE,
                                           RestartPolicy.ALWAYS):
                continue
            for pod in self.filter_pods_for_replica_type(pods, rtype):
                if pod.status.phase != PodPhase.RUNNING:
                    continue
                for cs in pod.status.container_statuses:
                    total_restarts += cs.restart_count
        if limit == 0:
            return total_restarts > 0
        return total_restarts >= limit

    def _record_abnormal_pods(self, active_pods: List[Pod],
                              job: TPUJob) -> None:
        """Reference recordAbnormalPods (common/job.go:76-120)."""
        for pod in active_pods:
            for cs in pod.status.container_statuses:
                if cs.state == "Terminated" and cs.exit_code not in (0, None):
                    self.recorder.event(
                        job, EVENT_TYPE_WARNING, "AbnormalPod",
                        f"Error pod {pod.metadata.name} container {cs.name} "
                        f"exitCode: {cs.exit_code} message: {cs.message}")
                elif cs.state == "Waiting" and cs.message:
                    self.recorder.event(
                        job, EVENT_TYPE_WARNING, "AbnormalPod",
                        f"Error pod {pod.metadata.name} container {cs.name} "
                        f"waiting message: {cs.message}")

    # ------------------------------------------------------------------

    @staticmethod
    def gen_labels(job_name: str) -> Dict[str, str]:
        """Reference GenLabels (common/job_controller.go:208-216)."""
        return {
            constants.LABEL_GROUP_NAME: constants.GROUP,
            constants.LABEL_JOB_NAME: job_name.replace("/", "-"),
        }
