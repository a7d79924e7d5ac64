"""TPUJob status roll-up: replica tallies -> job conditions.

Behavioral parity with reference pkg/controller.v1/tensorflow/status.go:
63-219 (UpdateJobStatus):

- start time set on first sync; ActiveDeadlineSeconds schedules a delayed
  re-sync so the deadline actually fires.
- with a chief/master replica type: the chief decides — running chief =>
  Running, completed chief => Succeeded.
- without: worker-0 completion decides under the default success policy;
  under AllWorkers every worker must finish.
- any failed replica => Failed, unless a Restarting condition was set
  while reconciling (restart-with-identity in flight).
"""

from __future__ import annotations

import datetime as _dt
import logging
from typing import Dict, List, Optional

from tf_operator_tpu_torch.api.types import (
    JobConditionType,
    Pod,
    PodPhase,
    ReplicaSpec,
    ReplicaType,
    SuccessPolicy,
    TPUJob,
    is_chief_or_master,
)
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.controller.engine import JobEngine
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime.events import EVENT_TYPE_NORMAL, Recorder
from tf_operator_tpu_torch.runtime.workqueue import RateLimitingQueue

log = logging.getLogger("tpu_operator.status")

# Evaluation order (reference status.go:95-101; serving is a TPU
# extension appended last so training-role semantics are untouched).
_TYPE_ORDER = (ReplicaType.CHIEF, ReplicaType.EVALUATOR, ReplicaType.MASTER,
               ReplicaType.PS, ReplicaType.WORKER, ReplicaType.SERVING)


def contains_chief_or_master(replica_specs: Dict[str, ReplicaSpec]) -> bool:
    """Reference tensorflow/util.go:44-52."""
    return any(is_chief_or_master(rt) for rt in replica_specs)


def is_worker0_completed(job: TPUJob, replica_specs: Dict[str, ReplicaSpec],
                         pods: List[Pod],
                         default_container: str) -> bool:
    """Worker-0 succeeded with exit code 0 (reference pod.go:359-379).
    Vacuously true when the job has no worker type."""
    spec = replica_specs.get(ReplicaType.WORKER)
    if spec is None:
        return True
    workers = JobEngine.filter_pods_for_replica_type(pods, ReplicaType.WORKER)
    for pod_slice in JobEngine.get_pod_slices(workers, spec.replicas or 0)[:1]:
        for pod in pod_slice:
            if pod.status.phase != PodPhase.SUCCEEDED:
                continue
            for cs in pod.status.container_statuses:
                if (cs.name == default_container and cs.state == "Terminated"
                        and cs.exit_code == 0):
                    return True
    return False


def update_job_status(job: TPUJob, replica_specs: Dict[str, ReplicaSpec],
                      worker0_completed: bool,
                      recorder: Optional[Recorder] = None,
                      workqueue: Optional[RateLimitingQueue] = None) -> None:
    status = job.status
    now = _dt.datetime.now(_dt.timezone.utc)

    if status.start_time is None:
        status.start_time = now
        ads = job.spec.run_policy.active_deadline_seconds
        if ads is not None and workqueue is not None:
            # Re-sync when the deadline passes (reference status.go:84-92).
            workqueue.add_after(job.key(), float(ads))

    has_chief = contains_chief_or_master(replica_specs)

    # AllReplicasReady latency (BASELINE north star): observed once, when
    # EVERY desired replica across all types is Running or already done —
    # not on the first Running transition, which fires at one active pod.
    if status.all_replicas_ready_time is None:
        all_ready = all(
            (status.replica_statuses.get(rt) is not None
             and status.replica_statuses[rt].active
             + status.replica_statuses[rt].succeeded >= (spec.replicas or 0))
            for rt, spec in replica_specs.items())
        if all_ready and job.metadata.creation_timestamp is not None:
            status.all_replicas_ready_time = now
            dt = (now - job.metadata.creation_timestamp).total_seconds()
            if dt >= 0:
                metrics.ready_latency_seconds.observe(
                    dt, job_namespace=job.metadata.namespace)

    # Capture restart state BEFORE any Running condition is set below:
    # setting Running removes Restarting (mutual exclusion), and the
    # failed>0 guard must still see that a restart is in flight this sync.
    # (The reference checks conditions after the fact, status.go:183-191,
    # which mis-fails a restarting job when a sibling replica is Running.)
    was_restarting = any(c.type == JobConditionType.RESTARTING
                         for c in status.conditions)

    for rtype in _TYPE_ORDER:
        spec = replica_specs.get(rtype)
        if spec is None:
            continue
        rs = status.replica_statuses.get(rtype)
        if rs is None:
            continue
        succeeded = rs.succeeded
        expected = (spec.replicas or 0) - succeeded
        running = rs.active
        failed = rs.failed

        if has_chief:
            if is_chief_or_master(rtype):
                if running > 0:
                    _set_running(job, recorder)
                if expected == 0:
                    _set_succeeded(job, recorder)
        else:
            if rtype == ReplicaType.WORKER:
                # Success: all workers done, or worker-0 done under the
                # default policy (reference status.go:152-158).
                if expected == 0 or (
                        worker0_completed
                        and job.spec.success_policy != SuccessPolicy.ALL_WORKERS):
                    _set_succeeded(job, recorder)
                elif running > 0:
                    _set_running(job, recorder)
            elif rtype == ReplicaType.SERVING:
                # Serving replicas are long-running peers with no rank-0
                # shortcut: the job Runs while any replica serves and
                # Succeeds only when every replica exited 0 (the spool's
                # close sentinel in bounded runs; production serving
                # jobs simply never complete).
                if expected == 0:
                    _set_succeeded(job, recorder)
                elif running > 0:
                    _set_running(job, recorder)

        if failed > 0:
            if not was_restarting:
                msg = (f"TPUJob {job.key()} has failed because {failed} "
                       f"{rtype} replica(s) failed.")
                if recorder:
                    recorder.event(job, EVENT_TYPE_NORMAL,
                                   cond.JOB_FAILED_REASON, msg)
                if status.completion_time is None:
                    status.completion_time = now
                if not cond.is_failed(status):
                    metrics.jobs_failed.inc(
                        job_namespace=job.metadata.namespace)
                cond.update_job_conditions(status, JobConditionType.FAILED,
                                           cond.JOB_FAILED_REASON, msg)


def _set_running(job: TPUJob, recorder: Optional[Recorder]) -> None:
    msg = f"TPUJob {job.key()} is running."
    cond.update_job_conditions(job.status, JobConditionType.RUNNING,
                               cond.JOB_RUNNING_REASON, msg)


def _set_succeeded(job: TPUJob, recorder: Optional[Recorder]) -> None:
    msg = f"TPUJob {job.key()} successfully completed."
    if recorder:
        recorder.event(job, EVENT_TYPE_NORMAL, cond.JOB_SUCCEEDED_REASON, msg)
    if job.status.completion_time is None:
        job.status.completion_time = _dt.datetime.now(_dt.timezone.utc)
    if not cond.is_succeeded(job.status):
        metrics.jobs_successful.inc(job_namespace=job.metadata.namespace)
    cond.update_job_conditions(job.status, JobConditionType.SUCCEEDED,
                               cond.JOB_SUCCEEDED_REASON, msg)
