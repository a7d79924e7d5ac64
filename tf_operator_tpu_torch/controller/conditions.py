"""Job condition state machine.

Behavioral parity with reference vendor/.../common/pkg/util/status.go:36-127:

- conditions are appended with status True; re-setting an identical
  (type,status,reason) is a no-op; lastTransitionTime is preserved when only
  reason/message change.
- Running and Restarting are mutually exclusive: setting one removes the
  other.
- Terminal conditions (Succeeded/Failed) flip an existing Running condition
  to status False rather than removing it.
- Once Failed is set the status is frozen: no further condition updates.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

from tf_operator_tpu_torch.api.types import (
    ConditionStatus,
    JobCondition,
    JobConditionType,
    JobStatus,
)

# Reasons (reference util/status.go:9-21).
JOB_CREATED_REASON = "JobCreated"
JOB_SUCCEEDED_REASON = "JobSucceeded"
JOB_RUNNING_REASON = "JobRunning"
JOB_FAILED_REASON = "JobFailed"
JOB_RESTARTING_REASON = "JobRestarting"
# TPU extensions (controller/quota.py): tenant-queue admission arc.
JOB_QUEUED_REASON = "QueuedWaitingForQuota"
JOB_QUOTA_ADMITTED_REASON = "QuotaAdmitted"
JOB_QUOTA_EXCEEDED_REASON = "QuotaExceeded"
# TPU extensions (runtime/retry.py): degraded-mode arc — the API server
# was failing past the threshold / answered again.
JOB_CONTROLPLANE_DEGRADED_REASON = "ControlPlaneDegraded"
JOB_CONTROLPLANE_RECOVERED_REASON = "ControlPlaneRecovered"
# TPU extensions (controller/gang.py resize pass): elastic-resize arc —
# a grow/shrink was applied / the gang is fully up at the new size.
JOB_RESIZING_REASON = "GangResizing"
JOB_RESIZED_REASON = "GangResizeComplete"


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def has_condition(status: JobStatus, cond_type: str) -> bool:
    return any(c.type == cond_type and c.status == ConditionStatus.TRUE
               for c in status.conditions)


def is_succeeded(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.SUCCEEDED)


def is_failed(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.FAILED)


def is_running(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.RUNNING)


def is_finished(status: JobStatus) -> bool:
    return is_succeeded(status) or is_failed(status)


def get_condition(status: JobStatus, cond_type: str) -> Optional[JobCondition]:
    for c in status.conditions:
        if c.type == cond_type:
            return c
    return None


def update_job_conditions(status: JobStatus, cond_type: str, reason: str,
                          message: str) -> None:
    """Reference UpdateJobConditions (util/status.go:36-40)."""
    condition = JobCondition(type=cond_type, status=ConditionStatus.TRUE,
                             reason=reason, message=message,
                             last_update_time=_now(),
                             last_transition_time=_now())
    _set_condition(status, condition)


def mark_condition_false(status: JobStatus, cond_type: str, reason: str,
                         message: str) -> None:
    """Flip an existing True condition to False (no reference analog:
    the reference never resolves a condition, it only supersedes; the
    Queued tenant-quota condition resolves on admission and must say
    so rather than linger True). No-op when the condition is absent or
    already False — level-triggered callers can re-assert freely."""
    current = get_condition(status, cond_type)
    if current is None or current.status == ConditionStatus.FALSE:
        return
    _set_condition(status, JobCondition(
        type=cond_type, status=ConditionStatus.FALSE, reason=reason,
        message=message, last_update_time=_now(),
        last_transition_time=_now()))


def _set_condition(status: JobStatus, condition: JobCondition) -> None:
    # A failed job's status is frozen (util/status.go:78-81).
    if is_failed(status):
        return

    current = get_condition(status, condition.type)
    if (current is not None and current.status == condition.status
            and current.reason == condition.reason):
        return
    if current is not None and current.status == condition.status:
        condition.last_transition_time = current.last_transition_time

    status.conditions = _filter_out(status.conditions, condition.type)
    status.conditions.append(condition)


def _filter_out(conditions, cond_type: str):
    out = []
    for c in conditions:
        # Running <-> Restarting mutual exclusion (util/status.go:104-109).
        if cond_type == JobConditionType.RESTARTING and c.type == JobConditionType.RUNNING:
            continue
        if cond_type == JobConditionType.RUNNING and c.type == JobConditionType.RESTARTING:
            continue
        if c.type == cond_type:
            continue
        # Terminal conditions demote Running to False (util/status.go:116-118).
        if (cond_type in (JobConditionType.FAILED, JobConditionType.SUCCEEDED)
                and c.type == JobConditionType.RUNNING):
            c.status = ConditionStatus.FALSE
        out.append(c)
    return out
