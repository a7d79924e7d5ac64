"""TPUJob spec validation.

Reference: pkg/apis/tensorflow/validation/validation.go:27-66 —
spec non-nil; every replica has containers; container image/command
non-empty; a container named after the default container exists; at most
one Chief/Master. TPU additions: known restart/clean policies, replica
counts, slice accelerator syntax.
"""

from __future__ import annotations

import re
from typing import List

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CleanPodPolicy,
    ClusterQueue,
    DisruptionClass,
    ReclaimPolicy,
    ReplicaType,
    RestartPolicy,
    SuccessPolicy,
    TenantQueue,
    TPUJob,
    TPUJobSpec,
    is_chief_or_master,
)

_ACCELERATOR_RE = re.compile(r"^([a-z]+[0-9]+[a-z]*)-([0-9]+)$")
_TOPOLOGY_RE = re.compile(r"^[0-9]+(x[0-9]+)*$")
# RFC 1123 label: job names become pod names and label values, so the
# stricter label charset applies (no dots).
_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


class ValidationError(ValueError):
    """Raised when a TPUJob spec is invalid; message lists every finding."""

    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        super().__init__("; ".join(self.errors))


def validate_job(job: TPUJob) -> None:
    errors = list(_job_errors(job))
    if errors:
        raise ValidationError(errors)


def _job_errors(job: TPUJob):
    if not job.metadata.name:
        yield "metadata.name must be set"
    elif not _NAME_RE.match(job.metadata.name):
        yield (f"metadata.name {job.metadata.name!r} must be a lowercase "
               "RFC-1123 label (alphanumerics and '-')")
    yield from _spec_errors(job.spec)


def _spec_errors(spec: TPUJobSpec):
    if not spec.replica_specs:
        # Reference: "TFJobSpec is not valid" on nil TFReplicaSpecs
        # (validation.go:31-33).
        yield "spec.replicaSpecs must declare at least one replica type"
        return

    chief_like = 0
    for rtype, rspec in spec.replica_specs.items():
        path = f"spec.replicaSpecs[{rtype}]"
        if rtype.lower() not in ReplicaType.ALL:
            yield (f"{path}: unknown replica type; expected one of "
                   f"{', '.join(ReplicaType.ALL)}")
        if is_chief_or_master(rtype):
            chief_like += 1
        if rspec.replicas is not None and not isinstance(rspec.replicas, int):
            yield f"{path}.replicas must be an integer"
        elif rspec.replicas is not None and rspec.replicas < 0:
            yield f"{path}.replicas must be >= 0"
        if rspec.restart_policy and rspec.restart_policy not in RestartPolicy.ALL:
            yield (f"{path}.restartPolicy {rspec.restart_policy!r} invalid; "
                   f"expected one of {', '.join(RestartPolicy.ALL)}")
        yield from _role_policy_errors(path, rtype, rspec)
        yield from _template_errors(path, rspec)

    if chief_like > 1:
        # Reference: "more than 1 chief/master found" (validation.go:58-64).
        yield "spec.replicaSpecs: at most one chief/master replica type allowed"

    if spec.success_policy not in (SuccessPolicy.DEFAULT, SuccessPolicy.ALL_WORKERS):
        yield (f"spec.successPolicy {spec.success_policy!r} invalid; expected "
               f"'' or {SuccessPolicy.ALL_WORKERS!r}")

    cpp = spec.run_policy.clean_pod_policy
    if cpp is not None and cpp not in (CleanPodPolicy.ALL, CleanPodPolicy.RUNNING,
                                       CleanPodPolicy.NONE):
        yield f"spec.runPolicy.cleanPodPolicy {cpp!r} invalid"
    bl = spec.run_policy.backoff_limit
    if bl is not None and bl < 0:
        yield "spec.runPolicy.backoffLimit must be >= 0"
    ads = spec.run_policy.active_deadline_seconds
    if ads is not None and ads < 0:
        yield "spec.runPolicy.activeDeadlineSeconds must be >= 0"
    ttl = spec.run_policy.ttl_seconds_after_finished
    if ttl is not None and ttl < 0:
        yield "spec.runPolicy.ttlSecondsAfterFinished must be >= 0"

    cp = spec.run_policy.checkpoint_policy
    if cp is not None:
        if cp.enabled and not cp.directory:
            # Without a directory there is nowhere to save to or restore
            # from — an enabled policy would silently never checkpoint.
            yield ("spec.runPolicy.checkpointPolicy.directory is required "
                   "when the policy is enabled")
        if cp.interval_steps is not None and cp.interval_steps < 1:
            yield "spec.runPolicy.checkpointPolicy.intervalSteps must be >= 1"
        if cp.interval_seconds is not None and cp.interval_seconds <= 0:
            yield ("spec.runPolicy.checkpointPolicy.intervalSeconds must "
                   "be > 0")
        if cp.max_to_keep < 1:
            yield "spec.runPolicy.checkpointPolicy.maxToKeep must be >= 1"
        if cp.barrier_timeout_seconds <= 0:
            # A zero/negative timeout would make every barrier complete
            # instantly (defeating the save) or hang semantics unclear.
            yield ("spec.runPolicy.checkpointPolicy.barrierTimeoutSeconds "
                   "must be > 0")

    sp = spec.run_policy.serving_policy
    if sp is not None:
        if sp.enabled and not sp.spool_directory:
            # Without a spool there is nowhere for requests to arrive or
            # responses to land — an enabled policy would serve nothing.
            yield ("spec.runPolicy.servingPolicy.spoolDirectory is "
                   "required when the policy is enabled")
        if sp.enabled and ReplicaType.SERVING not in spec.replica_specs:
            yield ("spec.runPolicy.servingPolicy is enabled but the job "
                   "declares no 'serving' replica type")
        if sp.max_batch_slots < 1:
            yield "spec.runPolicy.servingPolicy.maxBatchSlots must be >= 1"
        if sp.max_queue_depth < 1:
            yield "spec.runPolicy.servingPolicy.maxQueueDepth must be >= 1"
        if sp.max_tokens_per_request < 1:
            yield ("spec.runPolicy.servingPolicy.maxTokensPerRequest must "
                   "be >= 1")
        if (sp.ttft_p99_slo_seconds is not None
                and sp.ttft_p99_slo_seconds <= 0):
            yield ("spec.runPolicy.servingPolicy.ttftP99SloSeconds must "
                   "be > 0")
        if (sp.tokens_per_second_slo is not None
                and sp.tokens_per_second_slo <= 0):
            yield ("spec.runPolicy.servingPolicy.tokensPerSecondSlo must "
                   "be > 0")
        if (sp.target_queue_depth_per_slice is not None
                and sp.target_queue_depth_per_slice < 1):
            yield ("spec.runPolicy.servingPolicy.targetQueueDepthPerSlice "
                   "must be >= 1")
        if sp.scale_down_cooldown_seconds < 0:
            # Zero is legal (no hysteresis — useful in tests); negative
            # has no meaning.
            yield ("spec.runPolicy.servingPolicy.scaleDownCooldownSeconds "
                   "must be >= 0")

    if spec.queue_name and not _NAME_RE.match(spec.queue_name):
        yield (f"spec.queueName {spec.queue_name!r} must be a lowercase "
               "RFC-1123 label (alphanumerics and '-')")

    yield from _slice_errors(spec)


def _role_policy_errors(path: str, rtype: str, rspec):
    """Per-role RolePolicy validation (docs/rl.md). The elastic band
    mirrors _slice_errors' minSlices/maxSlices checks, with one role
    twist: minReplicas may be 0 (a pool may drain to nothing; a gang
    below one slice cannot exist), and the band is only legal on roles
    that resolve to chip_consuming=False — chip holders resize in whole
    slices via spec.slice.minSlices/maxSlices."""
    rp = rspec.role_policy
    if rp is None:
        return
    rpath = f"{path}.rolePolicy"
    if rp.disruption_class and rp.disruption_class not in DisruptionClass.ALL:
        yield (f"{rpath}.disruptionClass {rp.disruption_class!r} invalid; "
               f"expected one of {', '.join(DisruptionClass.ALL)}")
    mn, mx = rp.min_replicas, rp.max_replicas
    if mn is not None and mn < 0:
        yield f"{rpath}.minReplicas must be >= 0"
    if mx is not None and mx < 1:
        yield f"{rpath}.maxReplicas must be >= 1"
    if mn is not None and mx is not None and mx < mn:
        yield f"{rpath}.maxReplicas ({mx}) must be >= minReplicas ({mn})"
    if mn is None and mx is None:
        return
    if (mn is None) != (mx is None):
        yield (f"{rpath}: minReplicas and maxReplicas must be set "
               "together (the elastic band needs both bounds)")
    chip = (rp.chip_consuming if rp.chip_consuming is not None
            else rtype.lower() in (ReplicaType.WORKER,
                                   ReplicaType.SERVING))
    if chip:
        yield (f"{rpath}: minReplicas/maxReplicas require a "
               "non-chip-consuming role (chip holders resize in whole "
               "slices via spec.slice.minSlices/maxSlices)")
    n = rspec.replicas or 0
    if mn is not None and mn >= 0 and n < mn:
        yield (f"{path}.replicas ({n}) must be >= "
               f"rolePolicy.minReplicas ({mn})")
    if mx is not None and mx >= 1 and n > mx:
        yield (f"{path}.replicas ({n}) must be <= "
               f"rolePolicy.maxReplicas ({mx})")


def _template_errors(path: str, rspec):
    containers = rspec.template.spec.containers
    if not containers:
        # Reference: "Content of replica template is empty" (validation.go:40-44).
        yield f"{path}.template.spec.containers must not be empty"
        return
    default_found = False
    for i, c in enumerate(containers):
        if not c.name:
            yield f"{path}.template.spec.containers[{i}].name must be set"
        if c.name == constants.DEFAULT_CONTAINER_NAME:
            default_found = True
            if not c.command and not c.image:
                # Reference requires image non-empty (validation.go:46-50);
                # local process pods require a command instead.
                yield (f"{path}.template.spec.containers[{i}] must set "
                       "command or image")
    if not default_found:
        # Reference: "There is no container named tensorflow" (validation.go:52-57).
        yield (f"{path}.template.spec: no container named "
               f"{constants.DEFAULT_CONTAINER_NAME!r}")


def _slice_errors(spec: TPUJobSpec):
    sl = spec.slice
    if sl.accelerator:
        from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator

        m = _ACCELERATOR_RE.match(sl.accelerator)
        if not m:
            yield (f"spec.slice.accelerator {sl.accelerator!r} invalid; "
                   "expected e.g. 'h100-8'")
        elif int(m.group(2)) < 1:
            yield "spec.slice.accelerator chip count must be >= 1"
        else:
            # A TPU name (v5p-32) is well formed but names no GPU
            # generation: refuse it here, not at pod-create time.
            try:
                parse_accelerator(sl.accelerator)
            except ValueError as e:
                yield f"spec.slice.accelerator {sl.accelerator!r}: {e}"
    if sl.topology and not _TOPOLOGY_RE.match(sl.topology):
        yield (f"spec.slice.topology {sl.topology!r} invalid; expected e.g. "
               "'2x2x4'")
    if sl.num_slices < 1:
        yield "spec.slice.numSlices must be >= 1"
    mn, mx = sl.min_slices, sl.max_slices
    if mn is not None and mn < 1:
        yield "spec.slice.minSlices must be >= 1"
    if mx is not None and mx < 1:
        yield "spec.slice.maxSlices must be >= 1"
    if mn is not None and mx is not None and mx < mn:
        yield (f"spec.slice.maxSlices ({mx}) must be >= minSlices ({mn})")
    if mn is not None or mx is not None:
        if not sl.accelerator:
            # Resizing is defined in whole slices; without a declared
            # slice shape there is no unit to grow or shrink by.
            yield ("spec.slice.minSlices/maxSlices require "
                   "spec.slice.accelerator (elastic resize operates on "
                   "whole slices)")
        if mn is not None and mn >= 1 and sl.num_slices < mn:
            yield (f"spec.slice.numSlices ({sl.num_slices}) must be >= "
                   f"minSlices ({mn})")
        if mx is not None and mx >= 1 and sl.num_slices > mx:
            yield (f"spec.slice.numSlices ({sl.num_slices}) must be <= "
                   f"maxSlices ({mx})")


def validate_tenant_queue(tq: TenantQueue) -> None:
    """TenantQueue admission-config validation (controller/quota.py):
    both names are RFC-1123 labels; the ClusterQueue reference is
    required (an unreferenced TenantQueue admits nothing and would
    silently behave like the default queue)."""
    errors: List[str] = []
    if not tq.metadata.name:
        errors.append("metadata.name must be set")
    elif not _NAME_RE.match(tq.metadata.name):
        errors.append(f"metadata.name {tq.metadata.name!r} must be a "
                      "lowercase RFC-1123 label")
    if not tq.spec.cluster_queue:
        errors.append("spec.clusterQueue must name a ClusterQueue")
    elif not _NAME_RE.match(tq.spec.cluster_queue):
        errors.append(f"spec.clusterQueue {tq.spec.cluster_queue!r} must "
                      "be a lowercase RFC-1123 label")
    if errors:
        raise ValidationError(errors)


def validate_cluster_queue(cq: ClusterQueue) -> None:
    """ClusterQueue quota validation: non-negative chip counts, known
    reclaim policy, RFC-1123 names. ('' reclaimPolicy/cohort are legal
    pre-defaulting inputs — api/defaults.set_cluster_queue_defaults
    fills them.)"""
    errors: List[str] = []
    if not cq.metadata.name:
        errors.append("metadata.name must be set")
    elif not _NAME_RE.match(cq.metadata.name):
        errors.append(f"metadata.name {cq.metadata.name!r} must be a "
                      "lowercase RFC-1123 label")
    if cq.spec.nominal_chips < 0:
        errors.append("spec.nominalChips must be >= 0")
    bl = cq.spec.borrowing_limit
    if bl is not None and bl < 0:
        errors.append("spec.borrowingLimit must be >= 0 (or omitted for "
                      "unlimited cohort borrowing)")
    if (cq.spec.reclaim_policy
            and cq.spec.reclaim_policy not in ReclaimPolicy.ALL):
        errors.append(
            f"spec.reclaimPolicy {cq.spec.reclaim_policy!r} invalid; "
            f"expected one of {', '.join(ReclaimPolicy.ALL)}")
    if cq.spec.cohort and not _NAME_RE.match(cq.spec.cohort):
        errors.append(f"spec.cohort {cq.spec.cohort!r} must be a "
                      "lowercase RFC-1123 label")
    if errors:
        raise ValidationError(errors)


def validation_warnings(job: TPUJob) -> List[str]:
    """Non-fatal spec smells, surfaced as Warning events on the job
    (the reference has no warning channel; closest analog is the event
    stream its harness scans). Covers:

    - multislice shape mismatch: numSlices > 1 with a worker count that
      is not hosts_per_slice x num_slices leaves slices under- or
      over-subscribed.

    Note: ``ps`` replicas no longer warn — ``tf_operator_tpu_torch.train.ps``
    is a real parameter-server runtime (sharded async optax updates;
    docs/parity.md §2.3), so a ps-typed pod running
    ``python -m tf_operator_tpu_torch.train.ps`` serves its shard for real.
    """
    warnings: List[str] = []
    spec = job.spec
    sl = spec.slice
    if sl.accelerator and sl.num_slices > 1:
        from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator

        try:
            topo = parse_accelerator(sl.accelerator, sl.topology,
                                     sl.num_slices)
        except ValueError:
            topo = None
        worker = spec.replica_specs.get(ReplicaType.WORKER)
        n_workers = (worker.replicas or 0) if worker else 0
        if topo is not None and n_workers != topo.num_hosts:
            warnings.append(
                f"spec.slice: numSlices={sl.num_slices} x "
                f"{topo.hosts_per_slice} hosts/slice wants "
                f"{topo.num_hosts} workers, spec declares {n_workers} — "
                "slices will be under- or over-subscribed")
    return warnings
