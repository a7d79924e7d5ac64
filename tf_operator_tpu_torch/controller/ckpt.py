"""Checkpoint coordination & goodput accounting: save-before-evict
barriers, restore-with-identity, disruption bookkeeping (port of
tf_operator_tpu/controller/ckpt.py, copied).

The slice-health and quota-reclaim machinery evicts gangs
routinely — maintenance drains, spot notices, nominal-quota reclaims —
and restart-with-identity preserved the gang's *topology* but threw away
every training step since the job's last periodic save: the 71-line
orbax Checkpointer and the control plane did not know about each other.
At pod scale disruption frequency grows with slice count ("Exploring the
limits of Concurrency in ML Training on Google TPUs", arXiv:2011.03641),
so the steps lost per disruption are the difference between goodput and
wasted fleet. This coordinator closes the loop across both planes:

1. **Barrier**: every PLANNED eviction (``controller/health.py`` drain,
   ``gang.displace`` quota reclaim) first asks ``ready_to_evict``. For a
   job whose ``runPolicy.checkpointPolicy`` opts in, the first ask opens
   a barrier: a preemption notice (annotation
   ``tpu-operator.dev/preemption-notice``) is stamped on the gang's live
   pods, the data plane forwards it to each worker process as a file
   (``runtime/local.py``; env ``TPUJOB_PREEMPT_FILE``), and the training
   loop forces a final ``Checkpointer.save(force=True)``
   (``train/checkpoint.py CheckpointHook``). Each replica acks by
   publishing a ``CheckpointRecord`` carrying the barrier id. Eviction
   is released on FULL-GANG ack or at ``barrierTimeoutSeconds`` —
   whichever first, so drains never hang on a wedged worker.
2. **Restore-with-identity**: recreated pods get
   ``TPUJOB_RESTORE_STEP`` / ``TPUJOB_CKPT_DIR`` rendered into their
   bootstrap env (``gpu_controller.set_cluster_spec``) from the gang's
   committed step — the minimum step every checkpointing replica has
   durably saved — so ``Checkpointer.restore`` resumes exactly where the
   barrier saved. Deliberately OUTSIDE the bootstrap hash: a new
   checkpoint must not restart live pods.
3. **Accounting**: ``checkpoint_save_seconds``,
   ``checkpoint_barrier_acks_total``, ``steps_lost_per_disruption`` and
   the per-job ``job_goodput_ratio`` gauge (docs/monitoring.md), plus
   ``lastCheckpointStep`` / ``restoredFromStep`` on the job status and a
   ``CheckpointBarrier`` condition arc rolled in by the engine
   (``sync_job_status``).

Level-triggered like its siblings: barrier membership, acks, committed
steps and restore steps are all re-derived from the store
(CheckpointRecords + pods) on every consult, so a coordinator restart
mid-barrier converges — only the barrier deadline anchor is in-memory,
and losing it costs one fresh (bounded) barrier window, never
correctness. Jobs without a policy — or an operator without
``--enable-ckpt-coordination`` — take the pre-coordinator eviction path
byte-for-byte.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    CheckpointRecord,
    DisruptionClass,
    JobConditionType,
    Pod,
    TPUJob,
    effective_role_policy,
)
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    REASON_CKPT_BARRIER_REQUESTED,
    REASON_CKPT_BARRIER_SAVED,
    REASON_CKPT_BARRIER_TIMEOUT,
)
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.ckpt")

# Condition reasons (the CheckpointBarrier arc on the job).
JOB_CKPT_BARRIER_PENDING_REASON = "CheckpointBarrierPending"
JOB_CKPT_BARRIER_SAVED_REASON = "CheckpointBarrierSaved"
JOB_CKPT_BARRIER_TIMEOUT_REASON = "CheckpointBarrierTimeout"

OUTCOME_ACKED = "acked"
OUTCOME_TIMEOUT = "timeout"

_TERMINAL_POD_PHASES = ("Succeeded", "Failed")


def job_checkpoint_policy(job: Optional[TPUJob]) -> Optional[CheckpointPolicy]:
    """The job's ACTIVE checkpoint policy, or None (no barrier, no env)."""
    if job is None:
        return None
    policy = job.spec.run_policy.checkpoint_policy
    if policy is None or not policy.enabled:
        return None
    return policy


@dataclass
class _Barrier:
    id: str
    reason: str
    deadline: float                # coordinator-clock instant
    deadline_wall: _dt.datetime    # what pods/workers see in the notice
    started: float
    stamped: Set[str] = field(default_factory=set)   # pod names noticed
    acked: Set[str] = field(default_factory=set)     # pod names acked
    outcome: str = ""              # "" while in flight


class CheckpointCoordinator:
    """Save-before-evict barriers + goodput accounting (module
    docstring). One instance serves every job in scope; the gang
    scheduler and the slice-health controller hold it as their ``ckpt``
    hook, the job controller as the env/status source.

    ``clock`` is injectable (tests drive barrier timeouts without
    sleeping); ``on_ack`` (usually ``gang.readmit``) is poked when a
    record lands inside an active barrier so a completed barrier
    releases its eviction on the next admission pass instead of the next
    resync.

    Two backend hooks keep the coordinator plane-agnostic:
    ``annotate_pod(ns, name, annotations)`` routes notice stamps through
    the backend's write path (on kube a merge PATCH to the API server —
    writing the informer-mirrored store copy would be clobbered by the
    next relist); ``barrier_capable(pods)`` says whether the gang's
    nodes have a relay that will actually deliver notices (kube: fresh
    node-agent heartbeats). When it returns False the gate degrades to
    the pre-coordinator eviction path instead of opening a barrier
    nobody can ack — a missing agent must not hang a drain. Both default
    to None: the local plane stamps through the store and is always
    relay-capable."""

    def __init__(self, store: Store, recorder=None,
                 namespace: Optional[str] = None,
                 clock=time.monotonic,
                 annotate_pod=None,
                 barrier_capable=None):
        self.store = store
        self.recorder = recorder
        self.namespace = namespace
        self.clock = clock
        self.annotate_pod = annotate_pod
        self.barrier_capable = barrier_capable
        self.on_ack = None
        self._lock = threading.RLock()
        # (ns, job) -> in-flight barrier.
        self._barriers: Dict[Tuple[str, str], _Barrier] = {}
        # (ns, job) -> outcome of the most recent completed barrier
        # (condition arc resolves off it; cleared when the job vanishes).
        self._completed: Dict[Tuple[str, str], str] = {}
        # (ns, job) -> cumulative steps lost to disruptions (goodput).
        self._lost_steps: Dict[Tuple[str, str], int] = {}
        # (ns, pod, step) save-seconds observations already exported.
        self._seen_saves: set = set()
        self._watcher = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "CheckpointCoordinator":
        self._watcher = self.store.watch(store_mod.CHECKPOINTRECORDS,
                                         self._on_record_event,
                                         replay=False)
        return self

    def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None

    def _on_record_event(self, etype: str, record: CheckpointRecord) -> None:
        """Record writes drive two things: the save-latency metric (one
        observation per new (pod, step)) and barrier progress — an ack
        landing mid-barrier pokes admission so the eviction releases
        now, not at the next resync."""
        if etype == store_mod.DELETED:
            return
        ns = record.metadata.namespace
        st = record.status
        if st.save_seconds > 0 and st.step >= 0:
            key = (ns, record.metadata.name, st.step)
            with self._lock:
                fresh = key not in self._seen_saves
                if fresh:
                    self._seen_saves.add(key)
            if fresh:
                metrics.checkpoint_save_seconds.observe(
                    st.save_seconds, job_namespace=ns)
        job_name = record.metadata.labels.get(constants.LABEL_JOB_NAME, "")
        with self._lock:
            active = (ns, job_name) in self._barriers
        if active and self.on_ack is not None:
            try:
                self.on_ack()
            except Exception:
                log.debug("on_ack poke failed", exc_info=True)

    # -- the barrier (eviction gate) -------------------------------------

    def ready_to_evict(self, namespace: str, name: str,
                       reason: str) -> bool:
        """The save-before-evict gate, consulted by every planned
        eviction path (health drain, gang.displace reclaim). True means
        evict now — either the job runs no checkpoint policy, or a
        barrier completed (full-gang ack or timeout). False means a
        barrier is in flight; the caller retries on its next
        level-triggered pass and the timeout bounds the wait."""
        with trace_mod.span("ckpt.barrier_consult",
                            job=f"{namespace}/{name}"):
            return self._ready_to_evict(namespace, name, reason)

    def _ready_to_evict(self, namespace: str, name: str,
                        reason: str) -> bool:
        job = self.store.try_get(store_mod.TPUJOBS, namespace, name)
        policy = job_checkpoint_policy(job)
        if policy is None:
            return True  # pre-coordinator path, byte-identical
        if self.barrier_capable is not None and not self.barrier_capable(
                self._live_pods(namespace, name)):
            # No relay will deliver the notice (kube node agent absent
            # or stale on some gang node): degrade to plain eviction
            # now rather than opening a barrier that can only time out.
            log.info("gang %s/%s is not barrier-capable (no node-agent "
                     "relay); evicting without a barrier", namespace,
                     name)
            return True
        key = (namespace, name)
        with self._lock:
            barrier = self._barriers.get(key)
            if barrier is not None and barrier.outcome:
                return True  # completed; waiting for release()
            pods = self._live_pods(namespace, name)
            if barrier is None:
                now = self.clock()
                barrier = _Barrier(
                    id=uuid.uuid4().hex[:12], reason=reason,
                    deadline=now + policy.barrier_timeout_seconds,
                    deadline_wall=_now_wall() + _dt.timedelta(
                        seconds=policy.barrier_timeout_seconds),
                    started=now)
                self._barriers[key] = barrier
                log.info("checkpoint barrier %s opened for %s/%s (%s); "
                         "timeout %.0fs", barrier.id, namespace, name,
                         reason, policy.barrier_timeout_seconds)
                self._record_event(
                    job, EVENT_TYPE_NORMAL, REASON_CKPT_BARRIER_REQUESTED,
                    f"Save-before-evict barrier opened ({reason}); "
                    f"evicting after full-gang checkpoint ack or "
                    f"{policy.barrier_timeout_seconds:.0f}s")
                trace_mod.JOURNAL.record(
                    namespace, name, "barrier.open", "save-before-evict",
                    f"barrier {barrier.id} opened ({reason}); evicting "
                    "after full-gang checkpoint ack or "
                    f"{policy.barrier_timeout_seconds:.0f}s",
                    barrier=barrier.id)
            # Stamp the notice level-triggered: pods missed on an earlier
            # pass (conflicts, stragglers the engine just recreated) get
            # it on this one.
            self._stamp_notices(job, pods, barrier)
            records = self._records(namespace, name)
            self._count_acks(namespace, barrier, records)
            required = self._required_acks(job, barrier, pods, records)
            if required and required <= barrier.acked:
                self._complete(job, key, barrier, OUTCOME_ACKED, records)
                return True
            if self.clock() >= barrier.deadline:
                self._complete(job, key, barrier, OUTCOME_TIMEOUT, records)
                return True
            return False

    def release(self, namespace: str, name: str) -> None:
        """Close out a completed barrier once its eviction actually
        executed (displacement landed). The outcome stays recorded for
        the condition arc; a NEW disruption opens a fresh barrier."""
        with self._lock:
            self._barriers.pop((namespace, name), None)

    def _live_pods(self, namespace: str, name: str) -> List[Pod]:
        return [p for p in self.store.list(
                    store_mod.PODS, namespace=namespace,
                    selector={constants.LABEL_JOB_NAME: name})
                if p.status.phase not in _TERMINAL_POD_PHASES]

    def _records(self, namespace: str, name: str) -> List[CheckpointRecord]:
        """The job's CheckpointRecords, restricted to replicas of the
        CURRENT world. An elastic shrink removes replica identities
        permanently, and a doomed-but-still-running pod can publish a
        record AFTER the resize pass pruned it (the data plane races
        the prune) — an out-of-world record left in the ledger would
        drag ``committed_step`` (the min over records) down to the
        shrink point and make every later restore roll the gang back.
        Filtering against the job spec is level-triggered and immune
        to that race; ``prune_departed_records`` remains as storage
        hygiene."""
        records = self.store.list(store_mod.CHECKPOINTRECORDS,
                                  namespace=namespace,
                                  selector={constants.LABEL_JOB_NAME: name})
        job = self.store.try_get(store_mod.TPUJOBS, namespace, name)
        if job is None:
            return records
        return [r for r in records
                if _record_in_world(job, r.metadata.name)]

    def _stamp_notices(self, job: Optional[TPUJob], pods: List[Pod],
                       barrier: _Barrier) -> None:
        notice = json.dumps({
            "barrier": barrier.id,
            "deadline": barrier.deadline_wall.strftime(
                "%Y-%m-%dT%H:%M:%SZ"),
            "reason": barrier.reason,
        }, sort_keys=True)
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        for pod in pods:
            if job is not None and _explicitly_non_barrier(
                    job, pod.metadata.labels.get(
                        constants.LABEL_REPLICA_TYPE, "")):
                # Roles that EXPLICITLY opted out of the barrier
                # (disruptionClass evict/ignore — RL actors) never get
                # the notice: forcing a final save on a stateless actor
                # just delays the gang's eviction. Default-policy roles
                # keep today's stamping byte-for-byte.
                continue
            if pod.metadata.name in barrier.stamped:
                continue
            if pod.metadata.annotations.get(
                    constants.ANNOTATION_PREEMPT_NOTICE) == notice:
                barrier.stamped.add(pod.metadata.name)
                continue
            if self.annotate_pod is not None:
                # Backend write path (kube: merge PATCH — the mirrored
                # store copy would be clobbered by the next relist).
                try:
                    self.annotate_pod(
                        pod.metadata.namespace, pod.metadata.name,
                        {constants.ANNOTATION_PREEMPT_NOTICE: notice})
                except Exception:
                    log.debug("stamping notice on %s/%s failed; next "
                              "consult re-stamps", pod.metadata.namespace,
                              pod.metadata.name, exc_info=True)
                    continue
                barrier.stamped.add(pod.metadata.name)
                continue

            def stamp(cur):
                if cur.metadata.annotations.get(
                        constants.ANNOTATION_PREEMPT_NOTICE) == notice:
                    return False  # already carries this barrier's notice
                cur.metadata.annotations[
                    constants.ANNOTATION_PREEMPT_NOTICE] = notice

            # Conflict-aware read-modify-write (runtime/retry.py): the
            # notice races the kubelet's status writes on every pod of
            # the gang — losing the CAS used to delay the stamp (and so
            # the worker's final save) a full consult cycle per loss;
            # re-reading and re-stamping in place converges the whole
            # gang in one pass. A pod deleted under us stays unstamped;
            # the next consult re-derives membership.
            try:
                written = retry_mod.update_with_conflict_retry(
                    self.store, store_mod.PODS, pod.metadata.namespace,
                    pod.metadata.name, stamp, component="ckpt.stamp")
            except Exception:
                log.debug("stamping notice on %s/%s failed; next "
                          "consult re-stamps", pod.metadata.namespace,
                          pod.metadata.name, exc_info=True)
                continue
            if written is not None or pod.metadata.name in (
                    barrier.stamped):
                barrier.stamped.add(pod.metadata.name)
            elif written is None:
                # stamp() aborted because the notice is already there
                # (a racing earlier pass won) — that still counts.
                cur = self.store.try_get(store_mod.PODS,
                                         pod.metadata.namespace,
                                         pod.metadata.name)
                if cur is not None and cur.metadata.annotations.get(
                        constants.ANNOTATION_PREEMPT_NOTICE) == notice:
                    barrier.stamped.add(pod.metadata.name)

    def _count_acks(self, namespace: str, barrier: _Barrier,
                    records: List[CheckpointRecord]) -> None:
        for r in records:
            if (r.status.barrier_id == barrier.id
                    and r.metadata.name not in barrier.acked):
                barrier.acked.add(r.metadata.name)
                metrics.checkpoint_barrier_acks.inc(job_namespace=namespace)

    @staticmethod
    def _required_acks(job: Optional[TPUJob], barrier: _Barrier,
                       pods: List[Pod],
                       records: List[CheckpointRecord]) -> Set[str]:
        """Who must ack before the barrier completes early: every
        stamped Running pod of a BARRIER-class role (the resolver
        defaults worker/serving to barrier — workers hold the model
        shards, a distributed checkpoint missing one shard is
        unrestorable, so a worker that has not even made its FIRST save
        still gates the eviction; a serving replica's "save" is
        re-spooling in-flight sequences, serve/worker.py), plus any
        stamped pod already known to checkpoint (it carries a
        CheckpointRecord — covers non-worker types that opted into the
        hook). Coordinator-only pods (chief/ps) and evict/ignore-class
        roles (RL actors) that never published a record are never
        waited on; the barrier timeout bounds everything else."""
        with_records = {r.metadata.name for r in records}
        gated = {p.metadata.name for p in pods
                 if p.status.phase == "Running"
                 and job is not None
                 and effective_role_policy(
                     job, p.metadata.labels.get(
                         constants.LABEL_REPLICA_TYPE, "")).barrier}
        return barrier.stamped & (with_records | gated)

    def _complete(self, job: Optional[TPUJob], key: Tuple[str, str],
                  barrier: _Barrier, outcome: str,
                  records: List[CheckpointRecord]) -> None:
        barrier.outcome = outcome
        ns = key[0]
        committed = _committed_step(records)
        progress = max((r.status.progress_step for r in records
                        if r.status.progress_step >= 0), default=-1)
        lost = 0
        if progress >= 0:
            lost = max(0, progress - (committed if committed is not None
                                      else 0))
        metrics.checkpoint_barriers.inc(job_namespace=ns, outcome=outcome)
        metrics.steps_lost_per_disruption.observe(float(lost),
                                                  job_namespace=ns)
        self._lost_steps[key] = self._lost_steps.get(key, 0) + lost
        self._publish_goodput(key, progress, job)
        elapsed = self.clock() - barrier.started
        # Phase attribution: open->resolve elapsed is the disruption's
        # "barrier_wait" — the time capacity reclaim spent waiting on
        # final saves (runtime/trace.py; docs/observability.md).
        trace_mod.note_phase("barrier_wait", max(0.0, elapsed))
        trace_mod.JOURNAL.record(
            key[0], key[1], "barrier.resolved", outcome,
            f"barrier {barrier.id} {outcome} after {elapsed:.2f}s "
            f"({len(barrier.acked)}/{len(barrier.stamped)} acks, "
            f"committed step {committed}, ~{lost} step(s) lost)",
            barrier=barrier.id, committed=committed, lost=lost)
        if outcome == OUTCOME_ACKED:
            log.info("checkpoint barrier %s for %s/%s: full-gang ack at "
                     "step %s in %.2fs; releasing eviction", barrier.id,
                     key[0], key[1], committed, elapsed)
            self._record_event(
                job, EVENT_TYPE_NORMAL, REASON_CKPT_BARRIER_SAVED,
                f"All {len(barrier.acked)} replica(s) checkpointed at "
                f"step {committed} in {elapsed:.2f}s; evicting")
        else:
            log.warning("checkpoint barrier %s for %s/%s TIMED OUT after "
                        "%.2fs (%d/%d acks); evicting anyway, ~%d "
                        "step(s) lost", barrier.id, key[0], key[1],
                        elapsed, len(barrier.acked), len(barrier.stamped),
                        lost)
            self._record_event(
                job, EVENT_TYPE_WARNING, REASON_CKPT_BARRIER_TIMEOUT,
                f"Checkpoint barrier timed out after {elapsed:.2f}s "
                f"({len(barrier.acked)}/{len(barrier.stamped)} acks); "
                f"evicting anyway — about {lost} step(s) lost")
        self._completed[key] = outcome

    def _publish_goodput(self, key: Tuple[str, str], progress: int,
                         job: Optional[TPUJob] = None) -> None:
        lost = self._lost_steps.get(key, 0)
        if progress > 0:
            ratio = max(0.0, (progress - lost) / progress)
            metrics.job_goodput_ratio.set(
                ratio, job_namespace=key[0], job=key[1])
            if job is not None and _heterogeneous(job):
                # Heterogeneous jobs additionally publish the learner
                # lane: records come only from barrier-class (learner)
                # replicas — actors publish none — so this IS the
                # learner gang's goodput, and actor-only churn must
                # leave it at 1.0 (docs/rl.md).
                metrics.learner_goodput_ratio.set(
                    ratio, job_namespace=key[0], job=key[1])

    # -- restore-with-identity (bootstrap env) ---------------------------

    def bootstrap_env(self, job: TPUJob) -> Dict[str, str]:
        """Checkpoint env for a pod being created NOW: the policy knobs
        plus — when a committed checkpoint exists — the restore step.
        Derived live from the records, not job.status, so the first
        recreate after a barrier already sees the barrier's step."""
        policy = job_checkpoint_policy(job)
        if policy is None:
            return {}
        env = {constants.ENV_CKPT_DIR: policy.directory,
               constants.ENV_CKPT_MAX_TO_KEEP: str(policy.max_to_keep)}
        if policy.interval_steps is not None:
            env[constants.ENV_CKPT_INTERVAL_STEPS] = \
                str(policy.interval_steps)
        if policy.interval_seconds is not None:
            env[constants.ENV_CKPT_INTERVAL_SECONDS] = \
                str(policy.interval_seconds)
        committed = self.committed_step(job.metadata.namespace,
                                        job.metadata.name)
        if committed is not None:
            env[constants.ENV_RESTORE_STEP] = str(committed)
        return env

    def committed_step(self, namespace: str, name: str) -> Optional[int]:
        """The step a rebind restores from: the newest step EVERY
        checkpointing replica has durably saved (min over records — a
        distributed checkpoint is only usable when all shards landed)."""
        return _committed_step(self._records(namespace, name))

    def prune_departed_records(self, namespace: str, job_name: str,
                               rtype: str, keep: int,
                               up_to: int) -> None:
        """Drop the CheckpointRecords of replicas an elastic shrink
        removed from the world (indices ``keep``..``up_to``-1 of
        ``rtype``). Records are keyed by pod name, so a departed
        replica's record would otherwise linger forever and pin
        ``committed_step`` (the min over records) at the shrink point —
        every later restore would roll the surviving gang back to the
        pre-shrink step. Called by the resize pass (controller/gang.py)
        after the smaller world landed; level-triggered deletes, safe
        to repeat."""
        from tf_operator_tpu_torch.api.types import gen_general_name

        for index in range(keep, up_to):
            self.store.try_delete(
                store_mod.CHECKPOINTRECORDS, namespace,
                gen_general_name(job_name, rtype, index))

    def restored_step(self, namespace: str, name: str) -> Optional[int]:
        steps = [r.status.restored_from_step
                 for r in self._records(namespace, name)
                 if r.status.restored_from_step is not None]
        return min(steps) if steps else None

    # -- job-status roll-in (engine hook) --------------------------------

    def sync_job_status(self, job: TPUJob) -> None:
        """Called by the engine inside every job sync: surface the
        barrier arc as a CheckpointBarrier condition and mirror
        lastCheckpointStep / restoredFromStep onto the job status. Pure
        status mutation — the engine's change-diff decides whether a
        write happens, so an idle sync stays writeless."""
        policy = job_checkpoint_policy(job)
        if policy is None:
            return
        key = (job.metadata.namespace, job.metadata.name)
        with self._lock:
            barrier = self._barriers.get(key)
            in_flight = barrier is not None and not barrier.outcome
            reason_done = self._completed.get(key)
        if in_flight:
            cond.update_job_conditions(
                job.status, JobConditionType.CHECKPOINT_BARRIER,
                JOB_CKPT_BARRIER_PENDING_REASON,
                f"TPUJob {job.metadata.name} is saving a final "
                f"checkpoint before a planned disruption "
                f"({barrier.reason})")
        elif reason_done is not None:
            cond.mark_condition_false(
                job.status, JobConditionType.CHECKPOINT_BARRIER,
                JOB_CKPT_BARRIER_SAVED_REASON
                if reason_done == OUTCOME_ACKED
                else JOB_CKPT_BARRIER_TIMEOUT_REASON,
                f"TPUJob {job.metadata.name} barrier resolved "
                f"({reason_done}); gang evicted for rebind")
        committed = self.committed_step(*key)
        if committed is not None:
            job.status.last_checkpoint_step = committed
        restored = self.restored_step(*key)
        if restored is not None:
            job.status.restored_from_step = restored
        records = self._records(*key)
        progress = max((r.status.progress_step for r in records
                        if r.status.progress_step >= 0), default=-1)
        with self._lock:
            self._publish_goodput(key, progress, job)

    def _record_event(self, job, etype: str, reason: str,
                      msg: str) -> None:
        if self.recorder is not None and job is not None:
            self.recorder.event(job, etype, reason, msg)


def _explicitly_non_barrier(job: TPUJob, rtype: str) -> bool:
    """True when the role EXPLICITLY opted out of save-before-evict
    (RolePolicy.disruptionClass evict/ignore). Explicitness matters:
    resolver DEFAULTS must not relax behavior — a chief/ps pod with no
    RolePolicy resolves to evict-class but keeps getting the notice it
    always got (flag-off parity, docs/rl.md)."""
    eff = effective_role_policy(job, rtype)
    return eff.explicit_disruption and eff.disruption_class in (
        DisruptionClass.EVICT, DisruptionClass.IGNORE)


def _heterogeneous(job: TPUJob) -> bool:
    """A job with at least one explicitly non-barrier role — the
    actor/learner split that makes a separate learner goodput lane
    meaningful."""
    return any(_explicitly_non_barrier(job, rt)
               for rt in job.spec.replica_specs)


def _record_in_world(job: TPUJob, record_name: str) -> bool:
    """Whether a record's replica identity ({job}-{rtype}-{index}, the
    pod naming contract) exists in the job's CURRENT spec. Records with
    unrecognized names are kept (fail open: better a conservative
    committed step than dropping a live shard's ack)."""
    prefix = job.metadata.name + "-"
    if not record_name.startswith(prefix):
        return True
    rtype, sep, raw = record_name[len(prefix):].rpartition("-")
    if not sep:
        return True
    try:
        index = int(raw)
    except ValueError:
        return True
    spec = job.spec.replica_specs.get(rtype)
    if spec is None:
        return True
    return index < (spec.replicas or 0)


def _committed_step(records: List[CheckpointRecord]) -> Optional[int]:
    steps = [r.status.step for r in records if r.status.step >= 0]
    return min(steps) if steps else None


def _now_wall() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)
