"""Gang scheduling: all-or-nothing SliceGroup admission (port of
tf_operator_tpu/controller/gang.py; slices are counted in GPUs through
the port's ``parse_accelerator``, so ``total_chips`` is a GPU budget).

Reference parity: Volcano PodGroup sync (common/job_controller.go:218-322)
and the gang annotations stamped on pods (tensorflow/pod.go:221-235).
The PodGroup fields the reference forwards to Volcano — ``queue``,
``priorityClassName``, ``minMember``/``minResources``
(common/pkg/apis/common/v1/types.go:189-204, minResources from
top-priority pods at common/job.go:423-460) — drive admission here the
way Volcano acts on them there: priority orders the queue, queues are
isolated admission lanes with optional capacity quotas, and preemption
(opt-in) evicts lower-priority not-yet-running groups.

Device-native difference: the gang unit is a *slice* — admission is
all-or-nothing against whole-slice GPU capacity, not per-pod resources.
A SliceGroup carries minMember (pod gang) plus the slice shape; the
scheduler admits groups when the cluster's GPU budget fits the whole
request (a slice's NVLink world is indivisible). The data-plane backend holds
gang-scheduled pods in Pending until their group is admitted, which is
exactly how Volcano gates pods.
"""

from __future__ import annotations

import datetime as _dt
import logging
import threading
import time
from typing import Dict, List, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    ObjectMeta,
    Pod,
    ReplicaSpec,
    ReplicaType,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TPUJob,
    effective_role_policy,
)
from tf_operator_tpu_torch.controller.control import controller_owner_ref
from tf_operator_tpu_torch.controller.engine import GangScheduler
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    REASON_GANG_RESIZED,
)
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.gang")

PHASE_PENDING = "Pending"
PHASE_INQUEUE = "Inqueue"
PHASE_RUNNING = "Running"


def _chips_for(group: SliceGroup) -> int:
    sl = group.spec.slice
    if not sl.accelerator:
        return 0
    from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator

    topo = parse_accelerator(sl.accelerator, sl.topology, max(1, sl.num_slices))
    return topo.total_chips


def _chips_per_slice(group: SliceGroup) -> int:
    """GPUs of ONE slice — the unit that must land whole inside one
    NVLink domain (multislice groups span domains over the data-center
    network by design)."""
    sl = group.spec.slice
    if not sl.accelerator:
        return 0
    from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator

    return parse_accelerator(sl.accelerator, sl.topology,
                             max(1, sl.num_slices)).chips


class SliceGangScheduler(GangScheduler):
    """Priority/queue-aware whole-slice admission. ``total_chips=None`` =
    unlimited capacity (admission always succeeds, groups still tracked
    for observability) — unless a ``capacity_provider`` is bound, in
    which case it supplies the budget per pass (the kube backend feeds
    live node inventory through it; see controller/binder.py).

    Ordering: groups are considered by (priorityClass value desc,
    creation time asc) — a higher-priority group is always offered
    capacity first, FIFO breaks ties. ``priority_classes`` maps
    priorityClass names to integer values (the PriorityClass-object
    analog); a name that parses as an integer is its own value; unknown
    names are value 0 (warned once).

    Queues (``spec.queue``) are isolated admission lanes: head-of-line
    blocking under ``strict``/``aged`` fairness applies only within the
    blocked group's own queue, so one queue's backlog never stalls
    another's admissions. ``queue_quotas`` optionally caps the chips a
    queue may hold concurrently (Volcano queue-capacity analog) —
    isolation by construction, not just by ordering.

    ``fairness`` decides what happens when a group doesn't fit:

    - ``"backfill"``: skip it, keep admitting later smaller groups —
      maximum utilization, but a large job can starve behind a stream of
      small ones;
    - ``"strict"``: head-of-line per queue — nothing behind a
      non-fitting group admits (in its queue) until it fits;
    - ``"aged"`` (default): backfill until a skipped group has waited
      ``aging_seconds`` since it last became Pending; from then on it
      blocks its queue, so freed capacity accumulates for it. Priority
      interacts: while a skipped group waits, only *equal-priority*
      groups may backfill past it — a lower-priority group never
      leapfrogs a waiting higher-priority one, i.e. a high-priority
      group ages out backfill by lower-priority work immediately.

    ``preemption`` (default off, Volcano's job-level preemption analog):
    when a group doesn't fit, groups that are admitted but not yet
    running (phase Inqueue) and have strictly lower priority are evicted
    back to Pending — lowest priority, youngest first — until the new
    group fits. Eviction is real: the victim's pods are deleted through
    pod control (Volcano evicts pods, not just bookkeeping), the engine
    recreates them, and the recreated pods re-gate on the now-Pending
    group — so freed chips are never double-booked by a victim whose
    pods had already passed the admission gate. Running groups (gang
    fully up: minMember live pods, tracked from pod state each sync)
    are never preempted; a Running group whose live count falls below
    minMember is demoted back to Inqueue and becomes preemptible again.

    ``elastic`` (default off, docs/elastic.md) adds the resize pass:
    gangs declaring spec.slice.minSlices/maxSlices are GROWN into idle
    capacity (only when nothing feasible is waiting for it) and SHRUNK
    — instead of displaced — when quota reclaim or a slice-health
    drain needs their chips, riding the engine's world-restart +
    restore-with-identity machinery, with shrinks gated on the
    save-before-evict barrier. A gang is never resized below its
    minSlices floor, and in-flight grows stay charged against the chip
    budget until their group spec catches up, so the admitted-chips
    invariant holds mid-resize.
    """

    def __init__(self, store: Store, total_chips: Optional[int] = None,
                 fairness: str = "aged", aging_seconds: float = 300.0,
                 priority_classes: Optional[Dict[str, int]] = None,
                 queue_quotas: Optional[Dict[str, int]] = None,
                 preemption: bool = False,
                 pod_control=None,
                 scheduled_pods_occupy: bool = False,
                 capacity_provider=None,
                 domain_capacity_provider=None,
                 draining_provider=None,
                 quota=None,
                 ckpt=None,
                 cp_health=None,
                 elastic: bool = False,
                 resize_signals=None,
                 recorder=None):
        if fairness not in ("backfill", "strict", "aged"):
            raise ValueError(f"unknown gang fairness {fairness!r}")
        self.store = store
        self.total_chips = total_chips
        # When total_chips is None, a provider (if bound) supplies the
        # budget per admission pass — the kube backend derives it from
        # live node inventory (sum of schedulable nodes' allocatable
        # chips), so admission tracks the real cluster the way Volcano's
        # allocator does, instead of trusting a static flag.
        self.capacity_provider = capacity_provider
        # Optional structural-feasibility probe: largest single NVLink
        # domain's GPU capacity. A group whose per-slice chips exceed
        # it can never be placed whole and is skipped as infeasible
        # instead of booking budget forever (kube backend binds this to
        # node inventory; None = no topology knowledge, aggregate only).
        self.domain_capacity_provider = domain_capacity_provider
        # Optional data-plane drain feedback: (ns, group) -> count of
        # deleted pods whose PROCESSES are still dying. Their chips
        # stay counted so a preemptor is never admitted into a victim's
        # termination-grace window (the local backend binds
        # LocalProcessBackend.draining_gang_groups here; kubelet has
        # the same window on the kube backend, where
        # scheduled_pods_occupy + the pod object's lifetime covers it).
        self.draining_provider = draining_provider
        # Optional multi-tenant quota hook (controller/quota.py
        # TenantQueueManager): consulted per pending group each
        # admission pass — it decides quota ELIGIBILITY (nominal /
        # borrow / reclaim), this scheduler keeps deciding physical
        # fit. None = pre-quota behavior, byte-identical.
        self.quota = quota
        if quota is not None and getattr(quota, "priority_of", None):
            quota.priority_of = self._priority_of
        # Optional checkpoint coordinator (controller/ckpt.py): displace
        # becomes a save-then-evict barrier for jobs whose
        # checkpointPolicy opts in — the displacement is deferred until
        # the gang acked a final save or the barrier timed out. None =
        # pre-coordinator eviction, byte-identical.
        self.ckpt = ckpt
        # Optional ControlPlaneHealth (runtime/retry.py): while the API
        # server is degraded, NEW disruptions — priority preemptions,
        # quota-reclaim displacements — are deferred (a half-executed
        # eviction against an unreachable apiserver is how chips get
        # double-booked); completing already-started evictions is never
        # gated. None = pre-degraded behavior, byte-identical.
        self.cp_health = cp_health
        self.fairness = fairness
        self.aging_seconds = aging_seconds
        self.priority_classes = dict(priority_classes or {})
        self.queue_quotas = dict(queue_quotas or {})
        self.preemption = preemption
        # How preemption deletes victim pods. The owning controller
        # binds its engine's PodControl after construction (the local
        # backend reacts to store deletes; the kube backend issues API
        # deletes); unbound, eviction falls back to direct store deletes.
        self.pod_control = pod_control
        # True when a controller auto-bound its engine control (vs an
        # explicit pod_control= argument, which rebinds must respect).
        self._pod_control_auto_bound = False
        # Kube backend: a Pending pod bound to a node (ContainerCreating)
        # already occupies its chips even though nothing stamps
        # gang_released there; local/agent backends must NOT set this —
        # their gate-held pods also carry node bindings, and treating
        # those as occupying would read every freshly created gang as
        # mid-eviction and kill its pods.
        self.scheduled_pods_occupy = scheduled_pods_occupy
        # Optional PodDisruptionBudget sync (reference SyncPdb) — bound
        # by the kube backend so cluster eviction machinery respects
        # the gang's minMember; local backends have no evictor.
        self.pdb_control = None
        # Elastic resize pass (docs/elastic.md): with elastic=True,
        # gangs whose spec.slice declares minSlices/maxSlices are
        # GROWN one slice at a time into idle capacity and SHRUNK
        # (instead of displaced) when quota reclaim or a slice-health
        # drain needs their chips — the resize mutates the job's slice
        # count + coupled worker replicas and rides the engine's
        # world-restart + restore-with-identity machinery. Off =
        # behavior byte-identical to the pre-elastic scheduler.
        self.elastic = elastic
        # Optional resize-decision signal provider:
        # (namespace, name) -> {signal: value}, e.g. serving_queue_depth.
        # The serving autoscaler (controller/autoscaler.py) both acts on
        # these values and doubles as the provider, so the pass attaches
        # the demand each resize decision saw to its record/event.
        self.resize_signals = resize_signals
        # Optional event recorder (GangResized events).
        self.recorder = recorder
        # (ns, name) -> monotonic time the shrink first consulted the
        # save-before-evict barrier (resize_barrier_seconds metric).
        self._resize_barrier_t0: Dict[tuple, float] = {}
        # (ns, name) -> (target slice count, resourceVersion of the
        # newest job read carrying the target, or None before one) of
        # grows planned but whose GROUP spec has not caught up yet. A
        # grow executes outside the scheduler lock, so without a charge
        # two passes (or a pass and a pending admission) could spend the
        # same free chips and over-admit once the groups sync. The
        # ledger charges until the group follows, not only until the
        # job write is seen: a later read of the job may be stale (a
        # lagging cache) and show it before the grow. The persisted
        # job-vs-group spec delta (_elastic_inflight_extras) carries
        # the charge across an operator crash-restart, where the
        # in-memory ledger is lost (pinned by elastic chaos seed 100).
        self._grow_inflight: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        # Groups already flagged infeasible / unknown-priority (log once).
        self._warned_infeasible: set = set()
        self._warned_priority: set = set()

    # -- engine hooks ---------------------------------------------------

    def sync_slice_group(self, job: TPUJob,
                         replica_specs: Dict[str, ReplicaSpec]) -> None:
        """Create/refresh the job's SliceGroup and run admission
        (reference SyncPodGroup, job_controller.go:218-245)."""
        total = 0
        for rt, s in replica_specs.items():
            n = s.replicas or 0
            eff = effective_role_policy(job, rt)
            if eff.elastic:
                # An elastic-band role (RL actor pool, docs/rl.md) gangs
                # at its FLOOR: the job must not wait on — or be demoted
                # by — actors above minReplicas, which come and go by
                # design. Roles without an explicit band keep counting
                # in full, so default minMember is byte-identical.
                n = min(n, eff.min_replicas or 0)
            total += n
        min_member = total
        queue = ""
        priority = ""
        sp = job.spec.run_policy.scheduling_policy
        if sp is not None:
            if sp.min_available is not None:
                min_member = sp.min_available
            queue = sp.queue
            priority = sp.priority_class
        # Tenant-queue membership (controller/quota.py): spec.queueName
        # is authoritative when set — the group admits through that
        # TenantQueue's quota AND uses it as its fairness lane.
        if job.spec.queue_name:
            queue = job.spec.queue_name

        desired_spec = SliceGroupSpec(min_member=min_member, queue=queue,
                                      priority_class=priority,
                                      slice=job.spec.slice.deepcopy())
        existing = self.store.try_get(store_mod.SLICEGROUPS,
                                      job.metadata.namespace,
                                      job.metadata.name)
        if existing is None:
            # Pods run only while their group is admitted, so a gang
            # whose pods already hold devices had its group admitted by
            # an operator whose state is gone: on the kube backend
            # SliceGroups live in the leader's memory, and a standby
            # that took over the lease rebuilds them. Such a group is
            # adopted as admitted; created Pending, the next pass would
            # read it as mid-eviction and kill the running gang. Only
            # pods this job owns and that are not terminating count: a
            # job deleted and re-created under its name finds the old
            # job's pods still running out their grace, and its group
            # must go through admission.
            adopted = any(
                p.metadata.deletion_timestamp is None
                and (ref := p.metadata.controller_ref()) is not None
                and ref.uid == job.metadata.uid
                for p in self._pods_occupying(job.metadata.namespace,
                                              job.metadata.name))
            group = SliceGroup(spec=desired_spec,
                               status=SliceGroupStatus(
                                   phase=(PHASE_INQUEUE if adopted
                                          else PHASE_PENDING),
                                   pending_since=_now()))
            group.metadata.name = job.metadata.name
            group.metadata.namespace = job.metadata.namespace
            group.metadata.labels = {constants.LABEL_JOB_NAME: job.metadata.name}
            group.metadata.owner_references = [controller_owner_ref(job)]
            self.store.create(store_mod.SLICEGROUPS, group)
            metrics.slicegroups_created.inc(
                job_namespace=job.metadata.namespace)
        else:
            if existing.spec.to_dict() != desired_spec.to_dict():
                existing.spec = desired_spec
                self.store.update(store_mod.SLICEGROUPS, existing)
            self._maybe_promote_running(existing, job)
        if self.pdb_control is not None:
            self.pdb_control.sync(job, min_member)
        self._admit()

    def _maybe_promote_running(self, group: SliceGroup, job: TPUJob) -> None:
        """Sync phase from observed pod state (Volcano PodGroup-phase
        analog): Inqueue -> Running once the gang actually runs
        (minMember pods active/succeeded), and Running -> Inqueue when
        the live count drops below minMember again (a gang that lost
        pods is no longer "fully up" and re-enters the preemptible set
        — phase is two-way, never latched)."""
        statuses = (job.status.replica_statuses or {}).values()
        live = sum((rs.active or 0) + (rs.succeeded or 0) for rs in statuses)
        min_member = group.spec.min_member or 0
        if group.status.phase == PHASE_INQUEUE:
            if live > 0 and live >= min_member:
                if group.status.displaced_reason and not \
                        self._gang_live_in_store(group, min_member):
                    # Displaced by a slice-health drain: the job's
                    # replica tallies are STALE on the first sync after
                    # the eviction (they still count the deleted pods),
                    # so promotion must verify against live pod state —
                    # otherwise the group snaps back to Running and the
                    # repair arc (Restarting condition, rebind
                    # stopwatch) is erased before the rebind happened.
                    return
                group.status.phase = PHASE_RUNNING
                # A drain-displaced gang that reached Running again has
                # completed its repair arc: clear the marker so the
                # engine flips the job's Restarting condition back to
                # Running.
                group.status.displaced_reason = ""
                if (group.status.resizing_reason
                        and self._gang_settled(group, job, min_member)):
                    group.status.resizing_reason = ""
                self.store.update_status(store_mod.SLICEGROUPS, group)
                log.info("slice group %s running (%d live pods)",
                         group.metadata.name, live)
        elif group.status.phase == PHASE_RUNNING:
            if live < min_member:
                group.status.phase = PHASE_INQUEUE
                self.store.update_status(store_mod.SLICEGROUPS, group)
                log.info("slice group %s lost pods (%d live < minMember "
                         "%d); demoted to Inqueue", group.metadata.name,
                         live, min_member)
            elif (group.status.resizing_reason
                    and self._gang_settled(group, job, min_member)):
                # Resize arc complete: the gang is fully up at the NEW
                # size (exact pod count — the job's stale tallies alone
                # would clear the marker before the world restart even
                # started). Clearing re-arms the resize pass and flips
                # the job's Resizing condition back (engine.py).
                group.status.resizing_reason = ""
                self.store.update_status(store_mod.SLICEGROUPS, group)
                log.info("slice group %s resize settled (%d live pods)",
                         group.metadata.name, live)

    def _gang_live_in_store(self, group: SliceGroup,
                            min_member: int) -> bool:
        """Ground truth for a displaced group's liveness: actually
        Running/Succeeded pods in the store, not job-status tallies."""
        live = sum(
            1 for p in self.store.list(
                store_mod.PODS, namespace=group.metadata.namespace,
                selector={constants.LABEL_JOB_NAME: group.metadata.name})
            if p.status.phase in ("Running", "Succeeded"))
        return live >= min_member

    def _gang_settled(self, group: SliceGroup, job: TPUJob,
                      min_member: int) -> bool:
        """A resized gang has SETTLED when the store holds exactly the
        desired pod count for the job's current spec and the gang is
        running — i.e. the world restart finished and no stale pods of
        the old size remain. Job-status tallies are not enough: right
        after a shrink they still count the doomed pods."""
        desired = sum(s.replicas or 0
                      for s in job.spec.replica_specs.values())
        pods = [p for p in self.store.list(
                    store_mod.PODS, namespace=group.metadata.namespace,
                    selector={constants.LABEL_JOB_NAME:
                              group.metadata.name})
                if p.status.phase not in ("Succeeded", "Failed")]
        running = sum(1 for p in pods if p.status.phase == "Running")
        return len(pods) == desired and running >= min_member

    def displace(self, namespace: str, name: str, reason: str) -> bool:
        """Slice-health drain hook (controller/health.py): push an
        admitted group back through admission after its pods were
        evicted off a degraded node. Phase -> Pending releases the
        group's GPU booking and its NVLink-domain reservation; a fresh
        pending_since grants a new aging grace window; the kept
        creationTimestamp means the displaced group re-enters the queue
        at its original priority AHEAD of equal-priority newcomers
        (admission orders by creation time — see _admit). The
        displaced_reason marker surfaces as the job's Restarting
        condition (engine.py) until the gang runs again."""
        with trace_mod.span("gang.displace", job=f"{namespace}/{name}"):
            return self._displace(namespace, name, reason)

    def _displace(self, namespace: str, name: str, reason: str) -> bool:
        group = self.store.try_get(store_mod.SLICEGROUPS, namespace, name)
        if group is None or group.status.phase == PHASE_PENDING:
            return False
        if (self.cp_health is not None
                and not self.cp_health.allow_disruption("displace")):
            # Degraded control plane: initiating a displacement now
            # would open a checkpoint barrier (or delete pods) it may
            # never be able to enforce; the caller's level-triggered
            # pass retries once the API server answers again.
            trace_mod.JOURNAL.record(
                namespace, name, "disruption.deferred",
                "controlplane-degraded",
                f"displacement ({reason}) deferred: the API server is "
                "degraded (docs/robustness.md)")
            return False
        if self.ckpt is not None and not self.ckpt.ready_to_evict(
                namespace, name, reason):
            # Save-before-evict barrier in flight (controller/ckpt.py):
            # hold the displacement; the caller's level-triggered pass
            # (quota reclaim re-derived per _admit, health retry per
            # health_pass) retries, and an ack landing mid-barrier pokes
            # readmit so release happens promptly. The barrier timeout
            # bounds the wait — a reclaim or drain can never hang on a
            # wedged worker.
            return False
        group.status.phase = PHASE_PENDING
        group.status.pending_since = _now()
        group.status.displaced_reason = reason
        try:
            self.store.update_status(store_mod.SLICEGROUPS, group)
        except (store_mod.ConflictError, store_mod.NotFoundError):
            return False  # racing sync; the next health pass retries
        if self.ckpt is not None:
            # Displacement landed: close the barrier episode (a future
            # disruption opens a fresh one).
            self.ckpt.release(namespace, name)
        log.info("displaced slice group %s/%s (%s); re-entering "
                 "admission at original priority", namespace, name,
                 reason)
        trace_mod.JOURNAL.record(
            namespace, name, "displaced", "drain",
            f"gang displaced back through admission: {reason}")
        self._admit()  # freed chips may admit it (or others) right away
        return True

    def displaced_reason(self, job: TPUJob) -> Optional[str]:
        """Engine hook: non-empty while the job's gang is displaced by a
        drain and not yet fully back up."""
        group = self.store.try_get(store_mod.SLICEGROUPS,
                                   job.metadata.namespace,
                                   job.metadata.name)
        if group is None:
            return None
        return group.status.displaced_reason or None

    def resize_reason(self, job: TPUJob) -> Optional[str]:
        """Engine hook: non-empty while an elastic resize has been
        applied to the job's gang and the new world has not fully
        settled — rolled into the job's Resizing condition."""
        group = self.store.try_get(store_mod.SLICEGROUPS,
                                   job.metadata.namespace,
                                   job.metadata.name)
        if group is None:
            return None
        return group.status.resizing_reason or None

    # -- elastic resize (docs/elastic.md) -------------------------------

    def try_shrink(self, namespace: str, name: str, remove_slices: int,
                   reason_label: str, message: str) -> Optional[bool]:
        """Elastic shrink request (the slice-health controller's and
        harnesses' entry point). Returns:

        - ``None``  — not applicable: elastic off, the gang declares no
          ``minSlices``, or removing ``remove_slices`` would go below
          it. The caller falls back to its non-elastic path (full
          drain / displacement).
        - ``False`` — applicable but held: save-before-evict barrier in
          flight, degraded control plane, or a previous resize still
          settling. The caller's level-triggered pass retries; the
          barrier timeout bounds the wait.
        - ``True``  — the smaller world landed in the job spec; the
          engine's restart-with-identity + restore path takes it from
          here.
        """
        if not self.elastic or remove_slices <= 0:
            return None
        group = self.store.try_get(store_mod.SLICEGROUPS, namespace, name)
        job = self.store.try_get(store_mod.TPUJOBS, namespace, name)
        if group is None or job is None:
            return None
        sl = job.spec.slice
        if not sl.accelerator or sl.min_slices is None:
            return None
        new_n = sl.num_slices - remove_slices
        if new_n < sl.min_slices:
            return None  # would go below the floor: not shrinkable
        if group.status.resizing_reason:
            return False  # previous resize still settling
        return self._resize(namespace, name, new_n, "shrink",
                            reason_label, message)

    def resize_role(self, namespace: str, name: str, rtype: str,
                    new_replicas: int, reason_label: str,
                    message: str) -> Optional[bool]:
        """Elastic ROLE resize (docs/rl.md): change the replica count of
        one elastic-band role (an RL actor pool) inside its
        RolePolicy.minReplicas..maxReplicas band. Unlike the slice
        resize lane this is NOT a world restart — the band's cluster
        entry is outside every bootstrap hash
        (gpu_controller._compute_bootstrap_hash), the gang's minMember
        counts the band at its floor (sync_slice_group), and no
        save-before-evict barrier opens (the band is preemptible by
        contract) — so the engine just deletes out-of-range pods or
        creates missing ones while the learner world keeps stepping.
        Deliberately caller-driven (tests, harnesses, operators, a
        future actor autoscaler): the control plane never auto-shrinks
        a pool on health events, because no signal exists to grow it
        back (CPU capacity is not chip capacity). Works on both
        backends and does not require ``elastic`` (that flag gates
        SLICE resizes, which mutate container env).

        Returns None = not applicable (no such job/role, or the role
        declares no explicit band), False = held (degraded control
        plane, clamp made it a no-op), True = the new pool size landed
        in the job spec."""
        rt = rtype.lower()
        job = self.store.try_get(store_mod.TPUJOBS, namespace, name)
        if job is None:
            return None
        eff = effective_role_policy(job, rt)
        if not eff.elastic:
            return None
        if (self.cp_health is not None
                and not self.cp_health.allow_disruption("resize")):
            trace_mod.JOURNAL.record(
                namespace, name, "disruption.deferred",
                "controlplane-degraded",
                f"role {rt} resize ({message}) deferred: the API "
                "server is degraded (docs/robustness.md)")
            return False
        target = max(eff.min_replicas or 0,
                     min(new_replicas, eff.max_replicas or new_replicas))
        applied: Dict[str, int] = {}

        def mutate(cur):
            spec = cur.spec.replica_specs.get(rt)
            if spec is None:
                return False
            cur_n = spec.replicas or 0
            if cur_n == target:
                return False
            applied["old"] = cur_n
            spec.replicas = target

        from tf_operator_tpu_torch.runtime import retry as retry_mod

        job = retry_mod.update_with_conflict_retry(
            self.store, store_mod.TPUJOBS, namespace, name, mutate,
            component="gang.resize_role")
        if job is None or "old" not in applied:
            return False
        direction = "grow" if target > applied["old"] else "shrink"
        if direction == "shrink" and self.ckpt is not None:
            # Departed band replicas must not pin committed_step: prune
            # their CheckpointRecords like a slice shrink does (actors
            # normally publish none — level-triggered no-op then).
            self.ckpt.prune_departed_records(
                namespace, name, rt, target, applied["old"])
        metrics.gang_resizes.inc(direction=direction, reason=reason_label)
        metrics.actor_pool_replicas.set(target, job_namespace=namespace,
                                        job=name, replica_type=rt)
        detail = (f"{direction} {rt} pool to {target} replica(s): "
                  f"{message}")
        log.info("resized role %s of %s/%s: %s", rt, namespace, name,
                 detail)
        trace_mod.JOURNAL.record(
            namespace, name, "role-resized", reason_label, detail,
            direction=direction, replica_type=rt, replicas=target)
        if self.recorder is not None:
            try:
                self.recorder.event(
                    job, EVENT_TYPE_NORMAL, REASON_GANG_RESIZED,
                    f"Role {rt} of {name} resized ({detail}); the "
                    "learner world keeps running")
            except Exception:
                log.debug("GangResized event emit failed", exc_info=True)
        return True

    def _try_shrink_for_reclaim(self, namespace: str, name: str,
                                chips_needed: int, reason: str):
        """Quota reclaim prefers shrink-to-min over displacement:
        returns (handled, landed). handled=False — the gang is not
        elastic-shrinkable, the caller displaces as before.
        handled=True, landed=False — a shrink is in flight (barrier /
        degraded / settling): hold the displacement, the level-
        triggered pass re-derives the remaining demand and retries."""
        group = self.store.try_get(store_mod.SLICEGROUPS, namespace, name)
        job = self.store.try_get(store_mod.TPUJOBS, namespace, name)
        if group is None or job is None:
            return False, False
        if group.status.resizing_reason:
            # A resize is still settling; displacing on top of it would
            # double-disrupt the gang for chips already being freed.
            return True, False
        sl = job.spec.slice
        mn = sl.min_slices
        if not sl.accelerator or mn is None or sl.num_slices <= mn:
            return False, False  # at (or below) the floor: displace
        unit = _chips_per_slice(group)
        if unit <= 0 or chips_needed <= 0:
            return False, False
        k = -(-chips_needed // unit)  # ceil: whole slices only
        new_n = max(mn, sl.num_slices - k)
        if new_n >= sl.num_slices:
            return False, False
        landed = self._resize(namespace, name, new_n, "shrink",
                              "reclaim", reason)
        return True, landed

    def _plan_grows(self, groups: List[SliceGroup], cap: Optional[int],
                    used: int, reserved: int, qpass) -> List[tuple]:
        """Grow candidates for THIS pass (called under the scheduler
        lock): fully-Running elastic gangs below maxSlices. Each grows
        by as many slices as currently fit — one restart straight to
        the biggest world the budget allows beats a ladder of restarts,
        each of which rolls progress back to the committed step —
        bounded by the remaining physical budget and, with tenant
        queues on, quota eligibility for the incremental chips (growth
        above nominal is borrowing and freezes like any other borrow
        while a cohort nominal demand is unmet). Walk order is the
        admission order, so higher-priority gangs claim idle capacity
        first."""
        free = None if cap is None else cap - used - reserved
        out: List[tuple] = []
        for g in groups:
            if g.status.phase != PHASE_RUNNING or g.status.resizing_reason:
                continue
            sl = g.spec.slice
            if not sl.accelerator or sl.max_slices is None:
                continue
            if sl.num_slices >= sl.max_slices:
                continue
            key = (g.metadata.namespace, g.metadata.name)
            if key in self._grow_inflight:
                continue  # a planned grow is still executing/syncing
            job = self.store.try_get(store_mod.TPUJOBS, *key)
            if job is None or job.spec.slice.num_slices != sl.num_slices:
                continue  # resize in flight; wait for the sync to settle
            unit = _chips_per_slice(g)
            if unit <= 0:
                continue
            step = sl.max_slices - sl.num_slices
            if free is not None:
                step = min(step, free // unit)
            while step > 0 and qpass is not None:
                # Largest quota-eligible increment (borrow limits may
                # cap below the physical headroom).
                q_ok, _, _, _ = qpass.evaluate(g, unit * step)
                if q_ok:
                    break
                step -= 1
            if step <= 0:
                continue
            if free is not None:
                free -= unit * step
            self._grow_inflight[key] = (sl.num_slices + step, None)
            out.append((key[0], key[1], sl.num_slices + step))
        return out

    def _elastic_inflight_extras(self, groups: List[SliceGroup]
                                 ) -> Dict[tuple, int]:
        """(ns, name) -> extra chips an in-flight grow of that gang
        already owns beyond its group spec, admitted or not (a gang
        displaced mid-grow is re-admitted at its job's size). Two
        sources, never added together:

        - the PERSISTED job-vs-group slice delta (job spec grew, group
          spec hasn't synced) — survives an operator crash-restart;
        - the in-memory plan ledger, from planning a grow until the
          group spec carries it, so a stale job read cannot hide it.

        Caller holds the scheduler lock. Entries whose group caught up,
        whose grow a newer job version undid, or whose gang vanished
        are pruned from the ledger here."""
        extras: Dict[tuple, int] = {}
        live = set()
        for g in groups:
            key = (g.metadata.namespace, g.metadata.name)
            live.add(key)
            sl = g.spec.slice
            ledger = self._grow_inflight.get(key)
            if (ledger is None and sl.max_slices is None
                    and sl.min_slices is None):
                continue  # not elastic: no job read, no charge
            job = self.store.try_get(store_mod.TPUJOBS, *key)
            if job is None:
                self._grow_inflight.pop(key, None)
                continue
            unit = _chips_per_slice(g)
            job_slices = job.spec.slice.num_slices
            delta = max(0, job_slices - sl.num_slices) * unit
            if ledger is not None:
                target, landed_rv = ledger
                rv = store_mod.rv_number(job.metadata.resource_version)
                if sl.num_slices >= target:
                    del self._grow_inflight[key]  # the group caught up
                    ledger = None
                elif job_slices >= target:
                    # The job write landed; the group has yet to follow.
                    if rv is not None and (landed_rv is None
                                           or rv > landed_rv):
                        self._grow_inflight[key] = (target, rv)
                elif (landed_rv is not None and rv is not None
                        and rv > landed_rv):
                    # A job version newer than the grow's, below its
                    # target: a later resize undid it.
                    del self._grow_inflight[key]
                    ledger = None
                if ledger is not None:
                    delta = max(delta, (target - sl.num_slices) * unit)
            if delta:
                extras[key] = delta
        for key in list(self._grow_inflight):
            if key not in live:
                del self._grow_inflight[key]
        return extras

    def _resize(self, namespace: str, name: str, new_slices: int,
                direction: str, reason_label: str, message: str) -> bool:
        """Apply ONE elastic resize: mutate the job's slice count (and
        the coupled worker replica count) so the engine re-renders the
        world — bootstrap digests change, live pods restart with
        identity and resume from the committed checkpoint
        (TPUJOB_RESTORE_STEP), out-of-range pods are deleted, missing
        ones created. A shrink first completes a save-before-evict
        barrier (controller/ckpt.py) so the smaller world restores from
        a checkpoint that includes every doomed replica's shard, and
        prunes the departed replicas' CheckpointRecords so they never
        pin committed_step at the shrink point. Gated on degraded mode
        like every other disruption. Returns True when the new world
        landed in the spec."""
        with trace_mod.span("gang.resize", job=f"{namespace}/{name}",
                            direction=direction, slices=new_slices):
            return self._resize_inner(namespace, name, new_slices,
                                      direction, reason_label, message)

    def _resize_inner(self, namespace: str, name: str, new_slices: int,
                      direction: str, reason_label: str,
                      message: str) -> bool:
        if (self.cp_health is not None
                and not self.cp_health.allow_disruption("resize")):
            trace_mod.JOURNAL.record(
                namespace, name, "disruption.deferred",
                "controlplane-degraded",
                f"elastic {direction} ({message}) deferred: the API "
                "server is degraded (docs/robustness.md)")
            return False
        key = (namespace, name)
        if direction == "shrink" and self.ckpt is not None:
            self._resize_barrier_t0.setdefault(key, time.monotonic())
            if not self.ckpt.ready_to_evict(
                    namespace, name, f"elastic shrink ({message})"):
                return False  # barrier in flight; retry next pass
        scaled: Dict[str, tuple] = {}

        def mutate(job):
            sl = job.spec.slice
            cur = sl.num_slices
            if new_slices == cur or not sl.accelerator:
                return False
            mn = sl.min_slices if sl.min_slices is not None else 1
            mx = sl.max_slices if sl.max_slices is not None else cur
            if direction == "shrink" and new_slices < mn:
                return False  # never below minSlices, even on re-read
            if direction == "grow" and new_slices > max(mx, cur):
                return False
            from tf_operator_tpu_torch.bootstrap.topology import (
                parse_accelerator,
            )

            try:
                topo = parse_accelerator(sl.accelerator, sl.topology,
                                         max(1, cur))
            except ValueError:
                return False
            worker = job.spec.replica_specs.get(ReplicaType.WORKER)
            if (worker is not None and (worker.replicas or 0)
                    == topo.hosts_per_slice * cur):
                # The worker count tracks the slice count (one process
                # per host). Templates with a custom worker shape keep
                # their count; only the slice request changes.
                scaled["workers"] = ((worker.replicas or 0),
                                     topo.hosts_per_slice * new_slices)
                worker.replicas = topo.hosts_per_slice * new_slices
            sl.num_slices = new_slices
            return None

        from tf_operator_tpu_torch.runtime import retry as retry_mod

        job = retry_mod.update_with_conflict_retry(
            self.store, store_mod.TPUJOBS, namespace, name, mutate,
            component="gang.resize")
        if job is None:
            # Job vanished / resize no longer valid on fresh state:
            # close the barrier episode we may have opened.
            self._resize_barrier_t0.pop(key, None)
            if direction == "shrink" and self.ckpt is not None:
                self.ckpt.release(namespace, name)
            return False
        if direction == "shrink" and self.ckpt is not None:
            self.ckpt.release(namespace, name)
            old_w, new_w = scaled.get("workers", (0, 0))
            if new_w < old_w:
                self.ckpt.prune_departed_records(
                    namespace, name, ReplicaType.WORKER, new_w, old_w)
        t0 = self._resize_barrier_t0.pop(key, None)
        if t0 is not None:
            metrics.resize_barrier_seconds.observe(
                max(0.0, time.monotonic() - t0), job_namespace=namespace)
        detail = f"{direction} to {new_slices} slice(s): {message}"
        signals = self._signal_values(namespace, name)
        if signals:
            detail += (" [signals: " + ", ".join(
                f"{k}={v:g}" for k, v in sorted(signals.items())) + "]")

        def mark(group):
            group.status.resizing_reason = detail

        retry_mod.update_with_conflict_retry(
            self.store, store_mod.SLICEGROUPS, namespace, name, mark,
            status=True, component="gang.resize")
        metrics.gang_resizes.inc(direction=direction, reason=reason_label)
        metrics.job_slices.set(new_slices, job_namespace=namespace,
                               job=name)
        log.info("resized gang %s/%s: %s", namespace, name, detail)
        trace_mod.JOURNAL.record(
            namespace, name, "resized", reason_label, detail,
            direction=direction, slices=new_slices)
        if self.recorder is not None:
            try:
                self.recorder.event(
                    job, EVENT_TYPE_NORMAL, REASON_GANG_RESIZED,
                    f"Gang {name} resized ({detail}); replicas rejoin "
                    "the new world and resume from the latest "
                    "checkpoint")
            except Exception:
                log.debug("GangResized event emit failed", exc_info=True)
        return True

    def _signal_values(self, namespace: str, name: str) -> Dict[str, float]:
        """Resize-decision signals (e.g. serving_queue_depth) from the
        optional provider — attached to the resize record/event so
        humans reading events see what the decision saw. The serving
        autoscaler (controller/autoscaler.py) is the provider when
        enabled: its autoscale resizes carry their own inputs."""
        if self.resize_signals is None:
            return {}
        try:
            return dict(self.resize_signals(namespace, name) or {})
        except Exception:
            log.debug("resize signal provider failed", exc_info=True)
            return {}

    def readmit(self) -> None:
        """Re-run admission off a capacity change (the binder calls this
        when node inventory shifts — a job sync would otherwise be the
        only trigger, stalling admission until the next resync)."""
        self._admit()

    def quota_status(self, job: TPUJob):
        """Engine hook (controller/quota.py QuotaWait | None): why the
        job's gang is held by tenant-queue quota — rolled into the
        job's Queued condition, or a terminal QuotaExceeded failure."""
        if self.quota is None:
            return None
        return self.quota.status_for(job)

    def delete_slice_group(self, job: TPUJob) -> None:
        if self.pdb_control is not None:
            self.pdb_control.delete(job)
        # try_delete's return is the atomicity seam: under concurrent
        # syncs only the worker whose delete landed counts/re-admits.
        if self.store.try_delete(store_mod.SLICEGROUPS,
                                 job.metadata.namespace, job.metadata.name):
            metrics.slicegroups_deleted.inc(
                job_namespace=job.metadata.namespace)
            self._admit()  # freed capacity may admit queued groups

    def annotate_pod(self, job: TPUJob, pod: Pod, rtype: str) -> None:
        """Reference: schedulerName + group-name + task-spec annotations
        (tensorflow/pod.go:221-235). The gang scheduler name is FORCED
        (kubeflow common logs the same "Another scheduler is specified,
        overwriting" warning): a template-supplied schedulerName would
        hand the pod to a scheduler that binds before admission, which
        the kube backend's occupancy probe reads as mid-eviction and
        answers with a delete/recreate churn loop."""
        if (pod.spec.scheduler_name
                and pod.spec.scheduler_name
                != constants.DEFAULT_GANG_SCHEDULER):
            log.warning(
                "pod %s template sets schedulerName=%r; gang scheduling "
                "overrides it with %r (gang pods must gate on admission)",
                pod.metadata.name, pod.spec.scheduler_name,
                constants.DEFAULT_GANG_SCHEDULER)
        pod.spec.scheduler_name = constants.DEFAULT_GANG_SCHEDULER
        pod.metadata.annotations[constants.ANNOTATION_GANG_GROUP] = \
            job.metadata.name
        pod.metadata.annotations[constants.ANNOTATION_GANG_TASK] = rtype

    # -- admission ------------------------------------------------------

    def _priority_of(self, group: SliceGroup) -> int:
        name = group.spec.priority_class
        if not name:
            return 0
        if name in self.priority_classes:
            return self.priority_classes[name]
        try:
            return int(name)
        except ValueError:
            if name not in self._warned_priority:
                self._warned_priority.add(name)
                log.warning("unknown priorityClass %r (no entry in "
                            "priority_classes, not numeric); treating as 0",
                            name)
            return 0

    def _pending_since(self, group: SliceGroup) -> Optional[_dt.datetime]:
        return group.status.pending_since or group.metadata.creation_timestamp

    def _admit(self) -> None:
        # Admission is a traced pass: nested under the sync span when a
        # job sync drove it, a root trace of its own when capacity
        # events (readmit pokes) did.
        with trace_mod.span("gang.admit_pass"):
            self._admit_pass()

    def _admit_pass(self) -> None:
        """Walk groups by (priority desc, creation asc); admit while the
        whole slice request fits the remaining chip budget (global and
        per-queue quota), applying fairness per queue lane when a group
        doesn't fit and — if enabled — preempting lower-priority
        not-yet-running groups.

        Aging is anchored on the group's persisted pending-since
        timestamp (falling back to creationTimestamp), so the
        no-starvation guarantee survives operator restarts and leader
        failovers, and a preempted/re-queued group gets a fresh grace
        window. Mid-eviction state is likewise derived from persisted
        observations — a Pending group with Running pods IS mid-eviction
        (pods only run while admitted) — so a restart or failover
        between preempting a victim and deleting its pods can never
        drop an eviction or double-book the victim's chips."""
        now = _now()
        to_evict: List[tuple] = []
        grows: List[tuple] = []
        # True when some feasible pending group failed to admit this
        # pass — idle capacity is then NOT idle (it is what the blocked
        # group is waiting for) and the elastic grow pass stands down.
        any_blocked = False
        with self._lock:
            # Effective chip budget for THIS pass: the static flag wins;
            # otherwise a bound capacity provider reports live cluster
            # capacity; otherwise unlimited. Valid only under the lock.
            cap = self.total_chips
            if cap is None and self.capacity_provider is not None:
                cap = self.capacity_provider()
            self._cap = cap
            dom_cap = (self.domain_capacity_provider()
                       if self.domain_capacity_provider is not None
                       else None)
            groups = sorted(
                self.store.list(store_mod.SLICEGROUPS),
                key=lambda g: (-self._priority_of(g),
                               g.metadata.creation_timestamp or 0,
                               g.metadata.name))
            live_keys = {(g.metadata.namespace, g.metadata.name)
                         for g in groups}
            # Tenant-queue quota ledger for THIS pass (None = quota
            # off). It answers eligibility per pending group; failures
            # degrade to quota-off admission rather than stalling the
            # fleet.
            qpass = None
            if self.quota is not None:
                try:
                    with trace_mod.span("quota.plan"):
                        qpass = self.quota.plan(groups, _chips_for, now)
                except Exception:
                    log.exception("tenant-queue quota plan failed; "
                                  "running this pass without quota")
            used = 0
            queue_used: Dict[str, int] = {}
            # Groups not admissible this pass because their pods still
            # occupy chips: Pending phase + Running pods = a preempted
            # victim whose eviction hasn't completed (or a gate race
            # about to be corrected). Their chips stay counted and
            # their pods get (re-)deleted below — level-triggered, so
            # failed deletes retry on every pass with no extra state.
            evicting = set()
            # One pod-store scan per pass; mid-eviction state can only
            # exist when something flips a group with released pods
            # back to Pending: priority preemption, or a tenant-queue
            # quota reclaim (displace leaves the victim's pods to this
            # level-triggered eviction path, exactly like preemption —
            # chips stay counted until the deletes land, so a nominal
            # demander is never admitted into the borrower's dying
            # window). Slice-health drains evict their pods themselves
            # before displacing (controller/health.py _drain).
            occ_index = (self._occupancy_index()
                         if self.preemption or self.quota is not None
                         else {})
            # Chips already committed to in-flight elastic grows whose
            # group spec lags the job spec (or whose job write is still
            # in flight): charged per group in the walk below so
            # neither a pending admission nor another grow spends them
            # twice.
            grow_extras = (self._elastic_inflight_extras(groups)
                           if self.elastic else {})
            for g in groups:
                gk = (g.metadata.namespace, g.metadata.name)
                occupied = g.status.phase in (PHASE_INQUEUE, PHASE_RUNNING)
                if g.status.phase == PHASE_PENDING and occ_index.get(gk):
                    evicting.add(gk)
                    to_evict.append(gk)
                    occupied = True
                if occupied:
                    # A mid-eviction group holds its pods at the group's
                    # size; only an admitted one owns its in-flight grow.
                    c = _chips_for(g) + (grow_extras.get(gk, 0)
                                         if g.status.phase != PHASE_PENDING
                                         else 0)
                    used += c
                    q = g.spec.queue or ""
                    queue_used[q] = queue_used.get(q, 0) + c
            # Chips held by dying processes of groups that no longer
            # EXIST (job deleted mid-run: delete_slice_group removed
            # the SliceGroup and re-ran admission while the processes
            # sit in their termination grace). They stay booked against
            # the global budget until the data plane reports them gone
            # — drain completion pokes readmit — so a queued successor
            # never overlaps them. Queue quotas can't be charged (the
            # queue died with the group); global accounting suffices
            # because quotas only subdivide the global budget.
            for dk, d in self._draining().items():
                if dk not in live_keys:
                    used += d.get("chips", 0)
            # Per-queue lane blocking: queue -> minimum priority still
            # allowed to backfill (None = hard block, nothing admits).
            blocked: Dict[str, Optional[int]] = {}
            # queue -> True while EVERY blocker of that lane was held by
            # quota alone (chips were free). Such a lane lets quota-
            # clean under-nominal groups through: the head is waiting
            # on quota that may itself be waiting on another queue's
            # nominal demand admitting THROUGH this lane — holding them
            # back deadlocks the cohort (pinned by
            # hack/verify-quota-invariants.py).
            lane_quota_only: Dict[str, bool] = {}
            # Chips held back for aged-out groups. Their lane block alone
            # can't protect them: the chip budget is global, so backfill
            # from *other* queues would otherwise keep consuming freed
            # capacity and starve them indefinitely. Reserving makes the
            # docstring's "freed capacity accumulates for it" true
            # cluster-wide, not just within the blocked lane.
            reserved = 0
            for group in groups:
                if group.status.phase in (PHASE_INQUEUE, PHASE_RUNNING):
                    continue
                key = (group.metadata.namespace, group.metadata.name)
                if key in evicting:
                    continue  # mid-eviction: not admissible until done
                q = group.spec.queue or ""
                # A gang displaced mid-grow comes back at the size its
                # job now asks for, not its group's stale one.
                need = _chips_for(group) + grow_extras.get(key, 0)
                pri = self._priority_of(group)
                quota = self.queue_quotas.get(q)
                # Infeasible at ANY occupancy (cluster-, quota-, or
                # domain-wise): can never be satisfied, so it must not
                # block the lane or book budget (the capacity-vs-request
                # mismatch is the operator's to fix, not later jobs' to
                # wait out). The domain check is structural: a single
                # slice larger than every NVLink domain can never be placed
                # WHOLE even though the aggregate budget fits it —
                # admitting it would reserve chips the binder can never
                # use and starve everything behind it. Flag once, not on
                # every admission pass; all three re-evaluate per pass,
                # so capacity growth un-skips automatically.
                why = None
                if self._cap is not None and need > self._cap:
                    why = f"cluster capacity is {self._cap}"
                elif quota is not None and need > quota:
                    why = f"queue {q!r} quota is {quota}"
                elif dom_cap is not None:
                    slice_need = _chips_per_slice(group)
                    if slice_need > dom_cap:
                        why = (f"largest NVLink domain holds {dom_cap} "
                               f"chips and one slice needs {slice_need}")
                if why is not None:
                    if key not in self._warned_infeasible:
                        self._warned_infeasible.add(key)
                        log.warning(
                            "slice group %s needs %d chips but the %s; "
                            "skipping (infeasible)",
                            group.metadata.name, need, why)
                    trace_mod.JOURNAL.record(
                        key[0], key[1], "admission.deny", "infeasible",
                        f"needs {need} chips but the {why}; can never "
                        "be admitted at any occupancy")
                    continue
                if q in blocked:
                    floor = blocked[q]
                    passes_quota_lane = False
                    if lane_quota_only.get(q) and qpass is not None:
                        # Quota-held lane: an under-nominal (borrow-free)
                        # group may pass the waiting head — its claim is
                        # on its own queue's share.
                        bp_ok, bp_borrow, _, _ = qpass.evaluate(group,
                                                                need)
                        passes_quota_lane = bp_ok and bp_borrow == 0
                    if not passes_quota_lane and (floor is None
                                                  or pri < floor):
                        any_blocked = True
                        trace_mod.JOURNAL.record(
                            key[0], key[1], "admission.defer",
                            "queue-blocked",
                            f"queue {q!r} is held for an earlier group "
                            "(head-of-line fairness); waiting behind it")
                        continue  # lane held for an earlier group
                fits_phys = ((self._cap is None
                              or used + reserved + need <= self._cap)
                             and (quota is None
                                  or queue_used.get(q, 0) + need <= quota))
                # Quota eligibility (tenant queues): evaluated even when
                # physically blocked so reclaim demands register.
                q_ok, q_borrow, q_why, q_terminal = True, 0, None, False
                if qpass is not None:
                    q_ok, q_borrow, q_why, q_terminal = qpass.evaluate(
                        group, need)
                fits = fits_phys and q_ok
                if (not fits and self.preemption and q_ok
                        and not fits_phys
                        and (self.cp_health is None
                             or self.cp_health.allow_disruption(
                                 "preemption"))):
                    # Priority preemption frees PHYSICAL capacity only —
                    # never fired to solve a quota block (that's the
                    # quota manager's reclaim path). Deferred wholesale
                    # while the control plane is degraded: choosing
                    # victims it cannot reliably evict would strand
                    # them Pending with chips double-booked.
                    fits, used, queue_used, ev_pending = self._try_preempt(
                        groups, group, need, pri, q, quota,
                        used, queue_used, reserved, now,
                        evicting, to_evict, occ_index)
                    if fits:
                        fits_phys = True
                    if not fits and ev_pending:
                        any_blocked = True
                        # Chips are inbound for THIS group (victims died
                        # or are dying for it). Earmark them — lane block
                        # plus a global reservation — so no lower-priority
                        # group later in this pass (or cross-queue
                        # backfill) admits onto capacity the eviction just
                        # paid for; the preemptor lands next pass when the
                        # deletes are confirmed.
                        reserved += need
                        blocked[q] = None
                        lane_quota_only[q] = False
                        continue
                if not fits:
                    if not fits_phys and (qpass is None or q_ok):
                        # Physical-capacity block (quota blocks record
                        # their own defer inside on_blocked below).
                        if self._cap is not None:
                            block_msg = (f"needs {need} chips; "
                                         f"{used + reserved}/{self._cap} "
                                         "in use or reserved")
                        else:
                            block_msg = (f"needs {need} chips over "
                                         f"queue {q!r} quota {quota}")
                        trace_mod.JOURNAL.record(
                            key[0], key[1], "admission.defer",
                            "capacity", block_msg)
                    if qpass is not None:
                        qpass.on_blocked(group, need, q_ok, q_why,
                                         q_terminal, fits_phys, pri)
                        if q_terminal:
                            # Never admissible through its queue (e.g.
                            # zero-quota): like the infeasible skip, it
                            # must not hold the lane or book budget —
                            # the engine fails the job off the recorded
                            # wait state.
                            continue
                    any_blocked = True
                    if self.fairness == "backfill":
                        continue  # pure skip: later groups may still fit
                    quota_only = fits_phys and not q_ok
                    lane_quota_only[q] = (lane_quota_only.get(q, True)
                                          and quota_only)
                    since = self._pending_since(group)
                    waited = ((now - since).total_seconds()
                              if since is not None else 0.0)
                    if (self.fairness == "strict"
                            or waited >= self.aging_seconds):
                        if self.fairness == "aged" and not fits_phys:
                            log.info("slice group %s aged out backfill; "
                                     "reserving %d chips for it",
                                     group.metadata.name, need)
                            # Hold its chips out of the global budget so
                            # cross-queue backfill can't eat freed
                            # capacity (strict mode stays per-queue by
                            # design: lane isolation is its contract).
                            # Quota-only blocks reserve nothing: chips
                            # aren't the scarce thing, quota is.
                            reserved += need
                        blocked[q] = None  # hard block: lane waits
                    else:
                        # aged, still in grace: only equal-priority
                        # groups may backfill this lane (sorted desc, so
                        # floor=pri excludes exactly the lower-priority
                        # ones — no priority inversion while it waits).
                        if q not in blocked:
                            blocked[q] = pri
                    continue
                used += need
                queue_used[q] = queue_used.get(q, 0) + need
                group.status.phase = PHASE_INQUEUE
                self.store.update_status(store_mod.SLICEGROUPS, group)
                if qpass is not None:
                    qpass.on_admit(group, need, q_borrow)
                log.info("admitted slice group %s (%d chips, queue=%r, "
                         "priority=%d)", group.metadata.name, need, q, pri)
                trace_mod.JOURNAL.record(
                    key[0], key[1], "admission.admit", "admitted",
                    f"gang admitted: {need} chips (queue={q!r}, "
                    f"priority={pri}, borrowed={q_borrow})")
            self._warned_infeasible &= live_keys
            # Quota reclaim plan + per-queue status/metrics publication.
            reclaims: List[tuple] = []
            if qpass is not None:
                try:
                    reclaims = qpass.reclaims()
                    qpass.finish()
                except Exception:
                    log.exception("tenant-queue quota pass finish failed")
            if (reclaims and self.cp_health is not None
                    and not self.cp_health.allow_disruption("reclaim")):
                # Degraded: the demands stay registered (level-triggered
                # — the next pass re-derives them) but no borrower is
                # displaced until evictions can actually be enforced.
                reclaims = []
            # Elastic grow pass: only when nothing feasible is waiting
            # for capacity or quota (idle means idle) and no reclaim is
            # about to free chips the grow would immediately re-take.
            if self.elastic and not any_blocked and not reclaims:
                grows = self._plan_grows(groups, self._cap, used,
                                         reserved, qpass)
        # Pod deletes are API I/O on the kube backend — never under the
        # lock. Completed evictions free their chips on the next pass
        # (triggered by the pods' DELETED events re-enqueuing jobs);
        # failed deletes are retried because the next pass re-derives
        # the same group from its still-occupying pods. On the local
        # backend the store delete precedes process exit by up to the
        # termination grace (~3s); draining_provider keeps those chips
        # counted until the processes actually exit, so a preemptor is
        # never admitted into the dying window (pinned by
        # test_preemptor_spawns_only_after_victim_exits).
        for ns, name in to_evict:
            self._evict_pods(ns, name)
        # Quota reclaim displacements: borrowed gangs go back through
        # admission (the slice-health re-admission path — original
        # priority, fresh aging window, level-triggered pod eviction)
        # so a cohort member can take its nominal share back. Elastic
        # gangs above their minSlices are SHRUNK by just the demanded
        # chips instead — capacity loss as degradation, not failure
        # (docs/elastic.md); at the floor they displace like everyone
        # else. Outside the lock: displace/_resize re-enter _admit.
        for ns, name, qname, reason, chips_needed in reclaims:
            if self.elastic:
                handled, landed = self._try_shrink_for_reclaim(
                    ns, name, chips_needed, reason)
                if handled:
                    if landed and self.quota is not None:
                        try:
                            self.quota.note_reclaimed(qname, ns, name,
                                                      reason)
                        except Exception:
                            log.debug("quota reclaim note failed",
                                      exc_info=True)
                    continue
            if self.displace(ns, name, reason) and self.quota is not None:
                try:
                    self.quota.note_reclaimed(qname, ns, name, reason)
                except Exception:
                    log.debug("quota reclaim note failed", exc_info=True)
        # Elastic grows into idle capacity (the restart a grow triggers
        # demotes the gang out of Running until it is back up, so
        # growth is self-pacing). A grow that fails to land releases
        # its budget charge immediately; a landed one stays charged
        # until the group spec catches up (_elastic_inflight_extras).
        for ns, name, new_n in grows:
            if not self._resize(ns, name, new_n, "grow", "idle",
                                "idle capacity available"):
                with self._lock:
                    self._grow_inflight.pop((ns, name), None)

    def _try_preempt(self, groups: List[SliceGroup], group: SliceGroup,
                     need: int, pri: int, q: str, quota: Optional[int],
                     used: int, queue_used: Dict[str, int],
                     reserved: int, now,
                     evicting: set, to_evict: List[tuple],
                     occ_index: Dict[tuple, List[Pod]]):
        """Evict Inqueue (never Running) groups with strictly lower
        priority — lowest priority first, youngest first — until
        ``group`` fits both the global budget (minus chips reserved for
        aged-out groups) and its queue quota. All-or-nothing: if even
        evicting every eligible victim wouldn't fit, nothing is evicted.

        Eviction = flip the SliceGroup to Pending AND delete its pods.
        A victim with no released pods frees its chips immediately (the
        preemptor can admit in this very pass); a victim whose pods
        passed the admission gate keeps its chips *counted* — and stays
        in ``evicting`` — until a later _admit pass observes every pod
        deleted (triggered by the pods' DELETED events re-enqueuing
        jobs) and the preemptor admits then.

        Chips already in flight from earlier evictions (the mid-eviction
        groups in ``evicting``) are credited before choosing new
        victims: if inbound capacity alone will fit the preemptor, no
        additional gang is killed for it (no over-preemption while
        deletes land).

        Returns (fits, used, queue_used, pending) where ``pending``
        means capacity is inbound for this group — victims were just
        evicted or are mid-eviction — and the caller must earmark it.
        """
        def fits(u_, qu_):
            return ((self._cap is None
                     or u_ + reserved + need <= self._cap)
                    and (quota is None or qu_.get(q, 0) + need <= quota))

        # Credit for evictions already in flight: their chips are in
        # `used`/`queue_used` now but are guaranteed to free (their
        # groups are Pending; their pods are being deleted on every
        # pass). Credited globally AND per queue — a quota-bound
        # preemptor must not kill a fresh same-queue victim when an
        # earlier same-queue eviction is already freeing enough.
        in_flight = 0
        in_flight_q: Dict[str, int] = {}
        for g in groups:
            if (g.metadata.namespace, g.metadata.name) in evicting:
                c = _chips_for(g)
                in_flight += c
                gq = g.spec.queue or ""
                in_flight_q[gq] = in_flight_q.get(gq, 0) + c
        qu_credit = {k: queue_used.get(k, 0) - in_flight_q.get(k, 0)
                     for k in set(queue_used) | set(in_flight_q)}
        if in_flight and fits(used - in_flight, qu_credit):
            return False, used, queue_used, True  # wait, don't kill more

        victims = [g for g in groups
                   if g.status.phase == PHASE_INQUEUE
                   and self._priority_of(g) < pri]
        victims.sort(key=lambda g: (self._priority_of(g),
                                    -(_ts(g.metadata.creation_timestamp)),
                                    g.metadata.name))
        u, qu, chosen = used - in_flight, qu_credit, []
        for v in victims:
            if fits(u, qu):
                break
            vq = v.spec.queue or ""
            # A victim only helps if it relieves a violated constraint:
            # any victim relieves the global budget; only same-queue
            # victims relieve this queue's quota.
            global_tight = (self._cap is not None
                            and u + reserved + need > self._cap)
            if not global_tight and vq != q:
                continue
            c = _chips_for(v)
            u -= c
            qu[vq] = qu.get(vq, 0) - c
            chosen.append(v)
        if not fits(u, qu):
            return False, used, queue_used, False
        # Feasible: flip every chosen victim Pending (pods the engine
        # recreates re-gate on the unadmitted group), then free chips
        # only for victims with no released pods; the rest stay counted
        # — and excluded from this pass's admission walk — until their
        # deletes land (the preemptor admits on a later pass).
        u, qu = used, dict(queue_used)
        for v in chosen:
            v.status.phase = PHASE_PENDING
            v.status.pending_since = now  # fresh aging grace window
            self.store.update_status(store_mod.SLICEGROUPS, v)
            metrics.slicegroups_preempted.inc(
                job_namespace=v.metadata.namespace)
            log.info("preempted slice group %s (priority %d) for %s "
                     "(priority %d)", v.metadata.name,
                     self._priority_of(v), group.metadata.name, pri)
            trace_mod.JOURNAL.record(
                v.metadata.namespace, v.metadata.name, "preempted",
                "priority-preemption",
                f"evicted back to Pending (priority "
                f"{self._priority_of(v)}) so {group.metadata.name} "
                f"(priority {pri}) fits")
            vk = (v.metadata.namespace, v.metadata.name)
            # Either way the victim is out of this pass's admission walk
            # (it sorts after the higher-priority preemptor and must not
            # re-admit onto the chips it just gave up).
            evicting.add(vk)
            # Fresh store read, NOT the pass-start occ_index snapshot: a
            # pod can pass the gate (gang_released persisted) between
            # the snapshot and this flip, and freeing its chips off the
            # stale snapshot would admit the preemptor into the spawn
            # window.
            if (self._pods_occupying(*vk)
                    or self._draining().get(vk, {}).get("pods", 0)):
                to_evict.append(vk)
            else:
                c = _chips_for(v)
                u -= c
                vq = v.spec.queue or ""
                qu[vq] = qu.get(vq, 0) - c
        return fits(u, qu), u, qu, True

    def _pod_occupies(self, p: Pod) -> bool:
        """Whether a pod actually holds chips: phase Running; released
        past the admission gate and mid-spawn (gang_released — the
        local/agent data plane stamps it before spawning, closing the
        race where a preemptor admits into the spawn window); or, on
        the kube backend, bound to a node while containers create
        (scheduled_pods_occupy). Gate-held Pending pods occupy nothing
        and are the engine's to manage; terminal pods hold no chips and
        carry completion records (deleting a Succeeded pod would re-run
        finished work on re-admission), so eviction never touches
        either."""
        if p.status.phase == "Running":
            return True
        if p.status.phase != "Pending":
            return False
        return bool(p.status.gang_released
                    or (self.scheduled_pods_occupy and p.spec.node_name))

    def _pods_occupying(self, ns: str, group_name: str) -> List[Pod]:
        return [p for p in self.store.list(
                    store_mod.PODS, namespace=ns,
                    selector={constants.LABEL_JOB_NAME: group_name})
                if self._pod_occupies(p)]

    def _occupancy_index(self) -> Dict[tuple, int]:
        """(namespace, group) -> occupying-pod count, from ONE
        deepcopy-free pod-store projection — the per-pass probe must
        not do a full list per Pending group under the scheduler
        lock. Dying-but-not-exited local processes (draining_provider)
        occupy too: the store delete alone must not hand their chips
        to a preemptor."""
        index: Dict[tuple, int] = {}

        def key_of(p):
            if not self._pod_occupies(p):
                return None
            group = p.metadata.labels.get(constants.LABEL_JOB_NAME, "")
            return (p.metadata.namespace, group) if group else None

        for k in self.store.project(store_mod.PODS, key_of):
            index[k] = index.get(k, 0) + 1
        for k, d in self._draining().items():
            index[k] = index.get(k, 0) + d.get("pods", 0)
        return index

    def _draining(self) -> Dict[tuple, Dict[str, int]]:
        """(ns, group) -> {"pods": live processes, "chips": chips they
        hold}, from the data plane (empty without a provider)."""
        if self.draining_provider is None:
            return {}
        try:
            return dict(self.draining_provider())
        except Exception:
            log.debug("draining_provider failed", exc_info=True)
            return {}

    def _evict_pods(self, ns: str, name: str) -> None:
        """Delete a preempted group's Running pods (Volcano evicts pods;
        accounting-only eviction would let a victim whose pods already
        passed the admission gate keep running on chips handed to the
        preemptor). Failures only log: the next admission pass
        re-derives the victim from its still-Running pods and retries —
        and keeps its chips counted meanwhile, so a failed delete can
        never double-book. Runs without the scheduler lock (deletes are
        API I/O on the kube backend)."""
        job = self.store.try_get(store_mod.TPUJOBS, ns, name)
        if job is None and self.pod_control is not None:
            # Job already deleted mid-eviction: synthesize a reference
            # for event attribution so eviction still goes through pod
            # control (a store-level delete would only touch the kube
            # backend's informer mirror, not the cluster).
            job = TPUJob(metadata=ObjectMeta(name=name, namespace=ns))
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        for pod in self._pods_occupying(ns, name):
            try:
                # Both controls swallow NotFound themselves (deletion is
                # level-triggered); transient blips retry in place
                # (runtime/retry.py); anything that survives the
                # backoff logs and retries next pass.
                if self.pod_control is not None:
                    retry_mod.with_retries(
                        lambda pod=pod: self.pod_control.delete_pod(
                            ns, pod.metadata.name, job),
                        component="gang.evict", health=self.cp_health)
                else:
                    retry_mod.with_retries(
                        lambda pod=pod: self.store.try_delete(
                            store_mod.PODS, ns, pod.metadata.name),
                        component="gang.evict", health=self.cp_health)
            except Exception as e:
                log.warning("evicting pod %s/%s of preempted group %s "
                            "failed (will retry): %s",
                            ns, pod.metadata.name, name, e)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _ts(t) -> float:
    return t.timestamp() if t is not None else 0.0
