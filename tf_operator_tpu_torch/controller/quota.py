"""Multi-tenant quota & fair-share queueing above gang admission (port
of tf_operator_tpu/controller/quota.py, copied; quotas count GPUs).

Kueue/Volcano-style workload queueing collapsed to the chip-count
resource model the gang scheduler already admits in (the SliceGroup API
cites Volcano PodGroup; api/types.py:424). Two API objects drive it:

- ``TenantQueue`` (namespaced): the handle jobs reference via
  ``spec.queueName``; it points at one ClusterQueue.
- ``ClusterQueue`` (cluster-scoped): ``nominalChips`` the queue owns,
  ``borrowingLimit`` above nominal it may borrow, ``reclaimPolicy`` for
  taking nominal back, and a ``cohort`` whose members lend each other
  idle nominal capacity.

Division of labor: the TenantQueueManager decides *which* pending
groups are quota-eligible each admission pass; ``SliceGangScheduler``
keeps deciding *whether* the gang physically fits (and runs fairness /
priority preemption); ``SliceGangBinder`` keeps placing it. The manager
plugs into the scheduler as its ``quota`` hook and is consulted inside
``_admit`` — one plan per pass, under the scheduler lock.

Invariants (pinned by tests/test_quota.py and the randomized property
check hack/verify-quota-invariants.py):

- no admission above cohort capacity: the chips admitted through a
  cohort's queues never exceed the cohort's aggregate nominal;
- borrow-then-reclaim convergence: while any cohort member has unmet
  nominal demand, no member may borrow, and reclaim displaces borrowed
  gangs (via ``gang.displace`` — the slice-health re-admission path)
  until the demander's nominal share is free;
- starvation-freedom: within a tenant queue, FIFO-within-priority
  ordering is preserved by the scheduler's lane blocking, and the
  borrow-freeze above guarantees a nominal demand is eventually met.
"""

from __future__ import annotations

import datetime as _dt
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from tf_operator_tpu_torch.api.defaults import set_cluster_queue_defaults
from tf_operator_tpu_torch.api.types import (
    ClusterQueue,
    ReclaimPolicy,
    SliceGroup,
    TenantQueue,
    TPUJob,
)
from tf_operator_tpu_torch.api.validation import (
    validate_cluster_queue,
    validate_tenant_queue,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    REASON_BORROWED_CAPACITY,
    REASON_QUEUE_DELETED,
    REASON_QUEUED_WAITING_FOR_QUOTA,
    REASON_QUOTA_RECLAIMED,
)
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.quota")

PHASE_PENDING = "Pending"
PHASE_INQUEUE = "Inqueue"
PHASE_RUNNING = "Running"


@dataclass
class QuotaWait:
    """Why a job's gang is not quota-admitted (engine rolls it into the
    job's Queued condition; ``terminal`` means it never will be and the
    job must fail with reason QuotaExceeded)."""

    queue: str
    message: str
    terminal: bool = False
    since: Optional[_dt.datetime] = None


class _QuotaPass:
    """One admission pass's quota ledger. Built by
    ``TenantQueueManager.plan`` from a frozen snapshot of queues +
    groups; the gang scheduler consults it per pending group and
    reports admissions/blocks back, then ``finish`` computes reclaim
    displacements and publishes per-queue status/metrics."""

    def __init__(self, mgr: "TenantQueueManager",
                 groups: List[SliceGroup],
                 chips_of: Callable[[SliceGroup], int],
                 now: _dt.datetime):
        self.mgr = mgr
        self.now = now
        self.chips_of = chips_of
        # ClusterQueue names referenced by a TenantQueue but absent
        # (dangling): their groups wait on a zero-capacity placeholder.
        self._missing_cq: set = set()
        # name -> defaulted ClusterQueue
        self.cluster_queues: Dict[str, ClusterQueue] = {}
        # (namespace, name) -> TenantQueue
        self.tenant_queues: Dict[Tuple[str, str], TenantQueue] = {}
        for cq in mgr.store.list(store_mod.CLUSTERQUEUES):
            self.cluster_queues[cq.metadata.name] = \
                set_cluster_queue_defaults(cq)
        for tq in mgr.store.list(store_mod.TENANTQUEUES):
            self.tenant_queues[(tq.metadata.namespace,
                                tq.metadata.name)] = tq
        self.cohort_nominal: Dict[str, int] = {}
        for cq in self.cluster_queues.values():
            self.cohort_nominal[cq.spec.cohort] = \
                self.cohort_nominal.get(cq.spec.cohort, 0) \
                + cq.spec.nominal_chips
        # Admitted usage at pass start, from occupied groups.
        self.usage: Dict[str, int] = {}
        self.cohort_usage: Dict[str, int] = {}
        self.pending: Dict[str, int] = {}        # tenant-queue pending count
        self.tq_admitted: Dict[str, int] = {}    # tenant-queue admitted chips
        self._occupied: List[Tuple[SliceGroup, Optional[ClusterQueue]]] = []
        pending_groups = []
        for g in groups:
            cq = self._resolve(g)
            if g.status.phase in (PHASE_INQUEUE, PHASE_RUNNING):
                c = chips_of(g)
                if cq is not None:
                    self.usage[cq.metadata.name] = \
                        self.usage.get(cq.metadata.name, 0) + c
                    self.cohort_usage[cq.spec.cohort] = \
                        self.cohort_usage.get(cq.spec.cohort, 0) + c
                    self._occupied.append((g, cq))
                if g.spec.queue:
                    self.tq_admitted[g.spec.queue] = \
                        self.tq_admitted.get(g.spec.queue, 0) + c
            elif g.status.phase == PHASE_PENDING:
                pending_groups.append((g, cq))
                if g.spec.queue:
                    self.pending[g.spec.queue] = \
                        self.pending.get(g.spec.queue, 0) + 1
        # Pending groups by key, for the borrow freeze: while a cohort
        # member has unmet NOMINAL demand (a pending group that fits
        # under its queue's nominal), no cohort member may borrow —
        # that freeze is what makes borrow-then-reclaim converge
        # instead of churning (an evicted borrower would otherwise
        # re-admit onto the chips the reclaim just freed). The set is
        # live within the pass: on_admit removes entries, so a demand
        # met earlier in the walk stops freezing later borrowers.
        self._pending_nominal: Dict[Tuple[str, str],
                                    Tuple[SliceGroup,
                                          Optional[ClusterQueue]]] = {
            (g.metadata.namespace, g.metadata.name): (g, cq)
            for g, cq in pending_groups}
        # (priority, group, cq, unmet chips) nominal demands that were
        # physically blocked this pass — reclaim candidates for finish().
        self._reclaim_demands: List[Tuple[int, SliceGroup,
                                          ClusterQueue, int]] = []
        self._live_keys = {(g.metadata.namespace, g.metadata.name)
                           for g in groups}

    # -- resolution -----------------------------------------------------

    def _resolve(self, group: SliceGroup) -> Optional[ClusterQueue]:
        """The ClusterQueue a group admits through; None = default
        queue (quota-exempt — preserves pre-quota behavior). A queue
        name that resolves to no live TenantQueue falls back to the
        default queue with a one-shot QueueDeleted event (the
        "TenantQueue deleted with pending groups" arc)."""
        qname = group.spec.queue
        if not qname:
            return None
        key = (group.metadata.namespace, qname)
        tq = self.tenant_queues.get(key)
        if tq is None:
            self.mgr._note_orphaned(group, qname)
            return None
        cq = self.cluster_queues.get(tq.spec.cluster_queue)
        if cq is None:
            # Dangling ClusterQueue reference: handled in evaluate (the
            # group must WAIT, not silently bypass quota).
            return None if tq.spec.cluster_queue == "" else \
                self._dangling(tq)
        return cq

    def _dangling(self, tq: TenantQueue) -> ClusterQueue:
        """Placeholder for a TenantQueue whose ClusterQueue doesn't
        exist: zero capacity, non-terminal (the operator may still
        create it) — the group waits instead of admitting unmetered."""
        cq = ClusterQueue()
        cq.metadata.name = tq.spec.cluster_queue
        cq.spec.nominal_chips = 0
        cq.spec.borrowing_limit = 0
        cq.spec.cohort = f"missing-{tq.spec.cluster_queue}"
        cq.spec.reclaim_policy = ReclaimPolicy.NEVER
        self._missing_cq.add(tq.spec.cluster_queue)
        return cq

    # -- the gang scheduler's per-group hooks ---------------------------

    def evaluate(self, group: SliceGroup,
                 need: int) -> Tuple[bool, int, Optional[str], bool]:
        """(quota_fits, borrowed_chips, why, terminal) for admitting
        ``group`` at ``need`` chips right now. ``borrowed_chips`` > 0
        means the admission would dip into cohort capacity above the
        queue's nominal."""
        cq = self._resolve(group)
        if cq is None:
            return True, 0, None, False
        name = cq.metadata.name
        if name in self._missing_cq:
            # Dangling reference: wait (non-terminal — the operator may
            # still create the ClusterQueue), never admit unmetered.
            return False, 0, (
                f"TenantQueue {group.spec.queue!r} references "
                f"ClusterQueue {name!r} which does not exist"), False
        used = self.usage.get(name, 0)
        nominal = cq.spec.nominal_chips
        bl = cq.spec.borrowing_limit
        cohort = cq.spec.cohort
        cohort_cap = self.cohort_nominal.get(cohort, 0)
        cohort_used = self.cohort_usage.get(cohort, 0)
        if used + need <= nominal:
            if cohort_used + need <= cohort_cap:
                return True, 0, None, False
            # Under nominal but the cohort is full: borrowers are
            # sitting on this queue's share. Admitting anyway would
            # break the cohort-capacity invariant — the group waits
            # while on_blocked registers the reclaim demand.
            return False, 0, (
                f"queue {name!r} is under its nominal quota but cohort "
                f"{cohort!r} is at {cohort_used}/{cohort_cap} chips; "
                "waiting for borrowed capacity to be reclaimed"), False
        # Borrowing path: above nominal, into idle cohort capacity.
        borrow = used + need - nominal
        # Can this group EVER admit through this queue? Its ceiling is
        # nominal + borrowing limit, itself capped by cohort capacity.
        ceiling = min(nominal + bl if bl is not None else cohort_cap,
                      cohort_cap)
        if need > ceiling:
            return False, 0, (
                f"group needs {need} chips but queue {name!r} can hold "
                f"at most {ceiling} (nominalChips={nominal}, "
                f"borrowingLimit={bl}, cohort {cohort!r} capacity "
                f"{cohort_cap})"), True
        if bl is not None and borrow > bl:
            return False, 0, (
                f"queue {name!r} is at {used}/{nominal} nominal chips "
                f"and borrowing {borrow} more would exceed "
                f"borrowingLimit={bl}"), False
        if cohort_used + need > cohort_cap:
            return False, 0, (
                f"cohort {cohort!r} is at {cohort_used}/{cohort_cap} "
                f"chips; no idle capacity for queue {name!r} to "
                f"borrow"), False
        if self._cohort_has_unmet_nominal_demand(group, cohort, name):
            return False, 0, (
                f"cohort {cohort!r} has unmet nominal demand; "
                f"borrowing by queue {name!r} is frozen until it is "
                "reclaimed"), False
        return True, borrow, None, False

    def _cohort_has_unmet_nominal_demand(self, group: SliceGroup,
                                         cohort: str,
                                         borrower_cq: str) -> bool:
        """True while some still-pending group of ANOTHER cohort queue
        fits under its own queue's nominal quota (at current in-pass
        usage): its share must not be lent out underneath it. Same-
        cluster-queue demands don't freeze — within one queue, FIFO-
        within-priority lane ordering already decides who goes first,
        and freezing a queue's own borrow for a demand queued behind it
        would deadlock the lane."""
        gk = (group.metadata.namespace, group.metadata.name)
        for key, (pg, pcq) in self._pending_nominal.items():
            if (key == gk or pcq is None or pcq.spec.cohort != cohort
                    or pcq.metadata.name == borrower_cq):
                continue
            if (self.usage.get(pcq.metadata.name, 0) + self.chips_of(pg)
                    <= pcq.spec.nominal_chips):
                return True
        return False

    def on_admit(self, group: SliceGroup, need: int, borrow: int) -> None:
        cq = self._resolve(group)
        self.mgr._clear_wait(group)
        self._pending_nominal.pop((group.metadata.namespace,
                                   group.metadata.name), None)
        qname = group.spec.queue
        if qname:
            self.tq_admitted[qname] = self.tq_admitted.get(qname, 0) + need
            self.pending[qname] = max(0, self.pending.get(qname, 0) - 1)
            since = group.status.pending_since \
                or group.metadata.creation_timestamp
            if since is not None:
                metrics.queue_admission_wait_seconds.observe(
                    max(0.0, (self.now - since).total_seconds()),
                    queue=qname)
        if cq is None:
            return
        self.usage[cq.metadata.name] = \
            self.usage.get(cq.metadata.name, 0) + need
        self.cohort_usage[cq.spec.cohort] = \
            self.cohort_usage.get(cq.spec.cohort, 0) + need
        if borrow > 0:
            self.mgr._event(group, EVENT_TYPE_NORMAL,
                            REASON_BORROWED_CAPACITY,
                            f"SliceGroup admitted with {borrow} chips "
                            f"borrowed from cohort {cq.spec.cohort!r} "
                            f"above queue {cq.metadata.name!r} nominal "
                            "quota")

    def on_blocked(self, group: SliceGroup, need: int, quota_ok: bool,
                   why: Optional[str], terminal: bool,
                   fits_phys: bool, priority: int = 0) -> None:
        """Record why a queued group didn't admit this pass. A group
        that is quota-eligible UNDER NOMINAL but physically blocked is
        a reclaim demand: borrowers in its cohort are sitting on its
        share."""
        cq = self._resolve(group)
        if cq is None:
            return  # default queue: physical-capacity wait, not quota
        used = self.usage.get(cq.metadata.name, 0)
        if (used + need <= cq.spec.nominal_chips
                and cq.metadata.name not in self._missing_cq):
            # Blocked NOMINAL demand — whether by physical capacity or
            # by a full cohort, borrowers in its cohort are sitting on
            # its share: register the reclaim.
            self._reclaim_demands.append((priority, group, cq, need))
            msg = (f"waiting for cohort {cq.spec.cohort!r} to "
                   f"reclaim {need} chips of queue "
                   f"{cq.metadata.name!r} nominal quota from "
                   "borrowers")
            self.mgr._set_wait(group, QuotaWait(
                queue=group.spec.queue, message=msg,
                since=group.status.pending_since or self.now))
            trace_mod.JOURNAL.record(
                group.metadata.namespace, group.metadata.name,
                "admission.defer", "quota-reclaim-pending", msg)
            return
        if quota_ok:
            return  # over-nominal borrow that fits quota but not chips
        self.mgr._set_wait(group, QuotaWait(
            queue=group.spec.queue,
            message=why or "waiting for quota",
            terminal=terminal,
            since=group.status.pending_since or self.now))
        trace_mod.JOURNAL.record(
            group.metadata.namespace, group.metadata.name,
            "admission.deny" if terminal else "admission.defer",
            "quota-terminal" if terminal else "quota",
            why or "waiting for quota")

    # -- pass end -------------------------------------------------------

    def reclaims(self) -> List[Tuple[str, str, str, str, int]]:
        """(namespace, name, queue, reason, chips_needed) of borrowed
        gangs to displace so nominal demands can land — chips_needed is
        the portion of the demander's unmet nominal this victim was
        chosen to cover (the elastic resize pass shrinks by just that
        much instead of displacing wholesale when the victim's gang
        opted into minSlices; docs/elastic.md). Victims are chosen from
        over-nominal cohort members — lowest priority first, youngest
        first — honoring the demanding queue's reclaimPolicy; a queue
        is never reclaimed below its nominal."""
        out: List[Tuple[str, str, str, str, int]] = []
        if not self._reclaim_demands:
            return out
        usage = dict(self.usage)
        # Highest-priority, oldest demand first (matches admission order).
        demands = sorted(
            self._reclaim_demands,
            key=lambda d: (-d[0], _ts(d[1].metadata.creation_timestamp),
                           d[1].metadata.name))
        taken: set = set()
        for pri, demander, cq, need in demands:
            if cq.spec.reclaim_policy == ReclaimPolicy.NEVER:
                continue
            cohort = cq.spec.cohort
            unmet = need
            victims = []
            for g, vcq in self._occupied:
                vk = (g.metadata.namespace, g.metadata.name)
                if vk in taken or vcq.spec.cohort != cohort:
                    continue
                vpri = self.mgr.priority_of(g)
                if (cq.spec.reclaim_policy == ReclaimPolicy.LOWER_PRIORITY
                        and vpri >= pri):
                    continue
                victims.append((vpri, g, vcq))
            # Running gangs are reclaimed last (they lose real work);
            # within a band: lowest priority, youngest first.
            victims.sort(key=lambda v: (
                v[1].status.phase == PHASE_RUNNING, v[0],
                -_ts(v[1].metadata.creation_timestamp),
                v[1].metadata.name))
            for vpri, g, vcq in victims:
                if unmet <= 0:
                    break
                # Re-checked per eviction: a queue is never reclaimed
                # below its nominal, and an earlier eviction may have
                # already returned it there.
                if usage.get(vcq.metadata.name, 0) <= vcq.spec.nominal_chips:
                    continue  # not borrowing: its chips are its own
                c = self.chips_of(g)
                vk = (g.metadata.namespace, g.metadata.name)
                taken.add(vk)
                usage[vcq.metadata.name] = \
                    usage.get(vcq.metadata.name, 0) - c
                covered = min(unmet, c)
                unmet -= c
                out.append((vk[0], vk[1], g.spec.queue,
                            f"QuotaReclaimed: cohort {cohort!r} demands "
                            f"{need} chips of queue "
                            f"{cq.metadata.name!r} nominal quota back "
                            f"from borrower queue "
                            f"{vcq.metadata.name!r}", covered))
        return out

    def finish(self) -> None:
        """Publish per-queue gauges and TenantQueue/ClusterQueue status
        (write-on-change only), and drop wait states for groups that no
        longer exist."""
        self.mgr._prune_waits(self._live_keys)
        for (ns, name), tq in self.tenant_queues.items():
            pending = self.pending.get(name, 0)
            admitted = self.tq_admitted.get(name, 0)
            metrics.queue_pending_slices.set(pending, queue=name)
            if (tq.status.pending_groups != pending
                    or tq.status.admitted_chips != admitted):
                tq.status.pending_groups = pending
                tq.status.admitted_chips = admitted
                self.mgr._update_status(store_mod.TENANTQUEUES, tq)
        for name, cq in self.cluster_queues.items():
            used = self.usage.get(name, 0)
            borrowed = max(0, used - cq.spec.nominal_chips)
            metrics.queue_admitted_chips.set(used, queue=name)
            metrics.queue_borrowed_chips.set(borrowed, queue=name)
            pending = sum(
                self.pending.get(tq.metadata.name, 0)
                for tq in self.tenant_queues.values()
                if tq.spec.cluster_queue == name)
            if (cq.status.admitted_chips != used
                    or cq.status.borrowed_chips != borrowed
                    or cq.status.pending_groups != pending):
                cq.status.admitted_chips = used
                cq.status.borrowed_chips = borrowed
                cq.status.pending_groups = pending
                self.mgr._update_status(store_mod.CLUSTERQUEUES, cq)


class TenantQueueManager:
    """The quota hook ``SliceGangScheduler`` consults (one ``plan`` per
    admission pass, under the scheduler lock) and the engine queries
    for job conditions (``status_for``)."""

    def __init__(self, store: Store, recorder=None,
                 priority_of: Optional[Callable[[SliceGroup], int]] = None):
        self.store = store
        self.recorder = recorder
        # Bound to the gang scheduler's _priority_of after wiring so
        # reclaim ordering and priority preemption share one notion of
        # priority; identity 0 until then.
        self.priority_of = priority_of or (lambda g: 0)
        self._lock = threading.Lock()
        # (namespace, group name) -> QuotaWait
        self._waits: Dict[Tuple[str, str], QuotaWait] = {}
        # (namespace, group name, queue) orphan events already emitted.
        self._orphan_noted: set = set()

    # -- gang scheduler entry points ------------------------------------

    def plan(self, groups: List[SliceGroup],
             chips_of: Callable[[SliceGroup], int],
             now: _dt.datetime) -> _QuotaPass:
        return _QuotaPass(self, groups, chips_of, now)

    def note_reclaimed(self, queue: str, namespace: str, name: str,
                       reason: str) -> None:
        """A reclaim displacement landed (gang.displace succeeded)."""
        metrics.quota_reclaims.inc(queue=queue or "")
        group = self.store.try_get(store_mod.SLICEGROUPS, namespace, name)
        if group is not None:
            self._event(group, EVENT_TYPE_WARNING, REASON_QUOTA_RECLAIMED,
                        reason)

    # -- engine entry point ---------------------------------------------

    def status_for(self, job: TPUJob) -> Optional[QuotaWait]:
        with self._lock:
            return self._waits.get((job.metadata.namespace,
                                    job.metadata.name))

    # -- internals -------------------------------------------------------

    def _set_wait(self, group: SliceGroup, wait: QuotaWait) -> None:
        key = (group.metadata.namespace, group.metadata.name)
        with self._lock:
            prev = self._waits.get(key)
            self._waits[key] = wait
        if prev is None or prev.message != wait.message:
            self._event(group,
                        EVENT_TYPE_WARNING if wait.terminal
                        else EVENT_TYPE_NORMAL,
                        REASON_QUEUED_WAITING_FOR_QUOTA, wait.message)

    def _clear_wait(self, group: SliceGroup) -> None:
        with self._lock:
            self._waits.pop((group.metadata.namespace,
                             group.metadata.name), None)

    def _prune_waits(self, live_keys: set) -> None:
        with self._lock:
            for key in [k for k in self._waits if k not in live_keys]:
                del self._waits[key]

    def _note_orphaned(self, group: SliceGroup, qname: str) -> None:
        """The group references a TenantQueue that doesn't exist
        (deleted with pending groups, or never created): it re-queues
        to the default queue — quota-exempt — and says so once."""
        key = (group.metadata.namespace, group.metadata.name, qname)
        if key in self._orphan_noted:
            return
        self._orphan_noted.add(key)
        self._clear_wait(group)
        log.warning("slice group %s/%s references TenantQueue %r which "
                    "does not exist; re-queued to the default queue",
                    group.metadata.namespace, group.metadata.name, qname)
        self._event(group, EVENT_TYPE_WARNING, REASON_QUEUE_DELETED,
                    f"TenantQueue {qname!r} was deleted (or never "
                    "existed); group re-queued to the default queue")

    def _event(self, group: SliceGroup, etype: str, reason: str,
               message: str) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event(group, etype, reason, message)
            except Exception:
                log.debug("quota event emit failed", exc_info=True)

    def _update_status(self, kind: str, obj) -> None:
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        # Conflict-aware read-modify-write (runtime/retry.py): a CAS
        # loss re-reads the queue and re-applies the computed status on
        # fresh state instead of silently dropping the publication (a
        # dropped status used to linger until the NEXT admission pass —
        # under a conflict storm that meant dashboards reading stale
        # pending/borrowed numbers indefinitely). A vanished queue or
        # exhausted retries degrade to the old behavior: the next pass
        # republishes.
        desired = obj.status.deepcopy()

        def apply(cur):
            cur.status = desired.deepcopy()

        try:
            retry_mod.update_with_conflict_retry(
                self.store, kind, obj.metadata.namespace,
                obj.metadata.name, apply, status=True,
                component="quota.status")
        except Exception:
            log.debug("queue status publish failed; next pass "
                      "republishes", exc_info=True)


# ---------------------------------------------------------------------------
# Queue config file (cli --queue-config): declarative seed for the
# store's TenantQueue/ClusterQueue collections — the CRD-apply analog
# for the process-native control plane.
# ---------------------------------------------------------------------------

def load_queue_config(path: str) -> Tuple[List[ClusterQueue],
                                          List[TenantQueue]]:
    """Parse a YAML/JSON queue config::

        clusterQueues:
          - name: pool-a
            nominalChips: 16
            borrowingLimit: 8      # omit for unlimited
            cohort: research       # defaults to the queue name
            reclaimPolicy: Any     # Never | LowerPriority | Any
        tenantQueues:
          - name: team-a
            namespace: default     # defaults to "default"
            clusterQueue: pool-a

    Objects come back validated and defaulted; raises ValueError /
    ValidationError on malformed input.
    """
    import dataclasses

    try:
        import yaml
    except ImportError:
        raise ImportError(f"{path}: reading a queue config needs pyyaml, "
                          "which is not installed") from None

    from tf_operator_tpu_torch.api.serde import snake_to_camel
    from tf_operator_tpu_torch.api.types import ClusterQueueSpec, TenantQueueSpec

    def check_keys(raw: dict, cls, extra: set, what: str) -> None:
        allowed = {snake_to_camel(f.name)
                   for f in dataclasses.fields(cls)} | extra
        unknown = sorted(set(raw) - allowed)
        if unknown:
            raise ValueError(
                f"{path}: unknown {what} key(s) {unknown}; expected "
                f"{sorted(allowed)}")

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: queue config must be a mapping")
    unknown_top = sorted(set(data) - {"clusterQueues", "tenantQueues"})
    if unknown_top:
        raise ValueError(f"{path}: unknown top-level key(s) {unknown_top}")
    cluster_queues: List[ClusterQueue] = []
    for raw in data.get("clusterQueues") or []:
        raw = dict(raw)
        name = raw.pop("name", "")
        check_keys(raw, ClusterQueueSpec, set(), "clusterQueue")
        cq = ClusterQueue(spec=ClusterQueueSpec.from_dict(raw))
        cq.metadata.name = name
        cq.metadata.namespace = ""
        validate_cluster_queue(cq)
        cluster_queues.append(set_cluster_queue_defaults(cq))
    tenant_queues: List[TenantQueue] = []
    for raw in data.get("tenantQueues") or []:
        raw = dict(raw)
        name = raw.pop("name", "")
        namespace = raw.pop("namespace", "default")
        check_keys(raw, TenantQueueSpec, set(), "tenantQueue")
        tq = TenantQueue(spec=TenantQueueSpec.from_dict(raw))
        tq.metadata.name = name
        tq.metadata.namespace = namespace
        validate_tenant_queue(tq)
        tenant_queues.append(tq)
    return cluster_queues, tenant_queues


def seed_queues(store: Store, cluster_queues: List[ClusterQueue],
                tenant_queues: List[TenantQueue]) -> None:
    """Create-or-replace the configured queues in the store (spec only;
    live status is preserved by update_status semantics being separate)."""
    for cq in cluster_queues:
        existing = store.try_get(store_mod.CLUSTERQUEUES, "",
                                 cq.metadata.name)
        if existing is None:
            store.create(store_mod.CLUSTERQUEUES, cq)
        elif existing.spec.to_dict() != cq.spec.to_dict():
            existing.spec = cq.spec
            store.update(store_mod.CLUSTERQUEUES, existing)
    for tq in tenant_queues:
        existing = store.try_get(store_mod.TENANTQUEUES,
                                 tq.metadata.namespace, tq.metadata.name)
        if existing is None:
            store.create(store_mod.TENANTQUEUES, tq)
        elif existing.spec.to_dict() != tq.spec.to_dict():
            existing.spec = tq.spec
            store.update(store_mod.TENANTQUEUES, existing)


def _ts(t) -> float:
    return t.timestamp() if t is not None else 0.0
