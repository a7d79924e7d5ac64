"""Slice-health & auto-repair: maintenance-aware node lifecycle with
gang drain/rebind (port of tf_operator_tpu/controller/health.py; a
slice's hosts are counted through the port's ``parse_accelerator``).

The dominant real-world failure mode on TPU fleets is not the job's own
code — it is the node under it going away mid-run: scheduled maintenance
events, device-plugin loss, spot preemption ("Exploring the limits of
Concurrency in ML Training on Google TPUs", arXiv:2011.03641). At pod
scale one bad chip stalls the whole gang, so the unit of repair is the
*slice*, never the pod. The reference operator had no answer here — it
delegated node lifecycle to the cluster (kubelet taints, external
``kubectl drain`` tooling) and its gangs simply failed.

This controller closes the loop the way the binder closed placement:

1. **Watch** Node state mirrored by the informer: the Ready condition
   (a missing one means a never-heartbeated kubelet — NotReady, see
   ``runtime/kube.py node_from_k8s``) plus device degradation signals
   surfaced as conditions — ``MaintenancePending`` (advance maintenance
   notice; node still Ready and serving) and ``TerminationScheduled``
   (spot-preemption / imminent-termination notice).
2. **Classify** each node Healthy / Degraded / Draining
   (``classify_node``). Degraded nodes carrying an advance notice are
   **cordoned** (``spec.unschedulable``) so the binder stops targeting
   them and their chips leave the admission budget — the shared
   schedulability predicate (``binder.node_is_schedulable``) makes both
   happen at once. Transiently-NotReady nodes are *not* cordoned
   (kubelet restarts must not leave permanent cordons; NotReady already
   excludes them from capacity and placement).
3. **Drain** affected SliceGroups atomically, per the job's
   ``HealthPolicy`` (opt-in, with a drain grace window for a final
   checkpoint): evict the *whole* gang through pod control, then
   ``gang.displace()`` the group — back to Pending, fresh aging window,
   NVLink-domain reservation released — so it re-enters gang admission
   ahead of equal-priority newcomers (admission orders by creation
   time, which a displaced group keeps).
4. **Rebind & resume**: the engine recreates the evicted pods with the
   same identity (restart-with-identity), the recreated pods re-gate on
   the now-Pending group, admission re-admits onto the remaining spare
   capacity, and the binder places the slice whole in a healthy
   NVLink domain — preferring non-maintenance-pending nodes
   (``HealthPolicy.prefer_spare_capacity``). The job resumes from its
   latest checkpoint; the displaced marker surfaces as a Restarting
   condition on the job (engine.py) until the gang is fully back up.

Level-triggered and stateless where it matters: every pass re-derives
degraded nodes and affected gangs from the informer cache, so failed
cordons/evictions retry, an operator restart mid-drain converges, and a
healed node (signal cleared before the grace expired) cancels the drain.
Only the drain-grace anchor and the time-to-rebind stopwatch are
in-memory — losing them on failover costs one grace window restart and
one histogram sample, never correctness.

Observability: ``NodeCordoned`` / ``SliceDrainPending`` /
``SliceDrained`` / ``SliceRebound`` events (runtime/events.py),
``tpu_operator_slice_drains_total``,
``tpu_operator_nodes_cordoned_total`` and the
``tpu_operator_drain_rebind_seconds`` histogram (docs/monitoring.md).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    DisruptionClass,
    HealthPolicy,
    Node,
    Pod,
    ReplicaType,
    TPUJob,
    effective_role_policy,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    REASON_NODE_CORDONED,
    REASON_SLICE_DRAIN_PENDING,
    REASON_SLICE_DRAINED,
    REASON_SLICE_REBOUND,
)
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.health")

# Node health states (classify_node).
NODE_HEALTHY = "Healthy"
NODE_DEGRADED = "Degraded"      # degradation signal, not yet cordoned
NODE_DRAINING = "Draining"      # degradation signal + cordoned

# Condition types read off NodeStatus.conditions. MaintenancePending is
# the *advance* notice (node still Ready; GKE surfaces host maintenance
# events ahead of time); TerminationScheduled is the imminent spot/
# preemption warning. Both are cordon-worthy: the node is doomed while
# still looking placeable.
COND_READY = "Ready"
COND_MAINTENANCE = "MaintenancePending"
COND_TERMINATION = "TerminationScheduled"

# Degradation reasons (also the nodes_cordoned metric label values).
REASON_NOT_READY = "NotReady"

_TERMINAL_POD_PHASES = ("Succeeded", "Failed")


def node_maintenance_pending(node: Node) -> bool:
    """Advance-notice signal only: the node still serves but should not
    receive new work if clean capacity exists (binder placement
    preference)."""
    c = node.status.conditions
    return (c.get(COND_MAINTENANCE) == "True"
            or c.get(COND_TERMINATION) == "True")


def node_degradation_reason(node: Node) -> str:
    """The strongest degradation signal on a node, '' when healthy.
    Ordered hard-to-soft: a NotReady node is already gone; a
    TerminationScheduled one is about to be; MaintenancePending is an
    advance notice jobs may opt out of reacting to."""
    if node.status.phase not in ("", "Ready"):
        return REASON_NOT_READY
    if node.status.conditions.get(COND_TERMINATION) == "True":
        return COND_TERMINATION
    if node.status.conditions.get(COND_MAINTENANCE) == "True":
        return COND_MAINTENANCE
    return ""


def classify_node(node: Node) -> Tuple[str, str]:
    """-> (Healthy|Degraded|Draining, reason). An admin-cordoned node
    with no degradation signal stays Healthy — cordons the operator did
    not place are not its business to drain off."""
    reason = node_degradation_reason(node)
    if not reason:
        return NODE_HEALTHY, ""
    if node.spec.unschedulable:
        return NODE_DRAINING, reason
    return NODE_DEGRADED, reason


def job_health_policy(job: Optional[TPUJob]) -> Optional[HealthPolicy]:
    if job is None:
        return None
    return job.spec.run_policy.health_policy


class SliceHealthController:
    """Watches node health and auto-repairs gangs (module docstring).

    Seams mirror the binder's for testability: ``client`` supplies the
    cordon write (None = cordon via the store, the local/served control
    plane's path), ``pod_control`` the evictions, ``gang`` the
    displace/readmit hook. One daemon thread; store watch events wake
    it, a resync tick bounds staleness.
    """

    def __init__(self, store: Store, client=None, gang=None,
                 pod_control=None, recorder=None,
                 namespace: Optional[str] = None,
                 default_grace_seconds: float = 0.0,
                 resync_seconds: float = 1.0,
                 ckpt=None,
                 cp_health=None):
        self.store = store
        self.client = client
        self.gang = gang
        self.pod_control = pod_control
        self.recorder = recorder
        # Optional ControlPlaneHealth (runtime/retry.py): while the API
        # server is degraded, NEW drains are deferred — a drain started
        # against an unreachable apiserver evicts pods it then cannot
        # displace/rebind, the exact half-executed state the chaos
        # invariants forbid. Cordons and signal classification continue
        # (reads + an idempotent patch that simply retries).
        self.cp_health = cp_health
        # Optional checkpoint coordinator (controller/ckpt.py): a drain
        # of a checkpointPolicy-enabled gang becomes save-then-evict —
        # the eviction waits (bounded by barrierTimeoutSeconds) for the
        # gang's final save acks. None = pre-coordinator drains.
        self.ckpt = ckpt
        self.namespace = namespace
        self.default_grace_seconds = default_grace_seconds
        self.resync_seconds = resync_seconds
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watchers: list = []
        # (ns, group) -> monotonic time the degradation was first seen
        # (drain-grace anchor; episode resets when the signal clears).
        self._drain_first_seen: Dict[Tuple[str, str], float] = {}
        # (ns, group) -> monotonic drain time, for the time-to-rebind
        # histogram; cleared once the gang is fully bound again.
        self._rebind_started: Dict[Tuple[str, str], float] = {}
        # uids of the pods this controller evicted that the store still
        # lists. On the kube backend the store is an informer cache that
        # sees a deletion only when its watch event arrives; until then
        # an evicted pod must not doom its gang again (a second drain
        # would evict the rebound pods and count one episode twice).
        self._evicted_uids: set = set()
        # Groups already warned about a pending (grace-window) drain.
        self._warned_pending: set = set()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "SliceHealthController":
        for kind in (store_mod.NODES, store_mod.PODS,
                     store_mod.SLICEGROUPS):
            self._watchers.append(
                self.store.watch(kind, self._on_event, replay=False))
        self._thread = threading.Thread(target=self._run,
                                        name="slice-health",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for w in self._watchers:
            w.stop()
        self._watchers = []
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _on_event(self, etype: str, obj) -> None:
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.resync_seconds)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.health_pass()
            except Exception:
                log.exception("health pass failed; retrying next pass")

    # -- one level-triggered pass ---------------------------------------

    def health_pass(self) -> None:
        """Classify nodes, cordon advance-notice ones, drain affected
        gangs whose policy opts in, and close out rebind stopwatches."""
        degraded: Dict[str, str] = {}  # node name -> reason
        for node in self.store.list(store_mod.NODES):
            state, reason = classify_node(node)
            if state == NODE_HEALTHY:
                continue
            degraded[node.metadata.name] = reason
            if state == NODE_DEGRADED and reason != REASON_NOT_READY:
                # Advance notices leave the node Ready and placeable —
                # cordon so the binder stops targeting it and its chips
                # leave the admission budget. NotReady is already
                # excluded by the shared schedulability predicate, and
                # cordoning on it would outlive a kubelet blip forever
                # (nothing uncordons here).
                self._cordon(node, reason)
        self._drain_affected_gangs(degraded)
        self._observe_rebinds(degraded)

    def _cordon(self, node: Node, reason: str) -> None:
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        name = node.metadata.name

        def write():
            if self.client is not None:
                self.client.patch(store_mod.NODES, "", name,
                                  {"spec": {"unschedulable": True}})
            else:
                fresh = node.deepcopy()
                fresh.spec.unschedulable = True
                self.store.update(store_mod.NODES, fresh)

        try:
            # Transient blips retry in place with backoff
            # (runtime/retry.py); what survives logs and the next pass
            # re-derives + retries level-triggered.
            retry_mod.with_retries(write, component="health.cordon",
                                   health=self.cp_health)
        except (store_mod.NotFoundError, store_mod.ConflictError):
            return  # node changed/vanished underneath; next pass retries
        except Exception as e:
            log.warning("cordoning node %s failed (will retry): %s",
                        name, e)
            return
        metrics.nodes_cordoned.inc(reason=reason)
        log.info("cordoned node %s (%s)", name, reason)
        if self.recorder is not None:
            self.recorder.event(node, EVENT_TYPE_WARNING,
                                REASON_NODE_CORDONED,
                                f"Node {name} cordoned: {reason}")

    # -- gang drain ------------------------------------------------------

    def _drain_affected_gangs(self, degraded: Dict[str, str]) -> None:
        affected = self._affected_groups(degraded)
        # Episodes that healed (signal cleared, or the pods left the
        # degraded nodes) stop aging toward eviction.
        for key in list(self._drain_first_seen):
            if key not in affected:
                del self._drain_first_seen[key]
                self._warned_pending.discard(key)
        if not affected:
            return
        now = time.monotonic()
        for (ns, name), bad_pods in sorted(affected.items()):
            job = self.store.try_get(store_mod.TPUJOBS, ns, name)
            policy = job_health_policy(job)
            if policy is None or not policy.enabled:
                continue  # not opted in: the gang is left untouched
            reasons = sorted({degraded[p.spec.node_name]
                              for p in bad_pods})
            if (not policy.handle_maintenance
                    and all(r == COND_MAINTENANCE for r in reasons)):
                continue  # advance notices explicitly ignored by policy
            if self._evict_class_only(ns, name, job, bad_pods, reasons):
                # Every doomed pod belongs to a role that EXPLICITLY
                # opted out of the barrier (disruptionClass evict or
                # ignore — RL actors, docs/rl.md): evict-class pods are
                # deleted immediately (no grace, no barrier, no gang
                # displacement — the engine recreates them on healthy
                # capacity), ignore-class pods are left alone entirely.
                # The learner world never notices. Default-policy roles
                # never take this lane, so homogeneous gangs keep the
                # atomic-drain path byte-for-byte.
                continue
            grace = (policy.drain_grace_seconds
                     if policy.drain_grace_seconds is not None
                     else self.default_grace_seconds)
            first = self._drain_first_seen.setdefault((ns, name), now)
            if now - first < grace:
                if (ns, name) not in self._warned_pending:
                    self._warned_pending.add((ns, name))
                    self._record(job, EVENT_TYPE_WARNING,
                                 REASON_SLICE_DRAIN_PENDING,
                                 f"Gang {name} runs on degraded node(s) "
                                 f"({', '.join(reasons)}); draining in "
                                 f"{grace:.0f}s unless they recover")
                continue
            if (self.cp_health is not None
                    and not self.cp_health.allow_disruption("drain")):
                # Degraded control plane: starting a drain now could
                # evict pods and then fail to displace/rebind them —
                # the half-executed state the invariants forbid. The
                # signal persists, so the next healthy pass drains.
                # Gated BEFORE ready_to_evict so no barrier is opened
                # that the controller may not be able to enforce.
                trace_mod.JOURNAL.record(
                    ns, name, "disruption.deferred",
                    "controlplane-degraded",
                    f"health drain ({', '.join(reasons)}) deferred: "
                    "the API server is degraded (docs/robustness.md)")
                continue
            if self._try_elastic_shrink(ns, name, job, bad_pods, reasons):
                # The gang rides out the capacity loss as a shrink
                # (docs/elastic.md): only the doomed slices leave the
                # world, the survivors restart into the smaller one and
                # resume from the barrier-committed checkpoint. Either
                # the shrink landed or its save barrier is in flight —
                # both mean no full drain this pass.
                continue
            if self.ckpt is not None and not self.ckpt.ready_to_evict(
                    ns, name, f"node degraded ({', '.join(reasons)})"):
                # Save-before-evict barrier in flight: the gang is
                # writing its final checkpoint. Hold the eviction; the
                # next health pass (resync tick) re-consults, and the
                # barrier timeout guarantees the drain can never hang
                # behind a wedged worker.
                continue
            self._drain(ns, name, job, bad_pods, reasons)

    def _evict_class_only(self, ns: str, name: str, job: TPUJob,
                          bad_pods: List[Pod],
                          reasons: List[str]) -> bool:
        """The actor lane (docs/rl.md): when EVERY pod of the gang on a
        degraded node belongs to a role whose RolePolicy explicitly
        declares disruptionClass evict or ignore, handle the episode
        per-pod instead of per-gang — delete the evict-class pods (the
        engine recreates them elsewhere; no barrier, no displacement,
        no Restarting arc) and skip ignore-class ones. Returns True
        when the episode was handled here (including "all ignored");
        False sends the gang down the existing drain path — which is
        what happens whenever a learner shares the bad node, because
        learners resolve to barrier class."""
        classified = []
        for p in bad_pods:
            eff = effective_role_policy(
                job, p.metadata.labels.get(constants.LABEL_REPLICA_TYPE,
                                           ""))
            if not (eff.explicit_disruption and eff.disruption_class in
                    (DisruptionClass.EVICT, DisruptionClass.IGNORE)):
                return False
            classified.append((p, eff.disruption_class))
        to_evict = [p for p, c in classified
                    if c == DisruptionClass.EVICT]
        if not to_evict:
            return True  # all ignore-class: leave them where they are
        if (self.cp_health is not None
                and not self.cp_health.allow_disruption("drain")):
            trace_mod.JOURNAL.record(
                ns, name, "disruption.deferred", "controlplane-degraded",
                f"actor eviction ({', '.join(reasons)}) deferred: the "
                "API server is degraded (docs/robustness.md)")
            return True
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        evicted = []
        for p in to_evict:
            try:
                if self.pod_control is not None:
                    retry_mod.with_retries(
                        lambda p=p: self.pod_control.delete_pod(
                            ns, p.metadata.name, job),
                        component="health.actor_evict",
                        health=self.cp_health)
                else:
                    retry_mod.with_retries(
                        lambda p=p: self.store.try_delete(
                            store_mod.PODS, ns, p.metadata.name),
                        component="health.actor_evict",
                        health=self.cp_health)
            except Exception as e:
                log.warning("evicting actor pod %s/%s failed (will "
                            "retry): %s", ns, p.metadata.name, e)
                continue
            self._evicted_uids.add(p.metadata.uid)
            evicted.append(p.metadata.name)
            metrics.actor_preemptions.inc(job_namespace=ns,
                                          reason="health")
        if evicted:
            reason_str = ", ".join(reasons)
            trace_mod.JOURNAL.record(
                ns, name, "actor-evicted", "node-degraded",
                f"{len(evicted)} evict-class replica(s) deleted off "
                f"degraded node(s) ({reason_str}); no barrier, no gang "
                "drain — the learner world keeps running")
            log.info("evicted %d evict-class pod(s) of gang %s/%s off "
                     "degraded node(s) (%s); learner world untouched",
                     len(evicted), ns, name, reason_str)
            from tf_operator_tpu_torch.runtime.events import (
                REASON_ACTOR_EVICTED,
            )

            self._record(job, EVENT_TYPE_NORMAL, REASON_ACTOR_EVICTED,
                         f"{len(evicted)} evict-class replica(s) of "
                         f"{name} evicted off degraded node(s) "
                         f"({reason_str}); recreated on healthy "
                         "capacity, learner gang unaffected")
        return True

    def _try_elastic_shrink(self, ns: str, name: str, job: TPUJob,
                            bad_pods: List[Pod],
                            reasons: List[str]) -> bool:
        """Prefer shrinking an elastic gang over draining it whole:
        when every pod on the degraded node(s) is a worker and dropping
        their slices keeps the gang at or above ``minSlices``, ask the
        gang scheduler for a shrink by that many slices. True = handled
        elastically (landed, or its save-before-evict barrier is still
        in flight — the next health pass re-consults); False = not
        applicable, fall back to the atomic full drain."""
        gang = self.gang
        if gang is None or not getattr(gang, "elastic", False):
            return False
        doomed = self._doomed_slices(job, bad_pods)
        if doomed is None:
            return False  # a coordinator-role pod is doomed: full drain
        res = gang.try_shrink(ns, name, doomed, "drain",
                              f"node degraded ({', '.join(reasons)})")
        if res is None:
            return False  # not elastic / would fall below minSlices
        if res:
            # Shrink landed: this degradation episode is answered — the
            # survivors leave the degraded node via the world restart.
            self._drain_first_seen.pop((ns, name), None)
            self._warned_pending.discard((ns, name))
        return True

    def _doomed_slices(self, job: TPUJob,
                       bad_pods: List[Pod]) -> Optional[int]:
        """How many slices the degraded node(s) doom, or None when the
        loss is not expressible as whole worker slices (a chief/ps pod
        is affected, or an index is unparseable)."""
        sl = job.spec.slice
        if not sl.accelerator:
            return None
        from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator

        try:
            topo = parse_accelerator(sl.accelerator, sl.topology,
                                     max(1, sl.num_slices))
        except ValueError:
            return None
        hps = max(1, topo.hosts_per_slice)
        doomed: set = set()
        for p in bad_pods:
            if (p.metadata.labels.get(constants.LABEL_REPLICA_TYPE, "")
                    != ReplicaType.WORKER):
                return None
            raw = p.metadata.labels.get(constants.LABEL_REPLICA_INDEX)
            try:
                index = int(raw)
            except (TypeError, ValueError):
                return None
            doomed.add(index // hps)
        return len(doomed) or None

    def _affected_groups(self, degraded: Dict[str, str]
                         ) -> Dict[Tuple[str, str], List[Pod]]:
        """(ns, gang group) -> its live pods bound to degraded nodes."""
        pods = self.store.list(store_mod.PODS, namespace=self.namespace)
        self._evicted_uids &= {p.metadata.uid for p in pods}
        if not degraded:
            return {}
        affected: Dict[Tuple[str, str], List[Pod]] = {}
        for p in pods:
            if (p.status.phase in _TERMINAL_POD_PHASES
                    or p.spec.node_name not in degraded
                    or p.metadata.uid in self._evicted_uids):
                continue
            group = p.metadata.annotations.get(
                constants.ANNOTATION_GANG_GROUP, "")
            if group:
                affected.setdefault((p.metadata.namespace, group),
                                    []).append(p)
        return affected

    def _drain(self, ns: str, name: str, job: TPUJob,
               bad_pods: List[Pod], reasons: List[str]) -> None:
        """Atomic gang drain: evict EVERY live pod of the group (a slice
        is indivisible — keeping the healthy members would pin the slice
        to the degraded domain and leave the gang below minMember
        forever), then displace the SliceGroup back through admission.
        A failed eviction aborts the pass; the next one re-derives and
        retries with nothing double-counted."""
        with trace_mod.span("health.drain", job=f"{ns}/{name}"):
            self._drain_inner(ns, name, job, bad_pods, reasons)

    def _drain_inner(self, ns: str, name: str, job: TPUJob,
                     bad_pods: List[Pod], reasons: List[str]) -> None:
        group_pods = [
            p for p in self.store.list(
                store_mod.PODS, namespace=ns,
                selector={constants.LABEL_JOB_NAME: name})
            if p.status.phase not in _TERMINAL_POD_PHASES]
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        for p in group_pods:
            try:
                # Transient blips retry in place so one 500 mid-gang
                # doesn't abort the atomic drain halfway through; an
                # exhausted retry aborts the pass and the next one
                # re-derives + retries with nothing double-counted.
                if self.pod_control is not None:
                    retry_mod.with_retries(
                        lambda p=p: self.pod_control.delete_pod(
                            ns, p.metadata.name, job),
                        component="health.drain", health=self.cp_health)
                else:
                    retry_mod.with_retries(
                        lambda p=p: self.store.try_delete(
                            store_mod.PODS, ns, p.metadata.name),
                        component="health.drain", health=self.cp_health)
            except Exception as e:
                log.warning("draining pod %s/%s of gang %s failed "
                            "(will retry): %s", ns, p.metadata.name,
                            name, e)
                return
        # Marked only once the whole gang is evicted: a drain that failed
        # part-way is re-derived and retried by the next pass.
        self._evicted_uids.update(p.metadata.uid for p in group_pods)
        reason_str = ", ".join(reasons)
        trace_mod.JOURNAL.record(
            ns, name, "drained", "node-degraded",
            f"gang atomically drained off degraded node(s) "
            f"({reason_str}); {len(group_pods)} pod(s) evicted, "
            "re-entering admission for rebind on spare capacity")
        if self.gang is not None:
            self.gang.displace(ns, name,
                               f"node degraded ({reason_str})")
        metrics.slice_drains.inc(job_namespace=ns)
        self._rebind_started.setdefault((ns, name), time.monotonic())
        self._drain_first_seen.pop((ns, name), None)
        self._warned_pending.discard((ns, name))
        bad_nodes = sorted({p.spec.node_name for p in bad_pods})
        log.info("drained gang %s/%s off degraded node(s) %s (%s): "
                 "%d pod(s) evicted; re-entering gang admission",
                 ns, name, bad_nodes, reason_str, len(group_pods))
        self._record(job, EVENT_TYPE_WARNING, REASON_SLICE_DRAINED,
                     f"Gang {name} drained off degraded node(s) "
                     f"{', '.join(bad_nodes)} ({reason_str}); "
                     "re-queued for rebind on spare capacity, will "
                     "resume from the latest checkpoint")

    # -- time-to-rebind --------------------------------------------------

    def _observe_rebinds(self, degraded: Dict[str, str]) -> None:
        """Close the drain stopwatch once the displaced gang is fully
        bound again on healthy capacity."""
        from tf_operator_tpu_torch.controller.gang import PHASE_PENDING

        for (ns, name), t0 in list(self._rebind_started.items()):
            sg = self.store.try_get(store_mod.SLICEGROUPS, ns, name)
            if sg is None:
                del self._rebind_started[(ns, name)]
                continue  # job gone mid-repair; nothing to observe
            if sg.status.phase == PHASE_PENDING:
                continue  # still gated (or the old pods still mirror)
            pods = [
                p for p in self.store.list(
                    store_mod.PODS, namespace=ns,
                    selector={constants.LABEL_JOB_NAME: name})
                if p.status.phase not in _TERMINAL_POD_PHASES]
            want = max(1, sg.spec.min_member)
            bound = [p for p in pods if p.spec.node_name]
            if (len(pods) < want or len(bound) != len(pods)
                    or any(p.spec.node_name in degraded for p in bound)):
                continue
            elapsed = time.monotonic() - t0
            metrics.drain_rebind_seconds.observe(elapsed,
                                                 job_namespace=ns)
            del self._rebind_started[(ns, name)]
            log.info("gang %s/%s fully rebound %.2fs after drain",
                     ns, name, elapsed)
            self._record(self.store.try_get(store_mod.TPUJOBS, ns, name),
                         EVENT_TYPE_NORMAL, REASON_SLICE_REBOUND,
                         f"Gang {name} rebound on spare capacity "
                         f"{elapsed:.2f}s after drain")

    def _record(self, job, etype: str, reason: str, msg: str) -> None:
        if self.recorder is not None and job is not None:
            self.recorder.event(job, etype, reason, msg)
