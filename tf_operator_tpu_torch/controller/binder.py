"""Slice-gang pod binder: in-operator, topology-aware node placement
(port of tf_operator_tpu/controller/binder.py; it counts node-allocatable
``nvidia.com/gpu`` and places slices inside one NVLink domain).

The reference never binds a pod itself — it stamps ``schedulerName`` and
creates a Volcano PodGroup (common/job_controller.go:218-245), then an
external Volcano scheduler gates AND binds. That leaves two admission
brains (this operator's SliceGroup phases and Volcano's own gang logic)
running in parallel, and on a vanilla cluster gang pods deadlock with
nothing bound. Here the operator closes the loop itself: SliceGroup
admission (controller/gang.py) is the single gate, and this binder is
the placement arm — it watches unbound pods carrying
``schedulerName: slice-gang`` whose group is admitted, picks nodes
topology-aware, and POSTs ``pods/binding`` objects the way
kube-scheduler itself places pods. Non-admitted groups' pods stay
unbound; that IS the gang gate. No external scheduler, no second brain.

GPU placement model:

- Nodes advertise GPUs via the ``nvidia.com/gpu`` allocatable resource
  (NVIDIA device-plugin convention) and name their fabric domain with
  the ``tpu-operator.dev/nvlink-domain`` label (fallback: the GKE node
  pool label — on GKE a GPU node pool is one such domain).
- A slice is indivisible over its fabric: every host (worker pod) of one
  slice must land inside one NVLink domain, all-or-nothing. Distinct
  slices of a multislice job may land in different domains (that
  traffic rides the data-center network by design).
- Coordinator-only pods (chief/master/ps/evaluator — zero GPU demand)
  may land on any schedulable node.

The binder reads each node's GPUs from ``Node.spec.chips``: a Kubernetes
node's allocatable ``nvidia.com/gpu`` turned into that field by the
Kubernetes backend's ``node_from_k8s`` (runtime/kube.py), a served
node agent's ``--chips``, or an in-process ``Store`` node with an
injected bind endpoint, as its tests drive it.

Placement is level-triggered and stateless: every pass re-derives node
free-chip inventory and unbound gang pods from the informer cache, so a
binder restart, leader failover, or lost bind response converges without
bookkeeping. A 409 on ``pods/binding`` means another binder (or an
earlier self) won — settled, not an error.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import Node, ObjectMeta, Pod, SliceGroup
from tf_operator_tpu_torch.bootstrap.topology import parse_accelerator
from tf_operator_tpu_torch.controller.health import (
    job_health_policy,
    node_maintenance_pending,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
)
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.binder")

ADMITTED_PHASES = ("Inqueue", "Running")


def pod_chip_demand(pod: Pod) -> int:
    """GPUs a pod holds once placed: the sum of its containers'
    declared ``nvidia.com/gpu`` limits (the controller stamps worker
    pods from the slice topology at create time, so gang workers always
    declare; foreign pods count by what they declare)."""
    total = 0
    for c in pod.spec.containers:
        raw = c.resources.get(constants.RESOURCE_GPU, "0") or "0"
        try:
            total += int(float(raw))
        except ValueError:
            pass
    return total


def node_is_ready(node: Node) -> bool:
    """Kubelet reports Ready (an empty phase — e.g. a test double that
    never set one — counts as ready)."""
    return node.status.phase in ("", "Ready")


def node_is_schedulable(node: Node) -> bool:
    """The single placeability predicate shared by the binder's
    placement pass and the operator's admission-capacity provider —
    the two MUST agree or admission books chips placement can't use."""
    return not node.spec.unschedulable and node_is_ready(node)


def node_nvlink_domain(node: Node) -> str:
    """The NVLink domain a node belongs to: first-class label, then the
    GKE node-pool label, then the node's own name (every node its own
    domain — correct for single-host slices, conservative otherwise)."""
    for labels in (node.metadata.labels, node.spec.labels):
        for key in (constants.LABEL_NVLINK_DOMAIN,
                    constants.LABEL_GKE_NODEPOOL):
            if labels.get(key):
                return labels[key]
    return node.metadata.name


# -- hard placement predicates ------------------------------------------
#
# kube-scheduler filters before it scores; a direct pods/binding POST
# bypasses every filter, so the binder must apply the ones kubelet (or
# the taint manager) would otherwise enforce by rejecting/evicting what
# we placed: taints vs tolerations, nodeSelector, and cpu/mem fit.
# These are FILTERS, not preferences — a node that fails one is never a
# candidate, no matter how many chips it has free. kube_fake's binding
# subresource runs the same predicate so tier-1 pins the contract.

def parse_cpu_quantity_millis(raw) -> Optional[int]:
    """'500m' -> 500, '2' -> 2000. None = unparseable/absent."""
    raw = str(raw or "").strip()
    if not raw:
        return None
    try:
        if raw.endswith("m"):
            return int(float(raw[:-1]))
        return int(float(raw) * 1000)
    except ValueError:
        return None


_MEMORY_SUFFIXES = (
    ("Ei", 1024 ** 6), ("Pi", 1024 ** 5), ("Ti", 1024 ** 4),
    ("Gi", 1024 ** 3), ("Mi", 1024 ** 2), ("Ki", 1024),
    ("E", 1000 ** 6), ("P", 1000 ** 5), ("T", 1000 ** 4),
    ("G", 1000 ** 3), ("M", 1000 ** 2), ("k", 1000), ("K", 1000),
)


def parse_memory_quantity_bytes(raw) -> Optional[int]:
    """'512Mi' -> bytes; bare numbers are bytes. None = unparseable."""
    raw = str(raw or "").strip()
    if not raw:
        return None
    for suffix, mult in _MEMORY_SUFFIXES:
        if raw.endswith(suffix):
            try:
                return int(float(raw[:-len(suffix)]) * mult)
            except ValueError:
                return None
    try:
        return int(float(raw))
    except ValueError:
        return None


def pod_cpu_millis(pod: Pod) -> int:
    total = 0
    for c in pod.spec.containers:
        total += parse_cpu_quantity_millis(c.resources.get("cpu")) or 0
    return total


def pod_memory_bytes(pod: Pod) -> int:
    total = 0
    for c in pod.spec.containers:
        total += parse_memory_quantity_bytes(
            c.resources.get("memory")) or 0
    return total


def _toleration_matches(tol, taint) -> bool:
    """core/v1 semantics: empty tol key + Exists tolerates everything;
    empty tol effect tolerates all effects; Equal also matches value."""
    if tol.key:
        if tol.key != taint.key:
            return False
    elif tol.operator != "Exists":
        return False
    if tol.effect and tol.effect != taint.effect:
        return False
    if tol.operator == "Equal" and tol.value != taint.value:
        return False
    return True


def node_rejects_pod(pod: Pod, node: Node,
                     free_cpu_millis: Optional[int] = None,
                     free_memory_bytes: Optional[int] = None
                     ) -> Optional[str]:
    """The reason kube would refuse this placement, or None when the
    node is a legal candidate. ``free_*`` default to the node's full
    allocatable; callers doing pass-local accounting hand in what's
    left. None allocatable = unreported inventory — the fit check is
    skipped rather than rejecting every node."""
    for taint in node.spec.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue  # PreferNoSchedule is advisory
        if not any(_toleration_matches(t, taint)
                   for t in pod.spec.tolerations):
            return (f"node {node.metadata.name} has untolerated taint "
                    f"{taint.key}:{taint.effect}")
    if pod.spec.node_selector:
        labels = dict(node.spec.labels)
        labels.update(node.metadata.labels)
        for k, v in pod.spec.node_selector.items():
            if labels.get(k) != v:
                return (f"node {node.metadata.name} does not match "
                        f"nodeSelector {k}={v}")
    if free_cpu_millis is None:
        free_cpu_millis = node.status.allocatable_cpu_millis
    if free_memory_bytes is None:
        free_memory_bytes = node.status.allocatable_memory_bytes
    need_cpu = pod_cpu_millis(pod)
    if need_cpu and free_cpu_millis is not None \
            and need_cpu > free_cpu_millis:
        return (f"node {node.metadata.name} lacks cpu "
                f"({need_cpu}m requested, {free_cpu_millis}m free)")
    need_mem = pod_memory_bytes(pod)
    if need_mem and free_memory_bytes is not None \
            and need_mem > free_memory_bytes:
        return (f"node {node.metadata.name} lacks memory "
                f"({need_mem} bytes requested, {free_memory_bytes} free)")
    return None


class _NodeState:
    __slots__ = ("name", "domain", "free", "pending", "node",
                 "free_cpu", "free_mem")

    def __init__(self, name: str, domain: str, free: int,
                 pending: bool = False, node: Optional[Node] = None):
        self.name = name
        self.domain = domain
        self.free = free
        # Maintenance-pending: still schedulable (the health controller
        # may not have cordoned it yet, or cordoning is disabled) but
        # announced to degrade — placement prefers clean capacity.
        self.pending = pending
        # The Node object, for the hard placement predicates
        # (taints/nodeSelector); a test double passing none gets a
        # predicate-neutral blank node.
        self.node = node if node is not None else Node(
            metadata=ObjectMeta(name=name))
        # Pass-local cpu/mem accounting (None = node didn't report).
        self.free_cpu = self.node.status.allocatable_cpu_millis
        self.free_mem = self.node.status.allocatable_memory_bytes


class SliceGangBinder:
    """Binds admitted gang pods to nodes (see module docstring).

    ``bind`` is injected for testability and defaults to the kube
    client's pods/binding POST. The binder runs one daemon thread: store
    watch events (pods/slicegroups/nodes) wake it; a resync tick bounds
    staleness when no events arrive."""

    def __init__(self, store: Store, client, gang,
                 namespace: Optional[str] = None,
                 recorder=None, resync_seconds: float = 2.0):
        self.store = store
        self.client = client
        self.gang = gang
        self.namespace = namespace
        self.recorder = recorder
        self.resync_seconds = resync_seconds
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watchers: list = []
        self._nodes_sig: Optional[tuple] = None
        # Groups already flagged unplaceable (event once per episode;
        # cleared when the group binds or goes away).
        self._warned_unplaceable: set = set()
        # (ns, pod) -> consecutive bind failures. Failures used to be
        # invisible beyond a log line: the pod just stayed Pending and
        # "retry next pass" could mask a permanently failing bind
        # (RBAC drift, node gone from the apiserver's view) forever.
        # Now every failure counts in bind_failures_total{reason} and
        # the SAME pod failing repeatedly raises a BindFailing event on
        # its job (once per episode; cleared on success/conflict).
        self._bind_failures: Dict[Tuple[str, str], int] = {}
        self._warned_bind_failing: set = set()

    # Consecutive per-pod failures before the job gets a BindFailing
    # event (one transient blip is business as usual).
    BIND_FAILING_EVENT_THRESHOLD = 3

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "SliceGangBinder":
        for kind in (store_mod.PODS, store_mod.SLICEGROUPS,
                     store_mod.NODES):
            self._watchers.append(
                self.store.watch(kind, self._on_event, replay=False))
        self._thread = threading.Thread(target=self._run,
                                        name="slice-gang-binder",
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
                self.bind_pass()
            except Exception:
                log.exception("bind pass failed; retrying next pass")

    # -- one level-triggered pass ---------------------------------------

    def bind_pass(self) -> int:
        """Re-derive inventory + demand from the cache and bind what the
        admission gate allows. Returns the number of binds issued."""
        # Flight-recorder "binder" phase: each pass is a trace of its
        # own (the binder runs on its own thread, never inside a sync).
        with trace_mod.span("binder.pass") as sp:
            binds = self._bind_pass()
            sp.set(binds=binds)
            return binds

    def _bind_pass(self) -> int:
        nodes = self.store.list(store_mod.NODES)
        sig = tuple(sorted(
            (n.metadata.name, n.spec.chips, node_is_schedulable(n))
            for n in nodes))
        if sig != self._nodes_sig:
            self._nodes_sig = sig
            # Capacity moved: admission may now pass (or must shrink);
            # only job syncs run _admit otherwise.
            self.gang.readmit()

        # Schedulable = not cordoned AND Ready. A dead kubelet's Node
        # object persists with Ready=False; kube-scheduler would skip
        # it via the not-ready taint, and a direct pods/binding POST
        # bypasses that filter — so the binder must apply it itself
        # (and its chips leave the admission budget the same way).
        states: Dict[str, _NodeState] = {}
        domain_of_any: Dict[str, str] = {}
        for n in nodes:
            domain_of_any[n.metadata.name] = node_nvlink_domain(n)
            if not node_is_schedulable(n):
                continue
            states[n.metadata.name] = _NodeState(
                n.metadata.name, domain_of_any[n.metadata.name],
                n.spec.chips, pending=node_maintenance_pending(n),
                node=n)

        # Chip accounting is deliberately UNSCOPED: node capacity is
        # cluster-wide, so occupancy must be too. (A namespace-scoped
        # operator only mirrors its own namespace's pods; it therefore
        # assumes its namespace owns the GPU nodes' capacity — the same
        # assumption its admission budget already makes.)
        pods = self.store.list(store_mod.PODS)
        unbound: Dict[Tuple[str, str], List[Pod]] = {}
        for p in pods:
            terminal = p.status.phase in ("Succeeded", "Failed")
            if p.spec.node_name:
                if not terminal and p.spec.node_name in states:
                    st = states[p.spec.node_name]
                    st.free -= pod_chip_demand(p)
                    if st.free_cpu is not None:
                        st.free_cpu -= pod_cpu_millis(p)
                    if st.free_mem is not None:
                        st.free_mem -= pod_memory_bytes(p)
                continue
            if (self.namespace is not None
                    and p.metadata.namespace != self.namespace):
                continue
            if (terminal
                    or p.spec.scheduler_name
                    != constants.DEFAULT_GANG_SCHEDULER):
                continue
            group = p.metadata.annotations.get(
                constants.ANNOTATION_GANG_GROUP, "")
            if group:
                unbound.setdefault(
                    (p.metadata.namespace, group), []).append(p)

        if not unbound:
            self._warned_unplaceable.clear()
            return 0
        if not states:
            log.debug("no schedulable nodes; %d gang groups waiting",
                      len(unbound))
            return 0

        # Admission order = placement order: priority desc, oldest first.
        def group_sort_key(item):
            (ns, name), _ = item
            sg = self.store.try_get(store_mod.SLICEGROUPS, ns, name)
            pri = self.gang._priority_of(sg) if sg is not None else 0
            created = (sg.metadata.creation_timestamp.timestamp()
                       if sg is not None
                       and sg.metadata.creation_timestamp else 0.0)
            return (-pri, created, name)

        bound = 0
        live_groups = set()
        for (ns, name), group_pods in sorted(unbound.items(),
                                             key=group_sort_key):
            live_groups.add((ns, name))
            sg = self.store.try_get(store_mod.SLICEGROUPS, ns, name)
            if sg is None or sg.status.phase not in ADMITTED_PHASES:
                continue  # the gang gate: unadmitted stays unbound
            bound += self._place_group(ns, name, sg, group_pods, pods,
                                       states, domain_of_any)
        self._warned_unplaceable &= live_groups
        # Failure streaks die with their pods (a deleted-and-recreated
        # pod starts a fresh episode).
        live_pods = {(p.metadata.namespace, p.metadata.name)
                     for group_pods in unbound.values()
                     for p in group_pods}
        for key in [k for k in self._bind_failures if k not in live_pods]:
            del self._bind_failures[key]
        self._warned_bind_failing &= live_pods
        return bound

    def _place_group(self, ns: str, name: str, sg: SliceGroup,
                     group_pods: List[Pod], all_pods: List[Pod],
                     states: Dict[str, _NodeState],
                     domain_of_any: Dict[str, str]) -> int:
        """Place one admitted group's unbound pods: workers slice-atomic
        into one NVLink domain each, coordinator-only pods anywhere.
        A slice's hosts come from the port's ``parse_accelerator``
        (8 GPUs a host for ``h100``)."""
        sl = sg.spec.slice
        hps = 1
        if sl.accelerator:
            topo = parse_accelerator(sl.accelerator, sl.topology,
                                     max(1, sl.num_slices))
            hps = max(1, topo.hosts_per_slice)

        # Spare-capacity preference (HealthPolicy.prefer_spare_capacity,
        # default on even without a policy): place away from
        # maintenance-pending nodes while clean capacity fits, so a gang
        # bound (or REBOUND after a drain) isn't handed straight to the
        # next node scheduled to degrade.
        policy = job_health_policy(
            self.store.try_get(store_mod.TPUJOBS, ns, name))
        prefer_clean = policy is None or policy.prefer_spare_capacity

        # Worker pods place as whole slices in one NVLink domain; every
        # other role — chief/ps/evaluator, serving off-slice, and
        # CPU-only RolePolicy roles like RL actor pools (docs/rl.md) —
        # takes the flexible path: pure cpu/mem/taint predicate fit
        # (_pick_flexible_node), zero GPU demand unless its containers
        # declare nvidia.com/gpu (the controller only stamps GPUs for
        # chipConsuming roles, gpu_controller.set_cluster_spec), so a
        # 100-actor pool never touches the slice budget or topology.
        by_slice: Dict[int, List[Pod]] = {}
        flexible: List[Pod] = []
        for p in group_pods:
            rt = p.metadata.labels.get(constants.LABEL_REPLICA_TYPE, "")
            idx = p.metadata.labels.get(constants.LABEL_REPLICA_INDEX, "")
            if rt == "worker" and idx.isdigit() and sl.accelerator:
                by_slice.setdefault(int(idx) // hps, []).append(p)
            else:
                flexible.append(p)

        # A partially-bound slice (binder restarted mid-bind, or a pod
        # restarted while its peers run) is pinned to the domain its
        # bound members already occupy. Resolved through the FULL node
        # map, not the schedulable one: a cordoned peer node still pins
        # the slice to its domain (placing the straggler elsewhere
        # would split the slice across NVLink domains).
        pinned: Dict[int, str] = {}
        for p in all_pods:
            if (p.metadata.namespace != ns or not p.spec.node_name
                    or p.status.phase in ("Succeeded", "Failed")):
                continue
            if p.metadata.labels.get(constants.LABEL_JOB_NAME) != name:
                continue
            rt = p.metadata.labels.get(constants.LABEL_REPLICA_TYPE, "")
            idx = p.metadata.labels.get(constants.LABEL_REPLICA_INDEX, "")
            dom = domain_of_any.get(p.spec.node_name)
            if rt == "worker" and idx.isdigit() and dom is not None:
                pinned[int(idx) // hps] = dom

        bound = 0
        for slice_id in sorted(by_slice):
            if (pinned.get(slice_id) is None
                    and len(by_slice[slice_id]) < hps):
                # No member bound yet and the slice's full pod
                # complement isn't visible (the engine recreates a
                # drained/evicted gang one create at a time, and the
                # binder races those creates): placing the partial set
                # would pin the slice to a domain that may not hold the
                # rest — a drain e2e caught exactly that split. Wait;
                # the missing pods' ADDED events re-wake the pass.
                log.debug("slice %d of gang %s/%s has %d/%d pods "
                          "visible; waiting for the full complement",
                          slice_id, ns, name,
                          len(by_slice[slice_id]), hps)
                continue
            plan = self._plan_slice(by_slice[slice_id], states,
                                    pinned.get(slice_id),
                                    prefer_clean=prefer_clean)
            if plan is None:
                self._warn_unplaceable(ns, name, slice_id,
                                       by_slice[slice_id])
                continue
            committed = []
            for pod, st in plan:
                outcome = self._bind(pod, st)
                if outcome != "failed":
                    # "conflict" also consumes: the winning bind almost
                    # certainly placed this pod on some node whose
                    # MODIFIED event hasn't mirrored yet — stay
                    # conservative within the pass rather than
                    # double-booking chips a 409 just proved contested.
                    self._consume(st, pod)
                if outcome == "bound":
                    committed.append((pod, st))
                    bound += 1
            if committed:
                self._warned_unplaceable.discard((ns, name))
                self._record(ns, name, EVENT_TYPE_NORMAL, "GangBound",
                             f"Bound {len(committed)} pod(s) of slice "
                             f"{slice_id} to NVLink domain "
                             f"{committed[0][1].domain}")
        for pod in flexible:
            st = self._pick_flexible_node(pod, states,
                                          prefer_clean=prefer_clean)
            if st is None:
                self._warn_unplaceable(ns, name, -1, [pod])
                continue
            outcome = self._bind(pod, st)
            if outcome != "failed":
                self._consume(st, pod)
            if outcome == "bound":
                bound += 1
        return bound

    @staticmethod
    def _consume(st: _NodeState, pod: Pod) -> None:
        st.free -= pod_chip_demand(pod)
        if st.free_cpu is not None:
            st.free_cpu -= pod_cpu_millis(pod)
        if st.free_mem is not None:
            st.free_mem -= pod_memory_bytes(pod)

    def _plan_slice(self, pods: List[Pod], states: Dict[str, _NodeState],
                    pinned_domain: Optional[str],
                    prefer_clean: bool = True
                    ) -> Optional[List[Tuple[Pod, _NodeState]]]:
        """All-or-nothing placement of one slice's pods into ONE NVLink
        domain. Best-fit: try the domain with the least total free that
        still fits (leaves big domains whole for big slices); with
        ``prefer_clean``, domains containing maintenance-pending nodes
        sort after fully-clean ones regardless of fit (a slice placed
        onto announced-to-degrade capacity is a drain waiting to
        happen). Within a domain, each pod lands on the fullest
        clean-first node that still fits it. Returns the (pod, node)
        plan, or None when no domain fits."""
        demands = sorted(pods, key=pod_chip_demand, reverse=True)
        by_domain: Dict[str, List[_NodeState]] = {}
        for st in states.values():
            by_domain.setdefault(st.domain, []).append(st)

        def domain_key(d):
            tainted = (prefer_clean
                       and any(s.pending for s in by_domain[d]))
            return (tainted, sum(s.free for s in by_domain[d]))

        candidates = ([pinned_domain] if pinned_domain is not None
                      else sorted(by_domain, key=domain_key))
        for domain in candidates:
            nodes = by_domain.get(domain)
            if not nodes:
                continue
            free = {st.name: st.free for st in nodes}
            free_cpu = {st.name: st.free_cpu for st in nodes}
            free_mem = {st.name: st.free_mem for st in nodes}
            plan: List[Tuple[Pod, _NodeState]] = []
            ok = True
            for pod in demands:
                need = pod_chip_demand(pod)
                # Chips first (cheap), then the hard kube predicates:
                # taints/nodeSelector/cpu-mem fit are filters — a node
                # failing one is no candidate regardless of free chips.
                fitting = [
                    st for st in nodes
                    if free[st.name] >= need
                    and node_rejects_pod(pod, st.node,
                                         free_cpu[st.name],
                                         free_mem[st.name]) is None]
                if not fitting:
                    ok = False
                    break
                best = min(fitting,
                           key=lambda st: (prefer_clean and st.pending,
                                           free[st.name]))
                free[best.name] -= need
                if free_cpu[best.name] is not None:
                    free_cpu[best.name] -= pod_cpu_millis(pod)
                if free_mem[best.name] is not None:
                    free_mem[best.name] -= pod_memory_bytes(pod)
                plan.append((pod, best))
            if ok:
                return plan
        return None

    @staticmethod
    def _pick_flexible_node(pod: Pod, states: Dict[str, _NodeState],
                            prefer_clean: bool = True
                            ) -> Optional[_NodeState]:
        need = pod_chip_demand(pod)
        fitting = [st for st in states.values()
                   if st.free >= need
                   and node_rejects_pod(pod, st.node, st.free_cpu,
                                        st.free_mem) is None]
        if not fitting:
            return None
        # Most-free node, clean (no maintenance notice) first: keeps
        # coordinator pods off nearly-full GPU hosts a later slice may
        # need whole, and off nodes announced to degrade.
        return max(fitting,
                   key=lambda st: (not (prefer_clean and st.pending),
                                   st.free))

    def _bind(self, pod: Pod, st: _NodeState) -> str:
        """-> "bound" | "conflict" (another binder won: settled) |
        "failed" (transport/server error: retry next pass)."""
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        ns, name = pod.metadata.namespace, pod.metadata.name
        key = (ns, name)
        try:
            # Transient blips retry in place (runtime/retry.py) so one
            # 500 doesn't cost a whole binder pass; what survives the
            # backoff is a real failure, counted and retried next pass.
            retry_mod.with_retries(
                lambda: self.client.bind_pod(ns, name, st.name),
                component="binder.bind")
        except store_mod.ConflictError:
            # Another binder (or an earlier pass whose MODIFIED event
            # hasn't mirrored yet) placed it: settled.
            log.debug("pod %s/%s already bound", ns, name)
            self._bind_failures.pop(key, None)
            self._warned_bind_failing.discard(key)
            return "conflict"
        except store_mod.NotFoundError:
            metrics.bind_failures.inc(reason="vanished")
            self._bind_failures.pop(key, None)
            return "failed"  # deleted under us; nothing to place
        except Exception as e:
            metrics.bind_failures.inc(reason="error")
            failures = self._bind_failures.get(key, 0) + 1
            self._bind_failures[key] = failures
            log.warning("binding pod %s/%s to %s failed (%d in a row, "
                        "will retry): %s", ns, name, st.name, failures, e)
            if (failures >= self.BIND_FAILING_EVENT_THRESHOLD
                    and key not in self._warned_bind_failing):
                self._warned_bind_failing.add(key)
                group = pod.metadata.annotations.get(
                    constants.ANNOTATION_GANG_GROUP, name)
                self._record(ns, group, EVENT_TYPE_WARNING, "BindFailing",
                             f"Binding pod {name} has failed "
                             f"{failures} consecutive passes "
                             f"(latest: {e}); it will stay Pending "
                             "until the bind succeeds")
            return "failed"
        metrics.gang_pods_bound.inc(job_namespace=ns)
        self._bind_failures.pop(key, None)
        self._warned_bind_failing.discard(key)
        log.info("bound pod %s/%s -> node %s (nvlink-domain %s)",
                 ns, name, st.name, st.domain)
        return "bound"

    def _warn_unplaceable(self, ns: str, name: str, slice_id: int,
                          pods: List[Pod]) -> None:
        key = (ns, name)
        if key in self._warned_unplaceable:
            return
        self._warned_unplaceable.add(key)
        need = sum(pod_chip_demand(p) for p in pods)
        what = (f"slice {slice_id}" if slice_id >= 0
                else f"pod {pods[0].metadata.name}")
        msg = (f"{what} of gang {name} needs {need} chip(s) "
               f"{'in one NVLink domain ' if slice_id >= 0 else ''}"
               "but no schedulable domain currently fits; waiting for "
               "capacity")
        log.warning("%s/%s: %s", ns, name, msg)
        self._record(ns, name, EVENT_TYPE_WARNING, "GangBindUnsatisfiable",
                     msg)

    def _record(self, ns: str, name: str, etype: str, reason: str,
                msg: str) -> None:
        if self.recorder is None:
            return
        job = self.store.try_get(store_mod.TPUJOBS, ns, name)
        if job is not None:
            self.recorder.event(job, etype, reason, msg)
