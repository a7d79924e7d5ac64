"""In-process fake Kubernetes API server for backend tests (port of
tf_operator_tpu/runtime/kube_fake.py: nodes carry the NVIDIA device
plugin's ``nvidia.com/gpu`` and the NVLink-domain label, binds run the
port's binder predicate, and the RBAC enforced is the port's own
``manifests/gpu/rbac.yaml``).

The reference tests its K8s write path with generated fake clientsets
(pkg/client/clientset/versioned/fake/) and its e2e against a live GKE
cluster. Here the seam sits one level lower — a real HTTP server speaking
the small API subset KubeClient uses — so the exact production client,
informer, and controls are exercised byte-for-byte (the kind-cluster
analog, hermetic and millisecond-fast):

  POST/GET/DELETE/PATCH  /api/v1/namespaces/{ns}/{pods|services|events}
  GET list (+labelSelector) on namespaced and cluster scope
  GET ?watch=1 JSON-lines stream (blank-line keepalives)
  /apis/tpu-operator.dev/v1/.../tpujobs (+ /status subresource patch)
  PATCH is application/merge-patch+json (RFC 7386)

RBAC is ENFORCED: the fake loads ``manifests/gpu/rbac.yaml`` (the
ClusterRole the operator actually deploys with) and answers any request
outside the granted verbs with 403 Forbidden, exactly like a real
apiserver running the operator under its ServiceAccount — so a
manifest/RBAC drift (a new write path without a new verb) fails the
hermetic e2e suite instead of surfacing on a real cluster. Pass
``rbac_path=None`` to run permissive, or point it at an alternate
manifest to test tightened roles.

The fake also plays kubelet: ``set_pod_phase`` fabricates the
containerStatuses a node would report, which is how tests drive the
lifecycle (the reference e2e does this through its Flask test-server's
/exit endpoint; test/test-server/test_app.py:17-60).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import queue as _q
import threading
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from tf_operator_tpu_torch.api import constants

log = logging.getLogger("tpu_operator.kube_fake")

_KEEPALIVE_SECONDS = 2.0

RESOURCES = ("pods", "services", "events", "leases",
             "poddisruptionbudgets", "nodes", constants.PLURAL)

# Cluster-scoped resources live under the "" namespace key.
_CLUSTER_SCOPED = ("nodes",)

# API group per served resource (RBAC rule lookup key).
_RESOURCE_GROUPS = {
    "pods": "", "services": "", "events": "", "nodes": "",
    "leases": "coordination.k8s.io",
    "poddisruptionbudgets": "policy",
    "customresourcedefinitions": "apiextensions.k8s.io",
    constants.PLURAL: constants.GROUP,
}

# The checked-in ClusterRole the fake enforces by default.
DEFAULT_RBAC_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "manifests", "gpu", "rbac.yaml")


def load_rbac_rules(path: str) -> Dict[Tuple[str, str], set]:
    """Parse ClusterRole rules out of an RBAC manifest into
    {(apiGroup, resource): {verbs}} — subresources keep their
    ``resource/sub`` names, exactly as K8s RBAC scopes them."""
    import yaml

    rules: Dict[Tuple[str, str], set] = {}
    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if (doc or {}).get("kind") != "ClusterRole":
                continue
            for rule in doc.get("rules") or []:
                verbs = set(rule.get("verbs") or [])
                for g in rule.get("apiGroups") or []:
                    for r in rule.get("resources") or []:
                        rules.setdefault((g, r), set()).update(verbs)
    return rules


def _default_ns(resource: str, ns) -> str:
    if resource in _CLUSTER_SCOPED:
        return ""
    return ns or "default"


def merge_patch(target, patch):
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


def _match_selector(labels: Dict[str, str], raw: str) -> bool:
    if not raw:
        return True
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if labels.get(k.strip()) != v.strip():
            return False
    return True


def _status_body(code: int, reason: str, message: str) -> dict:
    """core/v1 Status error shape real API servers return."""
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "message": message, "reason": reason, "code": code}


class _HttpError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(message)
        self.code = code
        self.reason = reason
        self.message = message


class FakeKubeState:
    """The etcd analog: objects + watch fan-out, shared by all handler
    threads."""

    def __init__(self):
        self.lock = threading.RLock()
        # resource -> {(ns, name) -> dict}
        self.objects: Dict[str, Dict[Tuple[str, str], dict]] = {
            r: {} for r in RESOURCES}
        # RBAC enforcement: {(apiGroup, resource): {verbs}} from the
        # deployed ClusterRole (load_rbac_rules). None = permissive.
        self.rbac_rules: Optional[Dict[Tuple[str, str], set]] = None
        self._rv = 0
        # (resource, queue) watch subscriptions
        self._watchers: List[Tuple[str, "_q.Queue"]] = []
        # (ns, pod) -> log text, the fake kubelet's log store.
        self.pod_logs: Dict[Tuple[str, str], str] = {}
        # --- chaos injection (reflector-hardening tests) ---------------
        # Watches started with resourceVersion < compact_rv get an
        # immediate ERROR 410 ("too old resource version") — the real
        # apiserver's etcd-compaction behavior.
        self.compact_rv = 0
        # Count of watch ERROR events to inject mid-stream: each watch
        # delivery decrements it and sends {"code": watch_error_code}
        # instead of the event (the event itself is NOT delivered — the
        # client must recover it by relist/resume).
        self.inject_watch_errors = 0
        self.watch_error_code = 410
        # Drop the next N watch events silently (network blip analog:
        # the client sees nothing and must reconcile via relist).
        self.drop_events = 0
        # Reorder pairs: hold back the next event and deliver it AFTER
        # the one following it, N times.
        self.reorder_events = 0
        self._held_event: Optional[Tuple[str, dict]] = None
        # Per-resource list-request counter (watch-resume assertions:
        # proves the reflector did NOT relist).
        self.list_counts: Dict[str, int] = {}
        # --- round-5 meanness -----------------------------------------
        # Answer the next N non-watch requests with 429 + Retry-After
        # (apiserver priority-and-fairness throttling analog).
        self.inject_429 = 0
        self.retry_after_seconds = 1
        self.throttled_requests = 0  # how many 429s were served
        # Answer the next N non-watch requests with 500 (apiserver
        # blip / upstream etcd error burst).
        self.inject_5xx = 0
        # Fixed added latency per request (models a loaded production
        # apiserver; tens of ms is realistic).
        self.latency_seconds = 0.0
        # --- seeded FaultProfile (runtime/chaos.py) -------------------
        # The deterministic successor to the one-shot knobs above:
        # per-verb/per-kind error RATES (write/read 5xx, 409 conflicts,
        # timeouts/connection drops, stale reads, watch-stream deaths)
        # drawn from one seeded RNG, so a whole chaos campaign is
        # reproducible from its seed. None = no probabilistic faults;
        # the counter knobs keep working either way (tests compose
        # both). set_fault_profile() installs it.
        self.fault_injector = None
        # (resource, (ns, name)) -> previous stored object, feeding
        # stale reads (a lagging watch-cache / follower-read analog).
        self.object_history: Dict[Tuple[str, Tuple[str, str]], dict] = {}

    def set_fault_profile(self, profile) -> "object":
        """Install a seeded ``chaos.FaultProfile`` (None clears).
        Returns the injector so tests can read its per-fault counts."""
        if profile is None:
            self.fault_injector = None
            return None
        from tf_operator_tpu_torch.runtime.chaos import FaultInjector

        self.fault_injector = FaultInjector(profile)
        return self.fault_injector

    def _remember(self, resource: str, key: Tuple[str, str]) -> None:
        """Stash the current version before a mutation (stale-read
        pool). Caller holds the lock."""
        inj = self.fault_injector
        if inj is None or inj.profile.rate("stale_read") <= 0.0:
            return
        cur = self.objects[resource].get(key)
        if cur is not None:
            self.object_history[(resource, key)] = json.loads(
                json.dumps(cur))

    def next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    # -- RBAC --------------------------------------------------------------

    def authorize(self, resource: str, verb: str,
                  subresource: str = "") -> None:
        """403 unless the loaded ClusterRole grants ``verb`` on the
        resource (subresources are their own RBAC names, e.g.
        ``pods/binding``). No rules loaded = permissive (unit tests
        driving the state directly, or rbac_path=None)."""
        rules = self.rbac_rules
        if rules is None:
            return
        group = _RESOURCE_GROUPS.get(resource, "")
        name = f"{resource}/{subresource}" if subresource else resource
        for key in ((group, name), ("*", name), (group, "*"), ("*", "*")):
            verbs = rules.get(key)
            if verbs and ("*" in verbs or verb in verbs):
                return
        raise _HttpError(
            403, "Forbidden",
            f'operator cannot {verb} resource "{name}" in API group '
            f'"{group}": not granted by the deployed ClusterRole '
            "(manifests/gpu/rbac.yaml) — add the verb there if the "
            "operator legitimately needs it")

    # -- CRUD (all under lock) --------------------------------------------

    def create(self, resource: str, ns: str, obj: dict) -> dict:
        with self.lock:
            name = (obj.get("metadata") or {}).get("name", "")
            if not name:
                raise _HttpError(400, "Invalid", "metadata.name required")
            key = (ns, name)
            if key in self.objects[resource]:
                raise _HttpError(409, "AlreadyExists",
                                 f"{resource} {ns}/{name} already exists")
            obj = json.loads(json.dumps(obj))  # detach
            meta = obj.setdefault("metadata", {})
            meta["namespace"] = ns
            meta.setdefault("uid", str(uuid.uuid4()))
            meta["resourceVersion"] = self.next_rv()
            meta.setdefault("creationTimestamp",
                            _dt.datetime.now(_dt.timezone.utc)
                            .strftime("%Y-%m-%dT%H:%M:%SZ"))
            if resource == "pods":
                obj.setdefault("status", {"phase": "Pending"})
            self.objects[resource][key] = obj
            self._notify(resource, "ADDED", obj)
            return json.loads(json.dumps(obj))

    def get(self, resource: str, ns: str, name: str) -> dict:
        with self.lock:
            obj = self.objects[resource].get((ns, name))
            if obj is None:
                raise _HttpError(404, "NotFound",
                                 f"{resource} {ns}/{name} not found")
            inj = self.fault_injector
            if inj is not None and inj.decide("stale_read", "get",
                                              resource):
                stale = self.object_history.get((resource, (ns, name)))
                if stale is not None:
                    return json.loads(json.dumps(stale))
            return json.loads(json.dumps(obj))

    def delete(self, resource: str, ns: str, name: str) -> dict:
        with self.lock:
            obj = self.objects[resource].pop((ns, name), None)
            if obj is None:
                raise _HttpError(404, "NotFound",
                                 f"{resource} {ns}/{name} not found")
            self._notify(resource, "DELETED", obj)
            return _status_body(200, "Deleted", f"{name} deleted") | {
                "status": "Success"}

    def patch(self, resource: str, ns: str, name: str, patch: dict,
              subresource: str = "") -> dict:
        with self.lock:
            cur = self.objects[resource].get((ns, name))
            if cur is None:
                raise _HttpError(404, "NotFound",
                                 f"{resource} {ns}/{name} not found")
            # resourceVersion in a patch is an optimistic-concurrency
            # precondition (real apiserver semantics).
            want_rv = (patch.get("metadata") or {}).get("resourceVersion")
            cur_rv = (cur.get("metadata") or {}).get("resourceVersion", "")
            if want_rv and want_rv != cur_rv:
                raise _HttpError(409, "Conflict",
                                 f"resourceVersion {want_rv} != {cur_rv}")
            if subresource == "status":
                # Status subresource: only .status merges.
                patch = {"status": patch.get("status")}
            self._remember(resource, (ns, name))
            merged = merge_patch(cur, patch)
            meta = merged.setdefault("metadata", {})
            meta["name"], meta["namespace"] = name, ns
            meta["uid"] = (cur.get("metadata") or {}).get("uid", "")
            meta["resourceVersion"] = self.next_rv()
            self.objects[resource][(ns, name)] = merged
            self._notify(resource, "MODIFIED", merged)
            return json.loads(json.dumps(merged))

    def replace(self, resource: str, ns: str, name: str, obj: dict) -> dict:
        """PUT with optimistic concurrency: a stale resourceVersion loses
        the race (the CAS leader election depends on)."""
        with self.lock:
            cur = self.objects[resource].get((ns, name))
            if cur is None:
                raise _HttpError(404, "NotFound",
                                 f"{resource} {ns}/{name} not found")
            rv = (obj.get("metadata") or {}).get("resourceVersion", "")
            cur_rv = (cur.get("metadata") or {}).get("resourceVersion", "")
            if rv and rv != cur_rv:
                raise _HttpError(409, "Conflict",
                                 f"resourceVersion {rv} != {cur_rv}")
            self._remember(resource, (ns, name))
            obj = json.loads(json.dumps(obj))
            meta = obj.setdefault("metadata", {})
            meta["name"], meta["namespace"] = name, ns
            meta["uid"] = (cur.get("metadata") or {}).get("uid", "")
            meta["creationTimestamp"] = (cur.get("metadata") or {}).get(
                "creationTimestamp", "")
            meta["resourceVersion"] = self.next_rv()
            self.objects[resource][(ns, name)] = obj
            self._notify(resource, "MODIFIED", obj)
            return json.loads(json.dumps(obj))

    def list(self, resource: str, ns: Optional[str],
             selector: str, field_selector: str = "") -> dict:
        with self.lock:
            items = []
            for (ons, _), obj in self.objects[resource].items():
                if ns is not None and ons != ns:
                    continue
                labels = (obj.get("metadata") or {}).get("labels") or {}
                if not _match_selector(labels, selector):
                    continue
                if field_selector and not self._match_fields(obj,
                                                             field_selector):
                    continue
                items.append(json.loads(json.dumps(obj)))
            return {"kind": "List", "apiVersion": "v1",
                    "metadata": {"resourceVersion": str(self._rv)},
                    "items": items}

    @staticmethod
    def _match_fields(obj: dict, raw: str) -> bool:
        """The fieldSelector subset real clients use on Events:
        dotted-path equality (e.g. involvedObject.name=job)."""
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            path, _, want = part.partition("=")
            node = obj
            for seg in path.split("."):
                node = node.get(seg, {}) if isinstance(node, dict) else {}
            if (node if isinstance(node, str) else "") != want:
                return False
        return True

    # -- watch -------------------------------------------------------------

    def subscribe(self, resource: str) -> "_q.Queue":
        q: "_q.Queue" = _q.Queue()
        with self.lock:
            self._watchers.append((resource, q))
        return q

    def unsubscribe(self, q: "_q.Queue") -> None:
        with self.lock:
            self._watchers = [(r, w) for r, w in self._watchers if w is not q]

    def _notify(self, resource: str, etype: str, obj: dict) -> None:
        payload = json.loads(json.dumps(obj))
        for r, q in self._watchers:
            if r == resource:
                q.put((etype, payload))

    # -- fake kubelet ------------------------------------------------------

    def set_pod_log(self, ns: str, name: str, text: str) -> None:
        """Fake kubelet log store (served by GET .../pods/{name}/log)."""
        with self.lock:
            self.pod_logs[(ns, name)] = text

    def append_pod_log(self, ns: str, name: str, text: str) -> None:
        with self.lock:
            self.pod_logs[(ns, name)] = self.pod_logs.get((ns, name),
                                                          "") + text

    def set_pod_phase(self, ns: str, name: str, phase: str,
                      exit_code: Optional[int] = None,
                      restart_count: int = 0) -> None:
        """Fabricate the node's status report for a pod."""
        with self.lock:
            pod = self.objects["pods"].get((ns, name))
            if pod is None:
                raise _HttpError(404, "NotFound", f"pod {ns}/{name} not found")
            containers = (pod.get("spec") or {}).get("containers") or []
            statuses = []
            for c in containers:
                if phase in ("Succeeded", "Failed"):
                    code = exit_code if exit_code is not None else (
                        0 if phase == "Succeeded" else 1)
                    state = {"terminated": {"exitCode": code}}
                elif phase == "Running":
                    state = {"running": {}}
                else:
                    state = {"waiting": {"reason": "ContainerCreating"}}
                statuses.append({"name": c.get("name", ""), "state": state,
                                 "restartCount": restart_count})
            self.patch("pods", ns, name,
                       {"status": {"phase": phase, "hostIP": "10.0.0.1",
                                   "containerStatuses": statuses}},
                       subresource="status")

    def add_node(self, name: str, chips: int = 8, nvlink_domain: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 unschedulable: bool = False, ready: bool = True,
                 taints: Optional[list] = None,
                 cpu: Optional[str] = None,
                 memory: Optional[str] = None) -> dict:
        """Register a core/v1 Node the way a kubelet + NVIDIA device plugin
        would: allocatable nvidia.com/gpu GPUs plus the NVLink-domain
        label the gang binder keys slice affinity on. A heartbeating
        kubelet reports a Ready condition (``ready=False`` models a dead
        kubelet; a node with NO Ready condition at all — kubelet never
        heartbeated — is built by passing ``ready=None``). ``taints``
        is a list of core/v1 taint dicts ({key, value, effect});
        ``cpu``/``memory`` are allocatable quantity strings ("4",
        "500m", "16Gi") — binds violating any of these are rejected the
        way kubelet/kube-scheduler would reject them (422)."""
        node_labels = dict(labels or {})
        if nvlink_domain:
            node_labels[constants.LABEL_NVLINK_DOMAIN] = nvlink_domain
        allocatable: dict = {constants.RESOURCE_GPU: str(chips)}
        if cpu is not None:
            allocatable["cpu"] = str(cpu)
        if memory is not None:
            allocatable["memory"] = str(memory)
        status: dict = {"allocatable": allocatable,
                        "addresses": [{"type": "InternalIP",
                                       "address": "10.0.0.1"}]}
        if ready is not None:
            status["conditions"] = [{"type": "Ready",
                                     "status": "True" if ready else "False"}]
        spec: dict = {"unschedulable": unschedulable}
        if taints:
            spec["taints"] = [dict(t) for t in taints]
        obj = {"apiVersion": "v1", "kind": "Node",
               "metadata": {"name": name, "labels": node_labels},
               "spec": spec,
               "status": status}
        return self.create("nodes", "", obj)

    def cordon_node(self, name: str, unschedulable: bool = True) -> dict:
        return self.patch("nodes", "", name,
                          {"spec": {"unschedulable": unschedulable}})

    def set_node_condition(self, name: str, ctype: str,
                           status: str = "True",
                           reason: str = "") -> dict:
        """Upsert one node condition the way a kubelet / node-problem-
        detector status write would (merge patch replaces the whole
        conditions list, so read-modify-write under the lock)."""
        with self.lock:
            node = self.objects["nodes"].get(("", name))
            if node is None:
                raise _HttpError(404, "NotFound", f"node {name} not found")
            conditions = list((node.get("status") or {})
                              .get("conditions") or [])
            conditions = [c for c in conditions if c.get("type") != ctype]
            cond = {"type": ctype, "status": status}
            if reason:
                cond["reason"] = reason
            conditions.append(cond)
            return self.patch("nodes", "", name,
                              {"status": {"conditions": conditions}},
                              subresource="status")

    def inject_maintenance(self, name: str,
                           reason: str = "ScheduledMaintenance") -> dict:
        """Maintenance notice: the node is still Ready and serving,
        but the platform has announced an upcoming disruption (GKE
        surfaces these ahead of host maintenance events). The slice-health
        controller cordons and drains off it."""
        return self.set_node_condition(name, "MaintenancePending",
                                       "True", reason=reason)

    def inject_preemption(self, name: str,
                          reason: str = "SpotPreemption") -> dict:
        """Spot/preemptible termination notice (the ~30s ACPI warning
        surfaced as a condition): the node is about to vanish."""
        return self.set_node_condition(name, "TerminationScheduled",
                                       "True", reason=reason)

    def bind_pod(self, ns: str, name: str, node: str) -> dict:
        """Bindings-API core: assign the pod to a node exactly once (a
        real apiserver 409s a second bind — two schedulers racing must
        not silently reassign a placed pod). Binds kubelet or the taint
        manager would reject — untolerated NoSchedule/NoExecute taints,
        unmatched nodeSelector, cpu/mem requests over what's left of the
        node's allocatable — are refused with 422, so a binder that
        skips its own hard filters fails loudly in tier-1 instead of
        placing pods a real cluster would evict."""
        with self.lock:
            pod = self.objects["pods"].get((ns, name))
            if pod is None:
                raise _HttpError(404, "NotFound", f"pod {ns}/{name} not found")
            current = (pod.get("spec") or {}).get("nodeName", "")
            if current:
                raise _HttpError(
                    409, "Conflict",
                    f"pod {ns}/{name} is already assigned to node {current}")
            node_obj = self.objects["nodes"].get(("", node))
            if node_obj is not None:
                reason = self._bind_rejection(pod, node_obj, node)
                if reason:
                    raise _HttpError(
                        422, "Invalid",
                        f"pod {ns}/{name} cannot bind: {reason}")
            self.patch("pods", ns, name, {"spec": {"nodeName": node}})
        return _status_body(201, "Created", f"{name} bound to {node}") | {
            "status": "Success"}

    def _bind_rejection(self, pod_raw: dict, node_raw: dict,
                        node_name: str) -> Optional[str]:
        """Run the binder's own hard predicate over the k8s-shaped
        objects (converted through the production parsers — the fake
        validates the SAME contract the operator filters on, so the two
        cannot drift). Caller holds the lock."""
        from tf_operator_tpu_torch.controller import binder as binder_mod
        from tf_operator_tpu_torch.runtime.kube import node_from_k8s, pod_from_k8s

        pod = pod_from_k8s(pod_raw)
        node = node_from_k8s(node_raw)
        free_cpu = node.status.allocatable_cpu_millis
        free_mem = node.status.allocatable_memory_bytes
        if free_cpu is not None or free_mem is not None:
            for (_, _), other in self.objects["pods"].items():
                spec = other.get("spec") or {}
                if spec.get("nodeName") != node_name:
                    continue
                if ((other.get("status") or {}).get("phase", "")
                        in ("Succeeded", "Failed")):
                    continue
                op = pod_from_k8s(other)
                if free_cpu is not None:
                    free_cpu -= binder_mod.pod_cpu_millis(op)
                if free_mem is not None:
                    free_mem -= binder_mod.pod_memory_bytes(op)
        return binder_mod.node_rejects_pod(pod, node, free_cpu, free_mem)

    def set_all_pods_phase(self, ns: str, phase: str, *,
                           selector: Optional[Dict[str, str]] = None) -> int:
        raw = ",".join(f"{k}={v}" for k, v in (selector or {}).items())
        with self.lock:
            names = [name for (ons, name), obj in self.objects["pods"].items()
                     if ons == ns and _match_selector(
                         (obj.get("metadata") or {}).get("labels") or {},
                         raw)]
        for name in names:
            self.set_pod_phase(ns, name, phase)
        return len(names)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "fake-kube-apiserver"
    state: FakeKubeState

    def log_message(self, fmt, *args):
        log.debug("%s %s", self.address_string(), fmt % args)

    # -- routing -----------------------------------------------------------

    def _route(self):
        """-> (resource, ns_or_None, name, subresource, query)."""
        parsed = urllib.parse.urlsplit(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = {k: v[0] for k, v in
                 urllib.parse.parse_qs(parsed.query).items()}
        # /api/v1/... (core) or /apis/{group}/{version}/... (CRs)
        if parts[:2] == ["api", "v1"]:
            rest = parts[2:]
        elif (parts[:3] == ["apis", constants.GROUP, constants.VERSION]):
            rest = parts[3:]
        elif parts[:3] == ["apis", "coordination.k8s.io", "v1"]:
            rest = parts[3:]
        elif parts[:3] == ["apis", "policy", "v1"]:
            rest = parts[3:]
        elif (parts[:3] == ["apis", "apiextensions.k8s.io", "v1"]
              and parts[3:4] == ["customresourcedefinitions"]):
            # CRD existence probe: report installed.
            name = parts[4] if len(parts) > 4 else ""
            if name and name != constants.CRD_NAME:
                raise _HttpError(404, "NotFound", f"CRD {name} not found")
            return "_crd_probe", None, name, "", query
        else:
            raise _HttpError(404, "NotFound", f"no route {self.path}")
        ns = None
        if rest[:1] == ["namespaces"] and len(rest) >= 3:
            ns = rest[1]
            rest = rest[2:]
        if not rest:
            raise _HttpError(404, "NotFound", f"no route {self.path}")
        resource, rest = rest[0], rest[1:]
        if resource not in RESOURCES:
            raise _HttpError(404, "NotFound", f"unknown resource {resource}")
        name = rest[0] if rest else ""
        sub = rest[1] if len(rest) > 1 else ""
        return resource, ns, name, sub, query

    # -- plumbing ----------------------------------------------------------

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", "0") or "0")
        raw = self.rfile.read(length) if length else b"{}"
        try:
            return json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise _HttpError(400, "Invalid", f"bad JSON: {e}")

    def _request_verb_kind(self) -> Tuple[str, str]:
        """(verb, resource) of the in-flight request, best-effort, for
        FaultProfile rate lookup (routing proper happens later)."""
        parts = [p for p in
                 urllib.parse.urlsplit(self.path).path.split("/") if p]
        resource = next((p for p in parts if p in RESOURCES), "*")
        if "watch=1" in self.path or "watch=true" in self.path:
            return "watch", resource
        verb = {"GET": "get", "POST": "create", "PATCH": "patch",
                "PUT": "update", "DELETE": "delete"}.get(
                    self.command, "get")
        if verb == "get" and parts and parts[-1] in RESOURCES:
            verb = "list"
        return verb, resource

    def _chaos_gate(self) -> bool:
        """Apply injected latency / 429 / 5xx / FaultProfile faults
        before routing. Returns True when the request was consumed by
        an injected error. Watch requests only pay latency
        (stream-level chaos has its own taps in _serve_watch)."""
        import time as _time

        is_watch = "watch=1" in self.path or "watch=true" in self.path
        verb, kind = self._request_verb_kind()
        with self.state.lock:
            delay = self.state.latency_seconds
            status = None
            if not is_watch:
                if self.state.inject_429 > 0:
                    self.state.inject_429 -= 1
                    self.state.throttled_requests += 1
                    status = 429
                elif self.state.inject_5xx > 0:
                    self.state.inject_5xx -= 1
                    status = 500
            retry_after = self.state.retry_after_seconds
            inj = self.state.fault_injector
        if delay:
            _time.sleep(delay)
        if status is None and inj is not None and not is_watch:
            # Seeded probabilistic faults (runtime/chaos.py). Order is
            # meanest-first: a dropped connection beats a clean error
            # body beats a conflict.
            if inj.decide("timeout", verb, kind):
                # No response at all: the client sees a reset/remote-
                # disconnect and cannot know whether the server applied
                # the write — exactly the ambiguity production retries
                # must survive. (The request was consumed BEFORE
                # routing, so nothing was applied here.)
                self.close_connection = True
                return True
            mutating = verb in ("create", "patch", "update", "delete")
            if mutating and inj.decide("conflict", verb, kind) \
                    and verb in ("patch", "update"):
                self._send_json(409, _status_body(
                    409, "Conflict",
                    "injected conflict: the object has been modified"))
                return True
            fault = "write_error" if mutating else "read_error"
            if inj.decide(fault, verb, kind):
                self._send_json(500, _status_body(
                    500, "InternalError", "injected server error"))
                return True
        if status == 429:
            body = json.dumps(_status_body(
                429, "TooManyRequests", "throttled (injected)")).encode()
            self.send_response(429)
            self.send_header("Retry-After", str(retry_after))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return True
        if status == 500:
            self._send_json(500, _status_body(
                500, "InternalError", "injected server error"))
            return True
        return False

    def _guard(self, fn):
        try:
            if self._chaos_gate():
                return
            fn()
        except _HttpError as e:
            try:
                self._send_json(e.code, _status_body(e.code, e.reason,
                                                     e.message))
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass

    # -- verbs -------------------------------------------------------------

    def do_GET(self):
        def run():
            resource, ns, name, sub, query = self._route()
            if resource == "_crd_probe":
                self.state.authorize("customresourcedefinitions", "get")
                return self._send_json(200, {
                    "kind": "CustomResourceDefinition",
                    "metadata": {"name": constants.CRD_NAME}})
            if resource == "pods" and name and sub == "log":
                self.state.authorize("pods", "get", subresource="log")
                return self._serve_pod_log(ns or "default", name, query)
            if name:
                self.state.authorize(resource, "get")
                return self._send_json(200, self.state.get(
                    resource, _default_ns(resource, ns), name))
            if query.get("watch") in ("1", "true"):
                self.state.authorize(resource, "watch")
                return self._serve_watch(resource, ns, query)
            self.state.authorize(resource, "list")
            with self.state.lock:
                self.state.list_counts[resource] = \
                    self.state.list_counts.get(resource, 0) + 1
            return self._send_json(200, self.state.list(
                resource, ns, query.get("labelSelector", ""),
                field_selector=query.get("fieldSelector", "")))
        self._guard(run)

    def do_POST(self):
        def run():
            resource, ns, name, sub, _q2 = self._route()
            if resource == "pods" and name and sub == "binding":
                self.state.authorize("pods", "create",
                                     subresource="binding")
                body = self._read_body()
                target = (body.get("target") or {}).get("name", "")
                if not target:
                    raise _HttpError(400, "Invalid", "binding target required")
                return self._send_json(201, self.state.bind_pod(
                    ns or "default", name, target))
            if name:
                raise _HttpError(405, "MethodNotAllowed", "POST to item")
            self.state.authorize(resource, "create")
            self._send_json(201, self.state.create(
                resource, _default_ns(resource, ns), self._read_body()))
        self._guard(run)

    def do_DELETE(self):
        def run():
            resource, ns, name, _, _q2 = self._route()
            if not name:
                raise _HttpError(405, "MethodNotAllowed", "DELETE collection")
            self.state.authorize(resource, "delete")
            self._send_json(200, self.state.delete(
                resource, _default_ns(resource, ns), name))
        self._guard(run)

    def do_PUT(self):
        def run():
            resource, ns, name, _, _q2 = self._route()
            if not name:
                raise _HttpError(405, "MethodNotAllowed", "PUT collection")
            self.state.authorize(resource, "update")
            self._send_json(200, self.state.replace(
                resource, _default_ns(resource, ns), name,
                self._read_body()))
        self._guard(run)

    def do_PATCH(self):
        def run():
            resource, ns, name, sub, _q2 = self._route()
            if not name:
                raise _HttpError(405, "MethodNotAllowed", "PATCH collection")
            # Subresources are distinct RBAC names (tpujobs/status); the
            # status writes of core resources (pods, nodes) are the fake
            # kubelet's own — they arrive through the state helpers, not
            # HTTP, so the role stays exactly what the OPERATOR needs.
            self.state.authorize(resource, "patch",
                                 subresource=sub)
            ctype = self.headers.get("Content-Type", "")
            if "merge-patch" not in ctype and "strategic" not in ctype:
                raise _HttpError(415, "UnsupportedMediaType",
                                 f"unsupported patch type {ctype}")
            self._send_json(200, self.state.patch(
                resource, _default_ns(resource, ns), name,
                self._read_body(), subresource=sub))
        self._guard(run)

    # -- pod logs (kubelet log API subresource) ----------------------------

    def _serve_pod_log(self, ns: str, name: str, query) -> None:
        import time as _time

        self.state.get("pods", ns, name)  # 404 when the pod is gone
        follow = query.get("follow") in ("1", "true")
        if not follow:
            text = self.state.pod_logs.get((ns, name), "")
            tail = query.get("tailLines")
            if tail is not None:
                n = int(tail)
                lines = text.splitlines()[-n:] if n > 0 else []
                text = "\n".join(lines)
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        # follow: stream appended text until the pod reaches a terminal
        # phase (kubectl logs -f semantics).
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Connection", "close")
        self.end_headers()
        pos = 0
        try:
            while True:
                text = self.state.pod_logs.get((ns, name), "")
                if len(text) > pos:
                    chunk = text[pos:].encode()
                    pos = len(text)
                    self.wfile.write(chunk)
                    self.wfile.flush()
                    continue
                try:
                    pod = self.state.get("pods", ns, name)
                except _HttpError:
                    return
                phase = (pod.get("status") or {}).get("phase", "")
                if phase in ("Succeeded", "Failed"):
                    return
                _time.sleep(0.05)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    # -- watch -------------------------------------------------------------

    def _serve_watch(self, resource: str, ns: Optional[str], query) -> None:
        import time as _time

        selector = query.get("labelSelector", "")
        q = self.state.subscribe(resource)
        # Replay every object newer than the client's resourceVersion as
        # ADDED — the subscribe-after-list race means events landing
        # between the client's list and this subscription would otherwise
        # be lost until a relist that never comes. (A real apiserver
        # serves these from its event history.) rv "0" replays all.
        rv = query.get("resourceVersion", "") or "0"
        try:
            rv_num = int(rv)
        except ValueError:
            rv_num = 0
        # Chaos: history compacted past the client's RV -> immediate
        # 410 ("too old resource version"), the etcd-compaction path a
        # real apiserver takes. The client must relist.
        with self.state.lock:
            compacted = bool(rv_num and rv_num < self.state.compact_rv)
        if compacted:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Connection", "close")
            self.end_headers()
            line = json.dumps({"type": "ERROR", "object": {
                "code": 410, "reason": "Expired",
                "message": "too old resource version"}})
            self.wfile.write(line.encode() + b"\n")
            self.wfile.flush()
            return
        for item in self.state.list(resource, ns, selector)["items"]:
            try:
                item_rv = int((item.get("metadata") or {})
                              .get("resourceVersion", "0"))
            except ValueError:
                item_rv = 0
            if item_rv > rv_num or rv_num == 0:
                q.put(("ADDED", item))
        # Honor timeoutSeconds: real watches expire and clients relist,
        # which is also the fake's backstop for window-lost deletions.
        try:
            deadline = _time.monotonic() + float(
                query.get("timeoutSeconds", "300"))
        except ValueError:
            deadline = _time.monotonic() + 300.0
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        held: Optional[tuple] = None  # chaos: event delayed for reorder
        try:
            while _time.monotonic() < deadline:
                try:
                    etype, obj = q.get(timeout=_KEEPALIVE_SECONDS)
                except _q.Empty:
                    self.wfile.write(b"\n")
                    self.wfile.flush()
                    continue
                meta = obj.get("metadata") or {}
                if ns is not None and meta.get("namespace") != ns:
                    continue
                if not _match_selector(meta.get("labels") or {}, selector):
                    continue
                # Chaos taps (see FakeKubeState.__init__): each applies
                # to events that WOULD be delivered, so tests control
                # exactly which update is lost/errored/reordered.
                with self.state.lock:
                    if self.state.drop_events > 0:
                        self.state.drop_events -= 1
                        continue  # silently lost on the wire
                    if self.state.inject_watch_errors > 0:
                        self.state.inject_watch_errors -= 1
                        code = self.state.watch_error_code
                        line = json.dumps({"type": "ERROR", "object": {
                            "code": code, "reason": "Chaos",
                            "message": "injected watch error"}})
                        self.wfile.write(line.encode() + b"\n")
                        self.wfile.flush()
                        return  # stream dies with the error
                    if self.state.reorder_events > 0 and held is None:
                        self.state.reorder_events -= 1
                        held = (etype, obj)
                        continue  # delivered after the NEXT event
                    inj = self.state.fault_injector
                if inj is not None and inj.decide("watch_drop", "watch",
                                                  resource):
                    # Stream dies BEFORE this event is delivered (the
                    # connection-drop analog): the client must
                    # reconnect, and RV-resume replays everything from
                    # its last delivered event — losing nothing iff the
                    # reflector resumes correctly, which is the
                    # property under test.
                    return
                line = json.dumps({"type": etype, "object": obj})
                self.wfile.write(line.encode() + b"\n")
                if held is not None:
                    late = json.dumps({"type": held[0], "object": held[1]})
                    self.wfile.write(late.encode() + b"\n")
                    held = None
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self.state.unsubscribe(q)


class FakeKubeApiServer:
    """Serve a FakeKubeState over HTTP on a background thread.

    ``rbac_path`` (default: the checked-in operator ClusterRole) is
    loaded into the state's verb table and enforced on every HTTP
    request; ``rbac_path=None`` serves permissively."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 rbac_path: Optional[str] = DEFAULT_RBAC_PATH):
        self.state = FakeKubeState()
        if rbac_path is not None and os.path.exists(rbac_path):
            try:
                self.state.rbac_rules = load_rbac_rules(rbac_path)
            except Exception:
                log.warning("failed to load RBAC rules from %s; "
                            "serving permissively", rbac_path,
                            exc_info=True)
        handler = type("BoundHandler", (_Handler,), {"state": self.state})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FakeKubeApiServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fake-kube", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "FakeKubeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
