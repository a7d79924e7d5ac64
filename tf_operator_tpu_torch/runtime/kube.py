"""Kubernetes cluster backend: the operator against a real API server
(port of tf_operator_tpu/runtime/kube.py over ``GPUJobController``: nodes
count their allocatable ``nvidia.com/gpu`` and name their NVLink domain).

Reference parity:

- config resolution + clientsets: cmd/tf-operator.v1/app/server.go:72-229
  (kubeconfig / in-cluster, five clientsets) — here one stdlib REST client.
- RealPodControl / RealServiceControl: vendor/.../control/pod_control.go:66+,
  service_control.go (create/delete with controller ownerRefs + events).
- Informer list+watch feeding the controller's cache: the generated
  informer factory (pkg/client/informers/) + unstructured TFJob informer
  (pkg/controller.v1/tensorflow/informer.go:33-53).
- Adoption ownership patch: controller_ref_manager.go:208-221.
- Status writes via the CRD status subresource: tensorflow/status.go:222-240.

Design: the reconcile engine is unchanged. The in-process ``Store`` plays
the informer-cache role: ``KubeInformer`` threads list+watch TPUJob CRs,
Pods, and Services from the cluster and mirror them into the Store (which
fires the controller's existing watch handlers, driving expectations and
the workqueue exactly as in the local runtime). The write path —
``KubePodControl``/``KubeEndpointControl``, status patches, adoption
patches — goes to the API server, and the resulting watch events close
the loop: API write -> watch -> cache -> expectation observed.

Everything here is stdlib (urllib + ssl + json; yaml only to parse
kubeconfig): the runtime image carries no kubernetes client package, and
the API subset the engine needs is small and stable.
"""

from __future__ import annotations

import atexit
import base64
import dataclasses
import json
import logging
import os
import random
import socket
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, Optional, Tuple

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.serde import parse_time
from tf_operator_tpu_torch.api.types import (
    Container,
    ContainerStatus,
    Endpoint,
    EndpointSpec,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodSpec,
    PodStatus,
    Taint,
    Toleration,
    TPUJob,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    Recorder,
)
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.kube")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Client-only resource kind (not mirrored in the Store): PDBs exist to
# inform the CLUSTER's eviction machinery, nothing reconciles off them.
KIND_PDBS = "poddisruptionbudgets"

# Key-material temp files materialized from inline kubeconfig data;
# removed at exit so credentials never persist in the tempdir.
_TEMP_KEY_FILES: list = []


@atexit.register
def _cleanup_temp_key_files() -> None:
    for path in _TEMP_KEY_FILES:
        try:
            os.unlink(path)
        except OSError:
            pass

# Restart policies core/v1 Pods accept; the engine maps ExitCode -> Never
# before the control sees the pod (reference setRestartPolicy,
# tensorflow/pod.go:319-326), this is the defensive backstop.
_K8S_RESTART_POLICIES = ("Always", "OnFailure", "Never")


class KubeApiError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(f"{reason} ({code}): {message}")
        self.code = code
        self.reason = reason
        self.message = message


# ---------------------------------------------------------------------------
# Config resolution (reference app/server.go:96-111 BuildConfigFromFlags)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KubeConfig:
    server: str = ""
    token: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    verify: bool = True
    namespace: str = "default"
    # Temp files holding key material materialized from inline
    # kubeconfig *-data fields — deleted by close() and, as a backstop,
    # at interpreter exit (key material must not outlive the process in
    # the tempdir).
    temp_key_files: Tuple[str, ...] = ()

    def close(self) -> None:
        for path in self.temp_key_files:
            try:
                os.unlink(path)
            except OSError:
                pass
        object.__setattr__(self, "temp_key_files", ())

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        """Service-account config inside a pod (reference rest.InClusterConfig
        via BuildConfigFromFlags with empty kubeconfig)."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise KubeApiError(0, "NoCluster",
                               "KUBERNETES_SERVICE_HOST not set")
        with open(os.path.join(SERVICE_ACCOUNT_DIR, "token")) as f:
            token = f.read().strip()
        ns_path = os.path.join(SERVICE_ACCOUNT_DIR, "namespace")
        namespace = "default"
        if os.path.exists(ns_path):
            with open(ns_path) as f:
                namespace = f.read().strip() or "default"
        return cls(server=f"https://{host}:{port}", token=token,
                   ca_file=os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt"),
                   namespace=namespace)

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None) -> "KubeConfig":
        """Parse a kubeconfig file (reference clientcmd loading rules)."""
        import yaml

        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser(
            "~/.kube/config")
        with open(path) as f:
            doc = yaml.safe_load(f) or {}

        def _by_name(section: str, name: str) -> dict:
            for entry in doc.get(section, []) or []:
                if entry.get("name") == name:
                    return entry
            raise KubeApiError(0, "BadKubeconfig",
                               f"{section} entry {name!r} not found in {path}")

        ctx_name = context or doc.get("current-context", "")
        if not ctx_name:
            raise KubeApiError(0, "BadKubeconfig",
                               f"no current-context in {path}")
        ctx = _by_name("contexts", ctx_name).get("context", {})
        cluster = _by_name("clusters", ctx.get("cluster", "")).get("cluster", {})
        user = _by_name("users", ctx.get("user", "")).get("user", {})

        materialized: list = []

        def _materialize(data_key: str, file_key: str, src: dict) -> str:
            """Inline base64 *-data fields become temp files for ssl
            (mkstemp => 0600). Paths are tracked for KubeConfig.close()
            and deleted at interpreter exit as a backstop — key material
            must not be left behind in the tempdir."""
            if src.get(file_key):
                return src[file_key]
            data = src.get(data_key)
            if not data:
                return ""
            fd, tmp = tempfile.mkstemp(prefix="kubecfg-", suffix=".pem")
            with os.fdopen(fd, "wb") as f:
                f.write(base64.b64decode(data))
            materialized.append(tmp)
            _TEMP_KEY_FILES.append(tmp)
            return tmp

        return cls(
            server=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=_materialize("certificate-authority-data",
                                 "certificate-authority", cluster),
            client_cert_file=_materialize("client-certificate-data",
                                          "client-certificate", user),
            client_key_file=_materialize("client-key-data", "client-key",
                                         user),
            verify=not cluster.get("insecure-skip-tls-verify", False),
            namespace=ctx.get("namespace", "default"),
            temp_key_files=tuple(materialized),
        )

    @classmethod
    def resolve(cls, kubeconfig: Optional[str] = None) -> "KubeConfig":
        """In-cluster when running inside a pod, else kubeconfig —
        the reference's loading order (server.go:96-103)."""
        if not kubeconfig and os.environ.get("KUBERNETES_SERVICE_HOST"):
            return cls.in_cluster()
        return cls.from_kubeconfig(kubeconfig)


# ---------------------------------------------------------------------------
# REST client
# ---------------------------------------------------------------------------

def _selector_str(selector: Optional[Dict[str, str]]) -> str:
    if not selector:
        return ""
    return ",".join(f"{k}={v}" for k, v in sorted(selector.items()))


class _TokenBucket:
    """Client-side request rate limiter (reference flags --kube-api-qps 5
    / --kube-api-burst 10, options.go:81-82; client-go's flowcontrol
    token bucket). acquire() blocks until a token is available — a hot
    requeue loop smooths out instead of hammering the API server."""

    def __init__(self, qps: float, burst: int):
        if qps <= 0:
            raise ValueError("qps must be positive")
        self.qps = qps
        self.burst = max(1, burst)
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._last)
                                   * self.qps)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)


# 429 handling: how many Retry-After waits one request will sit out
# before surfacing the error, and the per-wait cap (a malicious/buggy
# Retry-After of hours must not hang a reconcile worker).
_MAX_429_RETRIES = 5
_MAX_RETRY_AFTER_SECONDS = 30.0


class KubeClient:
    """Minimal typed REST client over the K8s API (stdlib only).

    ``qps``/``burst`` enable the client-side token bucket (None =
    unlimited — library default; the operator binary passes the
    reference's 5/10). Server 429s are honored: the client sleeps the
    Retry-After (capped) and retries a few times before surfacing."""

    def __init__(self, config: KubeConfig, timeout: float = 30.0,
                 watch_timeout_seconds: float = 300.0,
                 qps: Optional[float] = None, burst: int = 10):
        self.config = config
        self.timeout = timeout
        # Server-side watch expiry; a stream that outlives it ends
        # normally and the reflector RESUMES from its last RV (tests
        # shorten this to exercise the resume path).
        self.watch_timeout_seconds = watch_timeout_seconds
        self._bucket = _TokenBucket(qps, burst) if qps else None
        self._ssl: Optional[ssl.SSLContext] = None
        if config.server.startswith("https"):
            ctx = ssl.create_default_context(
                cafile=config.ca_file or None)
            if config.client_cert_file:
                ctx.load_cert_chain(config.client_cert_file,
                                    config.client_key_file or None)
            if not config.verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl = ctx

    # -- plumbing ----------------------------------------------------------

    def request(self, method: str, path: str,
                body: Optional[dict] = None,
                params: Optional[Dict[str, str]] = None,
                content_type: str = "application/json",
                timeout: Optional[float] = None,
                stream: bool = False):
        url = self.config.server.rstrip("/") + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v not in ("", None)})
        data = json.dumps(body).encode() if body is not None else None
        for attempt in range(_MAX_429_RETRIES + 1):
            if self._bucket is not None:
                self._bucket.acquire()
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Accept", "application/json")
            if data is not None:
                req.add_header("Content-Type", content_type)
            if self.config.token:
                req.add_header("Authorization",
                               f"Bearer {self.config.token}")
            try:
                resp = urllib.request.urlopen(
                    req,
                    timeout=self.timeout if timeout is None else timeout,
                    context=self._ssl)
            except urllib.error.HTTPError as e:
                raw = e.read()
                try:
                    status = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    status = {}
                reason = status.get("reason", "") or e.reason
                message = status.get("message", "") or raw.decode(
                    "utf-8", "replace")
                if e.code == 429 and attempt < _MAX_429_RETRIES:
                    # Server throttling: honor Retry-After (capped) and
                    # go again — client-go's standard 429 behavior.
                    try:
                        after = float(e.headers.get("Retry-After", "1")
                                      or "1")
                    except ValueError:
                        after = 1.0
                    metrics.kube_client_throttled.inc()
                    time.sleep(min(max(after, 0.0),
                                   _MAX_RETRY_AFTER_SECONDS))
                    continue
                if e.code == 404:
                    raise store_mod.NotFoundError(message)
                if e.code == 409 and reason == "AlreadyExists":
                    raise store_mod.AlreadyExistsError(message)
                if e.code == 409:
                    raise store_mod.ConflictError(message)
                raise KubeApiError(e.code, reason, message)
            if stream:
                return resp
            with resp:
                raw = resp.read()
            return json.loads(raw) if raw else {}

    # -- resource paths ----------------------------------------------------

    @staticmethod
    def _core(resource: str, ns: Optional[str], name: str = "") -> str:
        base = (f"/api/v1/namespaces/{ns}/{resource}" if ns
                else f"/api/v1/{resource}")
        return f"{base}/{name}" if name else base

    @staticmethod
    def _crd(ns: Optional[str], name: str = "") -> str:
        group = f"/apis/{constants.GROUP}/{constants.VERSION}"
        base = (f"{group}/namespaces/{ns}/{constants.PLURAL}" if ns
                else f"{group}/{constants.PLURAL}")
        return f"{base}/{name}" if name else base

    def _path(self, kind: str, ns: Optional[str], name: str = "") -> str:
        if kind == store_mod.TPUJOBS:
            return self._crd(ns, name)
        if kind == KIND_PDBS:
            base = f"/apis/policy/v1/namespaces/{ns}/poddisruptionbudgets"
            return f"{base}/{name}" if name else base
        if kind == store_mod.NODES:
            return self._core("nodes", None, name)  # cluster-scoped
        resource = {store_mod.PODS: "pods",
                    store_mod.ENDPOINTS: "services",
                    store_mod.EVENTS: "events"}.get(kind)
        if resource is None:
            raise KeyError(f"no K8s resource mapping for kind {kind!r}")
        return self._core(resource, ns, name)

    # -- typed verbs -------------------------------------------------------

    def create(self, kind: str, ns: str, body: dict) -> dict:
        return self.request("POST", self._path(kind, ns), body=body)

    def get(self, kind: str, ns: str, name: str) -> dict:
        return self.request("GET", self._path(kind, ns, name))

    def delete(self, kind: str, ns: str, name: str) -> dict:
        return self.request("DELETE", self._path(kind, ns, name))

    def list(self, kind: str, ns: Optional[str] = None,
             selector: Optional[Dict[str, str]] = None,
             field_selector: str = "") -> dict:
        return self.request("GET", self._path(kind, ns),
                            params={"labelSelector": _selector_str(selector),
                                    "fieldSelector": field_selector})

    def patch(self, kind: str, ns: str, name: str, patch: dict,
              subresource: str = "") -> dict:
        path = self._path(kind, ns, name)
        if subresource:
            path += f"/{subresource}"
        return self.request("PATCH", path, body=patch,
                            content_type="application/merge-patch+json")

    def create_event(self, ns: str, body: dict) -> dict:
        return self.request("POST", self._core("events", ns), body=body)

    def bind_pod(self, ns: str, name: str, node: str) -> dict:
        """POST a Binding (the scheduler's pods/binding subresource write
        — what kube-scheduler itself calls to place a pod). A 409 means
        another binder won the race; callers treat it as settled."""
        body = {"apiVersion": "v1", "kind": "Binding",
                "metadata": {"name": name, "namespace": ns},
                "target": {"apiVersion": "v1", "kind": "Node",
                           "name": node}}
        return self.request(
            "POST", f"/api/v1/namespaces/{ns}/pods/{name}/binding",
            body=body)

    def watch(self, kind: str, ns: Optional[str],
              selector: Optional[Dict[str, str]],
              resource_version: str,
              resp_box: Optional[list] = None):
        """Open a watch stream; yields (type, raw_object) tuples until the
        server closes the connection (callers reconnect; reference
        ListWatch + reflector relist semantics). ``resp_box`` receives the
        live response object so the caller can close it to abort a
        blocking read (informer shutdown)."""
        params = {"watch": "1",
                  "labelSelector": _selector_str(selector),
                  "allowWatchBookmarks": "true",
                  "timeoutSeconds": str(int(self.watch_timeout_seconds)),
                  "resourceVersion": resource_version}
        resp = self.request("GET", self._path(kind, ns), params=params,
                            timeout=self.watch_timeout_seconds + 30.0,
                            stream=True)
        if resp_box is not None:
            resp_box.clear()
            resp_box.append(resp)
        try:
            for line in resp:
                line = line.strip()
                if not line:
                    continue  # keepalive (fake apiserver liveness blanks)
                event = json.loads(line)
                yield event.get("type", ""), event.get("object", {})
        finally:
            resp.close()


# ---------------------------------------------------------------------------
# Wire translation: framework dataclasses <-> core/v1 + CRD objects
# ---------------------------------------------------------------------------

def _meta_to_k8s(meta: ObjectMeta) -> dict:
    out: dict = {"name": meta.name, "namespace": meta.namespace}
    if meta.labels:
        out["labels"] = dict(meta.labels)
    if meta.annotations:
        out["annotations"] = dict(meta.annotations)
    if meta.owner_references:
        out["ownerReferences"] = [r.to_dict() for r in meta.owner_references]
    return out


def _meta_from_k8s(d: dict) -> ObjectMeta:
    # resourceVersion is contractually an OPAQUE string (K8s API
    # conventions): preserved verbatim — int coercion would silently
    # collapse non-numeric RVs to 0 and defeat every CAS that compares
    # them. The local Store issues its own int RVs; equality checks are
    # the only comparison either kind ever participates in.
    rv = str(d.get("resourceVersion", "") or "") or 0
    return ObjectMeta(
        name=d.get("name", ""),
        namespace=d.get("namespace", "default"),
        uid=d.get("uid", ""),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
        creation_timestamp=parse_time(d.get("creationTimestamp")),
        deletion_timestamp=parse_time(d.get("deletionTimestamp")),
        resource_version=rv,
        owner_references=[OwnerReference.from_dict(r)
                          for r in d.get("ownerReferences") or []],
    )


def k8s_resource_version(d: dict) -> str:
    return str((d.get("metadata") or {}).get("resourceVersion", "") or "")


RELAY_VOLUME_NAME = "tpu-operator-relay"


def pod_to_k8s(pod: Pod) -> dict:
    containers = []
    for c in pod.spec.containers:
        kc: dict = {"name": c.name}
        if c.image:
            kc["image"] = c.image
        if c.command:
            kc["command"] = list(c.command)
        if c.args:
            kc["args"] = list(c.args)
        if c.working_dir:
            kc["workingDir"] = c.working_dir
        if c.env:
            kc["env"] = [{"name": k, "value": str(v)}
                         for k, v in sorted(c.env.items())]
        if c.ports:
            kc["ports"] = [{"name": n, "containerPort": int(p)}
                           for n, p in sorted(c.ports.items())]
        if c.resources:
            # Flat resource map -> limits (covers nvidia.com/gpu chip
            # requests; K8s defaults requests from limits).
            kc["resources"] = {"limits": dict(c.resources)}
        if pod.spec.relay_dir:
            # The node-agent relay volume, mounted at the SAME path the
            # agent sees on the host so the TPUJOB_*_FILE env renders
            # one path valid in both mount namespaces.
            kc["volumeMounts"] = [{"name": RELAY_VOLUME_NAME,
                                   "mountPath": pod.spec.relay_dir}]
        containers.append(kc)
    restart = pod.spec.restart_policy
    if restart not in _K8S_RESTART_POLICIES:
        restart = "Never"
    spec: dict = {"containers": containers, "restartPolicy": restart}
    if pod.spec.relay_dir:
        spec["volumes"] = [{"name": RELAY_VOLUME_NAME,
                            "hostPath": {"path": pod.spec.relay_dir,
                                         "type": "DirectoryOrCreate"}}]
    if pod.spec.scheduler_name:
        spec["schedulerName"] = pod.spec.scheduler_name
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.tolerations:
        # Tolerations ride to the cluster verbatim — the nvidia.com/gpu
        # one stamped on gang workers (gpu_controller.set_cluster_spec)
        # is what keeps GKE's GPU-node-pool taint manager off bound pods.
        spec["tolerations"] = [
            {k: v for k, v in (
                ("key", t.key), ("operator", t.operator),
                ("value", t.value), ("effect", t.effect),
                ("tolerationSeconds", t.toleration_seconds)) if v}
            for t in pod.spec.tolerations]
    if pod.spec.node_name:
        spec["nodeName"] = pod.spec.node_name
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": _meta_to_k8s(pod.metadata), "spec": spec}


def _container_from_k8s(kc: dict) -> Container:
    env = {e["name"]: e.get("value", "")
           for e in kc.get("env") or [] if "name" in e}
    ports = {p.get("name", f"port-{p.get('containerPort')}"):
             int(p.get("containerPort", 0)) for p in kc.get("ports") or []}
    resources = dict((kc.get("resources") or {}).get("limits") or {})
    return Container(name=kc.get("name", ""), image=kc.get("image", ""),
                     command=list(kc.get("command") or []),
                     args=list(kc.get("args") or []),
                     env=env, ports=ports,
                     resources={k: str(v) for k, v in resources.items()},
                     working_dir=kc.get("workingDir", ""))


def _container_status_from_k8s(cs: dict) -> ContainerStatus:
    state = cs.get("state") or {}
    mapped, exit_code, message = "", None, ""
    if "terminated" in state:
        mapped = "Terminated"
        exit_code = state["terminated"].get("exitCode")
        message = (state["terminated"].get("message")
                   or state["terminated"].get("reason") or "")
    elif "running" in state:
        mapped = "Running"
    elif "waiting" in state:
        mapped = "Waiting"
        message = (state["waiting"].get("message")
                   or state["waiting"].get("reason") or "")
    return ContainerStatus(name=cs.get("name", ""), state=mapped,
                           exit_code=exit_code,
                           restart_count=int(cs.get("restartCount", 0)),
                           message=message)


def pod_from_k8s(d: dict) -> Pod:
    spec_d = d.get("spec") or {}
    status_d = d.get("status") or {}
    relay_dir = ""
    for vol in spec_d.get("volumes") or []:
        if vol.get("name") == RELAY_VOLUME_NAME:
            relay_dir = (vol.get("hostPath") or {}).get("path", "")
            break
    spec = PodSpec(
        containers=[_container_from_k8s(kc)
                    for kc in spec_d.get("containers") or []],
        restart_policy=spec_d.get("restartPolicy", "Never"),
        scheduler_name=spec_d.get("schedulerName", ""),
        node_selector=dict(spec_d.get("nodeSelector") or {}),
        tolerations=[Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Exists"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
            toleration_seconds=t.get("tolerationSeconds"))
            for t in spec_d.get("tolerations") or []],
        node_name=spec_d.get("nodeName", ""),
        relay_dir=relay_dir,
    )
    status = PodStatus(
        phase=status_d.get("phase", "Pending"),
        container_statuses=[_container_status_from_k8s(cs) for cs in
                            status_d.get("containerStatuses") or []],
        start_time=parse_time(status_d.get("startTime")),
        host=status_d.get("podIP") or status_d.get("hostIP") or "",
        message=status_d.get("message", ""),
    )
    return Pod(metadata=_meta_from_k8s(d.get("metadata") or {}),
               spec=spec, status=status)


def service_to_k8s(ep: Endpoint) -> dict:
    """Per-replica headless Service (reference CreateNewService,
    common/service.go:277-339: ClusterIP None, selector = that one pod)."""
    ports = [{"name": n, "port": int(p)}
             for n, p in sorted(ep.spec.ports.items())]
    if not ports:
        ports = [{"name": constants.DEFAULT_PORT_NAME,
                  "port": constants.DEFAULT_PORT}]
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": _meta_to_k8s(ep.metadata),
            "spec": {"clusterIP": "None",
                     "selector": dict(ep.spec.selector),
                     "ports": ports}}


def endpoint_from_k8s_service(d: dict) -> Endpoint:
    spec_d = d.get("spec") or {}
    ports = {p.get("name", f"port-{p.get('port')}"): int(p.get("port", 0))
             for p in spec_d.get("ports") or []}
    return Endpoint(metadata=_meta_from_k8s(d.get("metadata") or {}),
                    spec=EndpointSpec(selector=dict(spec_d.get("selector")
                                                    or {}),
                                      ports=ports))


def tpujob_to_k8s(job: TPUJob) -> dict:
    d = job.to_dict()
    d["apiVersion"] = constants.API_VERSION
    d["kind"] = constants.KIND
    d["metadata"] = _meta_to_k8s(job.metadata)
    return d


def tpujob_from_k8s(d: dict) -> TPUJob:
    body = dict(d)
    meta = _meta_from_k8s(d.get("metadata") or {})
    body.pop("metadata", None)
    job = TPUJob.from_dict(body)
    job.metadata = meta
    return job


def node_from_k8s(d: dict) -> Node:
    """core/v1 Node -> the framework Node the agent registry also uses:
    allocatable nvidia.com/gpu GPUs become spec.chips, the NVLink-domain
    label rides metadata.labels, cordon maps onto spec.unschedulable.
    Taints and allocatable cpu/mem feed the binder's hard placement
    filters; the node agent's heartbeat annotation feeds the operator's
    barrier-capability check (docs/node-agent.md)."""
    from tf_operator_tpu_torch.controller.binder import (
        parse_cpu_quantity_millis,
        parse_memory_quantity_bytes,
    )

    meta = _meta_from_k8s(d.get("metadata") or {})
    meta.namespace = ""  # cluster-scoped
    spec_d = d.get("spec") or {}
    status_d = d.get("status") or {}
    address = ""
    for addr in status_d.get("addresses") or []:
        if addr.get("type") == "InternalIP":
            address = addr.get("address", "")
            break
    allocatable = status_d.get("allocatable") or {}
    try:
        chips = int(float(allocatable.get(constants.RESOURCE_GPU, 0) or 0))
    except ValueError:
        chips = 0
    conditions: Dict[str, str] = {}
    for cond in status_d.get("conditions") or []:
        ctype = cond.get("type", "")
        if ctype:
            conditions[ctype] = cond.get("status", "")
    # A node with NO Ready condition at all (kubelet never heartbeated)
    # is NotReady — kube-scheduler's conservative convention. Defaulting
    # to Ready would put its chips into the gang admission budget and
    # let the binder target a node nothing is serving on.
    ready = "Ready" if conditions.get("Ready") == "True" else "NotReady"
    taints = [Taint(key=t.get("key", ""), value=t.get("value", ""),
                    effect=t.get("effect", ""))
              for t in spec_d.get("taints") or []]
    return Node(metadata=meta,
                spec=NodeSpec(address=address, chips=chips,
                              labels=dict(meta.labels),
                              unschedulable=bool(
                                  spec_d.get("unschedulable")),
                              taints=taints),
                status=NodeStatus(
                    phase=ready, conditions=conditions,
                    last_heartbeat=parse_time(meta.annotations.get(
                        constants.ANNOTATION_AGENT_HEARTBEAT)),
                    allocatable_cpu_millis=parse_cpu_quantity_millis(
                        allocatable.get("cpu")),
                    allocatable_memory_bytes=parse_memory_quantity_bytes(
                        allocatable.get("memory"))))


FROM_K8S: Dict[str, Callable[[dict], object]] = {
    store_mod.TPUJOBS: tpujob_from_k8s,
    store_mod.PODS: pod_from_k8s,
    store_mod.ENDPOINTS: endpoint_from_k8s_service,
    store_mod.NODES: node_from_k8s,
}


# ---------------------------------------------------------------------------
# Controls (reference RealPodControl / RealServiceControl)
# ---------------------------------------------------------------------------

from tf_operator_tpu_torch.controller.control import (  # noqa: E402
    EndpointControl,
    PodControl,
    controller_owner_ref,
)


class KubePodControl(PodControl):
    def __init__(self, client: KubeClient, recorder: Recorder):
        self.client = client
        self.recorder = recorder

    def create_pod(self, namespace: str, pod: Pod, job: TPUJob) -> None:
        pod.metadata.namespace = namespace
        pod.metadata.owner_references = [controller_owner_ref(job)]
        try:
            self.client.create(store_mod.PODS, namespace, pod_to_k8s(pod))
        except Exception as e:
            self.recorder.event(job, EVENT_TYPE_WARNING, "FailedCreatePod",
                                f"Error creating: {e}")
            raise
        self.recorder.event(job, EVENT_TYPE_NORMAL, "SuccessfulCreatePod",
                            f"Created pod: {pod.metadata.name}")
        metrics.created_pods.inc(job_namespace=namespace)

    def delete_pod(self, namespace: str, name: str, job: TPUJob) -> None:
        try:
            self.client.delete(store_mod.PODS, namespace, name)
        except store_mod.NotFoundError:
            return
        except Exception as e:
            self.recorder.event(job, EVENT_TYPE_WARNING, "FailedDeletePod",
                                f"Error deleting: {e}")
            raise
        self.recorder.event(job, EVENT_TYPE_NORMAL, "SuccessfulDeletePod",
                            f"Deleted pod: {name}")
        metrics.deleted_pods.inc(job_namespace=namespace)


class KubeEndpointControl(EndpointControl):
    def __init__(self, client: KubeClient, recorder: Recorder):
        self.client = client
        self.recorder = recorder

    def create_endpoint(self, namespace: str, endpoint: Endpoint,
                        job: TPUJob) -> None:
        endpoint.metadata.namespace = namespace
        endpoint.metadata.owner_references = [controller_owner_ref(job)]
        self.client.create(store_mod.ENDPOINTS, namespace,
                           service_to_k8s(endpoint))
        metrics.created_endpoints.inc(job_namespace=namespace)

    def delete_endpoint(self, namespace: str, name: str, job: TPUJob) -> None:
        try:
            self.client.delete(store_mod.ENDPOINTS, namespace, name)
        except store_mod.NotFoundError:
            return
        metrics.deleted_endpoints.inc(job_namespace=namespace)


class KubePdbControl:
    """PodDisruptionBudget sync for gang-scheduled jobs (reference
    SyncPdb, common/job_controller.go:247-284): one PDB per job, named
    after it, minAvailable = the gang's minMember, selecting the job's
    pods — so the CLUSTER's eviction machinery (node drains, autoscaler)
    can't shrink a gang below its all-or-nothing threshold out from
    under the scheduler. Owner-referenced: cluster GC reaps it with the
    job; delete() covers backends without GC (the fake)."""

    def __init__(self, client: KubeClient, recorder: Recorder):
        self.client = client
        self.recorder = recorder

    def sync(self, job: TPUJob, min_available: int) -> None:
        """Level-triggered like the reference (SyncPdb GETs every
        reconcile): recreate an out-of-band-deleted PDB, patch
        minAvailable when the gang's threshold changes."""
        ns, name = job.metadata.namespace, job.metadata.name
        want = int(min_available)
        try:
            current = None
            try:
                current = self.client.get(KIND_PDBS, ns, name)
            except store_mod.NotFoundError:
                pass
            if current is None:
                self.client.create(KIND_PDBS, ns, {
                    "apiVersion": "policy/v1",
                    "kind": "PodDisruptionBudget",
                    "metadata": {
                        "name": name,
                        "ownerReferences": [
                            controller_owner_ref(job).to_dict()],
                    },
                    "spec": {
                        "minAvailable": want,
                        "selector": {"matchLabels": {
                            constants.LABEL_JOB_NAME: name}},
                    },
                })
                self.recorder.event(job, EVENT_TYPE_NORMAL,
                                    "SuccessfulCreatePdb",
                                    f"Created PDB: {name} "
                                    f"(minAvailable={want})")
            elif (current.get("spec") or {}).get("minAvailable") != want:
                self.client.patch(KIND_PDBS, ns, name,
                                  {"spec": {"minAvailable": want}})
                self.recorder.event(job, EVENT_TYPE_NORMAL,
                                    "SuccessfulUpdatePdb",
                                    f"PDB {name} minAvailable -> {want}")
        except store_mod.AlreadyExistsError:
            pass  # concurrent leader won the create; next sync verifies
        except Exception as e:
            # Best-effort (the reference tolerates pdb failure the same
            # way): gang admission itself doesn't depend on the PDB —
            # but degraded drain protection must be visible on the job.
            self.recorder.event(job, EVENT_TYPE_WARNING, "FailedSyncPdb",
                                f"Error syncing PDB: {e}")
            log.warning("pdb sync for %s/%s failed: %s", ns, name, e)

    def delete(self, job: TPUJob) -> None:
        try:
            self.client.delete(KIND_PDBS, job.metadata.namespace,
                               job.metadata.name)
        except store_mod.NotFoundError:
            pass
        except Exception as e:
            self.recorder.event(job, EVENT_TYPE_WARNING, "FailedDeletePdb",
                                f"Error deleting PDB: {e}")
            log.warning("pdb delete for %s/%s failed: %s",
                        job.metadata.namespace, job.metadata.name, e)


# ---------------------------------------------------------------------------
# Informer: cluster state -> Store cache
# ---------------------------------------------------------------------------

# Reflector failure backoff (client-go reflector backoff analog).
_BACKOFF_BASE = 0.5
_BACKOFF_CAP = 30.0


class _Reflector:
    """Shared list+watch+reconnect loop (client-go reflector analog):
    relist, stream the watch, relist again on expiry/error, abortable
    mid-read. Subclasses supply ``_on_list(first, items)`` and
    ``_on_event(etype, raw)`` sinks."""

    def __init__(self, client: KubeClient, kind: str,
                 namespace: Optional[str] = None,
                 selector: Optional[Dict[str, str]] = None,
                 thread_name: str = ""):
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.selector = selector
        self._thread_name = thread_name or f"reflector-{kind}"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._resp_box: list = []
        self._failures = 0

    def start(self):
        self._thread = threading.Thread(target=self._run,
                                        name=self._thread_name, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Abort a blocking watch read so shutdown doesn't wait out the
        # stream timeout. close() alone is not enough: it only drops the
        # fd reference, and a recv() already blocked inside the reflector
        # thread keeps the socket alive until the server's next keepalive
        # tick — shutdown() wakes that read immediately.
        for resp in self._resp_box:
            sock = getattr(getattr(resp, "fp", None), "raw", None)
            sock = getattr(sock, "_sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            try:
                resp.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _backoff_seconds(self) -> float:
        """Exponential backoff with full jitter (client-go's reflector
        backoff manager semantics: grow to a cap, never hot-loop, add
        jitter so restarted reflectors don't thundering-herd the API
        server)."""
        base = min(_BACKOFF_CAP, _BACKOFF_BASE * (2 ** min(
            self._failures - 1, 10)))
        return base * (0.5 + random.random() / 2)

    def _run(self) -> None:
        # Reference behavior (client-go reflector.go:166-302): list once,
        # then watch; when a watch stream ends normally RESUME watching
        # from lastSyncResourceVersion instead of relisting (relists are
        # O(collection) on the server); relist only on 410 Gone (history
        # compacted past our RV) or after an error.
        first = True
        rv: Optional[str] = None  # None = must (re)list before watching
        while not self._stop.is_set():
            try:
                if rv is None:
                    listing = self.client.list(self.kind, self.namespace,
                                               self.selector)
                    self._on_list(first, listing.get("items") or [])
                    first = False
                    rv = str((listing.get("metadata") or {})
                             .get("resourceVersion", "") or "0")
                for etype, raw in self.client.watch(
                        self.kind, self.namespace, self.selector, rv,
                        resp_box=self._resp_box):
                    if self._stop.is_set():
                        return
                    if etype == "BOOKMARK":
                        # Bookmark's only job: advance the resume point.
                        brv = str(((raw or {}).get("metadata") or {})
                                  .get("resourceVersion", "") or "")
                        if brv:
                            rv = brv
                        continue
                    if etype == "ERROR":
                        code = int((raw or {}).get("code", 410) or 410)
                        if code == 410:
                            # History compacted past our RV: relist —
                            # not a failure, no backoff.
                            rv = None
                            break
                        # Any other server-side watch error takes the
                        # failure path (backoff + escalating log) —
                        # otherwise a persistent error becomes a silent
                        # hot list/watch loop.
                        raise KubeApiError(code, (raw or {}).get(
                            "reason", "WatchError"),
                            (raw or {}).get("message", "watch error"))
                    self._on_event(etype, raw)
                    # Reset ONLY on a delivered event — a successful
                    # relist must not clear the counter, or a
                    # list-ok/watch-fails loop oscillates at failures<=1
                    # forever: backoff never grows and the escalated
                    # warning at 3 consecutive failures never fires.
                    self._failures = 0
                    erv = str(((raw or {}).get("metadata") or {})
                              .get("resourceVersion", "") or "")
                    if erv:
                        rv = erv
                # Normal stream end (server timeoutSeconds): fall through
                # with rv intact — the next iteration re-watches from the
                # last delivered event, losing nothing and listing
                # nothing.
            except Exception:
                if self._stop.is_set():
                    return
                self._failures += 1
                # A transient blip logs at debug; a PERSISTENT failure
                # (403 from missing RBAC, bad server, expired token)
                # must not hide there — it would look like a silent hang.
                logfn = (log.warning if self._failures == 3
                         or self._failures % 300 == 0 else log.debug)
                logfn("reflector %s retrying after %d consecutive "
                      "errors", self.kind, self._failures, exc_info=True)
                self._stop.wait(self._backoff_seconds())
                # After an error we cannot know what was missed: relist.
                rv = None

    def _on_list(self, first: bool, items) -> None:
        raise NotImplementedError

    def _on_event(self, etype: str, raw: dict) -> None:
        raise NotImplementedError


class KubeInformer(_Reflector):
    """List+watch one kind into the Store (reflector analog). The Store's
    watch fan-out then drives the controller handlers exactly as the
    local runtime does."""

    def __init__(self, client: KubeClient, store: Store, kind: str,
                 namespace: Optional[str] = None,
                 selector: Optional[Dict[str, str]] = None):
        super().__init__(client, kind, namespace, selector,
                         thread_name=f"informer-{kind}")
        self.store = store
        self._from_k8s = FROM_K8S[kind]
        self.synced = threading.Event()

    def _on_list(self, first: bool, items) -> None:
        seen = set()
        for raw in items:
            obj = self._from_k8s(raw)
            seen.add((obj.metadata.namespace, obj.metadata.name))
            self._upsert(obj)
        # Objects gone from the cluster but still cached: delete.
        for ns, name, _ in self.store.keys(self.kind):
            if (ns, name) not in seen:
                self.store.try_delete(self.kind, ns, name)
        self.synced.set()

    def _on_event(self, etype: str, raw: dict) -> None:
        obj = self._from_k8s(raw)
        if etype == store_mod.DELETED:
            self.store.try_delete(self.kind, obj.metadata.namespace,
                                  obj.metadata.name)
        else:
            self._upsert(obj)

    def _upsert(self, obj) -> None:
        cur = self.store.try_get(self.kind, obj.metadata.namespace,
                                 obj.metadata.name)
        if cur is None:
            try:
                self.store.create(self.kind, obj)
            except store_mod.AlreadyExistsError:
                self._upsert(obj)
            return
        # Skip no-op mirrors: a relist re-delivers every object, and an
        # unconditional update would fire MODIFIED -> enqueue for all.
        a, b = cur.to_dict(), obj.to_dict()
        a.get("metadata", {}).pop("resourceVersion", None)
        b.get("metadata", {}).pop("resourceVersion", None)
        if a == b:
            return
        obj.metadata.resource_version = cur.metadata.resource_version
        try:
            self.store.update(self.kind, obj)
        except (store_mod.ConflictError, store_mod.NotFoundError):
            pass  # racing mirror; the next event/relist converges


# ---------------------------------------------------------------------------
# Controller + operator assembly
# ---------------------------------------------------------------------------

from tf_operator_tpu_torch.controller.engine import EngineConfig  # noqa: E402
from tf_operator_tpu_torch.controller.gang import SliceGangScheduler  # noqa: E402
from tf_operator_tpu_torch.controller.gpu_controller import (  # noqa: E402
    GPUJobController,
)


class KubeJobController(GPUJobController):
    """GPUJobController with the write path against the K8s API server;
    the Store remains the read cache fed by KubeInformer."""

    # Per-key serialization in the workqueue makes parallel sync workers
    # safe; 4 is the production default (a 1k-job fleet converges ~4x
    # faster through API-server write latency).
    DEFAULT_THREADINESS = 4

    def run(self, threadiness: int = DEFAULT_THREADINESS) -> None:
        super().run(threadiness=threadiness)

    def __init__(self, client: KubeClient, store: Optional[Store] = None,
                 **kwargs):
        super().__init__(store or Store(), **kwargs)
        self.client = client
        self.engine.pod_control = KubePodControl(client, self.recorder)
        self.engine.endpoint_control = KubeEndpointControl(client,
                                                           self.recorder)
        if self.engine.gang is not None:
            if getattr(self.engine.gang, "_pod_control_auto_bound", False):
                # Re-bind only the base class's auto-bound store control
                # — evictions must go through the API server here. An
                # explicitly constructed pod_control is respected.
                self.engine.gang.pod_control = self.engine.pod_control
            # Reference SyncPdb: protect admitted gangs from cluster
            # eviction machinery (drains/autoscaler) via a PDB.
            self.engine.gang.pdb_control = KubePdbControl(client,
                                                          self.recorder)

    def update_job_status_in_api(self, job: TPUJob) -> None:
        """Status-subresource merge patch (reference
        UpdateJobStatusInApiServer, tensorflow/status.go:222-240).

        Every status field the schema knows is present in the patch —
        unset ones as explicit JSON nulls — because a merge patch can
        only CLEAR a field it names (RFC 7386): omitting a field leaves
        the server's old value in place forever."""
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        body = job.status.to_dict(explicit_nulls=True)
        try:
            # Transient 5xx blips retry in place (runtime/retry.py) and
            # report into degraded-mode tracking; a chaos-injected 409
            # is retried too — the patch carries no resourceVersion
            # precondition, so replaying the same merge is the correct
            # RetryOnConflict body.
            retry_mod.with_retries(
                lambda: self.client.patch(
                    store_mod.TPUJOBS, job.metadata.namespace,
                    job.metadata.name, {"status": body},
                    subresource="status"),
                component="kube.status",
                retryable=lambda e: (retry_mod.is_transient(e)
                                     or isinstance(
                                         e, store_mod.ConflictError)),
                health=self.cp_health)
        except store_mod.NotFoundError:
            pass  # job deleted mid-sync
        except store_mod.ConflictError:
            pass  # injected CAS loss; the next sync rewrites

    def delete_job(self, job: TPUJob) -> None:
        try:
            self.client.delete(store_mod.TPUJOBS, job.metadata.namespace,
                               job.metadata.name)
        except store_mod.NotFoundError:
            pass
        self.expectations.delete_for_job(job.key())
        self.recorder.event(job, EVENT_TYPE_NORMAL, "SuccessfulDeleteJob",
                            f"Deleted job: {job.metadata.name}")

    def _persist_adoption(self, kind: str, obj):
        """Ownership patch against the API server (reference AdoptPod's
        strategic-merge patch, controller_ref_manager.go:208-221)."""
        ns, name = obj.metadata.namespace, obj.metadata.name
        # Uncached quorum recheck (reference GetPodsForJob re-reads the
        # job live before claiming, common/pod.go:241-252): the cache may
        # lag — the object could have been deleted and recreated (new
        # uid) or adopted by someone else since the informer mirrored it.
        try:
            raw = self.client.get(kind, ns, name)
        except store_mod.NotFoundError:
            return None
        live = FROM_K8S[kind](raw)
        if (live.metadata.uid != obj.metadata.uid
                or live.metadata.controller_ref() is not None):
            return None
        patch = {"metadata": {
            # Live resourceVersion precondition closes the GET->PATCH
            # window (the reference adopt patch carries a uid
            # precondition for the same race).
            "resourceVersion": k8s_resource_version(raw),
            "ownerReferences": [
                r.to_dict() for r in obj.metadata.owner_references]}}
        try:
            raw = self.client.patch(kind, ns, name, patch)
        except (store_mod.ConflictError, store_mod.NotFoundError):
            return None
        return FROM_K8S[kind](raw)

    def _persist_release(self, kind: str, obj, job: TPUJob) -> None:
        """ReleasePod analog against the API server: live-read, verify
        the same object still exists, then patch our ownerReference away
        under a resourceVersion precondition."""
        ns, name = obj.metadata.namespace, obj.metadata.name
        try:
            raw = self.client.get(kind, ns, name)
        except store_mod.NotFoundError:
            return  # deleted is released
        live = FROM_K8S[kind](raw)
        if live.metadata.uid != obj.metadata.uid:
            return  # recreated under the same name; not ours to touch
        refs = [r.to_dict() for r in live.metadata.owner_references
                if r.uid != job.metadata.uid]
        patch = {"metadata": {"resourceVersion": k8s_resource_version(raw),
                              "ownerReferences": refs}}
        try:
            self.client.patch(kind, ns, name, patch)
        except (store_mod.ConflictError, store_mod.NotFoundError):
            pass  # changed underneath us; the next sync reconverges

    def _garbage_collect(self, job: TPUJob) -> None:
        """The cluster's ownerReference GC collects pods/services; delete
        explicitly too so tests (and clusters with GC lag) converge, and
        reap the store-local SliceGroup. O(owned) via the cache's
        owner-UID index — this used to deepcopy every cached object in
        the namespace, three kinds over, per deleted job."""
        for kind in (store_mod.PODS, store_mod.ENDPOINTS):
            for ns, name in self.store.owned_keys(kind, job.metadata.uid):
                try:
                    self.client.delete(kind, ns, name)
                except store_mod.NotFoundError:
                    pass
        for ns, name in self.store.owned_keys(store_mod.SLICEGROUPS,
                                              job.metadata.uid):
            self.store.try_delete(store_mod.SLICEGROUPS, ns, name)


class KubeOperator:
    """Operator assembly against a Kubernetes cluster (the reference
    deployment shape: manifests/gpu/operator-deployment.yaml runs
    exactly this)."""

    def __init__(self, client: KubeClient,
                 namespace: Optional[str] = None,
                 enable_gang_scheduling: bool = False,
                 total_chips: Optional[int] = None,
                 gang_fairness: str = "aged",
                 gang_aging_seconds: float = 300.0,
                 gang_priority_classes: Optional[dict] = None,
                 gang_queue_quotas: Optional[dict] = None,
                 gang_preemption: bool = False,
                 gang_binder: bool = True,
                 slice_health: bool = True,
                 health_drain_grace_seconds: float = 0.0,
                 config: Optional[EngineConfig] = None,
                 post_events: bool = True,
                 degraded_after_seconds: float = 10.0,
                 enable_tenant_queues: bool = False,
                 queue_config: Optional[str] = None,
                 enable_ckpt_coordination: bool = False,
                 enable_serving: bool = False,
                 relay_dir: str = "",
                 agent_heartbeat_staleness_seconds: float = 30.0):
        from tf_operator_tpu_torch.runtime.retry import ControlPlaneHealth

        self.client = client
        self.store = Store()
        self.post_events = post_events
        recorder = Recorder(sink=self._post_event if post_events else None)
        config = config or EngineConfig()
        # Degraded-mode tracker (runtime/retry.py, docs/robustness.md):
        # API writes report into it; while degraded the controller keeps
        # reconciling but defers new drains/reclaims/preemptions.
        self.cp_health = ControlPlaneHealth(
            threshold_seconds=degraded_after_seconds)
        if enable_tenant_queues and not enable_gang_scheduling:
            raise ValueError("tenant queues sit above gang admission: "
                             "--enable-tenant-queues requires "
                             "--enable-gang-scheduling")
        self.agent_heartbeat_staleness_seconds = \
            agent_heartbeat_staleness_seconds
        self.quota = None
        self.ckpt = None
        self.serving = None
        # (ns, pod) -> last ckpt-state annotation payload mirrored into
        # a CheckpointRecord (relist dedup for _on_pod_relay_event).
        self._ckpt_state_seen: Dict[Tuple[str, str], str] = {}
        if enable_ckpt_coordination:
            from tf_operator_tpu_torch.controller.ckpt import (
                CheckpointCoordinator,
            )

            # Notice stamps go through the API server (the store is an
            # informer mirror — a direct write would be clobbered by
            # the next relist), and barrier opening is gated on fresh
            # node-agent heartbeats: a node without a live relay can't
            # deliver the notice, so the drain degrades to plain
            # eviction instead of waiting out a doomed barrier.
            self.ckpt = CheckpointCoordinator(
                self.store, recorder=recorder, namespace=namespace,
                annotate_pod=self._annotate_pod,
                barrier_capable=self._barrier_capable)
        if enable_serving:
            from tf_operator_tpu_torch.controller.serving import ServingManager

            self.serving = ServingManager(self.store, recorder=recorder,
                                          namespace=namespace)
        gang = None
        if enable_gang_scheduling:
            config.enable_gang_scheduling = True
            if enable_tenant_queues:
                from tf_operator_tpu_torch.controller.quota import (
                    TenantQueueManager,
                    load_queue_config,
                    seed_queues,
                )

                # Queues/ClusterQueues are operator-internal kinds (no
                # CRD): on kube they live in the in-memory store and are
                # seeded from --queue-config (docs/quota.md Scope).
                self.quota = TenantQueueManager(self.store,
                                                recorder=recorder)
                if queue_config:
                    seed_queues(self.store,
                                *load_queue_config(queue_config))
            gang = SliceGangScheduler(self.store, total_chips=total_chips,
                                      fairness=gang_fairness,
                                      aging_seconds=gang_aging_seconds,
                                      priority_classes=gang_priority_classes,
                                      queue_quotas=gang_queue_quotas,
                                      preemption=gang_preemption,
                                      quota=self.quota,
                                      ckpt=self.ckpt,
                                      recorder=recorder,
                                      # Node-bound Pending pods (container
                                      # creating) already hold chips here;
                                      # nothing stamps gang_released on
                                      # the kube data plane.
                                      scheduled_pods_occupy=True,
                                      # With the in-operator binder, an
                                      # unset chip budget follows live
                                      # node inventory instead of being
                                      # unlimited.
                                      capacity_provider=(
                                          self._cluster_chip_capacity
                                          if gang_binder
                                          and total_chips is None
                                          else None),
                                      # Structural per-slice ceiling: a
                                      # slice no NVLink domain can hold is
                                      # infeasible, not admitted-and-
                                      # stuck (binder can't split it).
                                      # Only when capacity is node-
                                      # derived — an explicit
                                      # --total-chips overrides node
                                      # accounting wholesale.
                                      domain_capacity_provider=(
                                          self._max_domain_chip_capacity
                                          if gang_binder
                                          and total_chips is None
                                          else None),
                                      cp_health=self.cp_health)
        self.controller = KubeJobController(client, store=self.store,
                                            recorder=recorder, config=config,
                                            gang=gang, namespace=namespace,
                                            cp_health=self.cp_health,
                                            ckpt=self.ckpt,
                                            serving=self.serving,
                                            relay_dir=relay_dir)
        if self.ckpt is not None and gang is not None:
            # A barrier ack landing between resyncs must release the
            # held eviction promptly: record writes poke admission.
            self.ckpt.on_ack = gang.readmit
        # Pods/services are watched UNSELECTED (upstream controller
        # style): a selector watch would drop an owned pod from the cache
        # the moment its group label is edited away, making it invisible
        # to the release path and leaving a stale ownerReference to
        # cascade-delete it later.
        self.informers = [
            KubeInformer(client, self.store, store_mod.TPUJOBS, namespace),
            KubeInformer(client, self.store, store_mod.PODS, namespace),
            KubeInformer(client, self.store, store_mod.ENDPOINTS, namespace),
        ]
        self.binder = None
        self.health = None
        # Nodes are cluster-scoped: informer namespace is always None.
        # The binder needs them for placement; the checkpoint
        # coordinator needs them for agent-heartbeat freshness even
        # without the binder.
        if (enable_gang_scheduling and gang_binder) \
                or enable_ckpt_coordination:
            self.informers.append(
                KubeInformer(client, self.store, store_mod.NODES, None))
        self._relay_watcher = None
        if enable_ckpt_coordination:
            # The node agent mirrors each worker's checkpoint file onto
            # the pod's ckpt-state annotation; the PODS informer carries
            # it here, where it becomes the pod's (in-memory)
            # CheckpointRecord — the same object the local data plane
            # publishes directly (runtime/relay.py).
            self._relay_watcher = self.store.watch(
                store_mod.PODS, self._on_pod_relay_event)
        if enable_gang_scheduling and gang_binder:
            from tf_operator_tpu_torch.controller.binder import SliceGangBinder

            self.binder = SliceGangBinder(self.store, client, gang,
                                          namespace=namespace,
                                          recorder=recorder)
            if slice_health:
                # Slice-health & auto-repair rides the same node
                # inventory the binder placed from: maintenance-aware
                # cordon + gang drain/rebind (controller/health.py).
                from tf_operator_tpu_torch.controller.health import (
                    SliceHealthController,
                )

                self.health = SliceHealthController(
                    self.store, client=client, gang=gang,
                    pod_control=self.controller.engine.pod_control,
                    recorder=recorder, namespace=namespace,
                    default_grace_seconds=health_drain_grace_seconds,
                    ckpt=self.ckpt, cp_health=self.cp_health)

    # -- node-agent relay plumbing (docs/node-agent.md) ------------------

    def _annotate_pod(self, namespace: str, name: str,
                      annotations: Dict[str, str]) -> None:
        """Checkpoint-coordinator stamp hook: annotations go through the
        API server (merge PATCH); the informer mirrors them back and the
        node agent's own watch relays them to the worker."""
        self.client.patch(store_mod.PODS, namespace, name,
                          {"metadata": {"annotations": dict(annotations)}})

    def _barrier_capable(self, pods) -> bool:
        """A gang is barrier-capable only when EVERY node hosting one of
        its live pods has a fresh node-agent heartbeat — otherwise the
        preemption notice would never reach some worker as a file and
        the barrier could only time out. Unbound pods have no relay
        either. Degrading (returning False) reproduces today's
        no-coordination eviction exactly (docs/node-agent.md)."""
        import datetime as _dt

        node_names = {p.spec.node_name for p in pods if p.spec.node_name}
        if not node_names:
            return False
        now = _dt.datetime.now(_dt.timezone.utc)
        for node_name in node_names:
            node = self.store.try_get(store_mod.NODES, "", node_name)
            if node is None or node.status.last_heartbeat is None:
                return False
            hb = node.status.last_heartbeat
            if hb.tzinfo is None:
                hb = hb.replace(tzinfo=_dt.timezone.utc)
            if (now - hb).total_seconds() \
                    > self.agent_heartbeat_staleness_seconds:
                return False
        return True

    def _on_pod_relay_event(self, etype: str, pod: Pod) -> None:
        """Convert the agent-mirrored ckpt-state annotation into the
        pod's CheckpointRecord (operator-internal kind — lives only in
        this in-memory store, so the informer can't clobber it)."""
        key = (pod.metadata.namespace, pod.metadata.name)
        if etype == store_mod.DELETED:
            self._ckpt_state_seen.pop(key, None)
            return
        raw = pod.metadata.annotations.get(
            constants.ANNOTATION_CKPT_STATE, "")
        if not raw or self._ckpt_state_seen.get(key) == raw:
            return
        try:
            data = json.loads(raw)
        except ValueError:
            return
        if not isinstance(data, dict):
            return
        import datetime as _dt

        from tf_operator_tpu_torch.runtime import relay as relay_mod

        try:
            if relay_mod.upsert_checkpoint_record(
                    self.store, pod, data,
                    _dt.datetime.now(_dt.timezone.utc)):
                self._ckpt_state_seen[key] = raw
        except Exception:
            log.debug("ckpt-state mirror for %s/%s failed", *key,
                      exc_info=True)

    def _cluster_chip_capacity(self) -> int:
        """Gang admission budget from live node inventory: allocatable
        GPUs across schedulable, Ready nodes (Volcano allocator
        analog — a cordoned or dead-kubelet node's chips must not admit
        a gang the binder then cannot place).

        Single-tenant assumption (documented at the --gang-binder flag
        and docs/health.md): chips held by pods outside the operator's
        bookkeeping — foreign controllers, or other namespaces when the
        operator is namespaced — are invisible to admission occupancy,
        so on a shared cluster a group can be admitted yet sit
        unplaceable at the binder until the foreign pods leave."""
        from tf_operator_tpu_torch.controller.binder import node_is_schedulable

        total = 0
        for n in self.store.list(store_mod.NODES):
            if node_is_schedulable(n):
                total += n.spec.chips
        return total

    def _max_domain_chip_capacity(self) -> Optional[int]:
        """Largest single NVLink domain's GPU capacity — the structural
        ceiling for ONE slice. A slice bigger than every domain can
        never be placed whole; admission must not book budget for it
        (gang.py domain_capacity_provider). None when no nodes are
        known: zero topology knowledge must not flag everything
        infeasible (the capacity budget already gates admission)."""
        from tf_operator_tpu_torch.controller.binder import (
            node_nvlink_domain,
            node_is_schedulable,
        )

        per_domain: Dict[str, int] = {}
        for n in self.store.list(store_mod.NODES):
            if node_is_schedulable(n):
                dom = node_nvlink_domain(n)
                per_domain[dom] = per_domain.get(dom, 0) + n.spec.chips
        return max(per_domain.values(), default=None)

    def start(self, threadiness: int = KubeJobController.DEFAULT_THREADINESS,
              sync_timeout: float = 30.0) -> None:
        for inf in self.informers:
            inf.start()
        # WaitForCacheSync analog (reference controller.go:201).
        for inf in self.informers:
            if not inf.synced.wait(timeout=sync_timeout):
                raise TimeoutError(f"informer {inf.kind} never synced "
                                   f"(API server unreachable?)")
        if self.ckpt is not None:
            self.ckpt.start()
        self.controller.run(threadiness=threadiness)
        if self.binder is not None:
            self.binder.start()
        if self.health is not None:
            self.health.start()
        log.info("kube operator started (threadiness=%d)", threadiness)

    def stop(self) -> None:
        if self.health is not None:
            self.health.stop()
        if self.binder is not None:
            self.binder.stop()
        self.controller.stop()
        if self.ckpt is not None:
            self.ckpt.stop()
        if self._relay_watcher is not None:
            self._relay_watcher.stop()
            self._relay_watcher = None
        for inf in self.informers:
            inf.stop()
        self.store.stop_watchers()

    def _post_event(self, ev) -> None:
        """Mirror recorder events as core/v1 Events (reference recorder
        wiring, common/job_controller.go:158-162)."""
        import uuid

        ns = ev.namespace or "default"
        body = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": f"{ev.object_name}.{uuid.uuid4().hex[:10]}",
                         "namespace": ns},
            "involvedObject": {"kind": ev.object_kind,
                               "name": ev.object_name, "namespace": ns},
            "type": ev.type, "reason": ev.reason, "message": ev.message,
            "source": {"component": "tpu-operator"},
        }
        try:
            self.client.create_event(ns, body)
        except Exception:
            log.debug("event post failed", exc_info=True)


def check_crd_exists(client: KubeClient) -> bool:
    """Fail-fast CRD existence probe (reference checkCRDExists,
    app/server.go:232-251). Only a definitive 404 means "not installed";
    auth/server errors propagate so they aren't misdiagnosed as a
    missing CRD."""
    try:
        client.request(
            "GET",
            f"/apis/apiextensions.k8s.io/v1/customresourcedefinitions/"
            f"{constants.CRD_NAME}")
        return True
    except store_mod.NotFoundError:
        return False


# ---------------------------------------------------------------------------
# Leader election over coordination.k8s.io Leases
# ---------------------------------------------------------------------------

class KubeLeaseStore:
    """Duck-types the Store subset LeaderElector uses (try_get / create /
    update on the LEASES kind), backed by coordination.k8s.io/v1 Leases:
    the cluster-wide lock the reference took on an Endpoints object
    (app/server.go:168-193) and modern client-go takes on exactly this
    resource. Optimistic concurrency maps onto resourceVersion'd PUTs."""

    def __init__(self, client: KubeClient):
        self.client = client
        # (ns, name) -> raw K8s resourceVersion string for CAS replays.
        self._rv: Dict[Tuple[str, str], str] = {}

    @staticmethod
    def _path(ns: str, name: str = "") -> str:
        base = f"/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"
        return f"{base}/{name}" if name else base

    @staticmethod
    def _spec_to_k8s(lease) -> dict:
        import math

        spec = lease.spec.to_dict()
        # K8s LeaseSpec wants an integer duration; round UP so a
        # sub-second duration never truncates to an always-expired 0.
        if spec.get("leaseDurationSeconds") is not None:
            spec["leaseDurationSeconds"] = math.ceil(
                spec["leaseDurationSeconds"])
        return spec

    def _from_k8s(self, raw: dict):
        from tf_operator_tpu_torch.runtime.leaderelection import Lease

        lease = Lease.from_dict({"spec": raw.get("spec") or {}})
        lease.metadata = _meta_from_k8s(raw.get("metadata") or {})
        key = (lease.metadata.namespace, lease.metadata.name)
        self._rv[key] = k8s_resource_version(raw)
        return lease

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            raw = self.client.request("GET", self._path(namespace, name))
        except store_mod.NotFoundError:
            return None
        return self._from_k8s(raw)

    def create(self, kind: str, lease):
        ns = lease.metadata.namespace
        body = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                "metadata": {"name": lease.metadata.name, "namespace": ns},
                "spec": self._spec_to_k8s(lease)}
        return self._from_k8s(
            self.client.request("POST", self._path(ns), body=body))

    def update(self, kind: str, lease):
        ns, name = lease.metadata.namespace, lease.metadata.name
        body = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                "metadata": {"name": name, "namespace": ns,
                             "resourceVersion": self._rv.get((ns, name), "")},
                "spec": self._spec_to_k8s(lease)}
        return self._from_k8s(
            self.client.request("PUT", self._path(ns, name), body=body))


# ---------------------------------------------------------------------------
# SDK-facing store adapter: TPUJobClient directly against a K8s cluster
# ---------------------------------------------------------------------------

class _KubeWatcher(_Reflector):
    """Store.Watcher analog over a K8s watch stream: delivers translated
    (event_type, obj) pairs to a handler, surviving stream expiry."""

    def __init__(self, client: KubeClient, kind: str,
                 handler: Callable[[str, object], None],
                 namespace: Optional[str], replay: bool,
                 from_k8s: Callable[[dict], object],
                 on_stop: Optional[Callable[["_KubeWatcher"], None]] = None):
        super().__init__(client, kind, namespace,
                         thread_name=f"kube-watch-{kind}")
        self.handler = handler
        self.replay = replay
        self._from_k8s = from_k8s
        self._notify_stop = on_stop
        # (ns, name) -> last delivered object, for synthesizing DELETED
        # after a disconnect gap.
        self._known: Dict[Tuple[str, str], object] = {}
        self.start()

    def _on_list(self, first: bool, items) -> None:
        seen: Dict[Tuple[str, str], object] = {}
        for raw in items:
            obj = self._from_k8s(raw)
            seen[(obj.metadata.namespace, obj.metadata.name)] = obj
        # First relist replays as ADDED (informer initial list);
        # RECONNECT relists re-deliver as MODIFIED so state that changed
        # in the disconnect gap (e.g. a job finishing during a
        # 410/timeout window) is never lost, and objects that VANISHED
        # in the gap get a synthesized DELETED (a watch(until_finished)
        # consumer would otherwise block forever on a deleted job).
        if self.replay or not first:
            etype = store_mod.ADDED if first else store_mod.MODIFIED
            for obj in seen.values():
                self.handler(etype, obj)
        if not first:
            for key, obj in self._known.items():
                if key not in seen:
                    self.handler(store_mod.DELETED, obj)
        self._known = seen

    def _on_event(self, etype: str, raw: dict) -> None:
        obj = self._from_k8s(raw)
        key = (obj.metadata.namespace, obj.metadata.name)
        if etype == store_mod.DELETED:
            self._known.pop(key, None)
        else:
            self._known[key] = obj
        self.handler(etype, obj)

    def stop(self) -> None:
        super().stop()
        if self._notify_stop is not None:
            self._notify_stop(self)


def _event_from_k8s(d: dict) -> "object":
    from tf_operator_tpu_torch.api.types import EventRecord

    involved = d.get("involvedObject") or {}
    record = EventRecord(
        metadata=_meta_from_k8s(d.get("metadata") or {}),
        involved_kind=involved.get("kind", ""),
        involved_name=involved.get("name", ""),
        type=d.get("type", ""),
        reason=d.get("reason", ""),
        message=d.get("message", ""))
    # The in-process recorder stamps a job-name label; K8s Events carry
    # the target in involvedObject instead — reconstruct the label so
    # label-selector consumers (get_events) work unchanged.
    if record.involved_kind == constants.KIND:
        record.metadata.labels.setdefault(constants.LABEL_JOB_NAME,
                                          record.involved_name)
    return record


class KubeSdkStore:
    """Duck-types the Store surface ``TPUJobClient`` uses, directly
    against a Kubernetes cluster — the reference SDK's deployment shape
    (kubernetes-client from kubeconfig, tf_job_client.py:55-100):
    TPUJob CRs, pods, Events, watches, and the pod-log API."""

    def __init__(self, client: KubeClient,
                 namespace: Optional[str] = None):
        self.client = client
        # Watches scope to this namespace when set: a namespaced Role
        # (the common non-admin kubeconfig) cannot list cluster-wide,
        # and the SDK filters to one namespace anyway.
        self.namespace = namespace
        self._watchers: list = []

    @staticmethod
    def _to_k8s(kind: str, obj) -> dict:
        if kind == store_mod.TPUJOBS:
            return tpujob_to_k8s(obj)
        if kind == store_mod.PODS:
            return pod_to_k8s(obj)
        if kind == store_mod.ENDPOINTS:
            return service_to_k8s(obj)
        raise KeyError(f"unsupported kind {kind!r}")

    @staticmethod
    def _from_k8s(kind: str, raw: dict):
        if kind == store_mod.EVENTS:
            return _event_from_k8s(raw)
        return FROM_K8S[kind](raw)

    # -- CRUD -----------------------------------------------------------

    def create(self, kind: str, obj):
        ns = obj.metadata.namespace or "default"
        return self._from_k8s(kind, self.client.create(
            kind, ns, self._to_k8s(kind, obj)))

    def get(self, kind: str, namespace: str, name: str):
        return self._from_k8s(kind, self.client.get(kind, namespace, name))

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except store_mod.NotFoundError:
            return None

    def update(self, kind: str, obj):
        """Full replace under the object's resourceVersion (optimistic
        concurrency — the cluster returns 409 on a stale rv, surfaced
        as ConflictError for the SDK's read-modify-write retry)."""
        ns, name = obj.metadata.namespace, obj.metadata.name
        body = self._to_k8s(kind, obj)
        body.setdefault("metadata", {})["resourceVersion"] = \
            str(obj.metadata.resource_version or "")
        raw = self.client.request("PUT", self.client._path(kind, ns, name),
                                  body=body)
        return self._from_k8s(kind, raw)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self.client.delete(kind, namespace, name)

    def try_delete(self, kind: str, namespace: str, name: str) -> bool:
        try:
            self.client.delete(kind, namespace, name)
            return True
        except store_mod.NotFoundError:
            return False

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[Dict[str, str]] = None):
        if kind == store_mod.EVENTS:
            # K8s Events carry no useful labels. A job-name selector maps
            # onto the server-side involvedObject fieldSelector (a busy
            # shared namespace holds thousands of foreign events);
            # remaining label constraints filter on the reconstructed
            # labels client-side.
            field_selector = ""
            if selector and selector.get(constants.LABEL_JOB_NAME):
                field_selector = ("involvedObject.name="
                                  f"{selector[constants.LABEL_JOB_NAME]}")
            items = [self._from_k8s(kind, raw) for raw in
                     self.client.list(kind, namespace,
                                      field_selector=field_selector)
                     .get("items") or []]
            if selector:
                items = [e for e in items if store_mod.matches_selector(
                    e.metadata.labels, selector)]
            return items
        return [self._from_k8s(kind, raw) for raw in
                self.client.list(kind, namespace,
                                 selector).get("items") or []]

    # -- watch ----------------------------------------------------------

    def watch(self, kind: str, handler, replay: bool = True):
        w = _KubeWatcher(self.client, kind, handler, self.namespace,
                         replay,
                         from_k8s=lambda raw: self._from_k8s(kind, raw),
                         on_stop=self._remove_watcher)
        self._watchers.append(w)
        return w

    def _remove_watcher(self, w) -> None:
        try:
            self._watchers.remove(w)
        except ValueError:
            pass  # already removed (stop_watchers or double stop)

    def stop_watchers(self) -> None:
        watchers, self._watchers = self._watchers, []
        for w in watchers:
            w.stop()

    # -- pod logs (kubelet log API) --------------------------------------

    def read_logs(self, namespace: str, pod_name: str,
                  tail_lines: Optional[int] = None) -> str:
        params = {}
        if tail_lines is not None:
            params["tailLines"] = str(tail_lines)
        try:
            resp = self.client.request(
                "GET",
                f"/api/v1/namespaces/{namespace}/pods/{pod_name}/log",
                params=params, stream=True)
        except store_mod.NotFoundError:
            return ""  # transport parity: a vanished pod has no logs
        with resp:
            text = resp.read().decode("utf-8", "replace")
        if tail_lines == 0:
            return ""
        return text

    def stream_logs(self, namespace: str, pod_name: str):
        try:
            resp = self.client.request(
                "GET",
                f"/api/v1/namespaces/{namespace}/pods/{pod_name}/log",
                params={"follow": "true"}, timeout=None, stream=True)
        except store_mod.NotFoundError:
            return  # transport parity: empty stream for a vanished pod
        try:
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    return
                yield chunk.decode("utf-8", "replace")
        finally:
            resp.close()
