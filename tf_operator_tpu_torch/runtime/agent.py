"""Node agent: the kubelet analog for the served control plane (port of
tf_operator_tpu/runtime/agent.py; the resolver rewrites the
torch.distributed rendezvous, ``MASTER_ADDR``/``MASTER_PORT``, where the
JAX agent rewrites the JAX coordinator keys).

The reference's data plane is kubelet: the operator writes Pods to the
API server, kubelet (on each node) runs the containers and reports
status back (SURVEY §3.2-3.3). This agent closes the same loop against
the served Store:

- registers a ``Node`` (address, chip capacity, log URL) and heartbeats;
- watches Pods, **claims** unbound ones by CAS-ing ``spec.node_name``
  (pull scheduling — optimistic-concurrency conflicts mean another agent
  won the pod, the all-or-nothing analog of kube-scheduler binding);
- at claim time publishes the pod's placement on its status: the node
  address and a freshly allocated host "coordinator" port;
- runs claimed pods with ``LocalProcessBackend``, resolving bootstrap
  env through the control plane instead of DNS: cluster names like
  ``{job}-worker-0.{ns}.svc`` resolve to the owning node's
  ``(status.host, status.ports)`` — real multi-host addresses, no
  loopback rewriting (kube-dns + headless-service analog);
- serves pod logs over HTTP (``/logs/{ns}/{pod}``, with ``?follow=1``
  live tail) so the API server can proxy them to SDK clients (the
  kubelet log API);
- relays checkpoint coordination (controller/ckpt.py) in both
  directions through the embedded ``LocalProcessBackend``: a preemption
  notice stamped on a pod (save-before-evict barrier) is forwarded to
  the worker process as a file (env ``TPUJOB_PREEMPT_FILE``), and the
  worker's checkpoint state file (``TPUJOB_CKPT_FILE`` — periodic
  saves, barrier acks, restore confirmations) is mirrored into the
  pod's ``CheckpointRecord`` on the control plane, exactly like pod
  phase reports.

Run as: ``python -m tf_operator_tpu_torch.runtime.agent --server http://...``.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import logging
import os
import signal
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from tf_operator_tpu_torch.api.types import Node, NodeSpec, NodeStatus, Pod
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import retry as retry_mod
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.local import LocalProcessBackend, _free_port
from tf_operator_tpu_torch.runtime.remote import RemoteStore
from tf_operator_tpu_torch.runtime.store import ADDED, MODIFIED

log = logging.getLogger("tpu_operator.agent")

HEARTBEAT_SECONDS = 5.0
RESOLVE_TIMEOUT_SECONDS = 120.0
COORDINATOR_PORT_NAME = "coordinator"



def _dns_pod_name(hostname: str) -> Tuple[str, str]:
    """``{pod}.{ns}.svc[.domain]`` -> (namespace, pod name)."""
    labels = hostname.split(".")
    if len(labels) >= 2:
        return labels[1], labels[0]
    return "default", labels[0]


class ControlPlaneEnvResolver:
    """Resolve bootstrap env through pod placement records.

    Peers' cluster DNS names map to the (host, port) the owning node
    published on the pod status. Blocks (bounded) until the referenced
    pods are claimed — the analog of DNS names only resolving once pods
    are scheduled, with connection retries replaced by an explicit wait.
    """

    def __init__(self, store, timeout: float = RESOLVE_TIMEOUT_SECONDS):
        self.store = store
        self.timeout = timeout

    def _placement(self, namespace: str, pod_name: str,
                   deadline: float) -> Tuple[str, Dict[str, int]]:
        while time.monotonic() < deadline:
            pod = self.store.try_get(store_mod.PODS, namespace, pod_name)
            if pod is not None and pod.status.host:
                return pod.status.host, dict(pod.status.ports)
            time.sleep(0.05)
        raise TimeoutError(
            f"pod {namespace}/{pod_name} was not placed within "
            f"{self.timeout}s; cannot resolve its address")

    def resolve(self, pod: Pod, env: Dict[str, str]) -> Dict[str, str]:
        deadline = time.monotonic() + self.timeout
        out = dict(env)
        host_cache: Dict[str, Tuple[str, Dict[str, int]]] = {}

        def placement(hostname: str) -> Tuple[str, Dict[str, int]]:
            if hostname not in host_cache:
                ns, name = _dns_pod_name(hostname)
                host_cache[hostname] = self._placement(ns, name, deadline)
            return host_cache[hostname]

        # The torch.distributed rendezvous: MASTER_ADDR names process 0's
        # pod, which may not be the pod being started; its TCPStore
        # listens on the coordinator port the owning node published.
        hostname = env.get("MASTER_ADDR")
        if hostname:
            host, ports = placement(hostname)
            port = ports.get(COORDINATOR_PORT_NAME)
            if port is None:
                raise RuntimeError(
                    f"pod for {hostname} published no coordinator port")
            out["MASTER_ADDR"] = host
            out["MASTER_PORT"] = str(port)
        if env.get("TPUJOB_CLUSTER_SPEC"):
            out["TPUJOB_CLUSTER_SPEC"] = self._resolve_cluster_spec(
                env["TPUJOB_CLUSTER_SPEC"], placement)
        return out

    @staticmethod
    def _resolve_cluster_spec(raw: str, placement) -> str:
        """Rewrite the ps entries to published placements — the
        addresses tasks dial through the cluster spec (train/ps.py ps
        servers bind, workers' PSClient connects). Each claimed pod
        publishes one free port under the coordinator name
        (agent claim path); ps pods repurpose it as their serving port,
        so the same record resolves both sides. Other roles' entries
        stay DNS-named (identity, not dialed through the spec)."""
        import json as _json

        try:
            spec = _json.loads(raw)
        except ValueError:
            return raw
        cluster = spec.get("cluster") or {}
        if not cluster.get("ps"):
            return raw
        resolved = []
        for entry in cluster["ps"]:
            hostname = entry.rsplit(":", 1)[0]
            host, ports = placement(hostname)
            port = ports.get(COORDINATOR_PORT_NAME)
            if port is None:
                raise RuntimeError(
                    f"ps pod for {hostname} published no port")
            resolved.append(f"{host}:{port}")
        cluster["ps"] = resolved
        spec["cluster"] = cluster
        return _json.dumps(spec, sort_keys=True)


class _LogHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    agent: "NodeAgent"

    def log_message(self, fmt, *args):
        log.debug("%s %s", self.address_string(), fmt % args)

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = urllib.parse.parse_qs(parsed.query)
        # Capability-URL auth: the random path prefix is only published
        # in node.status.log_url behind the AUTHENTICATED control
        # plane, so direct unauthenticated reads from the network get
        # 404 (and learn nothing). hmac.compare_digest: no timing
        # oracle on the secret.
        import hmac

        if (len(parts) != 4 or parts[1] != "logs"
                or not hmac.compare_digest(parts[0],
                                           self.agent.log_secret)):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        ns, name = parts[2], parts[3]
        follow = (query.get("follow") or ["0"])[0] not in ("", "0", "false")
        tail = (query.get("tailLines") or [None])[0]
        try:
            self._serve(ns, name, follow, tail)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def _serve(self, ns: str, name: str, follow: bool,
               tail: Optional[str]) -> None:
        path = self.agent.log_path_for(ns, name)
        if path is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if not follow:
            try:
                with open(path, "rb") as f:
                    text = f.read()
            except OSError:
                text = b""
            if tail is not None:
                lines = text.splitlines()[-max(0, int(tail)):]
                text = b"\n".join(lines)
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
            return
        # follow: stream appended bytes until the pod reaches a terminal
        # phase AND the file is drained (kubectl logs -f semantics).
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Connection", "close")
        self.end_headers()
        pos = 0
        while True:
            chunk = b""
            try:
                with open(path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read(65536)
            except OSError:
                pass
            if chunk:
                pos += len(chunk)
                self.wfile.write(chunk)
                self.wfile.flush()
                continue
            if self.agent.pod_finished(ns, name):
                return
            time.sleep(0.05)


class NodeAgent:
    def __init__(self, server_url: str, name: Optional[str] = None,
                 address: str = "127.0.0.1", chips: int = 0,
                 workdir: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 log_port: int = 0,
                 resolve_timeout: float = RESOLVE_TIMEOUT_SECONDS,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 insecure_skip_verify: bool = False):
        self.store = RemoteStore(server_url, token=token, ca_file=ca_file,
                                 insecure_skip_verify=insecure_skip_verify)
        self.name = name or f"node-{socket.gethostname()}-{os.getpid()}"
        self.address = address
        self.chips = chips
        self.backend = LocalProcessBackend(
            self.store, workdir=workdir, extra_env=extra_env,
            resolver=ControlPlaneEnvResolver(self.store,
                                             timeout=resolve_timeout),
            pod_filter=lambda pod: pod.spec.node_name == self.name,
            chips=chips)
        # Random capability prefix for the log server: only readers of
        # node.status.log_url (behind the authed control plane) can
        # construct valid log URLs — a bare network peer hitting the
        # port gets 404s. Rotates every agent restart.
        import secrets

        self.log_secret = secrets.token_urlsafe(16)
        handler = type("BoundLogHandler", (_LogHandler,), {"agent": self})
        self._log_httpd = ThreadingHTTPServer(("0.0.0.0", log_port), handler)
        self._log_httpd.daemon_threads = True
        self._threads: list = []
        self._claim_watcher = None
        self._stopped = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    @property
    def log_url(self) -> str:
        port = self._log_httpd.server_address[1]
        return f"http://{self.address}:{port}/{self.log_secret}"

    def start(self) -> "NodeAgent":
        self._register_node()
        t = threading.Thread(target=self._log_httpd.serve_forever,
                             name="agent-logs", daemon=True)
        t.start()
        self._threads.append(t)
        hb = threading.Thread(target=self._heartbeat_loop,
                              name="agent-heartbeat", daemon=True)
        hb.start()
        self._threads.append(hb)
        # Claim watcher first so pods get bound, then the backend (which
        # only reacts to pods already bound to this node).
        self._claim_watcher = self.store.watch(store_mod.PODS,
                                               self._on_pod_event)
        self.backend.start()
        log.info("node agent %s up (address=%s, logs=%s)",
                 self.name, self.address, self.log_url)
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._claim_watcher is not None:
            self._claim_watcher.stop()
        self.backend.stop()
        self.store.stop_watchers()
        self._log_httpd.shutdown()
        self._log_httpd.server_close()

    def _register_node(self) -> None:
        cpu, mem = _host_allocatable()
        node = Node(spec=NodeSpec(address=self.address, chips=self.chips),
                    status=NodeStatus(last_heartbeat=_now(),
                                      log_url=self.log_url,
                                      allocatable_cpu_millis=cpu,
                                      allocatable_memory_bytes=mem))
        node.metadata.name = self.name
        node.metadata.namespace = "default"

        def _register():
            existing = self.store.try_get(store_mod.NODES, "default",
                                          self.name)
            if existing is None:
                self.store.create(store_mod.NODES, node)
            else:
                node.metadata.resource_version = \
                    existing.metadata.resource_version
                self.store.update(store_mod.NODES, node)

        # Registration must survive a control-plane blip at agent boot:
        # without a Node record no pod ever lands here. Conflicts
        # (another register racing our read) retry through the re-read.
        retry_mod.with_retries(
            _register, policy=retry_mod.CLIENT_POLICY,
            component="agent.register",
            retryable=lambda e: (retry_mod.is_transient(e)
                                 or isinstance(e, (store_mod.ConflictError,
                                                   store_mod.AlreadyExistsError))))

    def _heartbeat_once(self) -> bool:
        def _beat():
            node = self.store.get(store_mod.NODES, "default", self.name)
            node.status.last_heartbeat = _now()
            node.status.log_url = self.log_url
            self.store.update_status(store_mod.NODES, node)

        try:
            retry_mod.with_retries(
                _beat, component="agent.heartbeat",
                retryable=lambda e: (retry_mod.is_transient(e)
                                     or isinstance(e,
                                                   store_mod.ConflictError)))
        except store_mod.NotFoundError:
            # The control plane restarted and lost our Node (or an
            # operator GC'd it): re-register instead of heartbeating
            # into the void forever.
            try:
                self._register_node()
            except Exception:
                log.warning("node re-registration failed", exc_info=True)
                return False
        except Exception:
            log.warning("heartbeat failed; node %s will look stale until "
                        "one lands", self.name, exc_info=True)
            return False
        metrics.node_agent_heartbeats.inc(node=self.name)
        return True

    def _heartbeat_loop(self) -> None:
        while not self._stopped.wait(HEARTBEAT_SECONDS):
            self._heartbeat_once()

    # -- claiming ----------------------------------------------------------

    def _on_pod_event(self, event_type: str, pod: Pod) -> None:
        if self._stopped.is_set() or event_type not in (ADDED, MODIFIED):
            return
        if pod.spec.node_name:
            return  # already bound (possibly to us; backend handles it)
        threading.Thread(target=self._claim, args=(pod,),
                         daemon=True).start()

    def _claim(self, pod: Pod) -> None:
        """Bind an unscheduled pod to this node and publish its placement
        (address + allocated coordinator port) in one CAS update."""
        fresh = self.store.try_get(store_mod.PODS, pod.metadata.namespace,
                                   pod.metadata.name)
        if fresh is None or fresh.spec.node_name:
            return
        fresh.spec.node_name = self.name
        fresh.status.host = self.address
        fresh.status.ports = {COORDINATOR_PORT_NAME: _free_port()}
        try:
            # Transient API blips retry in place (a claim lost to a 500
            # is a pod nobody runs until the next watch event); Conflict
            # and NotFound stay semantic — another agent won, or the pod
            # vanished.
            retry_mod.with_retries(
                lambda: self.store.update(store_mod.PODS, fresh),
                component="agent.claim")
        except (store_mod.ConflictError, store_mod.NotFoundError):
            return
        except Exception:
            log.warning("claim of pod %s/%s failed after retries",
                        pod.metadata.namespace, pod.metadata.name,
                        exc_info=True)
            return
        log.info("claimed pod %s/%s", pod.metadata.namespace,
                 pod.metadata.name)

    # -- log server support ------------------------------------------------

    def log_path_for(self, namespace: str, name: str) -> Optional[str]:
        pod = self.store.try_get(store_mod.PODS, namespace, name)
        if pod is None:
            return None
        # Prefer the published status path (covers finished pods); fall
        # back to the deterministic path for pods that just started.
        if pod.status.log_path:
            return pod.status.log_path
        return self.backend.pod_log_path(pod)

    def pod_finished(self, namespace: str, name: str) -> bool:
        from tf_operator_tpu_torch.api.types import PodPhase

        pod = self.store.try_get(store_mod.PODS, namespace, name)
        return pod is None or pod.status.phase in (PodPhase.SUCCEEDED,
                                                   PodPhase.FAILED)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _host_allocatable() -> Tuple[Optional[int], Optional[int]]:
    """Best-effort host inventory (cpu millis, memory bytes) for the
    registered NodeStatus — the kubelet-allocatable analog the binder's
    fit filters consume. None (not 0) when the host doesn't expose it:
    unreported capacity must skip the fit check, not fail it."""
    cpu = os.cpu_count()
    cpu_millis = cpu * 1000 if cpu else None
    mem_bytes: Optional[int] = None
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page_size > 0:
            mem_bytes = pages * page_size
    except (ValueError, OSError, AttributeError):
        pass
    return cpu_millis, mem_bytes


def main(argv=None) -> int:
    from tf_operator_tpu_torch.runtime.logconfig import setup_logging

    parser = argparse.ArgumentParser(prog="tpu-node-agent")
    parser.add_argument("--server", required=True,
                        help="operator API server URL, e.g. http://op:8080")
    parser.add_argument("--name", default=None)
    parser.add_argument("--address", default="127.0.0.1",
                        help="address peers use to reach pods on this node")
    parser.add_argument("--chips", type=int, default=0,
                        help="GPUs this node offers: Node.spec.chips, "
                             "the nvidia.com/gpu inventory the gang "
                             "binder counts; each pod is given its own "
                             "of them as CUDA_VISIBLE_DEVICES (those of "
                             "this process's CUDA_VISIBLE_DEVICES where "
                             "it is set, else 0..chips-1)")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--log-port", type=int, default=0)
    parser.add_argument("--extra-env", default="",
                        help="JSON object of extra env for every pod")
    parser.add_argument("--token", default=None,
                        help="bearer token for the API server (admin "
                             "role: agents write pod/node state); "
                             "default $TPU_OPERATOR_TOKEN")
    parser.add_argument("--token-file", default=None,
                        help="read the bearer token from this file "
                             "(first line; wins over --token)")
    parser.add_argument("--ca-cert", default=None,
                        help="CA bundle to verify the API server's TLS "
                             "certificate (self-signed bootstrap)")
    parser.add_argument("--insecure-skip-tls-verify", action="store_true",
                        help="skip TLS verification (test/dev only)")
    parser.add_argument("--json-log-format", dest="json_log", default=True,
                        action=argparse.BooleanOptionalAction)
    args = parser.parse_args(argv)
    setup_logging(json_format=args.json_log)

    token = args.token or os.environ.get("TPU_OPERATOR_TOKEN") or None
    if args.token_file:
        from tf_operator_tpu_torch.runtime.tlsutil import read_token

        token = read_token(args.token_file)
    extra_env = json.loads(args.extra_env) if args.extra_env else None
    agent = NodeAgent(args.server, name=args.name, address=args.address,
                      chips=args.chips, workdir=args.workdir,
                      extra_env=extra_env, log_port=args.log_port,
                      token=token, ca_file=args.ca_cert,
                      insecure_skip_verify=args.insecure_skip_tls_verify)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    agent.start()
    stop.wait()
    agent.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
