"""Kube node agent: the DaemonSet half of checkpoint coordination (port
of tf_operator_tpu/runtime/nodeagent.py over the port's relay, retry and
trace; it imports no torch).

On ``--backend kube`` the kubelet runs the containers, so the operator
has no process-level channel to the worker: a preemption notice stamped
on a pod (controller/ckpt.py save-before-evict barrier) is just an
annotation, and the worker's checkpoint state file is just a file on
some node. This agent — deployed as a DaemonSet
(manifests/gpu/node-agent.yaml) with the node's relay directory
hostPath-mounted — closes that loop per node, the same loop
``LocalProcessBackend`` runs for its subprocesses and
``runtime/agent.py`` runs for the served plane (both through
runtime/relay.py, so the three planes share one contract):

- **Notice relay (control plane -> worker)**: watches the pods bound to
  THIS node (name from the downward API, ``NODE_NAME`` fieldRef
  ``spec.nodeName``); when the operator stamps the
  ``tpu-operator.dev/preemption-notice`` annotation, the agent writes
  the notice atomically to the pod's ``TPUJOB_PREEMPT_FILE`` path in
  the shared relay volume, where the training loop polls it each step.
- **Checkpoint mirror (worker -> control plane)**: polls each relayed
  pod's ``TPUJOB_CKPT_FILE``; on change, PATCHes the payload onto the
  pod as the ``tpu-operator.dev/ckpt-state`` annotation. The operator's
  relay watcher (KubeOperator) converts that into the in-memory
  ``CheckpointRecord`` that barrier accounting and restore-step
  derivation consume — pod annotations are the status channel, exactly
  like kubelet phase reports.
- **Liveness**: heartbeats the ``tpu-operator.dev/agent-heartbeat``
  annotation onto its Node. The operator treats a gang as
  barrier-capable only while every hosting node's heartbeat is fresh;
  no agent (or a dead one) means barriers degrade to plain eviction
  instead of hanging a drain on acks that can never arrive.

All API writes go through ``runtime/retry.py`` ``with_retries`` —
apiserver blips back off and retry in place; only exhausted retries
surface as ``node_agent_relay_errors_total`` and are re-attempted on
the next poll tick. Nothing here kills a loop thread.

Run as: ``python -m tf_operator_tpu_torch.runtime.nodeagent --node $NODE_NAME``.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import logging
import os
import signal
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import Pod
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import relay as relay_mod
from tf_operator_tpu_torch.runtime import retry as retry_mod
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.kube import KubeClient, KubeConfig, KubeInformer
from tf_operator_tpu_torch.runtime.store import DELETED, Store

log = logging.getLogger("tpu_operator.nodeagent")

HEARTBEAT_SECONDS = 5.0
CKPT_POLL_SECONDS = 0.5

DEFAULT_RELAY_DIR = "/var/run/tpu-operator/relay"


@dataclass
class _RelayedPod:
    """Per-pod relay state. ``notice_written`` and ``ckpt_sent`` are
    dedup markers (each notice hits the file once, each ckpt payload
    hits the apiserver once); ``ckpt_mtime`` is the worker file's last
    fully-parsed st_mtime_ns."""

    pod: Pod
    notice_written: str = ""
    ckpt_mtime: int = 0
    ckpt_sent: str = ""


class KubeNodeAgent:
    """The per-node relay daemon (see module docstring). Owns a private
    Store fed by one pods informer — the same reflector machinery the
    operator uses, so apiserver hiccups get list/watch backoff for
    free."""

    def __init__(self, client: KubeClient, node_name: str, relay_dir: str,
                 namespace: Optional[str] = None,
                 heartbeat_seconds: float = HEARTBEAT_SECONDS,
                 ckpt_poll_seconds: float = CKPT_POLL_SECONDS):
        if not node_name:
            raise ValueError(
                "node agent needs its node name (downward-API NODE_NAME "
                "fieldRef spec.nodeName in the DaemonSet manifest)")
        self.client = client
        self.node = node_name
        self.relay_dir = relay_dir
        self.heartbeat_seconds = heartbeat_seconds
        self.ckpt_poll_seconds = ckpt_poll_seconds
        self.store = Store()
        # namespace=None watches all namespaces (DaemonSet semantics:
        # any tenant's pod can land on this node).
        self._informer = KubeInformer(client, self.store, store_mod.PODS,
                                      namespace=namespace)
        self._pods: Dict[Tuple[str, str], _RelayedPod] = {}
        self._lock = threading.Lock()
        self._watcher = None
        self._threads: list = []
        self._stopped = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "KubeNodeAgent":
        # First heartbeat before anything else: the operator's
        # barrier-capability gate reads it, and a gang must not sit in a
        # barrier it could have started acking.
        self._heartbeat_once()
        self._watcher = self.store.watch(store_mod.PODS, self._on_pod_event)
        self._informer.start()
        for name, target in (("nodeagent-heartbeat", self._heartbeat_loop),
                             ("nodeagent-ckpt-poll", self._poll_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        log.info("kube node agent up on node %s (relay dir %s)",
                 self.node, self.relay_dir)
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._watcher is not None:
            self._watcher.stop()
        self._informer.stop()
        self.store.stop_watchers()
        for t in self._threads:
            t.join(timeout=5)

    # -- heartbeat ---------------------------------------------------------

    def _heartbeat_once(self) -> bool:
        stamp = _now().isoformat()

        def _patch():
            self.client.patch(
                store_mod.NODES, "", self.node,
                {"metadata": {"annotations": {
                    constants.ANNOTATION_AGENT_HEARTBEAT: stamp}}})

        try:
            retry_mod.with_retries(_patch, component="nodeagent.heartbeat")
        except Exception:
            log.warning("heartbeat for node %s failed; gangs on this node "
                        "are not barrier-capable until one lands",
                        self.node, exc_info=True)
            return False
        metrics.node_agent_heartbeats.inc(node=self.node)
        return True

    def _heartbeat_loop(self) -> None:
        while not self._stopped.wait(self.heartbeat_seconds):
            self._heartbeat_once()

    # -- notice relay (annotation -> file) ---------------------------------

    def _on_pod_event(self, event_type: str, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        if event_type == DELETED:
            with self._lock:
                rp = self._pods.pop(key, None)
            # Relay files follow the pod object (kubelet log-retention
            # semantics); the dead incarnation's notice must not be
            # readable by a restart-with-identity successor.
            relay_mod.cleanup(self.relay_dir, rp.pod if rp else pod)
            return
        if pod.spec.node_name != self.node or not pod.spec.relay_dir:
            return
        with self._lock:
            rp = self._pods.get(key)
            if rp is None:
                rp = self._pods[key] = _RelayedPod(pod=pod)
            else:
                rp.pod = pod
        self._forward_notice(rp)

    def _forward_notice(self, rp: _RelayedPod) -> None:
        pod = rp.pod
        notice = pod.metadata.annotations.get(
            constants.ANNOTATION_PREEMPT_NOTICE, "")
        if not notice or rp.notice_written == notice:
            return
        with trace_mod.span(
                "nodeagent.notice_relay",
                pod=f"{pod.metadata.namespace}/{pod.metadata.name}"):
            try:
                rp.notice_written = retry_mod.with_retries(
                    lambda: relay_mod.forward_notice(
                        self.relay_dir, pod, notice, rp.notice_written),
                    component="nodeagent.notice")
            except OSError:
                metrics.node_agent_relay_errors.inc(kind="notice_write")
                log.warning("notice write for pod %s/%s failed; retrying "
                            "on the next poll", pod.metadata.namespace,
                            pod.metadata.name, exc_info=True)

    # -- checkpoint mirror (file -> annotation) ----------------------------

    def _poll_loop(self) -> None:
        while not self._stopped.wait(self.ckpt_poll_seconds):
            with self._lock:
                relayed = list(self._pods.values())
            for rp in relayed:
                # Notices retry here too: an annotation that arrived
                # while the volume was unwritable would otherwise wait
                # for a MODIFIED event that may never refire.
                self._forward_notice(rp)
                self._mirror_ckpt(rp)

    def _mirror_ckpt(self, rp: _RelayedPod) -> None:
        pod = rp.pod
        data, rp.ckpt_mtime = relay_mod.read_ckpt_file(
            relay_mod.ckpt_path(self.relay_dir, pod), rp.ckpt_mtime)
        if data is None:
            return
        payload = json.dumps(data, sort_keys=True)
        if payload == rp.ckpt_sent:
            return
        with trace_mod.span(
                "nodeagent.ckpt_relay",
                pod=f"{pod.metadata.namespace}/{pod.metadata.name}",
                step=data.get("step")):
            try:
                retry_mod.with_retries(
                    lambda: self.client.patch(
                        store_mod.PODS, pod.metadata.namespace,
                        pod.metadata.name,
                        {"metadata": {"annotations": {
                            constants.ANNOTATION_CKPT_STATE: payload}}}),
                    component="nodeagent.ckpt")
            except store_mod.NotFoundError:
                return  # pod vanished; DELETED cleanup is in flight
            except Exception:
                metrics.node_agent_relay_errors.inc(kind="ckpt_patch")
                # Rewind so the next tick re-reads and re-sends — a
                # barrier ack must not be lost to one bad PATCH.
                rp.ckpt_mtime = 0
                log.warning("ckpt-state patch for pod %s/%s failed; will "
                            "re-mirror", pod.metadata.namespace,
                            pod.metadata.name, exc_info=True)
                return
        rp.ckpt_sent = payload


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def main(argv=None) -> int:
    from tf_operator_tpu_torch.runtime.logconfig import setup_logging

    parser = argparse.ArgumentParser(prog="tpu-node-agent-kube")
    parser.add_argument("--node", default=os.environ.get("NODE_NAME", ""),
                        help="this node's name (default $NODE_NAME, the "
                             "DaemonSet downward-API fieldRef)")
    parser.add_argument("--relay-dir",
                        default=os.environ.get("TPU_OPERATOR_RELAY_DIR",
                                               DEFAULT_RELAY_DIR),
                        help="hostPath directory shared with workload "
                             "pods (must match the operator's "
                             "--agent-relay-dir)")
    parser.add_argument("--server", default="",
                        help="apiserver URL override (tests/dev; "
                             "production resolves in-cluster config)")
    parser.add_argument("--kubeconfig", default=None,
                        help="kubeconfig path when not in-cluster")
    parser.add_argument("--namespace", default=None,
                        help="restrict the pod watch to one namespace "
                             "(default: all)")
    parser.add_argument("--heartbeat-seconds", type=float,
                        default=HEARTBEAT_SECONDS)
    parser.add_argument("--ckpt-poll-seconds", type=float,
                        default=CKPT_POLL_SECONDS)
    parser.add_argument("--json-log-format", dest="json_log", default=True,
                        action=argparse.BooleanOptionalAction)
    args = parser.parse_args(argv)
    setup_logging(json_format=args.json_log)

    if args.server:
        config = KubeConfig(server=args.server)
    else:
        config = KubeConfig.resolve(args.kubeconfig)
    agent = KubeNodeAgent(KubeClient(config), args.node, args.relay_dir,
                          namespace=args.namespace,
                          heartbeat_seconds=args.heartbeat_seconds,
                          ckpt_poll_seconds=args.ckpt_poll_seconds)
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
