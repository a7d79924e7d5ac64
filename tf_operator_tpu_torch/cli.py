"""Operator CLI: ``python -m tf_operator_tpu_torch`` — the process
entrypoint (port of tf_operator_tpu/cli.py; ``--backend kube`` runs
``runtime/kube.py``'s ``KubeOperator`` over ``GPUJobController``).

Reference parity: cmd/tf-operator.v1/main.go (flag parse, JSON logging,
monitoring endpoint, version print) + app/options/options.go:53-83 (the
flag surface) + app/server.go:72-196 (signal handling, leader election
wrapping the controller run).

Flag mapping (reference flag → here):
  -namespace               → --namespace
  -threadiness             → --threadiness
  -version                 → --version
  -json-log-format         → --json-log-format (default true, as reference)
  -enable-gang-scheduling  → --enable-gang-scheduling
  -monitoring-port         → --monitoring-port (default 8443)
  -kube-api-qps/burst      → n/a (no remote API server in the local
                             runtime; the K8s backend would add them)
  -resync-period           → --resync-period (idle re-enqueue of all jobs)
  -enable-leader-election  → --leader-elect / --no-leader-elect
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import sys
import threading
from typing import List, Optional

from tf_operator_tpu_torch.operator import Operator
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.leaderelection import LeaderElector
from tf_operator_tpu_torch.runtime.logconfig import setup_logging
from tf_operator_tpu_torch.runtime.monitoring import MonitoringServer
from tf_operator_tpu_torch.version import version_string

log = logging.getLogger("tpu_operator.cli")

# Reference leader-election cadence (app/server.go:56-59).
LEASE_DURATION = 15.0
RENEW_DEADLINE = 5.0
RETRY_PERIOD = 3.0


def parse_int_map(value) -> dict:
    """Parse 'name=int,name=int' flag values into a Dict[str, int].

    argparse ``type=`` for --gang-priority-classes / --gang-queue-quotas
    (reference analog: Volcano priorityClass/queue config maps). Empty
    string → empty map; dicts pass through so Server(args) also accepts
    hand-built Namespaces. ArgumentTypeError messages omit the flag name
    — argparse prefixes it ('argument --gang-…: …').
    """
    if isinstance(value, dict):
        return dict(value)
    result: dict = {}
    if not value or not value.strip():
        return result
    for entry in value.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, num = entry.partition("=")
        name = name.strip()
        if not sep or not name:
            raise argparse.ArgumentTypeError(
                f"malformed entry {entry!r}; expected 'name=int,name=int'")
        try:
            result[name] = int(num.strip())
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"value for {name!r} is not an integer: "
                f"{num.strip()!r}") from None
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-operator-torch",
        description="GPU distributed-job operator (the PyTorch/CUDA port)")
    p.add_argument("--namespace", default=os.environ.get(
        "TPU_OPERATOR_NAMESPACE", ""),
        help="watch a single namespace ('' = all namespaces)")
    p.add_argument("--threadiness", type=int, default=4,
                   help="number of concurrent sync workers (per-key "
                        "serialization in the workqueue keeps parallel "
                        "syncs safe; one job is never synced twice "
                        "concurrently)")
    p.add_argument("--version", action="store_true",
                   help="print version and exit")
    p.add_argument("--json-log-format", dest="json_log", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="structured JSON logs (default on)")
    p.add_argument("--enable-gang-scheduling", action="store_true",
                   help="gate pods behind all-or-nothing SliceGroup admission")
    p.add_argument("--total-chips", type=int, default=None,
                   help="chip capacity for gang admission (None = unlimited)")
    p.add_argument("--gang-fairness", default="aged",
                   choices=("backfill", "strict", "aged"),
                   help="admission policy when the FIFO head doesn't "
                        "fit: backfill past it, strict head-of-line, or "
                        "aged (backfill until --gang-aging-seconds, then "
                        "hold capacity for the starved group)")
    p.add_argument("--gang-aging-seconds", type=float, default=300.0,
                   help="wait before an unadmitted group blocks backfill "
                        "(only with --gang-fairness aged)")
    p.add_argument("--gang-priority-classes", default="",
                   type=parse_int_map,
                   help="priorityClass name=value map for gang admission "
                        "ordering, e.g. 'prod=100,batch=10' (numeric "
                        "class names need no entry)")
    p.add_argument("--gang-queue-quotas", default="",
                   type=parse_int_map,
                   help="per-queue chip caps for gang admission, e.g. "
                        "'prod=32,batch=16' (queues without an entry "
                        "share the global capacity)")
    p.add_argument("--gang-preemption", action="store_true",
                   help="let higher-priority groups evict admitted-but-"
                        "not-yet-running lower-priority groups")
    p.add_argument("--enable-tenant-queues", action="store_true",
                   help="run multi-tenant quota admission above gang "
                        "scheduling (requires --enable-gang-scheduling): "
                        "jobs reference a TenantQueue via spec.queueName; "
                        "ClusterQueues carry nominal chip quotas, cohort "
                        "borrowing, and reclaim (docs/quota.md). Off = "
                        "admission behavior identical to today")
    p.add_argument("--enable-elastic", action="store_true",
                   help="run the elastic resize pass (requires "
                        "--enable-gang-scheduling): gangs whose "
                        "spec.slice declares minSlices/maxSlices are "
                        "grown into idle capacity and shrunk — instead "
                        "of displaced — under quota reclaim or "
                        "maintenance pressure, riding the world-resize "
                        "restart with a resharded checkpoint restore "
                        "(docs/elastic.md). Off = resize behavior "
                        "identical to today")
    p.add_argument("--enable-ckpt-coordination", action="store_true",
                   help="run the CheckpointCoordinator: planned "
                        "disruptions (slice-health drains, quota "
                        "reclaims) of jobs whose runPolicy."
                        "checkpointPolicy opts in become save-then-"
                        "evict barriers, and rebinds restore from the "
                        "barrier-committed step (docs/checkpoint.md). "
                        "Off = eviction behavior identical to today")
    p.add_argument("--enable-serving", action="store_true",
                   help="wire the serving plane: jobs may declare a "
                        "'serving' replica role whose pods get the "
                        "runPolicy.servingPolicy knobs and per-tenant "
                        "QoS lane weights rendered into their env "
                        "(docs/serving.md); drains of serving gangs "
                        "ride the save-before-evict barrier so "
                        "in-flight requests re-queue instead of "
                        "dropping. Off = the serving role is inert "
                        "(controller behavior identical to today)")
    p.add_argument("--enable-serving-autoscaler", action="store_true",
                   help="run the serving replica autoscaler (requires "
                        "--enable-serving and --enable-elastic): elastic "
                        "serving gangs whose servingPolicy sets "
                        "targetQueueDepthPerSlice are resized to track "
                        "request backlog and TTFT-SLO burn — scale-up "
                        "immediate, scale-down after servingPolicy."
                        "scaleDownCooldownSeconds of continuous under-"
                        "demand (docs/serving.md). Off = serving gangs "
                        "keep their declared numSlices")
    p.add_argument("--autoscale-interval-seconds", type=float,
                   default=1.0,
                   help="seconds between serving-autoscaler policy "
                        "passes")
    p.add_argument("--enable-serving-gateway", action="store_true",
                   help="serve the HTTP front door over a request spool "
                        "in this process (serve/gateway.py; any backend "
                        "— it only touches the spool filesystem): "
                        "admission with per-tenant auth tokens, 429 + "
                        "Retry-After backpressure at maxQueueDepth, "
                        "streaming NDJSON responses (docs/serving.md). "
                        "Also runs standalone: python -m "
                        "tf_operator_tpu_torch.serve.gateway")
    p.add_argument("--gateway-port", type=int, default=8600,
                   help="listen port for --enable-serving-gateway "
                        "(0 = ephemeral)")
    p.add_argument("--gateway-host", default="127.0.0.1",
                   help="bind address for --enable-serving-gateway")
    p.add_argument("--gateway-spool", default=None,
                   help="request spool root the gateway fronts (the "
                        "serving job's servingPolicy.spoolDirectory)")
    p.add_argument("--gateway-tokens", default=None,
                   help="'token=tenant,token=tenant' auth map for the "
                        "gateway (default: TPUJOB_GATEWAY_TOKENS; empty "
                        "= open gateway, every request on the 'default' "
                        "QoS lane)")
    p.add_argument("--queue-config", default=None,
                   help="YAML/JSON file declaring clusterQueues / "
                        "tenantQueues to seed at startup (see "
                        "docs/quota.md for the format); queues can also "
                        "be created live through the served API")
    p.add_argument("--agent-relay-dir",
                   default="/var/run/tpu-operator/relay",
                   help="(kube backend) hostPath directory shared "
                        "between workload pods and the node-agent "
                        "DaemonSet (docs/node-agent.md): checkpoint-"
                        "coordinated and serving pods get it mounted "
                        "and their TPUJOB_PREEMPT_FILE/TPUJOB_CKPT_FILE "
                        "paths rendered inside it; must match the "
                        "agents' --relay-dir. Empty disables relay "
                        "rendering (barriers degrade to plain eviction)")
    p.add_argument("--gang-binder", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="(kube backend) run the in-operator slice-gang "
                        "pod binder: admitted gang pods are placed "
                        "topology-aware onto nodes by the operator "
                        "itself — no external Volcano-class scheduler. "
                        "--no-gang-binder reverts to stamping "
                        "schedulerName only (an external gang scheduler "
                        "must then bind). NOTE: node-derived admission "
                        "capacity assumes a SINGLE-TENANT cluster — "
                        "chips held by pods outside the operator's "
                        "bookkeeping (foreign controllers, other "
                        "namespaces when --namespace is set) are "
                        "invisible to gang admission (docs/health.md)")
    p.add_argument("--enable-slice-health", dest="slice_health",
                   default=True, action=argparse.BooleanOptionalAction,
                   help="run the slice-health controller: cordon nodes "
                        "on maintenance/preemption notices and, for "
                        "jobs whose runPolicy.healthPolicy opts in, "
                        "atomically drain affected gangs and rebind "
                        "them on spare capacity (docs/health.md). "
                        "Takes effect on the kube backend with the "
                        "gang binder, and on the local/served backends "
                        "with --enable-gang-scheduling")
    p.add_argument("--degraded-after-seconds", type=float, default=10.0,
                   help="enter degraded mode after the API server has "
                        "been failing this long (plus 5 consecutive "
                        "failures): reconciling continues but new "
                        "drains/reclaims/preemptions are deferred and "
                        "jobs carry a ControlPlaneDegraded condition "
                        "until it recovers (docs/robustness.md)")
    p.add_argument("--health-drain-grace-seconds", type=float,
                   default=0.0,
                   help="operator-wide default for the observed-"
                        "degraded to gang-evict delay (a checkpoint "
                        "window); a job's healthPolicy."
                        "drainGraceSeconds overrides it")
    p.add_argument("--monitoring-port", type=int, default=8443,
                   help="port for /metrics, /healthz, /debug/traces, "
                        "/debug/jobs/<ns>/<name> "
                        "(0 = disabled, -1 = ephemeral)")
    p.add_argument("--monitoring-host", default="127.0.0.1")
    p.add_argument("--enable-tracing", action="store_true",
                   help="record reconcile-path spans into the flight "
                        "recorder: /debug/traces serves the slowest/"
                        "errored/sampled sync traces and per-phase "
                        "totals (docs/observability.md). Off = the "
                        "span API is a shared no-op (near-zero cost); "
                        "/debug/traces stays served but empty. The "
                        "per-job decision journal at /debug/jobs/... "
                        "is always on")
    p.add_argument("--trace-file", default=None,
                   help="(with --enable-tracing) append every completed "
                        "trace as one JSON line to this file — the "
                        "offline counterpart of /debug/traces "
                        "(docs/observability.md 'Trace-file format')")
    p.add_argument("--api-port", type=int, default=0,
                   help="serve the control-plane API on this port "
                        "(0 = disabled, -1 = ephemeral); remote SDK "
                        "clients and node agents connect here")
    p.add_argument("--api-host", default="127.0.0.1",
                   help="bind address for the control-plane API")
    p.add_argument("--api-tokens-file", default=None,
                   help="bearer-token file for the served API: one "
                        "'<token> [role]' per line, role admin "
                        "(default) or read-only. Without it, a "
                        "non-loopback --api-host rejects everything "
                        "but /healthz with 401 (see --api-insecure)")
    p.add_argument("--api-tls-cert", default=None,
                   help="TLS certificate (PEM) for the served API")
    p.add_argument("--api-tls-key", default=None,
                   help="TLS private key (PEM) for the served API")
    p.add_argument("--api-self-signed-tls-dir", default=None,
                   help="generate (once) and serve a self-signed TLS "
                        "cert/key pair under this directory — "
                        "first-run bootstrap; clients verify with the "
                        "generated cert.pem as --ca-cert")
    p.add_argument("--api-tls-san", default="",
                   help="comma-separated extra subject-alt-names "
                        "(DNS names or IPs) for the self-signed cert — "
                        "whatever remote clients will dial, e.g. "
                        "'operator.example.com,10.0.0.5'")
    p.add_argument("--api-insecure", action="store_true",
                   help="explicitly allow anonymous access to the "
                        "served API on a non-loopback bind (NOT for "
                        "production)")
    p.add_argument("--backend", choices=("local", "none", "kube"),
                   default="local",
                   help="data plane: 'local' runs pods as subprocesses "
                        "in this process; 'none' leaves pods to external "
                        "node agents (requires --api-port); 'kube' "
                        "reconciles TPUJob CRs / pods / services against "
                        "a Kubernetes API server (CRD from "
                        "manifests/gpu/crd.yaml must be installed)")
    p.add_argument("--kubeconfig", default=None,
                   help="kubeconfig path for --backend kube (default: "
                        "in-cluster config when available, else "
                        "$KUBECONFIG or ~/.kube/config)")
    p.add_argument("--kube-api-qps", type=float, default=5.0,
                   help="client-side request rate to the K8s API server "
                        "(reference --kube-api-qps; 0 = unlimited)")
    p.add_argument("--kube-api-burst", type=int, default=10,
                   help="token-bucket burst above --kube-api-qps "
                        "(reference --kube-api-burst)")
    p.add_argument("--resync-period", type=float, default=30.0,
                   help="idle full re-enqueue period in seconds (0 = off)")
    p.add_argument("--leader-elect", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="run leader election before reconciling")
    p.add_argument("--leader-elect-identity", default=None,
                   help="lease holder identity (default: generated)")
    p.add_argument("--shards", type=int, default=1,
                   help="shard the control plane across N leases "
                        "(tpu-operator-shard-<i>): jobs hash to a shard "
                        "by (namespace, uid) and each held shard runs a "
                        "full engine over only its jobs; replicas "
                        "contend per shard, so a killed holder's shards "
                        "fail over to survivors (docs/benchmarks.md). "
                        "1 = the classic singleton lease. Requires the "
                        "in-process store (local/none backends); with "
                        "--backend kube the informer cache is per-"
                        "replica, so shard ownership there must come "
                        "from N Lease objects in the cluster — not "
                        "wired yet (docs/robustness.md)")
    p.add_argument("--shard-index", type=int, default=None,
                   help="contend for ONLY this shard's lease instead of "
                        "all of them — one-shard-per-process "
                        "deployments (default: contend for every "
                        "shard)")
    return p


class Server:
    """Assembled operator process; separable from main() for tests."""

    def __init__(self, args: argparse.Namespace,
                 store: Optional[store_mod.Store] = None,
                 on_fatal=None):
        self.args = args
        # Called (from any thread) when the process must exit — main()
        # wires this to its stop event so shutdown runs on the main
        # thread, never on the elector's own thread.
        self.on_fatal = on_fatal
        self._lease_store = None
        # Flight recorder (runtime/trace.py): spans are process-global
        # like the metrics registry, so wiring happens at assembly, not
        # per subsystem. Off (the default) the span API is a shared
        # no-op object — no allocation on the reconcile hot path.
        from tf_operator_tpu_torch.runtime import trace as trace_lib

        trace_lib.configure(
            enabled=getattr(args, "enable_tracing", False),
            trace_file=getattr(args, "trace_file", None))
        gang_kwargs = dict(
            enable_gang_scheduling=args.enable_gang_scheduling,
            total_chips=args.total_chips,
            gang_fairness=args.gang_fairness,
            gang_aging_seconds=args.gang_aging_seconds,
            gang_priority_classes=parse_int_map(
                getattr(args, "gang_priority_classes", "")),
            gang_queue_quotas=parse_int_map(
                getattr(args, "gang_queue_quotas", "")),
            gang_preemption=getattr(args, "gang_preemption", False))
        tenant_kwargs = dict(
            enable_tenant_queues=getattr(args, "enable_tenant_queues",
                                         False),
            queue_config=getattr(args, "queue_config", None),
            enable_ckpt_coordination=getattr(
                args, "enable_ckpt_coordination", False),
            enable_serving=getattr(args, "enable_serving", False),
            enable_elastic=getattr(args, "enable_elastic", False),
            enable_serving_autoscaler=getattr(
                args, "enable_serving_autoscaler", False),
            autoscale_interval_seconds=getattr(
                args, "autoscale_interval_seconds", 1.0))
        if getattr(args, "backend", "local") == "kube":
            # Cluster mode: the Store is the informer cache inside
            # KubeOperator; reads/writes/leases go to the K8s API.
            from tf_operator_tpu_torch.runtime.kube import (
                KubeClient,
                KubeConfig,
                KubeLeaseStore,
                KubeOperator,
                check_crd_exists,
            )

            qps = getattr(args, "kube_api_qps", 5.0)
            client = KubeClient(
                KubeConfig.resolve(getattr(args, "kubeconfig", None)),
                qps=qps if qps and qps > 0 else None,
                burst=getattr(args, "kube_api_burst", 10))
            if not check_crd_exists(client):
                # Fail fast like the reference (server.go:124, 232-251).
                raise RuntimeError(
                    f"CRD not installed on {client.config.server}; apply "
                    "manifests/gpu/crd.yaml first")
            # Everything in tenant_kwargs except the elastic family is
            # lifted onto kube by the node-agent relay
            # (docs/node-agent.md); elastic — and the serving
            # autoscaler riding its resize pass — stays gated in
            # main().
            kube_tenant_kwargs = {k: v for k, v in tenant_kwargs.items()
                                  if k not in ("enable_elastic",
                                               "enable_serving_autoscaler",
                                               "autoscale_interval_seconds")}
            self.operator = KubeOperator(
                client,
                namespace=args.namespace or None,
                gang_binder=args.gang_binder,
                slice_health=getattr(args, "slice_health", True),
                health_drain_grace_seconds=getattr(
                    args, "health_drain_grace_seconds", 0.0),
                degraded_after_seconds=getattr(
                    args, "degraded_after_seconds", 10.0),
                relay_dir=getattr(args, "agent_relay_dir", ""),
                **gang_kwargs, **kube_tenant_kwargs)
            self.store = self.operator.store
            self._lease_store = KubeLeaseStore(client)
        else:
            self.store = store or store_mod.Store()
            op_kwargs = {}
            if getattr(args, "backend", "local") == "none":
                op_kwargs["backend"] = None
            shared_kwargs = dict(
                store=self.store,
                namespace=args.namespace or None,
                # Slice health needs gang displace/readmit to repair, so
                # the default-on flag only takes effect alongside gang
                # scheduling on the process-native backends (the kube
                # backend gates it on the binder the same way).
                enable_slice_health=(
                    getattr(args, "slice_health", True)
                    and args.enable_gang_scheduling),
                health_drain_grace_seconds=getattr(
                    args, "health_drain_grace_seconds", 0.0),
                degraded_after_seconds=getattr(
                    args, "degraded_after_seconds", 10.0),
                **gang_kwargs, **tenant_kwargs, **op_kwargs)
            shards = getattr(args, "shards", 1)
            if shards > 1:
                # N-leader mode: the per-shard leases ARE the leader
                # election, so the singleton elector below is skipped.
                from tf_operator_tpu_torch.operator import ShardedOperator

                self.operator = ShardedOperator(
                    shards,
                    identity=args.leader_elect_identity,
                    shard_index=getattr(args, "shard_index", None),
                    lease_duration=LEASE_DURATION,
                    renew_deadline=RENEW_DEADLINE,
                    retry_period=RETRY_PERIOD,
                    **shared_kwargs)
            else:
                self.operator = Operator(**shared_kwargs)
        self.api_server = None
        if getattr(args, "api_port", 0) != 0:
            from tf_operator_tpu_torch.runtime.apiserver import APIServer

            tls_cert = getattr(args, "api_tls_cert", None)
            tls_key = getattr(args, "api_tls_key", None)
            ss_dir = getattr(args, "api_self_signed_tls_dir", None)
            if ss_dir:
                from tf_operator_tpu_torch.runtime.tlsutil import (
                    ensure_self_signed,
                )

                tls_cert = os.path.join(ss_dir, "cert.pem")
                tls_key = os.path.join(ss_dir, "key.pem")
                import ipaddress as _ip

                dns = ["localhost", socket.gethostname()]
                ips = ["127.0.0.1"]
                if args.api_host not in ("0.0.0.0", "::", ""):
                    ips.append(args.api_host)
                for san in getattr(args, "api_tls_san", "").split(","):
                    san = san.strip()
                    if not san:
                        continue
                    try:
                        _ip.ip_address(san)
                        ips.append(san)
                    except ValueError:
                        dns.append(san)
                ensure_self_signed(tls_cert, tls_key, dns_names=dns,
                                   ip_addresses=ips)
            tokens = None
            if getattr(args, "api_tokens_file", None):
                from tf_operator_tpu_torch.runtime.tlsutil import load_tokens

                tokens = load_tokens(args.api_tokens_file)
            self.api_server = APIServer(
                self.store, host=args.api_host,
                port=max(args.api_port, 0),
                tls_cert=tls_cert, tls_key=tls_key, tokens=tokens,
                insecure=getattr(args, "api_insecure", False))
        self.gateway = None
        if getattr(args, "enable_serving_gateway", False):
            from tf_operator_tpu_torch.serve.gateway import (
                GatewayServer,
                parse_token_map,
            )

            raw_tokens = getattr(args, "gateway_tokens", None)
            if raw_tokens is None:
                raw_tokens = os.environ.get("TPUJOB_GATEWAY_TOKENS", "")
            self.gateway = GatewayServer(
                args.gateway_spool,
                port=max(getattr(args, "gateway_port", 8600), 0),
                host=getattr(args, "gateway_host", "127.0.0.1"),
                tokens=parse_token_map(raw_tokens))
        self.monitoring: Optional[MonitoringServer] = None
        if args.monitoring_port != 0:
            self.monitoring = MonitoringServer(
                port=max(args.monitoring_port, 0),
                host=args.monitoring_host)
        self.elector: Optional[LeaderElector] = None
        if args.leader_elect and getattr(args, "shards", 1) <= 1:
            self.elector = LeaderElector(
                self._lease_store or self.store,
                identity=args.leader_elect_identity,
                namespace=args.namespace or "default",
                lease_duration=LEASE_DURATION,
                renew_deadline=RENEW_DEADLINE,
                retry_period=RETRY_PERIOD,
                on_started_leading=self._start_reconciling,
                on_stopped_leading=self._lost_lease)
        self._stop = threading.Event()
        # Held across the check of _stop and operator.start, and by
        # every path that stops the operator: a lease won while this
        # replica shuts down starts nothing, and a start still syncing
        # informers finishes before the operator is stopped.
        self._reconcile_lock = threading.Lock()
        self._resync_thread: Optional[threading.Thread] = None

    def _start_reconciling(self) -> None:
        with self._reconcile_lock:
            if self._stop.is_set():
                return
            try:
                self.operator.start(threadiness=self.args.threadiness)
                failed = False
            except Exception:
                log.exception("operator failed to start; shutting down")
                failed = True
        if failed:
            # Runs on the elector's daemon thread: swallowing the failure
            # would leave a zombie leader renewing the lease while never
            # reconciling, blocking standby failover. Fatal instead.
            self._stop.set()
            if self.on_fatal is not None:
                self.on_fatal()
            else:
                threading.Thread(target=self.shutdown, name="shutdown",
                                 daemon=True).start()
            return
        if self.args.resync_period > 0:
            self._resync_thread = threading.Thread(
                target=self._resync_loop, name="resync", daemon=True)
            self._resync_thread.start()

    def _lost_lease(self) -> None:
        # The reference fatals on lost leadership (server.go:178-182): a
        # stale leader must not keep writing. Same policy. Runs on the
        # elector's thread: stop reconciling immediately, then hand the
        # full shutdown to the main thread (shutdown() joins the elector
        # thread, which must not join itself).
        log.error("leader lease lost; shutting down")
        self._stop.set()
        with self._reconcile_lock:
            self.operator.stop()
        if self.on_fatal is not None:
            self.on_fatal()
        else:
            threading.Thread(target=self.shutdown, name="shutdown",
                             daemon=True).start()

    def _resync_loop(self) -> None:
        """Level-triggered safety net: periodically re-enqueue every job
        in the watched scope (reference: 15s ReconcilerSyncLoopPeriod via
        informer resync)."""
        while not self._stop.wait(self.args.resync_period):
            if hasattr(self.operator, "resync"):
                # Sharded mode: route each job to its holding shard's
                # controller (frozen-snapshot walk, no deepcopies).
                self.operator.resync()
                continue
            for ns, name, _ in self.store.keys(store_mod.TPUJOBS):
                if self.args.namespace and ns != self.args.namespace:
                    continue
                self.operator.controller.enqueue(f"{ns}/{name}")

    def start(self) -> None:
        if self.api_server is not None:
            # The API serves reads/writes even before this replica leads
            # (the reference API server is always up; leadership only
            # gates reconciling).
            self.api_server.start()
            log.info("control-plane API on %s", self.api_server.url)
        if self.monitoring is not None:
            self.monitoring.start()
        if self.gateway is not None:
            # Data-plane adapter, not a control loop: up regardless of
            # leadership, like the API server.
            self.gateway.start()
            log.info("serving gateway on :%d", self.gateway.port)
        if self.elector is not None:
            self.elector.start()
        else:
            self._start_reconciling()

    def shutdown(self) -> None:
        self._stop.set()
        # The operator stops before the elector releases the lease, so a
        # standby that takes the released lease never reconciles beside
        # this replica's still-running controller.
        with self._reconcile_lock:
            self.operator.stop()
        if self.elector is not None:
            self.elector.stop()
        if self.api_server is not None:
            self.api_server.stop()
        if self.gateway is not None:
            self.gateway.stop()
        if self.monitoring is not None:
            self.monitoring.stop()


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        print(version_string())
        return 0
    if args.backend == "none" and args.api_port == 0:
        parser.error("--backend none needs --api-port: without a served "
                     "API no node agent can reach the control plane, so "
                     "pods would sit Pending forever")
    if args.enable_tenant_queues and not args.enable_gang_scheduling:
        parser.error("--enable-tenant-queues requires "
                     "--enable-gang-scheduling: tenant queues decide "
                     "WHICH gangs are quota-eligible; without gang "
                     "admission there is nothing to gate")
    if args.queue_config and not args.enable_tenant_queues:
        parser.error("--queue-config only makes sense with "
                     "--enable-tenant-queues")
    if args.enable_elastic and not args.enable_gang_scheduling:
        parser.error("--enable-elastic requires "
                     "--enable-gang-scheduling: the resize pass is a "
                     "gang-scheduler pass — without gang admission "
                     "there is no slice accounting to resize against")
    if args.enable_serving_autoscaler and not (args.enable_serving
                                               and args.enable_elastic):
        parser.error("--enable-serving-autoscaler requires "
                     "--enable-serving and --enable-elastic: the "
                     "autoscaler maps serving queue depth to elastic "
                     "gang resizes — without both there is nothing to "
                     "measure or to resize")
    if args.enable_serving_gateway and not args.gateway_spool:
        parser.error("--enable-serving-gateway needs --gateway-spool: "
                     "the gateway is an HTTP adapter over a request "
                     "spool (the serving job's servingPolicy."
                     "spoolDirectory; docs/serving.md)")
    if args.enable_elastic and args.backend == "kube":
        parser.error("--enable-elastic is not yet supported with "
                     "--backend kube: a world-resize restart rewrites "
                     "pod env in place, which the node agent relay "
                     "does not propagate to running containers yet "
                     "(docs/elastic.md Scope); use the local or served "
                     "backend")
    if args.enable_serving_autoscaler and args.backend == "kube":
        parser.error("--enable-serving-autoscaler is not yet supported "
                     "with --backend kube: it rides the elastic resize "
                     "pass, which kube does not run yet "
                     "(docs/elastic.md Scope, docs/serving.md); use "
                     "the local or served backend")
    if args.shards < 1:
        parser.error("--shards must be >= 1")
    if args.shard_index is not None and not (
            0 <= args.shard_index < args.shards):
        parser.error(f"--shard-index {args.shard_index} is out of range "
                     f"for --shards {args.shards}: valid indices are "
                     f"0..{args.shards - 1}")
    if args.shards > 1 and args.backend == "kube":
        parser.error("--shards > 1 is not yet supported with --backend "
                     "kube: shard leases live in the in-process store, "
                     "but the kube Store is a per-replica informer "
                     "cache — cross-replica shard ownership there needs "
                     "N Lease objects in the cluster (docs/robustness.md "
                     "'Sharded control plane'); use the local or served "
                     "backend")
    if args.shards > 1 and not args.leader_elect:
        parser.error("--shards > 1 requires leader election: the "
                     "per-shard leases ARE the election (jobs follow "
                     "shard ownership), so --no-leader-elect would "
                     "leave every shard unowned")
    if args.backend == "kube" and args.api_port != 0:
        parser.error("--backend kube cannot serve --api-port: the Store "
                     "is a read cache of the cluster there, so jobs "
                     "submitted through the served API would be dropped "
                     "on the next relist; submit TPUJob CRs to the "
                     "Kubernetes API server instead")
    setup_logging(json_format=args.json_log)
    log.info("%s starting", version_string())

    stop_event = threading.Event()
    server = Server(args, on_fatal=stop_event.set)
    signal_count = [0]

    def _on_signal(signum, frame):
        # First signal: graceful stop. Second: hard exit (reference
        # vendored signals/signal.go:29-45 semantics).
        signal_count[0] += 1
        if signal_count[0] > 1:
            os._exit(1)
        log.info("received signal %d; shutting down", signum)
        stop_event.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    server.start()
    stop_event.wait()
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
