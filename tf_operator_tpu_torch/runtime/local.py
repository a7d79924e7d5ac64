"""Local process backend — the kubelet/data-plane analog (port of
tf_operator_tpu/runtime/local.py; the resolver rewrites the GPU
bootstrap env, and each pod sees its own cards, ``CardInventory``).

The reference hands pods to kubelet and watches status flow back through
the API server (SURVEY §3.3). This backend does the same hermetically:
it watches the store for pods, runs each container as a subprocess, and
writes phase transitions (Pending -> Running -> Succeeded/Failed with
exit codes) back to the store, driving the controller's watch feedback
loop. Pod-level restartPolicy (Always/OnFailure) is honored in-place with
restart counts, which feeds the engine's PastBackoffLimit policy.

Service discovery is pluggable: env rendered by the bootstrap layer uses
cluster DNS names; the ``resolver`` rewrites them to reachable addresses
at spawn time. The default ``LoopbackEnvResolver`` maps everything to
127.0.0.1 with a per-job rendezvous port (hermetic single-host runs);
node agents use ``agent.ControlPlaneEnvResolver``, which resolves names
through pod placement records in the served control plane (kube-dns
analog). A ``pod_filter`` scopes the backend to pods bound to one node.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from tf_operator_tpu_torch.api.types import (
    ContainerStatus,
    Pod,
    PodPhase,
    PodStatus,
    RestartPolicy,
)
from tf_operator_tpu_torch.runtime import relay as relay_mod
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.store import ADDED, DELETED, MODIFIED, Store

log = logging.getLogger("tpu_operator.local_backend")

_GRACE_SECONDS = 3.0

# The host env a pod's process sees beside PATH, PYTHONPATH, HOME and
# LANG: the device plugin's part on a real node. CUDA_VISIBLE_DEVICES
# keeps a pod to the cards the operator itself was given, and where the
# backend keeps a card inventory, to the pod's own. Nothing else is
# needed: on an H100 host a pod with those four alone sees the card and
# finds nvcc (ops/_build.py: on PATH, else under CUDA_HOME's default
# /usr/local/cuda), so CUDA_HOME and LD_LIBRARY_PATH stay the host's own.
DEVICE_ENV = ("CUDA_VISIBLE_DEVICES",)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CardInventory:
    """The cards of one node, each held by one pod at a time: the device
    plugin's part. A pod is given as many as its ``nvidia.com/gpu``
    request, as ``CUDA_VISIBLE_DEVICES`` (none for a pod that requests
    none), and they come back when its processes have all exited."""

    def __init__(self, cards):
        self.cards = list(cards)
        self._lock = threading.Lock()
        self._held: Dict[str, list] = {}   # pod key -> its cards

    @classmethod
    def of_node(cls, chips: Optional[int] = None,
                environ=None) -> Optional["CardInventory"]:
        """The cards named by ``CUDA_VISIBLE_DEVICES`` where it names
        some (the ones this process was given), else ``0..chips-1``;
        None, no inventory, where neither says: pods then see what this
        process sees."""
        env = os.environ if environ is None else environ
        visible = [c.strip() for c in
                   env.get("CUDA_VISIBLE_DEVICES", "").split(",")
                   if c.strip()]
        if visible:
            return cls(visible)
        if chips:
            return cls(str(i) for i in range(chips))
        return None

    def acquire(self, key: str, count: int) -> Optional[list]:
        """``count`` free cards for pod ``key`` (the ones it holds where it
        holds some already), or None while too few are free. Raises where
        the node has fewer than ``count`` at all."""
        if count > len(self.cards):
            raise ValueError(f"pod {key} requests {count} GPU(s); this "
                             f"node has {len(self.cards)}")
        with self._lock:
            if key in self._held:
                return list(self._held[key])
            busy = {c for cards in self._held.values() for c in cards}
            free = [c for c in self.cards if c not in busy]
            if len(free) < count:
                return None
            self._held[key] = free[:count]
            return list(self._held[key])

    def release(self, key: str) -> None:
        with self._lock:
            self._held.pop(key, None)


@dataclass
class _RunningPod:
    pod: Pod
    processes: Dict[str, subprocess.Popen] = field(default_factory=dict)
    restart_counts: Dict[str, int] = field(default_factory=dict)
    stop_requested: bool = False
    done: bool = False
    # True while this pod's processes are counted in the backend's
    # gang-occupancy registry (see _gang_acquire/_gang_release).
    gang_held: bool = False
    # Last preemption-notice payload forwarded to the worker process
    # (dedup: each barrier's notice is written to the file once).
    notice_written: str = ""
    # mtime (ns) of the worker's checkpoint file at the last mirror into
    # the store's CheckpointRecord.
    ckpt_mtime: int = 0
    # The cards this pod's processes see (CUDA_VISIBLE_DEVICES), where
    # the backend keeps an inventory.
    cards: Optional[list] = None


class LoopbackEnvResolver:
    """Single-host resolution: rewrite cluster DNS names to 127.0.0.1
    with one free rendezvous port per job (``MASTER_PORT``, shared by all
    its pods, so they meet at one TCPStore). The hermetic default; served
    deployments use the agent's control-plane resolver instead."""

    def __init__(self):
        self._lock = threading.Lock()
        self._job_ports: Dict[str, int] = {}  # job uid -> rendezvous port
        self._host_ports: Dict[str, int] = {}  # cluster DNS name -> port

    def _port_for_host(self, host: str) -> int:
        """Stable loopback port per cluster DNS name, shared by every
        pod this backend spawns — the ps replica binds the SAME port
        its peers dial (single-host kube-dns analog)."""
        with self._lock:
            port = self._host_ports.get(host)
            if port is None:
                port = _free_port()
                self._host_ports[host] = port
            return port

    def _rewrite_cluster_spec(self, raw: str) -> str:
        """Rewrite ONLY the ps entries: they are the addresses tasks
        actually dial through the cluster spec (train/ps.py). Other
        roles' entries stay DNS-named — they are identity, part of the
        golden bootstrap contract (test_runconfig_golden_full_topology),
        and their traffic (the torch.distributed rendezvous) is resolved
        separately."""
        import json

        try:
            spec = json.loads(raw)
        except ValueError:
            return raw
        cluster = spec.get("cluster") or {}
        if cluster.get("ps"):
            cluster["ps"] = [
                f"127.0.0.1:{self._port_for_host(h.rsplit(':', 1)[0])}"
                for h in cluster["ps"]]
            spec["cluster"] = cluster
            return json.dumps(spec, sort_keys=True)
        return raw

    def resolve(self, pod: Pod, env: Dict[str, str]) -> Dict[str, str]:
        job_uid = ""
        ref = pod.metadata.controller_ref()
        if ref is not None:
            job_uid = ref.uid
        with self._lock:
            port = self._job_ports.get(job_uid)
            if port is None:
                port = _free_port()
                self._job_ports[job_uid] = port
        out = {}
        for k, v in env.items():
            if k == "MASTER_ADDR":
                out[k] = "127.0.0.1"
            elif k == "MASTER_PORT":
                out[k] = str(port)
            elif k == "TPUJOB_CLUSTER_SPEC":
                # PS/worker tasks dial each other through the cluster
                # spec; rewrite its DNS names to stable loopback ports.
                out[k] = self._rewrite_cluster_spec(v)
            else:
                out[k] = v
        return out


class LocalProcessBackend:
    def __init__(self, store: Store, workdir: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None,
                 resolver=None,
                 pod_filter=None,
                 chips: Optional[int] = None):
        self.store = store
        self.workdir = workdir or os.getcwd()
        self.extra_env = dict(extra_env or {})
        # Service-discovery strategy: rewrites bootstrap env (coordinator
        # address, worker hostnames) to reachable addresses at spawn time.
        self.resolver = resolver or LoopbackEnvResolver()
        # Which pods this backend runs (a node agent passes "pods bound
        # to me"); None = every pod in the store.
        self.pod_filter = pod_filter
        # The node's cards, handed to pods disjointly
        # (CardInventory.of_node: this process's CUDA_VISIBLE_DEVICES,
        # else ``chips`` of them).
        self.cards = CardInventory.of_node(chips)
        # Pod stdout/stderr capture (kubelet container-log analog);
        # surfaced to clients via pod.status.log_path.
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), f"tpujob-logs-{os.getpid()}")
        self._lock = threading.Lock()
        self._running: Dict[str, _RunningPod] = {}  # "ns/name" -> state
        self._watcher = None
        self._stopped = False
        # Gang groups with LIVE local processes: (ns, group) -> chips
        # held (sum of the spawned pods' nvidia.com/gpu requests).
        # Registered synchronously at spawn and released only after
        # process exit, so the gang scheduler's draining_provider sees
        # the chips as occupied through the whole process lifetime —
        # including the termination-grace window after the store pod
        # (or even the whole SliceGroup, on job deletion) is already
        # gone (round-4 Weak #6: the store delete alone opened an
        # up-to-_GRACE_SECONDS overlap where a successor could run
        # alongside dying victims). Value = [pod count, chips] so the
        # scheduler can both gate occupancy and keep budget booked for
        # groups that no longer exist.
        self._gang_procs: Dict[tuple, list] = {}
        # Called (if set) when a gang group's last dying process exits,
        # so admission re-runs immediately instead of at the next
        # resync (process exit writes no store event to ride).
        self.on_gang_drained = None

    # ------------------------------------------------------------------

    def start(self) -> None:
        self._watcher = self.store.watch(store_mod.PODS, self._on_pod_event)

    def stop(self) -> None:
        self._stopped = True
        if self._watcher:
            self._watcher.stop()
        with self._lock:
            running = list(self._running.values())
        for rp in running:
            self._terminate(rp)

    def _on_pod_event(self, event_type: str, pod: Pod) -> None:
        if self._stopped:
            return
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        # MODIFIED starts pods too: a node agent's claim (binding
        # spec.node_name) arrives as MODIFIED, and the _running dedup
        # makes re-delivery harmless.
        if event_type in (ADDED, MODIFIED):
            if self.pod_filter is not None and not self.pod_filter(pod):
                return
            if pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                return  # terminal status echoes (incl. our own writes)
            with self._lock:
                running = self._running.get(key)
                if running is None:
                    rp = _RunningPod(pod=pod)
                    self._running[key] = rp
            if running is not None:
                # Already running here: the only update the data plane
                # acts on is a preemption notice landing on the pod —
                # forward it to the worker process as a file
                # (controller/ckpt.py save-before-evict barrier).
                self._forward_notice(running, pod)
                return
            threading.Thread(target=self._run_pod, args=(key, rp),
                             daemon=True).start()
        elif event_type == DELETED:
            with self._lock:
                rp = self._running.pop(key, None)
            if rp is not None:
                # Termination can block for the grace period; keep the watch
                # dispatcher thread free.
                threading.Thread(target=self._terminate, args=(rp,),
                                 daemon=True).start()
            # Log retention follows the pod object (kubelet semantics);
            # the checkpoint-coordination sidecar files follow it too.
            try:
                os.unlink(self.pod_log_path(pod))
            except OSError:
                pass
            relay_mod.cleanup(self.log_dir, pod)

    # ------------------------------------------------------------------

    def _run_pod(self, key: str, rp: _RunningPod) -> None:
        pod = rp.pod
        if not self._await_gang_admission(rp):
            return  # pod deleted while gated
        try:
            if not self._await_cards(rp):
                return  # deleted while waiting for its cards
            if rp.stop_requested:
                self._release_cards(rp)
                return  # deleted between admission and spawn
            self._spawn_all(rp)
        except Exception as e:  # bad command etc. -> Failed
            log.warning("pod %s failed to start: %s", key, e)
            self._release_cards(rp)
            self._write_status(pod, PodPhase.FAILED, message=str(e))
            return
        # Chips are held from the first spawned process until the last
        # one EXITS (not until the store pod is deleted) — the gang
        # scheduler reads this registry to close the preemption
        # overlap window.
        self._gang_acquire(rp)
        if rp.stop_requested:
            # Deletion raced the spawn: _terminate saw an empty process
            # map, so these processes would otherwise leak.
            self._terminate(rp)
            return
        self._write_running(rp)
        self._wait_pod(key, rp)

    def _await_gang_admission(self, rp: _RunningPod) -> bool:
        """Gang-scheduled pods stay Pending until their SliceGroup is
        admitted (Volcano's gating behavior). Gated on the gang annotation,
        which is stamped on every pod of a gang-scheduled job regardless of
        any custom scheduler name in the template."""
        from tf_operator_tpu_torch.api import constants
        from tf_operator_tpu_torch.controller.binder import ADMITTED_PHASES

        pod = rp.pod
        group_name = pod.metadata.annotations.get(
            constants.ANNOTATION_GANG_GROUP, "")
        if not group_name:
            return True
        while not (rp.stop_requested or self._stopped):
            group = self.store.try_get(store_mod.SLICEGROUPS,
                                       pod.metadata.namespace, group_name)
            if group is not None and group.status.phase in ADMITTED_PHASES:
                # Mark-then-recheck, not check-then-mark: persist the
                # release FIRST, then confirm the group is still
                # admitted. A preemption between our phase read and the
                # marker write would otherwise see no occupying pod and
                # hand these chips to the preemptor while we spawn.
                self._mark_released(pod, True)
                group = self.store.try_get(store_mod.SLICEGROUPS,
                                           pod.metadata.namespace,
                                           group_name)
                if group is not None and group.status.phase in (
                        ADMITTED_PHASES):
                    return True
                self._mark_released(pod, False)  # lost the race: re-gate
                continue
            time.sleep(0.05)
        return False

    def _await_cards(self, rp: _RunningPod) -> bool:
        """Hold the pod Pending until the inventory has its
        ``nvidia.com/gpu`` cards free (a card is reused only once the pod
        holding it has exited); False if it was deleted meanwhile."""
        if self.cards is None:
            return True
        count = self._pod_chips(rp.pod)
        while not (rp.stop_requested or self._stopped):
            cards = self.cards.acquire(self._card_key(rp.pod), count)
            if cards is not None:
                rp.cards = cards
                return True
            time.sleep(0.05)
        return False

    def _release_cards(self, rp: _RunningPod) -> None:
        if self.cards is not None:
            self.cards.release(self._card_key(rp.pod))

    @staticmethod
    def _card_key(pod: Pod) -> str:
        """An incarnation's key: a pod recreated under its name must not
        take the cards its dying predecessor still holds."""
        return (f"{pod.metadata.namespace}/{pod.metadata.name}/"
                f"{pod.metadata.uid}")

    def _mark_released(self, pod: Pod, released: bool) -> None:
        """Persist gang_released BEFORE spawning, so the gang scheduler
        counts this pod as occupying chips through the whole spawn
        window — a preemption landing mid-spawn evicts it instead of
        double-booking its chips (see PodStatus.gang_released)."""
        stored = self.store.try_get(store_mod.PODS, pod.metadata.namespace,
                                    pod.metadata.name)
        if stored is None:
            return
        stored.status.gang_released = released
        pod.status.gang_released = released
        try:
            self.store.update_status(store_mod.PODS, stored)
        except store_mod.NotFoundError:
            pass

    def _spawn_all(self, rp: _RunningPod) -> None:
        for container in rp.pod.spec.containers:
            self._spawn(rp, container.name)

    def _spawn(self, rp: _RunningPod, container_name: str) -> None:
        pod = rp.pod
        container = pod.spec.container(container_name)
        argv = list(container.command) + list(container.args)
        if not argv:
            raise ValueError(f"container {container_name} has no command")
        env = dict(self.extra_env)
        env.setdefault("PATH", os.environ.get("PATH", "/usr/bin:/bin"))
        for var in ("PYTHONPATH", "HOME", "LANG") + DEVICE_ENV:
            if var in os.environ:
                env.setdefault(var, os.environ[var])
        env.update(self.resolver.resolve(pod, container.env))
        if rp.cards is not None:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(rp.cards)
        env["TPUJOB_POD_NAME"] = pod.metadata.name
        env["TPUJOB_POD_NAMESPACE"] = pod.metadata.namespace
        # Checkpoint-coordination handoff (controller/ckpt.py): where a
        # preemption notice will appear, and where the worker publishes
        # its checkpoint state for the plane to mirror into its
        # CheckpointRecord (train/checkpoint.py CheckpointHook reads /
        # writes these).
        from tf_operator_tpu_torch.api import constants as _c

        env[_c.ENV_PREEMPT_FILE] = self.pod_preempt_path(pod)
        env[_c.ENV_CKPT_FILE] = self.pod_ckpt_path(pod)
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = self.pod_log_path(pod)
        with open(log_path, "ab") as log_file:
            proc = subprocess.Popen(
                argv,
                cwd=container.working_dir or self.workdir,
                env=env,
                stdout=log_file,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        rp.processes[container_name] = proc

    def pod_log_path(self, pod: Pod) -> str:
        # Keyed by uid so a restart-with-identity (same name, new pod)
        # gets a fresh file, not the dead incarnation's output.
        uid = (pod.metadata.uid or "nouid")[:8]
        return os.path.join(
            self.log_dir,
            f"{pod.metadata.namespace}.{pod.metadata.name}.{uid}.log")

    def pod_preempt_path(self, pod: Pod) -> str:
        """Where this pod's worker process finds a preemption notice
        (incarnation-keyed like the log: a recreated pod must never read
        the dead incarnation's notice and 'ack' a barrier it never saved
        under). Path derivation is shared with the kube node agent
        (runtime/relay.py)."""
        return relay_mod.preempt_path(self.log_dir, pod)

    def pod_ckpt_path(self, pod: Pod) -> str:
        """Where this pod's worker process publishes checkpoint state
        (saves / barrier acks / restore confirmation) for the plane to
        mirror into its CheckpointRecord."""
        return relay_mod.ckpt_path(self.log_dir, pod)

    def _forward_notice(self, rp: _RunningPod, pod: Pod) -> None:
        """Write the pod's preemption-notice annotation to the worker's
        notice file (atomic publish; the training loop polls it each
        step). The kubelet analog of the coordinator's annotation stamp
        reaching the container."""
        from tf_operator_tpu_torch.api import constants as _c

        notice = pod.metadata.annotations.get(
            _c.ANNOTATION_PREEMPT_NOTICE, "")
        try:
            rp.notice_written = relay_mod.forward_notice(
                self.log_dir, rp.pod, notice, rp.notice_written)
        except OSError:
            return  # next MODIFIED/poll retries

    def _mirror_ckpt_record(self, rp: _RunningPod) -> None:
        """Mirror the worker's checkpoint file into its CheckpointRecord
        — the data plane reports checkpoint state exactly like it
        reports pod phase (controller/ckpt.py reads the records to run
        barriers and derive restore steps). A partially-written or
        unparseable file is skipped; the next tick retries."""
        pod = rp.pod
        data, rp.ckpt_mtime = relay_mod.read_ckpt_file(
            self.pod_ckpt_path(pod), rp.ckpt_mtime)
        if data is None:
            return
        try:
            if not relay_mod.upsert_checkpoint_record(
                    self.store, pod, data, _now()):
                rp.ckpt_mtime = 0  # lost a race; next tick re-mirrors
        except Exception:
            log.debug("checkpoint record mirror failed", exc_info=True)
            rp.ckpt_mtime = 0

    # ------------------------------------------------------------------

    def _wait_pod(self, key: str, rp: _RunningPod) -> None:
        """Monitor processes; honor pod restartPolicy; write final phase."""
        pod = rp.pod
        policy = pod.spec.restart_policy or RestartPolicy.NEVER
        # A notice stamped while the pod was gate-held arrives with no
        # further MODIFIED event; forward it now that processes exist.
        self._forward_notice(rp, pod)
        while True:
            if rp.stop_requested:
                return
            self._mirror_ckpt_record(rp)
            exited = {}
            for name, proc in list(rp.processes.items()):
                code = proc.poll()
                if code is not None:
                    exited[name] = code
            if len(exited) == len(rp.processes):
                # all containers done; decide restart vs terminal
                should_restart = (
                    policy == RestartPolicy.ALWAYS
                    or (policy == RestartPolicy.ON_FAILURE
                        and any(c != 0 for c in exited.values())))
                if should_restart and not rp.stop_requested:
                    for name in exited:
                        rp.restart_counts[name] = rp.restart_counts.get(name, 0) + 1
                    try:
                        self._spawn_all(rp)
                    except Exception as e:
                        # All processes are dead: the chips must not
                        # stay booked behind a failed respawn.
                        self._gang_release(rp)
                        self._release_cards(rp)
                        self._write_status(pod, PodPhase.FAILED, message=str(e))
                        return
                    self._write_running(rp)
                    continue
                rp.done = True
                phase = (PodPhase.SUCCEEDED
                         if all(c == 0 for c in exited.values())
                         else PodPhase.FAILED)
                # Final mirror: a save completing in the process's last
                # instants (barrier ack, then exit) must not be lost.
                self._mirror_ckpt_record(rp)
                self._gang_release(rp)  # natural death frees the chips
                self._release_cards(rp)
                self._write_status(pod, phase, exit_codes=exited, rp=rp)
                return
            time.sleep(0.02)

    def draining_gang_groups(self) -> Dict[tuple, Dict[str, int]]:
        """(namespace, gang group) -> {"pods": live-process pod count,
        "chips": chips those pods hold}. Consumed by the gang
        scheduler's draining_provider so freed chips only admit a
        successor after the previous holders actually exited — even
        when the holder's SliceGroup itself was deleted with its job
        (pods gates occupancy; chips keeps deleted groups' budget
        booked)."""
        with self._lock:
            return {k: {"pods": v[0], "chips": v[1]}
                    for k, v in self._gang_procs.items()}

    def _gang_key(self, pod: Pod):
        from tf_operator_tpu_torch.api import constants

        group = pod.metadata.annotations.get(
            constants.ANNOTATION_GANG_GROUP, "")
        return (pod.metadata.namespace, group) if group else None

    @staticmethod
    def _pod_chips(pod: Pod) -> int:
        from tf_operator_tpu_torch.controller.binder import pod_chip_demand

        return pod_chip_demand(pod)

    def _gang_acquire(self, rp: _RunningPod) -> None:
        key = self._gang_key(rp.pod)
        if key is None:
            return
        with self._lock:
            if rp.gang_held:
                return
            rp.gang_held = True
            entry = self._gang_procs.setdefault(key, [0, 0])
            entry[0] += 1
            entry[1] += self._pod_chips(rp.pod)

    def _gang_release(self, rp: _RunningPod) -> None:
        key = self._gang_key(rp.pod)
        if key is None:
            return
        with self._lock:
            if not rp.gang_held:
                return
            rp.gang_held = False
            entry = self._gang_procs.get(key, [1, 0])
            entry[0] -= 1
            entry[1] = max(0, entry[1] - self._pod_chips(rp.pod))
            left = entry[0]
            if left <= 0:
                self._gang_procs.pop(key, None)
        if left <= 0 and self.on_gang_drained is not None:
            # Process exit writes no store event; poke admission so the
            # waiting successor lands now, not at the next resync.
            try:
                self.on_gang_drained()
            except Exception:
                log.debug("on_gang_drained failed", exc_info=True)

    def _terminate(self, rp: _RunningPod) -> None:
        rp.stop_requested = True
        try:
            procs = list(rp.processes.values())
            for proc in procs:
                if proc.poll() is None:
                    try:
                        os.killpg(proc.pid, signal.SIGTERM)
                    except (ProcessLookupError, PermissionError):
                        pass
            deadline = time.monotonic() + _GRACE_SECONDS
            for proc in procs:
                remaining = deadline - time.monotonic()
                try:
                    proc.wait(timeout=max(0.05, remaining))
                except subprocess.TimeoutExpired:
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
                    proc.wait(timeout=5)
        finally:
            self._gang_release(rp)
            self._release_cards(rp)

    # ------------------------------------------------------------------

    def _write_running(self, rp: _RunningPod) -> None:
        pod = rp.pod
        status = PodStatus(
            phase=PodPhase.RUNNING,
            start_time=rp.pod.status.start_time or _now(),
            host="127.0.0.1",
            container_statuses=[
                ContainerStatus(name=name, state="Running",
                                restart_count=rp.restart_counts.get(name, 0))
                for name in rp.processes
            ],
        )
        rp.pod.status = status
        self._write_pod_status(pod, status)

    def _write_status(self, pod: Pod, phase: str,
                      exit_codes: Optional[Dict[str, int]] = None,
                      message: str = "",
                      rp: Optional[_RunningPod] = None) -> None:
        statuses = []
        for name, code in (exit_codes or {}).items():
            statuses.append(ContainerStatus(
                name=name, state="Terminated", exit_code=code,
                restart_count=(rp.restart_counts.get(name, 0) if rp else 0)))
        status = PodStatus(phase=phase, message=message,
                           start_time=pod.status.start_time or _now(),
                           host="127.0.0.1",
                           container_statuses=statuses)
        self._write_pod_status(pod, status)

    def _write_pod_status(self, pod: Pod, status: PodStatus) -> None:
        stored = self.store.try_get(store_mod.PODS, pod.metadata.namespace,
                                    pod.metadata.name)
        if stored is None:
            return  # deleted concurrently
        log_path = self.pod_log_path(pod)
        if os.path.exists(log_path):
            status.log_path = log_path
        # Preserve the placement the claiming agent published — peers
        # resolve coordinator addresses from these fields.
        if stored.status.host:
            status.host = stored.status.host
        if stored.status.ports:
            status.ports = dict(stored.status.ports)
        stored.status = status
        try:
            self.store.update_status(store_mod.PODS, stored)
        except store_mod.NotFoundError:
            pass


def _now():
    import datetime as _dt

    return _dt.datetime.now(_dt.timezone.utc)
