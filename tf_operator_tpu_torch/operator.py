"""Operator assembly: store + controller + data-plane backend (port of
tf_operator_tpu/operator.py over ``GPUJobController``; every plane's flag
is wired as the JAX operator wires it, and ``total_chips`` counts GPUs).

Reference parity: cmd/tf-operator.v1/app/server.go Run() — builds
clients, informers, the controller, and runs it.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Dict, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import EventRecord, ObjectMeta
from tf_operator_tpu_torch.controller.engine import EngineConfig
from tf_operator_tpu_torch.controller.gang import SliceGangScheduler
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.runtime.events import Recorder
from tf_operator_tpu_torch.runtime.local import LocalProcessBackend
from tf_operator_tpu_torch.runtime.store import EVENTS, TPUJOBS, Store

# Store-mirrored events are capped like the in-memory Recorder: when the
# collection exceeds MAX_STORED_EVENTS, the oldest PRUNE_BATCH are dropped.
MAX_STORED_EVENTS = 4096
PRUNE_BATCH = 512

log = logging.getLogger("tpu_operator.operator")


# Sentinel: "no backend argument" (build the default LocalProcessBackend)
# vs an explicit backend=None (control plane only, no data plane).
_DEFAULT_BACKEND = object()


class Operator:
    def __init__(self, store: Optional[Store] = None,
                 backend=_DEFAULT_BACKEND,
                 config: Optional[EngineConfig] = None,
                 namespace: Optional[str] = None,
                 enable_gang_scheduling: bool = False,
                 total_chips: Optional[int] = None,
                 gang_fairness: str = "aged",
                 gang_aging_seconds: float = 300.0,
                 gang_priority_classes: Optional[dict] = None,
                 gang_queue_quotas: Optional[dict] = None,
                 gang_preemption: bool = False,
                 enable_tenant_queues: bool = False,
                 queue_config: Optional[str] = None,
                 enable_ckpt_coordination: bool = False,
                 enable_serving: bool = False,
                 enable_elastic: bool = False,
                 enable_serving_autoscaler: bool = False,
                 autoscale_interval_seconds: float = 1.0,
                 autoscale_signals=None,
                 resize_signals=None,
                 enable_slice_health: bool = False,
                 health_drain_grace_seconds: float = 0.0,
                 degraded_after_seconds: float = 10.0,
                 shard_index: Optional[int] = None,
                 shard_count: int = 1):
        from tf_operator_tpu_torch.runtime.retry import ControlPlaneHealth

        self.store = store or Store()
        self.recorder = Recorder(sink=self._persist_event)
        # Degraded-mode tracker (runtime/retry.py, docs/robustness.md):
        # every subsystem's API writes report into it; past the
        # threshold the controller keeps reconciling but defers NEW
        # drains/reclaims/preemptions and stamps ControlPlaneDegraded
        # on the jobs it syncs.
        self.cp_health = ControlPlaneHealth(
            threshold_seconds=degraded_after_seconds)
        config = config or EngineConfig()
        gang = None
        self.quota = None
        self.ckpt = None
        self.health = None
        if enable_tenant_queues and not enable_gang_scheduling:
            raise ValueError("tenant queues sit above gang admission: "
                             "--enable-tenant-queues requires "
                             "--enable-gang-scheduling")
        if enable_slice_health and not enable_gang_scheduling:
            raise ValueError("slice health drains whole gangs: "
                             "--enable-slice-health requires "
                             "--enable-gang-scheduling")
        if enable_elastic and not enable_gang_scheduling:
            raise ValueError("elastic resize is a gang-scheduler pass: "
                             "--enable-elastic requires "
                             "--enable-gang-scheduling")
        if enable_serving_autoscaler and not (enable_serving
                                              and enable_elastic):
            raise ValueError("the serving autoscaler maps queue depth to "
                             "elastic resizes: --enable-serving-autoscaler "
                             "requires --enable-serving and "
                             "--enable-elastic")
        if enable_ckpt_coordination:
            from tf_operator_tpu_torch.controller.ckpt import (
                CheckpointCoordinator,
            )

            self.ckpt = CheckpointCoordinator(self.store,
                                              recorder=self.recorder,
                                              namespace=namespace)
        self.serving = None
        if enable_serving:
            from tf_operator_tpu_torch.controller.serving import ServingManager

            # Serving-plane wiring (controller/serving.py): renders
            # ServingPolicy + tenant QoS lane weights into serving-role
            # pods. Off = the serving role stays inert (flag-off parity).
            self.serving = ServingManager(self.store,
                                          recorder=self.recorder,
                                          namespace=namespace)
        self.autoscaler = None
        if enable_gang_scheduling:
            config.enable_gang_scheduling = True
            if enable_tenant_queues:
                from tf_operator_tpu_torch.controller.quota import (
                    TenantQueueManager,
                    load_queue_config,
                    seed_queues,
                )

                self.quota = TenantQueueManager(self.store,
                                                recorder=self.recorder)
                if queue_config:
                    seed_queues(self.store, *load_queue_config(queue_config))
            if enable_serving_autoscaler:
                from tf_operator_tpu_torch.controller.autoscaler import (
                    ServingAutoscaler,
                )

                # Built before the gang so it can double as the resize-
                # signal provider: resize records/events then carry the
                # queue-depth/TTFT values the decision saw.
                self.autoscaler = ServingAutoscaler(
                    self.store, None, namespace=namespace,
                    interval_seconds=autoscale_interval_seconds,
                    signals=autoscale_signals)
                if resize_signals is None:
                    resize_signals = self.autoscaler.signals
            gang = SliceGangScheduler(self.store, total_chips=total_chips,
                                      fairness=gang_fairness,
                                      aging_seconds=gang_aging_seconds,
                                      priority_classes=gang_priority_classes,
                                      queue_quotas=gang_queue_quotas,
                                      preemption=gang_preemption,
                                      quota=self.quota,
                                      ckpt=self.ckpt,
                                      cp_health=self.cp_health,
                                      elastic=enable_elastic,
                                      resize_signals=resize_signals,
                                      recorder=self.recorder)
            if self.autoscaler is not None:
                self.autoscaler.gang = gang
        self.controller = GPUJobController(self.store, recorder=self.recorder,
                                           config=config, gang=gang,
                                           namespace=namespace,
                                           ckpt=self.ckpt,
                                           cp_health=self.cp_health,
                                           serving=self.serving,
                                           shard_index=shard_index,
                                           shard_count=shard_count)
        if self.ckpt is not None and gang is not None:
            # A barrier ack landing between resyncs must release the
            # held eviction promptly: record writes poke admission.
            self.ckpt.on_ack = gang.readmit
        if enable_slice_health:
            from tf_operator_tpu_torch.controller.health import (
                SliceHealthController,
            )

            self.health = SliceHealthController(
                self.store, gang=gang,
                pod_control=self.controller.engine.pod_control,
                recorder=self.recorder, namespace=namespace,
                default_grace_seconds=health_drain_grace_seconds,
                ckpt=self.ckpt, cp_health=self.cp_health)
        self.backend = (LocalProcessBackend(self.store)
                        if backend is _DEFAULT_BACKEND else backend)
        if gang is not None and hasattr(self.backend,
                                        "draining_gang_groups"):
            # Close the preemption overlap window: chips of deleted
            # pods stay counted until their processes exit, and drain
            # completion re-runs admission immediately.
            gang.draining_provider = self.backend.draining_gang_groups
            self.backend.on_gang_drained = gang.readmit

    def start(self, threadiness: int = 2) -> None:
        if self.ckpt is not None:
            self.ckpt.start()
        if self.backend is not None:
            self.backend.start()
        self.controller.run(threadiness=threadiness)
        if self.health is not None:
            self.health.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        log.info("operator started (threadiness=%d)", threadiness)

    def _persist_event(self, ev) -> None:
        """Mirror recorder events into the store (K8s Event analog) so
        SDK clients can scan them, e.g. for FailedCreatePod."""
        job_name = ev.labels.get(constants.LABEL_JOB_NAME, "")
        if not job_name and ev.object_kind == "TPUJob":
            job_name = ev.object_name
        record = EventRecord(
            metadata=ObjectMeta(
                name=f"{ev.object_name}.{uuid.uuid4().hex[:10]}",
                namespace=ev.namespace or "default",
                labels={constants.LABEL_JOB_NAME: job_name}),
            involved_kind=ev.object_kind, involved_name=ev.object_name,
            type=ev.type, reason=ev.reason, message=ev.message)
        try:
            self.store.create(EVENTS, record)
            if self.store.count(EVENTS) > MAX_STORED_EVENTS:
                # Prune by key metadata only — list() would deepcopy all
                # ~4096 event payloads inside the recorder's synchronous
                # sink while reconcile threads block on it.
                stale = sorted(self.store.keys(EVENTS), key=lambda t: t[2])
                for ns, name, _ in stale[:PRUNE_BATCH]:
                    self.store.try_delete(EVENTS, ns, name)
        except Exception:
            log.debug("event persist failed", exc_info=True)

    def stop(self, stop_store_watchers: bool = True) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.health is not None:
            self.health.stop()
        self.controller.stop()
        if self.backend is not None:
            self.backend.stop()
        if self.ckpt is not None:
            self.ckpt.stop()
        # A sharded replica tears down per-shard operators on lease loss
        # without killing the shared store's other watchers.
        if stop_store_watchers:
            self.store.stop_watchers()

    @classmethod
    def local(cls, workdir: str, extra_env: Optional[dict] = None,
              chips: Optional[int] = None, **kwargs) -> "Operator":
        """Operator wired to a subprocess pod backend rooted at
        ``workdir``, with ``workdir`` importable inside pods, each pod
        given its own of the host's cards: those of this process's
        ``CUDA_VISIBLE_DEVICES``, else ``chips`` of them
        (``CardInventory``). The common bootstrap for hermetic e2e,
        examples, and benchmarks."""
        import os

        env = {"PYTHONPATH": workdir + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        env.update(extra_env or {})
        backend = LocalProcessBackend(store=None, workdir=workdir,
                                      extra_env=env, chips=chips)
        op = cls(backend=backend, **kwargs)
        backend.store = op.store
        return op


class ShardedOperator:
    """N-leader control plane: one Lease per shard
    (``tpu-operator-shard-<i>``), jobs hashed to shards by
    ``(namespace, uid)``. Each held shard runs a FULL engine —
    workqueue, expectations, gang/quota/ckpt plugins — over only its
    own jobs; chip-budget and quota stay globally consistent through
    the store's CAS semantics and the admission plan ledger, so no
    cross-shard lock is needed.

    One data-plane backend is shared by every shard of this replica.
    Per-shard :class:`Operator` instances (``backend=None``) are built
    on lease acquisition and torn down on loss WITHOUT stopping the
    shared store's watchers, so a lost shard never takes down the
    survivors' event flow. A second replica contends for the same
    leases: kill one holder and its shards fail over. The leases live
    in ``lease_store`` (default: ``store``).
    """

    def __init__(self, shards: int, store: Optional[Store] = None,
                 backend=_DEFAULT_BACKEND,
                 identity: Optional[str] = None,
                 namespace: Optional[str] = None,
                 shard_index: Optional[int] = None,
                 lease_duration: float = 15.0,
                 renew_deadline: float = 5.0,
                 retry_period: float = 3.0,
                 lease_store: Optional[Store] = None,
                 **operator_kwargs):
        from tf_operator_tpu_torch.runtime.leaderelection import ShardMap

        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.shards = shards
        self.store = store or Store()
        self.backend = (LocalProcessBackend(self.store)
                        if backend is _DEFAULT_BACKEND else backend)
        self.namespace = namespace
        self._operator_kwargs = dict(operator_kwargs)
        self._threadiness = 2
        self._lock = threading.Lock()
        self._shard_ops: Dict[int, Operator] = {}
        self._started = False
        self._stopping = False
        self.shard_map = ShardMap(
            lease_store or self.store, shards, identity=identity,
            namespace=namespace or "default",
            shard_index=shard_index,
            lease_duration=lease_duration,
            renew_deadline=renew_deadline,
            retry_period=retry_period,
            on_shard_acquired=self._on_shard_acquired,
            on_shard_lost=self._on_shard_lost)
        if self.backend is not None and hasattr(self.backend,
                                                "on_gang_drained"):
            self.backend.on_gang_drained = self._readmit_all

    # -- shard lifecycle -------------------------------------------------

    def _build_shard_operator(self, index: int) -> Operator:
        op = Operator(store=self.store, backend=None,
                      namespace=self.namespace,
                      shard_index=index, shard_count=self.shards,
                      **self._operator_kwargs)
        gang = op.controller.engine.gang
        if gang is not None and hasattr(self.backend,
                                        "draining_gang_groups"):
            gang.draining_provider = self.backend.draining_gang_groups
        return op

    def _on_shard_acquired(self, index: int) -> None:
        with self._lock:
            if self._stopping or index in self._shard_ops:
                return
            op = self._build_shard_operator(index)
            self._shard_ops[index] = op
            # Started under the lock, so stop() never misses an operator
            # that is still starting.
            if self._started:
                op.start(threadiness=self._threadiness)
        log.info("shard %d acquired by %s", index, self.shard_map.identity)

    def _on_shard_lost(self, index: int) -> None:
        with self._lock:
            op = self._shard_ops.pop(index, None)
        if op is not None:
            op.stop(stop_store_watchers=False)
        log.info("shard %d lost by %s", index, self.shard_map.identity)

    def _readmit_all(self) -> None:
        with self._lock:
            ops = list(self._shard_ops.values())
        for op in ops:
            gang = op.controller.engine.gang
            if gang is not None:
                try:
                    gang.readmit()
                except Exception:
                    log.debug("shard readmit failed", exc_info=True)

    # -- operator surface ------------------------------------------------

    @property
    def held_shards(self):
        return self.shard_map.held()

    def operator_for(self, index: int) -> Optional[Operator]:
        with self._lock:
            return self._shard_ops.get(index)

    def start(self, threadiness: int = 2) -> None:
        with self._lock:
            self._threadiness = threadiness
            self._started = True
            pending = list(self._shard_ops.values())
        if self.backend is not None:
            self.backend.start()
        for op in pending:
            op.start(threadiness=threadiness)
        self.shard_map.start()
        log.info("sharded operator started (shards=%d, threadiness=%d)",
                 self.shards, threadiness)

    def resync(self) -> None:
        """Enqueue every owned job on its holding shard's controller —
        the sharded analog of the flat resync loop. Walks key metadata
        and frozen snapshots only (no deepcopies)."""
        from tf_operator_tpu_torch.runtime.leaderelection import shard_for

        for ns, name, _ in self.store.keys(TPUJOBS):
            if self.namespace is not None and ns != self.namespace:
                continue
            snap = self.store.get_snapshot(TPUJOBS, ns, name)
            if snap is None:
                continue
            idx = shard_for(ns, snap.metadata.uid, self.shards)
            op = self.operator_for(idx)
            if op is not None:
                op.controller.enqueue(f"{ns}/{name}")

    def stop(self) -> None:
        # Every shard's operator stops before its lease is released: a
        # standby that takes a released lease must find no engine of this
        # replica still reconciling that shard's jobs.
        with self._lock:
            self._stopping = True
            ops = list(self._shard_ops.values())
            self._shard_ops.clear()
        for op in ops:
            op.stop(stop_store_watchers=False)
        self.shard_map.stop()
        if self.backend is not None:
            self.backend.stop()
        self.store.stop_watchers()
