"""Operator assembly: store + controller + data-plane backend (port of
tf_operator_tpu/operator.py over ``GPUJobController``).

Reference parity: cmd/tf-operator.v1/app/server.go Run() — builds
clients, informers, the controller, and runs it.

The planes the port has not taken over yet refuse their flags with
``NotImplementedError`` naming the part of the port that brings them
(``UNPORTED_FLAGS``); none is silently ignored.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Dict, Optional

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import EventRecord, ObjectMeta
from tf_operator_tpu_torch.controller.engine import EngineConfig
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.runtime.events import Recorder
from tf_operator_tpu_torch.runtime.local import LocalProcessBackend
from tf_operator_tpu_torch.runtime.store import EVENTS, TPUJOBS, Store

# Store-mirrored events are capped like the in-memory Recorder: when the
# collection exceeds MAX_STORED_EVENTS, the oldest PRUNE_BATCH are dropped.
MAX_STORED_EVENTS = 4096
PRUNE_BATCH = 512

log = logging.getLogger("tpu_operator.operator")


# Operator flags whose plane the port does not have yet -> the part of the
# port's control plane that brings it.
UNPORTED_FLAGS = {
    "enable_gang_scheduling": "the gang scheduler, binder and slice health",
    "enable_slice_health": "the gang scheduler, binder and slice health",
    "enable_ckpt_coordination": "checkpoint coordination",
    "enable_tenant_queues": "quota, serving and elastic resize",
    "enable_serving": "quota, serving and elastic resize",
    "enable_elastic": "quota, serving and elastic resize",
    "enable_serving_autoscaler": "quota, serving and elastic resize",
}


# Sentinel: "no backend argument" (build the default LocalProcessBackend)
# vs an explicit backend=None (control plane only, no data plane).
_DEFAULT_BACKEND = object()


class Operator:
    def __init__(self, store: Optional[Store] = None,
                 backend=_DEFAULT_BACKEND,
                 config: Optional[EngineConfig] = None,
                 namespace: Optional[str] = None,
                 enable_gang_scheduling: bool = False,
                 enable_tenant_queues: bool = False,
                 enable_ckpt_coordination: bool = False,
                 enable_serving: bool = False,
                 enable_elastic: bool = False,
                 enable_serving_autoscaler: bool = False,
                 enable_slice_health: bool = False,
                 degraded_after_seconds: float = 10.0,
                 shard_index: Optional[int] = None,
                 shard_count: int = 1):
        from tf_operator_tpu_torch.runtime.retry import ControlPlaneHealth

        flags = {"enable_gang_scheduling": enable_gang_scheduling,
                 "enable_tenant_queues": enable_tenant_queues,
                 "enable_ckpt_coordination": enable_ckpt_coordination,
                 "enable_serving": enable_serving,
                 "enable_elastic": enable_elastic,
                 "enable_serving_autoscaler": enable_serving_autoscaler,
                 "enable_slice_health": enable_slice_health}
        for flag, on in flags.items():
            if on:
                raise NotImplementedError(
                    f"{flag}: the GPU control plane has no such plane yet "
                    f"(it comes with {UNPORTED_FLAGS[flag]})")
        self.store = store or Store()
        self.recorder = Recorder(sink=self._persist_event)
        # Degraded-mode tracker (runtime/retry.py, docs/robustness.md):
        # every subsystem's API writes report into it; past the
        # threshold the controller keeps reconciling but stamps
        # ControlPlaneDegraded on the jobs it syncs.
        self.cp_health = ControlPlaneHealth(
            threshold_seconds=degraded_after_seconds)
        config = config or EngineConfig()
        # The gang, checkpoint and serving hooks stay None until their
        # planes are ported.
        self.controller = GPUJobController(self.store, recorder=self.recorder,
                                           config=config,
                                           namespace=namespace,
                                           cp_health=self.cp_health,
                                           shard_index=shard_index,
                                           shard_count=shard_count)
        self.backend = (LocalProcessBackend(self.store)
                        if backend is _DEFAULT_BACKEND else backend)

    def start(self, threadiness: int = 2) -> None:
        if self.backend is not None:
            self.backend.start()
        self.controller.run(threadiness=threadiness)
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
        self.controller.stop()
        if self.backend is not None:
            self.backend.stop()
        # A sharded replica tears down per-shard operators on lease loss
        # without killing the shared store's other watchers.
        if stop_store_watchers:
            self.store.stop_watchers()

    @classmethod
    def local(cls, workdir: str, extra_env: Optional[dict] = None,
              **kwargs) -> "Operator":
        """Operator wired to a subprocess pod backend rooted at
        ``workdir``, with ``workdir`` importable inside pods. The common
        bootstrap for hermetic e2e, examples, and benchmarks."""
        import os

        env = {"PYTHONPATH": workdir + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        env.update(extra_env or {})
        backend = LocalProcessBackend(store=None, workdir=workdir,
                                      extra_env=env)
        op = cls(backend=backend, **kwargs)
        backend.store = op.store
        return op


class ShardedOperator:
    """N-leader control plane: one Lease per shard
    (``tpu-operator-shard-<i>``), jobs hashed to shards by
    ``(namespace, uid)``. Each held shard runs a FULL engine —
    workqueue and expectations — over only its own jobs; the store's
    CAS semantics keep them consistent, so no cross-shard lock is
    needed.

    One data-plane backend is shared by every shard of this replica.
    Per-shard :class:`Operator` instances (``backend=None``) are built
    on lease acquisition and torn down on loss WITHOUT stopping the
    shared store's watchers, so a lost shard never takes down the
    survivors' event flow. A second replica contends for the same
    leases: kill one holder and its shards fail over.
    """

    def __init__(self, shards: int, store: Optional[Store] = None,
                 backend=_DEFAULT_BACKEND,
                 identity: Optional[str] = None,
                 namespace: Optional[str] = None,
                 shard_index: Optional[int] = None,
                 lease_duration: float = 15.0,
                 renew_deadline: float = 5.0,
                 retry_period: float = 3.0,
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
        self.shard_map = ShardMap(
            self.store, shards, identity=identity,
            namespace=namespace or "default",
            shard_index=shard_index,
            lease_duration=lease_duration,
            renew_deadline=renew_deadline,
            retry_period=retry_period,
            on_shard_acquired=self._on_shard_acquired,
            on_shard_lost=self._on_shard_lost)

    # -- shard lifecycle -------------------------------------------------

    def _on_shard_acquired(self, index: int) -> None:
        with self._lock:
            if index in self._shard_ops:
                return
            op = Operator(store=self.store, backend=None,
                          namespace=self.namespace,
                          shard_index=index, shard_count=self.shards,
                          **self._operator_kwargs)
            self._shard_ops[index] = op
            started = self._started
        if started:
            op.start(threadiness=self._threadiness)
        log.info("shard %d acquired by %s", index, self.shard_map.identity)

    def _on_shard_lost(self, index: int) -> None:
        with self._lock:
            op = self._shard_ops.pop(index, None)
        if op is not None:
            op.stop(stop_store_watchers=False)
        log.info("shard %d lost by %s", index, self.shard_map.identity)

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
        self.shard_map.stop()
        with self._lock:
            ops = list(self._shard_ops.values())
            self._shard_ops.clear()
        for op in ops:
            op.stop(stop_store_watchers=False)
        if self.backend is not None:
            self.backend.stop()
        self.store.stop_watchers()
