"""Leader election: lease-based, exactly-one-active-reconciler.

Reference parity: cmd/tf-operator.v1/app/server.go:146-193 —
client-go leaderelection.RunOrDie over a resourcelock.EndpointsLock
("tf-operator" in the operator namespace) with LeaseDuration 15s,
RenewDeadline 5s, RetryPeriod 3s; OnStartedLeading runs the controller,
OnStoppedLeading fatals; the tf_operator_is_leader gauge flips at
server.go:65-69 and :175-182.

TPU-native shape: the lock record is a Lease object in the object store
(status-subresource-free, optimistic-concurrency CAS on update). With a
K8s backend the same protocol maps onto coordination.k8s.io/v1 Lease.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import logging
import threading
import uuid
from typing import Callable, Dict, List, Optional, Set

from tf_operator_tpu_torch.api.types import ApiObject, ObjectMeta
from tf_operator_tpu_torch.runtime import metrics as metrics_mod
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.metrics import is_leader as is_leader_gauge
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.leaderelection")

LEASES = "leases"
DEFAULT_LOCK_NAME = "tpu-operator"


def shard_for(namespace: str, uid: str, shards: int) -> int:
    """Stable job->shard assignment: sha1 over (namespace, uid). Every
    replica computes the same mapping with no coordination; a job never
    migrates between shards for its lifetime (uid is immutable), so two
    shard holders can never both believe they own it."""
    if shards <= 1:
        return 0
    digest = hashlib.sha1(f"{namespace}/{uid}".encode()).digest()
    return int.from_bytes(digest[:4], "big") % shards


def shard_lock_name(index: int) -> str:
    """Lease name for control-plane shard ``index``."""
    return f"{DEFAULT_LOCK_NAME}-shard-{index}"


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclasses.dataclass
class LeaseSpec(ApiObject):
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: Optional[_dt.datetime] = None
    renew_time: Optional[_dt.datetime] = None
    lease_transitions: int = 0


@dataclasses.dataclass
class _EmptyStatus(ApiObject):
    pass


@dataclasses.dataclass
class Lease(ApiObject):
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: LeaseSpec = dataclasses.field(default_factory=LeaseSpec)
    status: _EmptyStatus = dataclasses.field(default_factory=_EmptyStatus)


class LeaderElector:
    """Acquire-then-renew loop. ``on_started_leading`` runs (once) in a
    daemon thread after acquisition; ``on_stopped_leading`` fires if a
    renewal misses the deadline (the reference fatals there)."""

    def __init__(self, store: Store,
                 identity: Optional[str] = None,
                 namespace: str = "default",
                 name: str = DEFAULT_LOCK_NAME,
                 lease_duration: float = 15.0,
                 renew_deadline: float = 5.0,
                 retry_period: float = 3.0,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None):
        if renew_deadline >= lease_duration:
            raise ValueError("renew_deadline must be < lease_duration")
        self.store = store
        self.identity = identity or f"{DEFAULT_LOCK_NAME}-{uuid.uuid4().hex[:8]}"
        self.namespace = namespace
        self.name = name
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._leading = threading.Event()

    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    def wait_until_leading(self, timeout: Optional[float] = None) -> bool:
        return self._leading.wait(timeout)

    # -- lock record CAS -------------------------------------------------

    def _try_acquire_or_renew(self) -> bool:
        try:
            return self._acquire_or_renew_once()
        except Exception:
            # ANY failure — a 5xx burst, a timeout, a dropped
            # connection — is a failed attempt, never a thread-killer:
            # before this guard, a transient error here propagated out
            # of run(), silently killing the elector thread with
            # _leading still set — a zombie leader that never renews,
            # never steps down, and blocks standby failover until the
            # humans notice (found by the injected-renew-failure tests,
            # tests/test_leaderelection.py). The caller's retry loop +
            # renew deadline turn persistent failure into a clean
            # stepdown.
            log.warning("lease acquire/renew attempt failed; retrying",
                        exc_info=True)
            return False

    def _acquire_or_renew_once(self) -> bool:
        now = _now()
        lease = self.store.try_get(LEASES, self.namespace, self.name)
        if lease is None:
            fresh = Lease(spec=LeaseSpec(
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration,
                acquire_time=now, renew_time=now))
            fresh.metadata.name = self.name
            fresh.metadata.namespace = self.namespace
            try:
                self.store.create(LEASES, fresh)
                return True
            except store_mod.AlreadyExistsError:
                return False

        if lease.spec.holder_identity != self.identity:
            renew = lease.spec.renew_time
            expired = (renew is None or
                       (now - renew).total_seconds()
                       > lease.spec.lease_duration_seconds)
            if not expired:
                return False
            lease.spec.lease_transitions += 1
            lease.spec.acquire_time = now
            log.info("%s taking over expired lease from %s", self.identity,
                     lease.spec.holder_identity)

        lease.spec.holder_identity = self.identity
        lease.spec.renew_time = now
        lease.spec.lease_duration_seconds = self.lease_duration
        try:
            # Optimistic CAS: resource_version mismatch = lost the race.
            self.store.update(LEASES, lease)
            return True
        except (store_mod.ConflictError, store_mod.NotFoundError):
            return False

    def release(self) -> None:
        """Voluntarily drop the lease so a standby takes over instantly.
        Best-effort: on any failure (including transport errors during
        shutdown) the lease simply expires on its own duration."""
        try:
            lease = self.store.try_get(LEASES, self.namespace, self.name)
            if (lease is not None
                    and lease.spec.holder_identity == self.identity):
                lease.spec.holder_identity = ""
                lease.spec.renew_time = None
                self.store.update(LEASES, lease)
        except Exception:
            log.debug("lease release failed; it will expire on its own",
                      exc_info=True)

    # -- run loop --------------------------------------------------------

    def run(self) -> None:
        """Blocks until elected, then renews until stop() or lost lease."""
        while not self._stop.is_set():
            if self._try_acquire_or_renew():
                break
            if self._stop.wait(self.retry_period):
                return
        if self._stop.is_set():
            return

        log.info("%s became leader", self.identity)
        self._leading.set()
        is_leader_gauge.set(1)
        if self.on_started_leading is not None:
            threading.Thread(target=self.on_started_leading,
                             name="leading", daemon=True).start()

        renew_every = min(self.renew_deadline / 2.0, 2.0)
        while not self._stop.wait(renew_every):
            deadline = _now() + _dt.timedelta(seconds=self.renew_deadline)
            renewed = False
            while _now() < deadline and not self._stop.is_set():
                if self._try_acquire_or_renew():
                    renewed = True
                    break
                self._stop.wait(min(self.retry_period, 0.5))
            if not renewed:
                log.error("%s failed to renew lease; stepping down",
                          self.identity)
                break
        self._leading.clear()
        is_leader_gauge.set(0)
        if not self._stop.is_set() and self.on_stopped_leading is not None:
            self.on_stopped_leading()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="leaderelect",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._leading.clear()
        is_leader_gauge.set(0)
        # Callable from the elector's own thread (on_stopped_leading →
        # shutdown paths); a thread cannot join itself.
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        self.release()


class ShardMap:
    """N-leader job ownership: one Lease per control-plane shard
    (``tpu-operator-shard-<i>``), each contended independently with the
    singleton LeaderElector protocol. Jobs hash to shards via
    :func:`shard_for`; the holder of shard i runs a full engine over
    only that shard's jobs.

    A replica contends for EVERY shard by default (so one replica can
    own the whole map — the single-process degenerate case) or for one
    pinned shard (``shard_index``). Failover needs no new protocol: a
    dead holder's lease expires and a survivor's elector takes it over;
    ``on_shard_acquired``/``on_shard_lost`` fire per shard so the
    caller builds and tears down the shard-scoped engine.

    Unlike the singleton elector (whose run() returns after stepdown —
    the reference fatals there), a shard loop RE-CONTENDS after losing:
    shard ownership is a pool, not a process lifetime.
    """

    def __init__(self, store: Store, shards: int,
                 identity: Optional[str] = None,
                 namespace: str = "default",
                 shard_index: Optional[int] = None,
                 lease_duration: float = 15.0,
                 renew_deadline: float = 5.0,
                 retry_period: float = 3.0,
                 on_shard_acquired: Optional[Callable[[int], None]] = None,
                 on_shard_lost: Optional[Callable[[int], None]] = None):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if shard_index is not None and not 0 <= shard_index < shards:
            raise ValueError(
                f"shard_index {shard_index} out of range [0, {shards})")
        self.store = store
        self.shards = shards
        self.identity = (identity
                         or f"{DEFAULT_LOCK_NAME}-{uuid.uuid4().hex[:8]}")
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_shard_acquired = on_shard_acquired
        self.on_shard_lost = on_shard_lost
        # Shards this replica contends for (all, unless pinned).
        self._targets: List[int] = ([shard_index] if shard_index is not None
                                    else list(range(shards)))
        self._stop = threading.Event()
        self._held: Set[int] = set()
        self._held_lock = threading.Lock()
        self._crashed: Set[int] = set()
        self._electors: Dict[int, LeaderElector] = {}
        self._threads: List[threading.Thread] = []
        # Takeovers of a previously-held lease observed at acquire time
        # (mirrors tpu_operator_shard_reassignments_total for benches).
        self.reassignments = 0
        self._transitions_seen: Dict[int, int] = {}

    def held(self) -> Set[int]:
        with self._held_lock:
            return set(self._held)

    def is_held(self, index: int) -> bool:
        with self._held_lock:
            return index in self._held

    def wait_until_held(self, count: int,
                        timeout: Optional[float] = None) -> bool:
        """Block until this replica holds at least ``count`` shards."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while len(self.held()) < count:
            if deadline is not None and _time.monotonic() > deadline:
                return False
            if self._stop.wait(0.02):
                return False
        return True

    # -- per-shard contention loop ---------------------------------------

    def _shard_loop(self, index: int) -> None:
        while not self._stop.is_set() and index not in self._crashed:
            elector = LeaderElector(
                self.store, identity=self.identity,
                namespace=self.namespace, name=shard_lock_name(index),
                lease_duration=self.lease_duration,
                renew_deadline=self.renew_deadline,
                retry_period=self.retry_period,
                on_started_leading=lambda i=index: self._acquired(i),
                on_stopped_leading=lambda i=index: self._lost(i))
            self._electors[index] = elector
            elector.run()  # blocks: acquire -> renew -> stepdown/stop

    def _acquired(self, index: int) -> None:
        with self._held_lock:
            self._held.add(index)
        metrics_mod.shard_owner.set(1, shard=str(index))
        lease = self.store.try_get(LEASES, self.namespace,
                                   shard_lock_name(index))
        transitions = 0 if lease is None else lease.spec.lease_transitions
        if transitions > self._transitions_seen.get(index, 0):
            # The lease changed hands to get here — a failover
            # adoption, not a first acquisition.
            self.reassignments += 1
            metrics_mod.shard_reassignments.inc()
        self._transitions_seen[index] = transitions
        log.info("shard %d/%d acquired by %s (lease transitions: %d)",
                 index, self.shards, self.identity, transitions)
        if self.on_shard_acquired is not None:
            self.on_shard_acquired(index)

    def _lost(self, index: int) -> None:
        with self._held_lock:
            self._held.discard(index)
        metrics_mod.shard_owner.set(0, shard=str(index))
        log.warning("shard %d lost by %s; re-contending", index,
                    self.identity)
        if self.on_shard_lost is not None:
            self.on_shard_lost(index)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        for i in self._targets:
            t = threading.Thread(target=self._shard_loop, args=(i,),
                                 name=f"shard-elect-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def crash(self, index: int) -> None:
        """Simulate holder death for one shard: stop renewing WITHOUT
        releasing the lease and WITHOUT firing on_shard_lost — exactly
        what a killed process leaves behind. A survivor must wait out
        the lease duration before adopting (availability cost), and the
        caller is responsible for abandoning the shard's engine (e.g.
        chaos.crash_controller). stop() is the graceful counterpart."""
        self._crashed.add(index)
        elector = self._electors.get(index)
        if elector is not None:
            elector.on_stopped_leading = None
            elector._stop.set()
            elector._leading.clear()
        with self._held_lock:
            self._held.discard(index)
        metrics_mod.shard_owner.set(0, shard=str(index))

    def stop(self) -> None:
        """Graceful stop: release every held lease so standbys take
        over instantly. on_shard_lost does NOT fire (the caller is
        tearing everything down itself)."""
        self._stop.set()
        for elector in list(self._electors.values()):
            elector.stop()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)
        with self._held_lock:
            held, self._held = set(self._held), set()
        for i in held:
            metrics_mod.shard_owner.set(0, shard=str(i))
