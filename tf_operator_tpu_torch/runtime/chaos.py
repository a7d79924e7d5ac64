"""Deterministic fault injection for the control plane (port of
tf_operator_tpu/runtime/chaos.py over the port's metrics, store and
``retry.TransientAPIError``).

Every disruption-sensitive subsystem in this operator (slice-health
drains, quota reclaim, checkpoint barriers) was built against a
COOPERATIVE fake apiserver; real clusters at pod scale answer with
429/500 storms, write conflicts, stale reads, dropped watches, and
operator restarts mid-reconcile — the papers treat preemption/failure
as the steady state ("Exploring the limits of Concurrency in ML
Training on Google TPUs", PAPERS.md). This module makes those faults
INJECTABLE and SEEDED so convergence invariants can be asserted under
any profile, reproducibly:

- ``FaultProfile``: per-fault rates (write/read 5xx, 409 conflicts,
  timeouts, stale reads, watch drops, lost responses) with per-verb /
  per-kind overrides and a seed. Named presets: ``off``, ``default``
  (the acceptance profile: >=5% write errors + >=5% conflicts),
  ``heavy``.
- ``FaultInjector``: the seeded decision engine + per-fault counters
  (also exported as ``tpu_operator_chaos_faults_injected_total``).
- ``ChaosStore``: wraps the in-process ``Store`` with the profile on
  the OPERATOR's read/write path — the process-native twin of
  ``kube_fake.FakeKubeState``'s HTTP-level injection, driven by the
  port's chaos campaign (``runtime/chaos_campaign.py``).
- ``crash_controller``: the operator crash-restart hook — hard-stop a
  controller assembly, abandoning ALL in-memory state (workqueue
  backlog, expectations, bootstrap-hash caches, barrier deadlines,
  drain anchors) while the store (the durable plane) survives; the
  harness then cold-starts a fresh assembly against it and asserts
  convergence.

The fault vocabulary (``FAULTS``):

========== ==============================================================
write_error mutating verb answers 5xx BEFORE applying (request rejected)
lost_response mutating verb APPLIES, then the response is lost (the
            retry-idempotency hazard: a retried create now 409s, a
            retried delete 404s — both semantic outcomes callers handle)
read_error  get/list answers 5xx
conflict    update/status write answers 409 (optimistic-concurrency loss)
timeout     request hangs/drops with no response (TimeoutError /
            connection reset)
stale_read  a get serves the PREVIOUS version of the object (lagging
            watch cache / follower read)
watch_drop  a watch event is silently lost (or the stream dies, on the
            HTTP fake) — consumers must recover via resync/relist
========== ==============================================================
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.retry import TransientAPIError

FAULTS = ("write_error", "lost_response", "read_error", "conflict",
          "timeout", "stale_read", "watch_drop")

_WRITE_VERBS = ("create", "update", "update_status", "delete", "patch",
                "put", "post")


@dataclass
class FaultProfile:
    """Per-fault injection rates, seeded. ``overrides`` maps
    ``(verb, kind)`` — either element may be ``"*"`` — to
    ``{fault: rate}``, most-specific match wins; base rates apply
    otherwise."""

    seed: int = 0
    write_error_rate: float = 0.0
    lost_response_rate: float = 0.0
    read_error_rate: float = 0.0
    conflict_rate: float = 0.0
    timeout_rate: float = 0.0
    stale_read_rate: float = 0.0
    watch_drop_rate: float = 0.0
    latency_seconds: float = 0.0
    overrides: Dict[Tuple[str, str], Dict[str, float]] = field(
        default_factory=dict)

    def rate(self, fault: str, verb: str = "*", kind: str = "*") -> float:
        for key in ((verb, kind), (verb, "*"), ("*", kind)):
            o = self.overrides.get(key)
            if o is not None and fault in o:
                return o[fault]
        return getattr(self, f"{fault}_rate", 0.0)

    @classmethod
    def named(cls, name: str, seed: int = 0) -> "FaultProfile":
        """The presets the CLI/bench accept. ``default`` is the
        acceptance-criteria profile: >=5% write errors, >=5% conflicts,
        plus every other fault class at a non-zero rate."""
        if name == "off":
            return cls(seed=seed)
        if name == "default":
            return cls(seed=seed,
                       write_error_rate=0.05, conflict_rate=0.05,
                       read_error_rate=0.02, timeout_rate=0.02,
                       stale_read_rate=0.05, watch_drop_rate=0.05,
                       lost_response_rate=0.01)
        if name == "heavy":
            return cls(seed=seed,
                       write_error_rate=0.15, conflict_rate=0.10,
                       read_error_rate=0.05, timeout_rate=0.05,
                       stale_read_rate=0.10, watch_drop_rate=0.10,
                       lost_response_rate=0.03)
        raise ValueError(f"unknown fault profile {name!r}; "
                         "expected off|default|heavy")


class FaultInjector:
    """Seeded decision engine + per-fault counters. One RNG behind one
    lock: given the same request sequence, the same seed injects the
    same faults (thread interleaving still varies the sequence — the
    seed bounds the search space, it does not promise bit-identical
    schedules)."""

    def __init__(self, profile: FaultProfile):
        self.profile = profile
        self._rng = random.Random(profile.seed)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {f: 0 for f in FAULTS}

    def decide(self, fault: str, verb: str = "*", kind: str = "*") -> bool:
        rate = self.profile.rate(fault, verb, kind)
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.counts[fault] = self.counts.get(fault, 0) + 1
        if hit:
            metrics.chaos_faults_injected.inc(fault=fault)
        return hit

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())


class ChaosStore:
    """Duck-types the ``Store`` surface the controllers consume,
    injecting the profile's faults on the way through. Reads/writes by
    the HARNESS (pollers, fake kubelets) should go to the wrapped
    store directly — the chaos sits between the OPERATOR and its
    apiserver, not inside the world.

    Injection points: CRUD verbs raise ``TransientAPIError`` (5xx),
    ``ConflictError`` (409) or ``TimeoutError``; ``get`` may serve the
    object's previous version (stale read); watch handlers silently
    lose events at the drop rate — consumers must recover via their
    level-triggered resync, which is exactly the contract under test.
    ``project``/``owned_keys``/``count``/``keys`` pass through
    untouched (lock-held hot-path scans; the HTTP analog has no such
    verbs to fault)."""

    def __init__(self, store, profile: Optional[FaultProfile] = None,
                 injector: Optional[FaultInjector] = None):
        self.inner = store
        self.injector = injector or FaultInjector(profile or FaultProfile())
        # (kind, ns, name) -> previous stored version (stale-read pool).
        self._history: Dict[Tuple[str, str, str], object] = {}
        self._hist_lock = threading.Lock()

    # -- fault plumbing --------------------------------------------------

    def _latency(self) -> None:
        d = self.injector.profile.latency_seconds
        if d:
            time.sleep(d)

    def _maybe_read_fault(self, verb: str, kind: str) -> None:
        self._latency()
        if self.injector.decide("timeout", verb, kind):
            raise TimeoutError(f"injected timeout ({verb} {kind})")
        if self.injector.decide("read_error", verb, kind):
            raise TransientAPIError(
                f"injected server error ({verb} {kind})")

    def _maybe_write_fault(self, verb: str, kind: str,
                           conflictable: bool) -> None:
        self._latency()
        if self.injector.decide("timeout", verb, kind):
            raise TimeoutError(f"injected timeout ({verb} {kind})")
        if conflictable and self.injector.decide("conflict", verb, kind):
            raise store_mod.ConflictError(
                f"injected conflict ({verb} {kind})")
        if self.injector.decide("write_error", verb, kind):
            raise TransientAPIError(
                f"injected server error ({verb} {kind})")

    def _after_write(self, verb: str, kind: str, result):
        if self.injector.decide("lost_response", verb, kind):
            raise TransientAPIError(
                f"injected lost response ({verb} {kind}): write applied, "
                "reply dropped")
        return result

    def _remember(self, kind: str, namespace: str, name: str) -> None:
        """Stash the current version before a write, feeding stale
        reads."""
        if self.injector.profile.rate("stale_read") <= 0.0:
            return
        cur = self.inner.try_get(kind, namespace, name)
        if cur is not None:
            with self._hist_lock:
                self._history[(kind, namespace, name)] = cur

    # -- CRUD ------------------------------------------------------------

    def create(self, kind: str, obj):
        self._maybe_write_fault("create", kind, conflictable=False)
        return self._after_write("create", kind,
                                 self.inner.create(kind, obj))

    def get(self, kind: str, namespace: str, name: str):
        self._maybe_read_fault("get", kind)
        if self.injector.decide("stale_read", "get", kind):
            with self._hist_lock:
                stale = self._history.get((kind, namespace, name))
            if stale is not None:
                return stale.deepcopy()
        return self.inner.get(kind, namespace, name)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except store_mod.NotFoundError:
            return None

    def get_snapshot(self, kind: str, namespace: str, name: str):
        """Frozen-snapshot read with the same fault surface as get:
        injected timeouts/5xx, and stale reads served from the history
        pool (a historic version is frozen too — the consumer contract
        is identical)."""
        self._maybe_read_fault("get", kind)
        if self.injector.decide("stale_read", "get", kind):
            with self._hist_lock:
                stale = self._history.get((kind, namespace, name))
            if stale is not None:
                return stale
        return self.inner.get_snapshot(kind, namespace, name)

    def list(self, kind: str, namespace=None, selector=None):
        self._maybe_read_fault("list", kind)
        return self.inner.list(kind, namespace=namespace,
                               selector=selector)

    def list_claimable(self, kind: str, namespace: str, selector,
                       owner_uid: str):
        self._maybe_read_fault("list", kind)
        return self.inner.list_claimable(kind, namespace, selector,
                                         owner_uid)

    def update(self, kind: str, obj):
        self._remember(kind, obj.metadata.namespace, obj.metadata.name)
        self._maybe_write_fault("update", kind, conflictable=True)
        return self._after_write("update", kind,
                                 self.inner.update(kind, obj))

    def update_status(self, kind: str, obj):
        self._remember(kind, obj.metadata.namespace, obj.metadata.name)
        self._maybe_write_fault("update_status", kind, conflictable=True)
        return self._after_write("update_status", kind,
                                 self.inner.update_status(kind, obj))

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._remember(kind, namespace, name)
        self._maybe_write_fault("delete", kind, conflictable=False)
        self.inner.delete(kind, namespace, name)
        self._after_write("delete", kind, None)

    def try_delete(self, kind: str, namespace: str, name: str) -> bool:
        try:
            self.delete(kind, namespace, name)
            return True
        except store_mod.NotFoundError:
            return False

    # -- pass-throughs (hot-path scans; no HTTP analog) ------------------

    def project(self, kind: str, fn, namespace=None):
        return self.inner.project(kind, fn, namespace=namespace)

    def owned_keys(self, kind: str, owner_uid: str):
        return self.inner.owned_keys(kind, owner_uid)

    def count(self, kind: str) -> int:
        return self.inner.count(kind)

    def keys(self, kind: str):
        return self.inner.keys(kind)

    def latest_rv(self) -> int:
        return self.inner.latest_rv()

    def list_page(self, kind: str, namespace=None, selector=None,
                  limit=None, after=None):
        self._maybe_read_fault("list", kind)
        return self.inner.list_page(kind, namespace=namespace,
                                    selector=selector, limit=limit,
                                    after=after)

    # -- watch -----------------------------------------------------------

    def watch(self, kind: str, handler, replay: bool = True,
              since_rv=None):
        injector = self.injector

        def chaotic(etype, obj):
            if injector.decide("watch_drop", "watch", kind):
                return  # silently lost on the wire
            handler(etype, obj)

        return self.inner.watch(kind, chaotic, replay=replay,
                                since_rv=since_rv)

    def stop_watchers(self) -> None:
        self.inner.stop_watchers()


def crash_controller(controller, *extras) -> None:
    """Operator crash analog: stop the controller (and any co-located
    subsystems — health, ckpt, binder — passed as ``extras``) so every
    piece of in-memory state dies with it: workqueue backlog,
    expectations, bootstrap-hash caches, barrier deadline anchors,
    drain grace anchors, rebind stopwatches. Python threads cannot be
    killed mid-instruction, so in-flight syncs drain first — the state
    LOSS is the crash analog the invariants care about; the store (the
    durable plane) is untouched. Cold-start a fresh assembly against
    the surviving store afterwards and convergence must hold."""
    for part in (controller, *extras):
        if part is None:
            continue
        try:
            part.stop()
        except Exception:
            pass
