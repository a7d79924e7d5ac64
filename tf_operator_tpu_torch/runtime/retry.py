"""Shared retry/backoff + degraded-mode machinery for the control plane.

Before this module every subsystem had its own one-off answer to a
flaky API server: the engine raised and leaned on the workqueue's
rate-limited requeue, gang eviction logged-and-hoped for the next pass,
health cordons warned and returned, quota/ckpt status writes silently
dropped conflicts, and the remote client surfaced every 5xx straight to
its caller. Under a real 429/500 storm those behaviors compose into
exactly the failure modes chaos testing exists to catch: half-executed
drains, barrier notices stamped but never enforced, and retry storms
with no cap. This module centralizes the three primitives they all
need (client-go's retry.OnError / RetryOnConflict / flowcontrol
backoff, collapsed to what this codebase uses):

- ``with_retries``: capped exponential backoff with FULL jitter,
  deadline-aware, retrying only classified-transient failures
  (``is_transient``); attempts are counted in
  ``tpu_operator_api_retries_total{component}`` and reported into an
  optional ``ControlPlaneHealth`` so repeated failure trips degraded
  mode.
- ``update_with_conflict_retry``: conflict-aware read-modify-write for
  status/annotation writes — re-read, re-apply the mutation, re-write,
  bounded; the client-go ``RetryOnConflict`` shape that every
  optimistic-concurrency write site here used to approximate (or skip).
- ``ControlPlaneHealth``: reachability tracker. While the API server
  has been failing past a threshold the controller is DEGRADED: it
  keeps reconciling (level-triggered reads and creates retry harmlessly)
  but stops *initiating* disruptive actions — slice drains, quota
  reclaims, priority preemptions — because a half-executed eviction
  against an unreachable apiserver is how gangs end up drained but
  never rebound and barriers end up stamped but unenforced. State is
  surfaced via the ``tpu_operator_controlplane_degraded`` gauge, a
  ``ControlPlaneDegraded`` job condition (engine.py), and per-action
  ``tpu_operator_disruptions_deferred_total``.

Fault classification: NotFound / Conflict / AlreadyExists are SEMANTIC
outcomes every caller here already handles (level-triggered deletes,
CAS losses, create races) — never retried by ``with_retries``.
Transient is 5xx/429-class server errors (anything carrying an integer
``.code`` >= 500 or == 429, which covers both ``KubeApiError`` and the
fault injector's ``TransientAPIError``), timeouts, and dropped
connections.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod

log = logging.getLogger("tpu_operator.retry")


class TransientAPIError(Exception):
    """A retryable control-plane failure (5xx-class blip, timeout,
    dropped connection). Carries ``code`` so classification by status
    code and by type agree."""

    def __init__(self, message: str = "transient API error",
                 code: int = 500):
        super().__init__(message)
        self.code = code


def is_transient(exc: BaseException) -> bool:
    """Whether a failure is worth retrying in place. Semantic outcomes
    (NotFound/Conflict/AlreadyExists) are not — their callers handle
    them; everything that smells like an infrastructure blip is."""
    if isinstance(exc, (store_mod.NotFoundError, store_mod.ConflictError,
                        store_mod.AlreadyExistsError)):
        return False
    code = getattr(exc, "code", None)
    if isinstance(code, int) and code:
        return code == 429 or code >= 500
    return isinstance(exc, (TransientAPIError, TimeoutError,
                            ConnectionError, OSError))


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter (AWS-style: sleep a
    uniform draw from [0, min(cap, base * 2^attempt)] — restarted
    retriers never thundering-herd) plus an overall deadline."""

    base_delay: float = 0.05
    max_delay: float = 2.0
    max_attempts: int = 4          # total tries = max_attempts
    deadline_seconds: Optional[float] = None

    def delay(self, attempt: int, rng: Callable[[], float]) -> float:
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        return cap * rng()


#: Short in-place policy for per-object writes inside a reconcile pass.
#: Deliberately small: the workqueue's rate-limited requeue is the
#: long-haul retry loop; this only absorbs blips so a single 500 does
#: not abort a whole sync.
DEFAULT_POLICY = RetryPolicy()

#: Standalone-client policy (SDK / remote store): no outer workqueue to
#: lean on, so it tries longer before surfacing.
CLIENT_POLICY = RetryPolicy(base_delay=0.1, max_delay=5.0,
                            max_attempts=5, deadline_seconds=30.0)


def with_retries(fn: Callable[[], object], *,
                 policy: RetryPolicy = DEFAULT_POLICY,
                 component: str = "",
                 retryable: Callable[[BaseException], bool] = is_transient,
                 health: Optional["ControlPlaneHealth"] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] = random.random):
    """Call ``fn``; on a retryable failure back off and try again until
    attempts or the deadline run out, then re-raise the last error.
    Success/failure outcomes feed ``health`` (degraded-mode tracking)
    and retries are counted per ``component``. Inside a traced sync
    the whole call is a child span carrying its attempt count, and
    backoff sleeps are attributed to the ``api_retry`` phase — retry
    and conflict loops show up in the timeline instead of vanishing
    into ``api_retries_total`` (runtime/trace.py)."""
    with trace_mod.span(f"retry.{component or 'unknown'}") as sp:
        deadline = (time.monotonic() + policy.deadline_seconds
                    if policy.deadline_seconds is not None else None)
        last: Optional[BaseException] = None
        for attempt in range(policy.max_attempts):
            try:
                result = fn()
            except BaseException as e:  # classified below; re-raised verbatim
                if not retryable(e):
                    sp.set(attempts=attempt + 1)
                    raise
                last = e
                if health is not None:
                    health.record_failure()
                if attempt + 1 >= policy.max_attempts:
                    break
                delay = policy.delay(attempt, rng)
                if deadline is not None and time.monotonic() + delay > deadline:
                    break
                metrics.api_retries.inc(component=component or "unknown")
                log.debug("%s: transient failure (attempt %d/%d), retrying "
                          "in %.3fs: %s", component or fn, attempt + 1,
                          policy.max_attempts, delay, e)
                trace_mod.note_phase("api_retry", delay)
                sleep(delay)
                continue
            if health is not None:
                health.record_success()
            sp.set(attempts=attempt + 1)
            return result
        assert last is not None
        sp.set(attempts=policy.max_attempts, exhausted=True)
        raise last


def update_with_conflict_retry(store, kind: str, namespace: str,
                               name: str,
                               mutate: Callable[[object], Optional[bool]],
                               *, status: bool = False,
                               attempts: int = 4,
                               component: str = ""):
    """Conflict-aware read-modify-write (client-go RetryOnConflict):
    fetch the CURRENT object, apply ``mutate`` (return False to abort —
    the precondition no longer holds), write it back; a ConflictError
    re-reads and re-applies so the mutation always lands on fresh state
    instead of silently losing to a racing writer. Returns the written
    object, or None when the object vanished / ``mutate`` aborted /
    attempts ran out."""
    with trace_mod.span(f"retry.{component or 'conflict'}") as sp:
        for attempt in range(attempts):
            obj = store.try_get(kind, namespace, name)
            if obj is None:
                return None
            if mutate(obj) is False:
                return None
            try:
                sp.set(attempts=attempt + 1)
                if status:
                    return store.update_status(kind, obj)
                return store.update(kind, obj)
            except store_mod.ConflictError:
                if attempt + 1 < attempts:
                    metrics.api_retries.inc(component=component or "conflict")
                continue
            except store_mod.NotFoundError:
                return None
        sp.set(exhausted=True)
        return None


class ControlPlaneHealth:
    """API-server reachability tracker + disruptive-action gate.

    ``record_failure``/``record_success`` are fed by the retry wrapper
    (and may be called directly). The controller is DEGRADED once
    failures have been continuous for ``threshold_seconds`` AND at
    least ``failure_threshold`` consecutive calls failed — a single
    blip never trips it, a dead apiserver always does. One success
    clears it (the K8s liveness convention: reachability is now, not
    history).

    ``allow_disruption(action)`` is the gate eviction-initiating code
    paths consult: True = proceed; False = the control plane is
    degraded, defer (counted per action, logged once per episode). The
    point is invariant protection, not availability: a drain or reclaim
    started against an unreachable apiserver half-executes — pods
    deleted but the gang never displaced, a barrier stamped but its
    eviction never enforced — and those are exactly the states the
    chaos invariants forbid."""

    def __init__(self, threshold_seconds: float = 10.0,
                 failure_threshold: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold_seconds = threshold_seconds
        self.failure_threshold = failure_threshold
        self.clock = clock
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._failing_since: Optional[float] = None
        self._degraded = False
        self._deferral_logged: set = set()

    def record_failure(self) -> None:
        with self._lock:
            now = self.clock()
            self._consecutive_failures += 1
            if self._failing_since is None:
                self._failing_since = now
            if (not self._degraded
                    and self._consecutive_failures >= self.failure_threshold
                    and now - self._failing_since >= self.threshold_seconds):
                self._degraded = True
                metrics.controlplane_degraded.set(1)
                metrics.degraded_entries.inc()
                log.error(
                    "control plane DEGRADED: %d consecutive API failures "
                    "over %.1fs — deferring new drains/reclaims/"
                    "preemptions until the API server answers again",
                    self._consecutive_failures, now - self._failing_since)

    def record_success(self) -> None:
        with self._lock:
            was = self._degraded
            self._consecutive_failures = 0
            self._failing_since = None
            self._degraded = False
            self._deferral_logged.clear()
        if was:
            metrics.controlplane_degraded.set(0)
            log.warning("control plane recovered; resuming disruptive "
                        "actions")

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def allow_disruption(self, action: str) -> bool:
        """Gate for eviction-INITIATING paths (drain, reclaim,
        preemption). Completing an already-started eviction is never
        gated — leaving a victim half-evicted is the worse state."""
        with self._lock:
            if not self._degraded:
                return True
            first = action not in self._deferral_logged
            self._deferral_logged.add(action)
        metrics.disruptions_deferred.inc(action=action)
        if first:
            log.warning("control plane degraded: deferring %s until the "
                        "API server recovers", action)
        return False
