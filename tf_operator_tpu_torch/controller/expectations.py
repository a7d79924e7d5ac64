"""In-flight create/delete bookkeeping ("expectations").

Behavioral parity with reference vendor/.../controller.v1/expectation/
expectation.go: a sync that creates N pods records "expect N adds"; watch
events decrement the counters; the next sync is skipped until the counters
reach zero or the record expires (watch lost events). This prevents
duplicate creates against a stale observed cache.

- Once set, expectations can only be lowered.
- A controller is synced only when expectations are fulfilled or expired.
- Controllers that never set expectations sync on every event.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# Reference ExpectationsTimeout (expectation.go:24) — watchdog for dropped
# watch events.
EXPECTATIONS_TIMEOUT_SECONDS = 5 * 60.0


def expectation_key(job_key: str, kind: str, replica_type: str = "") -> str:
    """Key layout ``{job}/{rtype}/{kind}`` (reference GenExpectation*Key)."""
    if replica_type:
        return f"{job_key}/{replica_type.lower()}/{kind}"
    return f"{job_key}/{kind}"


@dataclass
class _Record:
    adds: int = 0
    dels: int = 0
    timestamp: float = field(default_factory=time.monotonic)

    def fulfilled(self) -> bool:
        return self.adds <= 0 and self.dels <= 0

    def expired(self, now: float) -> bool:
        return now - self.timestamp > EXPECTATIONS_TIMEOUT_SECONDS


class ControllerExpectations:
    """Thread-safe expectations store (reference ControllerExpectations)."""

    def __init__(self, timeout: float = EXPECTATIONS_TIMEOUT_SECONDS):
        self._lock = threading.Lock()
        self._store: Dict[str, _Record] = {}
        self._timeout = timeout

    def get_expectations(self, key: str) -> Optional[Tuple[int, int]]:
        with self._lock:
            rec = self._store.get(key)
            return (rec.adds, rec.dels) if rec else None

    def satisfied_expectations(self, key: str) -> bool:
        with self._lock:
            rec = self._store.get(key)
            if rec is None:
                # Never recorded (or deleted) -> sync freely.
                return True
            if rec.fulfilled():
                return True
            now = time.monotonic()
            if now - rec.timestamp > self._timeout:
                return True
            return False

    def set_expectations(self, key: str, adds: int, dels: int) -> None:
        with self._lock:
            self._store[key] = _Record(adds=adds, dels=dels)

    def expect_creations(self, key: str, adds: int) -> None:
        self.set_expectations(key, adds, 0)

    def expect_deletions(self, key: str, dels: int) -> None:
        self.set_expectations(key, 0, dels)

    def _lower(self, key: str, adds: int, dels: int) -> None:
        with self._lock:
            rec = self._store.get(key)
            if rec is None:
                return
            rec.adds -= adds
            rec.dels -= dels

    def raise_expectations(self, key: str, adds: int, dels: int) -> None:
        """Used to roll back after a failed create (reference
        tensorflow/pod.go:243-249 CreationObserved on create error)."""
        with self._lock:
            rec = self._store.get(key)
            if rec is None:
                return
            rec.adds += adds
            rec.dels += dels

    def lower_expectations(self, key: str, adds: int, dels: int) -> None:
        self._lower(key, adds, dels)

    def creation_observed(self, key: str) -> None:
        self._lower(key, 1, 0)

    def deletion_observed(self, key: str) -> None:
        self._lower(key, 0, 1)

    def delete_expectations(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def delete_for_job(self, job_key: str) -> None:
        """Drop every record under a job's prefix (job deleted)."""
        with self._lock:
            for k in [k for k in self._store if k.startswith(job_key + "/")]:
                del self._store[k]
