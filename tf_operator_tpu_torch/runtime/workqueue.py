"""Rate-limited work queue with K8s workqueue semantics.

Reference dependency: k8s.io/client-go/util/workqueue as used by
job_controller.go:139-142. Semantics preserved:

- De-duplication: an item present in the queue is not added twice
  (coalescing — a 256-pod gang start collapses its event storm into
  one pending sync per job; counted by ``workqueue_coalesced_total``).
- In-flight marking: an item re-added while being processed is deferred
  until ``done`` and then requeued (level-triggered, same-key serialized —
  this is the engine's only concurrency-safety requirement, and what
  makes ``threadiness > 1`` safe: two workers can never hold the same
  key simultaneously).
- ``add_rate_limited`` applies per-item exponential backoff;
  ``num_requeues`` feeds the engine's BackoffLimit policy;
  ``forget`` resets the counter.
- ``add_after`` schedules a delayed add (used for ActiveDeadlineSeconds
  and TTL re-sync, reference status.go:84-92, job.go:345-357).

Wakeups: ``get()`` waiters and the delay loop wait on SEPARATE
conditions sharing one mutex. They used to share a single condition,
and ``add``'s lone ``notify()`` could wake the delay loop instead of a
``get()`` waiter — the freshly queued item then sat until a worker's
poll timeout (~0.5 s of sync latency per quiet-period add; masked by
event churn, exposed by the elastic resize pass's steady-state grows).
``notify_all`` is not the fix either: waking every worker and the
delay loop on every add is a thundering herd that starves the
process's other threads (watch streams, servers) under event storms.

Observability lives HERE, under the queue's own lock (the depth gauge
used to be set racily at the two controller call sites):
``workqueue_depth`` on every transition, ``workqueue_latency_seconds``
(add -> get wait) on every pop, ``workqueue_coalesced_total`` on every
deduplicated add.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Dict, Hashable, List, Optional, Tuple

from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import trace as trace_mod


class ShutDown(Exception):
    pass


class RateLimitingQueue:
    def __init__(self, base_delay: float = 0.005, max_delay: float = 30.0,
                 instrument: bool = True):
        # One mutex, two wait channels: ``_items`` for get() waiters,
        # ``_delay_cv`` for the delay loop — a ready-item notify can
        # only ever wake a consumer (see module docstring).
        self._mutex = threading.Lock()
        self._items = threading.Condition(self._mutex)
        self._delay_cv = threading.Condition(self._mutex)
        self._queue: deque = deque()
        self._dirty: set = set()
        self._processing: set = set()
        self._failures: Dict[Hashable, int] = {}
        self._added_at: Dict[Hashable, float] = {}
        self._delayed: List[Tuple[float, int, Hashable]] = []  # heap
        self._seq = 0
        self._shutting_down = False
        self._base_delay = base_delay
        self._max_delay = max_delay
        # Process-global metrics; tests that build throwaway queues can
        # opt out so they don't scribble on the operator's gauges.
        self._instrument = instrument
        self._delay_thread = threading.Thread(target=self._delay_loop,
                                              daemon=True)
        self._delay_thread.start()

    # -- instrumentation (callers hold self._mutex) ------------------------

    def _mark_queued(self, item: Hashable) -> None:
        self._queue.append(item)
        self._added_at.setdefault(item, time.monotonic())
        self._set_depth()

    def _set_depth(self) -> None:
        if self._instrument:
            metrics.workqueue_depth.set(len(self._queue))

    def _coalesced(self) -> None:
        if self._instrument:
            metrics.workqueue_coalesced.inc()

    # -- core queue -------------------------------------------------------

    def add(self, item: Hashable) -> None:
        with self._items:
            if self._shutting_down:
                return
            if item in self._dirty:
                self._coalesced()
                return
            self._dirty.add(item)
            if item in self._processing:
                return  # re-queued by done()
            self._mark_queued(item)
            self._items.notify()

    def get(self, timeout: Optional[float] = None) -> Hashable:
        """Block until an item is available. Raises ShutDown when drained
        after shutdown, or TimeoutError on timeout."""
        with self._items:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue:
                if self._shutting_down:
                    raise ShutDown()
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError()
                self._items.wait(remaining)
            item = self._queue.popleft()
            self._processing.add(item)
            self._dirty.discard(item)
            added = self._added_at.pop(item, None)
            if added is not None and self._instrument:
                wait = time.monotonic() - added
                metrics.workqueue_latency_seconds.observe(wait)
                # Flight-recorder phase attribution: enqueue->dequeue
                # wait is the "queue_wait" phase of the item's next
                # sync (no span — the wait belongs to no trace yet).
                trace_mod.note_phase("queue_wait", wait)
            self._set_depth()
            return item

    def done(self, item: Hashable) -> None:
        with self._items:
            self._processing.discard(item)
            if item in self._dirty:
                self._mark_queued(item)
                self._items.notify()

    def __len__(self) -> int:
        with self._mutex:
            return len(self._queue)

    def shutdown(self) -> None:
        with self._mutex:
            self._shutting_down = True
            self._items.notify_all()
            self._delay_cv.notify_all()

    @property
    def shutting_down(self) -> bool:
        with self._mutex:
            return self._shutting_down

    # -- rate limiting ----------------------------------------------------

    def num_requeues(self, item: Hashable) -> int:
        with self._mutex:
            return self._failures.get(item, 0)

    def forget(self, item: Hashable) -> None:
        with self._mutex:
            self._failures.pop(item, None)

    def add_rate_limited(self, item: Hashable) -> None:
        with self._mutex:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        delay = min(self._base_delay * (2 ** n), self._max_delay)
        self.add_after(item, delay)

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._delay_cv:
            if self._shutting_down:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (time.monotonic() + delay,
                                           self._seq, item))
            self._delay_cv.notify()  # re-arm the loop's wait window

    def _delay_loop(self) -> None:
        while True:
            with self._delay_cv:
                if self._shutting_down and not self._delayed:
                    return
                now = time.monotonic()
                while self._delayed and self._delayed[0][0] <= now:
                    _, _, item = heapq.heappop(self._delayed)
                    if item not in self._dirty:
                        self._dirty.add(item)
                        if item not in self._processing:
                            self._mark_queued(item)
                            self._items.notify()
                    else:
                        self._coalesced()
                wait = 0.2
                if self._delayed:
                    wait = min(wait, max(0.0, self._delayed[0][0] - now))
                self._delay_cv.wait(wait)
