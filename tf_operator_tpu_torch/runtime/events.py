"""Event recorder (reference: client-go record.EventRecorder wired at
job_controller.go:158-162; events are emitted on every lifecycle edge).

Storm control (client-go EventCorrelator/EventAggregator analog): an
exact duplicate within the aggregation window bumps the stored event's
``count`` instead of appending — and once more than
``SIMILAR_EVENTS_THRESHOLD`` events share (kind, name, type, reason)
in the window, further ones collapse into a single "(combined from
similar events)" record. Either way the fan-out sink is NOT re-invoked,
so a 256-pod gang storm doesn't become 256 API Event writes in the kube
backend (kube.py _post_event) or 256 store writes in the local one.
"""

from __future__ import annotations

import datetime as _dt
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tf_operator_tpu_torch.runtime import metrics

log = logging.getLogger("tpu_operator.events")

# Aggregation window + similar-event threshold (client-go defaults are
# 10 minutes / 10 events; same here).
AGGREGATION_WINDOW_SECONDS = 600.0
SIMILAR_EVENTS_THRESHOLD = 10

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"

# Slice-health / auto-repair event reasons (controller/health.py) — the
# drain/rebind lifecycle's observable edges, named here so emitters and
# test/SDK consumers share one vocabulary.
REASON_NODE_CORDONED = "NodeCordoned"
REASON_SLICE_DRAIN_PENDING = "SliceDrainPending"
REASON_SLICE_DRAINED = "SliceDrained"
REASON_SLICE_REBOUND = "SliceRebound"

# Checkpoint-coordination event reasons (controller/ckpt.py) — the
# save-before-evict barrier's observable edges.
REASON_CKPT_BARRIER_REQUESTED = "CheckpointBarrierRequested"
REASON_CKPT_BARRIER_SAVED = "CheckpointBarrierSaved"
REASON_CKPT_BARRIER_TIMEOUT = "CheckpointBarrierTimeout"

# Tenant-queue quota event reasons (controller/quota.py) — the
# quota-admission lifecycle's observable edges.
REASON_QUEUED_WAITING_FOR_QUOTA = "QueuedWaitingForQuota"
REASON_QUOTA_EXCEEDED = "QuotaExceeded"
REASON_BORROWED_CAPACITY = "BorrowedCapacity"
REASON_QUOTA_RECLAIMED = "QuotaReclaimed"
REASON_QUEUE_DELETED = "QueueDeleted"

# Elastic-gang event reasons (controller/gang.py resize pass,
# docs/elastic.md) — one event per applied grow/shrink.
REASON_GANG_RESIZED = "GangResized"

# Heterogeneous-gang event reasons (docs/rl.md): evict-class replicas
# (RL actors) removed from a degraded node WITHOUT a barrier or a gang
# drain — the learner world keeps running.
REASON_ACTOR_EVICTED = "ActorEvicted"


@dataclass
class Event:
    object_kind: str
    object_name: str
    namespace: str
    type: str
    reason: str
    message: str
    timestamp: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc))
    # The involved object's labels (job-name etc.) so sinks can attribute
    # pod events to their job without name parsing.
    labels: dict = field(default_factory=dict)
    # How many occurrences this record stands for (aggregation).
    count: int = 1


class Recorder:
    """In-memory event sink with optional fan-out callback and
    EventCorrelator-style duplicate/similar aggregation."""

    def __init__(self, sink: Optional[Callable[[Event], None]] = None,
                 max_events: int = 4096,
                 aggregation_window: float = AGGREGATION_WINDOW_SECONDS,
                 similar_threshold: int = SIMILAR_EVENTS_THRESHOLD):
        self._lock = threading.Lock()
        self._events: List[Event] = []
        self._sink = sink
        self._max = max_events
        self._window = aggregation_window
        self._similar_threshold = similar_threshold
        # exact (kind, ns, name, type, reason, message) -> (event, last_seen)
        self._by_exact: Dict[Tuple, Tuple[Event, float]] = {}
        # similar (kind, ns, name, type, reason) -> (count, window_start,
        #                                            aggregate event | None)
        self._by_similar: Dict[Tuple, Tuple[int, float, Optional[Event]]] = {}

    def _aggregate(self, ev: Event, now: float) -> bool:
        """Fold ``ev`` into an existing record when it's a duplicate or
        part of a similar-event storm; returns True when folded (caller
        skips append + sink). Caller holds the lock."""
        similar_key = (ev.object_kind, ev.namespace, ev.object_name,
                       ev.type, ev.reason)
        exact_key = similar_key + (ev.message,)
        hit = self._by_exact.get(exact_key)
        if hit is not None and now - hit[1] <= self._window:
            record = hit[0]
            record.count += 1
            record.timestamp = ev.timestamp
            self._by_exact[exact_key] = (record, now)
            metrics.events_aggregated.inc()
            return True
        n, start, aggregate = self._by_similar.get(similar_key,
                                                   (0, now, None))
        if now - start > self._window:
            n, start, aggregate = 0, now, None
        n += 1
        if n > self._similar_threshold:
            if aggregate is None:
                aggregate = Event(
                    object_kind=ev.object_kind, object_name=ev.object_name,
                    namespace=ev.namespace, type=ev.type, reason=ev.reason,
                    message=f"(combined from similar events): {ev.message}",
                    labels=dict(ev.labels), count=n)
                self._events.append(aggregate)
            else:
                aggregate.count = n
                aggregate.message = ("(combined from similar events): "
                                     f"{ev.message}")
                aggregate.timestamp = ev.timestamp
            self._by_similar[similar_key] = (n, start, aggregate)
            metrics.events_aggregated.inc()
            return True
        self._by_similar[similar_key] = (n, start, aggregate)
        self._by_exact[exact_key] = (ev, now)
        return False

    def event(self, obj, etype: str, reason: str, message: str) -> None:
        meta = getattr(obj, "metadata", None)
        ev = Event(
            object_kind=getattr(obj, "kind", type(obj).__name__),
            object_name=getattr(meta, "name", "") if meta else "",
            namespace=getattr(meta, "namespace", "") if meta else "",
            type=etype, reason=reason, message=message,
            labels=dict(getattr(meta, "labels", None) or {}) if meta else {},
        )
        log.debug("%s %s %s/%s: %s", etype, reason, ev.namespace,
                  ev.object_name, message)
        with self._lock:
            if self._aggregate(ev, time.monotonic()):
                return  # folded into an existing record; no re-sink
            self._events.append(ev)
            if len(self._events) > self._max:
                self._events = self._events[-self._max:]
        if self._sink:
            self._sink(ev)

    def events_for(self, name: str = "", reason: str = "") -> List[Event]:
        with self._lock:
            return [e for e in self._events
                    if (not name or e.object_name == name)
                    and (not reason or e.reason == reason)]

    @property
    def events(self) -> List[Event]:
        with self._lock:
            return list(self._events)
