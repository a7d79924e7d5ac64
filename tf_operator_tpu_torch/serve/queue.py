"""Serving request queue: per-tenant QoS lanes with fair-share pop.

Copy of ``tf_operator_tpu/serve/queue.py`` (the port imports nothing of
the JAX package); the same pop order and metrics.

The tenant lanes reuse the multi-tenant machinery's handles
(docs/quota.md): a lane is named after the TenantQueue the caller's job
admits through, and its weight defaults to the backing ClusterQueue's
nominal chip share (controller/serving.py renders the weights into the
serving pods' env). Scheduling is deficit-round-robin — each cycle a
lane earns ``weight`` credits and spends one per popped request — so a
heavy tenant cannot starve a light one of decode slots, exactly like
cohort fair-share keeps it from starving them of chips.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from dataclasses import field
from typing import Deque, Dict, List, Optional

from tf_operator_tpu_torch.runtime import metrics

DEFAULT_TENANT = "default"

OUTCOME_COMPLETED = "completed"
OUTCOME_REJECTED = "rejected"
OUTCOME_REQUEUED = "requeued"


@dataclasses.dataclass
class Request:
    """One generation request through the serving plane."""

    id: str
    tenant: str = DEFAULT_TENANT
    prompt: List[int] = field(default_factory=list)   # token ids
    max_new_tokens: int = 16
    # Filled in by the queue/engine:
    enqueued_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    output: List[int] = field(default_factory=list)
    outcome: str = ""

    @property
    def ttft_seconds(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.enqueued_at

    def reset(self) -> "Request":
        """Forget in-flight progress — a drained request restarts from
        its prompt on the replica that re-claims it."""
        self.first_token_at = None
        self.done_at = None
        self.output = []
        self.outcome = ""
        return self


class RequestQueue:
    """Bounded request queue with weighted-fair tenant lanes."""

    def __init__(self, max_depth: int = 256,
                 tenant_weights: Optional[Dict[str, int]] = None,
                 clock=time.monotonic):
        self.max_depth = max_depth
        self.clock = clock
        # Lanes in insertion order; the DRR cursor walks this ordering.
        self._lanes: "OrderedDict[str, Deque[Request]]" = OrderedDict()
        self._weights: Dict[str, int] = dict(tenant_weights or {})
        self._credits: Dict[str, float] = {}
        self._lock = threading.Lock()

    # -- submit / requeue ----------------------------------------------

    def submit(self, request: Request) -> bool:
        """Enqueue at the tail of the tenant's lane; False (and a
        ``rejected`` outcome) when the queue is at maxQueueDepth."""
        with self._lock:
            if self._depth_locked() >= self.max_depth:
                request.outcome = OUTCOME_REJECTED
                metrics.serving_requests_total.inc(outcome=OUTCOME_REJECTED)
                return False
            request.enqueued_at = request.enqueued_at or self.clock()
            self._lane(request.tenant).append(request)
            self._publish_depth(request.tenant)
            return True

    def requeue_front(self, request: Request) -> None:
        """Put a drained request back at the head of its lane (it has
        already waited once; draining must not send it to the back)."""
        with self._lock:
            self._lane(request.tenant).appendleft(request.reset())
            self._publish_depth(request.tenant)

    # -- pop ------------------------------------------------------------

    def pop(self) -> Optional[Request]:
        """Weighted-fair pop (deficit round robin): walk the lanes,
        spending one credit per popped request; when every non-empty
        lane is out of credits, grant each its weight and continue. A
        single-tenant queue degrades to plain FIFO."""
        with self._lock:
            if not any(self._lanes.values()):
                return None
            for _ in range(2):  # second pass runs after a credit grant
                for tenant, lane in self._lanes.items():
                    if lane and self._credits.get(tenant, 0) >= 1:
                        self._credits[tenant] -= 1
                        request = lane.popleft()
                        self._publish_depth(tenant)
                        return request
                for tenant, lane in self._lanes.items():
                    if lane:
                        self._credits[tenant] = (
                            self._credits.get(tenant, 0)
                            + self.weight(tenant))
            return None  # unreachable: a non-empty lane now has credit

    def drain(self) -> List[Request]:
        """Empty every lane (drain-mid-traffic): returns the waiting
        requests in pop-fairness-free FIFO order for re-spooling."""
        with self._lock:
            out: List[Request] = []
            for tenant, lane in self._lanes.items():
                out.extend(lane)
                lane.clear()
                self._publish_depth(tenant)
            return out

    # -- introspection ---------------------------------------------------

    def depth(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return len(self._lanes.get(tenant, ()))
            return self._depth_locked()

    def weight(self, tenant: str) -> int:
        return max(1, int(self._weights.get(tenant, 1)))

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._lanes)

    def remove_tenant(self, tenant: str) -> List[Request]:
        """Drop a tenant's lane — called when its TenantQueue is deleted
        — returning any requests still waiting so the caller can
        re-spool or fail them. Also removes the lane's
        ``serving_queue_depth{tenant=...}`` gauge series: a deleted
        tenant must not leak a stale 0-valued series forever (the
        job-GC cardinality rule applied to serving)."""
        with self._lock:
            lane = self._lanes.pop(tenant, None)
            self._credits.pop(tenant, None)
            metrics.serving_queue_depth.remove(tenant=tenant)
            return list(lane or ())

    # -- internals -------------------------------------------------------

    def _lane(self, tenant: str) -> Deque[Request]:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = deque()
            self._lanes[tenant] = lane
            self._credits.setdefault(tenant, self.weight(tenant))
        return lane

    def _depth_locked(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def _publish_depth(self, tenant: str) -> None:
        metrics.serving_queue_depth.set(
            len(self._lanes.get(tenant, ())), tenant=tenant)


def parse_tenant_weights(raw: str) -> Dict[str, int]:
    """Parse the 'tenant=weight,tenant=weight' env rendering
    (controller/serving.py ENV_SERVE_TENANT_WEIGHTS). Malformed entries
    are skipped — a serving replica must come up even if the quota
    topology changed under it; unknown tenants default to weight 1."""
    weights: Dict[str, int] = {}
    for entry in (raw or "").split(","):
        name, sep, num = entry.strip().partition("=")
        if not sep or not name:
            continue
        try:
            weights[name] = max(1, int(num.strip()))
        except ValueError:
            continue
    return weights
