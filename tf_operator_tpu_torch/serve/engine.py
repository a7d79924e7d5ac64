"""ServingEngine: the serve loop tying queue -> batcher -> SLO metrics.

One ``step()`` is one continuous-batching round (admission + batched
decode); ``run_until_idle`` drives rounds until queue and slots are
empty (benchmarks, tests, the graft dryrun smoke); the serving worker
process (serve/worker.py) calls ``step()`` from its own poll loop.

SLO metrics (runtime/metrics.py, the operator's one registry):
- serving_ttft_seconds          enqueue -> first generated token
- serving_tokens_per_second     decode throughput over a rolling window
- serving_queue_depth{tenant}   published by the queue itself
- serving_requests_total{outcome} completed | rejected | requeued

``drain()`` implements drain-mid-traffic: queued AND in-flight requests
come back (progress reset) for the caller to re-spool, counted as
``requeued`` — the serving half of the save-before-evict contract
(docs/serving.md): zero requests are dropped, they complete on the
replica that rebinds.

Copy of ``tf_operator_tpu/serve/engine.py``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.serve.batcher import ContinuousBatcher
from tf_operator_tpu_torch.serve.queue import (
    OUTCOME_COMPLETED,
    OUTCOME_REQUEUED,
    Request,
    RequestQueue,
)

# Tokens/sec gauge window: short enough to track load swings, long
# enough to smooth per-step jitter.
THROUGHPUT_WINDOW_SECONDS = 2.0


class ServingEngine:
    def __init__(self, queue: RequestQueue, batcher: ContinuousBatcher,
                 clock: Callable[[], float] = time.monotonic,
                 on_complete: Optional[Callable[[Request], None]] = None):
        self.queue = queue
        self.batcher = batcher
        self.clock = clock
        self.on_complete = on_complete
        self.completed_total = 0
        self.tokens_total = 0
        self._window: List[tuple] = []  # (t, tokens) samples

    # -- serve loop ------------------------------------------------------

    def step(self) -> List[Request]:
        """One continuous-batching round; returns completed requests."""
        before = self._tokens_in_flight()
        done = self.batcher.step(self.queue)
        generated = (self._tokens_in_flight()
                     + sum(len(r.output) for r in done) - before)
        self._observe_throughput(generated)
        for request in done:
            request.outcome = OUTCOME_COMPLETED
            self.completed_total += 1
            metrics.serving_requests_total.inc(outcome=OUTCOME_COMPLETED)
            if request.ttft_seconds is not None:
                metrics.serving_ttft_seconds.observe(request.ttft_seconds)
            if self.on_complete is not None:
                self.on_complete(request)
        return done

    def run_until_idle(self, max_steps: int = 100000) -> List[Request]:
        """Drive rounds until nothing is queued or in flight."""
        done: List[Request] = []
        for _ in range(max_steps):
            if self.queue.depth() == 0 and self.batcher.active == 0:
                return done
            done.extend(self.step())
        raise RuntimeError(f"serving engine not idle after {max_steps} "
                           "steps (sequence leak?)")

    @property
    def idle(self) -> bool:
        return self.queue.depth() == 0 and self.batcher.active == 0

    # -- drain -----------------------------------------------------------

    def drain(self) -> List[Request]:
        """Stop-the-world drain: every queued and in-flight request
        comes back (in-flight first — they have waited longest) with
        progress reset, for the caller to re-spool."""
        evicted = self.batcher.drain() + self.queue.drain()
        for request in evicted:
            request.outcome = OUTCOME_REQUEUED
            metrics.serving_requests_total.inc(outcome=OUTCOME_REQUEUED)
        return evicted

    # -- throughput ------------------------------------------------------

    def _tokens_in_flight(self) -> int:
        return sum(len(r.output) for r in self.batcher.in_flight())

    def _observe_throughput(self, generated: int) -> None:
        now = self.clock()
        self.tokens_total += generated
        self._window.append((now, generated))
        horizon = now - THROUGHPUT_WINDOW_SECONDS
        while self._window and self._window[0][0] < horizon:
            self._window.pop(0)
        span = now - self._window[0][0] if len(self._window) > 1 else 0.0
        if span > 0:
            rate = sum(n for _, n in self._window[1:]) / span
            metrics.serving_tokens_per_second.set(rate)
