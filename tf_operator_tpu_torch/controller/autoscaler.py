"""Serving replica autoscaler: queue depth + TTFT-SLO burn -> numSlices
(port of tf_operator_tpu/controller/autoscaler.py, copied).

The policy loop behind ``--enable-serving-autoscaler`` (ROADMAP item
3(a), now resolved): for every elastic serving gang whose ServingPolicy
sets ``targetQueueDepthPerSlice``, map the observed request backlog and
TTFT-SLO burn to a ``numSlices`` target and ride the EXISTING elastic
resize pass (controller/gang.py ``_resize``/``try_shrink``) to land it.
Nothing here bypasses the resize invariants: shrinks complete the
save-before-evict barrier (in-flight requests re-spool, zero drops),
grows clamp at ``maxSlices``, and every applied resize is the same
world-restart the training plane uses — world resize is the unit of
elasticity on device slices, not per-replica scale.

Policy (docs/serving.md autoscaler section):

- target = ceil(queue_depth / targetQueueDepthPerSlice), clamped to the
  gang's ``minSlices``/``maxSlices`` band;
- TTFT-SLO burn — measured p99 over ``ttftP99SloSeconds`` (via
  ``Histogram.quantile``) — forces at least one slice of growth even
  when the backlog alone would not (latency can burn while depth looks
  fine: slots saturated by long generations);
- hysteresis: scale-UP applies immediately (a burst is already hurting
  TTFT); scale-DOWN only after demand sat below the current size
  continuously for ``scaleDownCooldownSeconds`` — a square-wave trace
  produces at most one resize per direction per period;
- holds (wanted a different size but did not act) are counted in
  ``autoscaler_holds_total{reason}`` with reason ``cooldown`` (shrink
  window still open), ``settling`` (a prior resize has not completed),
  or ``bounds`` (target clamped back to the current size).

Every decision — up, down, or hold — lands in the DecisionJournal
(``autoscale.up`` / ``autoscale.down`` / ``autoscale.hold``) and is
served at ``/debug/jobs/<ns>/<name>``; applied resizes additionally
count in ``gang_resizes_total{reason="autoscale"}`` like any other
elastic resize.

Signals: the default provider reads the job's spool backlog directly
(``pending/`` file count — the one global depth signal the operator can
observe without scraping replicas) and the ambient
``serving_ttft_seconds`` histogram (live for in-process benchmarks and
tests; production deployments scrape per-replica /metrics and inject a
provider). The autoscaler doubles as the gang scheduler's
``resize_signals`` provider, so the values that drove a decision are
attached to the resize record/event.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Dict, Optional

from tf_operator_tpu_torch.controller.serving import job_serving_policy
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.store import Store

log = logging.getLogger("tpu_operator.autoscaler")

SIGNAL_QUEUE_DEPTH = "serving_queue_depth"
SIGNAL_TTFT_P99 = "serving_ttft_p99_seconds"

HOLD_COOLDOWN = "cooldown"
HOLD_SETTLING = "settling"
HOLD_BOUNDS = "bounds"


def spool_pending_depth(spool_root: str) -> float:
    """Global request backlog of a spool: pending/ file count. Zero on
    any filesystem hiccup — a transient misread must not trigger a
    world resize."""
    try:
        return float(sum(1 for n in os.listdir(
            os.path.join(spool_root, "pending")) if n.endswith(".json")))
    except OSError:
        return 0.0


class ServingAutoscaler:
    """One policy loop over every autoscalable serving gang.

    ``signals`` overrides the measurement seam: a callable
    ``(namespace, name) -> {signal: value}`` returning
    ``serving_queue_depth`` (required) and optionally
    ``serving_ttft_p99_seconds``. Benchmarks and tests inject
    synthetic traffic through it; the default reads the job's spool +
    the ambient TTFT histogram (module docstring).
    """

    def __init__(self, store: Store, gang, namespace: Optional[str] = None,
                 interval_seconds: float = 1.0, signals=None,
                 clock=time.monotonic):
        self.store = store
        self.gang = gang
        self.namespace = namespace
        self.interval_seconds = interval_seconds
        self._signals = signals
        self.clock = clock
        # (ns, name) -> clock() when demand FIRST sat below the current
        # size; cleared whenever demand reaches the current size again,
        # so the cooldown window measures continuous under-demand.
        self._below_since: Dict[tuple, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals ---------------------------------------------------------

    def signals(self, namespace: str, name: str) -> Dict[str, float]:
        """Signal values for one gang — also wired as the gang
        scheduler's ``resize_signals`` provider (operator.py), so
        resize records/events carry what the decision saw."""
        if self._signals is not None:
            try:
                return dict(self._signals(namespace, name) or {})
            except Exception:
                log.debug("injected signal provider failed", exc_info=True)
                return {}
        job = self.store.try_get(store_mod.TPUJOBS, namespace, name)
        policy = job_serving_policy(job) if job is not None else None
        if policy is None or not policy.spool_directory:
            return {}
        out = {SIGNAL_QUEUE_DEPTH:
               spool_pending_depth(policy.spool_directory)}
        p99 = metrics.serving_ttft_seconds.quantile(0.99)
        if p99 is not None:
            out[SIGNAL_TTFT_P99] = p99
        return out

    # -- policy ----------------------------------------------------------

    def evaluate_once(self) -> None:
        """One pass over every candidate job (the loop body; tests and
        benchmarks call it directly for deterministic stepping)."""
        try:
            jobs = self.store.list(store_mod.TPUJOBS,
                                   namespace=self.namespace)
        except Exception:
            log.debug("autoscaler job listing failed", exc_info=True)
            return
        for job in jobs:
            try:
                self._evaluate_job(job)
            except Exception:
                log.exception("autoscaler pass failed for %s/%s",
                              job.metadata.namespace, job.metadata.name)

    def _evaluate_job(self, job) -> None:
        policy = job_serving_policy(job)
        if policy is None or policy.target_queue_depth_per_slice is None:
            return
        sl = job.spec.slice
        if not sl.accelerator or (sl.min_slices is None
                                  and sl.max_slices is None):
            return  # not an elastic gang: nothing to resize
        ns, name = job.metadata.namespace, job.metadata.name
        key = (ns, name)
        cur = sl.num_slices
        mn = sl.min_slices if sl.min_slices is not None else 1
        mx = sl.max_slices if sl.max_slices is not None else cur

        sig = self.signals(ns, name)
        depth = float(sig.get(SIGNAL_QUEUE_DEPTH, 0.0))
        want = max(mn, math.ceil(
            depth / max(1, policy.target_queue_depth_per_slice)))
        reason = "queue-depth"
        p99 = sig.get(SIGNAL_TTFT_P99)
        slo = policy.ttft_p99_slo_seconds
        if (slo is not None and p99 is not None and p99 > slo
                and want <= cur):
            # SLO burn with no backlog-driven growth: add one slice.
            want = cur + 1
            reason = "ttft-slo"
        target = min(max(want, mn), mx)
        metrics.autoscaler_target_slices.set(target, job_namespace=ns,
                                             job=name)
        detail = (f"queue_depth={depth:g} "
                  f"target_per_slice={policy.target_queue_depth_per_slice} "
                  + (f"ttft_p99={p99:g}s slo={slo:g}s "
                     if p99 is not None and slo is not None else "")
                  + f"want={want} target={target} current={cur}")

        if target >= cur:
            # Demand covers the current size: any open cooldown window
            # ends (under-demand was not continuous).
            self._below_since.pop(key, None)
        if target == cur:
            if want != cur:
                # Wanted more (or fewer) than the band allows.
                metrics.autoscaler_holds.inc(reason=HOLD_BOUNDS)
                trace_mod.JOURNAL.record(
                    ns, name, "autoscale.hold", HOLD_BOUNDS,
                    f"target clamped to {target} "
                    f"({mn}..{mx} band): {detail}")
            return
        if self.gang is None:
            return
        group = self.store.try_get(store_mod.SLICEGROUPS, ns, name)
        if group is not None and group.status.resizing_reason:
            metrics.autoscaler_holds.inc(reason=HOLD_SETTLING)
            trace_mod.JOURNAL.record(
                ns, name, "autoscale.hold", HOLD_SETTLING,
                f"previous resize still settling "
                f"({group.status.resizing_reason}); {detail}")
            return

        if target > cur:
            trace_mod.JOURNAL.record(ns, name, "autoscale.up", reason,
                                     detail, slices=target)
            self.gang._resize(ns, name, target, "grow", "autoscale",
                              f"autoscale: {detail}")
            return

        # target < cur: shrink only after continuous under-demand.
        now = self.clock()
        since = self._below_since.setdefault(key, now)
        if now - since < policy.scale_down_cooldown_seconds:
            metrics.autoscaler_holds.inc(reason=HOLD_COOLDOWN)
            trace_mod.JOURNAL.record(
                ns, name, "autoscale.hold", HOLD_COOLDOWN,
                f"scale-down window open "
                f"({now - since:.1f}s/"
                f"{policy.scale_down_cooldown_seconds:g}s); {detail}")
            return
        trace_mod.JOURNAL.record(ns, name, "autoscale.down", reason,
                                 detail, slices=target)
        landed = self.gang.try_shrink(ns, name, cur - target, "autoscale",
                                      f"autoscale: {detail}")
        if landed:
            self._below_since.pop(key, None)
        elif landed is False:
            # Applicable but held (barrier in flight / degraded / racing
            # resize): the next pass retries off fresh state.
            metrics.autoscaler_holds.inc(reason=HOLD_SETTLING)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ServingAutoscaler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="serving-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            self.evaluate_once()
            self._stop.wait(self.interval_seconds)
