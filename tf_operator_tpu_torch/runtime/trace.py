"""Control-plane flight recorder: reconcile tracing + decision journal.

The metric catalog (runtime/metrics.py) says HOW MUCH; nothing said
WHERE THE TIME WENT or WHY A JOB IS WAITING. This module adds the two
missing surfaces:

- **Spans** (``span(name, **attrs)``): contextvar-propagated trace
  context with deterministic ids, instrumenting the reconcile path —
  workqueue dequeue -> engine sync -> pod list/claim -> gang/quota
  pass -> checkpoint-barrier consults -> binder pass -> status writes —
  with every ``runtime/retry.py`` call a child span carrying its
  attempt count, so conflict loops and retry storms show up in the
  timeline instead of vanishing into ``api_retries_total``. Tracing is
  OFF by default; disabled, ``span()`` returns one shared no-op object
  (no allocation, no lock — near-zero cost on the hot path).

- **FlightRecorder**: completed root traces are retained under a
  keep-the-interesting-ones policy — always the slowest
  ``keep_slowest``, every errored trace, plus every ``sample_every``-th
  of the rest (the drop count is exported as
  ``trace_spans_dropped_total``). Cumulative per-span-name wall time
  (``phase_totals``) feeds bench_controlplane.py's phase attribution.
  Served as JSON at ``/debug/traces`` on the MonitoringServer and
  optionally streamed to a ``--trace-file`` JSONL.

- **DecisionJournal**: every admission defer/deny, barrier
  open/resolve, displacement, preemption, and resize decision appends
  a structured per-job record (kind, reason, message, trace id);
  consecutive identical decisions coalesce into one record with a
  count, so a level-triggered pass re-deriving the same block 50
  times is one journal line, not 50. Always on (it is the "why is my
  job Pending" answer and must not require tracing); queryable at
  ``/debug/jobs/<ns>/<name>`` and via ``TPUJobClient.explain``.

Log correlation: ``current_ids()`` is read by
``logconfig.JSONFormatter`` so every log line emitted inside a traced
sync carries ``trace_id``/``span`` and cross-references the recorded
trace (docs/observability.md).
"""

from __future__ import annotations

import contextvars
import heapq
import itertools
import json
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from tf_operator_tpu_torch.runtime import metrics

# The active span of this thread/task (None = untraced).
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_operator_trace", default=None)

# Deterministic ids: a process-wide monotonic counter, not uuids — two
# runs of the same test produce the same id sequence, and ids sort in
# creation order.
_trace_seq = itertools.count(1)


class _NoopSpan:
    """The disabled-tracing span: one shared instance, every operation
    a no-op. ``span() is span()`` holding true IS the zero-overhead
    contract (pinned by tests/test_observability.py)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _TraceBuf:
    """One in-flight trace: its id, completed-span list, and span-id
    counter. Owned by the root span; handed to the recorder when the
    root exits."""

    __slots__ = ("trace_id", "spans", "_span_seq", "t0", "t0_unix")

    def __init__(self) -> None:
        self.trace_id = f"t{next(_trace_seq):08x}"
        self.spans: List[dict] = []
        self._span_seq = itertools.count(1)
        self.t0 = time.perf_counter()
        self.t0_unix = time.time()

    def next_span_id(self) -> str:
        return f"s{next(self._span_seq)}"


class _Span:
    """An active span (tracing enabled). Completed spans are appended
    to their trace's span list as plain dicts on exit — completion
    order, with relative start offsets for timeline reconstruction."""

    __slots__ = ("name", "attrs", "buf", "span_id", "parent_id",
                 "_t0", "_token", "_root", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        parent: Optional[_Span] = _CURRENT.get()
        if parent is None:
            self.buf = _TraceBuf()
            self.parent_id = ""
            self._root = True
        else:
            self.buf = parent.buf
            self.parent_id = parent.span_id
            self._root = False
        self.span_id = self.buf.next_span_id()
        self._t0 = time.perf_counter()
        self._token = _CURRENT.set(self)
        return self

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _CURRENT.reset(self._token)
        duration = time.perf_counter() - self._t0
        record = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": round((self._t0 - self.buf.t0) * 1e3, 3),
            "duration_ms": round(duration * 1e3, 3),
        }
        if self.attrs:
            record["attrs"] = self.attrs
        if exc is not None:
            record["error"] = f"{exc_type.__name__}: {exc}"
        self.buf.spans.append(record)
        recorder = self._tracer.recorder
        recorder.note_phase(self.name, duration)
        if self._root:
            recorder.on_trace_complete(self.buf, duration,
                                       errored=exc is not None)
        return False


class FlightRecorder:
    """Ring-buffer retention of completed traces + phase accounting.

    Retention: the ``keep_slowest`` slowest-ever roots (min-heap), the
    last ``keep_errored`` errored roots, and every ``sample_every``-th
    of the rest in a ``ring``-deep sample ring. Everything else is
    dropped and counted (``trace_spans_dropped_total``) — at 10k-job
    scale the interesting syncs are the slow and broken ones, and a
    uniform sample preserves the baseline for comparison."""

    def __init__(self, keep_slowest: int = 32, keep_errored: int = 64,
                 sample_every: int = 16, ring: int = 128):
        self.keep_slowest = keep_slowest
        self.keep_errored = keep_errored
        self.sample_every = max(1, sample_every)
        self._lock = threading.Lock()
        # (duration, seq, trace_dict) min-heap: root of the heap is the
        # fastest of the retained-slowest, evicted first.
        self._slowest: List[Tuple[float, int, dict]] = []
        self._errored: deque = deque(maxlen=keep_errored)
        self._sampled: deque = deque(maxlen=ring)
        self._seen = 0
        self._heap_seq = itertools.count()
        self._phase_totals: Dict[str, float] = {}
        self._trace_file = None
        self._file_lock = threading.Lock()

    # -- ingestion -------------------------------------------------------

    def note_phase(self, name: str, seconds: float) -> None:
        """Accumulate wall time under a phase/span name. Called for
        every completed span and for phases that are not spans of one
        sync (``queue_wait`` from the workqueue, ``api_retry`` backoff
        sleeps, ``barrier_wait`` open->resolve elapsed)."""
        with self._lock:
            self._phase_totals[name] = \
                self._phase_totals.get(name, 0.0) + seconds

    def on_trace_complete(self, buf: _TraceBuf, duration: float,
                          errored: bool) -> None:
        trace = {
            "trace_id": buf.trace_id,
            "root": buf.spans[-1]["name"] if buf.spans else "",
            "start_unix": round(buf.t0_unix, 6),
            "duration_ms": round(duration * 1e3, 3),
            "errored": errored,
            "spans": buf.spans,
        }
        dropped_spans = 0
        with self._lock:
            self._seen += 1
            if errored:
                self._errored.append(trace)
            elif (len(self._slowest) < self.keep_slowest
                    or duration > self._slowest[0][0]):
                entry = (duration, next(self._heap_seq), trace)
                if len(self._slowest) < self.keep_slowest:
                    heapq.heappush(self._slowest, entry)
                else:
                    evicted = heapq.heapreplace(self._slowest, entry)
                    dropped_spans = len(evicted[2]["spans"])
            elif self._seen % self.sample_every == 0:
                if len(self._sampled) == self._sampled.maxlen:
                    dropped_spans = len(self._sampled[0]["spans"])
                self._sampled.append(trace)
            else:
                dropped_spans = len(buf.spans)
        if dropped_spans:
            metrics.trace_spans_dropped.inc(dropped_spans)
        self._stream(trace)

    def _stream(self, trace: dict) -> None:
        with self._file_lock:
            f = self._trace_file
            if f is None:
                return
            try:
                f.write(json.dumps(trace, sort_keys=True) + "\n")
                f.flush()
            except OSError:
                pass  # a full/yanked disk must not take down syncs

    # -- configuration ---------------------------------------------------

    def open_trace_file(self, path: Optional[str]) -> None:
        with self._file_lock:
            if self._trace_file is not None:
                try:
                    self._trace_file.close()
                except OSError:
                    pass
                self._trace_file = None
            if path:
                self._trace_file = open(path, "a", encoding="utf-8")

    # -- reads -----------------------------------------------------------

    def phase_totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._phase_totals)

    def snapshot(self, limit: int = 256) -> dict:
        """The /debug/traces payload: retained traces (slowest first,
        then errored, then the sample ring newest-first), capped."""
        with self._lock:
            slow = [t for _, _, t in
                    sorted(self._slowest, reverse=True)]
            errored = list(self._errored)
            sampled = list(self._sampled)[::-1]
            seen = self._seen
            totals = {k: round(v, 6)
                      for k, v in sorted(self._phase_totals.items())}
        traces = (slow + errored + sampled)[:limit]
        return {
            "traces": traces,
            "retained": {"slowest": len(slow), "errored": len(errored),
                         "sampled": len(sampled)},
            "traces_seen": seen,
            "phase_totals_s": totals,
        }

    def reset(self) -> None:
        with self._lock:
            self._slowest.clear()
            self._errored.clear()
            self._sampled.clear()
            self._seen = 0
            self._phase_totals.clear()


class Tracer:
    """The span factory. ``enabled`` is the only hot-path check: off,
    ``span()`` hands back the shared no-op."""

    def __init__(self, recorder: Optional[FlightRecorder] = None):
        self.enabled = False
        self.recorder = recorder or FlightRecorder()

    def span(self, name: str, **attrs):
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, attrs)


class DecisionJournal:
    """Per-job ring of structured control-plane decisions — the
    operator-side answer to "why is my job Pending" (no log
    archaeology). Always on: recording is a dict append under one lock,
    and level-triggered re-derivations coalesce (same kind+reason as
    the newest record bumps ``count`` and refreshes ``message``/
    ``last_time`` instead of appending).

    Bounded twice: ``per_job`` records per job (oldest dropped) and
    ``max_jobs`` jobs total (least-recently-touched job dropped) — the
    journal can never grow past ~max_jobs*per_job records no matter
    how long the operator runs. Job GC prunes entries with the job
    (tpu_controller._on_job_event)."""

    def __init__(self, per_job: int = 128, max_jobs: int = 4096):
        self.per_job = per_job
        self.max_jobs = max_jobs
        self._lock = threading.Lock()
        self._jobs: "OrderedDict[Tuple[str, str], deque]" = OrderedDict()
        self._seq = itertools.count(1)

    def record(self, namespace: str, name: str, kind: str, reason: str,
               message: str = "", **attrs) -> None:
        now = time.time()
        trace_id, span_name = current_ids()
        key = (namespace, name)
        with self._lock:
            dq = self._jobs.get(key)
            if dq is None:
                dq = deque(maxlen=self.per_job)
                self._jobs[key] = dq
                while len(self._jobs) > self.max_jobs:
                    self._jobs.popitem(last=False)
            else:
                self._jobs.move_to_end(key)
            if dq:
                last = dq[-1]
                if last["kind"] == kind and last["reason"] == reason:
                    last["count"] += 1
                    last["last_time"] = now
                    last["message"] = message
                    if trace_id:
                        last["trace_id"] = trace_id
                    return
            rec = {
                "seq": next(self._seq),
                "time": now,
                "last_time": now,
                "kind": kind,
                "reason": reason,
                "message": message,
                "trace_id": trace_id,
                "span": span_name,
                "count": 1,
            }
            if attrs:
                rec["attrs"] = attrs
            dq.append(rec)

    def decisions(self, namespace: str, name: str) -> Optional[List[dict]]:
        """The job's decision records oldest-first, or None when the
        journal has never seen the job (the endpoint's 404)."""
        with self._lock:
            dq = self._jobs.get((namespace, name))
            if dq is None:
                return None
            return [dict(r) for r in dq]

    def prune(self, namespace: str, name: str) -> None:
        with self._lock:
            self._jobs.pop((namespace, name), None)

    def reset(self) -> None:
        with self._lock:
            self._jobs.clear()


# -- process-wide instances (the metrics.REGISTRY convention) -------------

RECORDER = FlightRecorder()
TRACER = Tracer(RECORDER)
JOURNAL = DecisionJournal()


def span(name: str, **attrs):
    """Module-level convenience: ``with trace.span("gang.sync"): ...``"""
    if not TRACER.enabled:
        return NOOP_SPAN
    return _Span(TRACER, name, attrs)


def note_phase(name: str, seconds: float) -> None:
    """Attribute non-span wall time to a phase (no-op when disabled)."""
    if TRACER.enabled:
        RECORDER.note_phase(name, seconds)


def enabled() -> bool:
    return TRACER.enabled


def current_ids() -> Tuple[str, str]:
    """(trace id, span name) of the calling context, ("", "") when
    untraced. Read by the JSON log formatter and the decision journal."""
    cur = _CURRENT.get()
    if cur is None:
        return "", ""
    return cur.buf.trace_id, cur.name


def configure(enabled: bool, trace_file: Optional[str] = None) -> None:
    """Wire tracing on/off (cli.py --enable-tracing / --trace-file).
    Enabling resets nothing; disabling leaves retained traces readable
    at /debug/traces."""
    RECORDER.open_trace_file(trace_file if enabled else None)
    TRACER.enabled = enabled


def reset_for_tests() -> None:
    """Drop all recorded state and disable tracing (test isolation)."""
    configure(False)
    RECORDER.reset()
    JOURNAL.reset()
