"""In-memory object store with watch — the API-server/etcd analog.

The reference talks to the Kubernetes API server through clientsets and
shared informers (pkg/client/, cmd/tf-operator.v1/app/server.go:129-144).
This store provides the same contract process-natively so the whole
control loop runs hermetically:

- CRUD with uid assignment, resourceVersion bumps and optimistic
  concurrency on update;
- label-selector list;
- watch: registered handlers receive (ADDED/MODIFIED/DELETED, object)
  callbacks on a dispatcher thread per watcher (informer analog). Every
  event is deepcopied ONCE and that snapshot is shared by all watchers
  — handlers must not mutate delivered objects (the informer-cache
  immutability discipline the reference relies on, controller.go:325).
  A per-kind watch log lets reconnecting watchers resume from a known
  resourceVersion (``watch(since_rv=...)``) instead of replaying the
  world as ADDED.

Scale discipline (the reconcile hot path syncs ~1k jobs x ~10k pods):

- Two indexes are maintained on every write — per
  ``(namespace, job-name label)`` and per controller-owner UID — so
  ``list_claimable`` and ``owned_keys`` touch only a job's own objects
  instead of scanning the namespace (client-go Indexer analog).
- Stored objects are never mutated in place: every write deepcopies the
  inbound object and REPLACES the slot, so a stored object is an
  immutable snapshot from the moment it lands. ``list_claimable``
  exploits that by returning the stored objects themselves (frozen;
  callers deepcopy before mutating) instead of deepcopying the whole
  claimed set on every sync.
"""

from __future__ import annotations

import collections
import copy
import datetime as _dt
import queue
import threading
import uuid
from typing import Callable, Dict, List, Optional, Tuple

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

# Per-kind watch-log capacity: a reconnecting watcher with a known
# resourceVersion replays deltas from this ring (watch-cache hit); a
# resume point older than the ring's tail falls back to the full ADDED
# replay. Sized for reconnect windows (seconds of events), not history.
WATCH_LOG_CAPACITY = 4096

# The label both indexes and the controller's base selector key on
# (api/constants.LABEL_JOB_NAME; duplicated literally — the store must
# stay importable without the api package).
INDEX_LABEL_JOB_NAME = "job-name"


class ConflictError(Exception):
    pass


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(Exception):
    pass


def matches_selector(labels: Dict[str, str],
                     selector: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def rv_number(rv) -> Optional[int]:
    """A resourceVersion as a number, to tell an older read from a newer
    one (this store's are ints, the API server's decimal strings); None
    where it is not one."""
    try:
        return int(rv)
    except (TypeError, ValueError):
        return None


class Watcher:
    def __init__(self, kind: str, handler: Callable[[str, object], None]):
        self.kind = kind
        self.handler = handler
        self.queue: "queue.Queue[Optional[Tuple[str, object]]]" = queue.Queue()
        self.error_count = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            event_type, obj = item
            try:
                self.handler(event_type, obj)
            except Exception:  # watch handlers must never kill the dispatcher
                # Swallowed-but-accounted: the traceback logs ONCE per
                # handler (a broken handler throws on every event — one
                # stack is diagnosis, thousands are log spam) and every
                # occurrence lands in the
                # store_watch_handler_errors_total{kind} metric so a
                # silently-failing reconcile trigger is visible on a
                # dashboard instead of only in drowned logs.
                import logging

                from tf_operator_tpu_torch.runtime import metrics

                self.error_count += 1
                metrics.store_watch_handler_errors.inc(kind=self.kind)
                logger = logging.getLogger("tpu_operator.store")
                if self.error_count == 1:
                    logger.exception(
                        "watch handler error for %s (first occurrence; "
                        "further ones are counted in "
                        "store_watch_handler_errors_total and logged "
                        "without traceback)", self.kind)
                else:
                    logger.warning(
                        "watch handler error for %s (%d so far)",
                        self.kind, self.error_count)

    def stop(self) -> None:
        # Deregister from the store first so _notify stops enqueueing
        # into a dead queue (unbounded growth otherwise).
        on_stop = getattr(self, "_on_stop", None)
        if on_stop is not None:
            on_stop(self)
        self.queue.put(None)


class Store:
    def __init__(self):
        self._lock = threading.RLock()
        # kind -> {(namespace, name) -> obj}
        self._objects: Dict[str, Dict[Tuple[str, str], object]] = {}
        self._watchers: List[Watcher] = []
        # Last-assigned resourceVersion (plain int, not an iterator, so
        # latest_rv() can answer without consuming one).
        self._rv = 0
        # (kind, namespace, job-name label) -> {(ns, name), ...}
        self._label_index: Dict[Tuple[str, str, str], set] = {}
        # (kind, controller-owner uid) -> {(ns, name), ...}
        self._owner_index: Dict[Tuple[str, str], set] = {}
        # kind -> deque[(event rv, event type, frozen stored object)]:
        # the watch cache. Appended under the lock by every write;
        # watch(since_rv=...) replays deltas from it.
        self._watch_log: Dict[str, collections.deque] = {}
        # kind -> highest event rv ever evicted from the log (a resume
        # at or before this point has a gap -> full replay).
        self._watch_log_evicted: Dict[str, int] = {}
        # Plain-int mirrors of the watch-cache/pagination metrics, for
        # benches and tests that read the store without scraping the
        # registry (the registry is process-global and shared).
        self.watch_cache_hits = 0
        self.watch_cache_misses = 0
        self.list_pages = 0

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def latest_rv(self) -> int:
        """Highest resourceVersion assigned so far (0 = no writes yet):
        the resume point a watcher passes back as ``since_rv``."""
        with self._lock:
            return self._rv

    # -- indexes (maintained under the lock on every write) ---------------

    def _index_add(self, kind: str, key: Tuple[str, str], obj) -> None:
        job_name = obj.metadata.labels.get(INDEX_LABEL_JOB_NAME)
        if job_name:
            self._label_index.setdefault(
                (kind, key[0], job_name), set()).add(key)
        ref = obj.metadata.controller_ref()
        if ref is not None and ref.uid:
            self._owner_index.setdefault((kind, ref.uid), set()).add(key)

    def _index_remove(self, kind: str, key: Tuple[str, str], obj) -> None:
        job_name = obj.metadata.labels.get(INDEX_LABEL_JOB_NAME)
        if job_name:
            bucket = self._label_index.get((kind, key[0], job_name))
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._label_index[(kind, key[0], job_name)]
        ref = obj.metadata.controller_ref()
        if ref is not None and ref.uid:
            bucket = self._owner_index.get((kind, ref.uid))
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._owner_index[(kind, ref.uid)]

    # -- CRUD -------------------------------------------------------------

    def create(self, kind: str, obj) -> object:
        with self._lock:
            coll = self._objects.setdefault(kind, {})
            key = (obj.metadata.namespace, obj.metadata.name)
            if key in coll:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            # Identity is stamped on the CALLER's object and a deepcopy
            # becomes the stored snapshot — one copy per create (this
            # used to copy twice: once in, once back out). The return
            # value stays caller-owned and mutable; the store never
            # retains a reference to it.
            if not obj.metadata.uid:
                obj.metadata.uid = str(uuid.uuid4())
            if obj.metadata.creation_timestamp is None:
                obj.metadata.creation_timestamp = _dt.datetime.now(
                    _dt.timezone.utc)
            obj.metadata.resource_version = self._next_rv()
            stored = obj.deepcopy()
            coll[key] = stored
            self._index_add(kind, key, stored)
            self._notify(kind, ADDED, stored)
            return obj

    def get(self, kind: str, namespace: str, name: str) -> object:
        with self._lock:
            try:
                return self._objects[kind][(namespace, name)].deepcopy()
            except KeyError:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")

    def get_snapshot(self, kind: str, namespace: str, name: str):
        """The stored object itself — FROZEN — or None. The zero-copy
        point read: stored objects are never mutated in place (every
        write replaces the slot), so the snapshot stays valid forever;
        the caller must treat it as immutable and ``deepcopy()`` before
        mutating (the ``list_claimable`` contract, for a single key)."""
        with self._lock:
            return self._objects.get(kind, {}).get((namespace, name))

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[Dict[str, str]] = None) -> List[object]:
        with self._lock:
            out = []
            for (ns, _), obj in self._objects.get(kind, {}).items():
                if namespace is not None and ns != namespace:
                    continue
                if selector and not matches_selector(obj.metadata.labels,
                                                     selector):
                    continue
                out.append(obj.deepcopy())
            return out

    def project(self, kind: str, fn, namespace: Optional[str] = None):
        """Read-only projection under the lock WITHOUT deepcopying:
        collects ``fn(obj)`` for every object, skipping ``None``
        results. ``fn`` must treat the object as frozen — no mutation,
        no retaining references past the call (the cheap-scan pattern
        of list_claimable, generalized; a full list() deepcopies every
        payload, which hot per-sync scans must not)."""
        out = []
        with self._lock:
            for (ns, _), obj in self._objects.get(kind, {}).items():
                if namespace is not None and ns != namespace:
                    continue
                v = fn(obj)
                if v is not None:
                    out.append(v)
        return out

    def list_claimable(self, kind: str, namespace: str,
                       selector: Dict[str, str],
                       owner_uid: str) -> List[object]:
        """Objects a controller's claim pass must see: label matches OR
        already owned by ``owner_uid`` (covers owned objects whose
        labels stopped matching, which release needs).

        O(owned): candidates come from the job-name-label and owner-UID
        indexes, so a namespace full of other jobs' pods costs nothing
        (pre-index this scanned — and a full list() deepcopied — every
        object in the namespace per job sync). Falls back to the scan
        only for selectors without the indexed label.

        Returns FROZEN shared snapshots, not copies: stored objects are
        never mutated in place (every write replaces the slot), so the
        only contract is on the caller — treat the result as immutable
        and ``deepcopy()`` any object before mutating it (the claim
        pass does exactly that on its rare adopt/release edges)."""
        with self._lock:
            coll = self._objects.get(kind, {})
            job_name = (selector or {}).get(INDEX_LABEL_JOB_NAME)
            if job_name is None:
                candidates = [k for k in coll if k[0] == namespace]
            else:
                keys = set(self._label_index.get(
                    (kind, namespace, job_name), ()))
                keys.update(self._owner_index.get((kind, owner_uid), ()))
                candidates = sorted(keys)  # deterministic sync order
            out = []
            for key in candidates:
                obj = coll.get(key)
                if obj is None or key[0] != namespace:
                    continue
                if not matches_selector(obj.metadata.labels, selector):
                    ref = obj.metadata.controller_ref()
                    if ref is None or ref.uid != owner_uid:
                        continue
                out.append(obj)
            return out

    def owned_keys(self, kind: str, owner_uid: str) -> List[Tuple[str, str]]:
        """(namespace, name) keys of objects whose controller
        ownerReference is ``owner_uid`` — O(owned) via the owner index,
        no payload copies. The garbage-collection primitive: cascade
        deletes used to re-list (and deepcopy) whole namespaces."""
        with self._lock:
            return sorted(self._owner_index.get((kind, owner_uid), ()))

    def update(self, kind: str, obj) -> object:
        """Full-object update with optimistic concurrency: the caller's
        resourceVersion must match the stored one."""
        with self._lock:
            coll = self._objects.setdefault(kind, {})
            key = (obj.metadata.namespace, obj.metadata.name)
            current = coll.get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key} not found")
            if (obj.metadata.resource_version
                    and obj.metadata.resource_version
                    != current.metadata.resource_version):
                raise ConflictError(
                    f"{kind} {key}: resourceVersion "
                    f"{obj.metadata.resource_version} != "
                    f"{current.metadata.resource_version}")
            # Same one-copy discipline as create: stamp the caller's
            # object, store a deepcopy, hand the caller's own object
            # back (its resourceVersion now current, so a follow-up
            # CAS write passes without a re-read).
            obj.metadata.uid = current.metadata.uid
            obj.metadata.creation_timestamp = current.metadata.creation_timestamp
            obj.metadata.resource_version = self._next_rv()
            stored = obj.deepcopy()
            self._index_remove(kind, key, current)
            coll[key] = stored
            self._index_add(kind, key, stored)
            self._notify(kind, MODIFIED, stored)
            return obj

    def update_status(self, kind: str, obj) -> object:
        """Status-subresource-style update: merges only .status (and
        completion metadata) into the stored object, avoiding spec clobber."""
        with self._lock:
            coll = self._objects.setdefault(kind, {})
            key = (obj.metadata.namespace, obj.metadata.name)
            current = coll.get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key} not found")
            # Zero-copy merge: the new stored snapshot SHARES the
            # current one's frozen spec (neither is ever mutated in
            # place); only .status — the part that changed — is
            # deepcopied. This is the hottest write in the system (one
            # per kubelet phase transition and one per controller
            # sync), and it used to deepcopy the whole object twice
            # plus the status. The caller's resourceVersion is synced
            # in place so its working copy stays current; the return
            # is the FROZEN stored snapshot (callers treat it as
            # immutable, like every other snapshot read).
            stored = copy.copy(current)
            stored.metadata = copy.copy(current.metadata)
            stored.status = obj.status.deepcopy()
            stored.metadata.resource_version = self._next_rv()
            obj.metadata.resource_version = stored.metadata.resource_version
            # No index maintenance: a status merge cannot change the
            # labels/ownerRefs the (key-valued) indexes are built from.
            coll[key] = stored
            self._notify(kind, MODIFIED, stored)
            return stored

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            coll = self._objects.get(kind, {})
            obj = coll.pop((namespace, name), None)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            self._index_remove(kind, (namespace, name), obj)
            # The DELETED event carries a fresh resourceVersion (on a
            # shallow tombstone — the popped snapshot stays frozen) so
            # resumed watchers order the delete after the object's last
            # modification and reconnecting clients can advance their
            # resume point past it.
            tomb = copy.copy(obj)
            tomb.metadata = copy.copy(obj.metadata)
            tomb.metadata.resource_version = self._next_rv()
            self._notify(kind, DELETED, tomb)

    def try_delete(self, kind: str, namespace: str, name: str) -> bool:
        try:
            self.delete(kind, namespace, name)
            return True
        except NotFoundError:
            return False

    def count(self, kind: str) -> int:
        """Object count without the deepcopy cost of list()."""
        with self._lock:
            return len(self._objects.get(kind, {}))

    def keys(self, kind: str) -> List[Tuple[str, str, int]]:
        """(namespace, name, resourceVersion) tuples without deepcopying
        payloads — for pruning/housekeeping over large collections."""
        with self._lock:
            return [(ns, name, obj.metadata.resource_version)
                    for (ns, name), obj in self._objects.get(kind, {}).items()]

    def list_page(self, kind: str, namespace: Optional[str] = None,
                  selector: Optional[Dict[str, str]] = None,
                  limit: Optional[int] = None,
                  after: Optional[Tuple[str, str]] = None):
        """One page of a keyset-paginated list. Returns
        ``(items, next_after, rv)``: items sorted by (namespace, name)
        strictly after the ``after`` cursor, at most ``limit`` of them;
        feed ``next_after`` back as ``after`` to continue (None = walk
        complete); ``rv`` is the store's resourceVersion when the page
        was cut. The strictly-increasing key cursor makes a page walk
        exactly-once for every object that exists for its whole
        duration, regardless of concurrent writes between pages. Items
        are FROZEN stored snapshots — treat as immutable (serialize or
        deepcopy, never mutate)."""
        with self._lock:
            self.list_pages += 1
            from tf_operator_tpu_torch.runtime import metrics

            metrics.list_pages.inc(kind=kind)
            coll = self._objects.get(kind, {})
            items: List[object] = []
            next_after = None
            for key in sorted(coll):
                if after is not None and key <= tuple(after):
                    continue
                obj = coll[key]
                if namespace is not None and key[0] != namespace:
                    continue
                if selector and not matches_selector(obj.metadata.labels,
                                                     selector):
                    continue
                items.append(obj)
                if limit is not None and limit > 0 and len(items) >= limit:
                    next_after = key
                    break
            return items, next_after, self._rv

    # -- watch ------------------------------------------------------------

    def watch(self, kind: str,
              handler: Callable[[str, object], None],
              replay: bool = True,
              since_rv: Optional[int] = None) -> Watcher:
        """Register a handler; with ``replay`` existing objects are
        delivered as ADDED first (informer initial list).

        ``since_rv`` is the reconnect path: "I have seen every event up
        to and including this resourceVersion". When the per-kind watch
        log still covers that point, only the missed deltas replay, in
        order (watch-cache hit — no ADDED storm); when the log has
        evicted past it, the watcher falls back to the full ADDED
        replay (miss — the reflector relist contract)."""
        with self._lock:
            w = Watcher(kind, handler)
            w._on_stop = self._remove_watcher
            replay_all = replay
            if since_rv is not None:
                if since_rv >= self._watch_log_evicted.get(kind, 0):
                    self.watch_cache_hits += 1
                    from tf_operator_tpu_torch.runtime import metrics

                    metrics.watch_cache_hits.inc(kind=kind)
                    for entry_rv, et, obj in self._watch_log.get(kind, ()):
                        if entry_rv > since_rv:
                            w.queue.put((et, obj.deepcopy()))
                    replay_all = False
                else:
                    self.watch_cache_misses += 1
            if replay_all:
                for obj in self._objects.get(kind, {}).values():
                    w.queue.put((ADDED, obj.deepcopy()))
            self._watchers.append(w)
            return w

    def _remove_watcher(self, w: Watcher) -> None:
        with self._lock:
            try:
                self._watchers.remove(w)
            except ValueError:
                pass  # already removed (stop_watchers or double stop)

    def stop_watchers(self) -> None:
        with self._lock:
            watchers, self._watchers = self._watchers, []
        for w in watchers:
            w.stop()

    def _notify(self, kind: str, event_type: str, obj) -> None:
        # Callers hold self._lock. The frozen stored object lands in
        # the watch log (no copy — it is immutable); live watchers all
        # receive ONE shared deepcopy per event instead of one each
        # (handlers already must not mutate delivered objects; at fan-
        # out degree W this was W deepcopies per write).
        wlog = self._watch_log.setdefault(kind, collections.deque())
        wlog.append((obj.metadata.resource_version, event_type, obj))
        while len(wlog) > WATCH_LOG_CAPACITY:
            self._watch_log_evicted[kind] = wlog.popleft()[0]
        snap = None
        for w in self._watchers:
            if w.kind == kind:
                if snap is None:
                    snap = obj.deepcopy()
                w.queue.put((event_type, snap))


# Canonical collection names.
TPUJOBS = "tpujobs"
PODS = "pods"
ENDPOINTS = "endpoints"
SLICEGROUPS = "slicegroups"
EVENTS = "events"
NODES = "nodes"
# Multi-tenant admission (controller/quota.py). TENANTQUEUES is
# namespaced; CLUSTERQUEUES is cluster-scoped (stored under the
# reserved namespace "").
TENANTQUEUES = "tenantqueues"
CLUSTERQUEUES = "clusterqueues"
# Checkpoint coordination (controller/ckpt.py): one record per replica,
# named after the pod, labeled job-name — the save-before-evict barrier's
# ack channel and the restore-step source.
CHECKPOINTRECORDS = "checkpointrecords"
