"""GPUJobController: the concrete operator on top of the generic engine
(port of tf_operator_tpu/controller/tpu_controller.py ``TPUJobController``;
it differs only in ``set_cluster_spec``, which stamps ``nvidia.com/gpu``
and renders the GPU bootstrap env, and in the bootstrap hash over that
env).

Reference parity: pkg/controller.v1/tensorflow/controller.go (controller
struct, worker loop, expectation gate, enqueue handlers), job.go (add/
update handlers, invalid-spec failure), pod.go (adoption via
ControllerRefManager), status.go (success policy) — wired to the
process-native Store instead of the K8s API server.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from tf_operator_tpu_torch.api import constants, set_defaults
from tf_operator_tpu_torch.api.types import (
    Endpoint,
    Pod,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    JobConditionType,
    effective_role_policy,
    elastic_role_types,
)
from tf_operator_tpu_torch.api.validation import (
    ValidationError,
    validate_job,
    validation_warnings,
)
from tf_operator_tpu_torch.bootstrap import learner_endpoints, render_worker_env
from tf_operator_tpu_torch.bootstrap.cluster import is_distributed, pod_gpus
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.controller import status as status_mod
from tf_operator_tpu_torch.controller.control import (
    EndpointControl,
    PodControl,
    controller_owner_ref,
)
from tf_operator_tpu_torch.controller.engine import EngineConfig, JobEngine, JobPlugin
from tf_operator_tpu_torch.controller.expectations import (
    ControllerExpectations,
    expectation_key,
)
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime import trace as trace_mod
from tf_operator_tpu_torch.runtime.leaderelection import shard_for
from tf_operator_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    Recorder,
)
from tf_operator_tpu_torch.runtime.store import ADDED, DELETED, Store
from tf_operator_tpu_torch.runtime.workqueue import RateLimitingQueue, ShutDown

log = logging.getLogger("tpu_operator.controller")

CONTROLLER_NAME = "tpujob-controller"

SUCCESSFUL_CREATE_POD_REASON = "SuccessfulCreatePod"
FAILED_CREATE_POD_REASON = "FailedCreatePod"
SUCCESSFUL_DELETE_POD_REASON = "SuccessfulDeletePod"
FAILED_DELETE_POD_REASON = "FailedDeletePod"

# A job read older than one a sync already saw is read again this much
# later, at most this many times in a row (_fetch_job): about 2 s.
# Kubernetes calls resourceVersions opaque, and a restore of the API
# server's storage can move them back for good; past the bound the read
# is acted on.
STALE_READ_RETRY_SECONDS = 0.05
STALE_READ_RETRIES = 40
_STALE = object()


class StorePodControl(PodControl):
    """RealPodControl analog (control/pod_control.go:66+): creates stamp
    owner refs and emit success/failure events."""

    def __init__(self, store: Store, recorder: Recorder):
        self.store = store
        self.recorder = recorder

    def create_pod(self, namespace: str, pod: Pod, job: TPUJob) -> None:
        pod.metadata.namespace = namespace
        pod.metadata.owner_references = [controller_owner_ref(job)]
        try:
            self.store.create(store_mod.PODS, pod)
        except Exception as e:
            self.recorder.event(job, EVENT_TYPE_WARNING,
                                FAILED_CREATE_POD_REASON,
                                f"Error creating: {e}")
            raise
        self.recorder.event(job, EVENT_TYPE_NORMAL,
                            SUCCESSFUL_CREATE_POD_REASON,
                            f"Created pod: {pod.metadata.name}")
        metrics.created_pods.inc(job_namespace=namespace)

    def delete_pod(self, namespace: str, name: str, job: TPUJob) -> None:
        try:
            self.store.delete(store_mod.PODS, namespace, name)
        except store_mod.NotFoundError:
            return  # already gone: deletion is level-triggered
        except Exception as e:
            self.recorder.event(job, EVENT_TYPE_WARNING,
                                FAILED_DELETE_POD_REASON,
                                f"Error deleting: {e}")
            raise
        self.recorder.event(job, EVENT_TYPE_NORMAL,
                            SUCCESSFUL_DELETE_POD_REASON,
                            f"Deleted pod: {name}")
        metrics.deleted_pods.inc(job_namespace=namespace)


class StoreEndpointControl(EndpointControl):
    def __init__(self, store: Store, recorder: Recorder):
        self.store = store
        self.recorder = recorder

    def create_endpoint(self, namespace: str, endpoint: Endpoint,
                        job: TPUJob) -> None:
        endpoint.metadata.namespace = namespace
        endpoint.metadata.owner_references = [controller_owner_ref(job)]
        self.store.create(store_mod.ENDPOINTS, endpoint)
        metrics.created_endpoints.inc(job_namespace=namespace)

    def delete_endpoint(self, namespace: str, name: str, job: TPUJob) -> None:
        try:
            self.store.delete(store_mod.ENDPOINTS, namespace, name)
        except store_mod.NotFoundError:
            return
        metrics.deleted_endpoints.inc(job_namespace=namespace)


class GPUJobController(JobPlugin):
    def __init__(self, store: Store,
                 recorder: Optional[Recorder] = None,
                 config: Optional[EngineConfig] = None,
                 gang=None,
                 namespace: Optional[str] = None,
                 ckpt=None,
                 cp_health=None,
                 serving=None,
                 relay_dir: str = "",
                 shard_index: Optional[int] = None,
                 shard_count: int = 1):
        self.store = store
        self.recorder = recorder or Recorder()
        self.namespace = namespace  # None = all namespaces
        # Sharded ownership (runtime/leaderelection.py ShardMap): with
        # shard_count > 1 this controller reconciles ONLY jobs whose
        # shard_for(namespace, uid) hash lands on shard_index — event
        # handlers drop foreign jobs cheaply and _sync_tpujob enforces
        # it authoritatively, so a stray enqueue can never cause a
        # double-reconcile across holders.
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.workqueue = RateLimitingQueue()
        self.expectations = ControllerExpectations()
        # Optional checkpoint coordinator (controller/ckpt.py): renders
        # restore-with-identity env into created pods and rolls the
        # barrier arc into job status (via the engine hook).
        self.ckpt = ckpt
        # Node-agent relay directory (--agent-relay-dir, kube backend):
        # pods that participate in checkpoint/serving coordination get
        # this hostPath mounted, a per-incarnation relay token, and
        # TPUJOB_PREEMPT_FILE / TPUJOB_CKPT_FILE env pointing into it
        # (runtime/relay.py path contract). Empty = no relay rendering
        # (the local data plane injects its own paths at spawn time).
        self.relay_dir = relay_dir
        # Optional serving manager (controller/serving.py): renders
        # ServingPolicy env into serving-role pods. None (the
        # --enable-serving default) leaves the serving role inert.
        self.serving = serving
        # Optional ControlPlaneHealth (runtime/retry.py): write paths
        # report outcomes into it; the engine surfaces degraded mode as
        # a job condition; gang/health defer disruptions off it.
        self.cp_health = cp_health
        self.engine = JobEngine(
            plugin=self,
            pod_control=StorePodControl(store, self.recorder),
            endpoint_control=StoreEndpointControl(store, self.recorder),
            recorder=self.recorder,
            workqueue=self.workqueue,
            expectations=self.expectations,
            gang=gang,
            config=config,
            ckpt=ckpt,
            cp_health=cp_health,
        )
        if gang is not None and getattr(gang, "pod_control", None) is None:
            # Preemption evicts victim pods through the same control the
            # engine uses (KubeJobController re-binds after swapping in
            # its API-backed control; an explicitly passed pod_control
            # is never overwritten — see _pod_control_auto_bound).
            gang.pod_control = self.engine.pod_control
            gang._pod_control_auto_bound = True
        self._watchers = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # (job uid, rtype) -> (resourceVersion, digest). Single-writer
        # per key (the workqueue serializes a job's syncs), so plain
        # dict ops are safe at threadiness > 1.
        self._hash_cache: Dict[tuple, tuple] = {}
        # (ns, name) -> (defaulted working copy, stored-spec reference),
        # valid while the copy's (uid, resourceVersion) match the
        # store's frozen snapshot AND the snapshot's spec IS the same
        # object we fetched (identity, not equality). The store syncs
        # the working copy's resourceVersion in place on every status
        # write, so in steady state a sync re-fetches its own last
        # write as a cache hit — ZERO deepcopies on the sync read path
        # (the old job.fetch deepcopy was 25% of sync time at 200x16).
        # The spec-identity check closes the stamp-masking hole: a
        # status write lands on top of a concurrent spec write (e.g.
        # an elastic resize inside this very sync) without a conflict,
        # stamping the STALE working copy to the latest RV. Status
        # merges share the stored spec object by reference while every
        # spec write stores a fresh copy, so `is` detects exactly the
        # writes the RV check can be blinded to. Same single-writer-
        # per-key safety argument as _hash_cache.
        self._job_cache: Dict[tuple, tuple] = {}
        # (namespace, name) -> (uid, the newest resourceVersion a sync
        # has read). A read older than that is stale (a lagging cache or
        # follower read) and is not acted on: a stale spec would bring
        # back a world the job has left, e.g. a gang's slices after an
        # elastic shrink.
        self._job_rv: Dict[tuple, tuple] = {}
        # (namespace, name) -> stale reads in a row (STALE_READ_RETRIES).
        self._stale_reads: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    # Informer handlers (reference controller.go:140-180, pod.go:73-214)
    # ------------------------------------------------------------------

    def start_watching(self, since_rv: Optional[int] = None) -> None:
        # since_rv is the takeover fast path (sharded failover, crash
        # restart against a surviving store): resume the watches from
        # the store's watch log instead of a full ADDED replay. The
        # caller must pair it with one resync sweep of owned jobs —
        # events at or before since_rv never replay.
        self._watchers = [
            self.store.watch(store_mod.TPUJOBS, self._on_job_event,
                             since_rv=since_rv),
            self.store.watch(store_mod.PODS, self._on_pod_event,
                             since_rv=since_rv),
            self.store.watch(store_mod.ENDPOINTS, self._on_endpoint_event,
                             since_rv=since_rv),
        ]
        if getattr(self.engine.gang, "quota", None) is not None:
            # Tenant-queue admission is live-configured: queue writes
            # must re-drive admission and job conditions, not wait for
            # the resync period.
            self._watchers += [
                self.store.watch(store_mod.TENANTQUEUES,
                                 self._on_queue_event),
                self.store.watch(store_mod.CLUSTERQUEUES,
                                 self._on_queue_event),
            ]

    def _owns(self, namespace: str, uid: str) -> bool:
        """Shard-ownership check: True when this controller's shard is
        responsible for the job (always, unsharded)."""
        if self.shard_count <= 1:
            return True
        return shard_for(namespace, uid,
                         self.shard_count) == self.shard_index

    def _on_queue_event(self, event_type: str, obj) -> None:
        """Quota topology changed (TenantQueue/ClusterQueue created,
        edited, or deleted): re-run admission — freed or granted quota
        may admit waiting groups; a deleted TenantQueue re-queues its
        pending groups to the default queue (controller/quota.py emits
        the QueueDeleted event) — then re-enqueue every watched job so
        Queued conditions track the new config."""
        gang = self.engine.gang
        if gang is not None and hasattr(gang, "readmit"):
            try:
                gang.readmit()
            except Exception:
                log.exception("re-admission after queue event failed")
        for key in self.store.project(
                store_mod.TPUJOBS,
                lambda j: (j.key() if self._owns(j.metadata.namespace,
                                                 j.metadata.uid) else None),
                namespace=self.namespace):
            self.enqueue(key)

    def _on_job_event(self, event_type: str, job: TPUJob) -> None:
        if self.namespace and job.metadata.namespace != self.namespace:
            return
        if not self._owns(job.metadata.namespace, job.metadata.uid):
            return
        if event_type == ADDED:
            # A replayed ADD (informer initial list after a controller
            # restart / failover) carries the conditions a prior sync wrote;
            # only genuinely-new jobs count as created.
            if not job.status.conditions:
                metrics.jobs_created.inc(job_namespace=job.metadata.namespace)
        elif event_type == DELETED:
            metrics.jobs_deleted.inc(job_namespace=job.metadata.namespace)
            self.expectations.delete_for_job(job.key())
            for rt in list(job.spec.replica_specs):
                self._hash_cache.pop((job.metadata.uid, rt.lower()), None)
            self._job_cache.pop(
                (job.metadata.namespace, job.metadata.name), None)
            self._garbage_collect(job)
            self._prune_job_observability(job)
        self.enqueue(job.key())

    @staticmethod
    def _prune_job_observability(job: TPUJob) -> None:
        """Job GC for job-LABELED observability state: the per-job
        gauge series (goodput, slice count) would otherwise accumulate
        one dead series per deleted job forever — unbounded exposition
        cardinality on a long-running operator — and the decision
        journal would keep answering for a job that no longer exists."""
        ns, name = job.metadata.namespace, job.metadata.name
        metrics.job_goodput_ratio.remove(job_namespace=ns, job=name)
        metrics.learner_goodput_ratio.remove(job_namespace=ns, job=name)
        metrics.job_slices.remove(job_namespace=ns, job=name)
        for rt in list(job.spec.replica_specs):
            metrics.actor_pool_replicas.remove(
                job_namespace=ns, job=name, replica_type=rt.lower())
        trace_mod.JOURNAL.prune(ns, name)

    def _garbage_collect(self, job: TPUJob) -> None:
        """Cascade-delete owned objects. The reference gets this for free
        from the K8s ownerReference GC controller; the process-native store
        has no GC, so the controller reaps owned pods/endpoints/slicegroups
        when their job vanishes (pod deletion terminates the processes via
        the backend's watch). O(owned) via the store's owner-UID index —
        this used to be three full-namespace list() scans (deepcopying
        every object in the namespace) per deleted job."""
        for kind in (store_mod.PODS, store_mod.ENDPOINTS,
                     store_mod.SLICEGROUPS, store_mod.CHECKPOINTRECORDS):
            for ns, name in self.store.owned_keys(kind, job.metadata.uid):
                self.store.try_delete(kind, ns, name)

    def _resolve_job_key(self, obj) -> Optional[str]:
        """Reference resolveControllerRef (job_controller.go:327-343):
        kind + uid check against the live job. A frozen snapshot
        suffices — this runs once per pod/endpoint event (the hottest
        read in the process) and only compares identity fields, so the
        full-object deepcopy it used to pay bought nothing."""
        ref = obj.metadata.controller_ref()
        if ref is None or ref.kind != constants.KIND:
            return None
        # Shard filter BEFORE the store read: the ref already carries
        # the owner uid, and every controller sees every event, so in
        # N-shard mode (shards-1)/N of events are dropped here without
        # contending the store lock from the dispatch thread. A stale
        # ref uid (job recreated under the same name) resolves to None
        # either way: the old uid's owner fails the uid match below,
        # every other shard fails this check.
        if not self._owns(obj.metadata.namespace, ref.uid):
            return None
        job = self.store.get_snapshot(store_mod.TPUJOBS,
                                      obj.metadata.namespace, ref.name)
        if job is None or job.metadata.uid != ref.uid:
            return None
        return job.key()

    def _orphan_job_key(self, obj) -> Optional[str]:
        """For an ownerless object, resolve the job its labels select so
        that job can adopt it on the next sync (reference AddPod's
        getPodJobs label-resolution path, common/pod.go:85-105)."""
        if obj.metadata.controller_ref() is not None:
            return None
        labels = obj.metadata.labels
        if labels.get(constants.LABEL_GROUP_NAME) != constants.GROUP:
            return None
        name = labels.get(constants.LABEL_JOB_NAME)
        if not name:
            return None
        job = self.store.get_snapshot(store_mod.TPUJOBS,
                                      obj.metadata.namespace, name)
        if job is None or not self._owns(job.metadata.namespace,
                                         job.metadata.uid):
            return None
        return job.key()

    def _on_pod_event(self, event_type: str, pod: Pod) -> None:
        job_key = self._resolve_job_key(pod)
        if job_key is None:
            orphan_key = self._orphan_job_key(pod)
            if orphan_key is not None:
                self.enqueue(orphan_key)
            return
        rtype = pod.metadata.labels.get(constants.LABEL_REPLICA_TYPE, "")
        key = expectation_key(job_key, "pods", rtype)
        if event_type == ADDED:
            self.expectations.creation_observed(key)
        elif event_type == DELETED:
            self.expectations.deletion_observed(key)
        self.enqueue(job_key)

    def _on_endpoint_event(self, event_type: str, ep: Endpoint) -> None:
        job_key = self._resolve_job_key(ep)
        if job_key is None:
            orphan_key = self._orphan_job_key(ep)
            if orphan_key is not None:
                self.enqueue(orphan_key)
            return
        rtype = ep.metadata.labels.get(constants.LABEL_REPLICA_TYPE, "")
        key = expectation_key(job_key, "endpoints", rtype)
        if event_type == ADDED:
            self.expectations.creation_observed(key)
        elif event_type == DELETED:
            self.expectations.deletion_observed(key)
        self.enqueue(job_key)

    def enqueue(self, job_key: str) -> None:
        # Depth gauge + coalescing accounting live in the queue itself
        # (one owner; the two racy set() call sites here are gone).
        self.workqueue.add(job_key)

    # ------------------------------------------------------------------
    # Worker loop (reference controller.go:191-284)
    # ------------------------------------------------------------------

    def run(self, threadiness: int = 1,
            since_rv: Optional[int] = None) -> None:
        self.start_watching(since_rv=since_rv)
        for i in range(threadiness):
            t = threading.Thread(target=self._worker, name=f"sync-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.workqueue.shutdown()
        for w in self._watchers:
            w.stop()
        for t in self._threads:
            t.join(timeout=5)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                key = self.workqueue.get(timeout=0.5)
            except TimeoutError:
                continue
            except ShutDown:
                return
            try:
                self.sync_tpujob(key)
            except Exception:
                log.exception("error syncing %s; requeueing", key)
                # The working copy may hold half-applied status
                # mutations that never reached the store; a cache hit
                # would diff against them and skip the re-write.
                self._job_cache.pop(tuple(key.split("/", 1)), None)
                self.workqueue.done(key)
                self.workqueue.add_rate_limited(key)
                continue
            self.workqueue.done(key)
            self.workqueue.forget(key)

    def satisfied_expectations(self, job: TPUJob) -> bool:
        """Reference satisfiedExpectations (controller.go:348-367): gate the
        sync on every pods/endpoints expectation for the job."""
        for rtype in job.spec.replica_specs:
            for kind in ("pods", "endpoints"):
                if not self.expectations.satisfied_expectations(
                        expectation_key(job.key(), kind, rtype)):
                    return False
        return True

    def sync_tpujob(self, key: str) -> None:
        """Reference syncTFJob (controller.go:300-343)."""
        with trace_mod.span("sync", job=key):
            self._sync_tpujob(key)

    def _fetch_job(self, namespace: str, name: str) -> Optional[TPUJob]:
        """Zero-copy sync read: compare the store's frozen snapshot
        against the cached working copy by (uid, resourceVersion) and
        spec identity, and reuse it on a match. The store stamps the
        working copy's resourceVersion in place on every status write,
        so the copy a sync just wrote is a hit for the MODIFIED event
        that write fired — steady state performs no deepcopy at all.
        The spec identity check (`is`, not `==`) guards the one case
        the RV can lie about: a status write that landed on top of an
        interleaved spec write stamps the stale copy current. A miss
        (first sync, external write, failed write) deepcopies the
        snapshot once. A snapshot older than one already read (same uid,
        a lower resourceVersion) returns ``_STALE``, up to
        ``STALE_READ_RETRIES`` times in a row."""
        key = (namespace, name)
        snap = self.store.get_snapshot(store_mod.TPUJOBS, namespace, name)
        if snap is None:
            self._job_cache.pop(key, None)
            self._job_rv.pop(key, None)
            self._stale_reads.pop(key, None)
            return None
        rv = store_mod.rv_number(snap.metadata.resource_version)
        seen = self._job_rv.get(key)
        if rv is not None:
            if (seen is not None and seen[0] == snap.metadata.uid
                    and rv < seen[1]):
                stale = self._stale_reads.get(key, 0) + 1
                if stale <= STALE_READ_RETRIES:
                    self._stale_reads[key] = stale
                    return _STALE
                log.warning("job %s/%s: resourceVersion %s still below %s "
                            "after %d reads; acting on it", namespace, name,
                            rv, seen[1], STALE_READ_RETRIES)
            self._stale_reads.pop(key, None)
            self._job_rv[key] = (snap.metadata.uid, rv)
        entry = self._job_cache.get(key)
        if entry is not None:
            cached, spec_ref = entry
            if (cached.metadata.uid == snap.metadata.uid
                    and cached.metadata.resource_version
                    == snap.metadata.resource_version
                    and spec_ref is snap.spec):
                return cached
        job = snap.deepcopy()
        self._job_cache[key] = (job, snap.spec)
        return job

    def _sync_tpujob(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        with trace_mod.span("job.fetch"):
            job = self.store.get_snapshot(store_mod.TPUJOBS, namespace,
                                          name)
            if job is not None and not self._owns(namespace,
                                                  job.metadata.uid):
                # Authoritative shard guard: whatever enqueued this key,
                # a foreign shard's job is never synced here.
                return
            job = self._fetch_job(namespace, name)
        if job is _STALE:
            # Read again shortly; the store has a newer version.
            self.workqueue.add_after(key, STALE_READ_RETRY_SECONDS)
            return
        if job is None:
            log.info("job %s vanished; clearing expectations", key)
            self.expectations.delete_for_job(key)
            if self.engine.gang is not None:
                # Gang residue is not all owner-GC'd: the PDB is (real
                # clusters), but the fake apiserver and the informer
                # mirror's SliceGroup need the explicit delete —
                # level-triggered, no-op when nothing exists.
                ref = TPUJob()
                ref.metadata.name = name
                ref.metadata.namespace = namespace
                self.engine.gang.delete_slice_group(ref)
            return

        with trace_mod.span("spec.validate"):
            set_defaults(job)
            err = None
            try:
                validate_job(job)
            except ValidationError as e:
                err = e
        if err is not None:
            # Invalid spec -> Failed status, no requeue (reference
            # job.go:87-135 writes Failed via the CRD REST client). Write
            # only on change: an unconditional write fires MODIFIED ->
            # re-enqueue -> write, a hot loop.
            old_status_dict = job.status.to_dict()
            msg = f"TPUJob {key} is not valid: {err}"
            if not cond.is_failed(job.status):
                metrics.jobs_failed.inc(job_namespace=namespace)
            cond.update_job_conditions(job.status, JobConditionType.FAILED,
                                       "InvalidTPUJobSpec", msg)
            if job.status.to_dict() != old_status_dict:
                self.recorder.event(job, EVENT_TYPE_WARNING, "InvalidTPUJob", msg)
                self.update_job_status_in_api(job)
            return

        if not job.status.conditions:
            msg = f"TPUJob {key} is created."
            cond.update_job_conditions(job.status, JobConditionType.CREATED,
                                       cond.JOB_CREATED_REASON, msg)
            # Non-fatal spec smells surface once, as Warning events on
            # the fresh job (ps-without-runtime, multislice shape).
            for warning in validation_warnings(job):
                self.recorder.event(job, EVENT_TYPE_WARNING,
                                    "ValidationWarning", warning)

        needs_sync = (job.spec.enable_elastic_worker
                      or self.satisfied_expectations(job))
        if not needs_sync:
            log.debug("expectations pending for %s; skipping sync", key)
            return
        with metrics.reconcile_seconds.time():
            self.engine.reconcile_jobs(job)

    # ------------------------------------------------------------------
    # JobPlugin implementation (reference ControllerInterface)
    # ------------------------------------------------------------------

    def _base_selector(self, job: TPUJob) -> Dict[str, str]:
        return {
            constants.LABEL_GROUP_NAME: constants.GROUP,
            constants.LABEL_JOB_NAME: job.metadata.name,
        }

    def get_pods_for_job(self, job: TPUJob) -> List[Pod]:
        """List-then-claim; the view must include owned pods whose
        labels stopped matching so the manager can release them
        (reference GetPodsForJob common/pod.go:219-254 +
        ControllerRefManager claim semantics). ``list_claimable``
        answers from the store's job-name/owner indexes and returns
        FROZEN shared snapshots — O(owned) per sync with zero copies;
        the claim pass deepcopies only the objects it actually mutates
        (adopt/release edges)."""
        pods = self.store.list_claimable(
            store_mod.PODS, job.metadata.namespace,
            self._base_selector(job), job.metadata.uid)
        return self._claim(store_mod.PODS, job, pods)

    def get_endpoints_for_job(self, job: TPUJob) -> List[Endpoint]:
        eps = self.store.list_claimable(
            store_mod.ENDPOINTS, job.metadata.namespace,
            self._base_selector(job), job.metadata.uid)
        return self._claim(store_mod.ENDPOINTS, job, eps)

    def _claim(self, kind: str, job: TPUJob, objs):
        """Full ControllerRefManager semantics (reference
        controller_ref_manager.go:169-299 ClaimPods/ClaimObject):

        - matching orphan        -> adopt (unless the job is terminating)
        - owned + matching       -> keep
        - owned + NOT matching   -> release (drop our ownerReference so
          another controller — or nobody — can claim it; the pod itself
          is left alone)
        - someone else's         -> ignore

        ``objs`` may be frozen store snapshots (list_claimable): the
        common keep-path passes them through untouched, and the rare
        adopt/release edges deepcopy before mutating.
        """
        selector = self._base_selector(job)
        claimed = []
        for obj in objs:
            ref = obj.metadata.controller_ref()
            matches = store_mod.matches_selector(obj.metadata.labels,
                                                 selector)
            if ref is None:
                if not matches or job.metadata.deletion_timestamp is not None:
                    continue
                obj = obj.deepcopy()
                obj.metadata.owner_references.append(controller_owner_ref(job))
                obj = self._persist_adoption(kind, obj)
                if obj is not None:
                    claimed.append(obj)
            elif ref.uid == job.metadata.uid:
                if matches:
                    claimed.append(obj)
                elif job.metadata.deletion_timestamp is None:
                    # Reference ReleasePod (controller_ref_manager.go:223).
                    # A terminating job must NOT release: stripping the
                    # ownerReference mid-deletion would orphan the pod
                    # past every garbage collector, leaking it forever.
                    self._persist_release(kind, obj.deepcopy(), job)
            # else: owned by another controller -> leave it alone
        return claimed

    def _persist_adoption(self, kind: str, obj):
        """Persist a newly-stamped controller ownerReference (reference
        AdoptPod's ownership patch, controller_ref_manager.go:208-221).
        Returns the updated object, or None when the object changed or
        vanished underneath us (retry next sync)."""
        try:
            return self.store.update(kind, obj)
        except (store_mod.ConflictError, store_mod.NotFoundError):
            return None

    def _persist_release(self, kind: str, obj, job: TPUJob) -> None:
        """Drop this job's ownerReference from the object (reference
        ReleasePod's owner-delete patch; NotFound/Conflict are benign —
        deleted means released, changed means retry next sync)."""
        obj.metadata.owner_references = [
            r for r in obj.metadata.owner_references
            if r.uid != job.metadata.uid]
        try:
            self.store.update(kind, obj)
        except (store_mod.ConflictError, store_mod.NotFoundError):
            pass

    def delete_job(self, job: TPUJob) -> None:
        """Reference DeleteJob (tensorflow/job.go:39-55)."""
        self.store.try_delete(store_mod.TPUJOBS, job.metadata.namespace,
                              job.metadata.name)
        self.expectations.delete_for_job(job.key())
        self.recorder.event(job, EVENT_TYPE_NORMAL, "SuccessfulDeleteJob",
                            f"Deleted job: {job.metadata.name}")

    def update_job_status(self, job: TPUJob,
                          replica_specs: Dict[str, ReplicaSpec],
                          pods: Optional[List[Pod]] = None) -> None:
        if pods is None:
            # Standalone callers without a snapshot; the engine always
            # passes the one it already listed+claimed — exactly one
            # pod list per sync.
            pods = self.get_pods_for_job(job)
        w0 = status_mod.is_worker0_completed(
            job, replica_specs, pods, self.get_default_container_name())
        status_mod.update_job_status(job, replica_specs, w0,
                                     recorder=self.recorder,
                                     workqueue=self.workqueue)

    def update_job_status_in_api(self, job: TPUJob) -> None:
        from tf_operator_tpu_torch.runtime import retry as retry_mod

        with trace_mod.span("status.write"):
            self._update_job_status_in_api(job, retry_mod)

    def _update_job_status_in_api(self, job: TPUJob, retry_mod) -> None:
        try:
            # Transient blips retry in place (the status write is the
            # one mutation EVERY sync performs — losing it to a 500
            # burst starves observers of conditions); NotFound means
            # the job was deleted mid-sync. update_status carries no
            # resourceVersion CAS here, but a fault-injecting store can
            # still answer 409 — re-applying the same status is the
            # correct RetryOnConflict body, so plain retry suffices.
            retry_mod.with_retries(
                lambda: self.store.update_status(store_mod.TPUJOBS, job),
                component="controller.status",
                retryable=lambda e: (retry_mod.is_transient(e)
                                     or isinstance(
                                         e, store_mod.ConflictError)),
                health=self.cp_health)
        except store_mod.NotFoundError:
            pass  # job deleted mid-sync
        except store_mod.ConflictError:
            # Chaos-injected CAS loss. The working copy now carries
            # status the store never saw — drop it so the next sync
            # re-fetches and its change detection re-fires the write
            # (a cache hit would diff against the unwritten status and
            # wedge the store stale).
            self._job_cache.pop(
                (job.metadata.namespace, job.metadata.name), None)

    def set_cluster_spec(self, job: TPUJob, pod: Pod, rtype: str,
                         index: int) -> None:
        container = pod.spec.container(self.get_default_container_name())
        if container is None:
            return
        env = render_worker_env(job, rtype, index)
        # User-provided env wins over injected env? No: bootstrap identity
        # env must be authoritative (reference overwrites TF_CONFIG).
        container.env.update(env)
        # Slice workers request their host's GPUs under nvidia.com/gpu
        # (NVIDIA device-plugin convention) — derived from the declared
        # slice topology so the scheduler and kubelet account them,
        # unless the template already declares an explicit GPU request.
        # The reference had no topology to derive from; users hand-wrote
        # resources. Coordinator-only types (chief/ps/evaluator) hold no
        # GPUs. Serving replicas hold GPUs like workers: they run the
        # model's decode path on the slice. The role's RolePolicy decides
        # device ownership — the resolver defaults to exactly the
        # worker/serving name set, and chipConsuming overrides it either
        # way (a CPU-only actor pool must never get GPU resources or the
        # node-pool toleration stamped; docs/rl.md).
        eff = effective_role_policy(job, rtype)
        chip_holder = eff.chip_consuming
        if (job.spec.slice.accelerator and chip_holder
                and not any(constants.RESOURCE_GPU in c.resources
                            for c in pod.spec.containers)):
            # The number render_worker_env counts the pod's processes
            # by (bootstrap/cluster.py pod_gpus).
            container.resources[constants.RESOURCE_GPU] = str(
                pod_gpus(job, rtype))
        if (job.spec.slice.accelerator and chip_holder
                and not any(t.key == constants.RESOURCE_GPU
                            for t in pod.spec.tolerations)):
            # GKE GPU node pools taint their nodes with the extended-
            # resource key; without a matching toleration the taint
            # manager evicts a bound pod even though the scheduler
            # placed it correctly. Tolerations are immutable after
            # creation, so this is stamped here, not at bind time.
            from tf_operator_tpu_torch.api.types import Toleration

            pod.spec.tolerations.append(Toleration(
                key=constants.RESOURCE_GPU, operator="Exists"))
        # A pod that holds no GPU runs its payload on the host, as a JAX
        # process on such a pod runs on its host's default device: the
        # pod's device, named for _device.resolve_device. OUTSIDE the
        # bootstrap hash (computed from render_worker_env alone), like
        # the checkpoint and serving env below: a pod's device is not
        # cluster membership.
        if pod_gpus(job, rtype) == 0:
            container.env[constants.ENV_DEVICE] = constants.DEVICE_NO_GPU
        # Restore-with-identity (controller/ckpt.py): checkpoint policy
        # knobs + the committed restore step, rendered at create time.
        # Deliberately AFTER bootstrap env and OUTSIDE the bootstrap
        # hash (computed from render_worker_env alone): a new committed
        # checkpoint must not read as a topology change and restart
        # live pods.
        if self.ckpt is not None:
            container.env.update(self.ckpt.bootstrap_env(job))
        # Serving env (controller/serving.py): ServingPolicy knobs +
        # tenant QoS lane weights, rendered only for serving-role pods
        # and only with --enable-serving — same outside-the-hash rule
        # as the checkpoint env (a policy or quota-weight edit must not
        # restart live serving replicas mid-traffic).
        if self.serving is not None:
            container.env.update(self.serving.bootstrap_env(job, rtype))
        # Learner discovery for RolePolicy'd satellite roles (RL actors;
        # docs/rl.md): the current learner (ranked-replica) endpoints,
        # rendered like the ps view in reverse — OUTSIDE the bootstrap
        # hash (it is computed from render_worker_env alone), so learner
        # resizes never restart actors and actor churn never touches
        # learners. Only roles that explicitly opted into a RolePolicy
        # get it: default pod shapes stay byte-identical.
        if eff.explicit and not eff.data_plane:
            endpoints = learner_endpoints(job)
            if endpoints:
                container.env[constants.ENV_LEARNER_ENDPOINTS] = endpoints
        # Node-agent relay (runtime/relay.py): mount the shared relay
        # volume and render the notice/checkpoint file paths for pods a
        # coordination subsystem will actually talk to. Token-keyed, not
        # uid-keyed — the path must render NOW, before the apiserver
        # assigns a uid, and each incarnation gets a fresh token so a
        # recreated pod never reads a dead incarnation's notice. Outside
        # the bootstrap hash like the ckpt/serving env above.
        if self.relay_dir and self._pod_uses_relay(job, rtype):
            import uuid as _uuid

            from tf_operator_tpu_torch.runtime import relay as relay_mod

            pod.metadata.annotations.setdefault(
                constants.ANNOTATION_RELAY_TOKEN, _uuid.uuid4().hex[:8])
            pod.spec.relay_dir = self.relay_dir
            container.env[constants.ENV_PREEMPT_FILE] = \
                relay_mod.preempt_path(self.relay_dir, pod)
            container.env[constants.ENV_CKPT_FILE] = \
                relay_mod.ckpt_path(self.relay_dir, pod)

    def _pod_uses_relay(self, job: TPUJob, rtype: str) -> bool:
        """Relay files only reach pods a coordination plane will talk
        to: any replica of a checkpoint-policy job (the barrier notices
        every stamped pod), serving replicas under --enable-serving
        (drain re-spool rides the same files). Everything else keeps
        today's pod shape byte-identical."""
        if self.ckpt is not None:
            from tf_operator_tpu_torch.controller.ckpt import (
                job_checkpoint_policy,
            )

            if job_checkpoint_policy(job) is not None:
                return True
        return (self.serving is not None
                and rtype.lower() == ReplicaType.SERVING)

    def bootstrap_hash(self, job: TPUJob, rtype: str, index: int) -> str:
        """Cached world digest: the env render + sha1 is a pure function
        of (job spec, rtype), so memoize per (job UID, rtype) keyed on
        the job's resourceVersion — an idle resync (or a 256-pod gang
        create, one call per pod) costs a dict hit instead of a JSON
        render + digest. Any store write bumps the RV and invalidates;
        entries die with the job (_on_job_event DELETED)."""
        key = (job.metadata.uid, rtype.lower())
        rv = job.metadata.resource_version
        cached = self._hash_cache.get(key)
        if cached is not None and cached[0] == rv:
            return cached[1]
        digest = self._compute_bootstrap_hash(job, rtype, index)
        self._hash_cache[key] = (rv, digest)
        return digest

    def _compute_bootstrap_hash(self, job: TPUJob, rtype: str,
                                index: int) -> str:
        """sha1 over the WORLD a pod of this rtype joins — deliberately
        index-invariant (every per-index env key is a pure function of
        (world, index), so for a fixed pod name the env changes iff the
        world does; the engine computes one digest per rtype per sync).

        Per-index keys are dropped rather than hashed; the world facts
        they derive from (replica lists, topology) are all present in
        the remaining keys. Sparse-elastic workers additionally drop
        the world-coupled keys their async runtime never joins
        (their own sparse cluster entry and the dense world size),
        so a worker resize leaves them running — the reference
        enableDynamicWorker no-restart semantics (tensorflow.go:64-83);
        a ps resize still changes their digest (they dial ps).

        The slice count of a multislice job enters the digest of its
        ranked pods (sparse ones included) although no GPU env key
        carries it: the JAX package renders it to exactly those pods
        (``MEGASCALE_NUM_SLICES``), so a numSlices resize restarts the
        same pods under either control plane."""
        import hashlib
        import json as _json

        del index  # world digest: see docstring
        rt = rtype.lower()
        env = render_worker_env(job, rtype, 0)
        env.pop("RANK", None)
        env.pop("GROUP_RANK", None)
        sparse = (job.spec.enable_elastic_worker
                  and rt == ReplicaType.WORKER)
        raw = env.get("TPUJOB_CLUSTER_SPEC")
        if raw:
            d = _json.loads(raw)
            d.pop("task", None)
            if sparse:
                (d.get("cluster") or {}).pop(ReplicaType.WORKER, None)
            if not effective_role_policy(job, rtype).data_plane:
                # Non-data-plane roles never DIAL the world through
                # the spec (ps serves, workers dial it; bootstrap
                # renders them no MASTER_*/RANK env) — so a worker/chief resize
                # must not restart them: a ps restart interrupts the
                # whole job's parameter serving for nothing, a serving
                # restart drops live decode traffic, and an actor
                # restart throws away in-flight trajectories. Their
                # digest keeps the entries peers reach THEM by (their
                # own role list) and drops the data-plane lists. Same
                # predicate the resolver gives every consumer: dataPlane
                # is fixed per replica type (chief/master/worker), not a
                # RolePolicy knob.
                for t in (ReplicaType.CHIEF, ReplicaType.MASTER,
                          ReplicaType.WORKER):
                    (d.get("cluster") or {}).pop(t, None)
            for t in elastic_role_types(job):
                # Elastic-band roles (RL actor pools) resize by replica
                # count with NO world restart: their cluster entry
                # leaves EVERY role's digest, so an actor grow/shrink
                # changes no pod's bootstrap hash — learners included,
                # and the band's own surviving pods (its own list must
                # not be in its own digest, or a shrink would restart
                # the pool it kept). Peers that need actors find them
                # by DNS, not by the rendered list.
                (d.get("cluster") or {}).pop(t, None)
            env["TPUJOB_CLUSTER_SPEC"] = _json.dumps(d, sort_keys=True)
        if sparse:
            env.pop("WORLD_SIZE", None)
            env.pop("GROUP_WORLD_SIZE", None)
        if not is_distributed(job):
            # A one-pod job's local world is the pod's own GPU count,
            # fixed for the pod's life by its resources: no restart.
            env.pop("LOCAL_WORLD_SIZE", None)
        if ("MASTER_ADDR" in env and job.spec.slice.accelerator
                and job.spec.slice.num_slices > 1):
            env["numSlices"] = str(job.spec.slice.num_slices)
        blob = "\x00".join(f"{k}={env[k]}" for k in sorted(env))
        return hashlib.sha1(blob.encode()).hexdigest()
