"""The reconcile hot path's scalability invariants through the port's
``GPUJobController``, held to the JAX package's
``tests/test_controlplane_scale.py``:

- per-key serialisation at threadiness 4: one job is never synced by two
  workers at once;
- no lost enqueue: an add during a key's sync re-delivers the key after
  ``done()``;
- threadiness 4 converges as threadiness 1 does;
- exactly one pod list and claim per sync, a steady-state re-sync with no
  deepcopy and no ``get()``, and garbage collection by the owner index,
  each counted in store calls.

Each test runs the same code through both packages and compares what it
counts; each also reaches the outcome the JAX test asserts. The
convergence waits are 60 s where the JAX test has 20 s.
"""

import importlib
import threading
import time
from collections import defaultdict

import pytest

pytestmark = pytest.mark.control_plane

CONVERGE_S = 60.0


class Pkg:
    def __init__(self, port: bool):
        root = "tf_operator_tpu_torch" if port else "tf_operator_tpu"

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.name = "port" if port else "jax"
        self.testutil = mod("testutil")
        self.types = mod("api.types")
        self.const = mod("api.constants")
        self.cond = mod("controller.conditions")
        self.store_mod = mod("runtime.store")
        self.workqueue = mod("runtime.workqueue")
        self.controller_cls = (
            mod("controller.gpu_controller").GPUJobController if port
            else mod("controller.tpu_controller").TPUJobController)


JAX, PORT = Pkg(port=False), Pkg(port=True)


def both(scenario):
    out = {pkg.name: scenario(pkg) for pkg in (JAX, PORT)}
    assert out["port"] == out["jax"], out
    return out["port"]


def wait_for(predicate, timeout=CONVERGE_S, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def drive_pods_succeeded(pkg, store, namespace):
    """One fake-kubelet pass: Pending/Running pods -> Succeeded(0)."""
    t, sm = pkg.types, pkg.store_mod
    for ns, name in store.project(
            sm.PODS,
            lambda p: ((p.metadata.namespace, p.metadata.name)
                       if p.status.phase in (t.PodPhase.PENDING,
                                             t.PodPhase.RUNNING) else None),
            namespace=namespace):
        patch = t.Pod(metadata=t.ObjectMeta(name=name, namespace=ns))
        patch.status = t.PodStatus(
            phase=t.PodPhase.SUCCEEDED, start_time=pkg.testutil.now(),
            container_statuses=[t.ContainerStatus(
                name=pkg.const.DEFAULT_CONTAINER_NAME,
                state="Terminated", exit_code=0)])
        try:
            store.update_status(sm.PODS, patch)
        except (sm.NotFoundError, sm.ConflictError):
            pass


# ---------------------------------------------------------------------------
# The workqueue's serialisation and no-lost-enqueue contract
# ---------------------------------------------------------------------------

def _readded_while_processing(pkg):
    wq = pkg.workqueue
    q = wq.RateLimitingQueue(instrument=False)
    q.add("job")
    first = q.get(timeout=1)
    q.add("job")  # arrives mid-sync: must not be lost...
    try:
        q.get(timeout=0.05)
        concurrent = True
    except TimeoutError:
        concurrent = False  # ...nor delivered concurrently
    q.done("job")
    again = q.get(timeout=1)  # re-delivered after done
    q.done("job")
    q.shutdown()
    return {"first": first, "concurrent": concurrent, "again": again}


def test_item_readded_while_processing_is_redelivered():
    assert both(_readded_while_processing) == {
        "first": "job", "concurrent": False, "again": "job"}


def _coalesce(pkg):
    q = pkg.workqueue.RateLimitingQueue(instrument=False)
    for _ in range(256):  # a gang start's event storm on one key
        q.add("job")
    pending = len(q)
    got = q.get(timeout=1)
    q.done("job")
    try:
        q.get(timeout=0.05)
        redelivered = True
    except TimeoutError:
        redelivered = False
    q.shutdown()
    return {"pending": pending, "got": got, "redelivered": redelivered}


def test_duplicate_adds_coalesce_while_pending():
    assert both(_coalesce) == {"pending": 1, "got": "job",
                               "redelivered": False}


def _no_concurrent_get(pkg):
    q = pkg.workqueue.RateLimitingQueue(instrument=False)
    in_flight = defaultdict(int)
    overlaps, synced = [], set()
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                item = q.get(timeout=0.05)
            except TimeoutError:
                continue
            except pkg.workqueue.ShutDown:
                return
            with lock:
                in_flight[item] += 1
                if in_flight[item] > 1:
                    overlaps.append(item)
                synced.add(item)
            time.sleep(0.001)  # hold the key long enough to collide
            with lock:
                in_flight[item] -= 1
            q.done(item)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(50):
        for key in ("a", "b", "c"):
            q.add(key)
        time.sleep(0.002)
    stop.set()
    q.shutdown()
    for t in threads:
        t.join(timeout=5)
    return {"overlaps": overlaps, "synced": sorted(synced)}


def test_no_concurrent_get_of_same_key_across_workers():
    assert both(_no_concurrent_get) == {"overlaps": [],
                                        "synced": ["a", "b", "c"]}


# ---------------------------------------------------------------------------
# The controller at threadiness 4
# ---------------------------------------------------------------------------

class SyncTracker:
    """Wraps sync_tpujob: records per-key overlap and total syncs."""

    def __init__(self, controller):
        self._inner = controller.sync_tpujob
        self._lock = threading.Lock()
        self._active = defaultdict(int)
        self.overlaps = []
        self.syncs = 0
        controller.sync_tpujob = self

    def __call__(self, key):
        with self._lock:
            self._active[key] += 1
            if self._active[key] > 1:
                self.overlaps.append(key)
            self.syncs += 1
        try:
            self._inner(key)
        finally:
            with self._lock:
                self._active[key] -= 1


def _converge_fleet(pkg, threadiness, jobs=6, workers=3):
    sm = pkg.store_mod
    ns = f"scale-t{threadiness}"
    store = sm.Store()
    controller = pkg.controller_cls(store, namespace=ns)
    tracker = SyncTracker(controller)
    controller.run(threadiness=threadiness)
    try:
        for i in range(jobs):
            store.create(sm.TPUJOBS, pkg.testutil.new_tpujob(
                worker=workers, name=f"j{i}", namespace=ns))
        wait_for(lambda: store.count(sm.PODS) >= jobs * workers,
                 msg="pod creation")
        drive_pods_succeeded(pkg, store, ns)
        wait_for(lambda: sum(store.project(
            sm.TPUJOBS, lambda j: 1 if pkg.cond.is_succeeded(j.status)
            else None, namespace=ns)) == jobs, msg="job convergence")
        jobs_list = store.list(sm.TPUJOBS, namespace=ns)
    finally:
        controller.stop()
        store.stop_watchers()
    # Terminal state a job: Succeeded, nothing active, nothing failed
    # (exact succeeded tallies depend on timing at any threadiness).
    digest = sorted(
        (j.metadata.name, pkg.cond.is_succeeded(j.status),
         sum(rs.active for rs in j.status.replica_statuses.values()),
         sum(rs.failed for rs in j.status.replica_statuses.values()))
        for j in jobs_list)
    return tracker, digest


def _threadiness(pkg):
    tracker4, digest4 = _converge_fleet(pkg, threadiness=4)
    tracker1, digest1 = _converge_fleet(pkg, threadiness=1)
    assert tracker4.syncs > 0 and tracker1.syncs > 0
    return {"overlaps4": tracker4.overlaps, "digest4": digest4,
            "digest1": digest1}


def test_threadiness4_serializes_per_key_and_converges_like_1():
    out = both(_threadiness)
    assert out["overlaps4"] == []
    assert out["digest4"] == out["digest1"]
    assert out["digest4"] == [(f"j{i}", True, 0, 0) for i in range(6)]


# ---------------------------------------------------------------------------
# Store calls of one sync
# ---------------------------------------------------------------------------

def _steady_job(pkg, store, workers, endpoints=True):
    sm, tu = pkg.store_mod, pkg.testutil
    job = store.create(sm.TPUJOBS, tu.new_tpujob(worker=workers))
    for i in range(workers):
        store.create(sm.PODS, tu.new_pod(job, "worker", i,
                                         phase=pkg.types.PodPhase.RUNNING))
        if endpoints:
            store.create(sm.ENDPOINTS, tu.new_endpoint(job, "worker", i))
    return job


def _claim_lists(pkg):
    sm = pkg.store_mod

    class CountingStore(sm.Store):
        def __init__(self):
            super().__init__()
            self.claim_lists = defaultdict(int)

        def list_claimable(self, kind, namespace, selector, owner_uid):
            self.claim_lists[kind] += 1
            return super().list_claimable(kind, namespace, selector,
                                          owner_uid)

    store = CountingStore()
    controller = pkg.controller_cls(store)
    # Fully materialised steady state: both syncs are pure re-syncs.
    job = _steady_job(pkg, store, 4)
    counts = []
    for _ in range(2):   # the first sync, then an idle re-sync
        store.claim_lists.clear()
        controller.sync_tpujob(job.key())
        counts.append((store.claim_lists[sm.PODS],
                       store.claim_lists[sm.ENDPOINTS]))
    return counts


def test_exactly_one_pod_list_and_claim_per_sync():
    """update_job_status consumes the engine's snapshot, not a re-list:
    one pod and one endpoint listing a sync, as in JAX."""
    assert both(_claim_lists) == [(1, 1), (1, 1)]


def _frozen_claims(pkg):
    store = pkg.store_mod.Store()
    controller = pkg.controller_cls(store)
    job = _steady_job(pkg, store, 2, endpoints=False)
    first = controller.get_pods_for_job(job)
    second = controller.get_pods_for_job(job)
    return {"pods": len(first),
            "same_objects": {id(p) for p in first} == {id(p) for p in second}}


def test_frozen_claim_snapshot_not_deepcopied_on_keep_path():
    assert both(_frozen_claims) == {"pods": 2, "same_objects": True}


def _steady_sync(pkg):
    sm = pkg.store_mod

    class SnapshotCountingStore(sm.Store):
        def __init__(self):
            super().__init__()
            self.gets = 0
            self.snapshot_gets = 0

        def get(self, kind, namespace, name):
            self.gets += 1
            return super().get(kind, namespace, name)

        def get_snapshot(self, kind, namespace, name):
            self.snapshot_gets += 1
            return super().get_snapshot(kind, namespace, name)

    store = SnapshotCountingStore()
    controller = pkg.controller_cls(store)
    job = _steady_job(pkg, store, 2)
    # The first syncs build the working copy and settle the status.
    controller.sync_tpujob(job.key())
    controller.sync_tpujob(job.key())
    store.gets = store.snapshot_gets = 0
    api_object = pkg.types.ApiObject
    orig = api_object.deepcopy
    copies = [0]

    def counted(obj):
        copies[0] += 1
        return orig(obj)

    api_object.deepcopy = counted
    try:
        controller.sync_tpujob(job.key())
    finally:
        api_object.deepcopy = orig
    return {"deepcopies": copies[0], "gets": store.gets,
            "snapshot_gets": store.snapshot_gets}


def test_steady_state_sync_read_path_is_zero_deepcopy():
    out = both(_steady_sync)
    assert out["deepcopies"] == 0 and out["gets"] == 0
    assert out["snapshot_gets"] >= 1   # the cache-validation read


def _garbage_collect(pkg):
    sm, tu = pkg.store_mod, pkg.testutil
    store = sm.Store()
    controller = pkg.controller_cls(store)
    job_a = store.create(sm.TPUJOBS, tu.new_tpujob(worker=2, name="job-a"))
    job_b = store.create(sm.TPUJOBS, tu.new_tpujob(worker=2, name="job-b"))
    for job in (job_a, job_b):
        for i in range(2):
            store.create(sm.PODS, tu.new_pod(job, "worker", i))
            store.create(sm.ENDPOINTS, tu.new_endpoint(job, "worker", i))
    controller._garbage_collect(job_a)
    return {"pods": store.count(sm.PODS),
            "endpoints": store.count(sm.ENDPOINTS),
            "owners": sorted(
                "job-b" if p.metadata.controller_ref().uid
                == job_b.metadata.uid else "other"
                for p in store.list(sm.PODS))}


def test_garbage_collect_uses_owner_index():
    """A deleted job's residue goes; another job's objects stay."""
    assert both(_garbage_collect) == {"pods": 2, "endpoints": 2,
                                      "owners": ["job-b", "job-b"]}
