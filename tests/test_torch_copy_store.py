"""Copy of ``tests/test_store.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Store (API-server analog) tests.
"""

import threading

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.store import Store


def test_create_assigns_identity():
    s = Store()
    job = testutil.new_tpujob(worker=1)
    job.metadata.uid = ""
    job.metadata.creation_timestamp = None
    created = s.create(store_mod.TPUJOBS, job)
    assert created.metadata.uid
    assert created.metadata.creation_timestamp is not None
    assert created.metadata.resource_version > 0


def test_double_create_rejected():
    s = Store()
    s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))
    with pytest.raises(store_mod.AlreadyExistsError):
        s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))


def test_update_conflict_on_stale_rv():
    s = Store()
    created = s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))
    fresh = s.get(store_mod.TPUJOBS, "default", created.metadata.name)
    s.update(store_mod.TPUJOBS, fresh)  # bumps rv
    with pytest.raises(store_mod.ConflictError):
        s.update(store_mod.TPUJOBS, created)  # stale rv


def test_update_status_merges_only_status():
    s = Store()
    created = s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=2))
    stale = created.deepcopy()
    stale.spec.replica_specs["worker"].replicas = 99  # must NOT land
    from tf_operator_tpu_torch.api.types import ReplicaStatus

    stale.status.replica_statuses["worker"] = ReplicaStatus(active=2)
    s.update_status(store_mod.TPUJOBS, stale)
    stored = s.get(store_mod.TPUJOBS, "default", created.metadata.name)
    assert stored.spec.replica_specs["worker"].replicas == 2
    assert stored.status.replica_statuses["worker"].active == 2


def test_list_with_selector():
    s = Store()
    job = testutil.new_tpujob(worker=2)
    for i in range(2):
        s.create(store_mod.PODS, testutil.new_pod(job, "worker", i))
    s.create(store_mod.PODS, testutil.new_pod(job, "ps", 0))
    from tf_operator_tpu_torch.api import constants

    out = s.list(store_mod.PODS, namespace="default",
                 selector={constants.LABEL_REPLICA_TYPE: "worker"})
    assert len(out) == 2


def test_watch_delivers_events_and_replay():
    s = Store()
    job = testutil.new_tpujob(worker=1)
    s.create(store_mod.TPUJOBS, job)
    events = []
    done = threading.Event()

    def handler(etype, obj):
        events.append((etype, obj.metadata.name))
        if len(events) >= 3:
            done.set()

    s.watch(store_mod.TPUJOBS, handler, replay=True)
    s.update_status(store_mod.TPUJOBS, job)
    s.delete(store_mod.TPUJOBS, "default", job.metadata.name)
    assert done.wait(2.0)
    assert events[0][0] == store_mod.ADDED
    assert events[1][0] == store_mod.MODIFIED
    assert events[2][0] == store_mod.DELETED


def test_watcher_stop_deregisters_from_store():
    s = Store()
    w = s.watch(store_mod.TPUJOBS, lambda *_: None)
    assert w in s._watchers
    w.stop()
    assert w not in s._watchers
    # events after stop are not enqueued into the dead watcher
    s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))
    assert w.queue.qsize() <= 1  # only the stop sentinel (if undrained)
    w.stop()  # idempotent


def test_mutating_returned_object_does_not_affect_store():
    s = Store()
    created = s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))
    created.spec.replica_specs["worker"].replicas = 42
    stored = s.get(store_mod.TPUJOBS, "default", created.metadata.name)
    assert stored.spec.replica_specs["worker"].replicas == 1


def test_keys_returns_metadata_without_payload_copy():
    store = Store()
    for i in range(3):
        store.create(store_mod.TPUJOBS,
                     testutil.new_tpujob(worker=1, name=f"j{i}"))
    ks = store.keys(store_mod.TPUJOBS)
    assert len(ks) == 3
    assert {name for _, name, _ in ks} == {"j0", "j1", "j2"}
    rvs = [rv for _, _, rv in ks]
    assert all(isinstance(rv, int) for rv in rvs)
    assert len(set(rvs)) == 3  # monotone resourceVersions, usable for age sort

# --- indexes (control-plane scalability, ISSUE 2) -------------------------


def _claim_selector(job):
    from tf_operator_tpu_torch.api import constants

    return {constants.LABEL_GROUP_NAME: constants.GROUP,
            constants.LABEL_JOB_NAME: job.metadata.name}


def test_list_claimable_answers_from_indexes():
    """Label-matching and owned-but-relabeled objects are returned;
    other jobs' objects are not — all via the job-name/owner indexes."""
    s = Store()
    mine = testutil.new_tpujob(worker=3, name="mine")
    other = testutil.new_tpujob(worker=3, name="other")
    for i in range(3):
        s.create(store_mod.PODS, testutil.new_pod(mine, "worker", i))
        s.create(store_mod.PODS, testutil.new_pod(other, "worker", i))
    # One owned pod whose job-name label was edited away: the release
    # path must still see it.
    relabeled = s.get(store_mod.PODS, "default", "mine-worker-0")
    relabeled.metadata.labels["job-name"] = "somewhere-else"
    s.update(store_mod.PODS, relabeled)

    out = s.list_claimable(store_mod.PODS, "default",
                           _claim_selector(mine), mine.metadata.uid)
    names = {p.metadata.name for p in out}
    assert names == {f"mine-worker-{i}" for i in range(3)}
    assert all("other" not in n for n in names)


def test_list_claimable_index_follows_updates_and_deletes():
    s = Store()
    job = testutil.new_tpujob(worker=2)
    for i in range(2):
        s.create(store_mod.PODS, testutil.new_pod(job, "worker", i))
    s.delete(store_mod.PODS, "default",
             testutil.new_pod(job, "worker", 0).metadata.name)
    out = s.list_claimable(store_mod.PODS, "default",
                           _claim_selector(job), job.metadata.uid)
    assert len(out) == 1


def test_list_claimable_returns_frozen_snapshots():
    """Returned objects are the stored immutable snapshots themselves —
    no per-sync deepcopy. A store write REPLACES the slot, so a held
    snapshot never changes underneath the caller."""
    s = Store()
    job = testutil.new_tpujob(worker=1)
    s.create(store_mod.PODS, testutil.new_pod(job, "worker", 0))
    sel = _claim_selector(job)
    first = s.list_claimable(store_mod.PODS, "default", sel,
                             job.metadata.uid)
    again = s.list_claimable(store_mod.PODS, "default", sel,
                             job.metadata.uid)
    assert first[0] is again[0]  # shared snapshot, not a copy
    held = first[0]
    held_rv = held.metadata.resource_version
    update = held.deepcopy()
    update.status.phase = "Running"
    s.update(store_mod.PODS, update)
    # The held snapshot is untouched; a fresh list sees the new slot.
    assert held.metadata.resource_version == held_rv
    assert held.status.phase != "Running"
    fresh = s.list_claimable(store_mod.PODS, "default", sel,
                             job.metadata.uid)
    assert fresh[0] is not held
    assert fresh[0].status.phase == "Running"


def test_owned_keys_tracks_ownership():
    s = Store()
    job_a = testutil.new_tpujob(worker=2, name="a")
    job_b = testutil.new_tpujob(worker=1, name="b")
    for i in range(2):
        s.create(store_mod.PODS, testutil.new_pod(job_a, "worker", i))
    s.create(store_mod.PODS, testutil.new_pod(job_b, "worker", 0))
    assert s.owned_keys(store_mod.PODS, job_a.metadata.uid) == [
        ("default", "a-worker-0"), ("default", "a-worker-1")]
    s.delete(store_mod.PODS, "default", "a-worker-0")
    assert s.owned_keys(store_mod.PODS, job_a.metadata.uid) == [
        ("default", "a-worker-1")]
    assert s.owned_keys(store_mod.PODS, "no-such-uid") == []


def test_owner_index_follows_release():
    """Dropping the controller ownerReference (release) removes the
    object from the owner index."""
    s = Store()
    job = testutil.new_tpujob(worker=1)
    s.create(store_mod.PODS, testutil.new_pod(job, "worker", 0))
    pod = s.get(store_mod.PODS, "default",
                testutil.new_pod(job, "worker", 0).metadata.name)
    pod.metadata.owner_references = []
    s.update(store_mod.PODS, pod)
    assert s.owned_keys(store_mod.PODS, job.metadata.uid) == []


# --- zero-copy reads + watch cache (sharded control plane, ISSUE 19) ------


class _CopyCounter:
    """Counts ApiObject.deepcopy calls inside a with-block."""

    def __enter__(self):
        from tf_operator_tpu_torch.api.types import ApiObject

        self._cls = ApiObject
        self._orig = ApiObject.deepcopy
        self.count = 0
        counter = self

        def counted(obj):
            counter.count += 1
            return counter._orig(obj)

        ApiObject.deepcopy = counted
        return self

    def __exit__(self, *exc):
        self._cls.deepcopy = self._orig
        return False


def test_get_snapshot_returns_frozen_object_without_copy():
    """The sync read path: get_snapshot hands out the stored immutable
    snapshot itself — zero deepcopies, identity-stable until the next
    write replaces the slot."""
    s = Store()
    created = s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))
    name = created.metadata.name
    with _CopyCounter() as copies:
        first = s.get_snapshot(store_mod.TPUJOBS, "default", name)
        again = s.get_snapshot(store_mod.TPUJOBS, "default", name)
    assert copies.count == 0
    assert first is again  # the stored snapshot, not a copy
    assert s.get_snapshot(store_mod.TPUJOBS, "default", "nope") is None
    update = first.deepcopy()
    s.update_status(store_mod.TPUJOBS, update)
    fresh = s.get_snapshot(store_mod.TPUJOBS, "default", name)
    assert fresh is not first  # write REPLACED the slot
    assert (first.metadata.resource_version
            < fresh.metadata.resource_version)


def test_watch_fanout_is_one_deepcopy_per_event():
    """W watchers receive ONE shared copy per event, not W copies —
    the fan-out allocation fix. Identity across handlers proves the
    share; the counter pins the per-event allocation at exactly 1."""
    s = Store()
    received = {i: [] for i in range(3)}
    done = threading.Event()

    def make_handler(i):
        def handler(etype, obj):
            received[i].append(obj)
            if all(received.values()):
                done.set()
        return handler

    for i in range(3):
        s.watch(store_mod.TPUJOBS, make_handler(i), replay=False)
    with _CopyCounter() as copies:
        s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1))
        assert done.wait(2.0)
    a, b, c = (received[i][0] for i in range(3))
    assert a is b is c  # one shared snapshot across the fan-out
    # create() copies once for the stored snapshot and once for the
    # fan-out — watcher count must not appear in the total.
    assert copies.count <= 2
    assert a is not s.get_snapshot(store_mod.TPUJOBS, "default",
                                   a.metadata.name)
    s.stop_watchers()


def test_watch_since_rv_replays_only_missed_events():
    """Reconnect path: a watcher resuming from a resourceVersion it has
    already seen gets exactly the missed deltas from the watch log (a
    cache hit) — NOT the full ADDED storm."""
    s = Store()
    for i in range(3):
        s.create(store_mod.TPUJOBS,
                 testutil.new_tpujob(worker=1, name=f"j{i}"))
    resume_rv = s.latest_rv()
    s.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=1, name="j3"))
    got = []
    done = threading.Event()

    def handler(etype, obj):
        got.append((etype, obj.metadata.name))
        done.set()

    hits0, misses0 = s.watch_cache_hits, s.watch_cache_misses
    s.watch(store_mod.TPUJOBS, handler, replay=True, since_rv=resume_rv)
    assert done.wait(2.0)
    assert got == [(store_mod.ADDED, "j3")]  # only the missed delta
    assert s.watch_cache_hits == hits0 + 1
    assert s.watch_cache_misses == misses0
    s.stop_watchers()


def test_watch_since_rv_past_eviction_falls_back_to_full_replay(
        monkeypatch):
    """When the watch log has evicted past the resume point the watcher
    gets the full ADDED replay (the reflector relist contract) and the
    miss is counted."""
    monkeypatch.setattr(store_mod, "WATCH_LOG_CAPACITY", 2)
    s = Store()
    first = s.create(store_mod.TPUJOBS,
                     testutil.new_tpujob(worker=1, name="j0"))
    resume_rv = first.metadata.resource_version
    for i in range(1, 5):  # evicts j0's entry from the 2-slot log
        s.create(store_mod.TPUJOBS,
                 testutil.new_tpujob(worker=1, name=f"j{i}"))
    got = []
    done = threading.Event()

    def handler(etype, obj):
        got.append((etype, obj.metadata.name))
        if len(got) >= 5:
            done.set()

    misses0 = s.watch_cache_misses
    s.watch(store_mod.TPUJOBS, handler, replay=True, since_rv=resume_rv)
    assert done.wait(2.0)
    assert sorted(n for _, n in got) == [f"j{i}" for i in range(5)]
    assert all(et == store_mod.ADDED for et, _ in got)
    assert s.watch_cache_misses == misses0 + 1
    s.stop_watchers()


def test_list_page_exactly_once_under_concurrent_writes():
    """Keyset pagination contract: a page walk sees every object that
    exists for the walk's whole duration EXACTLY once, even when
    objects are updated (rv churn) and created between pages."""
    s = Store()
    for i in range(20):
        s.create(store_mod.TPUJOBS,
                 testutil.new_tpujob(worker=1, name=f"job-{i:03d}"))
    original = {f"job-{i:03d}" for i in range(20)}

    seen = []
    after = None
    page = 0
    while True:
        items, after, rv = s.list_page(store_mod.TPUJOBS,
                                       namespace="default",
                                       limit=6, after=after)
        assert rv >= s.latest_rv() - 3  # cut at the live store version
        seen.extend(o.metadata.name for o in items)
        if after is None:
            break
        # Concurrent churn between pages: update an already-seen
        # object (rv bump must not resurface it) and create a new one
        # BEFORE the cursor (must not surface mid-walk either).
        victim = s.get(store_mod.TPUJOBS, "default", seen[0])
        s.update_status(store_mod.TPUJOBS, victim)
        s.create(store_mod.TPUJOBS, testutil.new_tpujob(
            worker=1, name=f"aaa-new-{page}"))
        page += 1

    assert len(seen) == len(set(seen)), "an object surfaced twice"
    assert original <= set(seen), "an original object was skipped"
    assert s.list_pages == page + 1


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
