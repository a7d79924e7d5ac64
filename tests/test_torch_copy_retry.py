"""Copy of ``tests/test_retry.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

runtime/retry.py + runtime/chaos.py unit coverage: transient
classification, backoff/jitter/deadline behavior, conflict-aware
read-modify-write, degraded-mode entry/exit and its disruption gates,
the seeded fault injector, the ChaosStore fault surface, and the HTTP
fake's FaultProfile path.
"""

import threading
import time

import pytest

from tf_operator_tpu_torch.api.types import ObjectMeta, Pod
from tf_operator_tpu_torch.runtime import metrics, store as store_mod
from tf_operator_tpu_torch.runtime.chaos import (
    ChaosStore,
    FaultInjector,
    FaultProfile,
)
from tf_operator_tpu_torch.runtime.retry import (
    ControlPlaneHealth,
    RetryPolicy,
    TransientAPIError,
    is_transient,
    update_with_conflict_retry,
    with_retries,
)
from tf_operator_tpu_torch.runtime.store import Store


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def test_semantic_outcomes_are_not_transient():
    assert not is_transient(store_mod.NotFoundError("x"))
    assert not is_transient(store_mod.ConflictError("x"))
    assert not is_transient(store_mod.AlreadyExistsError("x"))
    assert not is_transient(ValueError("x"))


def test_infrastructure_blips_are_transient():
    assert is_transient(TransientAPIError("boom"))
    assert is_transient(TimeoutError("slow"))
    assert is_transient(ConnectionResetError("gone"))
    assert is_transient(OSError("net"))


def test_status_code_classification():
    assert is_transient(TransientAPIError("t", code=503))
    assert is_transient(TransientAPIError("t", code=429))
    assert not is_transient(TransientAPIError("t", code=400))


# ---------------------------------------------------------------------------
# with_retries
# ---------------------------------------------------------------------------

def test_retries_then_succeeds():
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise TransientAPIError("blip")
        return "ok"

    assert with_retries(flaky, sleep=lambda s: None) == "ok"
    assert calls[0] == 3


def test_exhausted_retries_reraise_last_error():
    policy = RetryPolicy(max_attempts=3)
    calls = [0]

    def always():
        calls[0] += 1
        raise TransientAPIError("persistent")

    with pytest.raises(TransientAPIError):
        with_retries(always, policy=policy, sleep=lambda s: None)
    assert calls[0] == 3


def test_non_retryable_raises_immediately():
    calls = [0]

    def conflict():
        calls[0] += 1
        raise store_mod.ConflictError("cas")

    with pytest.raises(store_mod.ConflictError):
        with_retries(conflict, sleep=lambda s: None)
    assert calls[0] == 1


def test_backoff_is_capped_exponential_with_full_jitter():
    policy = RetryPolicy(base_delay=0.1, max_delay=0.4, max_attempts=5)
    # rng=1.0 -> the delay IS the cap for that attempt.
    delays = [policy.delay(a, lambda: 1.0) for a in range(4)]
    assert delays == [0.1, 0.2, 0.4, 0.4]
    # full jitter: rng=0 -> zero delay.
    assert policy.delay(3, lambda: 0.0) == 0.0


def test_deadline_stops_retrying():
    policy = RetryPolicy(base_delay=10.0, max_delay=10.0,
                         max_attempts=10, deadline_seconds=0.01)
    calls = [0]

    def always():
        calls[0] += 1
        raise TransientAPIError("blip")

    with pytest.raises(TransientAPIError):
        with_retries(always, policy=policy, sleep=lambda s: None,
                     rng=lambda: 1.0)
    # The first backoff (10s) already overshoots the 10ms deadline.
    assert calls[0] == 1


def test_retries_counted_in_metric():
    before = metrics.api_retries.value(component="test.retry")
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 2:
            raise TransientAPIError("blip")

    with_retries(flaky, component="test.retry", sleep=lambda s: None)
    assert metrics.api_retries.value(component="test.retry") == before + 1


# ---------------------------------------------------------------------------
# conflict-aware read-modify-write
# ---------------------------------------------------------------------------

def _pod(name="p", ns="default"):
    p = Pod(metadata=ObjectMeta(name=name, namespace=ns))
    return p


def test_conflict_retry_reapplies_on_fresh_state():
    store = Store()
    store.create(store_mod.PODS, _pod())

    raced = [False]

    class RacingStore:
        """First update loses to a concurrent writer; the retry must
        re-read and land the mutation on the NEW version."""

        def try_get(self, kind, ns, name):
            return store.try_get(kind, ns, name)

        def update(self, kind, obj):
            if not raced[0]:
                raced[0] = True
                fresh = store.get(kind, obj.metadata.namespace,
                                  obj.metadata.name)
                fresh.metadata.labels["racer"] = "won"
                store.update(kind, fresh)
                raise store_mod.ConflictError("lost the race")
            return store.update(kind, obj)

        def update_status(self, kind, obj):
            return store.update_status(kind, obj)

    def mutate(cur):
        cur.metadata.annotations["stamped"] = "yes"

    out = update_with_conflict_retry(RacingStore(), store_mod.PODS,
                                     "default", "p", mutate)
    assert out is not None
    final = store.get(store_mod.PODS, "default", "p")
    # Both the racer's write and ours survived — nothing clobbered.
    assert final.metadata.annotations["stamped"] == "yes"
    assert final.metadata.labels["racer"] == "won"


def test_conflict_retry_aborts_when_precondition_fails():
    store = Store()
    store.create(store_mod.PODS, _pod())
    out = update_with_conflict_retry(store, store_mod.PODS, "default",
                                     "p", lambda cur: False)
    assert out is None


def test_conflict_retry_none_on_vanished_object():
    store = Store()
    out = update_with_conflict_retry(store, store_mod.PODS, "default",
                                     "ghost", lambda cur: None)
    assert out is None


# ---------------------------------------------------------------------------
# degraded mode
# ---------------------------------------------------------------------------

def _health(threshold=0.0, failures=3):
    clock = [0.0]
    h = ControlPlaneHealth(threshold_seconds=threshold,
                           failure_threshold=failures,
                           clock=lambda: clock[0])
    return h, clock


def test_degraded_needs_both_streak_and_duration():
    h, clock = _health(threshold=5.0, failures=3)
    for _ in range(10):
        h.record_failure()
    assert not h.degraded  # streak yes, duration no
    clock[0] = 6.0
    h.record_failure()
    assert h.degraded


def test_single_blip_never_degrades():
    h, clock = _health(threshold=0.0, failures=5)
    for _ in range(4):
        h.record_failure()
    assert not h.degraded
    h.record_success()
    for _ in range(4):
        h.record_failure()
    assert not h.degraded  # success reset the streak


def test_success_clears_degraded_and_gauge():
    h, clock = _health(threshold=0.0, failures=2)
    h.record_failure()
    h.record_failure()
    assert h.degraded
    assert metrics.controlplane_degraded.value() == 1
    assert not h.allow_disruption("drain")
    h.record_success()
    assert not h.degraded
    assert metrics.controlplane_degraded.value() == 0
    assert h.allow_disruption("drain")


def test_deferred_disruptions_counted():
    h, clock = _health(threshold=0.0, failures=1)
    h.record_failure()
    before = metrics.disruptions_deferred.value(action="test-action")
    assert not h.allow_disruption("test-action")
    assert not h.allow_disruption("test-action")
    assert metrics.disruptions_deferred.value(
        action="test-action") == before + 2
    h.record_success()


def test_with_retries_feeds_health():
    h, clock = _health(threshold=0.0, failures=2)
    policy = RetryPolicy(max_attempts=2)

    def always():
        raise TransientAPIError("down")

    with pytest.raises(TransientAPIError):
        with_retries(always, policy=policy, health=h,
                     sleep=lambda s: None)
    assert h.degraded  # 2 attempts = 2 recorded failures
    with_retries(lambda: "ok", health=h)
    assert not h.degraded


# ---------------------------------------------------------------------------
# FaultProfile / FaultInjector
# ---------------------------------------------------------------------------

def test_named_profiles():
    off = FaultProfile.named("off")
    assert off.write_error_rate == 0.0
    default = FaultProfile.named("default", seed=3)
    assert default.write_error_rate >= 0.05
    assert default.conflict_rate >= 0.05
    assert default.seed == 3
    with pytest.raises(ValueError):
        FaultProfile.named("nope")


def test_overrides_win_most_specific_first():
    p = FaultProfile(write_error_rate=0.5, overrides={
        ("create", "pods"): {"write_error": 0.0},
        ("*", "nodes"): {"write_error": 1.0},
    })
    assert p.rate("write_error", "create", "pods") == 0.0
    assert p.rate("write_error", "delete", "nodes") == 1.0
    assert p.rate("write_error", "delete", "pods") == 0.5


def test_injector_is_seed_deterministic():
    a = FaultInjector(FaultProfile(seed=42, write_error_rate=0.3))
    b = FaultInjector(FaultProfile(seed=42, write_error_rate=0.3))
    seq_a = [a.decide("write_error") for _ in range(100)]
    seq_b = [b.decide("write_error") for _ in range(100)]
    assert seq_a == seq_b
    assert a.snapshot()["write_error"] == sum(seq_a)


# ---------------------------------------------------------------------------
# ChaosStore
# ---------------------------------------------------------------------------

def test_chaos_store_passthrough_with_zero_rates():
    base = Store()
    chaos = ChaosStore(base, FaultProfile())
    chaos.create(store_mod.PODS, _pod())
    assert chaos.get(store_mod.PODS, "default", "p").metadata.name == "p"
    assert len(chaos.list(store_mod.PODS)) == 1
    assert chaos.try_delete(store_mod.PODS, "default", "p")


def test_chaos_store_injects_write_errors():
    base = Store()
    chaos = ChaosStore(base, FaultProfile(seed=1, write_error_rate=1.0))
    with pytest.raises(TransientAPIError):
        chaos.create(store_mod.PODS, _pod())
    # Nothing landed: the fault fired before the write applied.
    assert base.count(store_mod.PODS) == 0


def test_chaos_store_injects_conflicts_on_updates_only():
    base = Store()
    base.create(store_mod.PODS, _pod())
    chaos = ChaosStore(base, FaultProfile(seed=1, conflict_rate=1.0))
    # create is conflict-free (conflicts are a CAS concept)...
    chaos.create(store_mod.PODS, _pod(name="other"))
    # ...updates always conflict under rate 1.0.
    cur = base.get(store_mod.PODS, "default", "p")
    with pytest.raises(store_mod.ConflictError):
        chaos.update(store_mod.PODS, cur)


def test_chaos_store_stale_read_serves_previous_version():
    base = Store()
    base.create(store_mod.PODS, _pod())
    chaos = ChaosStore(base, FaultProfile(seed=1, stale_read_rate=1.0))
    cur = base.get(store_mod.PODS, "default", "p")
    cur.metadata.labels["v"] = "2"
    chaos.update(store_mod.PODS, cur)  # stashes v1, applies v2
    stale = chaos.get(store_mod.PODS, "default", "p")
    assert "v" not in stale.metadata.labels  # served the OLD version
    assert base.get(store_mod.PODS, "default",
                    "p").metadata.labels["v"] == "2"


def test_chaos_store_lost_response_applies_then_raises():
    base = Store()
    chaos = ChaosStore(base, FaultProfile(seed=1,
                                          lost_response_rate=1.0))
    with pytest.raises(TransientAPIError):
        chaos.create(store_mod.PODS, _pod())
    # The write LANDED; only the reply was lost — the retry-idempotency
    # hazard production code must survive.
    assert base.count(store_mod.PODS) == 1


def test_chaos_store_drops_watch_events():
    base = Store()
    chaos = ChaosStore(base, FaultProfile(seed=1, watch_drop_rate=1.0))
    got = []
    w = chaos.watch(store_mod.PODS, lambda et, obj: got.append(et))
    base.create(store_mod.PODS, _pod())
    time.sleep(0.2)
    w.stop()
    assert got == []  # every event lost on the wire


def test_watch_handler_errors_counted_and_survived():
    base = Store()
    before = metrics.store_watch_handler_errors.value(
        kind=store_mod.PODS)
    fired = threading.Event()

    def bad_handler(et, obj):
        fired.set()
        raise RuntimeError("handler bug")

    w = base.watch(store_mod.PODS, bad_handler, replay=False)
    base.create(store_mod.PODS, _pod())
    base.create(store_mod.PODS, _pod(name="q"))
    assert fired.wait(2.0)
    deadline = time.monotonic() + 2.0
    while (metrics.store_watch_handler_errors.value(kind=store_mod.PODS)
           < before + 2 and time.monotonic() < deadline):
        time.sleep(0.01)
    w.stop()
    assert metrics.store_watch_handler_errors.value(
        kind=store_mod.PODS) >= before + 2
    assert w.error_count >= 2  # dispatcher survived both


# ---------------------------------------------------------------------------
# HTTP fake FaultProfile path (kube_fake)
# ---------------------------------------------------------------------------

def test_fake_apiserver_injects_profile_faults():
    import json
    import urllib.error
    import urllib.request

    from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer

    with FakeKubeApiServer(rbac_path=None) as srv:
        inj = srv.state.set_fault_profile(
            FaultProfile(seed=5, read_error_rate=1.0))
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"{srv.url}/api/v1/namespaces/default/pods", timeout=5)
        assert exc.value.code == 500
        assert inj.snapshot()["read_error"] == 1
        # Clearing the profile restores clean service.
        srv.state.set_fault_profile(None)
        with urllib.request.urlopen(
                f"{srv.url}/api/v1/namespaces/default/pods",
                timeout=5) as resp:
            assert json.loads(resp.read())["kind"] == "List"


def test_fake_apiserver_stale_reads_serve_history():
    import json
    import urllib.request

    from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer

    with FakeKubeApiServer(rbac_path=None) as srv:
        srv.state.set_fault_profile(
            FaultProfile(seed=5, stale_read_rate=1.0))
        srv.state.create("pods", "default", {
            "metadata": {"name": "p"}, "spec": {"containers": []}})
        srv.state.patch("pods", "default", "p",
                        {"metadata": {"labels": {"v": "2"}}})
        stale = srv.state.get("pods", "default", "p")
        assert "v" not in (stale["metadata"].get("labels") or {})


def test_fake_apiserver_injected_conflict_on_patch():
    import json
    import urllib.error
    import urllib.request

    from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer

    with FakeKubeApiServer(rbac_path=None) as srv:
        srv.state.create("pods", "default", {
            "metadata": {"name": "p"}, "spec": {"containers": []}})
        srv.state.set_fault_profile(
            FaultProfile(seed=5, conflict_rate=1.0))
        body = json.dumps({"metadata": {"labels": {"x": "1"}}}).encode()
        req = urllib.request.Request(
            f"{srv.url}/api/v1/namespaces/default/pods/p", data=body,
            method="PATCH",
            headers={"Content-Type": "application/merge-patch+json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5)
        assert exc.value.code == 409


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
