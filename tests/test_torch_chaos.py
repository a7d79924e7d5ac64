"""The port's fault injection (``runtime/chaos.py``) against the JAX
package's.

- For each named ``FaultProfile`` and a few seeds, the same scripted
  sequence of store calls through each package's ``ChaosStore`` (over
  each package's own ``Store``) raises at the same calls, serves the
  same stale reads and ends with the same ``snapshot()`` counts; the
  watch path drops the same events.
- The profiles resolve the same rates, per-verb overrides included.
- ``crash_controller`` stops the port's controller mid-arc under
  injected API errors; a fresh one against the surviving store brings
  the job to Succeeded.
"""

import dataclasses
import time
import types

import pytest

from tf_operator_tpu import testutil as jtestutil
from tf_operator_tpu.api import types as jtypes
from tf_operator_tpu.runtime import chaos as jchaos
from tf_operator_tpu.runtime import store as jstore
from tf_operator_tpu_torch import testutil as ttestutil
from tf_operator_tpu_torch.api import types as ttypes
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.runtime import chaos as tchaos
from tf_operator_tpu_torch.runtime import store as tstore

pytestmark = pytest.mark.control_plane

PACKAGES = {
    "jax": types.SimpleNamespace(chaos=jchaos, store=jstore, types=jtypes,
                                 testutil=jtestutil),
    "torch": types.SimpleNamespace(chaos=tchaos, store=tstore, types=ttypes,
                                   testutil=ttestutil),
}
PROFILES = ("off", "default", "heavy")
SEEDS = (0, 1, 7)
CALLS = 240


def _outcome(fn):
    try:
        result = fn()
    except Exception as err:  # the fault (or a semantic 404/409) raised
        return type(err).__name__
    if result is None or isinstance(result, bool):
        return result
    if isinstance(result, list):
        return sorted(o.metadata.name for o in result)
    return (result.metadata.name, result.metadata.resource_version)


def transcript(pk, profile: str, seed: int):
    """The outcome of each of a fixed sequence of CRUD calls through a
    ``ChaosStore`` of ``pk``, and the injector's counts."""
    chaos = pk.chaos.ChaosStore(pk.store.Store(),
                                pk.chaos.FaultProfile.named(profile,
                                                            seed=seed))
    pods = pk.store.PODS
    out = []
    for i in range(CALLS):
        name = f"p{(i * 7) % 11}"
        pod = pk.types.Pod(metadata=pk.types.ObjectMeta(
            name=name, namespace="default", labels={"i": str(i % 3)}))
        verb = i % 6
        if verb == 0:
            call = lambda: chaos.create(pods, pod)  # noqa: E731
        elif verb == 1:
            call = lambda: chaos.get(pods, "default", name)  # noqa: E731
        elif verb == 2:
            def call():
                cur = chaos.inner.try_get(pods, "default", name)
                if cur is None:
                    return chaos.create(pods, pod)
                cur.metadata.labels["i"] = str(i)
                return chaos.update(pods, cur)
        elif verb == 3:
            def call():
                cur = chaos.inner.try_get(pods, "default", name)
                if cur is None:
                    return None
                cur.status.phase = "Running"
                return chaos.update_status(pods, cur)
        elif verb == 4:
            call = lambda: chaos.list(  # noqa: E731
                pods, namespace="default", selector={"i": "1"})
        else:
            call = lambda: chaos.try_delete(  # noqa: E731
                pods, "default", name)
        out.append((i, _outcome(call)))
    return out, chaos.injector.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("profile", PROFILES)
def test_same_faults_at_the_same_calls(profile, seed):
    jout, jcounts = transcript(PACKAGES["jax"], profile, seed)
    tout, tcounts = transcript(PACKAGES["torch"], profile, seed)
    assert tout == jout
    assert tcounts == jcounts
    if profile != "off":
        assert sum(tcounts.values()) > 0
        assert any(not isinstance(o, (tuple, list, bool, type(None)))
                   for _, o in tout)


def dropped_events(pk, profile: str, seed: int, n: int = 60):
    """Names whose ADDED event a chaotic watch lost, of ``n`` pods
    created on the inner store."""
    inner = pk.store.Store()
    chaos = pk.chaos.ChaosStore(inner, pk.chaos.FaultProfile.named(
        profile, seed=seed))
    seen = []
    watcher = chaos.watch(pk.store.PODS,
                          lambda etype, obj: seen.append(obj.metadata.name))
    for i in range(n):
        inner.create(pk.store.PODS, pk.types.Pod(metadata=pk.types.ObjectMeta(
            name=f"w{i:03d}", namespace="default")))
    deadline = time.monotonic() + 10
    while (len(seen) + chaos.injector.snapshot()["watch_drop"] < n
           and time.monotonic() < deadline):
        time.sleep(0.01)
    watcher.stop()
    inner.stop_watchers()
    return sorted({f"w{i:03d}" for i in range(n)} - set(seen))


@pytest.mark.parametrize("profile", ["default", "heavy"])
def test_watch_drops_the_same_events(profile):
    jdrop = dropped_events(PACKAGES["jax"], profile, seed=5)
    tdrop = dropped_events(PACKAGES["torch"], profile, seed=5)
    assert tdrop == jdrop and tdrop


@pytest.mark.parametrize("profile", PROFILES)
def test_profiles_resolve_the_same_rates(profile):
    jp = jchaos.FaultProfile.named(profile, seed=3)
    tp = tchaos.FaultProfile.named(profile, seed=3)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    overrides = {("update", "pods"): {"conflict": 0.5},
                 ("*", "tpujobs"): {"write_error": 0.25}}
    jp.overrides, tp.overrides = dict(overrides), dict(overrides)
    for fault in tchaos.FAULTS:
        for verb, kind in (("update", "pods"), ("create", "tpujobs"),
                           ("get", "pods"), ("*", "*")):
            assert tp.rate(fault, verb, kind) == jp.rate(fault, verb, kind)
    assert tchaos.FAULTS == jchaos.FAULTS
    with pytest.raises(ValueError):
        tchaos.FaultProfile.named("storm")


def _wait(predicate, what: str, resync, timeout: float = 30.0):
    """Wait for ``predicate``, calling ``resync`` every 0.2 s (the
    production resync backstop: an injected fault can lose a watch
    handler's read, and only a level-triggered resync finds it again)."""
    deadline = time.monotonic() + timeout
    next_resync = 0.0
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        if time.monotonic() >= next_resync:
            resync()
            next_resync = time.monotonic() + 0.2
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_crash_restart_mid_arc_converges():
    """The port's controller reconciles through injected 5xx, 409s, lost
    responses, timeouts and stale reads; it is crashed once its pods run
    and a cold-started one finishes the job against the surviving
    store (the harness plays kubelet on the store itself)."""
    base = tstore.Store()
    profile = dataclasses.replace(tchaos.FaultProfile.named("default",
                                                            seed=11),
                                  watch_drop_rate=0.0)
    chaos = tchaos.ChaosStore(base, profile)

    def build():
        controller = GPUJobController(chaos)
        # A lost watch event leaves an expectation unobserved; the chaos
        # harness's short expiry (2 s, as the JAX benchmark's) ends it.
        controller.expectations._timeout = 2.0
        controller.run(threadiness=2)
        return controller

    def set_phase(phase: str):
        for pod in base.list(tstore.PODS, namespace="default"):
            pod.status.phase = phase
            base.update_status(tstore.PODS, pod)

    controller = build()
    resync = lambda: controller.enqueue("default/crash")  # noqa: E731
    try:
        base.create(tstore.TPUJOBS, ttestutil.new_tpujob(worker=2,
                                                         name="crash"))
        _wait(lambda: len(base.list(tstore.PODS, namespace="default")) == 2,
              "two pods", resync)
        set_phase("Running")
        _wait(lambda: cond.is_running(base.get(
            tstore.TPUJOBS, "default", "crash").status), "job Running",
            resync)
        tchaos.crash_controller(controller)
        controller = build()
        set_phase("Succeeded")
        _wait(lambda: cond.is_succeeded(base.get(
            tstore.TPUJOBS, "default", "crash").status), "job Succeeded",
            resync)
    finally:
        tchaos.crash_controller(controller)
        base.stop_watchers()
    assert sorted(p.metadata.name for p in base.list(
        tstore.PODS, namespace="default")) == ["crash-worker-0",
                                               "crash-worker-1"]
    assert chaos.injector.total > 0
