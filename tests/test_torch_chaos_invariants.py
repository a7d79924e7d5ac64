"""The chaos campaign through the port's control plane
(``tf_operator_tpu_torch/runtime/chaos_campaign.py``), held to the JAX
package's ``tests/test_chaos_invariants.py``:

- the same pinned seeds (7 plain with the resize pass off, 4 elastic,
  3 sharded, 3 RL), each round with zero violations through the port's
  ``GPUJobController``, gang, checkpoint coordinator, ``ShardMap`` and
  ``ChaosStore`` on ``h100-4`` slices;
- for every pinned seed, the port's draws (fleet shape, disruptions,
  threadiness, the ``FaultProfile``'s rates) equal those of
  ``hack/verify-chaos-invariants.py``, loaded as its own test loads it;
  only the draws are compared, the JAX rounds are not run;
- each invariant's check rejects a planted violation, so a checker that
  can never fail is caught;
- the command line's contract: exit 0 when clean, 1 with the repro seed.

Each round gets 180 s to converge where the JAX test gives 120 s: a
timeout is a violation, and the suite runs in six worker processes.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import threading
import time

import pytest

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    ObjectMeta,
    PodPhase,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.controller.ckpt import CheckpointCoordinator
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.runtime import chaos_campaign as cc
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.leaderelection import shard_for
from tf_operator_tpu_torch.runtime.store import Store

pytestmark = pytest.mark.control_plane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "hack", "verify-chaos-invariants.py")
ROUND_TIMEOUT = 180.0

# tests/test_chaos_invariants.py:35-69, unchanged.
PINNED_SEEDS = (100, 103, 1000, 1004, 1015, 1020, 1023)
ELASTIC_PINNED_SEEDS = (100, 2000, 2002, 2003)
SHARD_PINNED_SEEDS = (3000, 3003, 3007)
RL_PINNED_SEEDS = (4000, 4003, 4006)


@pytest.mark.parametrize("seed", PINNED_SEEDS)
def test_pinned_seed_holds_invariants(seed):
    errors = cc.run_round(seed, timeout=ROUND_TIMEOUT, elastic=False)
    assert not errors, f"seed {seed}: {errors}"


@pytest.mark.parametrize("seed", ELASTIC_PINNED_SEEDS)
def test_elastic_pinned_seed_holds_invariants(seed):
    errors = cc.run_round(seed, timeout=ROUND_TIMEOUT, elastic=True)
    assert not errors, f"seed {seed} (elastic): {errors}"


@pytest.mark.parametrize("seed", SHARD_PINNED_SEEDS)
def test_shard_pinned_seed_holds_invariants(seed):
    errors = cc.run_shard_round(seed, timeout=ROUND_TIMEOUT)
    assert not errors, f"seed {seed} (sharded): {errors}"


@pytest.mark.parametrize("seed", RL_PINNED_SEEDS)
def test_rl_pinned_seed_holds_invariants(seed):
    errors = cc.run_rl_round(seed, timeout=ROUND_TIMEOUT)
    assert not errors, f"seed {seed} (rl): {errors}"


# ---------------------------------------------------------------------------
# Draws: a seed names the same round in both packages
# ---------------------------------------------------------------------------

def _load_jax_script():
    spec = importlib.util.spec_from_file_location("verify_chaos", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(calls):
    """A stand-in harness: records the round's arguments, runs nothing."""

    def harness(**kwargs):
        profile = kwargs.pop("profile")
        kwargs["profile"] = {f.name: getattr(profile, f.name)
                             for f in dataclasses.fields(profile)}
        calls.append(kwargs)
        return {"invariant_violations": [], "ownership_violations": []}

    return harness


# (the round function's name, its harness, the seeds, round kwargs)
DRAWS = {
    "plain": ("run_round", "run_chaos_bench", PINNED_SEEDS,
              {"elastic": False}),
    "elastic": ("run_round", "run_chaos_bench", ELASTIC_PINNED_SEEDS,
                {"elastic": True}),
    "drawn": ("run_round", "run_chaos_bench",
              PINNED_SEEDS + ELASTIC_PINNED_SEEDS, {}),
    "sharded": ("run_shard_round", "run_sharded_chaos_bench",
                SHARD_PINNED_SEEDS, {}),
    "rl": ("run_rl_round", "run_chaos_bench", RL_PINNED_SEEDS, {}),
}


@pytest.mark.parametrize("mode", sorted(DRAWS))
def test_pinned_seeds_draw_the_jax_rounds(monkeypatch, mode):
    round_name, harness, seeds, kwargs = DRAWS[mode]
    jax_script = _load_jax_script()
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_script.bench_controlplane, harness,
                        _recorder(jax_calls))
    monkeypatch.setattr(cc, harness, _recorder(port_calls))
    for seed in seeds:
        assert getattr(jax_script, round_name)(seed, **kwargs) == []
        assert getattr(cc, round_name)(seed, **kwargs) == []
    assert len(port_calls) == len(seeds)
    assert port_calls == jax_calls
    for call in port_calls:
        rates = [v for k, v in call["profile"].items() if k.endswith("_rate")
                 and k != "lost_response_rate"]
        assert all(r > 0 for r in rates), call["profile"]


# ---------------------------------------------------------------------------
# Each check rejects a planted violation
# ---------------------------------------------------------------------------

NS = cc.NAMESPACE


def _job(store, name="planted", workers=2, accelerator=""):
    job = testutil.new_tpujob(worker=workers, name=name, namespace=NS,
                              accelerator=accelerator)
    return store.create(store_mod.TPUJOBS, job)


def _pod(job, index, phase=PodPhase.RUNNING, name=None):
    pod = testutil.new_pod(job, "worker", index, phase=phase)
    if name is not None:
        pod.metadata.name = name
    return pod


def test_check_pods_rejects_an_orphaned_pod():
    store = Store()
    job = _job(store)
    for i in range(2):
        store.create(store_mod.PODS, _pod(job, i))
    assert cc.check_pods(store) == []
    gone = testutil.new_tpujob(worker=1, name="gone", namespace=NS)
    store.create(store_mod.PODS, _pod(gone, 0))
    found = cc.check_pods(store)
    assert len(found) == 1 and found[0].startswith("orphaned pod gone-"), found


def test_check_pods_rejects_two_live_pods_of_one_identity():
    store = Store()
    job = _job(store)
    store.create(store_mod.PODS, _pod(job, 0))
    # A finished incarnation beside its replacement is no duplicate.
    store.create(store_mod.PODS, _pod(job, 0, phase=PodPhase.SUCCEEDED,
                                      name="planted-worker-0-old"))
    assert cc.check_pods(store) == []
    store.create(store_mod.PODS, _pod(job, 0, name="planted-worker-0-twin"))
    found = cc.check_pods(store)
    assert len(found) == 1 and "duplicate live pods" in found[0], found
    assert "'worker', '0'" in found[0]


def _group(name, gpus, phase):
    return SliceGroup(
        metadata=ObjectMeta(name=name, namespace=NS),
        spec=SliceGroupSpec(min_member=1, slice=TPUSliceSpec(
            accelerator=cc.accelerator(gpus))),
        status=SliceGroupStatus(phase=phase))


def test_admission_check_rejects_gpus_above_the_budget():
    store = Store()
    store.create(store_mod.SLICEGROUPS, _group("a", 4, "Running"))
    store.create(store_mod.SLICEGROUPS, _group("b", 4, "Inqueue"))
    store.create(store_mod.SLICEGROUPS, _group("queued", 4, "Pending"))
    assert cc.admitted_gpus(store) == 8
    assert cc.check_budget(cc.admitted_gpus(store), 8) == []
    store.create(store_mod.SLICEGROUPS, _group("c", 4, "Running"))
    found = cc.check_budget(cc.admitted_gpus(store), 8)
    assert found == ["admitted GPUs peaked at 12 > budget 8 (duplicate "
                     "admission / double-booking)"]


def test_barrier_check_rejects_an_unresolved_barrier():
    store = Store()
    job = testutil.new_tpujob(worker=2, name="held", namespace=NS,
                              accelerator=cc.accelerator(4))
    job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
        enabled=True, directory="/bench/ckpt", interval_steps=8,
        barrier_timeout_seconds=60.0)
    job = store.create(store_mod.TPUJOBS, job)
    for i in range(2):
        store.create(store_mod.PODS, _pod(job, i))
    ckpt = CheckpointCoordinator(store)
    assert cc.check_barriers(0, 0, 0, ckpt, store) == []
    # The barrier opens; no worker acks it and it has not timed out.
    assert not ckpt.ready_to_evict(NS, "held", "planted disruption")
    found = cc.check_barriers(0, 1, 0, ckpt, store)
    assert len(found) == 2, found
    assert found[0] == ("1 disruptions displaced + 0 shrinks landed but "
                        "only 0 barriers resolved (a barrier was left "
                        "unresolved)")
    assert found[1] == ("in-flight barriers left at convergence: "
                        "[('bench', 'held')]")


def test_a_gang_displaced_mid_grow_is_readmitted_at_its_grown_size():
    """Elastic seeds 100, 2000 and 2003 breached the budget under load:
    a gang whose grow had landed in its job spec (2 slices) but not yet
    in its group (1) was displaced, then re-admitted at the group's 1
    slice, and the grow pass handed the other slice's GPUs to a second
    gang. Four h100-4 gangs of minSlices 1 / maxSlices 2 on 20 GPUs."""
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_INQUEUE,
        PHASE_RUNNING,
        SliceGangScheduler,
    )

    store = Store()
    gang = SliceGangScheduler(store, total_chips=20, elastic=True)
    jobs = []
    for i in range(4):
        job = testutil.new_tpujob(worker=1, name=f"grow-{i}", namespace=NS,
                                  accelerator=cc.accelerator(4))
        job.spec.slice.min_slices, job.spec.slice.max_slices = 1, 2
        jobs.append(store.create(store_mod.TPUJOBS, job))
        gang.sync_slice_group(job, job.spec.replica_specs)

    def set_phase(name, phase):
        group = store.get(store_mod.SLICEGROUPS, NS, name)
        group.status.phase = phase
        store.update_status(store_mod.SLICEGROUPS, group)

    def grow_job(name):     # the job spec half of a landed grow
        job = store.get(store_mod.TPUJOBS, NS, name)
        job.spec.slice.num_slices = 2
        job.spec.replica_specs["worker"].replicas = 2
        store.update(store_mod.TPUJOBS, job)

    for i in range(4):
        set_phase(f"grow-{i}", PHASE_RUNNING)
    grow_job("grow-0")
    assert gang.displace(NS, "grow-0", "planted drain")
    gang.readmit()
    for i in range(4):   # the engine's syncs: group specs follow jobs
        job = store.get(store_mod.TPUJOBS, NS, f"grow-{i}")
        gang.sync_slice_group(job, job.spec.replica_specs)
    booked = {g.metadata.name: g.spec.slice.num_slices * 4
              for g in store.list(store_mod.SLICEGROUPS)
              if g.status.phase in (PHASE_INQUEUE, PHASE_RUNNING)}
    assert sum(booked.values()) <= 20, booked
    assert booked.get("grow-0") == 8, booked


def test_a_grow_stays_charged_until_its_group_follows():
    """Elastic seed 2000 breached the budget under load (1 round in about
    50): once a grow's job write had been seen, its charge rested on the
    job-vs-group delta alone, and a stale read of the job (its version
    before the grow) hid the grow from the next pass, which gave the same
    GPUs to a second gang. Two h100-4 gangs of minSlices 1 / maxSlices 2
    on 12 GPUs: one grows, then its job is read stale."""
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_INQUEUE,
        PHASE_RUNNING,
        SliceGangScheduler,
    )

    store = Store()
    gang = SliceGangScheduler(store, total_chips=12, elastic=True)
    for name in ("a", "b"):
        job = testutil.new_tpujob(worker=1, name=name, namespace=NS,
                                  accelerator=cc.accelerator(4))
        job.spec.slice.min_slices, job.spec.slice.max_slices = 1, 2
        job = store.create(store_mod.TPUJOBS, job)
        gang.sync_slice_group(job, job.spec.replica_specs)
    before = store.get(store_mod.TPUJOBS, NS, "a")
    for name in ("a", "b"):
        group = store.get(store_mod.SLICEGROUPS, NS, name)
        group.status.phase = PHASE_RUNNING
        store.update_status(store_mod.SLICEGROUPS, group)
    gang.readmit()      # a grows into the 4 free GPUs
    assert store.get(store_mod.TPUJOBS, NS, "a").spec.slice.num_slices == 2
    gang.readmit()      # a pass that reads the grow in a's job
    fresh = store.try_get
    store.try_get = lambda kind, ns, name: (
        before.deepcopy() if (kind, name) == (store_mod.TPUJOBS, "a")
        else fresh(kind, ns, name))
    gang.readmit()      # a pass that reads a's job from before the grow
    store.try_get = fresh
    for name in ("a", "b"):   # the engine's syncs: group specs follow jobs
        job = store.get(store_mod.TPUJOBS, NS, name)
        gang.sync_slice_group(job, job.spec.replica_specs)
    booked = {g.metadata.name: g.spec.slice.num_slices * 4
              for g in store.list(store_mod.SLICEGROUPS)
              if g.status.phase in (PHASE_INQUEUE, PHASE_RUNNING)}
    assert sum(booked.values()) <= 12, booked


def test_a_stale_job_read_is_not_acted_on():
    """Elastic seed 2003 breached the budget under load: a sync read the
    job from before a shrink (a stale read, one of the campaign's fault
    classes) and set its group back to the old size. The controller now
    reads a job no older than one it has seen. Here a job scaled from 2
    workers to 1 is then read at its old version."""
    store = Store()
    controller = GPUJobController(store)
    job = store.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=2))
    old = store.get_snapshot(store_mod.TPUJOBS, "default", job.metadata.name)
    job.spec.replica_specs["worker"].replicas = 1
    store.update(store_mod.TPUJOBS, job)
    store.create(store_mod.PODS, testutil.new_pod(
        job, "worker", 0, phase=PodPhase.RUNNING))
    store.create(store_mod.ENDPOINTS, testutil.new_endpoint(job, "worker", 0))
    controller.sync_tpujob(job.key())          # the current version
    fresh = store.get_snapshot
    store.get_snapshot = lambda kind, ns, name: (
        old if kind == store_mod.TPUJOBS else fresh(kind, ns, name))
    controller.sync_tpujob(job.key())          # the version before it
    pods = sorted(p.metadata.name for p in store.list(store_mod.PODS))
    assert pods == ["test-tpujob-worker-0"], pods


def test_a_resource_version_that_moved_back_is_acted_on_after_a_bound():
    """resourceVersions are opaque, and a restore of the API server's
    storage can move them back for good: a job whose store never again
    reaches the version a sync read is read again only
    ``STALE_READ_RETRIES`` times, then reconciled. Here the store is
    set back to the job's 2-worker version after a sync read it at 1."""
    from tf_operator_tpu_torch.controller import gpu_controller

    store = Store()
    controller = GPUJobController(store)
    job = store.create(store_mod.TPUJOBS, testutil.new_tpujob(worker=2))
    old = store.get_snapshot(store_mod.TPUJOBS, "default", job.metadata.name)
    job.spec.replica_specs["worker"].replicas = 1
    store.update(store_mod.TPUJOBS, job)
    store.create(store_mod.PODS, testutil.new_pod(
        job, "worker", 0, phase=PodPhase.RUNNING))
    store.create(store_mod.ENDPOINTS, testutil.new_endpoint(job, "worker", 0))
    controller.sync_tpujob(job.key())          # the version before the restore
    fresh = store.get_snapshot
    store.get_snapshot = lambda kind, ns, name: (
        old if kind == store_mod.TPUJOBS else fresh(kind, ns, name))

    def pods():
        return sorted(p.metadata.name for p in store.list(store_mod.PODS))

    for _ in range(gpu_controller.STALE_READ_RETRIES):
        controller.sync_tpujob(job.key())
    assert pods() == ["test-tpujob-worker-0"], pods()
    controller.sync_tpujob(job.key())
    assert pods() == ["test-tpujob-worker-0", "test-tpujob-worker-1"], (
        "the job was never reconciled again after its resourceVersion "
        "moved back")


def test_restore_check_rejects_a_restore_below_the_watermark():
    store = Store()
    job = _job(store, accelerator=cc.accelerator(4))
    violations = []
    stamp = time.time() - 60.0   # the displace recorded committed step 24
    kubelet = cc.ChaosKubelet(store, steps=30, save_interval=8,
                              watermark={"planted": (24, stamp)},
                              violations=violations)

    def start(index, restore):
        pod = _pod(job, index, phase=PodPhase.PENDING)
        pod.spec.containers[0].env[constants.ENV_RESTORE_STEP] = str(restore)
        kubelet._start(store.create(store_mod.PODS, pod))

    start(0, 16)        # within one save granule: the render race
    assert violations == []
    start(1, 15)        # below it: committed steps lost
    assert violations == [
        "pod planted-worker-1 restored from step 15 with committed "
        "watermark 24 (committed steps lost across restart)"]
    # An incarnation created before the displace is not judged.
    kubelet.watermark["planted"] = (24, time.time() + 60.0)
    start(2, 0)
    assert len(violations) == 1


def test_shard_check_rejects_a_second_live_controller_on_one_shard():
    """Replica A's elector dies without its controller: the lease lapses
    while A's engine still runs, and B's takeover is the
    double-reconcile window the registry must report."""
    store = Store()
    lock = threading.Lock()
    active, violations, durations = {}, [], []
    a, b = (cc._InstrumentedShardedOperator(name, store, 2, 1, durations,
                                            violations, lock, active)
            for name in ("replica-a", "replica-b"))
    try:
        a.start()
        assert a.shard_map.wait_until_held(2, timeout=10.0)
        b.start()
        a.shard_map.crash(1)   # the lease only; A's engine lives on
        deadline = time.monotonic() + 20.0
        while 1 not in b.held_shards and time.monotonic() < deadline:
            time.sleep(0.02)
        assert 1 in b.held_shards
    finally:
        b.stop()
        a.stop()
        store.stop_watchers()
    assert violations == [
        "shard 1 acquired by replica-b while replica-a still runs a "
        "controller on it (double-reconcile window)"]


def test_shard_check_rejects_a_sync_off_the_owning_shard():
    store = Store()
    violations = []
    jobs = [_job(store, name=f"owned-{i}") for i in range(8)]
    owned = {j.metadata.name: shard_for(NS, j.metadata.uid, 2) for j in jobs}
    c = GPUJobController(store, namespace=NS, shard_index=0, shard_count=2)
    recorder = cc._OwnershipRecorder(c, store, 2, [], violations,
                                     threading.Lock())
    for name, shard in sorted(owned.items()):
        recorder(f"{NS}/{name}")
    strays = sorted(n for n, s in owned.items() if s != 0)
    assert strays, owned
    assert violations == [f"{NS}/{n} synced by shard 0, owned by shard 1"
                          for n in strays]


def test_sharded_replica_stops_its_controllers_before_releasing():
    """A graceful stop hands each lease over only after this replica's
    controller on it has stopped: the standby never finds it running."""
    store = Store()
    lock = threading.Lock()
    active, violations = {}, []
    a, b = (cc._InstrumentedShardedOperator(name, store, 3, 1, [],
                                            violations, lock, active)
            for name in ("replica-a", "replica-b"))
    try:
        a.start()
        assert a.shard_map.wait_until_held(3, timeout=10.0)
        b.start()
        # A shard counts as held before its engine is built.
        deadline = time.monotonic() + 10.0
        while (any(a.operator_for(i) is None for i in range(3))
               and time.monotonic() < deadline):
            time.sleep(0.02)
        for op in (a.operator_for(i) for i in range(3)):
            def slow(*args, inner=op.controller.stop, **kwargs):
                time.sleep(0.3)      # an engine draining its syncs
                inner(*args, **kwargs)

            op.controller.stop = slow
        a.stop()
        assert b.shard_map.wait_until_held(3, timeout=10.0)
    finally:
        b.stop()
        store.stop_watchers()
    assert violations == []


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_cli_runs_clean():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.runtime.chaos_campaign",
         "--rounds", "2", "--seed", "100"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stderr


def test_cli_exits_1_with_the_repro_seed(monkeypatch, capsys):
    seen = []

    def planted(seed, timeout, verbose):
        seen.append(seed)
        return ["planted violation"] if seed == 8 else []

    monkeypatch.setattr(cc, "run_rl_round", planted)
    assert cc.main(["--rl", "--rounds", "3", "--seed", "7"]) == 1
    err = capsys.readouterr().err
    assert seen == [7, 8]
    assert "FAIL (repro: --seed 8 --rounds 1 --rl):" in err
    assert "  planted violation" in err
