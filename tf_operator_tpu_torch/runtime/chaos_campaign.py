"""The port's chaos campaign: the whole control plane under injected
faults, operator crash-restarts and shard-holder kills, with the
invariants it must hold (port of ``hack/verify-chaos-invariants.py``
and of the parts of ``benchmarks/bench_controlplane.py`` it runs:
``run_chaos_bench`` and ``run_sharded_chaos_bench`` over the port's
``GPUJobController``, gang, quota, checkpoint coordinator, ``ShardMap``
and ``ChaosStore``; ``h100-4`` slices where the JAX package has
``v5e-4``, both one host of 4 devices).

Each round draws a fleet shape (jobs x workers), a ``FaultProfile``
(write/read 5xx, 409 conflicts, timeouts, stale reads, dropped watch
events, lost responses: every class at a non-trivial rate) and a number
of planned disruptions, in the JAX script's order, so a seed draws the
same round in both packages. It then runs real reconciliation through
the fault-injecting store with one operator crash-restart mid-run and
checks, after convergence:

1. convergence: every job reaches Succeeded (a timeout is a violation);
2. no orphaned pods, and no two live pods with one (job, replica type,
   index) identity (a lost expectation would double-create);
3. no duplicate gang admission: the GPUs admitted at once, sampled at
   20 Hz, never exceed the budget (at each group's current size, so
   the check holds mid-resize);
4. every opened checkpoint barrier resolves (acked or timed out), and
   none is in flight at convergence;
5. no recreated worker restores from below the committed-step
   watermark recorded at its eviction (less one save granule, the
   render race of the JAX harness's seed 1004);
6. elastic rounds: no gang below its ``minSlices`` floor;
7. RL rounds: a learner's uid never changes while its job runs under
   actor kill storms, and its committed step never regresses;
8. sharded rounds (``--sharded``): two replicas contend for N shard
   leases; every sync runs on the shard that owns the job's (namespace,
   uid) hash, no shard ever has two live controllers, and a shard whose
   holder was killed without releasing its lease is re-acquired.

Usage::

    python -m tf_operator_tpu_torch.runtime.chaos_campaign            # 10 rounds
    python -m tf_operator_tpu_torch.runtime.chaos_campaign --rounds 3 --seed 7
    python -m tf_operator_tpu_torch.runtime.chaos_campaign --sharded --rounds 3
    python -m tf_operator_tpu_torch.runtime.chaos_campaign --rl --rounds 3

Exit status 0: every round clean; 1: a violation, with the repro seed
on stderr. A control-plane module: it imports neither torch nor jax.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    ContainerStatus,
    ObjectMeta,
    Pod,
    PodPhase,
    PodStatus,
)
from tf_operator_tpu_torch.controller import conditions as cond
from tf_operator_tpu_torch.controller.gpu_controller import GPUJobController
from tf_operator_tpu_torch.operator import ShardedOperator
from tf_operator_tpu_torch.runtime import store as store_mod
from tf_operator_tpu_torch.runtime.chaos import FaultProfile
from tf_operator_tpu_torch.runtime.store import Store

NAMESPACE = "bench"
TERMINAL = ("Succeeded", "Failed")


def accelerator(gpus: int) -> str:
    """The slice of one host of ``gpus`` H100s (JAX: ``v5e-<chips>``)."""
    return f"h100-{gpus}"


class FakeKubelet(threading.Thread):
    """Drives pod phases like a node agent: every tick, Pending pods
    start Running and Running pods complete with exit 0. One phase per
    tick so the controller observes the full lifecycle churn.

    ``admitted``: optional (namespace, job_name) -> bool gate: a Pending
    pod starts only once its SliceGroup is admitted (or, in the failover
    tests, once the test opens the gate). ``min_run_seconds`` holds
    Running pods at least that long before completing them."""

    def __init__(self, store: Store, tick: float = 0.01, admitted=None,
                 min_run_seconds: float = 0.0):
        super().__init__(name="fake-kubelet", daemon=True)
        self.store = store
        self.tick = tick
        self.admitted = admitted
        self.min_run_seconds = min_run_seconds
        self._run_since: Dict[Tuple[str, str], float] = {}
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            transitions = self.store.project(
                store_mod.PODS,
                lambda p: ((p.metadata.namespace, p.metadata.name,
                            p.status.phase,
                            p.metadata.labels.get(
                                constants.LABEL_JOB_NAME, ""))
                           if p.status.phase in (PodPhase.PENDING,
                                                 PodPhase.RUNNING)
                           else None),
                namespace=NAMESPACE)
            now = time.perf_counter()
            for ns, name, phase, job_name in transitions:
                patch = Pod(metadata=ObjectMeta(name=name, namespace=ns))
                if phase == PodPhase.PENDING:
                    if (self.admitted is not None
                            and not self.admitted(ns, job_name)):
                        continue  # gang gate: held until admission
                    self._run_since[(ns, name)] = now
                    patch.status = PodStatus(phase=PodPhase.RUNNING,
                                             start_time=testutil.now())
                elif (self.min_run_seconds
                        and now - self._run_since.get((ns, name), 0.0)
                        < self.min_run_seconds):
                    continue  # still inside its minimum runtime
                else:
                    patch.status = _succeeded_status()
                try:
                    self.store.update_status(store_mod.PODS, patch)
                except (store_mod.NotFoundError, store_mod.ConflictError):
                    pass  # reaped or raced by the controller; benign
            self._stop.wait(self.tick)


def _succeeded_status() -> PodStatus:
    return PodStatus(
        phase=PodPhase.SUCCEEDED, start_time=testutil.now(),
        container_statuses=[ContainerStatus(
            name=constants.DEFAULT_CONTAINER_NAME,
            state="Terminated", exit_code=0)])


class _SyncTimer:
    """Wraps ``sync_tpujob`` to count syncs and record their durations."""

    def __init__(self, controller: GPUJobController):
        self._inner = controller.sync_tpujob
        self.durations: List[float] = []
        self._lock = threading.Lock()
        controller.sync_tpujob = self  # type: ignore[assignment]

    def __call__(self, key: str) -> None:
        t0 = time.perf_counter()
        try:
            self._inner(key)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.durations.append(dt)

    def snapshot(self) -> List[float]:
        with self._lock:
            return list(self.durations)


class _OwnershipRecorder:
    """``_SyncTimer`` of the sharded rounds: times syncs and records the
    ownership evidence — every synced key must hash to the syncing
    controller's shard."""

    def __init__(self, controller: GPUJobController, store: Store,
                 shards: int, durations: List[float],
                 violations: List[str], lock: threading.Lock):
        from tf_operator_tpu_torch.runtime.leaderelection import shard_for

        self._inner = controller.sync_tpujob
        self._controller = controller
        self._store = store
        self._shards = shards
        self._shard_for = shard_for
        self.durations = durations
        self.violations = violations
        self._lock = lock
        controller.sync_tpujob = self  # type: ignore[assignment]

    def __call__(self, key: str) -> None:
        ns, name = key.split("/", 1)
        snap = self._store.get_snapshot(store_mod.TPUJOBS, ns, name)
        if snap is not None:
            owner = self._shard_for(ns, snap.metadata.uid, self._shards)
            if owner != self._controller.shard_index:
                with self._lock:
                    self.violations.append(
                        f"{key} synced by shard "
                        f"{self._controller.shard_index}, owned by "
                        f"shard {owner}")
        t0 = time.perf_counter()
        try:
            self._inner(key)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.durations.append(dt)


class _InstrumentedShardedOperator(ShardedOperator):
    """One operator replica of the sharded rounds: the ``ShardedOperator``
    that ``--shards`` deploys, its engines reconciling through
    ``controller_store`` (the fault-injecting one) while its leases stay
    on the healthy ``store`` (a flaky lease is a different failure mode
    than a flaky API), each shard's controller timed and checked by an
    ``_OwnershipRecorder``. The shared ``active`` registry proves single
    ownership: a shard acquired while another replica's engine on it has
    not yet stopped is a recorded violation."""

    def __init__(self, name: str, store: Store, shards: int,
                 threadiness: int, durations: List[float],
                 violations: List[str], lock: threading.Lock,
                 active: Dict[int, str],
                 lease_duration: float = 1.0,
                 renew_deadline: float = 0.4,
                 retry_period: float = 0.05,
                 controller_store=None,
                 expectations_timeout: Optional[float] = None):
        super().__init__(shards, store=controller_store or store,
                         lease_store=store, backend=None, identity=name,
                         namespace=NAMESPACE,
                         lease_duration=lease_duration,
                         renew_deadline=renew_deadline,
                         retry_period=retry_period)
        self.name = name
        self.base = store
        self.threadiness = threadiness
        self.expectations_timeout = expectations_timeout
        self.durations = durations
        self.violations = violations
        self.lock = lock
        self.active = active

    def start(self, threadiness: Optional[int] = None) -> None:
        super().start(threadiness=threadiness or self.threadiness)

    def _build_shard_operator(self, index: int):
        with self.lock:
            holder = self.active.get(index)
            if holder is not None:
                self.violations.append(
                    f"shard {index} acquired by {self.name} while "
                    f"{holder} still runs a controller on it "
                    "(double-reconcile window)")
            self.active[index] = self.name
        op = super()._build_shard_operator(index)
        c = op.controller
        if self.expectations_timeout is not None:
            c.expectations._timeout = self.expectations_timeout
        _OwnershipRecorder(c, self.base, self.shards, self.durations,
                           self.violations, self.lock)
        stop = op.stop

        def stopped(*args, **kwargs):
            # The shard leaves the registry only once its engine has
            # stopped: a takeover before that is the window it reports.
            stop(*args, **kwargs)
            self._left(index)

        op.stop = stopped
        return op

    def _left(self, index: int) -> None:
        with self.lock:
            if self.active.get(index) == self.name:
                del self.active[index]

    def crash_shard(self, index: int) -> None:
        """Kill this replica's hold on ``index`` the hard way: the
        elector dies releasing nothing (survivors must wait out the
        lease), the shard's engine dies with its workqueue and
        expectations. One still starting is waited for first."""
        from tf_operator_tpu_torch.runtime.chaos import crash_controller

        self.shard_map.crash(index)
        with self._lock:
            op = self._shard_ops.pop(index, None)
        if op is not None:
            crash_controller(op.controller)
            self._left(index)


class CkptFakeKubelet(FakeKubelet):
    """FakeKubelet that also plays the checkpointing worker and node
    agent: Running pods advance one training step a tick, publish
    periodic saves and barrier acks as CheckpointRecords, and a
    recreated pod resumes from the ``TPUJOB_RESTORE_STEP`` env the
    controller rendered."""

    def __init__(self, store: Store, steps: int, tick: float = 0.01,
                 admitted=None, save_interval: int = 20):
        super().__init__(store, tick=tick, admitted=admitted)
        self.steps = steps
        self.save_interval = save_interval
        # (ns, pod, uid) -> progress of the current incarnation (keyed
        # by uid so a recreate re-reads its restore env).
        self._progress: Dict[Tuple[str, str, str], int] = {}
        self._acked: Dict[Tuple[str, str, str], str] = {}

    def run(self) -> None:  # overrides FakeKubelet.run
        while not self._stop.is_set():
            for pod in self.store.list(store_mod.PODS, namespace=NAMESPACE):
                if pod.status.phase == PodPhase.PENDING:
                    job_name = pod.metadata.labels.get(
                        constants.LABEL_JOB_NAME, "")
                    if (self.admitted is not None
                            and not self.admitted(pod.metadata.namespace,
                                                  job_name)):
                        continue
                    self._start(pod)
                elif pod.status.phase == PodPhase.RUNNING:
                    self._step(pod)
            self._stop.wait(self.tick)

    def _key(self, pod) -> Tuple[str, str, str]:
        return (pod.metadata.namespace, pod.metadata.name,
                pod.metadata.uid)

    def _start(self, pod) -> None:
        restore = 0
        for c in pod.spec.containers:
            if constants.ENV_RESTORE_STEP in c.env:
                restore = int(c.env[constants.ENV_RESTORE_STEP])
        self._progress[self._key(pod)] = restore
        patch = Pod(metadata=ObjectMeta(name=pod.metadata.name,
                                        namespace=pod.metadata.namespace))
        patch.status = PodStatus(phase=PodPhase.RUNNING,
                                 start_time=testutil.now())
        try:
            self.store.update_status(store_mod.PODS, patch)
        except (store_mod.NotFoundError, store_mod.ConflictError):
            pass

    def _step(self, pod) -> None:
        key = self._key(pod)
        if key not in self._progress:
            self._start(pod)  # Running before we saw it Pending
            return
        self._progress[key] += 1
        progress = self._progress[key]
        notice = pod.metadata.annotations.get(
            constants.ANNOTATION_PREEMPT_NOTICE, "")
        barrier = ""
        if notice and self._acked.get(key) != notice:
            barrier = json.loads(notice).get("barrier", "")
        periodic = progress % self.save_interval == 0
        if barrier or periodic or progress >= self.steps:
            self._publish(pod, progress, barrier)
            if barrier:
                self._acked[key] = notice
        if progress >= self.steps:
            patch = Pod(metadata=ObjectMeta(
                name=pod.metadata.name,
                namespace=pod.metadata.namespace))
            patch.status = _succeeded_status()
            try:
                self.store.update_status(store_mod.PODS, patch)
            except (store_mod.NotFoundError, store_mod.ConflictError):
                pass

    def _publish(self, pod, progress: int, barrier: str) -> None:
        from tf_operator_tpu_torch.api.types import (
            CheckpointRecord,
            CheckpointRecordStatus,
        )

        ns, name = pod.metadata.namespace, pod.metadata.name
        status = CheckpointRecordStatus(
            step=progress, progress_step=progress, barrier_id=barrier,
            directory="/bench/ckpt", save_seconds=0.001,
            updated_at=testutil.now())
        try:
            existing = self.store.try_get(store_mod.CHECKPOINTRECORDS,
                                          ns, name)
            if existing is None:
                self.store.create(store_mod.CHECKPOINTRECORDS,
                                  CheckpointRecord(
                    metadata=ObjectMeta(
                        name=name, namespace=ns,
                        labels=dict(pod.metadata.labels),
                        owner_references=[r.deepcopy() for r in
                                          pod.metadata.owner_references]),
                    status=status))
            else:
                existing.status = status
                self.store.update_status(store_mod.CHECKPOINTRECORDS,
                                         existing)
        except (store_mod.AlreadyExistsError, store_mod.ConflictError,
                store_mod.NotFoundError):
            pass  # raced; the next periodic publish lands


class ChaosKubelet(CkptFakeKubelet):
    """The chaos rounds' data plane. A pod with no rendered restore step
    falls back to the newest local checkpoint (the records stand for
    the disk), as ``train/checkpoint.py`` does; each start is held to
    the committed-step watermark (``check_restore``); RL actors
    checkpoint nothing."""

    def __init__(self, store: Store, steps: int, tick: float = 0.01,
                 admitted=None, save_interval: int = 20,
                 watermark: Optional[Dict[str, tuple]] = None,
                 violations: Optional[List[str]] = None):
        super().__init__(store, steps=steps, tick=tick, admitted=admitted,
                         save_interval=save_interval)
        # job -> (committed step, wall time the displace recorded it)
        self.watermark = {} if watermark is None else watermark
        self.violations = [] if violations is None else violations

    def _start(self, pod) -> None:
        restore = None
        for c in pod.spec.containers:
            if constants.ENV_RESTORE_STEP in c.env:
                restore = int(c.env[constants.ENV_RESTORE_STEP])
        job_name = pod.metadata.labels.get(constants.LABEL_JOB_NAME, "")
        if restore is None:
            # No TPUJOB_RESTORE_STEP rendered: resume from the newest
            # local checkpoint, not from scratch (an env rendered before
            # the first commit, the pod created after it).
            steps = [r.status.step for r in self.store.list(
                store_mod.CHECKPOINTRECORDS, namespace=NAMESPACE,
                selector={constants.LABEL_JOB_NAME: job_name})
                if r.status.step >= 0]
            restore = min(steps) if steps else 0
            for c in pod.spec.containers:
                c.env[constants.ENV_RESTORE_STEP] = str(restore)
        found = check_restore(pod, restore, self.watermark.get(job_name),
                              self.save_interval)
        if found:
            self.violations.append(found)
        super()._start(pod)

    def _publish(self, pod, progress: int, barrier: str) -> None:
        # An actor record would drag committed_step (the min over the
        # records) down to actor pace and poison every learner restore.
        if (pod.metadata.labels.get(constants.LABEL_REPLICA_TYPE)
                == "actor"):
            return
        super()._publish(pod, progress, barrier)


# ---------------------------------------------------------------------------
# The invariants: each check returns what it found, so a planted
# violation can be shown to be caught.
# ---------------------------------------------------------------------------

def check_restore(pod, restore: int, watermark: Optional[tuple],
                  save_interval: int) -> Optional[str]:
    """Restart with identity: a pod created after the displace that
    recorded ``watermark`` = (committed step, wall time) must not start
    from scratch, nor more than one save granule below the committed
    step. Incarnations created before the stamp (their env predates
    the watermark) are not judged."""
    created = pod.metadata.creation_timestamp
    if (watermark is not None and created is not None
            and created.timestamp() > watermark[1]
            and (restore == 0 or restore < watermark[0] - save_interval)):
        return (f"pod {pod.metadata.name} restored from step {restore} "
                f"with committed watermark {watermark[0]} "
                "(committed steps lost across restart)")
    return None


def admitted_gpus(store: Store) -> int:
    """GPUs of every admitted SliceGroup, at each group's current size."""
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_INQUEUE,
        PHASE_RUNNING,
        _chips_for,
    )

    return sum(store.project(
        store_mod.SLICEGROUPS,
        lambda g: (_chips_for(g) if g.status.phase in (PHASE_INQUEUE,
                                                       PHASE_RUNNING)
                   else None)))


def check_budget(peak: int, budget: int) -> List[str]:
    if peak > budget:
        return [f"admitted GPUs peaked at {peak} > budget {budget} "
                "(duplicate admission / double-booking)"]
    return []


def check_floors(store: Store, broken: set) -> List[str]:
    """Elastic: no job resized below its minSlices floor (each job
    reported once, ``broken`` carrying those already reported)."""
    found = []
    for name, cur, mn in store.project(
            store_mod.TPUJOBS,
            lambda j: (j.metadata.name, j.spec.slice.num_slices,
                       j.spec.slice.min_slices),
            namespace=NAMESPACE):
        if mn is not None and cur < mn and name not in broken:
            broken.add(name)
            found.append(f"job {name} resized to {cur} slice(s), below "
                         f"minSlices {mn}")
    return found


def check_pods(store: Store) -> List[str]:
    """No orphaned pod, and no two live pods with one identity."""
    found = []
    live_jobs = {j.metadata.uid
                 for j in store.list(store_mod.TPUJOBS, namespace=NAMESPACE)}
    seen: Dict[tuple, str] = {}
    for p in store.list(store_mod.PODS, namespace=NAMESPACE):
        ref = p.metadata.controller_ref()
        if ref is None or ref.uid not in live_jobs:
            found.append(f"orphaned pod {p.metadata.name}: controller "
                         "owner missing from the store")
            continue
        if p.status.phase in TERMINAL:
            continue
        ident = (ref.uid,
                 p.metadata.labels.get(constants.LABEL_REPLICA_TYPE),
                 p.metadata.labels.get(constants.LABEL_REPLICA_INDEX))
        if ident in seen:
            found.append(f"duplicate live pods for identity {ident}: "
                         f"{seen[ident]} and {p.metadata.name}")
        seen[ident] = p.metadata.name
    return found


def check_barriers(resolved: int, displaced: int, shrinks: int, ckpt,
                   store: Store) -> List[str]:
    """Every displacement and shrink resolved its barrier (acked or
    timed out), and no barrier of an unfinished job is in flight."""
    found = []
    if resolved < displaced + shrinks:
        found.append(f"{displaced} disruptions displaced + {shrinks} "
                     f"shrinks landed but only {resolved} barriers "
                     "resolved (a barrier was left unresolved)")
    finished = {(j.metadata.namespace, j.metadata.name)
                for j in store.list(store_mod.TPUJOBS, namespace=NAMESPACE)
                if cond.is_finished(j.status)}
    in_flight = [key for key, b in getattr(ckpt, "_barriers", {}).items()
                 if not b.outcome and key not in finished]
    if in_flight:
        found.append(f"in-flight barriers left at convergence: {in_flight}")
    return found


def _succeeded_jobs(store: Store) -> int:
    return sum(store.project(
        store_mod.TPUJOBS,
        lambda j: 1 if cond.is_succeeded(j.status) else None,
        namespace=NAMESPACE))


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


# ---------------------------------------------------------------------------
# The rounds' harnesses
# ---------------------------------------------------------------------------

def run_sharded_chaos_bench(jobs: int, workers: int, shards: int,
                            threadiness: int, timeout: float,
                            profile_name: str = "default", seed: int = 0,
                            profile=None, kubelet_tick: float = 0.01,
                            crashes: int = 1,
                            resync_period: float = 0.25) -> Dict:
    """Split brain under faults: two replicas contend for ``shards``
    leases on the healthy base store while every controller reconciles
    through a seeded ``FaultProfile``; mid-run ``crashes`` shard holders
    are killed without releasing their leases, so the survivor must
    wait out the lease and take over through the faults.
    ``ownership_violations`` (a sync off the owning shard, two live
    controllers on one shard) and ``invariant_violations`` (a crashed
    shard never re-acquired, orphaned or duplicate pods) must be empty.
    Raises TimeoutError if the fleet does not converge."""
    from tf_operator_tpu_torch.runtime.chaos import ChaosStore

    base = Store()
    if profile is None:
        profile = FaultProfile.named(profile_name, seed=seed)
    chaos = ChaosStore(base, profile)
    kubelet = FakeKubelet(base, tick=kubelet_tick)
    durations: List[float] = []
    ownership_violations: List[str] = []
    violations: List[str] = []
    lock = threading.Lock()
    active: Dict[int, str] = {}
    per_shard_threads = max(1, threadiness // shards)
    replicas = [_InstrumentedShardedOperator(
                    name, base, shards, per_shard_threads, durations,
                    ownership_violations, lock, active,
                    controller_store=chaos, expectations_timeout=2.0)
                for name in ("replica-a", "replica-b")]
    replica_a, replica_b = replicas
    replica_a.start()
    if not replica_a.shard_map.wait_until_held(shards, timeout=30.0):
        raise TimeoutError(
            f"replica A holds {sorted(replica_a.held_shards)} of "
            f"{shards} shards after 30s")
    replica_b.start()

    stop_aux = threading.Event()

    def resync() -> None:
        """The resync backstop, shard-routed: every job re-enqueued on
        the live controller that owns its hash (the recovery path for
        dropped watch events)."""
        while not stop_aux.wait(resync_period):
            for rep in replicas:
                try:
                    rep.resync()
                except Exception:
                    pass  # an injected read fault; the next period retries

    def survivor_of(vname: str) -> _InstrumentedShardedOperator:
        return replica_b if vname == "replica-a" else replica_a

    def note_failovers() -> None:
        for vname, shard, tk in crashed[len(failovers):]:
            if shard not in survivor_of(vname).held_shards:
                break
            failovers.append(time.perf_counter() - tk)

    kubelet.start()
    resync_t = threading.Thread(target=resync, daemon=True,
                                name="shard-resync")
    t0 = time.perf_counter()
    crashed: List[tuple] = []   # (victim replica, shard, crash time)
    failovers: List[float] = []
    try:
        for i in range(jobs):
            base.create(store_mod.TPUJOBS, testutil.new_tpujob(
                worker=workers, name=f"bench-{i:04d}", namespace=NAMESPACE))
        resync_t.start()

        deadline = t0 + timeout
        next_kill_at = max(1, jobs // 3)
        while True:
            succeeded = _succeeded_jobs(base)
            if len(crashed) < crashes and succeeded >= next_kill_at:
                # Kill whoever holds the target shard now: after the
                # first failover that can be either replica.
                target = (shards - 1 - len(crashed)) % shards
                victim = next((r for r in replicas
                               if target in r.held_shards), None)
                if victim is not None:
                    victim.crash_shard(target)
                    crashed.append(
                        (victim.name, target, time.perf_counter()))
                    next_kill_at = succeeded + max(1, jobs // 4)
            note_failovers()
            if succeeded >= jobs:
                break
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"{succeeded}/{jobs} jobs Succeeded after {timeout}s "
                    f"(A holds {sorted(replica_a.held_shards)}, B holds "
                    f"{sorted(replica_b.held_shards)}, {len(crashed)} "
                    "shard crash(es))")
            time.sleep(0.02)
        convergence = time.perf_counter() - t0
        # A small fleet can converge before the survivor has waited out
        # the dead holder's lease: give each pending takeover the
        # worst-case acquisition window before calling the shard
        # orphaned.
        acquire_by = time.perf_counter() + 3 * 1.0 + 2.0
        while (len(failovers) < len(crashed)
               and time.perf_counter() < acquire_by):
            note_failovers()
            time.sleep(0.05)
    finally:
        stop_aux.set()
        kubelet.stop()
        replica_a.stop()
        replica_b.stop()
        base.stop_watchers()

    for vname, shard, _ in crashed[len(failovers):]:
        violations.append(f"shard {shard} crashed on {vname} was never "
                          "re-acquired by the surviving replica")
    violations.extend(check_pods(base))
    return {
        "convergence_seconds": round(convergence, 3),
        "jobs_per_sec": round(jobs / convergence, 2),
        "syncs": len(durations),
        "jobs": jobs,
        "workers_per_job": workers,
        "pods": jobs * workers,
        "threadiness": threadiness,
        "shards": shards,
        "threadiness_per_shard": per_shard_threads,
        "chaos_profile": profile_name,
        "chaos_seed": seed,
        "faults_injected": chaos.injector.snapshot(),
        "faults_injected_total": chaos.injector.total,
        "shard_crashes": [{"replica": v, "shard": s}
                          for v, s, _ in crashed],
        "failover_seconds": [round(f, 3) for f in failovers],
        "shard_reassignments": (replica_a.shard_map.reassignments
                                + replica_b.shard_map.reassignments),
        "ownership_violations": list(ownership_violations),
        "invariant_violations": list(violations),
    }


def run_chaos_bench(jobs: int, workers: int, threadiness: int,
                    timeout: float, profile_name: str = "default",
                    seed: int = 0, disruptions: int = 2,
                    steps: int = 60, save_interval: int = 15,
                    chips_per_job: int = 4,
                    barrier_timeout: float = 10.0,
                    capacity_fraction: float = 0.6,
                    kubelet_tick: float = 0.01,
                    crash_restarts: int = 1,
                    resync_period: float = 0.5,
                    profile=None,
                    elastic: bool = False,
                    rl: bool = False,
                    actors: int = 2) -> Dict:
    """The whole control plane (gang admission, checkpoint barriers,
    disruptions) reconciling through a seeded ``FaultProfile`` between
    the operator and its store, with ``crash_restarts`` operator
    crash-restarts mid-run (all in-memory state lost, the store kept).
    Every job is ``h100-<chips_per_job>`` under a checkpoint policy; the
    GPU budget is below the fleet's demand so admission queues.

    ``elastic``: jobs declare minSlices 1 / maxSlices 2, one spare slice
    of budget lets the grow pass fire, and an exerciser requests
    barrier-gated shrinks through the faults. ``rl``: every job carries
    ``actors`` evict-class actors that consume no GPU beside its
    learners, and the disruptor is an actor kill storm (at least half a
    job's pool deleted at once, no barrier). ``invariant_violations``
    must be empty. Raises TimeoutError if the fleet does not
    converge."""
    from tf_operator_tpu_torch.api.types import CheckpointPolicy
    from tf_operator_tpu_torch.controller.ckpt import CheckpointCoordinator
    from tf_operator_tpu_torch.controller.engine import EngineConfig
    from tf_operator_tpu_torch.controller.gang import (
        PHASE_INQUEUE,
        PHASE_RUNNING,
        SliceGangScheduler,
    )
    from tf_operator_tpu_torch.runtime import metrics
    from tf_operator_tpu_torch.runtime.chaos import (
        ChaosStore,
        crash_controller,
    )
    from tf_operator_tpu_torch.runtime.retry import ControlPlaneHealth

    base = Store()
    if profile is None:
        profile = FaultProfile.named(profile_name, seed=seed)
    chaos = ChaosStore(base, profile)
    # A budget below the fleet's demand forces real queueing, so the
    # duplicate-admission invariant bites. Elastic rounds instead get
    # one spare slice: every gang admits and the grow pass has exactly
    # one slice to fight over.
    if elastic:
        total_chips = (jobs + 1) * chips_per_job
    else:
        total_chips = max(chips_per_job,
                          int(jobs * chips_per_job * capacity_fraction))

    holder: Dict[str, object] = {}
    dur_acc: List[float] = []  # sync durations across crash-restarts

    def build():
        """(Re)build the operator assembly against the surviving store:
        the cold start a crash-restart exercises."""
        if "timer" in holder:
            dur_acc.extend(holder["timer"].snapshot())
        cp_health = ControlPlaneHealth(threshold_seconds=1.0)
        ckpt = CheckpointCoordinator(chaos).start()
        gang = SliceGangScheduler(chaos, total_chips=total_chips,
                                  ckpt=ckpt, cp_health=cp_health,
                                  elastic=elastic)
        ckpt.on_ack = gang.readmit
        controller = GPUJobController(
            chaos, config=EngineConfig(enable_gang_scheduling=True),
            gang=gang, namespace=NAMESPACE, ckpt=ckpt,
            cp_health=cp_health)
        # Dropped watch events must unblock in seconds, not the
        # production 5 minutes.
        controller.expectations._timeout = 2.0
        holder.update(controller=controller, gang=gang, ckpt=ckpt,
                      timer=_SyncTimer(controller))
        controller.run(threadiness=threadiness)

    def group_admitted(ns: str, job_name: str) -> bool:
        g = base.try_get(store_mod.SLICEGROUPS, ns, job_name)
        return g is not None and g.status.phase in (PHASE_INQUEUE,
                                                    PHASE_RUNNING)

    # job -> (committed step, wall time of the displace that saw it)
    watermark: Dict[str, tuple] = {}
    violations: List[str] = []
    kubelet = ChaosKubelet(base, steps=steps, tick=kubelet_tick,
                           admitted=group_admitted,
                           save_interval=save_interval,
                           watermark=watermark, violations=violations)

    injected = [0]
    stop_aux = threading.Event()
    max_admitted = [0]
    shrinks_landed = [0]
    # Bounded shrinks: unbounded shrink/grow churn could eat a pod's
    # uncommitted progress faster than it accrues.
    resize_budget = [max(2, disruptions)] if elastic else [0]

    def exercise_resizes() -> None:
        """Barrier-gated shrinks of grown gangs through the faults; the
        grow pass refills them."""
        while not stop_aux.is_set() and resize_budget[0] > 0:
            gang = holder["gang"]
            try:
                target = None
                for j in base.list(store_mod.TPUJOBS, namespace=NAMESPACE):
                    sl = j.spec.slice
                    if (sl.min_slices is not None
                            and sl.num_slices > sl.min_slices
                            and not cond.is_finished(j.status)):
                        target = j.metadata.name
                        break
                if target is None:
                    stop_aux.wait(kubelet_tick)
                    continue
                if gang.try_shrink(NAMESPACE, target, 1, "chaos",
                                   "chaos shrink"):
                    shrinks_landed[0] += 1
                    resize_budget[0] -= 1
            except Exception:
                pass  # injected fault; retry next tick
            stop_aux.wait(kubelet_tick)

    storms = [0]
    actor_kills = [0]
    learner_uids: Dict[tuple, str] = {}
    committed_seen: Dict[str, int] = {}

    def actor_storm() -> None:
        """The RL rounds' disruptor: round-robin over live jobs, each
        storm deleting at least half the target's live actors at once
        (evict class: no barrier, no displacement)."""
        cursor = 0
        half = max(1, (actors + 1) // 2)
        while not stop_aux.is_set() and storms[0] < disruptions:
            try:
                live = sorted(
                    j.metadata.name
                    for j in base.list(store_mod.TPUJOBS,
                                       namespace=NAMESPACE)
                    if not cond.is_finished(j.status))
                if not live:
                    stop_aux.wait(kubelet_tick)
                    continue
                target = live[cursor % len(live)]
                cursor += 1
                pool = sorted(
                    (p for p in base.list(
                        store_mod.PODS, namespace=NAMESPACE,
                        selector={constants.LABEL_JOB_NAME: target})
                     if p.metadata.labels.get(
                         constants.LABEL_REPLICA_TYPE) == "actor"
                     and p.status.phase not in TERMINAL),
                    key=lambda p: p.metadata.name)
                if len(pool) < half:
                    stop_aux.wait(kubelet_tick)
                    continue  # pool not regrown yet; storm a whole one
                for p in pool[:half]:
                    if base.try_delete(store_mod.PODS, NAMESPACE,
                                       p.metadata.name):
                        actor_kills[0] += 1
                        metrics.actor_preemptions.inc(
                            job_namespace=NAMESPACE, reason="chaos")
                storms[0] += 1
            except Exception:
                pass  # racing convergence; retry next tick
            stop_aux.wait(kubelet_tick)

    def sample_rl() -> None:
        """The RL invariants on the base store: a learner's uid never
        changes while its job runs, and the committed step (min over
        the job's records) never regresses."""
        while not stop_aux.wait(0.05):
            finished = {j.metadata.name
                        for j in base.list(store_mod.TPUJOBS,
                                           namespace=NAMESPACE)
                        if cond.is_finished(j.status)}
            for p in base.list(store_mod.PODS, namespace=NAMESPACE):
                if p.status.phase != "Running":
                    continue
                labels = p.metadata.labels
                jn = labels.get(constants.LABEL_JOB_NAME, "")
                rt = labels.get(constants.LABEL_REPLICA_TYPE, "")
                if jn in finished or rt == "actor":
                    continue
                ident = (jn, rt,
                         labels.get(constants.LABEL_REPLICA_INDEX, ""))
                prev = learner_uids.get(ident)
                if prev is None:
                    learner_uids[ident] = p.metadata.uid
                elif prev != p.metadata.uid:
                    learner_uids[ident] = p.metadata.uid
                    violations.append(
                        f"learner pod {ident} restarted (uid changed) "
                        "during actor-only chaos")
            steps_by_job: Dict[str, List[int]] = {}
            for r in base.list(store_mod.CHECKPOINTRECORDS,
                               namespace=NAMESPACE):
                jn = r.metadata.labels.get(constants.LABEL_JOB_NAME, "")
                if r.status.step >= 0 and jn not in finished:
                    steps_by_job.setdefault(jn, []).append(r.status.step)
            for jn, ss in steps_by_job.items():
                committed = min(ss)
                prev = committed_seen.get(jn)
                if prev is not None and committed < prev:
                    violations.append(
                        f"job {jn} committed step regressed {prev} -> "
                        f"{committed} under actor-only chaos")
                committed_seen[jn] = max(prev or 0, committed)

    def disrupt() -> None:
        """Round-robin planned disruptions through the current
        coordinator and gang: every call may hit an injected fault;
        level-triggered retry is the contract."""
        cursor = 0
        in_flight: Optional[str] = None
        while not stop_aux.is_set() and injected[0] < disruptions:
            ckpt = holder["ckpt"]
            gang = holder["gang"]
            try:
                target = in_flight
                if target is None:
                    live = sorted(
                        g.metadata.name
                        for g in base.list(store_mod.SLICEGROUPS,
                                           namespace=NAMESPACE)
                        if g.status.phase in (PHASE_INQUEUE,
                                              PHASE_RUNNING)
                        and not g.status.displaced_reason)
                    if not live:
                        stop_aux.wait(kubelet_tick)
                        continue
                    target = live[cursor % len(live)]
                    cursor += 1
                if ckpt.ready_to_evict(NAMESPACE, target,
                                       "chaos disruption"):
                    committed = ckpt.committed_step(NAMESPACE, target)
                    for p in base.list(
                            store_mod.PODS, namespace=NAMESPACE,
                            selector={constants.LABEL_JOB_NAME: target}):
                        if p.status.phase not in TERMINAL:
                            base.try_delete(store_mod.PODS, NAMESPACE,
                                            p.metadata.name)
                    if gang.displace(NAMESPACE, target,
                                     "chaos disruption"):
                        if committed is not None:
                            prev = watermark.get(target, (0, 0.0))
                            watermark[target] = (
                                max(prev[0], committed), time.time())
                        injected[0] += 1
                        in_flight = None
                    else:
                        in_flight = target
                else:
                    in_flight = target
            except Exception:
                pass  # injected fault; retry next tick
            stop_aux.wait(kubelet_tick)

    def resync() -> None:
        """The resync loop (``cli.py`` ``_resync_loop``): the backstop
        that makes dropped watch events recoverable."""
        while not stop_aux.wait(resync_period):
            controller = holder.get("controller")
            if controller is None:
                continue
            try:
                for key in base.project(store_mod.TPUJOBS,
                                        lambda j: j.key(),
                                        namespace=NAMESPACE):
                    controller.enqueue(key)
            except Exception:
                pass

    def sample_admission() -> None:
        """The GPUs admitted at once, sampled at 20 Hz (at each group's
        current size), and in elastic rounds the minSlices floors."""
        broken: set = set()
        while not stop_aux.wait(0.05):
            max_admitted[0] = max(max_admitted[0], admitted_gpus(base))
            if elastic:
                violations.extend(check_floors(base, broken))

    acked_before = metrics.checkpoint_barriers.value(
        job_namespace=NAMESPACE, outcome="acked")
    timeout_before = metrics.checkpoint_barriers.value(
        job_namespace=NAMESPACE, outcome="timeout")
    retries_before = sum(v for _, v in metrics.api_retries.collect())
    degraded_before = sum(v for _, v in
                          metrics.degraded_entries.collect()) or 0.0

    build()
    kubelet.start()
    aux_specs = [(actor_storm if rl else disrupt, "disruptor"),
                 (resync, "resync"),
                 (sample_admission, "admission-probe")]
    if elastic:
        aux_specs.append((exercise_resizes, "resize-exerciser"))
    if rl:
        aux_specs.append((sample_rl, "rl-probe"))
    aux = [threading.Thread(target=fn, daemon=True, name=name)
           for fn, name in aux_specs]
    t0 = time.perf_counter()
    crashes_done = 0
    try:
        for i in range(jobs):
            # Elastic jobs couple the worker count to the slice count
            # (one host a slice), so the resize pass scales both.
            job = testutil.new_tpujob(worker=1 if elastic else workers,
                                      actor=actors if rl else 0,
                                      name=f"bench-{i:04d}",
                                      namespace=NAMESPACE)
            if rl:
                from tf_operator_tpu_torch.api.types import (
                    DisruptionClass,
                    ReplicaType,
                    RolePolicy,
                )

                job.spec.replica_specs[ReplicaType.ACTOR].role_policy = \
                    RolePolicy(chip_consuming=False, preemptible=True,
                               min_replicas=1, max_replicas=actors,
                               disruption_class=DisruptionClass.EVICT)
            job.spec.slice.accelerator = accelerator(chips_per_job)
            if elastic:
                job.spec.slice.min_slices = 1
                job.spec.slice.max_slices = 2
            job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
                enabled=True, directory="/bench/ckpt",
                interval_steps=save_interval,
                barrier_timeout_seconds=barrier_timeout)
            base.create(store_mod.TPUJOBS, job)
        for t in aux:
            t.start()

        deadline = t0 + timeout
        while True:
            succeeded = _succeeded_jobs(base)
            if (crashes_done < crash_restarts
                    and succeeded >= max(1, jobs // 3)):
                # Crash-restart mid-reconcile: the whole assembly dies
                # (workqueue, expectations, barrier deadlines); a fresh
                # one cold-starts against the surviving store.
                crash_controller(holder["controller"], holder["ckpt"])
                crashes_done += 1
                build()
            if succeeded >= jobs:
                # Disruptions are best effort past convergence: with no
                # live gang left the remaining count would never land.
                break
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"{succeeded}/{jobs} jobs Succeeded, "
                    f"{injected[0]}/{disruptions} disruptions after "
                    f"{timeout}s")
            time.sleep(0.02)
        convergence = time.perf_counter() - t0
    finally:
        stop_aux.set()
        for t in aux:
            if t.is_alive():
                t.join(timeout=5.0)
        kubelet.stop()
        crash_controller(holder.get("controller"), holder.get("ckpt"))
        base.stop_watchers()

    violations.extend(check_pods(base))
    violations.extend(check_budget(max_admitted[0], total_chips))
    barriers_acked = int(metrics.checkpoint_barriers.value(
        job_namespace=NAMESPACE, outcome="acked") - acked_before)
    barriers_timeout = int(metrics.checkpoint_barriers.value(
        job_namespace=NAMESPACE, outcome="timeout") - timeout_before)
    violations.extend(check_barriers(
        barriers_acked + barriers_timeout, injected[0], shrinks_landed[0],
        holder["ckpt"], base))

    durations = dur_acc + holder["timer"].snapshot()
    return {
        "convergence_seconds": round(convergence, 3),
        "jobs_per_sec": round(jobs / convergence, 2),
        "syncs": len(durations),
        "reconcile_p50_ms": round(_percentile(durations, 0.50) * 1e3, 3),
        "reconcile_p99_ms": round(_percentile(durations, 0.99) * 1e3, 3),
        "jobs": jobs,
        "workers_per_job": workers,
        "pods": jobs * workers,
        "threadiness": threadiness,
        "chaos_profile": profile_name,
        "chaos_seed": seed,
        "faults_injected": chaos.injector.snapshot(),
        "faults_injected_total": chaos.injector.total,
        "retries_total": int(
            sum(v for _, v in metrics.api_retries.collect())
            - retries_before),
        "degraded_entries": int(
            (sum(v for _, v in metrics.degraded_entries.collect()) or 0.0)
            - degraded_before),
        "crash_restarts": crashes_done,
        "disruptions": disruptions,
        "disruptions_injected": injected[0],
        "barriers_acked": barriers_acked,
        "barriers_timeout": barriers_timeout,
        "total_chips": total_chips,
        "max_admitted_chips": max_admitted[0],
        "elastic": elastic,
        "shrinks_landed": shrinks_landed[0],
        "rl": rl,
        "actors_per_job": actors if rl else 0,
        "actor_kill_storms": storms[0],
        "actor_kills": actor_kills[0],
        "learner_identities_tracked": len(learner_uids),
        "invariant_violations": violations,
    }


# ---------------------------------------------------------------------------
# The campaign (hack/verify-chaos-invariants.py): one seed, one round
# ---------------------------------------------------------------------------

def random_profile(rng: random.Random, seed: int) -> FaultProfile:
    """Every fault class at a non-trivial random rate, bounded so
    convergence stays reachable inside the round's budget."""
    return FaultProfile(
        seed=seed,
        write_error_rate=rng.uniform(0.02, 0.10),
        conflict_rate=rng.uniform(0.02, 0.10),
        read_error_rate=rng.uniform(0.01, 0.05),
        timeout_rate=rng.uniform(0.01, 0.04),
        stale_read_rate=rng.uniform(0.02, 0.08),
        watch_drop_rate=rng.uniform(0.02, 0.08),
        lost_response_rate=rng.uniform(0.0, 0.02),
    )


def run_round(seed: int, timeout: float = 120.0, verbose: bool = False,
              elastic: Optional[bool] = None) -> List[str]:
    """One round; returns its violations ([] = clean). A convergence
    timeout is a violation. ``elastic`` None draws it from the seed,
    last, so the fleet and the profile of a seed do not depend on it."""
    rng = random.Random(seed)
    jobs = rng.randint(3, 6)
    workers = rng.randint(2, 3)
    disruptions = rng.randint(1, 2)
    profile = random_profile(rng, seed)
    threadiness = rng.choice((2, 4))
    if elastic is None:
        elastic = rng.random() < 0.5
    try:
        result = run_chaos_bench(
            jobs=jobs, workers=workers, threadiness=threadiness,
            timeout=timeout, seed=seed, profile=profile,
            disruptions=disruptions, steps=30, save_interval=8,
            barrier_timeout=8.0, crash_restarts=1,
            resync_period=0.25, elastic=elastic)
    except TimeoutError as e:
        return [f"no convergence under profile seed {seed} "
                f"(elastic={elastic}): {e}"]
    if verbose:
        print(f"  seed {seed}: {jobs}x{workers} d{disruptions} "
              f"elastic={elastic} "
              f"faults={result['faults_injected_total']} "
              f"retries={result['retries_total']} "
              f"shrinks={result['shrinks_landed']} "
              f"converged {result['convergence_seconds']}s",
              file=sys.stderr)
    return list(result["invariant_violations"])


def run_shard_round(seed: int, timeout: float = 120.0,
                    verbose: bool = False) -> List[str]:
    """One sharded round: two replicas contend for a drawn number of
    shard leases and a shard holder is killed mid-run without releasing
    its lease. Its own draw stream, so ``run_round``'s seeds keep
    theirs."""
    rng = random.Random(seed)
    jobs = rng.randint(4, 8)
    workers = rng.randint(2, 3)
    shards = rng.choice((2, 3, 4))
    crashes = rng.randint(1, 2)
    profile = random_profile(rng, seed)
    threadiness = rng.choice((2, 4))
    try:
        result = run_sharded_chaos_bench(
            jobs=jobs, workers=workers, shards=shards,
            threadiness=threadiness, timeout=timeout, seed=seed,
            profile=profile, crashes=crashes, resync_period=0.25)
    except TimeoutError as e:
        return [f"no convergence under profile seed {seed} "
                f"(sharded): {e}"]
    if verbose:
        print(f"  seed {seed}: {jobs}x{workers} s{shards} "
              f"crashes={len(result['shard_crashes'])} "
              f"faults={result['faults_injected_total']} "
              f"failovers={result['failover_seconds']} "
              f"converged {result['convergence_seconds']}s",
              file=sys.stderr)
    return (list(result["ownership_violations"])
            + list(result["invariant_violations"]))


def run_rl_round(seed: int, timeout: float = 120.0,
                 verbose: bool = False) -> List[str]:
    """One RL round: every job carries an evict-class actor pool beside
    its learners, one operator crash-restart, and actor kill storms as
    the disruptor. Its own draw stream."""
    rng = random.Random(seed)
    jobs = rng.randint(2, 4)
    workers = rng.randint(2, 3)
    actors = rng.randint(2, 4)
    storms = rng.randint(1, 2)
    profile = random_profile(rng, seed)
    threadiness = rng.choice((2, 4))
    try:
        result = run_chaos_bench(
            jobs=jobs, workers=workers, threadiness=threadiness,
            timeout=timeout, seed=seed, profile=profile,
            disruptions=storms, steps=30, save_interval=8,
            barrier_timeout=8.0, crash_restarts=1,
            resync_period=0.25, elastic=False, rl=True, actors=actors)
    except TimeoutError as e:
        return [f"no convergence under profile seed {seed} (rl): {e}"]
    if verbose:
        print(f"  seed {seed}: {jobs}x{workers}+{actors}a "
              f"storms={result['actor_kill_storms']} "
              f"kills={result['actor_kills']} "
              f"faults={result['faults_injected_total']} "
              f"retries={result['retries_total']} "
              f"converged {result['convergence_seconds']}s",
              file=sys.stderr)
    return list(result["invariant_violations"])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.runtime.chaos_campaign",
        description="Seeded chaos rounds through the port's control "
                    "plane; exit 1 with the repro seed on a violation.")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seed", type=int, default=None,
                   help="base seed (default: random; printed for repro)")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="per-round convergence budget in seconds")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--sharded", action="store_true",
                      help="two replicas contending for N shard leases "
                           "with a mid-run shard-holder kill")
    mode.add_argument("--rl", action="store_true",
                      help="actor pools beside learners, actor kill "
                           "storms as the disruptor")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    base = (args.seed if args.seed is not None
            else random.SystemRandom().randint(0, 2**31))
    if args.sharded:
        round_fn, mode_name, flag = run_shard_round, "sharded ", " --sharded"
    elif args.rl:
        round_fn, mode_name, flag = run_rl_round, "rl ", " --rl"
    else:
        round_fn, mode_name, flag = run_round, "", ""
    print(f"chaos_campaign: {args.rounds} {mode_name}rounds, "
          f"base seed {base}", file=sys.stderr)
    for i in range(args.rounds):
        seed = base + i
        errors = round_fn(seed, timeout=args.timeout, verbose=args.verbose)
        if errors:
            print(f"FAIL (repro: --seed {seed} --rounds 1{flag}):",
                  file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
    if args.sharded:
        print("OK: converged under every fault profile; every sync on "
              "the owning shard, no double-reconcile, every crashed "
              "shard re-acquired, no orphans", file=sys.stderr)
    elif args.rl:
        print("OK: converged under every fault profile; actor kill "
              "storms never restarted a learner or regressed a "
              "committed step, no orphans, no duplicate admissions",
              file=sys.stderr)
    else:
        print("OK: converged under every fault profile; no orphans, no "
              "duplicate admissions, every barrier resolved, no "
              "committed steps lost, elastic floors and budget held",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
