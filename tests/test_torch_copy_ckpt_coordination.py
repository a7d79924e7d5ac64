"""Copy of ``tests/test_ckpt_coordination.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

Checkpoint-coordination tests (controller/ckpt.py).

Unit level drives the CheckpointCoordinator's save-before-evict barrier
directly against the Store (open/stamp, full-gang ack, timeout, partial
ack, restore-step derivation, status roll-in), the CheckpointHook worker
loop against a file checkpointer with an injectable clock, and the
displace/drain gates of gang.py and health.py. The e2e tier runs the
full arc the ISSUE demands: a gang TRAINING under the local operator is
drained mid-epoch off a maintenance node; the drain becomes a
save-then-evict barrier, the rebound pods resume from the barrier step
(restoredFromStep == lastCheckpointStep), and the loss curve continues
where it stopped. A control arc pins that without
--enable-ckpt-coordination the drain path behaves exactly as before
(immediate eviction, restart from step 0, no preemption notice).
"""

import datetime as dt
import json
import os
import sys
import time

import pytest

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import (
    CheckpointPolicy,
    CheckpointRecord,
    CheckpointRecordStatus,
    Container,
    HealthPolicy,
    JobConditionType,
    ObjectMeta,
    Pod,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    RunPolicy,
    SliceGroup,
    SliceGroupSpec,
    SliceGroupStatus,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from tf_operator_tpu_torch.controller.ckpt import (
    CheckpointCoordinator,
    JOB_CKPT_BARRIER_PENDING_REASON,
    JOB_CKPT_BARRIER_SAVED_REASON,
    JOB_CKPT_BARRIER_TIMEOUT_REASON,
    OUTCOME_ACKED,
    OUTCOME_TIMEOUT,
)
from tf_operator_tpu_torch.controller.gang import (
    PHASE_INQUEUE,
    SliceGangScheduler,
)
from tf_operator_tpu_torch.controller.health import SliceHealthController
from tf_operator_tpu_torch.runtime import metrics, store as store_mod
from tf_operator_tpu_torch.runtime.events import (
    REASON_CKPT_BARRIER_REQUESTED,
    REASON_CKPT_BARRIER_SAVED,
    REASON_CKPT_BARRIER_TIMEOUT,
    Recorder,
)
from tf_operator_tpu_torch.runtime.store import Store
from tf_operator_tpu_torch.runtime.worker_stub import FileCheckpointer
from tf_operator_tpu_torch.train.checkpoint import (
    CheckpointConfig,
    CheckpointHook,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "default"


def _now():
    return dt.datetime.now(dt.timezone.utc)


def ckpt_policy(**kw) -> CheckpointPolicy:
    kw.setdefault("enabled", True)
    kw.setdefault("directory", "/tmp/ckpt")
    kw.setdefault("barrier_timeout_seconds", 30.0)
    return CheckpointPolicy(**kw)


def add_job(store, name, policy=None, health=None, workers=1,
            accelerator="h100-8") -> TPUJob:
    job = TPUJob(metadata=ObjectMeta(name=name, namespace=NS))
    job.spec = TPUJobSpec(
        replica_specs={"worker": ReplicaSpec(
            replicas=workers,
            template=PodTemplateSpec(spec=PodSpec(containers=[
                Container(name=constants.DEFAULT_CONTAINER_NAME)])),
            restart_policy=RestartPolicy.NEVER)},
        run_policy=RunPolicy(checkpoint_policy=policy,
                             health_policy=health),
        slice=TPUSliceSpec(accelerator=accelerator))
    return store.create(store_mod.TPUJOBS, job)


def add_pod(store, job_name, index=0, node="", phase="Running") -> Pod:
    pod = Pod(spec=PodSpec(
        containers=[Container(
            resources={constants.RESOURCE_GPU: "8"})],
        scheduler_name=constants.DEFAULT_GANG_SCHEDULER,
        node_name=node))
    pod.metadata.name = f"{job_name}-worker-{index}"
    pod.metadata.namespace = NS
    pod.metadata.labels = {
        constants.LABEL_JOB_NAME: job_name,
        constants.LABEL_REPLICA_TYPE: "worker",
        constants.LABEL_REPLICA_INDEX: str(index),
    }
    pod.metadata.annotations = {
        constants.ANNOTATION_GANG_GROUP: job_name,
        constants.ANNOTATION_GANG_TASK: "worker",
    }
    pod.status.phase = phase
    return store.create(store_mod.PODS, pod)


def add_group(store, name, chips=8, phase=PHASE_INQUEUE) -> SliceGroup:
    group = SliceGroup(
        spec=SliceGroupSpec(min_member=1,
                            slice=TPUSliceSpec(
                                accelerator=f"h100-{chips}")),
        status=SliceGroupStatus(phase=phase, pending_since=_now()))
    group.metadata.name = name
    group.metadata.namespace = NS
    return store.create(store_mod.SLICEGROUPS, group)


def add_record(store, job_name, pod_name, step=-1, progress=-1,
               barrier="", restored=None, save_seconds=0.0
               ) -> CheckpointRecord:
    rec = CheckpointRecord(
        metadata=ObjectMeta(
            name=pod_name, namespace=NS,
            labels={constants.LABEL_JOB_NAME: job_name}),
        status=CheckpointRecordStatus(
            step=step, progress_step=max(progress, step),
            barrier_id=barrier, restored_from_step=restored,
            save_seconds=save_seconds, directory="/tmp/ckpt",
            updated_at=_now()))
    existing = store.try_get(store_mod.CHECKPOINTRECORDS, NS, pod_name)
    if existing is None:
        return store.create(store_mod.CHECKPOINTRECORDS, rec)
    existing.status = rec.status
    return store.update_status(store_mod.CHECKPOINTRECORDS, existing)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


@pytest.fixture
def store():
    return Store()


@pytest.fixture
def recorder():
    return Recorder()


@pytest.fixture
def clock():
    return FakeClock()


@pytest.fixture
def coord(store, recorder, clock):
    return CheckpointCoordinator(store, recorder=recorder, clock=clock)


def notice_of(store, pod_name):
    pod = store.get(store_mod.PODS, NS, pod_name)
    raw = pod.metadata.annotations.get(
        constants.ANNOTATION_PREEMPT_NOTICE, "")
    return json.loads(raw) if raw else None


# ---------------------------------------------------------------------------
# Barrier lifecycle
# ---------------------------------------------------------------------------

class TestBarrier:
    def test_no_policy_is_transparent(self, store, coord):
        add_job(store, "plain")
        add_pod(store, "plain")
        assert coord.ready_to_evict(NS, "plain", "drain") is True
        assert notice_of(store, "plain-worker-0") is None
        assert coord._barriers == {}

    def test_disabled_policy_is_transparent(self, store, coord):
        add_job(store, "off", policy=ckpt_policy(enabled=False))
        add_pod(store, "off")
        assert coord.ready_to_evict(NS, "off", "drain") is True
        assert notice_of(store, "off-worker-0") is None

    def test_barrier_opens_and_stamps_notice(self, store, coord,
                                             recorder):
        add_job(store, "j", policy=ckpt_policy(barrier_timeout_seconds=30))
        add_pod(store, "j", 0)
        add_pod(store, "j", 1)
        assert coord.ready_to_evict(NS, "j", "node degraded") is False
        n0 = notice_of(store, "j-worker-0")
        n1 = notice_of(store, "j-worker-1")
        assert n0 and n1 and n0["barrier"] == n1["barrier"]
        assert n0["reason"] == "node degraded"
        assert n0["deadline"]  # RFC3339 wall deadline for the worker
        assert recorder.events_for("j", REASON_CKPT_BARRIER_REQUESTED)

    def test_full_gang_ack_releases_eviction(self, store, coord,
                                             recorder):
        before = metrics.checkpoint_barriers.value(
            job_namespace=NS, outcome=OUTCOME_ACKED)
        add_job(store, "j", policy=ckpt_policy(), workers=2)
        add_pod(store, "j", 0)
        add_pod(store, "j", 1)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        barrier_id = notice_of(store, "j-worker-0")["barrier"]
        add_record(store, "j", "j-worker-0", step=7, barrier=barrier_id)
        assert coord.ready_to_evict(NS, "j", "drain") is False  # 1/2
        add_record(store, "j", "j-worker-1", step=9, barrier=barrier_id)
        assert coord.ready_to_evict(NS, "j", "drain") is True
        assert metrics.checkpoint_barriers.value(
            job_namespace=NS, outcome=OUTCOME_ACKED) == before + 1
        assert recorder.events_for("j", REASON_CKPT_BARRIER_SAVED)
        # The committed step a rebind restores from is the MIN over the
        # gang (a distributed checkpoint needs every shard on disk).
        assert coord.committed_step(NS, "j") == 7
        coord.release(NS, "j")
        assert coord._barriers == {}

    def test_timeout_releases_eviction(self, store, coord, recorder,
                                       clock):
        add_job(store, "j",
                policy=ckpt_policy(barrier_timeout_seconds=30),
                workers=2)
        add_pod(store, "j", 0)
        add_pod(store, "j", 1)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        clock.advance(29.0)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        clock.advance(2.0)
        assert coord.ready_to_evict(NS, "j", "drain") is True
        assert recorder.events_for("j", REASON_CKPT_BARRIER_TIMEOUT)

    def test_partial_ack_then_timeout_counts_lost_steps(
            self, store, coord, clock):
        add_job(store, "j",
                policy=ckpt_policy(barrier_timeout_seconds=30),
                workers=2)
        add_pod(store, "j", 0)
        add_pod(store, "j", 1)
        # Periodic saves exist: worker-0 saved step 10, worker-1 step 10
        # but reported progress 25 — both must ack the BARRIER to
        # release early.
        add_record(store, "j", "j-worker-0", step=10, progress=25)
        add_record(store, "j", "j-worker-1", step=10, progress=25)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        barrier_id = notice_of(store, "j-worker-0")["barrier"]
        add_record(store, "j", "j-worker-0", step=20, progress=25,
                   barrier=barrier_id)
        assert coord.ready_to_evict(NS, "j", "drain") is False  # 1/2
        clock.advance(31.0)
        assert coord.ready_to_evict(NS, "j", "drain") is True
        # Lost = newest progress (25) - committed (min step = 10).
        key = (NS, "j")
        assert coord._lost_steps[key] == 15
        assert coord._completed[key] == OUTCOME_TIMEOUT

    def test_new_pod_stamped_on_later_pass(self, store, coord):
        add_job(store, "j", policy=ckpt_policy())
        add_pod(store, "j", 0)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        add_pod(store, "j", 1)  # straggler the engine just recreated
        assert coord.ready_to_evict(NS, "j", "drain") is False
        assert notice_of(store, "j-worker-1") is not None

    def test_record_watch_pokes_admission(self, store, coord):
        pokes = []
        coord.on_ack = lambda: pokes.append(1)
        coord.start()
        try:
            add_job(store, "j", policy=ckpt_policy())
            add_pod(store, "j", 0)
            assert coord.ready_to_evict(NS, "j", "drain") is False
            add_record(store, "j", "j-worker-0", step=3, barrier="x")
            deadline = time.monotonic() + 5
            while not pokes and time.monotonic() < deadline:
                time.sleep(0.01)
            assert pokes, "record write inside a barrier must poke"
        finally:
            coord.stop()

    def test_save_seconds_observed_once_per_step(self, store, coord):
        coord.start()
        try:
            add_job(store, "j", policy=ckpt_policy())
            add_record(store, "j", "j-worker-0", step=5,
                       save_seconds=0.25)
            add_record(store, "j", "j-worker-0", step=5,
                       save_seconds=0.25)  # duplicate mirror
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if (NS, "j-worker-0", 5) in coord._seen_saves:
                    break
                time.sleep(0.01)
            assert (NS, "j-worker-0", 5) in coord._seen_saves
        finally:
            coord.stop()


# ---------------------------------------------------------------------------
# Restore-with-identity (bootstrap env + status roll-in)
# ---------------------------------------------------------------------------

class TestRestore:
    def test_bootstrap_env_renders_policy_knobs(self, store, coord):
        job = add_job(store, "j", policy=ckpt_policy(
            directory="/ckpt/j", interval_steps=50,
            interval_seconds=120.0, max_to_keep=5))
        env = coord.bootstrap_env(job)
        assert env[constants.ENV_CKPT_DIR] == "/ckpt/j"
        assert env[constants.ENV_CKPT_INTERVAL_STEPS] == "50"
        assert env[constants.ENV_CKPT_INTERVAL_SECONDS] == "120.0"
        assert env[constants.ENV_CKPT_MAX_TO_KEEP] == "5"
        # No committed checkpoint yet: cold start, no restore step.
        assert constants.ENV_RESTORE_STEP not in env

    def test_bootstrap_env_empty_without_policy(self, store, coord):
        job = add_job(store, "plain")
        assert coord.bootstrap_env(job) == {}

    def test_restore_step_is_min_committed(self, store, coord):
        # Two declared workers: records beyond the job's CURRENT
        # replica set are ignored (elastic shrink hygiene, ckpt.py
        # _record_in_world), so the world must match the records.
        job = add_job(store, "j", policy=ckpt_policy(), workers=2)
        add_record(store, "j", "j-worker-0", step=30)
        add_record(store, "j", "j-worker-1", step=20)
        env = coord.bootstrap_env(job)
        assert env[constants.ENV_RESTORE_STEP] == "20"

    def test_restore_env_outside_bootstrap_hash(self, store, coord):
        """A new committed checkpoint must not restart live pods: the
        restore env is rendered at pod create but excluded from the
        world digest the engine compares."""
        from tf_operator_tpu_torch.controller.gpu_controller import (
            GPUJobController,
        )

        controller = GPUJobController(store, ckpt=coord)
        job = add_job(store, "j", policy=ckpt_policy())
        digest_before = controller._compute_bootstrap_hash(
            job, "worker", 0)
        add_record(store, "j", "j-worker-0", step=40)
        assert controller._compute_bootstrap_hash(
            job, "worker", 0) == digest_before
        pod = Pod(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME)]))
        controller.set_cluster_spec(job, pod, "worker", 0)
        env = pod.spec.containers[0].env
        assert env[constants.ENV_RESTORE_STEP] == "40"
        controller.stop()

    def test_status_roll_in_condition_arc(self, store, coord):
        from tf_operator_tpu_torch.controller import conditions as cond

        job = add_job(store, "j", policy=ckpt_policy())
        add_pod(store, "j", 0)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        coord.sync_job_status(job)
        c = cond.get_condition(job.status,
                               JobConditionType.CHECKPOINT_BARRIER)
        assert c is not None and c.status == "True"
        assert c.reason == JOB_CKPT_BARRIER_PENDING_REASON
        barrier_id = notice_of(store, "j-worker-0")["barrier"]
        add_record(store, "j", "j-worker-0", step=12, progress=14,
                   barrier=barrier_id, restored=None)
        assert coord.ready_to_evict(NS, "j", "drain") is True
        coord.release(NS, "j")
        coord.sync_job_status(job)
        c = cond.get_condition(job.status,
                               JobConditionType.CHECKPOINT_BARRIER)
        assert c.status == "False"
        assert c.reason == JOB_CKPT_BARRIER_SAVED_REASON
        assert job.status.last_checkpoint_step == 12
        # The rebound incarnation reports what it restored from.
        add_record(store, "j", "j-worker-0", step=12, progress=14,
                   restored=12)
        coord.sync_job_status(job)
        assert job.status.restored_from_step == 12

    def test_timeout_reason_on_condition(self, store, coord, clock):
        from tf_operator_tpu_torch.controller import conditions as cond

        job = add_job(store, "j",
                      policy=ckpt_policy(barrier_timeout_seconds=5))
        add_pod(store, "j", 0)
        assert coord.ready_to_evict(NS, "j", "drain") is False
        coord.sync_job_status(job)
        clock.advance(6)
        assert coord.ready_to_evict(NS, "j", "drain") is True
        coord.release(NS, "j")
        coord.sync_job_status(job)
        c = cond.get_condition(job.status,
                               JobConditionType.CHECKPOINT_BARRIER)
        assert c.status == "False"
        assert c.reason == JOB_CKPT_BARRIER_TIMEOUT_REASON


# ---------------------------------------------------------------------------
# Eviction-path gates (gang.displace, health drain)
# ---------------------------------------------------------------------------

class TestEvictionGates:
    def test_displace_defers_until_ack_then_releases(self, store, coord):
        gang = SliceGangScheduler(store, total_chips=None, ckpt=coord)
        add_job(store, "j", policy=ckpt_policy())
        add_group(store, "j", phase=PHASE_INQUEUE)
        add_pod(store, "j", 0)
        assert gang.displace(NS, "j", "quota reclaim") is False
        group = store.get(store_mod.SLICEGROUPS, NS, "j")
        assert group.status.phase == PHASE_INQUEUE  # still admitted
        barrier_id = notice_of(store, "j-worker-0")["barrier"]
        add_record(store, "j", "j-worker-0", step=4, barrier=barrier_id)
        assert gang.displace(NS, "j", "quota reclaim") is True
        group = store.get(store_mod.SLICEGROUPS, NS, "j")
        # The displacement landed (unlimited test capacity means the
        # follow-up _admit may re-admit right away; the marker stays
        # until the gang actually RUNS again).
        assert group.status.displaced_reason == "quota reclaim"
        assert coord._barriers == {}, "displace must release the barrier"

    def test_displace_without_ckpt_is_unchanged(self, store):
        gang = SliceGangScheduler(store, total_chips=None)
        add_job(store, "j", policy=ckpt_policy())
        add_group(store, "j", phase=PHASE_INQUEUE)
        add_pod(store, "j", 0)
        # Coordinator off: displacement is immediate even though the
        # job declares a policy (flag-off = byte-identical eviction).
        assert gang.displace(NS, "j", "reclaim") is True
        assert notice_of(store, "j-worker-0") is None

    def test_health_drain_waits_for_barrier(self, store, coord,
                                            recorder):
        gang = SliceGangScheduler(store, total_chips=None, ckpt=coord)
        health = SliceHealthController(store, client=None, gang=gang,
                                       recorder=recorder, ckpt=coord)
        add_job(store, "j", policy=ckpt_policy(),
                health=HealthPolicy(enabled=True))
        add_group(store, "j", phase=PHASE_INQUEUE)
        add_pod(store, "j", 0, node="n1")
        store.create(store_mod.NODES, _node(
            "n1", conditions={"Ready": "True",
                              "MaintenancePending": "True"}))
        health.health_pass()
        # Barrier in flight: pods survive, notice stamped.
        assert store.try_get(store_mod.PODS, NS, "j-worker-0") is not None
        barrier_id = notice_of(store, "j-worker-0")["barrier"]
        health.health_pass()  # still waiting
        assert store.try_get(store_mod.PODS, NS, "j-worker-0") is not None
        add_record(store, "j", "j-worker-0", step=8, barrier=barrier_id)
        health.health_pass()  # ack landed: drain executes
        assert store.try_get(store_mod.PODS, NS, "j-worker-0") is None
        group = store.get(store_mod.SLICEGROUPS, NS, "j")
        assert group.status.displaced_reason.startswith("node degraded")

    def test_health_drain_without_ckpt_is_immediate(self, store,
                                                    recorder):
        gang = SliceGangScheduler(store, total_chips=None)
        health = SliceHealthController(store, client=None, gang=gang,
                                       recorder=recorder)
        add_job(store, "j", policy=ckpt_policy(),
                health=HealthPolicy(enabled=True))
        add_group(store, "j", phase=PHASE_INQUEUE)
        add_pod(store, "j", 0, node="n1")
        store.create(store_mod.NODES, _node(
            "n1", conditions={"Ready": "True",
                              "MaintenancePending": "True"}))
        health.health_pass()
        assert store.try_get(store_mod.PODS, NS, "j-worker-0") is None


def _node(name, conditions):
    from tf_operator_tpu_torch.api.types import Node, NodeSpec, NodeStatus

    return Node(metadata=ObjectMeta(name=name, namespace=""),
                spec=NodeSpec(chips=8),
                status=NodeStatus(phase="Ready",
                                  conditions=dict(conditions)))


# ---------------------------------------------------------------------------
# CheckpointHook: the worker-process side
# ---------------------------------------------------------------------------

class TestCheckpointHook:
    def _hook(self, tmp_path, clock=None, **cfg):
        cfg.setdefault("directory", str(tmp_path / "ckpt"))
        cfg.setdefault("preempt_file", str(tmp_path / "preempt.json"))
        cfg.setdefault("record_file", str(tmp_path / "record.json"))
        config = CheckpointConfig(**cfg)
        ckpt = FileCheckpointer(config.directory)
        return CheckpointHook(ckpt, config,
                              clock=clock or FakeClock()), config, ckpt

    def _record(self, config):
        with open(config.record_file) as f:
            return json.load(f)

    def test_periodic_interval_steps(self, tmp_path):
        hook, config, ckpt = self._hook(tmp_path, interval_steps=3)
        for step in (1, 2):
            assert hook.after_step(step, {"s": step}) is False
        assert hook.after_step(3, {"s": 3}) is True
        assert ckpt.latest_step() == 3
        assert self._record(config)["step"] == 3

    def test_periodic_interval_seconds(self, tmp_path):
        clock = FakeClock()
        hook, config, ckpt = self._hook(tmp_path, clock=clock,
                                        interval_seconds=60.0)
        assert hook.after_step(1, {}) is False
        clock.advance(61.0)
        assert hook.after_step(2, {}) is True
        assert ckpt.latest_step() == 2

    def test_notice_forces_save_and_acks_once(self, tmp_path):
        hook, config, ckpt = self._hook(tmp_path, interval_steps=1000)
        assert hook.after_step(1, {}) is False
        with open(config.preempt_file, "w") as f:
            json.dump({"barrier": "b-1", "deadline": "soon",
                       "reason": "drain"}, f)
        assert hook.after_step(2, {}) is True  # barrier-forced save
        rec = self._record(config)
        assert rec["step"] == 2 and rec["barrier"] == "b-1"
        # Same notice again: already acked, no re-save every step.
        assert hook.after_step(3, {}) is False

    def test_fresh_barrier_forces_fresh_save(self, tmp_path):
        hook, config, ckpt = self._hook(tmp_path, interval_steps=1000)
        for barrier, step in (("b-1", 1), ("b-2", 5)):
            with open(config.preempt_file, "w") as f:
                json.dump({"barrier": barrier}, f)
            assert hook.after_step(step, {}) is True
            assert self._record(config)["barrier"] == barrier

    def test_restore_step_prefers_controller_env(self, tmp_path):
        hook, config, ckpt = self._hook(tmp_path, restore_step=17)
        ckpt.save(30, {})
        assert hook.restore_step() == 17

    def test_restore_step_falls_back_to_local_latest(self, tmp_path):
        hook, config, ckpt = self._hook(tmp_path)
        assert hook.restore_step() is None
        ckpt.save(12, {})
        assert hook.restore_step() == 12

    def test_note_restored_publishes(self, tmp_path):
        hook, config, ckpt = self._hook(tmp_path)
        hook.note_restored(9)
        rec = self._record(config)
        assert rec["restored_from_step"] == 9
        assert rec["progress_step"] == 9

    def test_failed_save_does_not_publish_commit(self, tmp_path):
        class Exploding:
            def save(self, *a, **k):
                raise OSError("disk full")

            def wait(self):
                pass

            def latest_step(self):
                return None

        config = CheckpointConfig(
            directory=str(tmp_path / "ckpt"), interval_steps=1,
            record_file=str(tmp_path / "record.json"))
        hook = CheckpointHook(Exploding(), config, clock=FakeClock())
        assert hook.after_step(1, {}) is False
        assert not os.path.exists(config.record_file)

    def test_from_env_none_without_policy(self):
        assert CheckpointHook.from_env(environ={}) is None

    def test_config_from_env(self):
        env = {"TPUJOB_CKPT_DIR": "/c", "TPUJOB_CKPT_INTERVAL_STEPS": "7",
               "TPUJOB_CKPT_MAX_TO_KEEP": "2", "TPUJOB_RESTORE_STEP": "4",
               "TPUJOB_PREEMPT_FILE": "/p", "TPUJOB_CKPT_FILE": "/r"}
        config = CheckpointConfig.from_env(env)
        assert (config.directory, config.interval_steps,
                config.max_to_keep, config.restore_step,
                config.preempt_file, config.record_file) == (
            "/c", 7, 2, 4, "/p", "/r")


# ---------------------------------------------------------------------------
# Toleration stamp (binder-predicates first slice)
# ---------------------------------------------------------------------------

class TestTolerationStamp:
    def _spec_pod(self, store, job, rtype="worker"):
        from tf_operator_tpu_torch.controller.gpu_controller import (
            GPUJobController,
        )

        controller = GPUJobController(store)
        pod = Pod(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME)]))
        controller.set_cluster_spec(job, pod, rtype, 0)
        controller.stop()
        return pod

    def test_worker_gets_tpu_toleration(self, store):
        job = add_job(store, "j", accelerator="h100-8")
        pod = self._spec_pod(store, job)
        tols = [t for t in pod.spec.tolerations
                if t.key == constants.RESOURCE_GPU]
        assert len(tols) == 1 and tols[0].operator == "Exists"

    def test_existing_toleration_not_duplicated(self, store):
        from tf_operator_tpu_torch.api.types import Toleration

        job = add_job(store, "j", accelerator="h100-8")
        from tf_operator_tpu_torch.controller.gpu_controller import (
            GPUJobController,
        )

        controller = GPUJobController(store)
        pod = Pod(spec=PodSpec(
            containers=[Container(
                name=constants.DEFAULT_CONTAINER_NAME)],
            tolerations=[Toleration(key=constants.RESOURCE_GPU,
                                    operator="Exists",
                                    effect="NoSchedule")]))
        controller.set_cluster_spec(job, pod, "worker", 0)
        controller.stop()
        assert len([t for t in pod.spec.tolerations
                    if t.key == constants.RESOURCE_GPU]) == 1

    def test_coordinator_types_untouched(self, store):
        job = add_job(store, "j", accelerator="h100-8")
        job.spec.replica_specs["chief"] = ReplicaSpec(
            replicas=1,
            template=PodTemplateSpec(spec=PodSpec(containers=[
                Container(name=constants.DEFAULT_CONTAINER_NAME)])))
        pod = self._spec_pod(store, job, rtype="chief")
        assert pod.spec.tolerations == []


# ---------------------------------------------------------------------------
# E2E: drain-with-checkpoint arc (local operator, real subprocess pods)
# ---------------------------------------------------------------------------

def stub_train_job(name, ckpt_dir, steps=300, workers=2,
                   accelerator="h100-16", ckpt=True):
    def spec():
        return ReplicaSpec(
            replicas=workers,
            restart_policy=RestartPolicy.NEVER,
            template=PodTemplateSpec(spec=PodSpec(containers=[Container(
                name=constants.DEFAULT_CONTAINER_NAME,
                command=[sys.executable, "-m",
                         "tf_operator_tpu_torch.runtime.worker_stub",
                         "--train-steps", str(steps),
                         "--step-seconds", "0.02"],
            )])))

    job = TPUJob(metadata=ObjectMeta(name=name),
                 spec=TPUJobSpec(replica_specs={"worker": spec()}))
    job.spec.slice.accelerator = accelerator
    job.spec.run_policy.clean_pod_policy = "None"
    job.spec.run_policy.health_policy = HealthPolicy(enabled=True)
    if ckpt:
        job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
            enabled=True, directory=ckpt_dir,
            # No periodic cadence: the ONLY save is the barrier's, so
            # lastCheckpointStep == restoredFromStep holds through job
            # completion and the assertion below is race-free.
            interval_steps=100000, barrier_timeout_seconds=20.0)
    return job


def wait_for(predicate, timeout=30.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


@pytest.mark.e2e
class TestDrainWithCheckpointE2E:
    def _operator(self, **kw):
        from tf_operator_tpu_torch.operator import Operator

        op = Operator.local(workdir=REPO_ROOT,
                            enable_gang_scheduling=True,
                            total_chips=16,
                            enable_slice_health=True, **kw)
        op.start(threadiness=2)
        return op

    def _inject_maintenance(self, store, job_name):
        """Bind the job's live pods to a node and degrade it — what a
        GKE maintenance notice under a placed gang looks like to the
        slice-health controller."""
        for pod in store.list(store_mod.PODS,
                              selector={constants.LABEL_JOB_NAME:
                                        job_name}):
            fresh = pod.deepcopy()
            fresh.spec.node_name = "n-maint"
            store.update(store_mod.PODS, fresh)
        store.create(store_mod.NODES, _node(
            "n-maint", conditions={"Ready": "True",
                                   "MaintenancePending": "True"}))

    def test_drain_resumes_from_barrier_step(self, tmp_path):
        """The ISSUE acceptance arc: train, drain mid-epoch, the
        rebound gang resumes from the barrier-saved step with no
        loss-curve reset (restoredFromStep == lastCheckpointStep)."""
        from tf_operator_tpu_torch.sdk import TPUJobClient

        op = self._operator(enable_ckpt_coordination=True)
        try:
            client = TPUJobClient(op.store)
            client.create(stub_train_job("ckptjob",
                                         str(tmp_path / "ckpt")))
            client.wait_for_condition("ckptjob",
                                      JobConditionType.RUNNING,
                                      timeout=30)
            # Mid-epoch: both workers actually stepping.
            wait_for(lambda: all(
                "step 3 " in text for text in
                client.get_job_logs("ckptjob").values()),
                message="workers training")
            self._inject_maintenance(op.store, "ckptjob")
            # Drain (behind the barrier) evicts and recreates the pods;
            # the rebound incarnation logs its restore.
            wait_for(lambda: any(
                "resumed from checkpoint at step" in text
                for text in client.get_job_logs("ckptjob").values()),
                timeout=60, message="rebound worker resumed")
            job = client.wait_for_job("ckptjob", timeout=60)
            assert any(c.type == JobConditionType.SUCCEEDED
                       and c.status == "True"
                       for c in job.status.conditions)
            # Restore-with-identity preserved WORK, not just topology.
            assert job.status.restored_from_step is not None
            assert job.status.restored_from_step > 0
            assert (job.status.restored_from_step
                    == job.status.last_checkpoint_step)
            # The barrier arc resolved on the job's conditions.
            barrier = [c for c in job.status.conditions
                       if c.type == JobConditionType.CHECKPOINT_BARRIER]
            assert barrier and barrier[0].status == "False"
            assert barrier[0].reason == JOB_CKPT_BARRIER_SAVED_REASON
            # No loss-curve reset: the rebound log continues AFTER the
            # restored step; step 1 never reappears.
            restored = job.status.restored_from_step
            logs = client.get_job_logs("ckptjob")
            resumed = [t for t in logs.values()
                       if "resumed from checkpoint at step" in t]
            assert resumed, "rebound pods must log their restore"
            for text in resumed:
                assert "step 1 " not in text
                assert f"step {restored + 1} " in text
            # Goodput accounting observed the disruption.
            assert metrics.job_goodput_ratio.value(
                job_namespace="default", job="ckptjob") > 0.0
        finally:
            op.stop()

    def test_drain_without_flag_restarts_from_scratch(self, tmp_path):
        """Control: --enable-ckpt-coordination off leaves the drain
        path untouched — immediate eviction, no preemption notice, no
        restore env; the job restarts from step 0 (the existing health
        and quota suites pin the deeper byte-identical behavior)."""
        from tf_operator_tpu_torch.sdk import TPUJobClient

        op = self._operator()
        assert op.ckpt is None
        try:
            client = TPUJobClient(op.store)
            client.create(stub_train_job("plainjob",
                                         str(tmp_path / "ckpt"),
                                         steps=150, ckpt=False))
            client.wait_for_condition("plainjob",
                                      JobConditionType.RUNNING,
                                      timeout=30)
            wait_for(lambda: all(
                "step 3 " in text for text in
                client.get_job_logs("plainjob").values()),
                message="workers training")
            self._inject_maintenance(op.store, "plainjob")
            job = client.wait_for_job("plainjob", timeout=60)
            assert any(c.type == JobConditionType.SUCCEEDED
                       and c.status == "True"
                       for c in job.status.conditions)
            assert job.status.restored_from_step is None
            assert job.status.last_checkpoint_step is None
            logs = client.get_job_logs("plainjob")
            # Rebound pods started over (their fresh logs begin at 1)
            # and never saw a preemption notice.
            assert all("resumed from checkpoint" not in t
                       for t in logs.values())
            assert all("step 1 " in t for t in logs.values())
            for pod in op.store.list(
                    store_mod.PODS,
                    selector={constants.LABEL_JOB_NAME: "plainjob"}):
                assert constants.ANNOTATION_PREEMPT_NOTICE \
                    not in pod.metadata.annotations
        finally:
            op.stop()


# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
