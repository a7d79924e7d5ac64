"""The port's checkpoint coordination against the JAX package's.

Scenarios run once per package on one fake clock (``World`` and the
``clock`` fixture of ``tests/test_torch_operator_gang.py``), mirroring
``tests/test_ckpt_coordination.py``: the save-before-evict barrier
(notices stamped on every live pod, the full-gang ack, the timeout and
its lost steps), the restore env a recreated pod gets (byte-equal, and
rendered into the pod by each package's controller), the eviction gates
of a displacement and of a slice-health drain, and the status roll-in
onto the job. The port's ``worker_stub`` — its ``FileCheckpointer`` and
its fake trainer threading the port's ``CheckpointHook`` — gives the
JAX stub's files, records and log lines, in process and as the pods'
command.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_operator_gang import JAX, NS, PORT, FakeClock, both, clock

pytestmark = pytest.mark.control_plane

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ = clock  # the shared fake-clock fixture


def policy(w, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("directory", "/tmp/ckpt")
    kw.setdefault("barrier_timeout_seconds", 30.0)
    return w.p.types.CheckpointPolicy(**kw)


def coordinator(w):
    w.coord = w.p.ckpt.CheckpointCoordinator(w.store, recorder=w.recorder,
                                             clock=w.clock)
    return w.coord


def record(w, job, pod, step=-1, progress=-1, barrier="", restored=None):
    t = w.p.types
    rec = t.CheckpointRecord(
        metadata=t.ObjectMeta(name=pod, namespace=NS,
                              labels={w.p.const.LABEL_JOB_NAME: job}),
        status=t.CheckpointRecordStatus(
            step=step, progress_step=max(progress, step), barrier_id=barrier,
            restored_from_step=restored, directory="/tmp/ckpt",
            updated_at=w.clock.wall()))
    existing = w.store.try_get(w.sm.CHECKPOINTRECORDS, NS, pod)
    if existing is None:
        return w.store.create(w.sm.CHECKPOINTRECORDS, rec)
    existing.status = rec.status
    return w.store.update_status(w.sm.CHECKPOINTRECORDS, existing)


def notices(w):
    """Every pod's preemption notice, barrier ids replaced by the order
    in which they first appear (ids are random)."""
    out = {}
    for pod in sorted(w.store.list(w.sm.PODS),
                      key=lambda p: p.metadata.name):
        raw = pod.metadata.annotations.get(
            w.p.const.ANNOTATION_PREEMPT_NOTICE, "")
        out[pod.metadata.name] = json.loads(raw) if raw else None
    ids = []
    for notice in out.values():
        if notice and notice["barrier"] not in ids:
            ids.append(notice["barrier"])
    for notice in out.values():
        if notice:
            notice["barrier"] = f"barrier-{ids.index(notice['barrier'])}"
    w.barrier_ids = ids
    return out


def barrier_of(w, pod):
    raw = w.store.get(w.sm.PODS, NS, pod).metadata.annotations[
        w.p.const.ANNOTATION_PREEMPT_NOTICE]
    return json.loads(raw)["barrier"]


def outcome_count(w, outcome):
    return w.p.metrics.checkpoint_barriers.value(job_namespace=NS,
                                                 outcome=outcome)


# ---------------------------------------------------------------------------
# The barrier
# ---------------------------------------------------------------------------

def barrier_ack(w):
    c = coordinator(w)
    before = outcome_count(w, "acked")
    w.job("j", workers=2, ckpt=policy(w))
    w.pod("j", 0)
    w.pod("j", 1)
    steps = [c.ready_to_evict(NS, "j", "node degraded")]
    w.trace.append({"notices": notices(w)})
    record(w, "j", "j-worker-0", step=7, barrier=barrier_of(w, "j-worker-0"))
    steps.append(c.ready_to_evict(NS, "j", "node degraded"))
    record(w, "j", "j-worker-1", step=9, barrier=barrier_of(w, "j-worker-0"))
    steps.append(c.ready_to_evict(NS, "j", "node degraded"))
    w.trace.append({"ready": steps, "committed": c.committed_step(NS, "j"),
                    "acked": outcome_count(w, "acked") - before})
    c.release(NS, "j")
    w.trace.append({"barriers": len(c._barriers)})
    w.snap()


def barrier_timeout(w):
    c = coordinator(w)
    before = outcome_count(w, "timeout")
    w.job("j", workers=2, ckpt=policy(w))
    w.pod("j", 0)
    w.pod("j", 1)
    record(w, "j", "j-worker-0", step=10, progress=25)
    record(w, "j", "j-worker-1", step=10, progress=25)
    steps = [c.ready_to_evict(NS, "j", "drain")]
    record(w, "j", "j-worker-0", step=20, progress=25,
           barrier=barrier_of(w, "j-worker-0"))
    steps.append(c.ready_to_evict(NS, "j", "drain"))
    w.clock.advance(29.0)
    steps.append(c.ready_to_evict(NS, "j", "drain"))
    w.clock.advance(2.0)
    steps.append(c.ready_to_evict(NS, "j", "drain"))
    w.trace.append({"ready": steps, "lost": dict(c._lost_steps),
                    "completed": dict(c._completed),
                    "timeouts": outcome_count(w, "timeout") - before,
                    "goodput": w.p.metrics.job_goodput_ratio.value(
                        job_namespace=NS, job="j")})
    w.snap()


def barrier_transparent_and_straggler(w):
    c = coordinator(w)
    w.job("plain")
    w.pod("plain")
    w.job("off", ckpt=policy(w, enabled=False))
    w.pod("off")
    w.job("j", ckpt=policy(w))
    w.pod("j", 0)
    steps = [c.ready_to_evict(NS, n, "drain") for n in ("plain", "off", "j")]
    w.pod("j", 1)  # the engine recreated a straggler
    steps.append(c.ready_to_evict(NS, "j", "drain"))
    w.trace.append({"ready": steps, "notices": notices(w)})
    w.snap()


BARRIER_SCENARIOS = {
    "ack": barrier_ack,
    "timeout": barrier_timeout,
    "transparent-and-straggler": barrier_transparent_and_straggler,
}


@pytest.mark.parametrize("name", sorted(BARRIER_SCENARIOS))
def test_barrier_matches_jax(name, clock):
    jw, tw = both(BARRIER_SCENARIOS[name], clock)
    assert tw.trace == jw.trace
    t = jw.trace
    if name == "ack":
        assert t[0]["notices"]["j-worker-0"] == {
            "barrier": "barrier-0", "reason": "node degraded",
            "deadline": t[0]["notices"]["j-worker-1"]["deadline"]}
        assert t[1] == {"ready": [False, False, True], "committed": 7,
                        "acked": 1}
        assert [r for _, r in t[3]["events"]] == [
            "CheckpointBarrierRequested", "CheckpointBarrierSaved"]
    if name == "timeout":
        assert t[0]["ready"] == [False, False, False, True]
        assert t[0]["lost"] == {(NS, "j"): 15}
        assert t[0]["completed"] == {(NS, "j"): "timeout"}
        assert t[0]["timeouts"] == 1 and t[0]["goodput"] == 0.4
    if name == "transparent-and-straggler":
        assert t[0]["ready"] == [True, True, False, False]
        assert t[0]["notices"]["j-worker-1"] is not None
        assert t[0]["notices"]["plain-worker-0"] is None


# ---------------------------------------------------------------------------
# Restore-with-identity: the restore env and the status roll-in
# ---------------------------------------------------------------------------

CKPT_ENV_PREFIXES = ("TPUJOB_CKPT_", "TPUJOB_RESTORE_", "TPUJOB_PREEMPT_")


def restore_env(w):
    c = coordinator(w)
    jobs = {
        "plain": w.job("plain"),
        "knobs": w.job("knobs", ckpt=policy(
            w, directory="/ckpt/knobs", interval_steps=50,
            interval_seconds=120.0, max_to_keep=5)),
        "restored": w.job("restored", workers=2, ckpt=policy(w)),
        "shrunk": w.job("shrunk", workers=1, ckpt=policy(w)),
    }
    record(w, "restored", "restored-worker-0", step=30)
    record(w, "restored", "restored-worker-1", step=20)
    record(w, "shrunk", "shrunk-worker-0", step=12)
    record(w, "shrunk", "shrunk-worker-1", step=3)  # outside the world
    envs = {n: json.dumps(c.bootstrap_env(j), sort_keys=True)
            for n, j in jobs.items()}
    controller = w.p.controller_cls(w.store, ckpt=c)
    try:
        t = w.p.types
        rendered = {}
        for n, j in jobs.items():
            pod = t.Pod(spec=t.PodSpec(containers=[t.Container(
                name=w.p.const.DEFAULT_CONTAINER_NAME)]))
            controller.set_cluster_spec(j, pod, "worker", 0)
            env = pod.spec.containers[0].env
            rendered[n] = json.dumps(
                {k: v for k, v in env.items()
                 if k.startswith(CKPT_ENV_PREFIXES)}, sort_keys=True)
        digest = controller._compute_bootstrap_hash(jobs["restored"],
                                                    "worker", 0)
        record(w, "restored", "restored-worker-1", step=25)
        same = digest == controller._compute_bootstrap_hash(
            jobs["restored"], "worker", 0)
    finally:
        controller.stop()
    w.trace.append({"env": envs, "rendered": rendered,
                    "hash_kept": same})


def status_roll_in(w):
    c = coordinator(w)
    cond = w.p.conditions
    job = w.job("j", ckpt=policy(w, barrier_timeout_seconds=5))
    w.pod("j", 0)
    arc = []

    def look():
        c.sync_job_status(job)
        got = cond.get_condition(job.status, "CheckpointBarrier")
        arc.append((got and (got.status, got.reason),
                    job.status.last_checkpoint_step,
                    job.status.restored_from_step))

    c.ready_to_evict(NS, "j", "drain")
    look()
    record(w, "j", "j-worker-0", step=12, progress=14,
           barrier=barrier_of(w, "j-worker-0"))
    c.ready_to_evict(NS, "j", "drain")
    c.release(NS, "j")
    look()
    record(w, "j", "j-worker-0", step=12, progress=14, restored=12)
    look()
    # A second disruption that times out.
    w.store.delete(w.sm.PODS, NS, "j-worker-0")
    w.pod("j", 0)
    c.ready_to_evict(NS, "j", "drain")
    look()
    w.clock.advance(6)
    c.ready_to_evict(NS, "j", "drain")
    c.release(NS, "j")
    look()
    w.trace.append({"arc": arc})
    w.snap()


@pytest.mark.parametrize("name", ["restore-env", "status-roll-in"])
def test_restore_matches_jax(name, clock):
    scenario = {"restore-env": restore_env,
                "status-roll-in": status_roll_in}[name]
    jw, tw = both(scenario, clock)
    assert tw.trace == jw.trace
    t = jw.trace[0]
    if name == "restore-env":
        env = {n: json.loads(e) for n, e in t["env"].items()}
        assert env["plain"] == {}
        assert env["knobs"] == {
            "TPUJOB_CKPT_DIR": "/ckpt/knobs", "TPUJOB_CKPT_MAX_TO_KEEP": "5",
            "TPUJOB_CKPT_INTERVAL_STEPS": "50",
            "TPUJOB_CKPT_INTERVAL_SECONDS": "120.0"}
        assert env["restored"]["TPUJOB_RESTORE_STEP"] == "20"
        assert env["shrunk"]["TPUJOB_RESTORE_STEP"] == "12"
        assert json.loads(t["rendered"]["restored"])[
            "TPUJOB_RESTORE_STEP"] == "20"
        assert t["hash_kept"] is True
    else:
        assert t["arc"] == [
            (("True", "CheckpointBarrierPending"), None, None),
            (("False", "CheckpointBarrierSaved"), 12, None),
            (("False", "CheckpointBarrierSaved"), 12, 12),
            (("True", "CheckpointBarrierPending"), 12, 12),
            (("False", "CheckpointBarrierTimeout"), 12, 12)]


# ---------------------------------------------------------------------------
# Eviction gates: displacement and health drains wait for the barrier
# ---------------------------------------------------------------------------

def displace_gate(w):
    c = coordinator(w)
    gang = w.scheduler(total_chips=None, ckpt=c)
    w.job("j", ckpt=policy(w))
    w.group("j", phase="Inqueue")
    w.pod("j", 0)
    steps = [gang.displace(NS, "j", "quota reclaim")]
    w.snap("held")
    record(w, "j", "j-worker-0", step=4, barrier=barrier_of(w, "j-worker-0"))
    steps.append(gang.displace(NS, "j", "quota reclaim"))
    w.snap("released")
    w.trace.append({"displace": steps, "barriers": len(c._barriers)})


def displace_without_coordinator(w):
    gang = w.scheduler(total_chips=None)
    w.job("j", ckpt=policy(w))
    w.group("j", phase="Inqueue")
    w.pod("j", 0)
    w.trace.append({"displace": gang.displace(NS, "j", "reclaim")})
    w.snap()


def health_drain_gate(w):
    c = coordinator(w)
    gang = w.scheduler(total_chips=None, ckpt=c)
    health = w.p.health.SliceHealthController(
        w.store, client=None, gang=gang, recorder=w.recorder, ckpt=c)
    w.job("j", ckpt=policy(w), health=w.p.types.HealthPolicy(enabled=True))
    w.group("j", phase="Inqueue")
    w.pod("j", 0, node="n1")
    w.node("n1", conditions={"Ready": "True", "MaintenancePending": "True"})
    health.health_pass()
    w.snap("barrier open")
    health.health_pass()
    w.snap("still waiting")
    record(w, "j", "j-worker-0", step=8, barrier=barrier_of(w, "j-worker-0"))
    health.health_pass()
    w.snap("drained")


GATE_SCENARIOS = {
    "displace": displace_gate,
    "displace-without-coordinator": displace_without_coordinator,
    "health-drain": health_drain_gate,
}


@pytest.mark.parametrize("name", sorted(GATE_SCENARIOS))
def test_eviction_gates_match_jax(name, clock):
    jw, tw = both(GATE_SCENARIOS[name], clock)
    assert tw.trace == jw.trace
    t = jw.trace
    if name == "displace":
        assert t[0]["groups"][0][1] == "Inqueue"
        assert t[1]["groups"][0][2] == "quota reclaim"
        assert t[2] == {"displace": [False, True], "barriers": 0}
    if name == "displace-without-coordinator":
        assert t[0] == {"displace": True}
        assert t[1]["pods"] == [("j-worker-0", "", "Running", False)]
    if name == "health-drain":
        assert t[0]["pods"] == [("j-worker-0", "n1", "Running", True)]
        assert len(t[1]["pods"]) == 1 and t[2]["pods"] == []
        assert t[2]["groups"][0][2].startswith("node degraded")


# ---------------------------------------------------------------------------
# The worker side: FileCheckpointer and the fake trainer's hook
# ---------------------------------------------------------------------------

def published(path):
    """A record file as the data plane reads it, less the measured save
    time."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    rec.pop("save_seconds")
    return rec


def hook_run(pkg, root, clock, steps, notices_at=(), restore=None, **cfg):
    """Drive ``pkg``'s CheckpointHook over ``pkg``'s FileCheckpointer
    for ``steps``, writing a notice before the listed steps; return
    what each step returned and each record published."""
    ckpt_mod = pkg.checkpoint
    config = ckpt_mod.CheckpointConfig(
        directory=os.path.join(root, "ckpt"),
        preempt_file=os.path.join(root, "preempt.json"),
        record_file=os.path.join(root, "record.json"),
        restore_step=restore, **cfg)
    files = pkg.worker_stub.FileCheckpointer(config.directory)
    hook = ckpt_mod.CheckpointHook(files, config, clock=clock)
    out = []
    for step in steps:
        if step in dict(notices_at):
            with open(config.preempt_file, "w") as f:
                json.dump({"barrier": dict(notices_at)[step],
                           "reason": "drain"}, f)
        saved = hook.after_step(step, {"step": step})
        out.append((step, saved, published(config.record_file)))
        clock.advance(10.0)
    return {"steps": out, "restore_step": hook.restore_step(),
            "latest": files.latest_step(),
            "files": sorted(os.listdir(config.directory))
            if os.path.isdir(config.directory) else []}


HOOK_CASES = {
    "interval-steps": dict(steps=range(1, 8), interval_steps=3),
    "interval-seconds": dict(steps=range(1, 8), interval_seconds=25.0),
    "notice-acks-once": dict(steps=range(1, 6), interval_steps=1000,
                             notices_at=((2, "b-1"), (4, "b-2"))),
    "restore-prefers-env": dict(steps=(1,), restore=17, interval_steps=1),
}


@pytest.mark.parametrize("name", sorted(HOOK_CASES))
def test_checkpoint_hook_over_file_checkpointer_matches_jax(name, tmp_path):
    runs = []
    for pkg in (JAX, PORT):
        root = tmp_path / "run"
        root.mkdir()
        runs.append(hook_run(pkg, str(root), FakeClock(), **HOOK_CASES[name]))
        root.rename(tmp_path / ("port" if pkg.port else "jax"))
    assert runs[1] == runs[0]
    got = runs[0]
    if name == "interval-steps":
        assert [s for s, saved, _ in got["steps"] if saved] == [3, 6]
    if name == "notice-acks-once":
        assert [(s, rec["barrier"]) for s, saved, rec in got["steps"]
                if saved] == [(2, "b-1"), (4, "b-2")]
    if name == "restore-prefers-env":
        assert got["restore_step"] == 17


def stub(pkg, root, *args, env=None):
    root = str(root)
    full = dict(os.environ, PYTHONPATH=REPO_ROOT, TPUJOB_STUB_DIR=root,
                TPUJOB_POD_NAME="j-worker-0",
                TPUJOB_CKPT_DIR=os.path.join(root, "ckpt"),
                TPUJOB_CKPT_FILE=os.path.join(root, "record.json"),
                TPUJOB_PREEMPT_FILE=os.path.join(root, "preempt.json"),
                TPUJOB_CKPT_INTERVAL_STEPS="4", **(env or {}))
    module = ("tf_operator_tpu_torch" if pkg.port
              else "tf_operator_tpu") + ".runtime.worker_stub"
    proc = subprocess.run([sys.executable, "-m", module, *args], env=full,
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=60)
    with open(os.path.join(root, "j-worker-0.env.json")) as f:
        snapshot = json.load(f)
    ckpt = os.path.join(root, "ckpt")
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    return (proc.returncode, proc.stdout,
            published(os.path.join(root, "record.json")), files, snapshot)


def test_worker_stub_trains_saves_and_resumes_as_jax_stub(tmp_path):
    """The fake trainer as a pod runs it: 6 steps with a save every 4,
    then a new incarnation restores from the controller's step and runs
    on to 10; the port's stub writes the JAX stub's files and lines."""
    runs = []
    for pkg in (JAX, PORT):
        root = tmp_path / "run"
        first = stub(pkg, root, "--train-steps", "6", "--step-seconds", "0")
        second = stub(pkg, root, "--train-steps", "10", "--step-seconds",
                      "0", env={"TPUJOB_RESTORE_STEP": "4"})
        runs.append((first[:4], second[:4], first[4]["argv"]))
        root.rename(tmp_path / ("port" if pkg.port else "jax"))
    assert runs[1] == runs[0]
    (rc1, out1, rec1, files1), (rc2, out2, rec2, files2), _ = runs[0]
    assert (rc1, rc2) == (0, 0)
    assert "step 6 loss" in out1 and "done: 6 steps" in out1
    assert out2.splitlines()[1] == "resumed from checkpoint at step 4"
    assert "step 5 loss 20.0000" in out2 and "step 1 " not in out2
    assert files2 == ["step_00000004.json", "step_00000008.json"]
    assert rec2["restored_from_step"] == 4 and rec2["step"] == 8


def test_worker_stub_snapshots_the_gpu_env(tmp_path):
    """The env snapshot holds the port's bootstrap keys, as the JAX
    stub's holds the TPU ones."""
    env = {"TPUJOB_CLUSTER_SPEC": "{}", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "8476", "WORLD_SIZE": "2", "RANK": "1",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "TPUJOB_ACCELERATOR_TYPE": "h100-8", "TPUJOB_TOPOLOGY": "8",
           "TPUJOB_POD_NAMESPACE": NS, "JAX_PROCESS_ID": "1"}
    *_, snapshot = stub(PORT, tmp_path, "--train-steps", "1",
                        "--step-seconds", "0", env=env)
    del env["JAX_PROCESS_ID"]
    env["TPUJOB_POD_NAME"] = "j-worker-0"
    assert snapshot == dict(env, argv=["--train-steps", "1",
                                       "--step-seconds", "0"])
    assert set(PORT.worker_stub.ENV_KEYS) == set(env)
