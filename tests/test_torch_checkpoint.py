"""Port parity: checkpointing, resume and the coordinated-checkpoint hook.

- Every ``TestCheckpointHook`` scenario of tests/test_ckpt_coordination.py
  runs on the port's hook and on the JAX package's, each over the port's
  ``FileCheckpointer`` and a fake clock: the return values and the
  record files must be identical.
- The port's ``Checkpointer`` and the JAX package's orbax one go through
  the same save / force / interval sequence: same return values,
  ``latest_step``, kept steps and restored values.
- Save at step 3, restore into a fresh trainer and take 2 more steps: bit
  for bit what 5 steps straight give (losses and every parameter), under
  ``adamw`` and under ``default_optimizer``'s warmup schedule.
"""

import concurrent.futures
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tf_operator_tpu.train import checkpoint as jckpt
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.runtime.worker_stub import FileCheckpointer
from tf_operator_tpu_torch.train import checkpoint as tckpt
from tf_operator_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.compute


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


# ---------------------------------------------------------------------------
# CheckpointHook: the scenarios of TestCheckpointHook, on both packages
# ---------------------------------------------------------------------------

class Side:
    """One package's hook over a FileCheckpointer in its own directory.
    ``config.directory`` is the same string on both sides, so the record
    files can be compared byte for byte."""

    def __init__(self, pkg, root, clock=None, checkpointer=None, **cfg):
        os.makedirs(root, exist_ok=True)
        cfg.setdefault("directory", "ckpt")
        cfg.setdefault("preempt_file", os.path.join(root, "preempt.json"))
        cfg.setdefault("record_file", os.path.join(root, "record.json"))
        self.config = pkg.CheckpointConfig(**cfg)
        self.ckpt = checkpointer or FileCheckpointer(
            os.path.join(root, "files"))
        self.clock = clock or FakeClock()
        self.hook = pkg.CheckpointHook(self.ckpt, self.config,
                                       clock=self.clock)

    def notice(self, **notice):
        with open(self.config.preempt_file, "w") as f:
            json.dump(notice, f)

    def record(self):
        path = self.config.record_file
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()


def periodic_interval_steps(side):
    out = [side.hook.after_step(step, {"s": step}) for step in (1, 2, 3)]
    return out + [side.ckpt.latest_step(), side.record()]


def periodic_interval_seconds(side):
    out = [side.hook.after_step(1, {})]
    side.clock.advance(61.0)
    return out + [side.hook.after_step(2, {}), side.ckpt.latest_step(),
                  side.record()]


def notice_forces_save_and_acks_once(side):
    out = [side.hook.after_step(1, {})]
    side.notice(barrier="b-1", deadline="soon", reason="drain")
    out += [side.hook.after_step(2, {}), side.record()]
    return out + [side.hook.after_step(3, {}), side.record()]


def fresh_barrier_forces_fresh_save(side):
    out = []
    for barrier, step in (("b-1", 1), ("b-2", 5)):
        side.notice(barrier=barrier)
        out += [side.hook.after_step(step, {}), side.record()]
    return out


def restore_step_prefers_controller_env(side):
    side.ckpt.save(30, {})
    return [side.hook.restore_step()]


def restore_step_falls_back_to_local_latest(side):
    out = [side.hook.restore_step()]
    side.ckpt.save(12, {})
    return out + [side.hook.restore_step()]


def note_restored_publishes(side):
    side.hook.note_restored(9)
    return [side.record()]


class Exploding:
    def save(self, *a, **k):
        raise OSError("disk full")

    def wait(self):
        pass

    def latest_step(self):
        return None


def failed_save_does_not_publish_commit(side):
    return [side.hook.after_step(1, {}), side.record()]


SCENARIOS = {
    "periodic_interval_steps": (periodic_interval_steps,
                                dict(interval_steps=3)),
    "periodic_interval_seconds": (periodic_interval_seconds,
                                  dict(interval_seconds=60.0)),
    "notice_forces_save_and_acks_once": (notice_forces_save_and_acks_once,
                                         dict(interval_steps=1000)),
    "fresh_barrier_forces_fresh_save": (fresh_barrier_forces_fresh_save,
                                        dict(interval_steps=1000)),
    "restore_step_prefers_controller_env": (
        restore_step_prefers_controller_env, dict(restore_step=17)),
    "restore_step_falls_back_to_local_latest": (
        restore_step_falls_back_to_local_latest, {}),
    "note_restored_publishes": (note_restored_publishes, {}),
    "failed_save_does_not_publish_commit": (
        failed_save_does_not_publish_commit,
        dict(interval_steps=1, preempt_file="",
             checkpointer=Exploding())),
}

# What tests/test_ckpt_coordination.py asserts of each scenario.
EXPECT = {
    "periodic_interval_steps":
        lambda o: o[:4] == [False, False, True, 3]
        and json.loads(o[4])["step"] == 3,
    "periodic_interval_seconds": lambda o: o[:3] == [False, True, 2],
    "notice_forces_save_and_acks_once":
        lambda o: o[1] is True and o[3] is False
        and json.loads(o[2])["step"] == 2
        and json.loads(o[2])["barrier"] == "b-1",
    "fresh_barrier_forces_fresh_save":
        lambda o: o[0] is o[2] is True
        and json.loads(o[1])["barrier"] == "b-1"
        and json.loads(o[3])["barrier"] == "b-2",
    "restore_step_prefers_controller_env": lambda o: o == [17],
    "restore_step_falls_back_to_local_latest": lambda o: o == [None, 12],
    "note_restored_publishes":
        lambda o: json.loads(o[0])["restored_from_step"] == 9
        and json.loads(o[0])["progress_step"] == 9,
    "failed_save_does_not_publish_commit": lambda o: o == [False, None],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hook_scenario_matches_jax(name, tmp_path):
    drive, cfg = SCENARIOS[name]
    got = drive(Side(tckpt, str(tmp_path / "port"), **cfg))
    want = drive(Side(jckpt, str(tmp_path / "jax"), **cfg))
    assert got == want
    assert EXPECT[name](got), got


def test_hook_from_env_and_config_match_jax():
    assert tckpt.CheckpointHook.from_env(environ={}) is None
    env = {"TPUJOB_CKPT_DIR": "/c", "TPUJOB_CKPT_INTERVAL_STEPS": "7",
           "TPUJOB_CKPT_INTERVAL_SECONDS": "2.5",
           "TPUJOB_CKPT_MAX_TO_KEEP": "2", "TPUJOB_RESTORE_STEP": "4",
           "TPUJOB_PREEMPT_FILE": "/p", "TPUJOB_CKPT_FILE": "/r"}
    got = dataclasses.asdict(tckpt.CheckpointConfig.from_env(env))
    assert got == dataclasses.asdict(jckpt.CheckpointConfig.from_env(env))
    assert (got["directory"], got["interval_steps"], got["max_to_keep"],
            got["restore_step"]) == ("/c", 7, 2, 4)


def test_hook_from_env_saves_through_the_port_checkpointer(tmp_path):
    """With no checkpointer given, the hook builds the port's: a barrier
    notice forces a save that is on disk when after_step returns."""
    env = {"TPUJOB_CKPT_DIR": str(tmp_path / "ckpt"),
           "TPUJOB_CKPT_MAX_TO_KEEP": "2",
           "TPUJOB_PREEMPT_FILE": str(tmp_path / "preempt.json"),
           "TPUJOB_CKPT_FILE": str(tmp_path / "record.json")}
    hook = tckpt.CheckpointHook.from_env(environ=env)
    assert isinstance(hook.ckpt, tckpt.Checkpointer)
    assert hook.ckpt.max_to_keep == 2
    with open(env["TPUJOB_PREEMPT_FILE"], "w") as f:
        json.dump({"barrier": "b1"}, f)
    assert hook.after_step(4, {"w": torch.arange(3.0)}) is True
    assert os.path.isdir(tmp_path / "ckpt" / "4")
    with open(env["TPUJOB_CKPT_FILE"]) as f:
        assert json.load(f)["barrier"] == "b1"
    assert hook.restore_step() == 4
    hook.ckpt.close()


# ---------------------------------------------------------------------------
# Checkpointer against the orbax one
# ---------------------------------------------------------------------------

# (step, force): interval 2, keep 2. Off-interval, already-saved, older
# forced and existing-step saves included.
SEQUENCE = [(0, False), (1, False), (2, False), (3, False), (3, True),
            (4, False), (4, True), (2, True), (5, False), (6, False),
            (10, False), (7, True)]


def _drive(ckpt, make_state, directory):
    out = []
    for step, force in SEQUENCE:
        try:
            started = ckpt.save(step, make_state(step), force=force)
        except ValueError:
            started = "exists"
        ckpt.wait()
        out.append((step, force, started, ckpt.latest_step(),
                    sorted(int(n) for n in os.listdir(directory)
                           if n.isdigit())))
    return out


def test_checkpointer_matches_orbax(tmp_path):
    jdir, tdir = str(tmp_path / "orbax"), str(tmp_path / "port")
    jax_ckpt = jckpt.Checkpointer(jdir, max_to_keep=2, save_interval_steps=2)
    port = tckpt.Checkpointer(tdir, max_to_keep=2, save_interval_steps=2)
    want = _drive(jax_ckpt, lambda s: {"w": np.full(4, float(s))}, jdir)
    got = _drive(port, lambda s: {"w": torch.full((4,), float(s))}, tdir)
    assert got == want
    assert want[-1][3:] == (7, [7, 10])
    restored = jax_ckpt.restore(
        {"w": jax.ShapeDtypeStruct((4,), np.float32)})
    target = {"w": torch.zeros(4)}
    assert port.restore(target) is target
    np.testing.assert_array_equal(target["w"].numpy(), restored["w"])
    jax_ckpt.close()
    port.close()
    # A new Checkpointer over the directory sees the committed steps.
    reopened = tckpt.Checkpointer(tdir, max_to_keep=2)
    assert reopened.latest_step() == 10     # orbax also sorts on reopen
    reopened.close()


def test_restore_without_checkpoint_raises(tmp_path):
    ckpt = tckpt.Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        ckpt.restore({"w": torch.zeros(2)})
    ckpt.close()


def test_save_returns_after_the_copy_and_commits_later(tmp_path,
                                                       monkeypatch):
    """save() returns with the state copied (the live tensor may change
    at once); until the write completes, the step is neither named by
    latest_step nor on disk under its own name."""
    release = concurrent.futures.Future()
    real = tckpt.dcp.async_save

    def held(state_dict, checkpoint_id):
        written = real(state_dict, checkpoint_id=checkpoint_id)
        out = concurrent.futures.Future()
        release.add_done_callback(
            lambda _: out.set_result(written.result()))
        return out

    monkeypatch.setattr(tckpt.dcp, "async_save", held)
    directory = tmp_path / "ckpt"
    ckpt = tckpt.Checkpointer(str(directory))
    live = {"w": torch.arange(4.0)}
    assert ckpt.save(5, live) is True
    live["w"].add_(100.0)
    assert ckpt.latest_step() is None
    assert not (directory / "5").exists()
    release.set_result(None)
    ckpt.wait()
    assert ckpt.latest_step() == 5 and (directory / "5").is_dir()
    target = {"w": torch.zeros(4)}
    ckpt.restore(target)
    assert torch.equal(target["w"], torch.arange(4.0))
    ckpt.close()


def test_failed_write_commits_nothing(tmp_path, monkeypatch):
    def failing(state_dict, checkpoint_id):
        out = concurrent.futures.Future()
        out.set_exception(OSError("disk full"))
        return out

    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))
    monkeypatch.setattr(tckpt.dcp, "async_save", failing)
    assert ckpt.save(1, {"w": torch.zeros(1)}) is True
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert ckpt.latest_step() is None
    monkeypatch.undo()
    # The step is due again: nothing was committed.
    assert ckpt.save(1, {"w": torch.zeros(1)}) is True
    ckpt.wait()
    assert ckpt.latest_step() == 1
    ckpt.close()


def test_stale_tmp_directory_is_ignored_and_removed(tmp_path):
    (tmp_path / "ckpt" / "9.tmp").mkdir(parents=True)
    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() is None
    assert not (tmp_path / "ckpt" / "9.tmp").exists()
    ckpt.close()


# ---------------------------------------------------------------------------
# Save -> restore -> continue equals an uninterrupted run
# ---------------------------------------------------------------------------

FIELDS = dict(vocab_size=512, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
              head_dim=16, mlp_dim=128, max_seq_len=64, rope_theta=10000.0,
              remat=False, dtype=torch.float32)


def _trainer(opt_name, seed):
    model = tllama.Llama(tllama.LlamaConfig(**FIELDS), device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    optimizer = (ttr.adamw(3e-3) if opt_name == "adamw" else
                 ttr.default_optimizer(3e-3, warmup_steps=3, total_steps=8))
    return ttr.Trainer(model=model, optimizer=optimizer, device="cpu")


@pytest.mark.parametrize("opt_name", ["adamw", "default"])
def test_restore_then_continue_is_bit_exact(opt_name, tmp_path):
    data = np.random.default_rng(0)
    batches = [{"inputs": data.integers(0, 512, (2, 33))} for _ in range(5)]

    trainer = _trainer(opt_name, seed=0)
    state, step = trainer.init(), trainer.make_train_step()
    straight = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch)
        straight.append(float(metrics["loss"]))
        if i == 2:
            ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))
            assert ckpt.save(state.step, state)
            ckpt.close()
    want = {n: p.detach().clone()
            for n, p in trainer.model.named_parameters()}

    other = _trainer(opt_name, seed=1)
    resumed = other.init()
    assert not resumed.opt_state.state
    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.restore(resumed) is resumed
    assert resumed.step == 3
    assert all(float(s["step"]) == 3.0
               for s in resumed.opt_state.state.values())
    step = other.make_train_step()
    tail = []
    for batch in batches[3:]:
        resumed, metrics = step(resumed, batch)
        tail.append(float(metrics["loss"]))
    assert tail == straight[3:]
    for name, param in other.model.named_parameters():
        assert torch.equal(param, want[name]), name
    ckpt.close()


def test_train_state_dict_holds_step_params_and_moments():
    trainer = _trainer("adamw", seed=0)
    state = trainer.init()
    sd = state.state_dict()     # a fresh optimizer gets its state made
    names = {n for n, _ in trainer.model.named_parameters()}
    assert sd["step"] == 0 and set(sd["model"]) == names
    assert set(sd["optim"]["state"]) == names
    for per_param in sd["optim"]["state"].values():
        assert set(per_param) == {"step", "exp_avg", "exp_avg_sq"}
        assert float(per_param["step"]) == 0.0
        assert not per_param["exp_avg"].any()
    # The zero step made that state and left the parameters as they were;
    # training from it is training from a fresh optimizer.
    other = _trainer("adamw", seed=0)
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, other.model.state_dict()[name]), name
    batch = {"inputs": np.random.default_rng(1).integers(0, 512, (2, 33))}
    trainer.make_train_step()(state, batch)
    other_state = other.init()
    other.make_train_step()(other_state, batch)
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, other.model.state_dict()[name]), name
