"""Controllable worker stub — the e2e fault-injection payload (port of
tf_operator_tpu/runtime/worker_stub.py; it snapshots the GPU bootstrap
env and threads the port's ``CheckpointHook``).

Reference analog: test/test-server/test_app.py, the Flask app run *as*
the TF replicas in e2e so the harness can read each replica's TF_CONFIG
(`/tfconfig`) and make any replica exit with any code (`/exit`). This
stub is file-based instead of HTTP (deterministic, dependency-free):

- at startup it writes its identity + bootstrap env snapshot to
  ``$TPUJOB_STUB_DIR/{pod}.env.json``;
- it polls ``$TPUJOB_STUB_DIR/{pod}.cmd`` for a line ``exit:N`` and exits
  with code N when told;
- ``--exit-after S --exit-code N`` terminates autonomously;
- ``--train-steps N`` switches to the fake-trainer loop: one "optimizer
  step" every ``--step-seconds``, a deterministic decreasing loss line
  per step, and the real coordinated-checkpoint hook
  (``train/checkpoint.py CheckpointHook``) threaded after every step —
  periodic saves, save-before-evict barrier acks, and
  restore-with-identity run exactly as a real training loop would,
  minus the model (checkpoints are tiny JSON files). The e2e payload for the
  controller/ckpt.py drain-with-checkpoint arc.

Run as: ``python -m tf_operator_tpu_torch.runtime.worker_stub [flags]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ENV_KEYS = (
    "TPUJOB_CLUSTER_SPEC",
    "MASTER_ADDR",
    "MASTER_PORT",
    "WORLD_SIZE",
    "RANK",
    "LOCAL_RANK",
    "LOCAL_WORLD_SIZE",
    "TPUJOB_ACCELERATOR_TYPE",
    "TPUJOB_TOPOLOGY",
    "TPUJOB_POD_NAME",
    "TPUJOB_POD_NAMESPACE",
)


class FileCheckpointer:
    """Minimal ``Checkpointer`` surface (save/wait/latest_step) writing
    one JSON file per step — what the fake trainer persists instead of
    model state, so the coordinated-checkpoint protocol is exercised
    end-to-end without a model."""

    def __init__(self, directory: str):
        self.directory = directory

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.json")

    def save(self, step: int, state, force: bool = False) -> bool:
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(step)
        with open(path + ".tmp", "w") as f:
            json.dump({"step": step, "state": state}, f)
        os.replace(path + ".tmp", path)
        return True

    def wait(self) -> None:
        pass  # synchronous writer: durability happened in save()

    def latest_step(self):
        try:
            names = os.listdir(self.directory)
        except OSError:
            return None
        steps = [int(n[len("step_"):-len(".json")]) for n in names
                 if n.startswith("step_") and n.endswith(".json")]
        return max(steps) if steps else None


def _train(train_steps: int, step_seconds: float) -> int:
    """Fake-trainer loop: resume from the controller-committed step,
    then one deterministic step per tick with the checkpoint hook
    threaded exactly like train/trainer.py run_train_steps."""
    from tf_operator_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        CheckpointHook,
    )

    config = CheckpointConfig.from_env()
    hook = None
    step = 0
    if config.directory:
        hook = CheckpointHook(FileCheckpointer(config.directory), config)
        restore = hook.restore_step()
        if restore is not None:
            step = restore
            hook.note_restored(restore)
            print(f"resumed from checkpoint at step {restore}", flush=True)
    while step < train_steps:
        time.sleep(step_seconds)
        step += 1
        # Strictly-decreasing deterministic curve: a resume that forgot
        # its progress would print a loss the curve already passed.
        print(f"step {step} loss {100.0 / step:.4f}", flush=True)
        if hook is not None:
            hook.after_step(step, {"step": step})
    print(f"done: {train_steps} steps", flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exit-after", type=float, default=None,
                        help="exit autonomously after this many seconds")
    parser.add_argument("--exit-code", type=int, default=0)
    parser.add_argument("--poll-interval", type=float, default=0.05)
    parser.add_argument("--train-steps", type=int, default=None,
                        help="run the fake-trainer loop to this TOTAL "
                             "step count (restores count toward it), "
                             "with the coordinated-checkpoint hook "
                             "active when TPUJOB_CKPT_DIR is set")
    parser.add_argument("--step-seconds", type=float, default=0.05,
                        help="(--train-steps) seconds per fake step")
    parser.add_argument("--term-grace", type=float, default=None,
                        help="handle SIGTERM gracefully: keep running "
                             "this many seconds, then write "
                             "{pod}.exited (with a timestamp) and exit "
                             "0 — models a slow-dying worker for "
                             "preemption-overlap tests")
    args = parser.parse_args(argv)

    stub_dir = os.environ.get("TPUJOB_STUB_DIR", "")
    pod_name = os.environ.get("TPUJOB_POD_NAME", f"pid-{os.getpid()}")

    # Install the graceful-term handler BEFORE publishing the env
    # snapshot: tests use the snapshot's existence as "stub fully
    # started", so a SIGTERM arriving after it must always be caught.
    term_at = []
    if args.term_grace is not None:
        import signal

        signal.signal(signal.SIGTERM,
                      lambda *_: term_at.append(time.monotonic()))
    # Identity banner on stdout: exercised by the log-capture path
    # (reference test-server logs requests the same way).
    print(f"worker stub {pod_name} started", flush=True)

    cmd_path = None
    if stub_dir:
        os.makedirs(stub_dir, exist_ok=True)
        snapshot = {k: os.environ[k] for k in ENV_KEYS if k in os.environ}
        snapshot["argv"] = sys.argv[1:]
        # Atomic publish: tests poll for this file and read it the
        # moment it exists; a plain open-write would expose a partial
        # JSON document to that race.
        snap_path = os.path.join(stub_dir, f"{pod_name}.env.json")
        with open(snap_path + ".tmp", "w") as f:
            json.dump(snapshot, f, indent=2, sort_keys=True)
        os.replace(snap_path + ".tmp", snap_path)
        cmd_path = os.path.join(stub_dir, f"{pod_name}.cmd")

    if args.train_steps is not None:
        return _train(args.train_steps, args.step_seconds)

    deadline = (time.monotonic() + args.exit_after
                if args.exit_after is not None else None)
    while True:
        if term_at and time.monotonic() - term_at[0] >= args.term_grace:
            # Slow graceful death complete: publish the exit instant
            # (wall clock — tests compare against other processes).
            if stub_dir:
                path = os.path.join(stub_dir, f"{pod_name}.exited")
                with open(path + ".tmp", "w") as f:
                    json.dump({"exited_at": time.time()}, f)
                os.replace(path + ".tmp", path)
            return 0
        if cmd_path and os.path.exists(cmd_path):
            with open(cmd_path) as f:
                line = f.read().strip()
            # Parse before unlinking: a partially-written file (non-atomic
            # writer) is left in place for the next poll.
            code = None
            if line.startswith("exit:"):
                try:
                    code = int(line.split(":", 1)[1])
                except ValueError:
                    code = None
            if code is not None:
                os.unlink(cmd_path)
                return code
        if deadline is not None and time.monotonic() >= deadline:
            return args.exit_code
        time.sleep(args.poll_interval)


if __name__ == "__main__":
    sys.exit(main())
