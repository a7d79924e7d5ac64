"""Checkpoint/resume over torch.distributed.checkpoint (async) + the
coordinated-checkpoint worker hook (port of train/checkpoint.py).

``Checkpointer`` keeps the surface of the JAX package's orbax manager:
``save(step, state, force)`` decides as orbax's ``CheckpointManager`` does
(a step on the ``save_interval_steps`` interval and past the last one
saved, or the first save; ``force`` skips the interval), ``restore``,
``latest_step``, ``wait``, ``close``, and only the newest ``max_to_keep``
steps stay on disk. A save runs in two halves, as orbax's async save does:

- ``save()`` copies the state off the card into host memory
  (``torch.distributed.checkpoint.async_save`` stages it) and returns, so
  the step that follows may update the live tensors in place;
- a background thread writes the staged copy into ``<step>.tmp`` and
  renames it to ``<step>`` once every file is written; ``wait()`` returns
  when that rename is done. ``latest_step`` names committed steps only.

With no process group a single process writes the whole checkpoint.
Under ``torch.distributed`` (``parallel/distributed.py``) every rank makes
the same calls: each writes the shards it holds (DTensor parameters and
optimizer state of a sharded ``TrainState``) into the same ``<step>.tmp``
and rank 0 the metadata, and the commit is rank 0's rename after a
barrier, followed by a second barrier so that no rank reports a step
before it is committed. The checkpoint's collectives run on a gloo group
of their own, made when the ``Checkpointer`` is (every rank constructs
one), so the commit thread never shares a communicator with the training
step. A restore loads into any layout: the shards of another mesh, or
whole tensors with no mesh at all.

``CheckpointHook`` and ``CheckpointConfig`` are copied from the JAX
package unchanged (same env keys, record payload, barrier and cadence
logic): the hook is the data-plane end of the control plane's
CheckpointCoordinator (controller/ckpt.py). It runs the policy's periodic
save cadence, polls the preemption-notice file the node's data plane
writes when a planned disruption opens a save-before-evict barrier,
forces the final ``save(force=True)`` on a notice, and publishes every
save / barrier ack / restore through the checkpoint state file the data
plane mirrors into this pod's ``CheckpointRecord``. All file I/O is
env-configured (``TPUJOB_PREEMPT_FILE`` / ``TPUJOB_CKPT_FILE`` /
``TPUJOB_CKPT_*`` / ``TPUJOB_RESTORE_STEP``), so a training script needs
exactly two calls: ``CheckpointHook.from_env`` at startup and
``hook.after_step(step, state)`` in the loop.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

log = logging.getLogger("tpu_operator.checkpoint")

_TMP_SUFFIX = ".tmp"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Async checkpoints of a ``TrainState`` (or any ``state_dict``/
    ``load_state_dict`` object, or a dict of tensors) under
    ``directory/<step>`` (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        # Collective: every rank of a process group makes its Checkpointer.
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized() else None)
        self._rank = dist.get_rank() if self._group is not None else 0
        os.makedirs(directory, exist_ok=True)
        # A .tmp directory is a write that never committed (its process
        # died): nothing reads it.
        if self._rank == 0:
            for name in os.listdir(directory):
                if name.endswith(_TMP_SUFFIX):
                    shutil.rmtree(os.path.join(directory, name))
        self._barrier()
        self._lock = threading.Lock()
        # Committed steps in the order they were saved (orbax keeps this
        # order in-process and sorts by step when it reopens a directory).
        self._steps: List[int] = sorted(
            int(n) for n in os.listdir(directory) if n.isdigit())
        # The step of the last save started, committed or not: what
        # orbax's save decision compares against.
        self._last_started: Optional[int] = self.latest_step()
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint-commit")
        self._pending: Optional[concurrent.futures.Future] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _group_kwargs(self) -> Dict[str, Any]:
        return {} if self._group is None else {"process_group": self._group}

    def _due(self, step: int) -> bool:
        last = self._last_started
        return last is None or (step > last
                                and step % self.save_interval_steps == 0)

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Async save; returns whether a save was started. Returns once
        the state has been copied to host memory (the write goes on in
        the background; ``wait()`` for it)."""
        if not force and not self._due(step):
            return False
        self.wait()     # one save in flight at a time, as orbax
        with self._lock:
            if step in self._steps:
                raise ValueError(f"checkpoint for step {step} already exists")
        tmp = self._path(step) + _TMP_SUFFIX
        if self._rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._barrier()
        written = dcp.async_save({"state": state}, checkpoint_id=tmp,
                                 **self._group_kwargs())
        if torch.cuda.is_initialized():
            # The staged copy must be complete before the caller's next
            # step updates the tensors it was copied from.
            torch.cuda.synchronize()
        self._last_started = step
        self._pending = self._writer.submit(self._commit, step, tmp, written)
        return True

    def _commit(self, step: int, tmp: str,
                written: concurrent.futures.Future) -> None:
        if self._group is None:
            written.result()
        else:
            # Every rank's shards are written, or every rank raises (a
            # rank whose write failed must not leave the others waiting).
            error = None
            try:
                written.result()
            except Exception as err:
                error = err
            failed = torch.tensor([int(error is not None)])
            dist.all_reduce(failed, group=self._group)
            if error is not None:
                raise error
            if failed.item():
                raise RuntimeError(f"checkpoint step {step}: another "
                                   f"rank's write failed")
        if self._rank == 0:
            os.rename(tmp, self._path(step))
            _fsync_dir(self.directory)
        self._barrier()         # the step is committed
        with self._lock:
            self._steps.append(step)
            drop = self._steps[:-self.max_to_keep]
            del self._steps[:-self.max_to_keep]
        if self._rank == 0:
            for old in drop:
                shutil.rmtree(self._path(old), ignore_errors=True)

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default: the latest) in place into ``target``, a
        ``TrainState`` (its tensors keep their device and layout: a
        sharded state reads its own shards, whatever mesh saved them) or a
        dict of tensors, and return it. The target is best
        ``Trainer.abstract_state()`` (or ``LlamaPipelineTrainer``'s), the
        JAX package's ``abstract_state_with_shardings``: allocated in its
        layout with nothing drawn, and steppable once loaded here; a state
        from ``init()`` also works, at the cost of its draws."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        loaded = {"state": target}
        dcp.load(loaded, checkpoint_id=self._path(step),
                 **self._group_kwargs())
        return loaded["state"]

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return self._steps[-1] if self._steps else None

    def wait(self) -> None:
        """Block until the save in flight (if any) is committed; raise its
        error if it failed."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        try:
            pending.result()
        except BaseException:
            self._last_started = self.latest_step()
            raise

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Coordinated checkpointing: the worker-process side of controller/ckpt.py
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointConfig:
    """Worker-side view of the job's CheckpointPolicy, rendered into pod
    env by the controller (api/constants.py ENV_CKPT_*)."""

    directory: str = ""
    interval_steps: Optional[int] = None
    interval_seconds: Optional[float] = None
    max_to_keep: int = 3
    restore_step: Optional[int] = None
    preempt_file: str = ""
    record_file: str = ""
    # Publish a progress-only record update at most this often (steps
    # reached between saves — the steps-lost-per-disruption numerator
    # when a barrier times out).
    progress_interval_seconds: float = 10.0

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None
                 ) -> "CheckpointConfig":
        env = os.environ if environ is None else environ

        def _opt(key, cast):
            raw = env.get(key, "")
            return cast(raw) if raw else None

        return cls(
            directory=env.get("TPUJOB_CKPT_DIR", ""),
            interval_steps=_opt("TPUJOB_CKPT_INTERVAL_STEPS", int),
            interval_seconds=_opt("TPUJOB_CKPT_INTERVAL_SECONDS", float),
            max_to_keep=int(env.get("TPUJOB_CKPT_MAX_TO_KEEP", "3") or 3),
            restore_step=_opt("TPUJOB_RESTORE_STEP", int),
            preempt_file=env.get("TPUJOB_PREEMPT_FILE", ""),
            record_file=env.get("TPUJOB_CKPT_FILE", ""),
        )


class CheckpointHook:
    """Coordinated-checkpoint loop hook (module docstring). Call
    ``after_step(step, state)`` after every optimizer step:

    - periodic cadence (interval_steps / interval_seconds) saves and
      publishes the committed step;
    - a preemption notice (save-before-evict barrier) forces a final
      save, WAITS for durability, and publishes the barrier ack — the
      coordinator releases the eviction on full-gang ack;
    - between saves, cheap progress-only publishes keep the control
      plane's steps-lost accounting honest.

    ``checkpointer`` is anything with the ``Checkpointer`` surface
    (save/wait/latest_step) — the torch.distributed.checkpoint one in
    production, a trivial file writer in hermetic tests. Saves initiated
    by the hook are followed by ``wait()`` before the step is published as
    committed: a step the control plane restores from must actually be on
    disk.
    """

    def __init__(self, checkpointer, config: CheckpointConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.ckpt = checkpointer
        self.config = config
        self.clock = clock
        self._committed: int = -1
        self._restored_from: Optional[int] = None
        self._acked_barrier: str = ""
        self._last_save_time = clock()
        self._last_progress_pub = 0.0
        self._last_directory = config.directory

    @classmethod
    def from_env(cls, checkpointer=None,
                 environ: Optional[Dict[str, str]] = None
                 ) -> Optional["CheckpointHook"]:
        """Build the hook from pod env; None when the job runs no
        checkpoint policy (no TPUJOB_CKPT_DIR rendered)."""
        config = CheckpointConfig.from_env(environ)
        if not config.directory:
            return None
        if checkpointer is None:
            checkpointer = Checkpointer(config.directory,
                                        max_to_keep=config.max_to_keep)
        return cls(checkpointer, config)

    # -- restore ---------------------------------------------------------

    def restore_step(self) -> Optional[int]:
        """The step the control plane committed for this incarnation
        (TPUJOB_RESTORE_STEP), falling back to the newest local
        checkpoint. None = cold start."""
        if self.config.restore_step is not None:
            return self.config.restore_step
        try:
            return self.ckpt.latest_step()
        except Exception:
            return None

    def note_restored(self, step: int) -> None:
        """Record that this incarnation resumed from ``step`` — surfaces
        as restoredFromStep on the job status."""
        self._restored_from = step
        self._committed = max(self._committed, step)
        self._publish(progress=step)

    # -- the per-step hook ------------------------------------------------

    def after_step(self, step: int, state: Any) -> bool:
        """Run the cadence + barrier logic for ``step`` (the number of
        completed optimizer steps). Returns True when a save was
        performed."""
        notice = self._poll_notice()
        if notice is not None:
            return self._save(step, state,
                              barrier=notice.get("barrier", ""))
        if self._periodic_due(step):
            return self._save(step, state)
        now = self.clock()
        if (self.config.record_file
                and now - self._last_progress_pub
                >= self.config.progress_interval_seconds):
            self._publish(progress=step)
        return False

    def _periodic_due(self, step: int) -> bool:
        cfg = self.config
        if step <= self._committed:
            return False
        if cfg.interval_steps is not None and cfg.interval_steps > 0 \
                and step % cfg.interval_steps == 0:
            return True
        return (cfg.interval_seconds is not None
                and self.clock() - self._last_save_time
                >= cfg.interval_seconds)

    def _poll_notice(self) -> Optional[dict]:
        path = self.config.preempt_file
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                notice = json.load(f)
        except (OSError, ValueError):
            return None  # partial write; next step retries
        if notice.get("barrier", "") == self._acked_barrier:
            return None  # already saved + acked under this barrier
        return notice

    def _save(self, step: int, state: Any, barrier: str = "") -> bool:
        t0 = self.clock()
        try:
            self.ckpt.save(step, state, force=True)
            # Durability before publication: the control plane treats
            # the published step as restorable, and a barrier ack
            # releases an eviction — an in-flight async save must not
            # count.
            self.ckpt.wait()
        except Exception:
            # Neither commit nor ack is published: the barrier keeps
            # waiting (bounded by its timeout) and the next step
            # retries the save.
            log.exception("checkpoint save at step %d failed", step)
            return False
        self._committed = step
        self._last_save_time = self.clock()
        if barrier:
            self._acked_barrier = barrier
            log.info("barrier %s: final checkpoint saved at step %d "
                     "(%.2fs); acking", barrier, step,
                     self._last_save_time - t0)
        self._publish(progress=step, save_seconds=self._last_save_time - t0)
        return True

    def _publish(self, progress: int, save_seconds: float = 0.0) -> None:
        """Atomic publish of this worker's checkpoint state; the data
        plane mirrors it into the pod's CheckpointRecord."""
        path = self.config.record_file
        if not path:
            return
        payload = {
            "step": self._committed,
            "progress_step": max(progress, self._committed),
            "barrier": self._acked_barrier,
            "directory": self._last_directory,
            "save_seconds": round(save_seconds, 4),
            "restored_from_step": self._restored_from,
        }
        try:
            with open(path + ".tmp", "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(path + ".tmp", path)
        except OSError:
            log.debug("checkpoint record publish failed", exc_info=True)
            return
        self._last_progress_pub = self.clock()

