"""MNIST payload with restart-and-resume (port of examples/dist_mnist).

    python -m tf_operator_tpu_torch.train.dist_mnist [--steps 20]
        [--batch-size 64] [--checkpoint-dir D] [--crash-at-step N]
        [--device cpu]

Each replica reads the operator-injected bootstrap env
(``TPUJOB_CLUSTER_SPEC``, ``TPU_WORKER_ID``) and trains ``MnistCNN`` on
synthetic data with ``adam(1e-3)`` on one device: the card unless
``--device cpu``. The batch of step i is drawn from a generator seeded
with i + 1, so a resumed run sees the batches an uninterrupted one sees.
With ``--checkpoint-dir`` every step is saved and a restarted replica
resumes from the latest checkpoint; ``--crash-at-step N`` exits 137 (a
retryable code under the ExitCode restart policy) once step N is on disk,
on a fresh start only. The log lines are the JAX payload's.

Multi-process training (``TPUJOB_JAX_DISTRIBUTED=1`` with
``JAX_NUM_PROCESSES`` > 1) is not ported yet and raises; without that
flag each replica trains locally, as the JAX payload does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

CRASH_EXIT_CODE = 137   # SIGKILL-class: retryable under ExitCode policy


def process_rank() -> int:
    """This replica's rank (it prints the step lines at rank 0); raises
    where the job asks for one multi-process training run."""
    num = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num > 1 and os.environ.get("TPUJOB_JAX_DISTRIBUTED") == "1":
        raise NotImplementedError(
            "multi-process training is not ported to PyTorch yet "
            "(ROADMAP.md queue A item 3); without TPUJOB_JAX_DISTRIBUTED=1 "
            "each replica trains locally")
    return int(os.environ.get("JAX_PROCESS_ID",
                              os.environ.get("TPU_WORKER_ID", "0")))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--checkpoint-dir", default="",
                    help="save/resume training state here")
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="exit with a retryable code at this step on a "
                         "fresh start (restart/resume e2e fault injection)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    spec = os.environ.get("TPUJOB_CLUSTER_SPEC")
    if spec:
        task = json.loads(spec).get("task", {})
        print(f"replica {task.get('type')}-{task.get('index')} starting")
    rank = process_rank()

    import torch

    from tf_operator_tpu_torch._device import resolve_device
    from tf_operator_tpu_torch.models.mnist import MnistCNN, synthetic_batch
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer
    from tf_operator_tpu_torch.train.trainer import (
        Trainer,
        adam,
        classification_loss,
    )

    device = resolve_device(args.device)
    model = MnistCNN(device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    trainer = Trainer(model=model, optimizer=adam(1e-3),
                      loss_fn=classification_loss, device=device)
    state = trainer.init()

    def make_batch(step_idx: int):
        return synthetic_batch(torch.Generator().manual_seed(step_idx),
                               batch_size=args.batch_size)

    # Checkpoint/resume: a restarted replica (same index, fresh pod)
    # picks up from the latest saved step instead of step 0 — what makes
    # the ExitCode restart policy resume work.
    ckpt = None
    fresh_start = True
    if args.checkpoint_dir:
        ckpt = Checkpointer(os.path.abspath(args.checkpoint_dir))
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state)
            fresh_start = False
            print(f"resumed from checkpoint at step {latest}")
    step = trainer.make_train_step()

    first = last = None
    for i in range(state.step, args.steps):
        state, metrics = step(state, make_batch(i + 1))
        loss = float(metrics["loss"])
        first = loss if first is None else first
        last = loss
        if rank == 0 and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i}: loss={loss:.4f}")
        if ckpt is not None:
            ckpt.save(state.step, state)
        if fresh_start and i + 1 == args.crash_at_step:
            if ckpt is not None:
                ckpt.wait()
            print(f"injected crash at step {i + 1}", flush=True)
            return CRASH_EXIT_CODE
    if ckpt is not None:
        ckpt.close()
    if first is None:  # resumed at or past the final step: nothing to do
        print("done: no steps remaining after resume")
    else:
        print(f"done: loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
