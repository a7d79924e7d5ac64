"""MNIST payload with restart-and-resume (port of examples/dist_mnist).

    python -m tf_operator_tpu_torch.train.dist_mnist [--steps 20]
        [--batch-size 64] [--checkpoint-dir D] [--crash-at-step N]
        [--device cpu]

Each replica reads the operator-injected bootstrap env
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` from the port's
operator, the ``JAX_*`` keys from the JAX package's)
and trains ``MnistCNN`` on synthetic data with ``adam(1e-3)``, on the
card unless ``--device cpu``. With ``TPUJOB_JAX_DISTRIBUTED=1``, more than
one process and a coordinator address, the replicas join one run
(``parallel/distributed.py``: NCCL on the card, gloo on the CPU) and
train through the sharded trainer on a ``MeshConfig(dp=-1)`` mesh over
the processes with ``CNN_RULES`` (parameters replicated); otherwise each
trains on its own, unsharded, as the JAX payload does.

``--batch-size`` is the global batch: each process draws only its local
slice, rank r's of step i from a generator seeded with (i + 1) * nproc +
r (one process: i + 1), so a resumed run sees the batches an
uninterrupted one sees and the global batch never exists on one host.
With ``--checkpoint-dir`` every step is saved (each rank its shards) and
a restarted run resumes from the latest checkpoint, restored into the
trainer's ``abstract_state()`` with no init drawn; ``--crash-at-step N``
exits 137 (a retryable code under the ExitCode restart policy) once step N
is on disk, on a fresh start only. The log lines are the JAX payload's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

CRASH_EXIT_CODE = 137   # SIGKILL-class: retryable under ExitCode policy


def process_rank(device=None) -> int:
    """This replica's rank (it prints the step lines at rank 0), having
    joined the multi-process run the env describes, if it describes one
    (``device``: the card unless ``"cpu"``)."""
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
    )

    return maybe_init_distributed(device)


def local_shard(step_idx: int, nproc: int, index: int, batch_size: int):
    """Process ``index`` of ``nproc``'s slice of the global batch of
    ``batch_size`` fed at ``step_idx`` (the loop's i + 1): drawn from a CPU
    generator seeded with step_idx * nproc + index, as the JAX payload
    seeds its PRNG key."""
    import torch

    from tf_operator_tpu_torch.models.mnist import synthetic_batch

    return synthetic_batch(
        torch.Generator().manual_seed(step_idx * nproc + index),
        batch_size=max(batch_size // nproc, 1))


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tf_operator_tpu_torch.parallel.distributed import (
        launch_local_processes,
    )

    # A pod of several GPUs runs one process a GPU: this one starts them.
    code = launch_local_processes(
        "tf_operator_tpu_torch.train.dist_mnist", argv)
    if code is not None:
        return code

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
    from tf_operator_tpu_torch.parallel.distributed import (
        process_group_scope,
    )

    with process_group_scope():
        return _train(args, process_rank(args.device))


def _train(args, rank: int) -> int:
    import torch.distributed as dist

    from tf_operator_tpu_torch._device import resolve_device
    from tf_operator_tpu_torch.models.mnist import (
        MnistCNN,
        param_logical_axes,
    )
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import CNN_RULES
    from tf_operator_tpu_torch.train.checkpoint import Checkpointer
    from tf_operator_tpu_torch.train.data import multihost_batch
    from tf_operator_tpu_torch.train.trainer import (
        Trainer,
        adam,
        classification_loss,
    )

    device = resolve_device(args.device)
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if nproc > 1 else 0
    # One process trains unsharded: a world-1 mesh would only add the
    # host cost of FSDP2's hooks to every step.
    mesh = make_mesh(MeshConfig(dp=-1), device=device) if nproc > 1 else None
    # Built on the meta device: init() draws it on this rank's device
    # (seed 0), or a resume restores into abstract_state() and draws
    # nothing.
    trainer = Trainer(model=MnistCNN(device="meta"), optimizer=adam(1e-3),
                      loss_fn=classification_loss, device=device, mesh=mesh,
                      rules=CNN_RULES, param_axes_fn=param_logical_axes)

    # Multihost feeding contract: --batch-size is the GLOBAL batch; each
    # process draws only its local slice.

    def make_batch(step_idx: int):
        local = local_shard(step_idx, nproc, index, args.batch_size)
        return multihost_batch(local, mesh) if nproc > 1 else local

    if nproc > 1:
        print(f"distributed: {nproc} processes, {nproc} global devices")

    # Checkpoint/resume: a restarted replica (same index, fresh pod)
    # picks up from the latest saved step instead of step 0 — what makes
    # the ExitCode restart policy resume work. On resume, the parameters
    # land straight in their layout (no wasted init).
    ckpt = None
    state = None
    fresh_start = True
    if args.checkpoint_dir:
        ckpt = Checkpointer(os.path.abspath(args.checkpoint_dir))
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(trainer.abstract_state())
            fresh_start = False
            print(f"resumed from checkpoint at step {latest}")
    if state is None:
        state = trainer.init()
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
