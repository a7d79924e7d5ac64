"""Pipeline-parallel Llama training payload (port of
examples/llama_pp/train_llama_pp.py).

A tiny Llama (``llama_tiny`` widths, ``--layers`` deep, the reference
attention as in the JAX payload) whose layers are staged over ``--pp``
processes and replicated over ``--dp``, trained with ``adamw(3e-3)`` under
the GPipe or 1F1B schedule (``parallel/llama_pp.py``). One device a
process: the card unless ``--device cpu``. The processes join one run
from the operator's env (``parallel/distributed.py``); their count must be
pp x dp (it takes the place of the JAX payload's ``--cpu-devices``).

    python -m tf_operator_tpu_torch.train.train_llama_pp --pp 1 --dp 1
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tf_operator_tpu_torch.parallel.distributed import (
        launch_local_processes,
    )

    # A pod of several GPUs runs one process a GPU: this one starts them.
    code = launch_local_processes(
        "tf_operator_tpu_torch.train.train_llama_pp", argv)
    if code is not None:
        return code

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--schedule", default="auto",
                    choices=("auto", "gpipe", "1f1b"),
                    help="pipeline schedule; auto keeps GPipe when its "
                         "activation stash fits device memory, else 1F1B")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tf_operator_tpu_torch._device import describe, resolve_device
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )

    device = resolve_device(args.device)
    print("device:", describe(device))
    with process_group_scope():
        maybe_init_distributed(device)
        return _train(args, device)


def _train(args, device) -> int:
    import numpy as np
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.llama import llama_tiny
    from tf_operator_tpu_torch.parallel.llama_pp import LlamaPipelineTrainer
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        mesh_shape,
    )
    from tf_operator_tpu_torch.train.trainer import adamw

    need = args.pp * args.dp
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        print(f"need {need} processes for dp={args.dp} x pp={args.pp}, "
              f"have {have}")
        return 1
    cfg = dataclasses.replace(
        llama_tiny(vocab_size=512, max_seq_len=args.seq_len * 2),
        n_layers=args.layers, attention_impl="xla")
    mesh = make_mesh(MeshConfig(dp=args.dp, pp=args.pp), device=device)
    print("mesh:", mesh_shape(mesh))
    trainer = LlamaPipelineTrainer(cfg, mesh, adamw(3e-3),
                                   num_microbatches=args.microbatches,
                                   schedule=args.schedule, device=device)
    state = trainer.init()
    data_rng = np.random.default_rng(0)
    sample = np.zeros((args.batch_size, args.seq_len + 1), np.int64)
    step = trainer.make_train_step(state, sample_tokens=sample)
    print(f"schedule: requested={args.schedule} "
          f"resolved={trainer.resolved_schedule}")
    for i in range(args.steps):
        tokens = data_rng.integers(0, cfg.vocab_size,
                                   (args.batch_size, args.seq_len + 1))
        state, metrics = step(state, tokens)
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print(f"llama {trainer.resolved_schedule} pipeline training OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
