"""Llama decoder training payload (port of examples/llama_spmd/train_llama.py).

Trains on synthetic token data with ``adamw(3e-4)``, one device a
process: the card unless ``--device cpu``. Where the operator's env joins
several processes (``parallel/distributed.py``), it builds a
``MeshConfig(dp=-1, fsdp, tp)`` mesh over them and shards the model by
``LLAMA_RULES``; one process trains unsharded.
``--batch-size`` is the global batch. ``--size tiny`` (default) runs
anywhere; ``--size 8b`` is the full ``llama_3_8b`` config, whose state
(f32 params, grads and two AdamW moments: 16 bytes a parameter, 128 GB)
fits only sharded over several 80 GB cards.

    python -m tf_operator_tpu_torch.train.train_llama --size tiny --steps 4
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tf_operator_tpu_torch.parallel.distributed import (
        launch_local_processes,
    )

    # A pod of several GPUs runs one process a GPU: this one starts them.
    code = launch_local_processes(
        "tf_operator_tpu_torch.train.train_llama", argv)
    if code is not None:
        return code

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", choices=["tiny", "8b"], default="tiny")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tf_operator_tpu_torch._device import describe, resolve_device
    from tf_operator_tpu_torch.models.llama import llama_3_8b, llama_tiny
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )

    if args.size == "8b":
        cfg = llama_3_8b()
    else:
        cfg = llama_tiny(vocab_size=512, max_seq_len=args.seq_len * 2)

    device = resolve_device(args.device)
    print("device:", describe(device))
    with process_group_scope():
        maybe_init_distributed(device)
        return _train(args, cfg, device)


def _train(args, cfg, device) -> int:
    import numpy as np
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.llama import Llama, param_logical_axes
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        mesh_shape,
    )
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train.trainer import Trainer, adamw

    config = MeshConfig(dp=-1, fsdp=args.fsdp, tp=args.tp)
    # One process trains unsharded: a world-1 mesh would only add the
    # host cost of FSDP2's hooks and DTensor dispatch to every step.
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(config, device=device)
        print("mesh:", mesh_shape(mesh))
    else:
        mesh = None
        print("mesh:", config.resolve(1))
    # On a mesh the model is built on the meta device: init() gives each
    # rank its own shards of the same draws, and no rank holds it whole.
    model = Llama(cfg, device="meta" if mesh is not None else device)
    trainer = Trainer(model=model, optimizer=adamw(3e-4), device=device,
                      mesh=mesh, rules=LLAMA_RULES,
                      param_axes_fn=param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    data_rng = np.random.default_rng(0)
    for i in range(args.steps):
        tokens = data_rng.integers(0, cfg.vocab_size,
                                   (args.batch_size, args.seq_len + 1))
        state, metrics = step(state, {"inputs": tokens})
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print("llama training OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
