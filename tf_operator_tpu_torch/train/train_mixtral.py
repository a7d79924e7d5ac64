"""Mixtral MoE training payload (port of examples/mixtral_moe/train_mixtral.py).

Trains on synthetic token data with ``adamw(1e-4)`` and
``make_moe_lm_loss``, one device a process: the card unless ``--device
cpu``. Where the operator's env joins several processes
(``parallel/distributed.py``), it builds a ``MeshConfig(dcn=num_slices,
dp=-1, ep)`` mesh over them and shards the model by ``MOE_RULES`` (the
experts over ``ep``); one process trains unsharded. ``--batch-size`` is
the global batch. ``--size tiny`` (default) runs anywhere; ``--size 8x7b``
is the full ``mixtral_8x7b`` config (46.7 B parameters), which fits only
sharded over many cards.

    python -m tf_operator_tpu_torch.train.train_mixtral --size tiny --steps 4
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", choices=["tiny", "8x7b"], default="tiny")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--num-slices", type=int, default=1)
    ap.add_argument("--dispatch", choices=["einsum", "gather"],
                    default="einsum",
                    help="MoE routing implementation (the same numbers; "
                         "models/mixtral.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import dataclasses

    from tf_operator_tpu_torch._device import resolve_device
    from tf_operator_tpu_torch.models.mixtral import (
        mixtral_8x7b,
        mixtral_tiny,
    )
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )

    if args.size == "8x7b":
        cfg = mixtral_8x7b()
    else:
        cfg = mixtral_tiny(max_seq_len=args.seq_len * 2)
    cfg = dataclasses.replace(cfg, dispatch=args.dispatch)

    device = resolve_device(args.device)
    print("device:", device)
    with process_group_scope():
        maybe_init_distributed(device)
        return _train(args, cfg, device)


def _train(args, cfg, device) -> int:
    import numpy as np
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.mixtral import (
        Mixtral,
        make_moe_lm_loss,
        param_logical_axes,
    )
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        mesh_shape,
    )
    from tf_operator_tpu_torch.parallel.sharding import MOE_RULES
    from tf_operator_tpu_torch.train.trainer import Trainer, adamw

    config = MeshConfig(dcn=args.num_slices, dp=-1, ep=args.ep)
    # One process trains unsharded, as train_llama.py does.
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(config, device=device)
        print("mesh:", mesh_shape(mesh))
    else:
        mesh = None
        print("mesh:", config.resolve(1))
    # On a mesh, built on the meta device (as train_llama.py).
    model = Mixtral(cfg, device="meta" if mesh is not None else device)
    trainer = Trainer(model=model,
                      optimizer=adamw(1e-4),
                      loss_fn=make_moe_lm_loss(cfg.aux_loss_weight),
                      device=device, mesh=mesh, rules=MOE_RULES,
                      param_axes_fn=param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    data_rng = np.random.default_rng(0)
    for i in range(args.steps):
        tokens = data_rng.integers(0, cfg.vocab_size,
                                   (args.batch_size, args.seq_len + 1))
        state, metrics = step(state, {"inputs": tokens})
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print("mixtral training OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
