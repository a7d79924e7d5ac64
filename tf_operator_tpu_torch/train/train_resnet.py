"""ResNet data-parallel training payload (port of
examples/resnet_dp/train_resnet.py).

Trains on one synthetic batch with ``sgd(0.1, momentum=0.9)`` and
``classification_loss`` (BatchNorm statistics updated every step) on the
card unless ``--device cpu``. Where the operator's env joins several
processes (``parallel/distributed.py``: a pod's GPUs, or the job-wide
world), it builds a ``MeshConfig(dp=-1)`` mesh over them, as the JAX
payload does over its host's chips: parameters replicated by
``CNN_RULES``, each rank a slice of ``--batch-size`` (the global batch),
BatchNorm statistics over the global batch; one process trains
unsharded. ``--size tiny`` (default) runs anywhere; ``--size 50`` is
ResNet-50.

    python -m tf_operator_tpu_torch.train.train_resnet --size 50 --steps 4 \\
        --batch-size 64 --image-size 224
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
        "tf_operator_tpu_torch.train.train_resnet", argv)
    if code is not None:
        return code

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", choices=["tiny", "50"], default="tiny")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tf_operator_tpu_torch._device import describe, resolve_device
    from tf_operator_tpu_torch.models import resnet as rn
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )

    cfg = rn.resnet50() if args.size == "50" else rn.resnet_tiny()
    device = resolve_device(args.device)
    print("device:", describe(device))
    with process_group_scope():
        maybe_init_distributed(device)
        return _train(args, cfg, device)


def _train(args, cfg, device) -> int:
    import torch
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import resnet as rn
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        mesh_shape,
    )
    from tf_operator_tpu_torch.parallel.sharding import CNN_RULES
    from tf_operator_tpu_torch.train.trainer import (
        Trainer,
        classification_loss,
        sgd,
    )

    config = MeshConfig(dp=-1)
    # One process trains unsharded: a world-1 mesh would only add the
    # host cost of FSDP2's hooks to every step.
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(config, device=device)
        print("mesh:", mesh_shape(mesh))
    else:
        mesh = None
        print("mesh:", config.resolve(1))
    gen = torch.Generator(device=device).manual_seed(0)
    # On a mesh the model is built on the meta device and init() draws
    # it from ``gen`` as the eager build does, so the batch drawn after
    # is the same on every rank and in one process.
    trainer = Trainer(model=rn.ResNet(cfg, device="meta" if mesh is not None
                                      else device, generator=gen),
                      optimizer=sgd(0.1, momentum=0.9),
                      loss_fn=classification_loss, device=device, mesh=mesh,
                      rules=CNN_RULES, param_axes_fn=rn.param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    batch = rn.synthetic_batch(gen, batch_size=args.batch_size,
                               image_size=args.image_size,
                               num_classes=cfg.num_classes)
    for i in range(args.steps):
        state, metrics = step(state, batch)
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print("resnet training OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
