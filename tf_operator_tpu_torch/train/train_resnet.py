"""ResNet data-parallel training payload on one device (port of
examples/resnet_dp/train_resnet.py).

Trains on one synthetic batch with ``sgd(0.1, momentum=0.9)`` and
``classification_loss`` (BatchNorm statistics updated every step) on the
card unless ``--device cpu``. ``--size tiny`` (default) runs anywhere;
``--size 50`` is ResNet-50.

    python -m tf_operator_tpu_torch.train.train_resnet --size 50 --steps 4 \\
        --batch-size 64 --image-size 224
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", choices=["tiny", "50"], default="tiny")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from tf_operator_tpu_torch._device import describe, resolve_device
    from tf_operator_tpu_torch.models import resnet as rn
    from tf_operator_tpu_torch.train.trainer import (
        Trainer,
        classification_loss,
        sgd,
    )

    cfg = rn.resnet50() if args.size == "50" else rn.resnet_tiny()
    device = resolve_device(args.device)
    print("device:", describe(device))
    gen = torch.Generator(device=device).manual_seed(0)
    trainer = Trainer(model=rn.ResNet(cfg, device=device, generator=gen),
                      optimizer=sgd(0.1, momentum=0.9),
                      loss_fn=classification_loss, device=device)
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
