"""Llama decoder training payload (port of examples/llama_spmd/train_llama.py).

Trains on synthetic token data with ``adamw(3e-4)`` on one device: the
card unless ``--device cpu``. ``--size tiny`` (default) runs anywhere;
``--size 8b`` is the full ``llama_3_8b`` config, which needs more memory
than one 80 GB card holds at 32 layers (f32 params, grads and two AdamW
moments are 16 bytes a parameter).

    python -m tf_operator_tpu_torch.train.train_llama --size tiny --steps 4
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", choices=["tiny", "8b"], default="tiny")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from tf_operator_tpu_torch._device import resolve_device
    from tf_operator_tpu_torch.models.llama import (
        Llama,
        llama_3_8b,
        llama_tiny,
    )
    from tf_operator_tpu_torch.train.trainer import Trainer, adamw

    if args.size == "8b":
        cfg = llama_3_8b()
    else:
        cfg = llama_tiny(vocab_size=512, max_seq_len=args.seq_len * 2)

    device = resolve_device(args.device)
    print("device:", device)
    trainer = Trainer(model=Llama(cfg, device=device), optimizer=adamw(3e-4),
                      device=device)
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
