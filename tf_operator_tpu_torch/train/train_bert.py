"""BERT MLM pretraining payload (port of examples/bert_gang/train_bert.py).

The BASELINE's "BERT-base pretraining TFJob, PS + 8 Workers with gang
scheduling" config: the job spec keeps gang scheduling, and the payload
trains dp/tp-sharded with the masked-LM loss and ``adamw(1e-4)``, one
device a process: the card unless ``--device cpu``. Where the operator's
env joins several processes (``parallel/distributed.py``), it builds a
``MeshConfig(dp=-1, tp)`` mesh over them and shards the model by
``LLAMA_RULES``; one process trains unsharded. The batches are the JAX
payload's: ``default_rng(0)`` tokens, 15% of positions masked with the
sentinel 3. ``--size tiny`` (default) runs anywhere; ``--size base`` is
``bert_base`` (bf16 compute, remat), whose tp must divide its 30522-word
vocabulary (1 or 2).

    python -m tf_operator_tpu_torch.train.train_bert --size tiny --steps 4
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
        "tf_operator_tpu_torch.train.train_bert", argv)
    if code is not None:
        return code

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", choices=["tiny", "base"], default="tiny")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tf_operator_tpu_torch._device import describe, resolve_device
    from tf_operator_tpu_torch.models.bert import bert_base, bert_tiny
    from tf_operator_tpu_torch.parallel.distributed import (
        maybe_init_distributed,
        process_group_scope,
    )

    if args.size == "base":
        cfg = bert_base()
    else:
        cfg = bert_tiny(max_seq_len=args.seq_len)

    device = resolve_device(args.device)
    print("device:", describe(device))
    with process_group_scope():
        maybe_init_distributed(device)
        return _train(args, cfg, device)


def _train(args, cfg, device) -> int:
    import numpy as np
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.bert import (
        Bert,
        mlm_loss,
        param_logical_axes,
    )
    from tf_operator_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        mesh_shape,
    )
    from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
    from tf_operator_tpu_torch.train.trainer import Trainer, adamw

    config = MeshConfig(dp=-1, tp=args.tp)
    # One process trains unsharded, as train_llama.py does.
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(config, device=device)
        print("mesh:", mesh_shape(mesh))
    else:
        mesh = None
        print("mesh:", config.resolve(1))
    # On a mesh, built on the meta device (as train_llama.py).
    model = Bert(cfg, device="meta" if mesh is not None else device)
    trainer = Trainer(model=model, optimizer=adamw(1e-4), loss_fn=mlm_loss,
                      device=device, mesh=mesh, rules=LLAMA_RULES,
                      param_axes_fn=param_logical_axes)
    state = trainer.init()
    step = trainer.make_train_step()
    data_rng = np.random.default_rng(0)

    def make_batch():
        tokens = data_rng.integers(0, cfg.vocab_size,
                                   (args.batch_size, args.seq_len))
        mask = data_rng.random((args.batch_size, args.seq_len)) < 0.15
        inputs = np.where(mask, 3, tokens)  # 3 = [MASK]-style sentinel
        return {"inputs": inputs, "targets": tokens,
                "mask": mask.astype(np.float32)}

    # The JAX payload draws one sample batch for its init first.
    make_batch()
    for i in range(args.steps):
        state, metrics = step(state, make_batch())
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print("bert training OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
