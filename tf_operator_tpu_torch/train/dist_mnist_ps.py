"""Async parameter-server MNIST worker (port of
examples/dist_mnist/dist_mnist_ps.py).

The dist-mnist PS topology on the port's runtime (``train/ps.py``):

- ps replicas run ``python -m tf_operator_tpu_torch.train.ps --lr 0.2``;
- worker replicas run this module: pull the parameters from the sharded
  servers, compute a gradient on the card (``--device cpu`` for the
  host), push it back; fully async, no worker-to-worker synchronisation
  (DownpourSGD).

The model is the JAX worker's 784-64-10 ReLU MLP with its loss, under the
same wire keys (``dense1/w`` [784, 64], ``dense1/b``, ``dense2/w``
[64, 10], ``dense2/b``), so port and JAX workers can share one PS. The
data is synthetic and separable: x ~ N(0, 1) [batch, 784] from a torch
generator seeded ``worker_id * 10000 + step``, label = argmax of x @ P
for a fixed projection P [784, 10] from seed 7. Every worker initialises
from seed 0, so the racing ``/init`` writes are identical.

    python -m tf_operator_tpu_torch.train.dist_mnist_ps --steps 20
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from tf_operator_tpu_torch._device import DeviceLike, describe, resolve_device


def init_params(device: DeviceLike = "cpu"
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The MLP's initial parameters (seed 0, N(0, 0.05²) weights, zero
    biases)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    normal = lambda *shape: torch.randn(*shape, generator=gen,
                                        device=device) * 0.05
    return {"dense1": {"w": normal(784, 64),
                       "b": torch.zeros(64, device=device)},
            "dense2": {"w": normal(64, 10),
                       "b": torch.zeros(10, device=device)}}


def loss_fn(p: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the MLP's log-softmax at the labels."""
    h = torch.relu(x @ p["dense1"]["w"] + p["dense1"]["b"])
    logits = h @ p["dense2"]["w"] + p["dense2"]["b"]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def grads(p: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
          y: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients in ``p``'s tree)."""
    leaves = {(a, b): t.detach().requires_grad_()
              for a, layer in p.items() for b, t in layer.items()}
    tree = {a: {b: leaves[(a, b)] for b in layer} for a, layer in p.items()}
    loss = loss_fn(tree, x, y)
    got = torch.autograd.grad(loss, list(leaves.values()))
    out: Dict = {}
    for (a, b), g in zip(leaves, got):
        out.setdefault(a, {})[b] = g
    return loss.detach(), out


def batch(worker_id: int, step: int, batch_size: int,
          device: DeviceLike = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The synthetic separable batch of ``worker_id`` at ``step``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        worker_id * 10_000 + step)
    x = torch.randn(batch_size, 784, generator=gen, device=device)
    proj = torch.randn(784, 10, device=device,
                       generator=torch.Generator(device=device).manual_seed(7))
    return x, (x @ proj).argmax(dim=1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tf_operator_tpu_torch.train.ps import PSClient, cluster_ps_addrs

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print("device:", describe(device), flush=True)
    addrs = cluster_ps_addrs()
    if not addrs:
        raise SystemExit("no ps replicas in TPUJOB_CLUSTER_SPEC")
    print(f"ps addrs: {','.join(addrs)}", flush=True)
    # RANK under the port's operator, TPU_WORKER_ID under the JAX one.
    worker_id = int(os.environ.get("RANK")
                    or os.environ.get("TPU_WORKER_ID") or 0)

    client = PSClient(addrs)
    try:
        client.wait_ready()
        client.init(init_params(device))
        losses = []
        for step in range(args.steps):
            p = {a: {b: torch.tensor(t, device=device)
                     for b, t in layer.items()}
                 for a, layer in client.pull().items()}
            x, y = batch(worker_id, step, args.batch_size, device)
            loss, g = grads(p, x, y)
            client.push(g)
            losses.append(float(loss))
            print(f"worker {worker_id} step {step}: loss={losses[-1]:.4f}",
                  flush=True)
    finally:
        client.close()
    # Async staleness makes single steps noisy: report window means.
    k = max(1, min(5, len(losses) // 3))
    first = sum(losses[:k]) / k
    last = sum(losses[-k:]) / k
    print(f"done: first={first:.4f} last={last:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
