"""Smoke payload: a matmul on every visible device (port of
examples/smoke/tpu_smoke.py).

Reference analog: examples/tf_sample/tf_smoke.py (all-device matmul).
Prints the bootstrap env the operator injected (and the cards the pod
was given, ``CUDA_VISIBLE_DEVICES``) and where the port was imported
from (a checkout or an install), runs one bf16 256x256
matmul on each visible card (or on the host with ``--device cpu``), and
exits 0 on success. Like the JAX smoke it joins no process group.

    python -m tf_operator_tpu_torch.train.gpu_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

import torch

import tf_operator_tpu_torch
from tf_operator_tpu_torch._device import resolve_device

BOOTSTRAP_PREFIXES = ("MASTER_", "RANK", "WORLD_SIZE", "LOCAL_", "GROUP_",
                      "TPUJOB_", "CUDA_VISIBLE_DEVICES")


def devices(device: Optional[str]) -> List[torch.device]:
    """Every visible card, or the one device the caller names (or the
    operator, for a pod that holds no GPU: ``TPUJOB_DEVICE``)."""
    resolved = resolve_device(device)  # raises without a card
    if device is not None or resolved.type != "cuda":
        return [resolved]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: every visible CUDA card)")
    args = ap.parse_args(argv)

    bootstrap = {k: v for k, v in sorted(os.environ.items())
                 if k.startswith(BOOTSTRAP_PREFIXES)}
    print("bootstrap env:", json.dumps(bootstrap, indent=1), flush=True)
    print("port imported from",
          os.path.dirname(tf_operator_tpu_torch.__file__), flush=True)

    found = devices(args.device)
    for device in found:
        x = torch.ones((256, 256), dtype=torch.bfloat16, device=device)
        y = (x @ x).sum()
        print(f"{device} ({device_name(device)}): matmul sum = "
              f"{float(y):.1f}", flush=True)
    print("smoke OK on", len(found), "device(s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
