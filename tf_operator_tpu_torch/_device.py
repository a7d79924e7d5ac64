"""Device resolution for the port's entry points: the card by default."""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raise if there is none.

    Only an explicit ``"cpu"`` (or ``torch.device("cpu")``) runs on the
    host: a missing card never turns into a silent CPU run. In a process
    the env gives a ``LOCAL_RANK`` (one of a pod's processes, one a GPU),
    a card named without an index is card ``LOCAL_RANK`` of the pod's
    visible ones, made the current device.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run on the host")
    local_rank = os.environ.get("LOCAL_RANK")
    if dev.type == "cuda" and dev.index is None and local_rank:
        dev = torch.device("cuda", int(local_rank))
        torch.cuda.set_device(dev)
    return dev


def describe(device: torch.device) -> str:
    """``device`` as a payload logs it: a card with its name and the
    cards this process was given (``CUDA_VISIBLE_DEVICES``, as the
    operator's backend or the device plugin set it)."""
    if device.type != "cuda":
        return str(device)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return (f"{device} ({torch.cuda.get_device_name(device)}, "
            f"CUDA_VISIBLE_DEVICES={'unset' if visible is None else visible})")
