"""Device resolution for the port's entry points: the card by default."""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


# The pod's device as the operator renders it into a pod that holds no
# GPU (api/constants.py ENV_DEVICE; a copy, so this module stays free of
# the control plane's imports).
ENV_DEVICE = "TPUJOB_DEVICE"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the device the operator named for this pod
    (``TPUJOB_DEVICE``, ``cpu`` in a pod that holds no GPU), else the
    CUDA card; raise if there is none.

    Only an explicit ``"cpu"`` (or ``torch.device("cpu")``, or the
    operator's key) runs on the host: a missing card never turns into a
    silent CPU run, nor does an empty or unset ``CUDA_VISIBLE_DEVICES``.
    In a process the env gives a ``LOCAL_RANK`` (one of a pod's
    processes, one a GPU), a card named without an index is card
    ``LOCAL_RANK`` of the pod's visible ones, made the current device.
    """
    if device is None:
        device = os.environ.get(ENV_DEVICE) or "cuda"
    dev = torch.device(device)
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
    operator's backend or the device plugin set it); another device with
    the device the operator named for the pod, where it named one
    (``TPUJOB_DEVICE``)."""
    if device.type != "cuda":
        named = os.environ.get(ENV_DEVICE)
        return f"{device} ({ENV_DEVICE}={named})" if named else str(device)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return (f"{device} ({torch.cuda.get_device_name(device)}, "
            f"CUDA_VISIBLE_DEVICES={'unset' if visible is None else visible})")
