"""Slice-gang pod binder, the part the local data plane needs (port of
tf_operator_tpu/controller/binder.py:60-75).

Only the admitted gang phases and a pod's device demand are here: the
local backend gates gang pods on ``ADMITTED_PHASES`` and books their
GPUs through ``pod_chip_demand``. The placement arm itself (node
inventory, topology-aware binding, slice health) comes with the gang
scheduler, a later part of the port's control plane.
"""

from __future__ import annotations

from tf_operator_tpu_torch.api import constants
from tf_operator_tpu_torch.api.types import Pod

ADMITTED_PHASES = ("Inqueue", "Running")


def pod_chip_demand(pod: Pod) -> int:
    """GPUs a pod holds once placed: the sum of its containers'
    declared ``nvidia.com/gpu`` limits (the controller stamps worker
    pods from the slice topology at create time, so gang workers always
    declare; foreign pods count by what they declare)."""
    total = 0
    for c in pod.spec.containers:
        raw = c.resources.get(constants.RESOURCE_GPU, "0") or "0"
        try:
            total += int(float(raw))
        except ValueError:
            pass
    return total
