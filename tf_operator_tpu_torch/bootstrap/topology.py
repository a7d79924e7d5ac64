"""GPU slice topology model (port of tf_operator_tpu/bootstrap/topology.py).

No reference analog — the reference was device-blind (Volcano PodGroups
carry only counts/resources). The control plane needs the slice shape to
(a) compute process counts/ranks for torch.distributed, (b) derive the
default device mesh, (c) gang-allocate whole slices.

Conventions encoded:
- the one generation is ``h100``: an HGX H100 board holds 8 GPUs a host,
  and the accelerator name counts GPUs, so ``h100-8`` is one host of 8,
  ``h100-16`` two hosts and ``h100-1`` one host with one GPU (capped by
  slice size, as sub-host TPU slices are).
- the mesh is one-dimensional, ``(gpus,)``: NVLink joins a host's GPUs
  all to all, so there is no torus to factor.
- a TPU name (``v5p-32``) names an unknown generation and is refused.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Tuple

_ACCEL_RE = re.compile(r"^([a-z]+[0-9]+[a-z]*)-([0-9]+)$")

# generation -> (name counts cores?, GPUs per host, mesh rank)
_GENERATIONS = {
    "h100": (False, 8, 1),
}


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    accelerator: str          # e.g. "h100-16"
    generation: str           # e.g. "h100"
    chips: int                # GPUs in one slice
    topology: Tuple[int, ...]  # device mesh, e.g. (16,)
    chips_per_host: int
    num_slices: int = 1

    @property
    def hosts_per_slice(self) -> int:
        return max(1, self.chips // self.chips_per_host)

    @property
    def num_hosts(self) -> int:
        """Total worker processes across all slices (one per host)."""
        return self.hosts_per_slice * self.num_slices

    @property
    def devices_per_host(self) -> int:
        return min(self.chips, self.chips_per_host)

    @property
    def total_chips(self) -> int:
        return self.chips * self.num_slices

    @property
    def topology_str(self) -> str:
        return "x".join(str(d) for d in self.topology)


def _default_topology(chips: int, rank: int) -> Tuple[int, ...]:
    """Factor ``chips`` into ``rank`` near-balanced power-of-two-ish dims,
    sorted ascending (2x2x4 rather than 4x2x2); at rank 1, ``(chips,)``."""
    if chips <= 0:
        raise ValueError(f"chips must be positive, got {chips}")
    dims = [1] * rank
    remaining = chips
    # Peel factors smallest-first so dims stay balanced.
    while remaining > 1:
        for factor in range(2, remaining + 1):
            if remaining % factor == 0:
                smallest = dims.index(min(dims))
                dims[smallest] *= factor
                remaining //= factor
                break
    # Non-trivial dims ascending, trailing 1s.
    non_trivial = sorted(d for d in dims if d > 1)
    return tuple(non_trivial + [1] * (rank - len(non_trivial)))


def parse_accelerator(accelerator: str, topology: str = "",
                      num_slices: int = 1) -> SliceTopology:
    """Parse a GPU accelerator string (``h100-<gpus>``) into a
    SliceTopology.

    ``topology`` overrides the derived mesh (e.g. "16"); its product must
    equal the GPU count.
    """
    m = _ACCEL_RE.match(accelerator)
    if not m:
        raise ValueError(f"invalid accelerator {accelerator!r}; expected e.g. 'h100-8'")
    generation, count = m.group(1), int(m.group(2))
    if generation not in _GENERATIONS:
        raise ValueError(
            f"unknown GPU generation {generation!r}; known: "
            f"{', '.join(sorted(_GENERATIONS))}")
    counts_cores, chips_per_host, rank = _GENERATIONS[generation]
    chips = count // 2 if counts_cores else count
    if chips < 1:
        raise ValueError(f"accelerator {accelerator!r} resolves to zero chips")

    if topology:
        dims = tuple(int(d) for d in topology.split("x"))
        if math.prod(dims) != chips:
            raise ValueError(
                f"topology {topology!r} has {math.prod(dims)} chips but "
                f"{accelerator!r} has {chips}")
    else:
        dims = _default_topology(chips, rank)

    if num_slices < 1:
        raise ValueError("num_slices must be >= 1")

    return SliceTopology(accelerator=accelerator, generation=generation,
                         chips=chips, topology=dims,
                         chips_per_host=chips_per_host, num_slices=num_slices)
