"""Device mesh construction (port of parallel/mesh.py).

The same axis convention as the JAX package, outermost first:

    ("dcn", "dp", "fsdp", "pp", "sp", "tp", "ep")

and the same ``MeshConfig`` (sizes, -1 on at most one axis absorbs the
remaining processes). A mesh is a ``torch.distributed`` ``DeviceMesh``
with those seven dimension names over the processes of the world, one
device each (rank order, so the innermost axes land on neighbouring
ranks). Axes of size 1 are kept, as in JAX, so a placement can name every
logical axis unconditionally.

A ``DeviceMesh`` needs a process group. Where none stands (one process,
no ``parallel/distributed.py`` bring-up), ``make_mesh`` makes a world of
one first: NCCL on the card, gloo on the CPU, as ``distributed.py``
chooses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from tf_operator_tpu_torch._device import DeviceLike, resolve_device

AXIS_ORDER = ("dcn", "dp", "fsdp", "pp", "sp", "tp", "ep")

# Ambient mesh, as in the JAX package: code that needs the mesh reaches
# it without threading it through every call.
_MESH_STACK: List[DeviceMesh] = []


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def active_mesh() -> Optional[DeviceMesh]:
    return _MESH_STACK[-1] if _MESH_STACK else None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; -1 on at most one axis means 'absorb remaining devices'."""

    dcn: int = 1
    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes product {fixed} != device count {n_devices}")
        return sizes


def ensure_process_group(device: torch.device) -> None:
    """Make a world of one process (an in-process store, no network) when
    no process group stands: NCCL for a CUDA device, gloo for the CPU."""
    if dist.is_initialized():
        return
    from tf_operator_tpu_torch.parallel.distributed import backend_for

    kwargs = {}
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1, **kwargs)


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` named ``AXIS_ORDER`` over ``devices`` (ranks of
    the world; default all of them, in rank order), shaped by ``config``.

    ``device`` is the kind of device each rank drives: the card unless
    ``"cpu"``. Every rank of the world calls this, also one left out of
    ``devices`` (building a mesh makes process groups, which is
    collective)."""
    config = config or MeshConfig()
    device = resolve_device(device)
    ensure_process_group(device)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else list(devices)
    sizes = config.resolve(len(ranks))
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    if ranks == list(range(world)):
        return init_device_mesh(device.type, shape,
                                mesh_dim_names=AXIS_ORDER)
    return DeviceMesh(device.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXIS_ORDER)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis: size}, as JAX's ``dict(mesh.shape)``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along the mesh ``axis`` (its rank in
    ``mesh.get_group(axis)``, the sub-mesh's process group)."""
    return mesh.get_local_rank(axis)


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes a [batch, ...] input's leading dim shards over."""
    return tuple(a for a in ("dcn", "dp", "fsdp") if a in mesh.mesh_dim_names)


def data_parallel_size(mesh: DeviceMesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in data_axes(mesh))


def batch_placements(mesh: DeviceMesh) -> List[Placement]:
    """Placements of a [batch, ...] tensor: dim 0 over the data axes,
    replicated over the others (JAX's ``Trainer.batch_shardings``)."""
    batch = data_axes(mesh)
    return [Shard(0) if name in batch else Replicate()
            for name in mesh.mesh_dim_names]


def data_index(mesh: DeviceMesh) -> int:
    """This rank's position along the data axes (row-major over
    ``data_axes``): which slice of a [batch, ...] input it holds."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    names, index = mesh.mesh_dim_names, 0
    for axis in data_axes(mesh):
        i = names.index(axis)
        index = index * mesh.size(i) + coord[i]
    return index


def all_reduce_mean(x: torch.Tensor, mesh: DeviceMesh,
                    axes: Sequence[str]) -> torch.Tensor:
    """Mean of ``x`` over the mesh ``axes`` (a new tensor; gloo has no
    AVG, so a SUM over each axis' group, then one division)."""
    x = x.detach().clone()
    count = 1
    for axis in axes:
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        if size > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
            count *= size
    return x / count if count > 1 else x


class _GroupSum(torch.autograd.Function):
    """A sum over a process group whose backward sums the gradients too:
    every rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def data_sum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` summed over the mesh's data axes, differentiably (a batch
    statistic of a sharded batch)."""
    for axis in data_axes(mesh):
        if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
            x = _GroupSum.apply(x, mesh.get_group(axis))
    return x


def mesh_axis_size(tensor: torch.Tensor, axis: str) -> int:
    """Into how many shards the mesh ``axis`` splits ``tensor``: 1 for a
    plain tensor or a DTensor replicated over that axis."""
    if not isinstance(tensor, DTensor):
        return 1
    mesh = tensor.device_mesh
    names = mesh.mesh_dim_names or ()
    return math.prod(mesh.size(i) for i, (name, p)
                     in enumerate(zip(names, tensor.placements))
                     if name == axis and p.is_shard())
