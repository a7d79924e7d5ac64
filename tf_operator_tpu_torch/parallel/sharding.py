"""Logical-axis sharding rules (port of parallel/sharding.py) and their
placement of a model on a mesh.

The rule tables are the JAX package's: a parameter is annotated with
logical axis names ("embed", "heads", "mlp", ...) by its model's
``param_logical_axes``, and a table maps each logical axis to mesh axes.
``spec_for`` turns one parameter's logical axes into a DTensor placement
per mesh dimension (``AXIS_ORDER``), the counterpart of a JAX
``PartitionSpec``.

``shard_model`` places a model by those placements:
- ``tp``: megatron tensor parallelism. A projection whose weight shards
  over ``tp`` gets ``_place_projection``: its weight becomes a DTensor
  on the ``tp`` dimension, sharded on the weight dim the rule names
  (``[out, in]``: heads/kv_heads/mlp/vocab on dim 0, the column-parallel
  projections; wo/down on dim 1, the row-parallel ones; an embedding's
  vocab on dim 0). Inputs and outputs stay local tensors, as the body of a
  JAX ``shard_map`` sees them: a column-parallel projection returns its
  shard of the features (the attention then works on its local heads),
  a row-parallel one all-reduces its partial sums. A biased projection
  (BERT's) keeps its bias with it: split with a column-parallel
  projection's output features, whole on a row-parallel one and added
  once, after the sum (the JAX rules replicate every bias and GSPMD
  slices it against the sharded activation). Logits (features on
  ``vocab``) are all-gathered, so the f32 loss sees every class; so is the
  output of a projection whose ``heads`` tp does not divide (Llama's KV
  projections where tp divides the query heads but not the KV heads: each
  rank then takes the KV heads its query heads read, ``models/llama.py``).
- ``fsdp``: ``fully_shard`` (FSDP2) over the ``fsdp`` dimension, each
  block of a ``ModuleList`` (the layers) a unit of its own, then the
  root. FSDP2 shards every parameter's dim 0 whatever dim the rule names;
  it gathers the parameter before use, so the numbers do not change.
- ``ep`` (``MOE_RULES``): a parameter of any other module that shards
  over ``ep`` or ``tp`` (the Mixtral expert tensors: the expert dim over
  ``ep``, the expert ``mlp`` dim over ``tp``) becomes a DTensor on the
  (ep, tp) mesh, and the module computes on its local shard
  (``models/mixtral.py``). ``ep`` is not a data axis: its ranks see the
  same batch.
- ``dcn``/``dp``: replicated, as HSDP: ``fully_shard`` on the 2-D mesh
  (``dcn`` x ``dp`` flattened, ``fsdp``), which all-reduces gradients
  over the replicas and reduce-scatters them within one.
The batch is sharded over (dcn, dp, fsdp) by the trainer.

Sharded from birth (the JAX trainer's ``jit(init, out_shardings=...)``):
a model built on the meta device (``Llama(cfg, device="meta")``, which
records its initialisers, ``ops/layers.py``) is placed by ``shard_model``
with nothing allocated, and ``materialize`` then gives each rank storage
for its own shards only and fills them from today's draws: each
initialiser, in the build's order, draws the whole parameter on the
device, keeps this rank's piece and frees the rest before the next one.
A rank's peak is its shards and one whole parameter, and the values are
bit for bit those of the eager build from the same seed. With
``draw=False`` it only allocates (and computes the non-persistent
buffers): the restore target, the counterpart of the JAX package's
``abstract_state_with_shardings``.

Parameters are replicated over ``sp`` and ``pp``. ``sp`` is no data axis:
its ranks see the same batch and run ring attention on their blocks of
the sequence (``ops/ring_attention.py``), each computing whole and equal
gradients. Under ``pp`` the pipeline trainer (``parallel/llama_pp.py``)
gives each rank its own stage and places nothing here.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_module,
    distribute_tensor,
)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset,
)
from torch.distributed.tensor.placement_types import Placement

from tf_operator_tpu_torch.models.llama import Dense
from tf_operator_tpu_torch.ops.layers import InitRecord, is_meta
from tf_operator_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_shape

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]

# Dense transformer (Llama/BERT family), megatron TP + FSDP:
# - embed dim sharded over fsdp (ZeRO-3 gather on use)
# - attention heads + ffn hidden sharded over tp
# - vocab sharded over tp (output projection all-gather)
LLAMA_RULES: Rules = {
    "batch": ("dcn", "dp", "fsdp"),
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "seq": "sp",
    "kv_seq": None,
    "layers": None,
    "norm": None,
}

# MoE (Mixtral family): experts sharded over ep, expert-internal mlp over tp.
MOE_RULES: Rules = {
    **LLAMA_RULES,
    "expert": "ep",
    "capacity": None,
}

# Conv/vision nets (ResNet): pure data parallel; params replicated.
CNN_RULES: Rules = {
    "batch": ("dcn", "dp", "fsdp"),
}

# Output feature axes whose activations are all-gathered after their
# projection: the logits leave the model whole.
GATHERED_AXES = ("vocab",)
# The mesh axes that split a model's parameters (not its batch).
MODEL_AXES = ("ep", "tp")

ParamAxesFn = Callable[[str, torch.Tensor], Tuple[Optional[str], ...]]


def spec_for(logical_axes: Sequence[Optional[str]], rules: Rules,
             axis_names: Sequence[str] = AXIS_ORDER) -> List[Placement]:
    """One placement per mesh dimension (``axis_names``): ``Shard(d)``
    where the rule maps tensor dim d's logical axis to that mesh axis,
    else ``Replicate()`` (JAX's ``spec_for`` as a DTensor placement
    list)."""
    placements: List[Placement] = [Replicate()] * len(axis_names)
    for dim, name in enumerate(logical_axes):
        axes = rules.get(name) if name is not None else None
        for axis in (axes,) if isinstance(axes, str) else axes or ():
            i = list(axis_names).index(axis)
            if placements[i].is_shard():
                raise ValueError(f"mesh axis {axis!r} shards two dims of "
                                 f"{tuple(logical_axes)}")
            placements[i] = Shard(dim)
    return placements


def _place_projection(module: nn.Module, tp_mesh: DeviceMesh,
                      weight_dim: int, gather_output: bool,
                      partial_grad: bool = False) -> None:
    """Tensor parallelism for a projection with one weight: the port's
    ``Dense`` (``[out, in]``, ``x @ W^T``) or an ``nn.Embedding``
    (``[vocab, embed]``). ``weight_dim`` is the weight dim split over
    ``tp_mesh`` (module docstring); inputs and outputs are local tensors,
    the output gathered whole where ``gather_output``. A ``Dense`` bias
    splits with a column-parallel projection's output features and stays
    whole on a row-parallel one, where it is added after the sum; either
    way its gradient comes out whole and equal on every tp rank. A
    gathered output that every rank uses alike (the logits) gets the same
    gradient on every rank; with ``partial_grad`` each rank uses its own part of it (Llama's
    KV heads), so its gradients are summed over tp."""
    embedding = isinstance(module, nn.Embedding)
    if not isinstance(module, (Dense, nn.Embedding)) or (
            embedding and weight_dim != 0) or weight_dim not in (0, 1):
        raise NotImplementedError(
            f"no tensor-parallel placement of {type(module).__name__} "
            f"on weight dim {weight_dim}")
    # Column-parallel Dense: replicated input, features split on output.
    # Row-parallel Dense: input split on its features, output partial
    # sums. Vocab-split embedding: replicated ids, partial rows.
    column = weight_dim == 0 and not embedding
    in_layout = Replicate() if weight_dim == 0 else Shard(-1)

    def partition(name, mod, mesh):
        if mod is module:
            mod.register_parameter("weight", nn.Parameter(
                distribute_tensor(mod.weight, mesh, [Shard(weight_dim)])))
            if getattr(mod, "bias", None) is not None:
                # Column-parallel: split with the output features.
                # Row-parallel: whole, added once after the tp sum
                # (Dense.forward).
                mod.register_parameter("bias", nn.Parameter(
                    distribute_tensor(mod.bias, mesh,
                                      [Shard(0) if column else Replicate()])))

    def prepare_input(mod, inputs, mesh):
        x, *rest = inputs
        if isinstance(x, DTensor):
            raise TypeError(f"{type(mod).__name__} under tensor "
                            f"parallelism takes local tensors")
        return (DTensor.from_local(x, mesh, [in_layout], run_check=False),
                *rest)

    def prepare_output(mod, out, mesh):
        if not column or gather_output:
            out = out.redistribute(mesh, [Replicate()])
        return out.to_local(grad_placements=[Partial()] if partial_grad
                            else None)

    distribute_module(module, tp_mesh, partition, prepare_input,
                      prepare_output)


def _fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 2-D (replicas, shards) mesh of HSDP: (dp, fsdp), with dcn x dp
    flattened into the replicas where dcn > 1."""
    if mesh_shape(mesh)["dcn"] == 1:
        return mesh[("dp", "fsdp")]
    flat = "dcn_dp"
    try:
        mesh[("dcn", "dp")]._flatten(flat)
    except (RuntimeError, ValueError, KeyError):
        pass    # flattened already (another model on this mesh)
    return mesh[(flat, "fsdp")]


def _model_placements(name: str, param: torch.Tensor, rules: Rules,
                      param_axes_fn: ParamAxesFn
                      ) -> Tuple[List[Placement], tuple]:
    """The parameter's placements on the (ep, tp) dimensions, and its
    logical axes."""
    axes = tuple(param_axes_fn(name, param))
    if len(axes) != param.dim():
        raise ValueError(f"{name}: logical axes {axes} for a "
                         f"{param.dim()}-d parameter")
    placements = spec_for(axes, rules)
    return [placements[AXIS_ORDER.index(a)] for a in MODEL_AXES], axes


def shard_model(model: nn.Module, mesh: DeviceMesh, rules: Rules,
                param_axes_fn: ParamAxesFn) -> nn.Module:
    """Place ``model`` on ``mesh`` by ``rules`` (module docstring), in
    place; returns it. The model is built the same on every rank, on this
    rank's device or on the meta device (then ``materialize`` it after).
    ``param_axes_fn(name, param)`` gives a parameter's logical axes by its
    ``named_parameters`` name."""
    from torch.distributed.fsdp import fully_shard

    shape = mesh_shape(mesh)
    model_mesh = mesh[MODEL_AXES]
    for prefix, module in list(model.named_modules()):
        split = {}
        for pname, param in module.named_parameters(recurse=False):
            name = f"{prefix}.{pname}" if prefix else pname
            placements, axes = _model_placements(name, param, rules,
                                                 param_axes_fn)
            for axis, placement in zip(MODEL_AXES, placements):
                if placement.is_shard() and (
                        param.shape[placement.dim] % shape[axis]):
                    raise ValueError(
                        f"{name}: dim {placement.dim} of "
                        f"{tuple(param.shape)} does not split over "
                        f"{axis}={shape[axis]}")
            if any(p.is_shard() for p in placements):
                split[pname] = (placements, axes)
        if not split:
            continue
        if not isinstance(module, (Dense, nn.Embedding)):
            for pname, (placements, _) in split.items():
                module.register_parameter(pname, nn.Parameter(
                    distribute_tensor(getattr(module, pname), model_mesh,
                                      placements)))
            continue
        if set(split) != {"weight"} or split["weight"][0][0].is_shard():
            raise NotImplementedError(
                f"{prefix}: no placement of {type(module).__name__} "
                f"parameters {sorted(split)} over ep/tp")
        (_, tp), axes = split["weight"]
        heads = getattr(module, "heads", None)
        split_heads = heads is not None and heads % shape["tp"] != 0
        _place_projection(module, mesh["tp"], tp.dim,
                          gather_output=axes[0] in GATHERED_AXES
                          or split_heads, partial_grad=split_heads)
    dp_mesh = _fsdp_mesh(mesh)
    for module in model.modules():
        if isinstance(module, nn.ModuleList):
            for block in module:
                fully_shard(block, mesh=dp_mesh)
    fully_shard(model, mesh=dp_mesh)
    return model


def _local_piece_(param: DTensor, whole: torch.Tensor) -> None:
    """Copy this rank's piece of ``whole`` into ``param``'s local shard:
    the block that DCP saves and loads for it, a view of ``whole`` (no
    copy of it is made, where ``distribute_tensor`` would copy a strided
    shard's chunks twice over)."""
    shape, offset = compute_local_shape_and_global_offset(
        param.shape, param.device_mesh, param.placements)
    local = param.to_local()
    if tuple(local.shape) != tuple(shape):
        raise ValueError(f"a local shard of {tuple(local.shape)} where its "
                         f"placements {param.placements} give {shape}")
    local.copy_(whole[tuple(slice(o, o + n)
                            for o, n in zip(offset, shape))])


def materialize(model: nn.Module, device, draw: bool = True) -> nn.Module:
    """Give a model built on the meta device (placed by ``shard_model``
    or not) storage for this rank's shards on ``device``, in place, and
    with ``draw`` their first values (module docstring); returns it.

    The values replay the build's record (``model.init_record``) in its
    order from the generator the build was given, else one seeded 0 on
    ``device``: a DTensor parameter is drawn whole, this rank's piece of it
    copied into its local shard (a local slice, no collective) and the
    whole freed; a plain tensor is filled in place; a draw of a module
    the model no longer holds (``LlamaStage``'s other stages) is made and
    dropped, so that every later draw is the eager build's. Without ``draw`` only the
    non-persistent buffers, which no checkpoint holds, get values. A
    parameter or buffer with no recorded initialiser raises before
    anything is allocated."""
    record: Optional[InitRecord] = getattr(model, "init_record", None)
    if record is None or not is_meta(model):
        raise ValueError("materialize needs a model built on the meta "
                         "device and not yet materialised")
    recorded = {(id(m), name) for m, name, _ in record.entries}
    missing = [f"{prefix}.{name}" if prefix else name
               for prefix, module in model.named_modules()
               for name, t in itertools.chain(module._parameters.items(),
                                              module._buffers.items())
               if t is not None and (id(module), name) not in recorded]
    if missing:
        raise ValueError(f"no recorded initialiser for {missing}: build "
                         f"the model's tensors with ops.layers.init_")
    device = torch.device(device)
    model.to_empty(device=device)
    held = {id(m) for m in model.modules()}
    gen = record.generator or torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for module, name, init in record.entries:
            t = getattr(module, name)
            if not draw:
                if (id(module) in held
                        and name in module._non_persistent_buffers_set):
                    init.fill_(t, None)
                continue
            if id(module) not in held:
                if init.draws:
                    init.fill_(torch.empty(t.shape, dtype=t.dtype,
                                           device=device), gen)
                continue
            if not isinstance(t, DTensor):
                init.fill_(t, gen)
                continue
            whole = torch.empty(t.shape, dtype=t.dtype, device=device)
            init.fill_(whole, gen)
            _local_piece_(t, whole)
            del whole
    model.init_record = None
    return model
