"""Single-device training harness (port of train/trainer.py).

The loss, the optimizer and the step follow the JAX trainer's formulas:
``cross_entropy_loss`` in f32, ``lm_loss`` on shifted tokens,
``classification_loss`` (BatchNorm statistics updated by the forward, as
the JAX loss threads ``extra_vars``) and its frozen-statistics variant, and
an optimizer that clips by global norm as ``optax.clip_by_global_norm``
does, then steps ``torch.optim.AdamW`` (or SGD with optax's momentum
trace) at a learning rate read from a schedule at the pre-increment count
(so the first update of a warmup schedule uses ``schedule(0)``), as
optax's ``scale_by_learning_rate`` does.

Unlike the JAX trainer the state is updated in place: the step mutates
the model's parameters and the optimizer's moments rather than returning
new arrays. ``TrainState.state_dict``/``load_state_dict`` carry the step,
the parameters, the model's buffers (BatchNorm statistics, the JAX state's
``extra_vars``) and the optimizer's state (AdamW's per-parameter ``step``
and both moments, SGD's momentum buffers) for ``train/checkpoint.py``.

With a ``mesh`` (``parallel/mesh.py``), ``init`` places the model by a
rule table (``parallel/sharding.py`` ``shard_model``: tensor parallel
over ``tp``, FSDP2 over ``fsdp``, replicas over ``dcn``/``dp``), each
step trains on this rank's slice of the batch over the data axes, and the
``loss`` metric is the mean over them, as the JAX trainer's global loss
is. FSDP2 averages the slices' gradients. A batch with a ``mask`` gets a
``mask_count`` (``slice_mask_count``), which ``lm_loss`` divides by, so
that a masked loss trains on the global masked mean and not on the mean
of the slices' means. The step's forward and backward run under
``use_mesh(mesh)``, where a Mixtral MoE layer routes over every slice's
tokens (``models/mixtral.py``), so that its capacity, priority and aux
loss are those of the global batch. Gradients are then DTensors; their
global norm is reduced to one scalar over every shard before the clip.
The state dict holds DTensors, which ``train/checkpoint.py`` saves shard
by shard and restores into any mesh, or none. On a mesh with ``sp`` (a
model with ``attention_impl="ring"``/``"ring_flash"``) the step is the
same: the ``sp`` ranks take the same batch, and the ring inside the model
leaves each of them whole, equal gradients, so nothing is reduced over
``sp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.checkpoint.state_dict import (
    get_model_state_dict,
    get_optimizer_state_dict,
    set_model_state_dict,
    set_optimizer_state_dict,
)

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.parallel import mesh as mesh_lib
from tf_operator_tpu_torch.train.data import local_batch, prefetch_to_device


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       mask_count: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean next-token NLL; logits in any dtype, loss in f32; integer
    targets of any width. A masked sum is divided by ``mask_count``, by
    default the mask's own count (at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long().unsqueeze(-1)).squeeze(-1)
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        if mask_count is None:
            mask_count = mask.sum().clamp_min(1.0)
        return (nll * mask).sum() / mask_count
    return nll.mean()


def lm_loss(model: nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]. A
    ``mask_count`` in the batch is what the masked sum divides by (the
    trainer sets it on a mesh)."""
    tokens = batch["inputs"]
    logits = model(tokens[:, :-1])
    return cross_entropy_loss(logits, tokens[:, 1:], batch.get("mask"),
                              batch.get("mask_count"))


def slice_mask_count(mask: torch.Tensor, mesh) -> torch.Tensor:
    """What each data-parallel slice divides its masked loss sum by: the
    global mask count (at least 1) over the number of slices. FSDP2
    averages the slices' gradients and the ``loss`` metric is the slices'
    mean, so both come out as those of the global masked mean, as in the
    JAX trainer, however unevenly the mask falls on the slices."""
    axes = mesh_lib.data_axes(mesh)
    return mesh_lib.all_reduce_mean(mask.float().sum(), mesh, axes
                                    ).clamp_min(
        1.0 / mesh_lib.data_parallel_size(mesh))


def classification_loss(model: nn.Module,
                        batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Image/feature classification: NLL of ``labels`` under the logits of
    ``inputs``. A model with BatchNorm layers in training mode normalises
    with the batch and updates its running statistics in this forward (the
    JAX loss returns them as the new ``extra_vars``)."""
    return cross_entropy_loss(model(batch["inputs"]), batch["labels"])


def classification_loss_frozen_stats(model: nn.Module,
                                     batch: Dict[str, torch.Tensor]
                                     ) -> torch.Tensor:
    """Classification normalising with the *running* statistics, which
    stay as they are (the model's ``update_stats=False`` path: no
    batch-statistics reductions); the parameters still train. The building
    block of interval statistics: one ``classification_loss`` step every N,
    frozen steps between. Needs a model whose forward takes
    ``update_stats`` (models/resnet.py)."""
    return cross_entropy_loss(model(batch["inputs"], update_stats=False),
                              batch["labels"])


# ---------------------------------------------------------------------------
# Optimizer (optax formulas over torch.optim)
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (total, warmup included)."""
    alpha = end_value / peak_value if peak_value else 0.0
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = count / warmup_steps
            return init_value + (peak_value - init_value) * frac
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).

    DTensor gradients (a sharded model's, on meshes of one or more
    dimensions) count each element once: each shard's sum of squares is
    summed over the mesh dimensions that shard it (not those that
    replicate it), one all-reduce for each mesh and dimension, and the
    result is a plain scalar, the same on every rank."""
    if not any(isinstance(g, DTensor) for g in grads):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    by_layout: Dict[tuple, List[torch.Tensor]] = {}
    for g in grads:
        if isinstance(g, DTensor):
            mesh = g.device_mesh
            if any(p.is_partial() for p in g.placements):
                g = g.redistribute(mesh, [Replicate() if p.is_partial()
                                          else p for p in g.placements])
            dims = tuple(i for i, p in enumerate(g.placements)
                         if not p.is_replicate() and mesh.size(i) > 1)
            key, local = (mesh, dims), g.to_local()
        else:
            key, local = (None, ()), g
        by_layout.setdefault(key, []).append(
            torch.linalg.vector_norm(local.float()) ** 2)
    total = []
    for (mesh, dims), squares in by_layout.items():
        part = torch.stack(squares).sum()
        for i in dims:
            dist.all_reduce(part, group=mesh.get_group(i))
        total.append(part)
    return torch.stack(total).sum().sqrt()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place ``g * max_norm / max(norm, max_norm)`` (optax's formula);
    returns the norm before clipping. DTensors are scaled shard by
    shard."""
    if norm is None:
        norm = global_norm(grads)
    factor = max_norm / torch.clamp_min(norm, max_norm)
    torch._foreach_mul_([_local(g) for g in grads], factor)
    return norm


@dataclasses.dataclass
class Optimizer:
    """An optional global-norm clip, then ``make(params)``'s
    ``torch.optim`` step at ``schedule(count)`` when a schedule is given."""

    make: Callable[[List[nn.Parameter]], torch.optim.Optimizer]
    schedule: Optional[Callable[[int], float]] = None
    max_grad_norm: Optional[float] = None

    def apply(self, opt: torch.optim.Optimizer, count: int,
              grad_norm: bool = False,
              norm_fn: Callable[[List[torch.Tensor]], torch.Tensor]
              = global_norm) -> Optional[torch.Tensor]:
        """One update from the parameters' ``.grad`` at update ``count``
        (0 for the first); returns the pre-clip global norm (``norm_fn``
        of the gradients) when clipping or when ``grad_norm`` asks for
        it."""
        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        norm = None
        if self.max_grad_norm is not None or grad_norm:
            norm = norm_fn(grads)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm, norm)
        if self.schedule is not None:
            for group in opt.param_groups:
                group["lr"] = self.schedule(count)
        opt.step()
        return norm


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    """optax.adamw at its defaults: a constant learning rate."""
    return Optimizer(make=lambda params: torch.optim.AdamW(
        params, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """optax.adam: a constant learning rate, no weight decay."""
    return Optimizer(make=lambda params: torch.optim.Adam(
        params, lr=learning_rate, betas=(b1, b2), eps=eps))


def sgd(learning_rate: float, momentum: Optional[float] = None) -> Optimizer:
    """optax.sgd: with ``momentum`` a trace m = g + momentum·m from zero,
    then p -= learning_rate·m; no dampening, no Nesterov, no weight decay
    (``torch.optim.SGD`` computes exactly that: its first buffer is g)."""
    return Optimizer(make=lambda params: torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum or 0.0, dampening=0.0,
        nesterov=False, weight_decay=0.0))


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000,
                      max_grad_norm: float = 1.0) -> Optimizer:
    """clip_by_global_norm then adamw(b1=.9, b2=.95) on warmup-cosine."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return Optimizer(
        make=lambda params: torch.optim.AdamW(
            params, lr=schedule(0), betas=(0.9, 0.95), eps=1e-8,
            weight_decay=weight_decay),
        schedule=schedule, max_grad_norm=max_grad_norm)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        """The step, the parameters and persistent buffers (BatchNorm
        statistics), and the optimizer's state, keyed by name. The tensors
        are the live ones (no copy), so a load into this dict is a load in
        place. An optimizer that has not stepped yet gets its state made
        first, so that a fresh state can be the target of a restore:
        torch.distributed.checkpoint takes a step at learning rate 0 over
        zero gradients (the parameters stay as they are), and its count is
        set back to 0, which is the state a first step would have made."""
        fresh = not self.opt_state.state
        optim = get_optimizer_state_dict(self.model, self.opt_state)
        if fresh:
            for per_param in self.opt_state.state.values():
                if torch.is_tensor(per_param.get("step")):
                    per_param["step"].zero_()
        return {"step": self.step,
                "model": get_model_state_dict(self.model),
                "optim": optim}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        set_model_state_dict(self.model, state["model"])
        set_optimizer_state_dict(self.model, self.opt_state, state["optim"])
        self.step = int(state["step"])


@dataclasses.dataclass
class Trainer:
    """init + train step for (model, optimizer) on one device, or on this
    rank's device of a ``mesh``.

    ``device`` defaults to the card; the model is moved there if its
    parameters are elsewhere. With a ``mesh``, ``rules`` and
    ``param_axes_fn`` (the model's ``param_logical_axes``) place the model
    at ``init`` (module docstring); every rank builds the model from the
    same seed first, so a sharded run starts from the unsharded one's
    weights. Without one, nothing is sharded."""

    model: nn.Module
    optimizer: Optimizer
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor] = lm_loss
    device: DeviceLike = None
    # grad_norm in the step metrics costs a read of every gradient.
    grad_norm_metric: bool = True
    mesh: Any = None                # torch DeviceMesh (parallel/mesh.py)
    rules: Optional[Dict[str, Any]] = None
    param_axes_fn: Optional[Callable] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model.to(self.device)
        if self.mesh is not None and (self.rules is None
                                      or self.param_axes_fn is None):
            raise ValueError("a mesh needs rules and param_axes_fn")

    def init(self) -> TrainState:
        if self.mesh is not None and not any(
                isinstance(p, DTensor) for p in self.model.parameters()):
            from tf_operator_tpu_torch.parallel.sharding import shard_model

            shard_model(self.model, self.mesh, self.rules,
                        self.param_axes_fn)
        params = [p for p in self.model.parameters() if p.requires_grad]
        return TrainState(step=0, model=self.model,
                          opt_state=self.optimizer.make(params))

    def _to_device(self, batch: Dict[str, Any],
                   batch_dim: int = 0) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            batch = local_batch(batch, self.mesh, batch_dim)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def make_train_step(self, steps_per_call: int = 1,
                        stacked_batches: bool = False):
        """step(state, batch) -> (state, metrics). Metrics are ``loss``
        and ``grad_norm`` as 0-d device tensors (reading them waits for
        the card) and ``step``, the count before this update.

        ``steps_per_call > 1`` makes one call take that many updates, as
        the JAX step's ``lax.scan`` does, and return the last one's
        metrics (so ``step`` is the last inner pre-increment count). With
        ``stacked_batches`` the batch then has a leading ``steps_per_call``
        axis, one slice an update; without, every update takes the same
        batch. In eager mode the updates are a loop of separate
        dispatches."""
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{steps_per_call}")

        def one_step(state: TrainState, batch: Dict[str, torch.Tensor]):
            state.model.train()
            state.opt_state.zero_grad(set_to_none=True)
            if self.mesh is not None and "mask" in batch:
                batch = {**batch, "mask_count": slice_mask_count(
                    batch["mask"], self.mesh)}
            # The backward's remat recompute routes over the mesh too.
            with (mesh_lib.use_mesh(self.mesh) if self.mesh is not None
                  else contextlib.nullcontext()):
                loss = self.loss_fn(state.model, batch)
                loss.backward()
            norm = self.optimizer.apply(state.opt_state, state.step,
                                        self.grad_norm_metric)
            loss = loss.detach()
            if self.mesh is not None:
                loss = mesh_lib.all_reduce_mean(
                    loss, self.mesh, mesh_lib.data_axes(self.mesh))
            metrics = {"loss": loss, "step": state.step}
            if self.grad_norm_metric:
                metrics["grad_norm"] = norm
            state.step += 1
            return state, metrics

        stacked = stacked_batches and steps_per_call > 1

        def step(state: TrainState, batch: Dict[str, Any]):
            batch = self._to_device(batch, batch_dim=1 if stacked else 0)
            for k in range(steps_per_call):
                inner = batch
                if stacked:
                    inner = {name: v[k] for name, v in batch.items()}
                state, metrics = one_step(state, inner)
            return state, metrics

        return step


def run_train_steps(step_fn, state, batch_iter: Iterator, num_steps: int,
                    start_step: int = 0, ckpt_hook=None,
                    on_metrics: Optional[Callable] = None,
                    prefetch_device: DeviceLike = None,
                    prefetch_depth: int = 2):
    """Drive ``num_steps`` steps, calling ``on_metrics(step, metrics)`` and
    ``ckpt_hook.after_step(step, state)`` (train/checkpoint.py
    ``CheckpointHook``) after each, with ``step`` counted from
    ``start_step`` (the restored step) as a plain int.

    ``prefetch_device`` (the JAX loop's ``prefetch_sharding``, on one
    device) copies each batch to that device ``prefetch_depth`` batches
    ahead on a side stream (train/data.py ``prefetch_to_device``), so the
    copy of batch N+1 overlaps step N. Off by default: the batches then
    reach the step as the iterator yields them."""
    if prefetch_device is not None:
        batch_iter = prefetch_to_device(batch_iter, prefetch_device,
                                        depth=prefetch_depth)
    step = start_step
    for _ in range(num_steps):
        state, step_metrics = step_fn(state, next(batch_iter))
        step += 1
        if on_metrics is not None:
            on_metrics(step, step_metrics)
        if ckpt_hook is not None:
            ckpt_hook.after_step(step, state)
    return state
