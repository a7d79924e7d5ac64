"""Pipeline parallelism over the ``pp`` mesh axis (port of
``tf_operator_tpu/parallel/pipeline.py``).

Each rank of the ``pp`` axis holds one *stage* (a contiguous chunk of
layers) and runs only that stage. Activations go forward and cotangents
backward as point-to-point sends on the ``pp`` group (``Pipe``); a tick in
which a stage has no microbatch computes nothing (the JAX schedules run a
masked compute in lock step there; the results are the same).

Eager autograd does not cross processes, so the training schedules take
their gradients explicitly (``torch.autograd.grad``) and return them, as
the JAX functions return theirs:

- **GPipe** (``pipeline_train_gpipe``): stage s runs microbatch j's
  forward at tick s + j (m + pp - 1 ticks) and keeps its autograd graph
  (O(m) microbatches of activations); the backward then runs the
  microbatches in reverse, the cotangent handed back one stage a tick.
- **1F1B** (``pipeline_train_1f1b``): stage s runs j's forward at tick
  s + j (no graph kept) and its recompute-backward at tick
  2(pp-1) - s + j (``tick_plan``). The stash holds stage *inputs* only, in
  a ring of depth 2·pp, so at most O(pp) microbatches are live whatever
  m is. The last stage's forward slot is its backward slot's microbatch in
  the same tick, so it runs the stage once there; at pp = 1 the schedule
  is the plain step. Only the scalar loss crosses stages at the end.

Either returns (loss, this stage's gradients, aux): the mean loss and the
head's gradients summed over the stages (they live on the last one), and
on request d(loss)/d(microbatches), valid on stage 0, so the caller closes
the chain through an embedding. ``pipeline_lm_train_sharded`` (1F1B) and
``pipeline_lm_train_gpipe`` compose embedding, trunk and loss head for a
language model, and average over the data axes.

``pipeline_apply``/``pipeline_sharded`` are GPipe's forward alone (the
outputs, gathered to every stage); across processes they do not carry a
gradient: train through the schedules above.

Parameters (``Params``) are an ``nn.Module`` or a dict of tensors; the
gradients come back as a dict by parameter name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from tf_operator_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    axis_index,
    data_axes,
    data_parallel_size,
    mesh_shape,
)

Params = Union[nn.Module, Dict[str, torch.Tensor]]
# stage_fn(stage_params, x) -> y of x's shape and dtype (residual-stream
# style), applied by every pp rank to its own stage.
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]
# loss_fn(y, targets[, head_params]) -> scalar mean loss of a microbatch.
LossFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Pipe:
    """This rank's place in the pipeline: its ``stage`` of ``stages``, and
    the process group the stages share (None for one stage)."""

    stage: int = 0
    stages: int = 1
    group: Optional[dist.ProcessGroup] = None

    @classmethod
    def of_mesh(cls, mesh, axis: str = "pp") -> "Pipe":
        if mesh is None:
            return cls()
        stages = mesh_shape(mesh)[axis]
        if stages == 1:
            return cls()
        return cls(axis_index(mesh, axis), stages, mesh.get_group(axis))

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def exchange(self, send_next=None, send_prev=None, recv_prev=None,
                 recv_next=None) -> Tuple[Optional[torch.Tensor], ...]:
        """One tick's handoffs, posted together: ``send_next`` goes to
        stage + 1 and ``send_prev`` to stage - 1; a tensor shaped like
        ``recv_prev`` (``recv_next``) comes from stage - 1 (+ 1). Returns
        (from_prev, from_next), None where nothing was asked."""
        ops, got = [], [None, None]
        peer = lambda s: dist.get_global_rank(self.group, s)
        for t, s in ((send_next, self.stage + 1), (send_prev,
                                                   self.stage - 1)):
            if t is not None:
                ops.append(dist.P2POp(dist.isend, t.contiguous(), peer(s),
                                      self.group))
        for i, (like, s) in enumerate(((recv_prev, self.stage - 1),
                                       (recv_next, self.stage + 1))):
            if like is not None:
                got[i] = torch.empty_like(like)
                ops.append(dist.P2POp(dist.irecv, got[i], peer(s),
                                      self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return tuple(got)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the stages (``x`` itself at one stage)."""
        if self.stages > 1:
            x = x.detach().clone()
            dist.all_reduce(x, group=self.group)
        return x


def split_microbatches(x: torch.Tensor, num_microbatches: int
                       ) -> torch.Tensor:
    """[B, ...] -> [m, B/m, ...] (leading microbatch axis)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         f"microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def merge_microbatches(x: torch.Tensor) -> torch.Tensor:
    """[m, B/m, ...] -> [B, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def stack_stage_params(per_stage: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """[stage0, stage1, ...] dicts -> one dict with a leading [pp] axis on
    every tensor (the JAX package's stacked layout)."""
    return {name: torch.stack([p[name] for p in per_stage])
            for name in per_stage[0]}


def _differentiable(params: Optional[Params]
                    ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(what stage_fn/loss_fn get, the tensors to differentiate by name).
    A module's parameters are used as they are; a dict's tensors that do
    not require grad are replaced by grad-requiring views."""
    if params is None:
        return None, {}
    if isinstance(params, nn.Module):
        return params, dict(params.named_parameters())
    ready = {n: t if t.requires_grad else t.detach().requires_grad_()
             for n, t in params.items()}
    return ready, ready


def tick_plan(stage: int, stages: int, m: int
              ) -> List[Tuple[Optional[int], Optional[int]]]:
    """1F1B: per tick, (the microbatch ``stage`` runs forward, the one it
    runs backward), None for an idle slot; m + 2(stages - 1) ticks."""
    plan = []
    for t in range(m + 2 * (stages - 1)):
        fj, bj = t - stage, t - 2 * (stages - 1) + stage
        plan.append((fj if 0 <= fj < m else None,
                     bj if 0 <= bj < m else None))
    return plan


class _Accumulator:
    """Per-microbatch gradients of the stage (and head, on every stage:
    the last one's are summed over the stages) added up, as the JAX
    schedules add them, then divided by m."""

    def __init__(self, stage: Dict[str, torch.Tensor],
                 head: Dict[str, torch.Tensor]):
        self.stage = {n: torch.zeros_like(t) for n, t in stage.items()}
        self.head = {n: torch.zeros_like(t) for n, t in head.items()}

    def add(self, stage: Dict[str, Optional[torch.Tensor]],
            head: Dict[str, Optional[torch.Tensor]]) -> None:
        for into, grads in ((self.stage, stage), (self.head, head)):
            for name, g in grads.items():
                if g is not None:
                    into[name] += g


def _backward(outs, gouts, stage_leaves, head_leaves, x, want_dx):
    """One microbatch's gradients: (stage, head, dx) by autograd."""
    wrt = list(stage_leaves.values()) + list(head_leaves.values())
    if want_dx:
        wrt.append(x)
    grads = torch.autograd.grad(outs, wrt, gouts, allow_unused=True)
    n = len(stage_leaves)
    stage = dict(zip(stage_leaves, grads[:n]))
    head = dict(zip(head_leaves, grads[n:n + len(head_leaves)]))
    return stage, head, grads[-1] if want_dx else None


def _finish(pipe, acc, loss_sum, m, dmb, input_grads, with_head):
    loss = pipe.sum(loss_sum / m)
    grads = {n: g.div_(m) for n, g in acc.stage.items()}
    aux = {"head_grads": ({n: pipe.sum(g.div_(m))
                           for n, g in acc.head.items()}
                          if with_head else None),
           "input_grads": dmb.div_(m) if input_grads else None}
    return loss, grads, aux


def pipeline_train_1f1b(stage_fn: StageFn, loss_fn: LossFn,
                        stage_params: Params, microbatches: torch.Tensor,
                        targets: torch.Tensor, pipe: Pipe,
                        head_params: Optional[Params] = None,
                        input_grads: bool = False):
    """The fused 1F1B schedule on this rank's stage (module docstring).

    ``microbatches`` [m, mb, ...] are stage 0's inputs (the other stages
    read only their shape and dtype); ``targets`` [m, ...] are read by the
    last stage, whose ``loss_fn(y, targets[j], head_params)`` (or
    ``loss_fn(y, targets[j])`` without ``head_params``) gives each
    microbatch's loss. Returns (mean loss, stage grads, aux) with aux
    ``head_grads`` (summed over the stages) and ``input_grads`` (f32
    [m, mb, ...], valid on stage 0) where asked for."""
    m, s, last = microbatches.shape[0], pipe.stage, pipe.last
    stage_p, stage_leaves = _differentiable(stage_params)
    head_p, head_leaves = _differentiable(head_params)
    want_dx = s > 0 or input_grads
    acc = _Accumulator(stage_leaves, head_leaves)
    dmb = torch.zeros(microbatches.shape, dtype=torch.float32,
                      device=microbatches.device) if input_grads else None
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    depth = 2 * pipe.stages
    stash: List[Optional[torch.Tensor]] = [None] * depth
    template = microbatches[0]
    plan = tick_plan(s, pipe.stages, m)
    fwd_in = bwd_in = None
    for t, (fj, bj) in enumerate(plan):
        y = dx = None
        if fj is not None:
            x = microbatches[fj] if s == 0 else fwd_in
            stash[fj % depth] = x
            if not last:
                with torch.no_grad():
                    y = stage_fn(stage_p, x)
        if bj is not None:
            x = stash[bj % depth].detach().requires_grad_(want_dx)
            stash[bj % depth] = None
            with torch.enable_grad():
                y_re = stage_fn(stage_p, x)
                if last:
                    loss = (loss_fn(y_re, targets[bj], head_p)
                            if head_params is not None
                            else loss_fn(y_re, targets[bj]))
                    outs, gouts = [loss], None
                    loss_sum = loss_sum + loss.detach().float()
                else:
                    outs, gouts = [y_re], [bwd_in]
                g_stage, g_head, dx = _backward(
                    outs, gouts, stage_leaves,
                    head_leaves if last else {}, x, want_dx)
            acc.add(g_stage, g_head)
            if input_grads and s == 0:
                dmb[bj] = dx.float()
        nf, nb = plan[t + 1] if t + 1 < len(plan) else (None, None)
        fwd_in, bwd_in = pipe.exchange(
            send_next=y, send_prev=dx if s > 0 else None,
            recv_prev=template if nf is not None and s > 0 else None,
            recv_next=template if nb is not None and not last else None)
    return _finish(pipe, acc, loss_sum, m, dmb, input_grads,
                   head_params is not None)


def pipeline_train_gpipe(stage_fn: StageFn, loss_fn: LossFn,
                         stage_params: Params, microbatches: torch.Tensor,
                         targets: torch.Tensor, pipe: Pipe,
                         head_params: Optional[Params] = None,
                         input_grads: bool = False):
    """GPipe on this rank's stage: every microbatch forward with its graph
    kept, then every backward in reverse order. Same arguments and return
    as ``pipeline_train_1f1b``: no recompute and m + pp - 1 forward ticks,
    for an O(m) activation stash."""
    m, s, last = microbatches.shape[0], pipe.stage, pipe.last
    stage_p, stage_leaves = _differentiable(stage_params)
    head_p, head_leaves = _differentiable(head_params)
    want_dx = s > 0 or input_grads
    acc = _Accumulator(stage_leaves, head_leaves)
    dmb = torch.zeros(microbatches.shape, dtype=torch.float32,
                      device=microbatches.device) if input_grads else None
    template = microbatches[0]
    xs, outs = [], []
    with torch.enable_grad():
        for j in range(m):
            x = microbatches[j] if s == 0 else pipe.exchange(
                recv_prev=template)[0]
            x = x.detach().requires_grad_(want_dx)
            y = stage_fn(stage_p, x)
            if last:
                y = (loss_fn(y, targets[j], head_p) if head_params
                     is not None else loss_fn(y, targets[j]))
            else:
                pipe.exchange(send_next=y.detach())
            xs.append(x)
            outs.append(y)
    loss_sum = (torch.stack([o.detach().float() for o in outs]).sum()
                if last else torch.zeros((), device=microbatches.device))
    for j in reversed(range(m)):
        gouts = None if last else [pipe.exchange(recv_next=template)[1]]
        g_stage, g_head, dx = _backward(
            [outs[j]], gouts, stage_leaves, head_leaves if last else {},
            xs[j], want_dx)
        outs[j] = xs[j] = None
        acc.add(g_stage, g_head)
        if s > 0:
            pipe.exchange(send_prev=dx)
        elif input_grads:
            dmb[j] = dx.float()
    return _finish(pipe, acc, loss_sum, m, dmb, input_grads,
                   head_params is not None)


SCHEDULES = {"1f1b": pipeline_train_1f1b, "gpipe": pipeline_train_gpipe}


def pipeline_apply(stage_fn: StageFn, stage_params: Params,
                   microbatches: torch.Tensor, pipe: Pipe,
                   gather_output: bool = True) -> torch.Tensor:
    """GPipe's forward on this rank's stage: [m, mb, ...] inputs (stage
    0's) -> the last stage's [m, mb, ...] outputs, broadcast to every
    stage where ``gather_output`` (else zeros on the others)."""
    outputs = torch.zeros_like(microbatches)
    for j in range(microbatches.shape[0]):
        x = microbatches[j] if pipe.stage == 0 else pipe.exchange(
            recv_prev=microbatches[0])[0]
        y = stage_fn(stage_params, x)
        if pipe.last:
            outputs[j] = y
        else:
            pipe.exchange(send_next=y.detach())
    if gather_output and pipe.stages > 1:
        dist.broadcast(outputs, dist.get_global_rank(pipe.group,
                                                     pipe.stages - 1),
                       group=pipe.group)
    return outputs


def _local(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a global [B, ...] batch over the data axes."""
    from tf_operator_tpu_torch.train.data import local_batch

    return x if mesh is None else local_batch({"x": x}, mesh)["x"]


def pipeline_sharded(stage_fn: StageFn, stage_params: Params,
                     x: torch.Tensor, mesh, num_microbatches: int,
                     axis_name: str = "pp") -> torch.Tensor:
    """Global view: the global [B, ...] batch (B over the data axes) split
    into microbatches, GPipe's forward, this rank's [B/dp, ...] outputs."""
    mb = split_microbatches(_local(mesh, x), num_microbatches)
    return merge_microbatches(pipeline_apply(
        stage_fn, stage_params, mb, Pipe.of_mesh(mesh, axis_name)))


def _data_mean(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data axes (``x`` itself where they hold one
    replica)."""
    if mesh is None or data_parallel_size(mesh) == 1:
        return x
    return all_reduce_mean(x, mesh, data_axes(mesh))


def pipeline_train_sharded(stage_fn: StageFn, loss_fn: LossFn,
                           stage_params: Params, x: torch.Tensor,
                           targets: torch.Tensor, mesh,
                           num_microbatches: int, axis_name: str = "pp"):
    """Global-view 1F1B step of the trunk alone: (mean loss, this stage's
    gradients), both averaged over the data axes."""
    loss, grads, _ = pipeline_train_1f1b(
        stage_fn, loss_fn, stage_params,
        split_microbatches(_local(mesh, x), num_microbatches),
        split_microbatches(_local(mesh, targets), num_microbatches),
        Pipe.of_mesh(mesh, axis_name))
    return _data_mean(mesh, loss), {n: _data_mean(mesh, g)
                                    for n, g in grads.items()}


def _lm_train(schedule: str, stage_fn, loss_fn, embed_fn, stage_params,
              embed_params, head_params, inputs, targets, mesh,
              num_microbatches, axis_name):
    pipe = Pipe.of_mesh(mesh, axis_name)
    inp = split_microbatches(_local(mesh, inputs), num_microbatches)
    tgt = split_microbatches(_local(mesh, targets), num_microbatches)
    embed_p, embed_leaves = _differentiable(embed_params)
    # Stage 0 embeds with a graph, to close the chain; the others only
    # read the activations' shape and dtype.
    with torch.set_grad_enabled(pipe.stage == 0):
        x_mb = embed_fn(embed_p, inp)
    loss, sgrads, aux = SCHEDULES[schedule](
        stage_fn, loss_fn, stage_params, x_mb.detach(), tgt, pipe,
        head_params=head_params, input_grads=pipe.stage == 0)
    if pipe.stage == 0:
        egrads = dict(zip(embed_leaves, torch.autograd.grad(
            x_mb, list(embed_leaves.values()),
            aux["input_grads"].to(x_mb.dtype))))
    else:
        egrads = {n: torch.zeros_like(t) for n, t in embed_leaves.items()}
    egrads = {n: pipe.sum(g) for n, g in egrads.items()}
    mean = lambda d: {n: _data_mean(mesh, g) for n, g in d.items()}
    return (_data_mean(mesh, loss), mean(sgrads), mean(egrads),
            mean(aux["head_grads"]))


def pipeline_lm_train_sharded(stage_fn: StageFn, loss_fn: LossFn,
                              embed_fn, stage_params: Params,
                              embed_params: Params, head_params: Params,
                              inputs: torch.Tensor, targets: torch.Tensor,
                              mesh, num_microbatches: int,
                              axis_name: str = "pp"):
    """Language-model 1F1B step: ``embed_fn(embed_params, inputs_mb)`` on
    stage 0, the trunk over the stages, ``loss_fn(y, targets_mb,
    head_params)`` on the last. Global [B, ...] inputs and targets (B over
    the data axes). Returns (loss, stage grads, embed grads, head grads),
    the embedding's and head's the same on every stage, all averaged over
    the data axes."""
    return _lm_train("1f1b", stage_fn, loss_fn, embed_fn, stage_params,
                     embed_params, head_params, inputs, targets, mesh,
                     num_microbatches, axis_name)


def pipeline_lm_train_gpipe(stage_fn: StageFn, loss_fn: LossFn, embed_fn,
                            stage_params: Params, embed_params: Params,
                            head_params: Params, inputs: torch.Tensor,
                            targets: torch.Tensor, mesh,
                            num_microbatches: int, axis_name: str = "pp"):
    """GPipe counterpart of ``pipeline_lm_train_sharded``: the same
    contract, fewer ticks and no recompute, an O(m) activation stash."""
    return _lm_train("gpipe", stage_fn, loss_fn, embed_fn, stage_params,
                     embed_params, head_params, inputs, targets, mesh,
                     num_microbatches, axis_name)


# Activation-memory safety margin for schedule selection: a measured
# peak undercounts fragmentation and runtime buffers.
_SCHEDULE_MEM_SAFETY = 0.9


def select_schedule(gpipe_peak_bytes: Optional[int],
                    budget_bytes: Optional[int]) -> str:
    """GPipe when its peak fits the budget, else 1F1B (the JAX package's
    policy: GPipe is never slower where it fits; 1F1B's O(pp) stash is the
    memory ceiling's escape). Fail safe: a known budget with an unknown
    peak picks 1F1B; only an unknown budget defaults to GPipe."""
    if budget_bytes is None:
        return "gpipe"
    if gpipe_peak_bytes is None or gpipe_peak_bytes < 0:
        return "1f1b"
    if gpipe_peak_bytes <= budget_bytes * _SCHEDULE_MEM_SAFETY:
        return "gpipe"
    return "1f1b"
