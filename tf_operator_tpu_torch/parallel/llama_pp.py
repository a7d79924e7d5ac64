"""Pipeline-parallel training of the Llama decoder (port of
``tf_operator_tpu/parallel/llama_pp.py``).

The JAX model stacks its blocks on a leading [L] axis and re-stages them
as [pp, L/pp]; the port's layers are a ``ModuleList``, and a stage is
``LlamaStage``: the ``L/pp`` consecutive layers of one pp rank, keyed by
their index in the whole model (so a stage's ``state_dict`` names are the
``Llama``'s), with the embedding, final norm and head on every stage, as
the JAX trainer replicates them. Stage 0 embeds, each stage runs its
layers, the last applies final norm, head and loss
(``parallel/pipeline.py`` ``pipeline_lm_train_sharded``); the embedding's
and head's gradients are summed over the stages, so every copy gets the
same update.

``LlamaPipelineTrainer`` is the ``Trainer``-shaped wrapper: each pp rank
builds and optimises its own stage, and a step takes the global
[B, T+1] token batch (B over the data axes). ``schedule="auto"`` takes
one GPipe loss-and-gradient evaluation on a sample batch on the card,
reads its peak memory (``torch.cuda.max_memory_allocated``) and keeps
GPipe where that fits the card's memory (``select_schedule``), else
1F1B; on the CPU the budget is unknown and GPipe is kept, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.llama import (
    Dense,
    LlamaBlock,
    LlamaConfig,
    RMSNorm,
    _check_config,
)
from tf_operator_tpu_torch.ops.layers import rope_frequencies
from tf_operator_tpu_torch.parallel.pipeline import (
    Pipe,
    pipeline_lm_train_gpipe,
    pipeline_lm_train_sharded,
    select_schedule,
)
from tf_operator_tpu_torch.train.trainer import (
    Optimizer,
    TrainState,
    cross_entropy_loss,
)


def split_stage_params(layers: Sequence[nn.Module], pp: int
                       ) -> List[nn.ModuleDict]:
    """The model's L layers -> pp stages of L/pp consecutive layers, each
    keyed by its index in the model."""
    if len(layers) % pp:
        raise ValueError(f"n_layers {len(layers)} not divisible by pp={pp}")
    per = len(layers) // pp
    return [nn.ModuleDict({str(i): layers[i]
                           for i in range(s * per, (s + 1) * per)})
            for s in range(pp)]


def merge_stage_params(stages: Sequence[nn.ModuleDict]) -> nn.ModuleList:
    """pp stages -> the model's ``ModuleList`` of L layers."""
    merged = {int(i): layer for stage in stages
              for i, layer in stage.items()}
    return nn.ModuleList(merged[i] for i in range(len(merged)))


class LlamaStage(nn.Module):
    """One pipeline stage of the Llama (module docstring), made from
    ``generator`` in the whole model's order: the layers of other stages
    are drawn and dropped one at a time, so the stage's weights are the
    ``Llama``'s of the same seed and no more than one other layer is held."""

    def __init__(self, cfg: LlamaConfig, stage: int = 0, stages: int = 1,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        if cfg.n_layers % stages:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                             f"pp={stages}")
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(0)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden,
                                         device=device)
        nn.init.normal_(self.embed_tokens.weight, std=cfg.hidden ** -0.5,
                        generator=gen)
        per = cfg.n_layers // stages
        own = range(stage * per, (stage + 1) * per)
        layers = {}
        for i in range(cfg.n_layers):
            block = LlamaBlock(cfg, device, gen)
            if i in own:
                layers[str(i)] = block
            del block
        self.layers = nn.ModuleDict(layers)
        self.final_norm = RMSNorm(cfg.hidden, device)
        self.lm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, device,
                             gen)
        self.register_buffer(
            "angles", rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                       cfg.rope_theta, device=device),
            persistent=False)

    def head(self) -> nn.ModuleDict:
        """The loss head's modules (final norm and ``lm_head``)."""
        return nn.ModuleDict({"final_norm": self.final_norm,
                              "lm_head": self.lm_head})


def llama_pp_loss_and_grads(model: LlamaStage, tokens: torch.Tensor, mesh,
                            num_microbatches: int, axis_name: str = "pp",
                            schedule: str = "1f1b"
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One pipeline-parallel LM loss and gradient evaluation of this
    rank's stage: ``tokens`` is the global [B, T+1] next-token batch on
    the stage's device (B over the data axes). Returns (mean loss,
    gradients by the stage's parameter names)."""
    cfg = model.cfg

    def stage_fn(layers, x):
        for block in layers.values():
            x = block(x, model.angles)
        return x

    def embed_fn(embed, tok_mb):
        return embed(tok_mb).to(cfg.dtype)

    def loss_fn(y, t_mb, head):
        return cross_entropy_loss(head["lm_head"](head["final_norm"](y)),
                                  t_mb)

    trains = {"1f1b": pipeline_lm_train_sharded,
              "gpipe": pipeline_lm_train_gpipe}
    if schedule not in trains:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    loss, sgrads, egrads, hgrads = trains[schedule](
        stage_fn, loss_fn, embed_fn, model.layers, model.embed_tokens,
        model.head(), tokens[:, :-1], tokens[:, 1:], mesh, num_microbatches,
        axis_name=axis_name)
    grads = {**{f"layers.{n}": g for n, g in sgrads.items()},
             **{f"embed_tokens.{n}": g for n, g in egrads.items()},
             **{n: g for n, g in hgrads.items()}}
    return loss, grads


class LlamaPipelineTrainer:
    """init + train step of one pipeline stage (module docstring), the
    counterpart of ``train.trainer.Trainer``: ``init()`` gives a
    ``TrainState`` of this rank's ``LlamaStage`` (its ``state_dict`` is what
    ``train/checkpoint.py`` saves, each stage its own layers), and
    ``make_train_step`` a ``step(state, tokens) -> (state, metrics)``.

    ``schedule``: "gpipe", "1f1b" or "auto"; ``resolved_schedule`` holds
    the choice after ``make_train_step``. ``memory_budget_bytes`` replaces
    the card's memory as the budget of "auto"."""

    def __init__(self, cfg: LlamaConfig, mesh, optimizer: Optimizer,
                 num_microbatches: int, axis_name: str = "pp",
                 schedule: str = "auto",
                 memory_budget_bytes: Optional[int] = None,
                 device: DeviceLike = None):
        if schedule not in ("auto", "gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.optimizer = optimizer
        self.num_microbatches = num_microbatches
        self.axis_name = axis_name
        self.pipe = Pipe.of_mesh(mesh, axis_name)
        self.schedule = schedule
        self.memory_budget_bytes = memory_budget_bytes
        self.device = resolve_device(device)
        self.resolved_schedule: Optional[str] = (
            schedule if schedule != "auto" else None)
        # Probe of "auto": (GPipe peak bytes, budget bytes).
        self.probe: Tuple[Optional[int], Optional[int]] = (None, None)

    def init(self, generator: Optional[torch.Generator] = None,
             state_dict: Optional[Dict[str, torch.Tensor]] = None
             ) -> TrainState:
        """This rank's stage from ``generator`` (default: seed 0 on the
        device), then, given the whole model's ``state_dict`` (a
        ``Llama``'s names), its own entries of it."""
        model = LlamaStage(self.cfg, self.pipe.stage, self.pipe.stages,
                           self.device, generator)
        if state_dict is not None:
            own = model.state_dict()
            model.load_state_dict({n: state_dict[n] for n in own})
        return TrainState(step=0, model=model,
                          opt_state=self.optimizer.make(
                              list(model.parameters())))

    def _local_tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device)

    def _loss_and_grads(self, model, tokens, schedule):
        return llama_pp_loss_and_grads(model, tokens, self.mesh,
                                       self.num_microbatches,
                                       self.axis_name, schedule)

    def _memory_budget(self) -> Optional[int]:
        if self.memory_budget_bytes is not None:
            return self.memory_budget_bytes
        if self.device.type == "cuda":
            return torch.cuda.mem_get_info(self.device)[1]
        return None     # the CPU reports no limit: unbounded

    def _probe_gpipe(self, model, sample_tokens) -> Optional[int]:
        """Peak bytes of one GPipe loss-and-gradient evaluation (no
        update), or None where the device reports no peak."""
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        loss, grads = self._loss_and_grads(
            model, self._local_tokens(sample_tokens), "gpipe")
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        del loss, grads
        return peak

    def _global_norm(self, model: LlamaStage):
        """The norm over every stage: this stage's layers summed over the
        pp group, the embedding's and head's (the same on every stage)
        once."""
        layers = {id(p) for p in model.layers.parameters()}

        def norm(_grads):
            own = torch.zeros((), dtype=torch.float32, device=self.device)
            shared = torch.zeros_like(own)
            for p in model.parameters():
                if p.grad is None:
                    continue
                sq = torch.linalg.vector_norm(p.grad.float()) ** 2
                if id(p) in layers:
                    own = own + sq
                else:
                    shared = shared + sq
            return (self.pipe.sum(own) + shared).sqrt()

        return norm

    def make_train_step(self, state: TrainState, sample_tokens=None):
        """``step(state, tokens) -> (state, metrics)``; metrics are
        ``loss`` and ``grad_norm`` as 0-d tensors and ``step``, the
        count before the update. "auto" needs ``sample_tokens`` (a batch
        of the step's shape) to probe GPipe's peak; without it, or with no
        peak to read, the choice fails safe (``select_schedule``)."""
        chosen = self.schedule
        if chosen == "auto":
            budget = self._memory_budget()
            peak = None
            if sample_tokens is not None and budget is not None:
                peak = self._probe_gpipe(state.model, sample_tokens)
            self.probe = (peak, budget)
            chosen = select_schedule(peak, budget)
        self.resolved_schedule = chosen

        def step(state: TrainState, tokens):
            state.model.train()
            state.opt_state.zero_grad(set_to_none=True)
            loss, grads = self._loss_and_grads(
                state.model, self._local_tokens(tokens), chosen)
            for name, p in state.model.named_parameters():
                p.grad = grads[name]
            norm = self.optimizer.apply(state.opt_state, state.step, True,
                                        self._global_norm(state.model))
            metrics = {"loss": loss, "grad_norm": norm, "step": state.step}
            state.step += 1
            return state, metrics

        return step
