"""Mixtral-family MoE decoder (port of models/mixtral.py).

Token-choice top-k routing with capacity over a batched expert FFN, on
the Llama attention stack (``models/llama.py``: ``LlamaAttention`` and
``RMSNorm``, with the flash kernels where they take the shapes). Two
routing implementations, selected by ``MixtralConfig.dispatch``, with the
same drops, outputs, gradients and aux loss:

- ``"einsum"``: GShard one-hot [T, E, C] dispatch and combine tensors
  contracted by dense einsums;
- ``"gather"``: a stable argsort of the (token, slot) assignments by
  expert, a row gather into the same capacity-packed [E, C, H] buffer and
  a weighted inverse-permutation scatter to combine.

The same cast points as the flax model: the router and its softmax in
f32, dispatch/combine in the activations' dtype, the expert input summed
in f32 and cast to ``cfg.dtype``, f32 expert parameters cast to
``cfg.dtype`` at each call, the output cast back to the input's dtype.
The gather path sums its weighted rows in f32, as the einsum path's
matmul accumulates them (JAX sums them in the activations' dtype).

Capacity and priority are those of the whole batch, as in the JAX model,
whose MoE layer sees the global array. Under a data-parallel mesh
(``parallel.mesh.use_mesh``, which the ``Trainer`` enters for its step)
each rank holds a slice of the batch, so the layer gathers every slice's
per-expert assignment counts (one small all-gather): the capacity counts
every slice's tokens, an assignment ranks behind those of earlier slices,
and the aux loss's routed fractions are the global ones. Each rank's
``dropped_assignments`` is then its slice's count.

Expert parallelism (``parallel/sharding.py`` ``MOE_RULES``): the expert
tensors are DTensors over the (ep, tp) mesh, the expert dim over ``ep`` and
the expert ``mlp`` dim over ``tp``. ``ep`` is not a data axis, so every ep
rank routes the same tokens the same way; each runs its own experts on
its rows of the [E, C, H] buffer, and the outputs are gathered over ep and
summed over tp before the combine. Both boundaries are DTensor
redistributions, so their backward is the transposed collective (a
gradient summed over the ranks that share an input, none added to a
replicated one).

``dropped_assignments``: JAX sows the count into ``intermediates``; here
each ``MoELayer`` keeps it as a 0-d tensor attribute after every forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.models.llama import (  # noqa: F401 (re-export)
    Dense,
    LlamaAttention,
    LlamaConfig,
    RMSNorm,
    init_cache,
    insert_cache,
)
from tf_operator_tpu_torch.ops.layers import Init, build_scope, new_param
from tf_operator_tpu_torch.parallel import mesh as mesh_lib

DISPATCHES = ("einsum", "gather")


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    # "einsum" | "gather" (module docstring).
    dispatch: str = "einsum"
    aux_loss_weight: float = 0.02
    max_seq_len: int = 8192
    rope_theta: float = 1000000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attention_impl: str = ""
    # Incremental decode (the serving path): attention reads and writes its
    # KV cache as the Llama model's does, and routing is drop-free.
    decode: bool = False

    def attention_config(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden=self.hidden,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            mlp_dim=self.mlp_dim, max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta, dtype=self.dtype, remat=self.remat,
            attention_impl=self.attention_impl, decode=self.decode)


def mixtral_8x7b() -> MixtralConfig:
    return MixtralConfig()


def mixtral_tiny(vocab_size: int = 256, max_seq_len: int = 128
                 ) -> MixtralConfig:
    return MixtralConfig(vocab_size=vocab_size, hidden=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, head_dim=16, mlp_dim=128,
                         n_experts=4, experts_per_token=2,
                         max_seq_len=max_seq_len, rope_theta=10000.0,
                         remat=False)


# ---------------------------------------------------------------------------
# Routing across data slices
# ---------------------------------------------------------------------------

def _slice_counts(counts: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """([slices, E] per-expert assignment counts of every data slice of the
    active mesh, in data order; this rank's slice index). One slice, this
    rank's own, without a data-parallel mesh."""
    mesh = mesh_lib.active_mesh()
    if mesh is None or mesh_lib.data_parallel_size(mesh) == 1:
        return counts[None], 0
    axes = mesh_lib.data_axes(mesh)
    every = DTensor.from_local(counts[None], mesh[axes],
                               [Shard(0)] * len(axes),
                               run_check=False).full_tensor()
    return every, mesh_lib.data_index(mesh)


def _aux_loss(probs: torch.Tensor, kept: torch.Tensor, n_tokens: int,
              e: int, k: int) -> torch.Tensor:
    """Load-balancing aux loss (Switch/GShard): E * sum_e f_e * P_e / k.

    f counts only assignments that landed a capacity slot: ``kept`` per
    expert over the whole batch of ``n_tokens`` tokens. P is this slice's
    mean router probability, so the mean over data slices is the global
    loss, gradient included (f carries none)."""
    f = kept.float() / n_tokens
    p = probs.mean(dim=0)
    return e * (f * p).sum() / k


def _einsum_route(xt, top_idx, top_probs, capacity, offset, expert_ffn,
                  cfg):
    """GShard one-hot dispatch: [T, E, C] routing tensors + dense einsums.
    ``offset`` [E]: assignments of earlier data slices per expert."""
    t, h = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    x_dtype = xt.dtype

    # For each (token, slot) assignment, its rank among the earlier
    # assignments (token-major, slot-minor) choosing the same expert.
    expert_onehot = F.one_hot(top_idx, e)                    # [T, K, E]
    flat_assign = expert_onehot.reshape(t * k, e)
    position = flat_assign.cumsum(dim=0) - flat_assign
    position = (position * flat_assign).sum(dim=-1).reshape(t, k)
    within_capacity = position + offset[top_idx] < capacity   # [T, K]

    slots = torch.arange(capacity, device=xt.device)
    pos_onehot = (position[..., None] == slots).to(x_dtype)   # [T, K, C]
    disp = (expert_onehot.to(x_dtype)[..., None]
            * pos_onehot[:, :, None, :]
            * within_capacity.to(x_dtype)[:, :, None, None])  # [T,K,E,C]
    dispatch = disp.sum(dim=1)                                # [T, E, C]
    combine = (disp * top_probs.to(x_dtype)[:, :, None, None]).sum(dim=1)

    expert_in = torch.einsum("tec,th->ech", dispatch.float(),
                             xt.float()).to(cfg.dtype)        # [E, C, H]
    expert_out = expert_ffn(expert_in)                        # [E, C, H]
    dtype = torch.promote_types(combine.dtype, expert_out.dtype)
    y = torch.einsum("tec,ech->th", combine.to(dtype), expert_out.to(dtype))
    return y, within_capacity


def _gather_route(xt, top_idx, top_probs, capacity, offset, expert_ffn,
                  cfg):
    """Sort/gather dispatch: a stable argsort of the assignments by expert
    keeps the einsum path's token-major priority, so the same assignments
    drop; rows are gathered into the capacity-packed [E, C, H] buffer
    (an over-capacity row lands in a spare row that is sliced away) and
    combined through the inverse permutation."""
    t, h = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    tk = t * k

    flat_expert = top_idx.reshape(tk)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = torch.bincount(flat_expert, minlength=e)
    seg_start = counts.cumsum(dim=0) - counts
    pos_sorted = (torch.arange(tk, device=xt.device)
                  - seg_start[sorted_expert])
    keep = pos_sorted + offset[sorted_expert] < capacity
    slot = sorted_expert * capacity + pos_sorted
    src_tok = torch.div(order, k, rounding_mode="floor")

    spare = e * capacity
    gathered = xt[src_tok].to(cfg.dtype)                      # [T*K, H]
    expert_in = xt.new_zeros((spare + 1, h), dtype=cfg.dtype).index_put(
        (torch.where(keep, slot, spare),), gathered)[:spare]
    expert_out = expert_ffn(expert_in.reshape(e, capacity, h))

    out_rows = expert_out.reshape(spare, h)[torch.where(keep, slot, 0)]
    w = top_probs.reshape(tk)[order].to(xt.dtype)
    contrib = out_rows.float() * torch.where(keep, w, 0).float()[:, None]
    unsorted = contrib.new_zeros((tk, h)).index_put((order,), contrib)
    y = unsorted.reshape(t, k, h).sum(dim=1).to(
        torch.promote_types(xt.dtype, expert_out.dtype))

    within_capacity = torch.zeros(tk, dtype=torch.bool,
                                  device=xt.device).index_put(
        (order,), keep).reshape(t, k)
    return y, within_capacity


# ---------------------------------------------------------------------------
# Expert parallelism: the two boundaries of the sharded expert FFN
# ---------------------------------------------------------------------------

def _local_expert_rows(expert_in: torch.Tensor, mesh) -> torch.Tensor:
    """This (ep, tp) rank's experts' rows of the replicated [E, C, H]
    buffer. Backward: the rows' gradients are gathered over ep and summed
    over tp (each tp rank's holds its share of the mlp columns)."""
    x = DTensor.from_local(expert_in, mesh, [Replicate(), Replicate()],
                           run_check=False)
    return x.redistribute(mesh, [Shard(0), Replicate()]).to_local(
        grad_placements=[Shard(0), Partial()])


def _all_expert_rows(expert_out: torch.Tensor, mesh) -> torch.Tensor:
    """The whole [E, C, H] output from each rank's rows, partial sums over
    tp: gathered over ep, summed over tp. Backward: each rank takes its
    rows of the replicated gradient."""
    return DTensor.from_local(expert_out, mesh, [Shard(0), Partial()],
                              run_check=False).full_tensor()


class MoELayer(nn.Module):
    """Token-choice top-k routing with capacity; returns (y, aux)."""

    def __init__(self, cfg: MixtralConfig, device, generator):
        super().__init__()
        if cfg.dispatch not in DISPATCHES:
            raise ValueError(f"MixtralConfig.dispatch must be 'einsum' or "
                             f"'gather', got {cfg.dispatch!r}")
        self.cfg = cfg
        e, h, m = cfg.n_experts, cfg.hidden, cfg.mlp_dim
        self.router = Dense(h, e, torch.float32, device, generator)
        for name, shape in (("w_gate", (e, h, m)), ("w_up", (e, h, m)),
                            ("w_down", (e, m, h))):
            # flax lecun_normal's fan-in over a [E, in, out] tensor: E * in.
            new_param(self, name, shape,
                      Init(std=(shape[0] * shape[1]) ** -0.5), device,
                      generator)
        # Assignments over capacity in the last forward (0-d int tensor).
        self.dropped_assignments: Optional[torch.Tensor] = None

    def _expert_ffn(self, expert_in: torch.Tensor) -> torch.Tensor:
        """Batched expert FFNs [E, C, H] -> [E, C, H]; on an (ep, tp) mesh
        (module docstring) each rank runs its shard."""
        dtype = self.cfg.dtype
        weights = (self.w_gate, self.w_up, self.w_down)
        mesh = (self.w_gate.device_mesh
                if isinstance(self.w_gate, DTensor) else None)
        if mesh is not None:
            expert_in = _local_expert_rows(expert_in, mesh)
            weights = tuple(w.to_local() for w in weights)
        w_gate, w_up, w_down = (w.to(dtype) for w in weights)
        gate = torch.einsum("ech,ehm->ecm", expert_in, w_gate)
        up = torch.einsum("ech,ehm->ecm", expert_in, w_up)
        out = torch.einsum("ecm,emh->ech", F.silu(gate) * up, w_down)
        if mesh is not None:
            out = _all_expert_rows(out, mesh)
        return out

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, h = x.shape
        t = b * s
        e, k = cfg.n_experts, cfg.experts_per_token
        xt = x.reshape(t, h)
        probs = torch.softmax(self.router(xt.float()), dim=-1)   # [T, E]
        top_probs, top_idx = torch.topk(probs, k)                  # [T, K]
        top_probs = top_probs / top_probs.sum(
            dim=-1, keepdim=True).clamp_min(1e-9)

        every, index = _slice_counts(torch.bincount(top_idx.reshape(-1),
                                                    minlength=e))
        n_tokens = t * every.shape[0]
        capacity = max(k, int(n_tokens * k * cfg.capacity_factor / e))
        if cfg.decode:
            # Inference never drops: at capacity T*K no expert overflows,
            # so decode reproduces a drop-free full forward.
            capacity = n_tokens * k
        before = every.cumsum(dim=0) - every        # earlier slices' counts
        route = _gather_route if cfg.dispatch == "gather" else _einsum_route
        y, within_capacity = route(xt, top_idx, top_probs, capacity,
                                   before[index], self._expert_ffn, cfg)
        self.dropped_assignments = (~within_capacity).sum().detach()
        kept = torch.minimum(every, (capacity - before).clamp_min(0)).sum(0)
        aux = _aux_loss(probs, kept, n_tokens, e, k)
        return y.reshape(b, s, h).to(x.dtype), aux


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig, device, generator):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden, device)
        self.attn = LlamaAttention(cfg.attention_config(), device, generator)
        self.mlp_norm = RMSNorm(cfg.hidden, device)
        self.moe = MoELayer(cfg, device, generator)

    def forward(self, x: torch.Tensor, angles: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x + self.attn(self.attn_norm(x), angles, positions, cache)
        moe_out, aux = self.moe(self.mlp_norm(x))
        return x + moe_out, aux


class Mixtral(nn.Module):
    """Token ids [B, S] -> (logits [B, S, vocab] in ``cfg.dtype``, the
    layers' mean aux loss).

    Parameters are made on ``device`` (the card unless ``device="cpu"``)
    from ``generator`` (one on ``device``), by default one seeded with 0;
    on ``device="meta"`` they are drawn later, as ``Llama``'s. Remat is the plain ``full`` checkpoint of each block (the JAX model's
    ``nn.remat``). In decode mode ``positions`` and ``cache`` are
    required, as for ``Llama``."""

    def __init__(self, cfg: MixtralConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        llama._check_config(cfg.attention_config())
        self.cfg = cfg
        device = resolve_device(device)
        with build_scope(self, device, generator) as gen:
            self.embed_tokens = llama.embedding(cfg.vocab_size, cfg.hidden,
                                                device, gen)
            self.layers = nn.ModuleList(
                MixtralBlock(cfg, device, gen) for _ in range(cfg.n_layers))
            self.final_norm = RMSNorm(cfg.hidden, device)
            self.lm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype,
                                 device, gen)
            llama.rope_angles(self, cfg, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.decode and positions is None:
            raise ValueError("decode mode requires positions")
        if cfg.decode and cache is None:
            raise ValueError("decode mode requires a cache (init_cache)")
        x = self.embed_tokens(tokens).to(cfg.dtype)
        remat = cfg.remat and not cfg.decode and torch.is_grad_enabled()
        auxes = []
        for i, block in enumerate(self.layers):
            if cfg.decode:
                x, aux = block(x, self.angles, positions,
                               (cache["k"][i], cache["v"][i]))
            elif remat:
                x, aux = checkpoint(block, x, self.angles, positions,
                                    use_reentrant=False)
            else:
                x, aux = block(x, self.angles, positions)
            auxes.append(aux)
        logits = self.lm_head(self.final_norm(x))
        return logits, torch.stack(auxes).mean()


# ---------------------------------------------------------------------------
# Incremental decode: the Llama helper contract (init_cache and
# insert_cache are Llama's, re-exported above); every forward returns
# (logits, aux) and the helpers drop the aux loss.
# ---------------------------------------------------------------------------

def prefill(model: Mixtral, cache: Dict[str, torch.Tensor],
            tokens: torch.Tensor, positions: torch.Tensor):
    """One incremental-decode forward: (logits, the updated cache)."""
    if not model.cfg.decode:
        raise ValueError("prefill/decode_step need a decode=True model")
    with torch.no_grad():
        logits, _aux = model(tokens, positions=positions, cache=cache)
    return logits, cache


def decode_step(model: Mixtral, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor):
    """One token per row: ``prefill`` at S = 1."""
    return prefill(model, cache, tokens, positions)


# ---------------------------------------------------------------------------
# Logical axes (parallel/sharding.py MOE_RULES) and the loss
# ---------------------------------------------------------------------------

# The JAX model's _MOE_LEAF_AXES without its scan's leading "layers" axis;
# the router is a Dense, so [out, in] where the flax kernel is [in, out].
_MOE_LEAF_AXES = {
    ("router", "weight"): (None, "embed"),
    ("w_gate",): ("expert", "embed", "mlp"),
    ("w_up",): ("expert", "embed", "mlp"),
    ("w_down",): ("expert", "mlp", "embed"),
}


def param_logical_axes(name: str, value: torch.Tensor
                       ) -> Tuple[Optional[str], ...]:
    """Mixtral logical axes: the MoE parameters, then the Llama mapping."""
    path = tuple(name.split("."))
    for suffix, axes in _MOE_LEAF_AXES.items():
        if path[-len(suffix):] == suffix:
            if len(axes) != value.dim():
                raise ValueError(f"no logical axes for MoE param {name} "
                                 f"shape {tuple(value.shape)}")
            return axes
    return llama.param_logical_axes(name, value)


def make_moe_lm_loss(aux_loss_weight: float = 0.02):
    """LM loss + weighted load-balancing aux loss, as ``Trainer``'s
    ``loss_fn(model, batch)``; a ``mask`` (and the trainer's
    ``mask_count``) as in ``lm_loss``."""
    from tf_operator_tpu_torch.train.trainer import cross_entropy_loss

    def moe_lm_loss(model: nn.Module,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens = batch["inputs"]
        logits, aux = model(tokens[:, :-1])
        ce = cross_entropy_loss(logits, tokens[:, 1:], batch.get("mask"),
                                batch.get("mask_count"))
        return ce + aux * aux_loss_weight

    return moe_lm_loss
