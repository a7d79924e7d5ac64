"""Llama-family dense decoder (port of models/llama.py).

Same configuration fields, module names and cast points as the flax model:
f32 parameters with bf16 compute (a flax ``Dense(dtype=bf16)`` casts both
its input and its kernel, as ``Dense`` here does), RMSNorm and RoPE in f32,
f32 logits only in the loss. Where flax stacks the blocks with ``nn.scan``,
the layers here are an ``nn.ModuleList``; ``models/convert.py`` carries
weights between the two trees.

Remat policies, as the JAX model's ``remat_policy``:
- ``"full"`` wraps each block in ``torch.utils.checkpoint`` (as
  ``nn.remat`` does), so under training the attention forward kernel runs
  twice per layer and step;
- ``"save_attn"`` checkpoints the block selectively: the two outputs of the
  flash forward op (JAX's ``flash_out``/``flash_lse``) are saved, so the
  backward recomputes the rest of the block but not the kernel;
- ``"save_qkv"`` also saves the post-rope q/k/v (``checkpoint_name``);
- ``"mlp_only"`` checkpoints the MLP branch only (``LlamaBlockMlpRemat``).
Every policy keeps the same parameters and the same numbers. Off the flash
path the flash outputs do not exist, so ``"save_attn"`` saves nothing
(it is ``"full"``). ``decode=True`` is the serving path: attention reads
and writes a KV cache (``init_cache``/``prefill``/``decode_step``/
``insert_cache`` below) and launches no flash kernel, as in the JAX model.

``attention_impl="ring"``/``"ring_flash"`` run ring attention over the
``sp`` axis of the active mesh (``ops/ring_attention.py``; the Trainer runs
its step under ``use_mesh``), as the JAX model's ``shard_map`` does: every
``sp`` rank computes the whole sequence outside attention (RoPE included),
and the ring runs on its block, laid out by DTensor redistributions whose
gradients gather and slice. ``"ring"`` repeats GQA KV for the einsum ring;
``"ring_flash"`` reads the shared KV heads through the kernels.

Under tensor parallelism a rank works on its own heads. Where tp divides
``n_heads`` but not ``n_kv_heads``, the KV projections give every KV head
(``parallel/sharding.py`` gathers their output) and each rank keeps the KV
heads its query heads read (``_own_kv``). JAX repeats K/V to full heads and
runs the reference attention on the global heads there, because its
sharded kernel wrapper cannot split them; the port's heads are already
local, so its attention dispatches as anywhere else (the kernels on the
card) to the same result.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.ops.flash_attention import (
    CHECKPOINT_NAME_OP,
    FLASH_FWD_OP,
    attention_placements,
    best_attention,
    checkpoint_name,
)
from tf_operator_tpu_torch.ops.layers import (
    NEG_INF,
    ONES,
    ZEROS,
    Init,
    apply_rope,
    attention,
    build_scope,
    init_,
    new_buffer,
    new_param,
    repeat_kv,
    rms_norm,
    rope_frequencies,
)
from tf_operator_tpu_torch.parallel.mesh import active_mesh, mesh_axis_size


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "full" | "save_attn" | "save_qkv" | "mlp_only" (module docstring).
    remat_policy: str = "full"
    # "" = auto (CUDA kernels where they take the shapes, else the
    # reference); "flash" = force flash_attention; "xla" = the reference;
    # "ring" = the einsum ring over sp; "ring_flash" = the ring over the
    # flash kernels (both need an active mesh).
    attention_impl: str = ""
    # Incremental decode (the serving path, serve/runner.py): attention
    # reads and writes a KV cache instead of recomputing the prefix; the
    # forward then requires ``positions`` and ``cache``. Same parameters as
    # the training model; remat is bypassed.
    decode: bool = False


def llama_3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab_size: int = 256, max_seq_len: int = 128) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden=64, n_layers=2,
                       n_heads=4, n_kv_heads=2, head_dim=16, mlp_dim=128,
                       max_seq_len=max_seq_len, rope_theta=10000.0,
                       remat=False)


REMAT_POLICIES = ("full", "save_attn", "save_qkv", "mlp_only")

# The ops whose outputs a selective policy saves. Every checkpoint_name in
# the model names a post-rope q, k or v, so saving the op saves exactly
# JAX's attn_q/attn_k/attn_v.
_SAVED_OPS = {"save_attn": [FLASH_FWD_OP],
              "save_qkv": [FLASH_FWD_OP, CHECKPOINT_NAME_OP]}


ATTENTION_IMPLS = ("", "flash", "xla", "ring", "ring_flash")


def _check_config(cfg: LlamaConfig) -> None:
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"expected {' | '.join(REMAT_POLICIES)}")


class Dense(nn.Module):
    """Projection with f32 weight [out, in], computed in ``dtype``;
    bias-free unless ``bias`` (an f32 ``bias`` [out], zeros).

    As flax's ``nn.Dense``, the input, the weight and the bias are cast to
    ``dtype`` and the bias is added after the product. Under tensor
    parallelism (``parallel/sharding.py``) a row-parallel projection's
    product is a partial sum over tp: it is summed first, so that the
    replicated bias is added once."""

    def __init__(self, features_in: int, features_out: int,
                 dtype: torch.dtype, device, generator: torch.Generator,
                 heads: Optional[int] = None, bias: bool = False):
        super().__init__()
        self.dtype = dtype
        # The attention heads its output holds: where tp does not divide
        # them, tensor parallelism gathers the output whole
        # (parallel/sharding.py).
        self.heads = heads
        new_param(self, "weight", (features_out, features_in),
                  Init(std=features_in ** -0.5), device, generator)
        if bias:
            new_param(self, "bias", (features_out,), ZEROS, device)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is None:
            return y
        if isinstance(y, DTensor) and any(p.is_partial()
                                          for p in y.placements):
            y = y.redistribute(y.device_mesh,
                               [Replicate()] * y.device_mesh.ndim)
        return y + self.bias.to(self.dtype)


def embedding(vocab_size: int, hidden: int, device,
              generator: Optional[torch.Generator]) -> nn.Embedding:
    """The token embedding, normal with std hidden ** -0.5 (the flax
    models' embedding init)."""
    embed = nn.Embedding(vocab_size, hidden, device=device)
    init_(embed, "weight", Init(std=hidden ** -0.5), generator)
    return embed


def rope_angles(module: nn.Module, cfg, device) -> None:
    """The non-persistent ``angles`` buffer ([max_seq_len, head_dim / 2],
    ``rope_frequencies``) of a model with ``cfg``'s rotary fields."""
    new_buffer(module, "angles", (cfg.max_seq_len, cfg.head_dim // 2),
               Init(compute=functools.partial(
                   rope_frequencies, cfg.head_dim, cfg.max_seq_len,
                   cfg.rope_theta)), device, persistent=False)


class RMSNorm(nn.Module):
    def __init__(self, features: int, device):
        super().__init__()
        new_param(self, "scale", (features,), ONES, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        dense = lambda n_in, n_out: Dense(n_in, n_out, cfg.dtype, device,
                                          generator)
        self.wq = dense(cfg.hidden, cfg.n_heads * cfg.head_dim)
        kv = lambda: Dense(cfg.hidden, cfg.n_kv_heads * cfg.head_dim,
                           cfg.dtype, device, generator,
                           heads=cfg.n_kv_heads)
        self.wk = kv()
        self.wv = kv()
        self.wo = dense(cfg.n_heads * cfg.head_dim, cfg.hidden)

    def forward(self, x: torch.Tensor, angles: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        # Under tensor parallelism (parallel/sharding.py) the projections
        # return this rank's heads: n_heads // tp and n_kv_heads // tp, or
        # every KV head where tp does not divide them (module docstring).
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        n_heads, n_kv_heads = local_heads(cfg, q.shape[-1], k.shape[-1])
        q = q.view(b, s, n_heads, cfg.head_dim)
        k = k.view(b, s, n_kv_heads, cfg.head_dim)
        v = v.view(b, s, n_kv_heads, cfg.head_dim)
        q = apply_rope(q, angles, positions)
        k = apply_rope(k, angles, positions)
        whole_kv = n_kv_heads == cfg.n_kv_heads and n_heads < cfg.n_heads
        if whole_kv:
            if cfg.decode:
                raise ValueError(
                    f"decode under tensor parallelism needs tp to divide "
                    f"the {cfg.n_kv_heads} KV heads")
            k, v = _own_kv(k, v, _tp_rank(self.wq.weight) * n_heads,
                           n_heads, cfg.n_heads // cfg.n_kv_heads)
            n_kv_heads = k.shape[2]
        if cfg.decode:
            out = self._cached_attention(q, k, v, positions, *cache)
        else:
            # Saved under remat_policy="save_qkv" (JAX's attn_q/k/v). The
            # eager recompute still replays the QKV matmuls and rope that
            # feed them; JAX's partial evaluation drops those.
            q = checkpoint_name(q, "attn_q")
            k = checkpoint_name(k, "attn_k")
            v = checkpoint_name(v, "attn_v")
            group = n_heads // n_kv_heads
            if cfg.attention_impl in ("ring", "ring_flash"):
                if cfg.attention_impl == "ring":
                    k, v = repeat_kv(k, group), repeat_kv(v, group)
                out = _ring(q, k, v, cfg.attention_impl == "ring_flash")
            elif cfg.attention_impl == "xla":
                out = attention(q, repeat_kv(k, group), repeat_kv(v, group),
                                causal=True)
            else:
                out = best_attention(
                    q, k, v, causal=True,
                    force_flash=cfg.attention_impl == "flash")
        return self.wo(out.reshape(b, s, n_heads * cfg.head_dim))

    def _cached_attention(self, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, positions: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor
                          ) -> torch.Tensor:
        """Attention against this layer's KV cache ([B, max_seq_len,
        n_kv_heads, head_dim], updated in place).

        The new K/V land at rows [positions[:,0], positions[:,0]+S) and a
        row attends exactly the keys at positions <= its own, over the whole
        cache, as the JAX model's ``_cached_attention``: rows past a
        sequence's length are never attended before they are overwritten,
        so slot reuse and padded prefill are safe. The sums are those of
        ``ops.layers.attention`` (f32 scores and softmax, weights cast to
        ``cfg.dtype``), taken over the cache in its GQA layout: the query
        heads of one KV head are read as [B, S, Hkv, G, D], so no repeated
        copy of the cache is made."""
        cfg = self.cfg
        b, s, n_heads = q.shape[:3]
        n_kv_heads = k.shape[2]
        _write_rows(cache_k, k, positions)
        _write_rows(cache_v, v, positions)
        q = q.view(b, s, n_kv_heads, n_heads // n_kv_heads, cfg.head_dim)
        logits = torch.einsum("bshgd,bthd->bhgst", q.float(), cache_k.float())
        logits.mul_(cfg.head_dim ** -0.5)
        k_pos = torch.arange(cfg.max_seq_len, device=q.device)
        keep = _visible(k_pos, positions)                  # [B, S, T]
        logits.masked_fill_(~keep[:, None, None], NEG_INF)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhgst,bthd->bshgd", weights, cache_v)


def local_heads(cfg: LlamaConfig, q_features: int,
                kv_features: int) -> Tuple[int, int]:
    """(query heads, KV heads) in projections of ``q_features`` and
    ``kv_features``: all of them, or a tensor-parallel rank's share, which
    keeps the GQA group whole, or its query heads' share beside every KV
    head (tp divides ``n_heads`` but not ``n_kv_heads``)."""
    n_heads, rem_q = divmod(q_features, cfg.head_dim)
    n_kv_heads, rem_kv = divmod(kv_features, cfg.head_dim)
    group = cfg.n_heads // cfg.n_kv_heads
    if rem_q or rem_kv or not n_heads or cfg.n_heads % n_heads or not (
            n_kv_heads == cfg.n_kv_heads or n_heads == n_kv_heads * group):
        raise ValueError(
            f"{cfg.n_heads} query and {cfg.n_kv_heads} KV heads of "
            f"{cfg.head_dim} do not split into local projections of "
            f"{q_features} and {kv_features} features: under tensor "
            f"parallelism tp must divide the query heads")
    return n_heads, n_kv_heads


def _own_kv(k: torch.Tensor, v: torch.Tensor, first: int, n_heads: int,
            group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV heads that query heads [first, first + n_heads) read, of
    every KV head [B, S, n_kv_heads, D]: the one they share, a GQA group
    of ``n_heads``, or, where they straddle KV heads, one KV head a query
    head."""
    lo, hi = first // group, (first + n_heads - 1) // group
    if lo == hi:
        return k[:, :, lo:lo + 1], v[:, :, lo:lo + 1]
    idx = torch.arange(first, first + n_heads, device=k.device) // group
    return k.index_select(2, idx), v.index_select(2, idx)


def _tp_rank(weight: torch.Tensor) -> int:
    """This rank's index on the tp mesh a projection weight is split over
    (0 for a plain tensor)."""
    return weight.device_mesh.get_local_rank("tp") if isinstance(
        weight, DTensor) else 0


def _ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          flash: bool) -> torch.Tensor:
    """Ring attention of this rank's [B/dp, S, H/tp, D] activations (the
    whole sequence) over the active mesh's ``sp`` axis: each rank's block
    runs the ring and the output is gathered whole again."""
    from tf_operator_tpu_torch.ops.ring_attention import (
        ring_attention_sharded,
    )

    mesh = active_mesh()
    if mesh is None:
        raise ValueError("ring attention requires an active mesh (wrap the "
                         "step in parallel.mesh.use_mesh)")
    placements = attention_placements(mesh)
    out = ring_attention_sharded(
        *(DTensor.from_local(x, mesh, placements, run_check=False)
          for x in (q, k, v)),
        mesh, causal=True, impl="flash" if flash else "einsum")
    return out.redistribute(mesh, placements).to_local()


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write ``new`` [B, S, ...] into ``cache`` [B, T, ...] at rows
    [positions[:,0], positions[:,0]+S), in place. The start is clamped to
    [0, T - S], as ``jax.lax.dynamic_update_slice`` clamps it, so a
    sequence decoded past ``max_seq_len`` keeps overwriting the last row."""
    b, s = new.shape[:2]
    start = positions[:, 0].clamp(0, cache.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=new.device)
    cache[torch.arange(b, device=new.device)[:, None], rows] = new.to(
        cache.dtype)


def _visible(k_pos: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """[B, S, T]: key position t is visible to the query at positions[b, s]
    when t <= positions[b, s]."""
    return k_pos[None, None, :] <= positions[:, :, None]


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, generator):
        super().__init__()
        dense = lambda n_in, n_out: Dense(n_in, n_out, cfg.dtype, device,
                                          generator)
        self.gate = dense(cfg.hidden, cfg.mlp_dim)
        self.up = dense(cfg.hidden, cfg.mlp_dim)
        self.down = dense(cfg.mlp_dim, cfg.hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, generator):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden, device)
        self.attn = LlamaAttention(cfg, device, generator)
        self.mlp_norm = RMSNorm(cfg.hidden, device)
        self.mlp = LlamaMLP(cfg, device, generator)

    def forward(self, x: torch.Tensor, angles: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), angles, positions, cache)
        return x + self.mlp(self.mlp_norm(x))


class LlamaBlockMlpRemat(LlamaBlock):
    """LlamaBlock with remat scoped to the MLP branch only (remat_policy
    "mlp_only"): the same parameters, but the attention branch keeps its
    activations (the flash op's saved tensors included), so the backward
    never runs the attention forward again."""

    def forward(self, x: torch.Tensor, angles: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), angles, positions, cache)
        h = self.mlp_norm(x)
        if torch.is_grad_enabled():
            return x + checkpoint(self.mlp, h, use_reentrant=False)
        return x + self.mlp(h)


class Llama(nn.Module):
    """Token ids [B, S] -> logits [B, S, vocab] in ``cfg.dtype``.

    Parameters are made on ``device`` (the card unless ``device="cpu"``)
    from ``generator`` (one on ``device``), by default one seeded with 0.
    On ``device="meta"`` nothing is drawn: ``Trainer.init`` materialises
    the same values later, on each rank's shards (``ops/layers.py``).
    ``positions`` ([B, S] absolute token positions) default to arange; in
    decode mode they and ``cache`` (from ``init_cache``) are required."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        remat = cfg.remat and not cfg.decode
        block = (LlamaBlockMlpRemat
                 if remat and cfg.remat_policy == "mlp_only" else LlamaBlock)
        # "full": plain torch.utils.checkpoint, which saves nothing.
        self._remat_context = noop_context_fn
        if remat and cfg.remat_policy in _SAVED_OPS:
            self._remat_context = functools.partial(
                create_selective_checkpoint_contexts,
                _SAVED_OPS[cfg.remat_policy])
        with build_scope(self, device, generator) as gen:
            self.embed_tokens = embedding(cfg.vocab_size, cfg.hidden,
                                          device, gen)
            self.layers = nn.ModuleList(
                block(cfg, device, gen) for _ in range(cfg.n_layers))
            self.final_norm = RMSNorm(cfg.hidden, device)
            self.lm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype,
                                 device, gen)
            rope_angles(self, cfg, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        if cfg.decode and positions is None:
            raise ValueError("decode mode requires positions")
        if cfg.decode and cache is None:
            raise ValueError("decode mode requires a cache (init_cache)")
        x = self.embed_tokens(tokens).to(cfg.dtype)
        remat = (cfg.remat and not cfg.decode and torch.is_grad_enabled()
                 and cfg.remat_policy != "mlp_only")
        for i, block in enumerate(self.layers):
            if cfg.decode:
                x = block(x, self.angles, positions,
                          (cache["k"][i], cache["v"][i]))
            elif remat:
                x = checkpoint(block, x, self.angles, positions,
                               use_reentrant=False,
                               context_fn=self._remat_context)
            else:
                x = block(x, self.angles, positions)
        return self.lm_head(self.final_norm(x))


# ---------------------------------------------------------------------------
# Logical axes (consumed by parallel/sharding.py rule tables)
# ---------------------------------------------------------------------------

# The JAX model's _LEAF_AXES in this model's layout: a Dense weight is
# [out, in] where the flax kernel is [in, out].
_LEAF_AXES = {
    ("embed_tokens", "weight"): ("vocab", "embed"),
    ("wq", "weight"): ("heads", "embed"),
    ("wk", "weight"): ("kv_heads", "embed"),
    ("wv", "weight"): ("kv_heads", "embed"),
    ("wo", "weight"): ("embed", "heads"),
    ("gate", "weight"): ("mlp", "embed"),
    ("up", "weight"): ("mlp", "embed"),
    ("down", "weight"): ("embed", "mlp"),
    ("lm_head", "weight"): ("vocab", "embed"),
    ("scale",): ("norm",),
}


def param_logical_axes(name: str, value: torch.Tensor
                       ) -> Tuple[Optional[str], ...]:
    """Logical axis names of the parameter ``name`` (as
    ``named_parameters`` gives it, e.g. ``layers.0.attn.wq.weight``)."""
    path = tuple(name.split("."))
    for suffix, axes in _LEAF_AXES.items():
        if path[-len(suffix):] == suffix and len(axes) == value.dim():
            return axes
    raise ValueError(f"no logical axes for param {name} shape "
                     f"{tuple(value.shape)}")


# ---------------------------------------------------------------------------
# Incremental decode (the serving path), the JAX helper contract with the
# parameters held by the model:
#
#   model  = Llama(dataclasses.replace(cfg, decode=True))   # same params
#   cache  = init_cache(model, batch_size=slots)
#   logits, one = prefill(model, one, prompt, positions)
#   cache  = insert_cache(cache, one, slot)                 # slot admission
#   logits, cache = decode_step(model, cache, tok, positions)
#
# The cache is {"k", "v"}, each [layers, batch, max_seq_len, kv_heads,
# head_dim] in cfg.dtype, the layout of the flax "cache" collection. Where
# JAX returns a new cache from every call, these update it in place (at
# llama_3_8b a 4-slot cache is 4.3 GB) and return the same object.
# ---------------------------------------------------------------------------


def init_cache(model: Llama, batch_size: int) -> Dict[str, torch.Tensor]:
    """All-zeros KV cache for ``batch_size`` slots on the model's device;
    under tensor parallelism, for this rank's KV heads (n_kv_heads // tp),
    as the JAX cache shards its kv_heads axis over tp."""
    cfg = model.cfg
    tp = mesh_axis_size(model.layers[0].attn.wk.weight, "tp")
    shape = (cfg.n_layers, batch_size, cfg.max_seq_len, cfg.n_kv_heads // tp,
             cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.dtype,
                              device=model.angles.device)
            for name in ("k", "v")}


def prefill(model: Llama, cache: Dict[str, torch.Tensor],
            tokens: torch.Tensor, positions: torch.Tensor):
    """One incremental-decode forward: (logits, the updated cache).

    ``tokens``/``positions`` are [B, S]; each row's positions must be
    consecutive (its K/V rows land at [positions[i,0], positions[i,0]+S)).
    Prompt processing uses S = prompt length (pad tails are harmless, see
    ``LlamaAttention._cached_attention``); decoding is the same call at
    S = 1."""
    if not model.cfg.decode:
        raise ValueError("prefill/decode_step need a decode=True model")
    with torch.no_grad():
        logits = model(tokens, positions=positions, cache=cache)
    return logits, cache


def decode_step(model: Llama, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor):
    """One token per row: ``prefill`` at S = 1."""
    return prefill(model, cache, tokens, positions)


def insert_cache(cache: Dict[str, torch.Tensor],
                 one: Dict[str, torch.Tensor], slot: int
                 ) -> Dict[str, torch.Tensor]:
    """Copy a 1-row cache (a finished prefill) into row ``slot`` of the
    decode cache along axis 1, in place: the continuous batcher's
    slot-admission step."""
    with torch.no_grad():
        for name, leaf in cache.items():
            leaf.narrow(1, slot, one[name].shape[1]).copy_(one[name])
    return cache
