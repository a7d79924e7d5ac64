"""BERT-family encoder with an MLM head (port of models/bert.py).

The BASELINE's "BERT-base pretraining TFJob, PS + 8 Workers with gang
scheduling" model: a bidirectional post-LN transformer encoder. The same
configuration fields, module names and cast points as the flax model: f32
parameters with compute in ``cfg.dtype``, every projection a biased
``Dense`` (flax's ``nn.Dense``: input, kernel and bias cast, the bias added
after the product), flax's ``LayerNorm`` (``ops/layers.py``: epsilon 1e-6,
f32 statistics), the tanh GELU, and the reference attention of
``ops/layers.py`` with a finite −1e30 padding mask. Like the JAX model it
never takes the flash kernels (its head_dim of 64 is outside their
domain). Where flax scans the blocks (``nn.scan``, with ``nn.remat`` when
``cfg.remat``), the blocks here are an ``nn.ModuleList``, each under
``torch.utils.checkpoint`` when ``cfg.remat`` and training;
``models/convert.py`` carries weights between the two trees.

MLM batches carry ``inputs``/``targets``/``mask`` (the masked positions)
and optionally ``attn_mask`` [B, S] (1 = a real token).

Initialisers follow flax's distributions from an explicit generator:
normal(fan_in^-½) projection weights (lecun-normal's variance, as the
port's ``Dense``), zero biases, ones/zeros LayerNorm parameters,
normal(0.02) ``pos_embed`` and normal(hidden^-½) token embeddings (flax's
``Embed`` default).

Under tensor parallelism (``parallel/sharding.py``) a rank works on its
own heads and MLP columns: q/k/v and ``mlp_in`` are column-parallel (their
biases split with them), ``wo`` and ``mlp_out`` row-parallel (their biases
added once, after the sum), the MLM head split over the vocabulary and
gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.llama import Dense
from tf_operator_tpu_torch.ops.layers import LayerNorm, attention, gelu


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    head_dim: int = 64
    mlp_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True


def bert_base() -> BertConfig:
    return BertConfig()


def bert_tiny(vocab_size: int = 256, max_seq_len: int = 128) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, hidden=64, n_layers=2,
                      n_heads=4, head_dim=16, mlp_dim=128,
                      max_seq_len=max_seq_len, remat=False)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        inner = cfg.n_heads * cfg.head_dim
        dense = lambda n_in, n_out: Dense(n_in, n_out, cfg.dtype, device,
                                          generator, bias=True)
        self.wq = dense(cfg.hidden, inner)
        self.wk = dense(cfg.hidden, inner)
        self.wv = dense(cfg.hidden, inner)
        self.wo = dense(inner, cfg.hidden)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        # This rank's heads under tensor parallelism, else all of them.
        heads = q.shape[-1] // cfg.head_dim
        q, k, v = (t.view(b, s, heads, cfg.head_dim) for t in (q, k, v))
        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :].bool()    # [B, 1, 1, S]
        out = attention(q, k, v, causal=False, mask=mask)
        return self.wo(out.reshape(b, s, heads * cfg.head_dim))


class BertBlock(nn.Module):
    """Post-LN: ``attn_ln(x + attn(x))``, then
    ``mlp_ln(x + mlp_out(gelu(mlp_in(x))))``."""

    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.attn = BertSelfAttention(cfg, device, generator)
        self.attn_ln = LayerNorm(cfg.hidden, cfg.dtype, device=device)
        self.mlp_in = Dense(cfg.hidden, cfg.mlp_dim, cfg.dtype, device,
                            generator, bias=True)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.hidden, cfg.dtype, device,
                             generator, bias=True)
        self.mlp_ln = LayerNorm(cfg.hidden, cfg.dtype, device=device)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.attn_ln(x + self.attn(x, attn_mask))
        return self.mlp_ln(x + self.mlp_out(gelu(self.mlp_in(x))))


class Bert(nn.Module):
    """Token ids [B, S] (and an optional ``attn_mask`` [B, S]) -> MLM
    logits [B, S, vocab] in ``cfg.dtype``.

    Parameters are made on ``device`` (the card unless ``device="cpu"``)
    from ``generator`` (one on ``device``), by default one seeded with 0."""

    def __init__(self, cfg: BertConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(0)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden,
                                         device=device)
        nn.init.normal_(self.embed_tokens.weight, std=cfg.hidden ** -0.5,
                        generator=gen)
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.max_seq_len, cfg.hidden, dtype=torch.float32, device=device))
        nn.init.normal_(self.pos_embed, std=0.02, generator=gen)
        self.embed_ln = LayerNorm(cfg.hidden, cfg.dtype, device=device)
        self.layers = nn.ModuleList(BertBlock(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        dense = lambda n_out: Dense(cfg.hidden, n_out, cfg.dtype, device,
                                    gen, bias=True)
        self.mlm_transform = dense(cfg.hidden)
        self.mlm_ln = LayerNorm(cfg.hidden, cfg.dtype, device=device)
        self.mlm_head = dense(cfg.vocab_size)

    def forward(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        s = tokens.shape[1]
        x = self.embed_tokens(tokens).to(cfg.dtype)
        x = x + self.pos_embed[:s].to(cfg.dtype)
        x = self.embed_ln(x)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x = checkpoint(block, x, attn_mask, use_reentrant=False)
            else:
                x = block(x, attn_mask)
        x = self.mlm_ln(gelu(self.mlm_transform(x)))
        return self.mlm_head(x)


# ---------------------------------------------------------------------------
# Logical axes (consumed by parallel/sharding.py rule tables)
# ---------------------------------------------------------------------------

# The JAX model's _LEAF_AXES in this model's layout: a Dense weight is
# [out, in] where the flax kernel is [in, out].
_LEAF_AXES = {
    ("embed_tokens", "weight"): ("vocab", "embed"),
    ("pos_embed",): ("seq", "embed"),
    ("wq", "weight"): ("heads", "embed"),
    ("wk", "weight"): ("heads", "embed"),
    ("wv", "weight"): ("heads", "embed"),
    ("wo", "weight"): ("embed", "heads"),
    ("mlp_in", "weight"): ("mlp", "embed"),
    ("mlp_out", "weight"): ("embed", "mlp"),
    # both dims are embed-sized; shard only one (an axis may appear once)
    ("mlm_transform", "weight"): (None, "embed"),
    ("mlm_head", "weight"): ("vocab", "embed"),
}


def param_logical_axes(name: str, value: torch.Tensor
                       ) -> Tuple[Optional[str], ...]:
    """Logical axis names of the parameter ``name`` (as
    ``named_parameters`` gives it, e.g. ``layers.0.attn.wq.weight``);
    biases and LayerNorm parameters are replicated."""
    path = tuple(name.split("."))
    for suffix, axes in _LEAF_AXES.items():
        if path[-len(suffix):] == suffix:
            if len(axes) == value.dim():
                return axes
            break
    if value.dim() <= 1:
        return (None,) * value.dim()
    raise ValueError(f"no logical axes for BERT param {name} shape "
                     f"{tuple(value.shape)}")


def mlm_loss(model: nn.Module, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
    """Masked-LM loss over the masked positions only. A ``mask_count`` in
    the batch (the trainer sets it on a mesh) is what the masked sum
    divides by, so that a sharded step trains on the global masked mean."""
    from tf_operator_tpu_torch.train.trainer import cross_entropy_loss

    logits = model(batch["inputs"], batch.get("attn_mask"))
    return cross_entropy_loss(logits, batch["targets"], batch.get("mask"),
                              batch.get("mask_count"))
