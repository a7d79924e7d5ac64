"""Llama-family dense decoder, training path (port of models/llama.py).

Same configuration fields, module names and cast points as the flax model:
f32 parameters with bf16 compute (a flax ``Dense(dtype=bf16)`` casts both
its input and its kernel, as ``Dense`` here does), RMSNorm and RoPE in f32,
f32 logits only in the loss. Where flax stacks the blocks with ``nn.scan``,
the layers here are an ``nn.ModuleList``; ``models/convert.py`` carries
weights between the two trees.

Remat ``"full"`` wraps each block in ``torch.utils.checkpoint`` (as
``nn.remat`` does), so under training the attention forward kernel runs
twice per layer and step. Decode mode, the other remat policies and the
ring attention modes belong to later slices of the port and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.ops.flash_attention import best_attention
from tf_operator_tpu_torch.ops.layers import (
    apply_rope,
    attention,
    repeat_kv,
    rms_norm,
    rope_frequencies,
)


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
    # "full" rematerializes each block. "save_attn", "save_qkv" and
    # "mlp_only" of the JAX model are not ported yet.
    remat_policy: str = "full"
    # "" = auto (CUDA kernels where they take the shapes, else the
    # reference); "flash" = force flash_attention; "xla" = the reference.
    attention_impl: str = ""
    decode: bool = False


def llama_3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab_size: int = 256, max_seq_len: int = 128) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden=64, n_layers=2,
                       n_heads=4, n_kv_heads=2, head_dim=16, mlp_dim=128,
                       max_seq_len=max_seq_len, rope_theta=10000.0,
                       remat=False)


_REMAT_NOT_PORTED = ("save_attn", "save_qkv", "mlp_only")


def _check_config(cfg: LlamaConfig) -> None:
    if cfg.decode:
        raise NotImplementedError(
            "decode mode (the KV-cache serving path) is not ported yet")
    if cfg.attention_impl in ("ring", "ring_flash"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} (ring attention over "
            "the sp axis) is not ported yet")
    if cfg.attention_impl not in ("", "flash", "xla"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.remat and cfg.remat_policy in _REMAT_NOT_PORTED:
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet; use "
            "'full' or remat=False")
    if cfg.remat and cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


class Dense(nn.Module):
    """Bias-free projection with f32 weight [out, in], computed in ``dtype``."""

    def __init__(self, features_in: int, features_out: int,
                 dtype: torch.dtype, device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features_out, features_in, dtype=torch.float32, device=device))
        nn.init.normal_(self.weight, std=features_in ** -0.5,
                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, features: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        dense = lambda n_in, n_out: Dense(n_in, n_out, cfg.dtype, device,
                                          generator)
        self.wq = dense(cfg.hidden, cfg.n_heads * cfg.head_dim)
        self.wk = dense(cfg.hidden, cfg.n_kv_heads * cfg.head_dim)
        self.wv = dense(cfg.hidden, cfg.n_kv_heads * cfg.head_dim)
        self.wo = dense(cfg.n_heads * cfg.head_dim, cfg.hidden)

    def forward(self, x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.wq(x).view(b, s, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
        if cfg.attention_impl == "xla":
            group = cfg.n_heads // cfg.n_kv_heads
            out = attention(q, repeat_kv(k, group), repeat_kv(v, group),
                            causal=True)
        else:
            out = best_attention(q, k, v, causal=True,
                                 force_flash=cfg.attention_impl == "flash")
        return self.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim))


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

    def forward(self, x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), angles)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Token ids [B, S] -> logits [B, S, vocab] in ``cfg.dtype``.

    Parameters are made on ``device`` (the card unless ``device="cpu"``)
    from ``generator`` (one on ``device``), by default one seeded with 0."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(0)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden,
                                         device=device)
        nn.init.normal_(self.embed_tokens.weight, std=cfg.hidden ** -0.5,
                        generator=gen)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, device, gen) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.hidden, device)
        self.lm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, device,
                             gen)
        self.register_buffer(
            "angles", rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                       cfg.rope_theta, device=device),
            persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed_tokens(tokens).to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x = checkpoint(block, x, self.angles, use_reentrant=False)
            else:
                x = block(x, self.angles)
        return self.lm_head(self.final_norm(x))
