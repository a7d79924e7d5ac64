"""Core layers: RMSNorm, rotary position embeddings, reference attention.

Port of ``tf_operator_tpu/ops/layers.py``: the same cast points (f32
statistics and rotations, cast back to the input dtype) and the same
finite ``-1e30`` mask, so the two packages agree on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 for numerical stability, cast back to input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dtype)


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """[max_seq_len, head_dim//2] f32 rotation angles."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv_freq)


def apply_rope(x: torch.Tensor, angles: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate [..., S, H, D] by position (half-split, not interleaved).

    ``angles`` is [max_S, D/2]; ``positions`` ([S] or [B, S]) defaults to
    arange. A position past the table reads its last row, as JAX's gather
    clamps it (a sequence decoded past max_S rotates at the last angle)."""
    seq_len = x.shape[-3]
    if positions is None:
        freqs = angles[:seq_len]
    else:
        freqs = angles[positions.clamp(0, angles.shape[0] - 1)]
    cos = torch.cos(freqs).unsqueeze(-2)   # [..., S, 1, D/2]
    sin = torch.sin(freqs).unsqueeze(-2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Grouped-query attention: [..., S, KVH, D] -> [..., S, KVH*n_rep, D]."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=-2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, mask: Optional[torch.Tensor] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Reference attention: q [B, S, H, D], k/v [B, T, H, D] -> [B, S, H, D].

    Scores and softmax in f32; ``q_offset`` shifts query positions for the
    causal mask; ``mask`` (broadcastable to [B, H, S, T]) keeps where True.
    """
    s, d = q.shape[-3], q.shape[-1]
    t = k.shape[-3]
    logits = torch.einsum("...shd,...thd->...hst", q.float(),
                          k.float()) * d ** -0.5
    if causal:
        q_pos = torch.arange(s, device=q.device) + q_offset
        k_pos = torch.arange(t, device=q.device)
        keep = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("...hst,...thd->...shd", weights, v)
