"""Core layers: RMSNorm, flax's LayerNorm, the tanh GELU, rotary position
embeddings, reference attention, and the TPU-formulated BatchNorm; and the
one place that says how every parameter and buffer of the port's models
gets its first value (``Init``, ``init_``).

Port of ``tf_operator_tpu/ops/layers.py``: the same cast points (f32
statistics and rotations, cast back to the input dtype) and the same
finite ``-1e30`` mask, so the two packages agree on the same inputs.

Initialisation. A model's constructor gives each parameter and buffer an
``Init`` through ``init_``: a normal draw with a given std from the
build's generator, a constant, or a value computed from the
configuration (the rotary angles). On a real device ``init_`` runs it at
once, so an eager build draws exactly as it always has. On the meta
device (``device="meta"``) nothing is drawn (``nn.init.normal_`` on a
meta tensor is a no-op that does not advance the generator): the call is
appended to the root module's ``init_record`` (opened by
``build_scope``), so the record's order is the eager build's draw order by
construction, and ``parallel/sharding.py`` ``materialize`` replays it
later on each rank's shards (the JAX package's sharded-from-birth init).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from tf_operator_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initialisers: run at once on a real device, recorded on the meta device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Init:
    """How a parameter or buffer gets its first value: a normal draw with
    ``std`` from the build's generator, the constant ``value``, or
    ``compute(device)`` (a buffer made from the configuration)."""

    std: Optional[float] = None
    value: Optional[float] = None
    compute: Optional[Callable[[torch.device], torch.Tensor]] = None

    @property
    def draws(self) -> bool:
        return self.std is not None

    def fill_(self, tensor: torch.Tensor,
              generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            if self.std is not None:
                nn.init.normal_(tensor, std=self.std, generator=generator)
            elif self.value is not None:
                tensor.fill_(self.value)
            else:
                tensor.copy_(self.compute(tensor.device))


ZEROS = Init(value=0.0)
ONES = Init(value=1.0)


class InitRecord:
    """The initialisers of a model built on the meta device, in the order
    its constructor ran them: ``entries`` of (module, attribute name,
    ``Init``). ``generator`` is the one the build was given (None: one
    seeded 0 on the materialising device, as an eager build's default)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator
        self.entries: List[Tuple[nn.Module, str, Init]] = []


_RECORD: contextvars.ContextVar[Optional[InitRecord]] = (
    contextvars.ContextVar("init_record", default=None))


@contextlib.contextmanager
def build_scope(root: nn.Module, device: torch.device,
                generator: Optional[torch.Generator] = None
                ) -> Iterator[Optional[torch.Generator]]:
    """The generator a model's constructor draws from, for the block that
    builds its submodules: on a real device ``generator``, by default one
    seeded 0 on ``device``. On the meta device it yields None and opens
    ``root.init_record`` (``InitRecord(generator)``), into which every
    ``init_`` of the block appends; a model built inside another's block
    shares that record."""
    if device.type != "meta":
        yield generator or torch.Generator(device=device).manual_seed(0)
        return
    outer = _RECORD.get()
    root.init_record = outer or InitRecord(generator)
    token = _RECORD.set(root.init_record)
    try:
        yield None
    finally:
        _RECORD.reset(token)


def init_(module: nn.Module, name: str, init: Init,
          generator: Optional[torch.Generator] = None) -> None:
    """Give ``module.<name>`` (a parameter or buffer) its first value:
    ``init`` at once on a real device; on the meta device the call is
    recorded in the open ``build_scope``'s record (none open: nothing is,
    and ``materialize`` will refuse the model)."""
    tensor = getattr(module, name)
    if not tensor.is_meta:
        init.fill_(tensor, generator)
        return
    record = _RECORD.get()
    if record is not None:
        record.entries.append((module, name, init))


def is_meta(model: nn.Module) -> bool:
    """Whether ``model`` was built on the meta device and is not yet
    materialised (its first parameter or buffer, or that one's local
    shard, is on meta)."""
    for t in itertools.chain(model.parameters(), model.buffers()):
        return getattr(t, "_local_tensor", t).is_meta
    return False


def new_param(module: nn.Module, name: str, shape: Sequence[int],
              init: Init, device, generator=None) -> None:
    """Register an f32 parameter ``name`` of ``shape`` on ``device`` and
    ``init_`` it."""
    module.register_parameter(name, nn.Parameter(torch.empty(
        tuple(shape), dtype=torch.float32, device=device)))
    init_(module, name, init, generator)


def new_buffer(module: nn.Module, name: str, shape: Sequence[int],
               init: Init, device, persistent: bool = True) -> None:
    """Register an f32 buffer ``name`` of ``shape`` on ``device`` and
    ``init_`` it (no buffer draws)."""
    module.register_buffer(name, torch.empty(
        tuple(shape), dtype=torch.float32, device=device),
        persistent=persistent)
    init_(module, name, init)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 for numerical stability, cast back to input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis (``use_fast_variance``): the
    mean and E[x²] in f32, var = max(E[x²] − E[x]², 0), then
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias`` in f32, cast to
    ``dtype`` (default: the input's) at the end."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True)
           - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * mul + bias.float()).to(dtype or x.dtype)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=dtype, param_dtype=float32)``: f32
    ``scale`` (ones) and ``bias`` (zeros), epsilon 1e-6, ``layer_norm``.

    ``torch.nn.LayerNorm`` differs: its eps is 1e-5 and its variance is
    the two-pass E[(x − E[x])²]."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        new_param(self, "scale", (features,), ONES, device)
        new_param(self, "bias", (features,), ZEROS, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, dtype=self.dtype)


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: by default the tanh form,
    0.5·x·(1 + tanh(sqrt(2/π)·(x + 0.044715·x³)))."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


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


def _mean_over(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``jnp.mean``: the sum in f32 (a bf16 input upcast first), divided by
    the count in f32, cast back to the input's dtype."""
    count = math.prod(x.shape[d] for d in dims)
    return (x.float().sum(dim=tuple(dims)) / count).to(x.dtype)


def _batch_mean(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``_mean_over`` a batch's dims. Under a data-parallel mesh (the
    ``Trainer`` enters ``parallel.mesh.use_mesh`` for its step) it is the
    global batch's, as ``jnp.mean`` over a batch sharded on the data
    axes: every slice's f32 sums added by an all-reduce whose backward
    adds every slice's gradient."""
    mesh = mesh_lib.active_mesh()
    if mesh is None or mesh_lib.data_parallel_size(mesh) == 1:
        return _mean_over(x, dims)
    total = mesh_lib.data_sum(x.float().sum(dim=tuple(dims)), mesh)
    count = (math.prod(x.shape[d] for d in dims)
             * mesh_lib.data_parallel_size(mesh))
    return (total / count).to(x.dtype)


def batch_stats(x: torch.Tensor, stats_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (dim 1) mean and biased variance over every other dim,
    as TPUBatchNorm computes them: ``x`` cast to ``stats_dtype``, then
    E[x] and E[x²] − E[x]² in that dtype (over the global batch on a
    data-parallel mesh), returned in f32 with the variance clamped at 0
    (no Bessel correction)."""
    dims = [d for d in range(x.ndim) if d != 1]
    xs = x.to(stats_dtype)
    mean = _batch_mean(xs, dims)
    var = _batch_mean(xs.square(), dims) - mean.square()
    return mean.float(), var.float().clamp_min(0.0)


class TPUBatchNorm(nn.Module):
    """BatchNorm as the JAX package's ``TPUBatchNorm`` formulates it, over
    channels on dim 1 (NCHW, or [N, C]).

    - Parameters ``scale`` and ``bias`` in f32; buffers ``mean`` (zeros) and
      ``var`` (ones) in f32, flax's ``batch_stats`` (none when
      ``track_stats=False``).
    - Batch statistics (``batch_stats``) in ``stats_dtype`` (f32 for the
      ``bn`` scheme, bf16 for ``bn_bf16``); the running update is
      ``ra = momentum·ra + (1 − momentum)·batch`` with flax's momentum
      (0.9) and the biased variance.
    - The affine is folded in f32 on the [C] vectors, ``a = scale ·
      rsqrt(var + eps)`` and ``b = bias − mean · a``, then applied as
      ``x·a + b`` in the output dtype (``a`` and ``b`` cast down first when
      that is bf16).
    - ``use_running_average=True`` normalises with the buffers; without
      buffers (``track_stats=False``) with mean 0 and variance 1, a pure
      per-channel affine.

    ``torch.nn.BatchNorm2d`` differs on each count that matters here: its
    running variance is unbiased, its ``momentum`` is 1 − flax's, and it
    normalises as (x − mean) / sqrt(var + eps) · scale + bias.
    """

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 stats_dtype: torch.dtype = torch.float32,
                 scale_init: float = 1.0, track_stats: bool = True,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.stats_dtype = stats_dtype
        self.track_stats = track_stats
        new_param(self, "scale", (features,), Init(value=float(scale_init)),
                  device)
        new_param(self, "bias", (features,), ZEROS, device)
        if track_stats:
            new_buffer(self, "mean", (features,), ZEROS, device)
            new_buffer(self, "var", (features,), ONES, device)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            if self.track_stats:
                mean, var = self.mean, self.var
            else:
                mean = torch.zeros_like(self.scale)
                var = torch.ones_like(self.scale)
        else:
            mean, var = batch_stats(x, self.stats_dtype)
            if self.track_stats:
                with torch.no_grad():
                    keep = 1.0 - self.momentum
                    self.mean.copy_(self.momentum * self.mean
                                    + keep * mean.detach())
                    self.var.copy_(self.momentum * self.var
                                   + keep * var.detach())
        a = self.scale.float() * torch.rsqrt(var + self.epsilon)
        b = self.bias.float() - mean * a
        shape = (1, -1) + (1,) * (x.ndim - 2)
        a, b = a.view(shape), b.view(shape)
        out_dtype = self.dtype or x.dtype
        if out_dtype == torch.float32:
            return x.float() * a + b
        return x * a.to(out_dtype) + b.to(out_dtype)
