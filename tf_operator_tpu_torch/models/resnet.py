"""ResNet-50 (port of models/resnet.py).

Same configuration fields, module names and cast points as the flax model:
inputs are NHWC, as in flax, and are permuted once to an NCHW view whose
strides are channels-last (NHWC in memory), cuDNN's fast layout on Hopper;
every activation after it keeps that layout. Convolutions are bias-free
with f32 OIHW weights cast to ``cfg.dtype`` at each call (a flax
``Conv(dtype=bf16)`` casts its input and kernel); the head averages over H
and W in the compute dtype, then runs an f32 ``classifier``.

Padding follows XLA's ``SAME`` rule, which puts the odd pixel of the total
on the far edge: a 3x3/stride-2 convolution or max pool on an even size
pads (0, 1), not (1, 1), so it is padded by hand (``same_padding``); the
s2d stem pads (2, 1) and the conv7 stem (3, 3), as the flax model does.

Normalisation schemes (``ResNetConfig.norm``), as ``_norm_factory``:
- ``"bn"``: ``TPUBatchNorm`` with f32 batch statistics;
- ``"bn_bf16"``: the same with bf16 statistics;
- ``"group"``: GroupNorm(32), gcd(32, C) groups on narrower layers, under
  a child named ``GroupNorm_0`` as in the flax tree;
- ``"affine"``: ``TPUBatchNorm(track_stats=False)`` at unit statistics,
  no buffers.
In training mode ``bn`` and ``bn_bf16`` normalise with the batch and
update their buffers; with ``update_stats=False`` or in eval mode they
normalise with the buffers and leave them as they are.

Parameters are made on ``device`` (the card unless ``device="cpu"``) from
``generator``: kernels normal with variance 1/fan_in (flax's lecun_normal
is truncated; the scale matches), norm scales one (``bn3``'s zero), biases
zero. ``models/convert.py`` carries weights and statistics from and to
flax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch._device import DeviceLike, resolve_device
from tf_operator_tpu_torch.ops.layers import TPUBatchNorm

NORMS = ("bn", "bn_bf16", "group", "affine")
STEMS = ("conv7", "s2d")
Padding = Tuple[Tuple[int, int], Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    # "bn" | "bn_bf16" | "group" | "affine" (module docstring).
    norm: str = "bn"
    # "conv7": 7x7/stride-2 conv on [N, 224, 224, 3]; "s2d": space-to-depth
    # to [N, 112, 112, 12], then a 4x4/stride-1 conv computing the same
    # function (s2d_stem_kernel maps the weights).
    stem: str = "conv7"


def resnet50(num_classes: int = 1000, stem: str = "conv7") -> ResNetConfig:
    return ResNetConfig(num_classes=num_classes, stem=stem)


def resnet_tiny(num_classes: int = 10) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(1, 1), width=8, num_classes=num_classes)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: the output has
    ceil(size / stride) positions, and of the total padding the odd pixel
    goes after the input."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, padding: Padding, value: float = 0.0
         ) -> Tuple[torch.Tensor, Optional[Tuple[int, int]]]:
    """(x padded where the two sides differ, symmetric padding left for
    the op); the result stays channels-last."""
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        return x, (top, left)
    x = F.pad(x, (left, right, top, bottom), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


class Conv(nn.Module):
    """Bias-free square convolution, f32 weight [out, in, k, k] computed in
    ``dtype``; ``padding`` is ``"SAME"`` (same_padding) or explicit
    ((top, bottom), (left, right))."""

    def __init__(self, features_in: int, features_out: int, kernel: int,
                 stride: int, dtype: torch.dtype, device,
                 generator: torch.Generator, padding="SAME"):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.dtype, self.padding = dtype, padding
        self.weight = nn.Parameter(torch.empty(
            features_out, features_in, kernel, kernel, dtype=torch.float32,
            device=device))
        nn.init.normal_(self.weight, std=(features_in * kernel * kernel)
                        ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.padding
        if padding == "SAME":
            padding = tuple(same_padding(n, self.kernel, self.stride)
                            for n in x.shape[2:])
        x, symmetric = _pad(x.to(self.dtype), padding)
        weight = self.weight.to(dtype=self.dtype,
                                memory_format=torch.channels_last)
        return F.conv2d(x, weight, stride=self.stride, padding=symmetric)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(padding="SAME")``: -inf padding by same_padding."""
    padding = tuple(same_padding(n, window, stride) for n in x.shape[2:])
    x, symmetric = _pad(x, padding, value=float("-inf"))
    return F.max_pool2d(x, window, stride, padding=symmetric)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` over channels on dim 1: statistics in f32
    per (sample, group) as E[x] and max(E[x²] − E[x]², 0), then
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias`` in f32, cast to
    ``dtype``."""

    def __init__(self, features: int, num_groups: int, epsilon: float,
                 dtype: torch.dtype, scale_init: float, device):
        super().__init__()
        self.num_groups, self.epsilon, self.dtype = num_groups, epsilon, dtype
        self.scale = nn.Parameter(torch.full(
            (features,), float(scale_init), dtype=torch.float32,
            device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        size = c // self.num_groups
        xs = x.float()
        grouped = xs.reshape(n, self.num_groups, size, *x.shape[2:])
        dims = tuple(range(2, grouped.ndim))
        count = math.prod(grouped.shape[d] for d in dims)
        mean = grouped.sum(dim=dims) / count
        var = (grouped.square().sum(dim=dims) / count
               - mean.square()).clamp_min(0.0)
        shape = (n, c) + (1,) * (x.ndim - 2)
        mean = mean.repeat_interleave(size, dim=1).view(shape)
        mul = (torch.rsqrt(var + self.epsilon).repeat_interleave(size, dim=1)
               * self.scale).view(shape)
        y = (xs - mean) * mul + self.bias.view((1, c) + (1,) * (x.ndim - 2))
        return y.to(self.dtype)


class GroupNormAuto(nn.Module):
    """GroupNorm with 32 groups, gcd(32, C) on narrower layers; the layer
    sits under ``GroupNorm_0`` as in the flax tree."""

    def __init__(self, features: int, dtype: torch.dtype, scale_init: float,
                 device):
        super().__init__()
        groups = 32 if features % 32 == 0 else math.gcd(32, features)
        self.GroupNorm_0 = GroupNorm(features, groups, 1e-5, dtype,
                                     scale_init, device)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        return self.GroupNorm_0(x)


def make_norm(cfg: ResNetConfig, features: int, device,
              scale_init: float = 1.0) -> nn.Module:
    """The normalisation layer of ``cfg.norm`` (module docstring)."""
    if cfg.norm in ("bn", "bn_bf16"):
        stats = torch.float32 if cfg.norm == "bn" else torch.bfloat16
        return TPUBatchNorm(features, momentum=0.9, epsilon=1e-5,
                            dtype=cfg.dtype, stats_dtype=stats,
                            scale_init=scale_init, device=device)
    if cfg.norm == "group":
        return GroupNormAuto(features, cfg.dtype, scale_init, device)
    if cfg.norm == "affine":
        return TPUBatchNorm(features, epsilon=1e-5, dtype=cfg.dtype,
                            scale_init=scale_init, track_stats=False,
                            device=device)
    raise ValueError(f"unknown norm scheme {cfg.norm!r}; expected "
                     f"{' | '.join(NORMS)}")


class BottleneckBlock(nn.Module):
    def __init__(self, features_in: int, filters: int, stride: int,
                 cfg: ResNetConfig, device, generator: torch.Generator):
        super().__init__()

        def conv(cin, cout, kernel, s=1):
            return Conv(cin, cout, kernel, s, cfg.dtype, device, generator)

        self.conv1 = conv(features_in, filters, 1)
        self.bn1 = make_norm(cfg, filters, device)
        self.conv2 = conv(filters, filters, 3, stride)
        self.bn2 = make_norm(cfg, filters, device)
        self.conv3 = conv(filters, filters * 4, 1)
        self.bn3 = make_norm(cfg, filters * 4, device, scale_init=0.0)
        # The flax block projects where the residual's shape differs from
        # the output's; in this network that is where the channels change.
        self.proj_conv = self.proj_bn = None
        if features_in != filters * 4 or stride != 1:
            self.proj_conv = conv(features_in, filters * 4, 1, stride)
            self.proj_bn = make_norm(cfg, filters * 4, device)

    def forward(self, x: torch.Tensor, running: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), running))
        y = F.relu(self.bn2(self.conv2(y), running))
        y = self.bn3(self.conv3(y), running)
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(x), running)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(x [N, H, W, 3], update_stats=True) -> f32 logits``."""

    def __init__(self, cfg: ResNetConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.stem not in STEMS:
            raise ValueError(f"unknown stem {cfg.stem!r}; expected "
                             f"{' | '.join(STEMS)}")
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(0)
        if cfg.stem == "s2d":
            self.stem_conv_s2d = Conv(12, cfg.width, 4, 1, cfg.dtype, device,
                                      gen, padding=((2, 1), (2, 1)))
        else:
            self.stem_conv = Conv(3, cfg.width, 7, 2, cfg.dtype, device, gen,
                                  padding=((3, 3), (3, 3)))
        self.stem_bn = make_norm(cfg, cfg.width, device)
        self.block_names = []
        features = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                filters = cfg.width * 2 ** stage
                self.add_module(name, BottleneckBlock(
                    features, filters, stride, cfg, device, gen))
                self.block_names.append(name)
                features = filters * 4
        self.classifier = nn.Linear(features, cfg.num_classes, device=device)
        nn.init.normal_(self.classifier.weight, std=features ** -0.5,
                        generator=gen)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        cfg = self.cfg
        running = cfg.norm == "affine" or not (self.training and update_stats)
        x = x.to(cfg.dtype)
        if cfg.stem == "s2d":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)   # NCHW view of NHWC (channels-last) memory
        stem = self.stem_conv_s2d if cfg.stem == "s2d" else self.stem_conv
        x = F.relu(self.stem_bn(stem(x), running))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, running)
        x = x.mean(dim=(2, 3)).float()
        return self.classifier(x)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, C·b·b], channel order (bi, bj, c):
    out[n, i, j, (bi·b + bj)·C + c] = x[n, i·b + bi, j·b + bj, c]."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def s2d_stem_kernel(w7: torch.Tensor, block: int = 2) -> torch.Tensor:
    """HWIO: the 7x7xCxO stride-2 kernel -> the 4x4x(4C)xO stride-1 kernel
    that computes the same function on space_to_depth(x, 2) with padding
    (2, 1). out(i) = Σ_k W7[k] x[2i + k − 3]; with k' = k + 1 (the kernel
    zero-padded in front to 8) and k' = 2a + b, b in {0, 1}, the tap reads
    s2d(x)[i + a − 2, channel (b, c)]: a 4-tap conv padded (2, 1)."""
    kh, kw, cin, cout = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {tuple(w7.shape)}")
    w8 = F.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))
    w4 = w8.reshape(4, block, 4, block, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return w4.reshape(4, 4, block * block * cin, cout)


def s2d_stem_kernel_oihw(w7: torch.Tensor, block: int = 2) -> torch.Tensor:
    """s2d_stem_kernel in the port's layout: [O, C, 7, 7] -> [O, 4C, 4, 4],
    input channels in the (bi, bj, c) order of space_to_depth."""
    cout, cin, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {tuple(w7.shape)}")
    w8 = F.pad(w7, (1, 0, 1, 0))
    # [O, C, a_h, bi, a_w, bj] -> [O, bi, bj, C, a_h, a_w]
    w4 = w8.reshape(cout, cin, 4, block, 4, block).permute(0, 3, 5, 1, 2, 4)
    return w4.reshape(cout, block * block * cin, 4, 4)


def synthetic_batch(generator: torch.Generator, batch_size: int = 128,
                    image_size: int = 224, num_classes: int = 1000
                    ) -> Dict[str, torch.Tensor]:
    """Uniform [B, H, W, 3] images in [0, 1) and labels in [0,
    num_classes), drawn from ``generator`` on its device (JAX's PRNG
    streams are not reproducible here)."""
    device = generator.device
    return {
        "inputs": torch.rand((batch_size, image_size, image_size, 3),
                             generator=generator, device=device),
        "labels": torch.randint(0, num_classes, (batch_size,),
                                generator=generator, device=device),
    }


def param_logical_axes(name: str, value: torch.Tensor
                       ) -> Tuple[Optional[str], ...]:
    """ResNet is pure data-parallel: every parameter replicates under
    ``CNN_RULES`` (the JAX package's ``models/resnet.py`` rule)."""
    return (None,) * value.dim()
