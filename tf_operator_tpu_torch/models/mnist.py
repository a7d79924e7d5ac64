"""MNIST models (port of models/mnist.py): a small CNN and a pure MLP.

Inputs are [B, 28, 28, 1] float32 in [0, 1], channels last as in flax.
``MnistCNN`` runs its convolutions channels first (cuDNN's layout) and
flattens in flax's (h, w, c) order, so ``fc1`` takes the flax kernel's
rows as they are (``models/convert.py`` ``mnist_params_from_flax``).
Parameters are made on ``device`` (the card unless ``device="cpu"``) from
``generator``, with flax's initial scales: kernels normal with variance
1/fan_in (flax's lecun_normal is truncated; the scale matches), biases
zero.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch._device import DeviceLike, resolve_device


def _init(module: nn.Module, generator: torch.Generator) -> None:
    for layer in module.children():
        fan_in = layer.weight[0].numel()
        nn.init.normal_(layer.weight, std=fan_in ** -0.5,
                        generator=generator)
        nn.init.zeros_(layer.bias)


def _generator(device: torch.device,
               generator: Optional[torch.Generator]) -> torch.Generator:
    return generator or torch.Generator(device=device).manual_seed(0)


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(1, 32, 5, padding="same", device=device)
        self.conv2 = nn.Conv2d(32, 64, 5, padding="same", device=device)
        self.fc1 = nn.Linear(7 * 7 * 64, 512, device=device)
        self.fc2 = nn.Linear(512, num_classes, device=device)
        _init(self, _generator(device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.permute(0, 2, 3, 1).flatten(1)            # flax's (h, w, c)
        return self.fc2(F.relu(self.fc1(x)))


class MnistMLP(nn.Module):
    def __init__(self, num_classes: int = 10, hidden: int = 128,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.fc1 = nn.Linear(28 * 28, hidden, device=device)
        self.fc2 = nn.Linear(hidden, num_classes, device=device)
        _init(self, _generator(device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


def synthetic_batch(generator: torch.Generator, batch_size: int = 64
                    ) -> Dict[str, torch.Tensor]:
    """Uniform [B, 28, 28, 1] images and labels in [0, 10), drawn from
    ``generator`` on its device (JAX's PRNG streams are not reproducible
    here)."""
    device = generator.device
    return {
        "inputs": torch.rand((batch_size, 28, 28, 1), generator=generator,
                             device=device),
        "labels": torch.randint(0, 10, (batch_size,), generator=generator,
                                device=device),
    }


def param_logical_axes(name: str, value: torch.Tensor
                       ) -> Tuple[Optional[str], ...]:
    """MNIST is pure data-parallel: every parameter replicates under
    ``CNN_RULES`` (the JAX package's ``models/resnet.py`` rule)."""
    return (None,) * value.dim()
