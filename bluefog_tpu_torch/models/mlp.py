# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Small models for the optimizer tests, the MNIST example and the dry
run, numerically following the flax models of the JAX package.

Counterpart of ``bluefog_tpu/models/mlp.py``. Parameter names are the flax
names (``Dense_0.kernel``, ``Conv_1.bias`` ...), so
:func:`bluefog_tpu_torch.interop.params_from_flax` brings a flax params
tree in and :class:`bluefog_tpu_torch.models.StackedModel` packs it. flax
infers a layer's input width from its first call; here it is given:
``in_features`` (the flattened input of :class:`MLP`) and ``image`` (the
side of :class:`MnistCNN`'s square input). Everything computes in f32.
Inputs are NHWC as in the JAX models, and :class:`MnistCNN` flattens its
features in NHWC order before its dense layers, as flax does.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models import resnet
from bluefog_tpu_torch.models.resnet import _TRUNC_STD
from bluefog_tpu_torch.models.transformer import Dense

__all__ = ["MLP", "MnistCNN", "init_flax_like"]


class MLP(nn.Module):
    """Plain MLP: ``Dense -> relu`` for every width of ``features`` but the
    last, then ``Dense(features[-1])``; the input is flattened to
    ``[batch, in_features]``."""

    def __init__(self, in_features: int, features: Sequence[int] = (64, 32, 10)):
        super().__init__()
        self.features = tuple(features)
        width = in_features
        for i, f in enumerate(self.features):
            self.add_module(f"Dense_{i}", Dense(width, f, torch.float32))
            width = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        last = len(self.features) - 1
        for i in range(last):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{last}")(x)


class Conv(resnet.Conv):
    """flax ``nn.Conv(features, kernel_size)``: ``SAME`` padding, a bias,
    f32."""

    def __init__(self, in_features: int, features: int, kernel_size=(3, 3)):
        super().__init__(in_features, features, kernel_size, dtype=torch.float32)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) + self.bias[:, None, None]


class MnistCNN(nn.Module):
    """Conv net of the reference MNIST example: two ``3x3`` convs (32 and 64
    channels) each with relu and a ``2x2`` max pool, then ``Dense(128)``,
    relu, ``Dense(num_classes)``. Takes ``[batch, image, image]`` or
    ``[batch, image, image, channels]`` NHWC."""

    def __init__(self, num_classes: int = 10, image: int = 28, channels: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.Conv_0 = Conv(channels, 32)
        self.Conv_1 = Conv(32, 64)
        side = image // 2 // 2
        self.Dense_0 = Dense(64 * side * side, 128, torch.float32)
        self.Dense_1 = Dense(128, num_classes, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NCHW view
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flattened in NHWC order
        return self.Dense_1(F.relu(self.Dense_0(x)))


@torch.no_grad()
def init_flax_like(module: nn.Module, seed: int) -> nn.Module:
    """Initialise an :class:`MLP`'s or :class:`MnistCNN`'s parameters in
    place with flax's distributions (lecun-normal kernels over fan-in, zero
    biases), drawn on the CPU from ``torch.Generator(seed)`` in
    parameter-name order (the bits differ from ``jax.random``)."""
    gen = torch.Generator().manual_seed(seed)
    for _name, m in sorted(module.named_modules()):
        if isinstance(m, (Dense, Conv)):
            fan_in = m.kernel[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw = torch.empty(m.kernel.shape)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
            m.kernel.copy_(draw)
            m.bias.zero_()
    return module
