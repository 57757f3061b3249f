# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""ResNet, numerically following the flax model of the JAX package.

Counterpart of ``bluefog_tpu/models/resnet.py``. Submodule and parameter
names are the flax names (``conv_init``, ``bn_init``,
``BottleneckBlock_3.Conv_1.kernel``, ``Dense_0.bias`` ...), so a parameter
path maps one to one onto the flax params tree. Inputs are NHWC images as
in the JAX model; inside, activations are NCHW views of the same memory
(``channels_last``). Weights are held in PyTorch's layouts (OIHW convs,
``[out, in]`` dense); :mod:`bluefog_tpu_torch.interop` converts.

BatchNorm, with the residual add and the ReLU after it fused, is
:func:`bluefog_tpu_torch.ops.batchnorm.batch_norm`: on the CPU the plain
composite (what the model has always computed), on CUDA the hand-written
kernels of ``csrc/batchnorm_kernels.cu`` (statistics, normalize with the
residual and the ReLU, and the backward), which take the channels-last bf16
or f32 activations the convolutions write.

Where flax and PyTorch differ, this follows flax:

- ``padding="SAME"`` is asymmetric for even strides (7x7/2 on 224 pads 2
  before and 3 after); convolutions and the max pool pad explicitly.
- BatchNorm keeps f32 statistics from the fast variance ``E[x^2] -
  E[x]^2`` (clipped at 0), uses the biased variance for the running
  estimate, and updates it as ``0.9 * running + 0.1 * batch``.
- ``dtype`` is the compute dtype (bf16 by default) over f32 parameters;
  the classifier is f32; the last BatchNorm of every block starts with a
  zero scale.
- Initialisers are flax's: ``lecun_normal`` (truncated normal over
  fan-in) for conv and dense kernels, ones and zeros for BatchNorm.
"""

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.ops.batchnorm import batch_norm

__all__ = [
    "BasicBlock",
    "BottleneckBlock",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "same_padding",
    "init_flax_like",
]

# flax truncated_normal stddev correction for the [-2, 2] cut
_TRUNC_STD = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of XLA's ``SAME`` rule on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
              value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad NCHW ``x`` for ``SAME``; returns the input to convolve and the
    symmetric padding left to the convolution itself."""
    ph = same_padding(x.shape[-2], kernel[0], stride[0])
    pw = same_padding(x.shape[-1], kernel[1], stride[1])
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Conv(nn.Module):
    """Bias-free ``SAME`` convolution computing in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.strides = tuple(strides)
        self.kernel_size = tuple(kernel_size)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, *kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x.to(self.dtype), self.kernel_size, self.strides)
        w = self.kernel.to(self.dtype)
        if x.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.strides, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.momentum = 0.9
        self.epsilon = 1e-5
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, residual: torch.Tensor = None,
                relu: bool = False) -> torch.Tensor:
        """``relu(residual + bn(x))``, each part optional; training updates
        the running statistics in place."""
        return batch_norm(x, self.scale, self.bias, self.mean, self.var, self.training,
                          self.momentum, self.epsilon, residual=residual, relu=relu)


class Dense(nn.Module):
    """f32 classifier; ``kernel`` is ``[out, in]``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(torch.float32), self.kernel, self.bias)


def _project(block: nn.Module, in_features: int, out_features: int,
             strides: Tuple[int, int], dtype: torch.dtype) -> None:
    """flax adds ``conv_proj``/``norm_proj`` when the residual's shape
    differs from the block output's (channels or stride)."""
    if in_features != out_features or tuple(strides) != (1, 1):
        block.conv_proj = Conv(in_features, out_features, (1, 1), strides, dtype)
        block.norm_proj = BatchNorm(out_features, dtype)


def _residual(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if hasattr(block, "conv_proj"):
        return block.norm_proj(block.conv_proj(x))
    return x


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: Tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), dtype=dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype, zero_scale=True)
        _project(self, in_features, filters * 4, strides, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.BatchNorm_1(self.Conv_1(y), relu=True)
        return self.BatchNorm_2(self.Conv_2(y), residual=_residual(self, x), relu=True)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: Tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, zero_scale=True)
        _project(self, in_features, filters, strides, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        return self.BatchNorm_1(self.Conv_1(y), residual=_residual(self, x), relu=True)


class ResNet(nn.Module):
    """NHWC-in ResNet; ``dtype`` is the compute dtype over f32 params."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), dtype)
        self.bn_init = BatchNorm(num_filters, dtype)
        self.blocks = []
        features = num_filters
        k = 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                block = block_cls(features, filters, strides, dtype)
                name = f"{block_cls.__name__}_{k}"
                self.add_module(name, block)
                self.blocks.append(name)
                features = filters * block_cls.expansion
                k += 1
        self.Dense_0 = Dense(features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        x = self.bn_init(self.conv_init(x), relu=True)
        x, _ = _pad_same(x, (3, 3), (2, 2), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)


@torch.no_grad()
def init_flax_like(module: nn.Module, seed: int) -> nn.Module:
    """Initialise parameters and batch statistics in place with flax's
    distributions, drawn on the CPU from ``torch.Generator(seed)`` in
    parameter-name order (the bits differ from ``jax.random``; the
    distributions match)."""
    gen = torch.Generator().manual_seed(seed)
    for _name, m in sorted(module.named_modules()):
        if isinstance(m, (Conv, Dense)):
            w = m.kernel
            fan_in = w[0].numel()  # I*kh*kw for OIHW, in for [out, in]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw = torch.empty(w.shape)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
            w.copy_(draw)
            if isinstance(m, Dense):
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.scale.fill_(0.0 if m.zero_scale else 1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    return module
