# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Models: ResNet (flax-equivalent) and the stacked-worker trainer."""

from bluefog_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
    init_flax_like,
)
from bluefog_tpu_torch.models.stacked import StackedModel

__all__ = [
    "BasicBlock",
    "BottleneckBlock",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "StackedModel",
    "init_flax_like",
]
