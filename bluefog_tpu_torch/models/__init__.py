# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Models: ResNet and the transformer LM (flax-equivalent), and the
stacked-worker trainer. Each model module has its own ``init_flax_like``
(``resnet.init_flax_like``, ``transformer.init_flax_like``)."""

from bluefog_tpu_torch.models import resnet, transformer
from bluefog_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
)
from bluefog_tpu_torch.models.stacked import (
    StackedModel,
    classification_loss,
    next_token_loss,
)
from bluefog_tpu_torch.models.transformer import TransformerLM

__all__ = [
    "BasicBlock",
    "BottleneckBlock",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "TransformerLM",
    "StackedModel",
    "classification_loss",
    "next_token_loss",
    "resnet",
    "transformer",
]
