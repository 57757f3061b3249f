# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Models: ResNet, the transformer LM, the MLP and the MNIST conv net
(flax-equivalent), the stacked-worker trainer, and sequence-parallel
training through ring attention (:mod:`long_context`). Each model module
has its own ``init_flax_like`` (``resnet``, ``transformer``, ``mlp``)."""

from bluefog_tpu_torch.models import long_context, mlp, resnet, transformer
from bluefog_tpu_torch.models.mlp import MLP, MnistCNN
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
    "MLP",
    "MnistCNN",
    "StackedModel",
    "classification_loss",
    "next_token_loss",
    "long_context",
    "mlp",
    "resnet",
    "transformer",
]
