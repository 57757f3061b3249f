# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Attention ops: the flash kernels, the sequence-parallel layers (ring,
Ulysses) and their dense oracle; and the ResNets' BatchNorm."""

from bluefog_tpu_torch.ops.attention import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from bluefog_tpu_torch.ops.batchnorm import batch_norm
from bluefog_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_supported,
    flash_attention_with_lse,
)

__all__ = [
    "reference_attention",
    "ring_attention",
    "ulysses_attention",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_supported",
    "batch_norm",
]
