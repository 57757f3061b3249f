# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Long-context training through ring attention: one model, the sequence
sharded over ``size`` workers.

Counterpart of ``examples/long_context.py``. Each worker holds one block of
``block`` tokens of every sequence; here the workers' blocks are folded
into the batch (``[size * batch, block]``, worker-major), each row embeds
its global positions (``pos_offset = worker * block``), and every block's
attention is :func:`~bluefog_tpu_torch.ops.ring_attention` over the worker
axis. The loss is the whole sequence's mean next-token loss (the JAX
example's ``sp_global_loss`` with its ``psum``); its gradient is the sum of
the workers' partial gradients, which one backward through the folded
batch gives directly.
"""

from typing import Callable

import torch
import torch.nn.functional as F

from bluefog_tpu_torch.ops.attention import ring_attention

__all__ = ["ring_attend", "shard_sequence", "sp_global_loss"]


def ring_attend(size: int, causal: bool = True) -> Callable:
    """An ``attend(q, k, v)`` for :class:`TransformerLM` whose ``[size *
    batch, block, heads, head_dim]`` inputs are ``size`` workers' blocks
    folded into the batch: ring attention over the workers."""

    def attend(q, k, v):
        rows, t, h, d = q.shape
        unfold = lambda x: x.reshape((size, rows // size) + tuple(x.shape[1:]))
        out = ring_attention(unfold(q), unfold(k), unfold(v), causal=causal)
        return out.reshape(rows, t, h, d)

    return attend


def shard_sequence(a: torch.Tensor, size: int) -> torch.Tensor:
    """``[batch, size * block]`` -> ``[size, batch, block]`` (the JAX
    example's ``np.stack(np.split(a, size, axis=1))``)."""
    return torch.stack(torch.chunk(a, size, dim=1))


def sp_global_loss(model, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss over the whole sequence from the worker-stacked
    ``tokens`` and ``targets`` ``[size, batch, block]`` (a block's last
    target is the first token of the next block): every block's summed
    cross-entropy, over ``batch * size * block``. ``model`` is a
    :class:`TransformerLM` built with ``attend=ring_attend(size)``."""
    size, batch, block = tokens.shape
    offsets = torch.arange(size).repeat_interleave(batch) * block
    logits = model(tokens.reshape(size * batch, block), pos_offset=offsets)
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                             targets.reshape(-1), reduction="sum")
    return losses / (batch * size * block)
