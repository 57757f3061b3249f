# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Dense attention: the oracle of the flash kernels.

Counterpart of the dense part of ``bluefog_tpu/ops/attention.py``
(``_expand_kv``, ``reference_attention``) on ``[batch, seq, heads,
head_dim]`` tensors. The sequence-parallel layers (ring, Ulysses) and the
block merge come with the sequence-parallel slice.
"""

import math
from typing import Optional

import torch

__all__ = ["reference_attention"]


def _expand_kv(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention: K/V may carry fewer heads than Q (``h %
    h_kv == 0``); repeat each KV head over its query group."""
    h, h_kv = q.shape[2], kv.shape[2]
    if h == h_kv:
        return kv
    if h % h_kv != 0:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({h_kv})")
    return kv.repeat_interleave(h // h_kv, dim=2)


def causal_keep(tq: int, tk: int, device) -> torch.Tensor:
    """``[tq, tk]`` bool: query ``i`` sees key ``j`` iff ``j <= i + tk -
    tq`` (``jnp.tril(ones, k=tk - tq)``)."""
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril(tk - tq)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention on ``[batch, seq, heads, dim]`` tensors, in
    the inputs' dtype. K/V with fewer heads than Q run grouped-query
    attention (each KV head serves ``h / h_kv`` query heads)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _expand_kv(q, k), _expand_kv(q, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(~causal_keep(s.shape[-2], s.shape[-1], s.device), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
