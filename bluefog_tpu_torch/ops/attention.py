# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Sequence-parallel attention over the stacked worker axis, and dense
attention, the oracle of the flash kernels.

Counterpart of ``bluefog_tpu/ops/attention.py`` on ``[batch, seq, heads,
head_dim]`` tensors. The JAX package runs the sequence-parallel layers per
worker inside ``shard_map`` (``ring_attention_block``,
``ulysses_attention_block``) behind facades on worker-stacked arrays; here
the facades :func:`ring_attention` and :func:`ulysses_attention` take the
stacked ``[size, batch, block, heads, head_dim]`` tensors themselves
(worker ``i`` holds positions ``[i * block, (i + 1) * block)``), and the
transport becomes tensor indexing along the worker axis:

- ring: each round rotates the compact K/V by one gather along the worker
  axis (``i -> i + 1``, the JAX ``perm``) and runs one
  :func:`~bluefog_tpu_torch.ops.flash.flash_attention_with_lse` call with
  the workers folded into the batch; the blocks merge in f32 by their
  logsumexp (:func:`_merge_blocks`);
- Ulysses: the two ``all_to_all`` re-shardings become a reshape and a
  transpose across the worker axis around one
  :func:`~bluefog_tpu_torch.ops.flash.flash_attention` call.
"""

import math
from typing import Optional

import torch

__all__ = [
    "reference_attention",
    "ring_attention",
    "ulysses_attention",
]


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


def _merge_blocks(out_a, lse_a, out_b, lse_b):
    """Exactly combine two normalized attention results over disjoint key
    blocks by their logsumexps (the online-softmax merge): ``out`` ``[b, t,
    h, d]`` f32, ``lse`` ``[b, h, t]``; ``lse = -inf`` marks an empty or
    excluded block (weight zero)."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    wa = torch.where(torch.isfinite(lse_a), torch.exp(lse_a - m_safe), 0.0)
    wb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - m_safe), 0.0)
    tot = wa + wb
    tot_safe = torch.where(tot > 0, tot, 1.0)
    tr = lambda w: (w / tot_safe).transpose(1, 2)[..., None]
    out = tr(wa) * out_a + tr(wb) * out_b
    lse = torch.where(tot > 0, m_safe + torch.log(tot_safe), float("-inf"))
    return out, lse


def _check_stacked(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 5 or v.dim() != 5:
        raise ValueError("q, k, v must be worker-stacked [size, batch, block, heads, head_dim]")
    if k.shape != v.shape or k.shape[:3] != q.shape[:3] or k.shape[4] != q.shape[4]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "are not one sequence's blocks")


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``[size, b, ...]`` -> ``[size * b, ...]`` (a view where it can be)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def ring_attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Ring attention over worker-stacked ``[size, batch, block, heads,
    head_dim]`` tensors (K/V may carry fewer heads: grouped-query attention,
    kept compact on the ring and in the kernels). Returns the attention of
    the whole sequence for every worker's queries, in q's dtype.

    Round 0 attends each worker's own block (``causal`` as given); round
    ``r`` brings worker ``i`` the K/V block of worker ``(i - r) mod size``,
    which is wholly past or wholly future of its queries: a future block
    (``causal``) enters the merge with its logsumexp gated to -inf. Each
    round is one differentiable ``flash_attention_with_lse`` call on the
    workers folded into the batch (the flash kernels on the card: for bf16
    q/k/v all three on the ``sm90`` route, the backward taking the round's
    f32 cotangent as two bf16 halves; f32 q/k/v on ``simt``)."""
    from bluefog_tpu_torch.ops.flash import flash_attention_with_lse

    _check_stacked(q, k, v)
    n, b, t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = _fold(q)
    out_acc, lse_acc = flash_attention_with_lse(qf, _fold(k), _fold(v), causal=causal,
                                                scale=scale)
    me = torch.arange(n, device=q.device)
    prev = (me - 1) % n  # the ring's perm i -> i + 1: worker i receives from i - 1
    kcur, vcur = k, v
    for r in range(1, n):
        kcur, vcur = kcur.index_select(0, prev), vcur.index_select(0, prev)
        out_b, lse_b = flash_attention_with_lse(qf, _fold(kcur), _fold(vcur), causal=False,
                                                scale=scale)
        if causal:
            past = ((me - r) % n < me).repeat_interleave(b)
            lse_b = torch.where(past[:, None, None], lse_b, float("-inf"))
        out_acc, lse_acc = _merge_blocks(out_acc, lse_acc, out_b, lse_b)
    return out_acc.to(q.dtype).reshape(n, b, t, h, d)


def ulysses_attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """All-to-all (Ulysses) sequence-parallel attention over worker-stacked
    ``[size, batch, block, heads, head_dim]`` tensors: re-shard sequence ->
    heads (worker ``w`` gets heads ``[w h / size, (w + 1) h / size)`` of the
    whole sequence), one ``flash_attention`` call on the workers folded
    into the batch, and re-shard back. The head count must divide by the
    worker count; grouped-query K/V stays compact when its head count does
    too and is expanded to the query heads otherwise."""
    from bluefog_tpu_torch.ops.flash import flash_attention

    _check_stacked(q, k, v)
    n, b, t, h, d = q.shape
    h_kv = k.shape[3]
    if h % n != 0:
        raise ValueError(f"ulysses attention needs heads ({h}) divisible by mesh size ({n})")
    if h % h_kv != 0:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({h_kv})")
    if h_kv % n != 0:
        k = k.repeat_interleave(h // h_kv, dim=3)
        v = v.repeat_interleave(h // h_kv, dim=3)

    def seq_to_heads(x):
        # [src, b, t, (dst, hh), d] -> [dst, b, (src, t), hh, d]
        hh = x.shape[3] // n
        y = x.reshape(n, b, t, n, hh, d).permute(3, 1, 0, 2, 4, 5)
        return y.reshape(n * b, n * t, hh, d)

    def heads_to_seq(y):
        # [dst, b, (src, t), hh, d] -> [src, b, t, (dst, hh), d]
        hh = y.shape[2]
        x = y.reshape(n, b, n, t, hh, d).permute(2, 1, 3, 0, 4, 5)
        return x.reshape(n, b, t, n * hh, d)

    out = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal,
                          scale=scale)
    return heads_to_seq(out)
