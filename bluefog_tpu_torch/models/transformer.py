# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Decoder-only transformer LM, numerically following the flax model of the
JAX package.

Counterpart of ``bluefog_tpu/models/transformer.py``. Submodule and
parameter names are the flax names (``Embed_0.embedding``, ``pos``,
``Block_3.Dense_0.kernel``, ``Block_3.LayerNorm_1.scale``, ``LayerNorm_0``
and ``Dense_0`` after the blocks), so a parameter path maps one to one onto
the flax params tree. Dense kernels are held as ``[out, in]``
(:mod:`bluefog_tpu_torch.interop` converts); the embedding and the position
table have the same layout in both frameworks.

Where flax and PyTorch differ, this follows flax:

- LayerNorm: epsilon 1e-6, f32 statistics from the fast variance ``E[x^2]
  - E[x]^2`` (clipped at 0), the normalisation in f32, the result in the
  compute dtype.
- Dense layers compute in ``dtype`` (kernel and input cast, product
  rounded, then the bias added); the attention projections have no bias;
  the LM head computes in f32.
- ``gelu`` is the tanh approximation.
- The position table is cast to the compute dtype before it is added.
- Initialisers: lecun-normal (truncated normal over fan-in) kernels, zero
  biases, ones and zeros for LayerNorm, the embedding ``normal(1 /
  sqrt(dim))`` (``variance_scaling(1, fan_in, normal)``), the position
  table ``normal(0.02)``.

``attend(q, k, v)`` on ``[batch, seq, heads, head_dim]`` defaults to the
port's causal flash attention (the CUDA kernels on the card);
``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``), with the same parameter names.
"""

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from bluefog_tpu_torch.models.resnet import _TRUNC_STD
from bluefog_tpu_torch.ops.flash import flash_attention

__all__ = ["Block", "TransformerLM", "init_flax_like"]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.epsilon = 1e-6
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mu) * mul + self.bias).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` is ``[out, in]``; computes in
    ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding [vocab, dim]``, the looked-up rows in
    ``dtype``."""

    def __init__(self, vocab: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, features))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding).to(self.dtype)


def _causal_flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


def _run_block(block: nn.Module, params, x: torch.Tensor) -> torch.Tensor:
    return functional_call(block, params, (x,))


class Block(nn.Module):
    """Pre-norm block: attention then a 4x MLP, each with a residual."""

    def __init__(self, dim: int, heads: int, attend: Callable, dtype: torch.dtype):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.dim, self.heads, self.attend = dim, heads, attend
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, 3 * dim, dtype, use_bias=False)
        self.Dense_1 = Dense(dim, dim, dtype, use_bias=False)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_2 = Dense(dim, 4 * dim, dtype)
        self.Dense_3 = Dense(4 * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        qkv = self.Dense_0(self.LayerNorm_0(x))
        q, k, v = (y.reshape(b, t, self.heads, self.dim // self.heads)
                   for y in qkv.split(self.dim, dim=-1))
        att = self.attend(q, k, v).reshape(b, t, self.dim)
        x = x + self.Dense_1(att)
        h = F.gelu(self.Dense_2(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_3(h)


class TransformerLM(nn.Module):
    """Causal LM on ``tokens [batch, seq]`` (int) -> logits ``[batch, seq,
    vocab]`` f32. ``dtype`` is the compute dtype over f32 parameters.
    ``pos_offset`` is the first global position of the rows: an int for
    all of them, or an integer tensor ``[batch]`` with one offset per row
    (sequence-sharded blocks folded into the batch, as the JAX model takes
    a traced per-worker offset). A position at or past ``max_len`` raises."""

    def __init__(self, vocab: int = 64, dim: int = 32, heads: int = 4, layers: int = 2,
                 max_len: int = 4096, dtype: torch.dtype = torch.float32,
                 attend: Optional[Callable] = None, remat: bool = False):
        super().__init__()
        self.vocab, self.dim, self.heads, self.layers = vocab, dim, heads, layers
        self.max_len, self.dtype, self.remat = max_len, dtype, remat
        attend = attend or _causal_flash
        self.Embed_0 = Embed(vocab, dim, dtype)
        self.pos = nn.Parameter(torch.empty(max_len, dim))
        for i in range(layers):
            self.add_module(f"Block_{i}", Block(dim, heads, attend, dtype))
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, vocab, torch.float32)

    def forward(self, tokens: torch.Tensor, pos_offset=0) -> torch.Tensor:
        t = tokens.shape[1]
        if isinstance(pos_offset, int):
            if t + pos_offset > self.max_len:
                raise ValueError(f"sequence of {t} tokens at offset {pos_offset} "
                                 f"exceeds max_len={self.max_len}")
            pos = (torch.arange(t, device=tokens.device) + pos_offset)[None]
        else:
            offsets = torch.as_tensor(pos_offset)
            if offsets.shape != (tokens.shape[0],) or offsets.is_floating_point():
                raise ValueError(f"pos_offset must be an int or one integer per row "
                                 f"[{tokens.shape[0]}], got {tuple(offsets.shape)} "
                                 f"{offsets.dtype}")
            last = t + int(offsets.max())
            if last > self.max_len:
                raise ValueError(f"block of {t} tokens at offset {last - t} "
                                 f"exceeds max_len={self.max_len}")
            pos = torch.arange(t, device=tokens.device)[None] + offsets.to(tokens.device)[:, None]
        x = self.Embed_0(tokens) + self.pos[pos].to(self.dtype)
        for i in range(self.layers):
            block = getattr(self, f"Block_{i}")
            if self.remat and torch.is_grad_enabled():
                # the recomputation runs after this forward has returned:
                # pin the parameters it used (functional_call's, under a
                # StackedModel), not the module's own
                params = dict(block.named_parameters())
                x = checkpoint(_run_block, block, params, x, use_reentrant=False)
            else:
                x = block(x)
        return self.Dense_0(self.LayerNorm_0(x))


@torch.no_grad()
def init_flax_like(module: nn.Module, seed: int) -> nn.Module:
    """Initialise a :class:`TransformerLM`'s parameters in place with
    flax's distributions, drawn on the CPU from ``torch.Generator(seed)`` in
    parameter-name order (the bits differ from ``jax.random``; the
    distributions match)."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in sorted(module.named_modules()):
        if isinstance(m, Dense):
            std = math.sqrt(1.0 / m.kernel.shape[1]) / _TRUNC_STD
            draw = torch.empty(m.kernel.shape)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
            m.kernel.copy_(draw)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Embed):
            w = m.embedding
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[1]))
        elif isinstance(m, TransformerLM):
            m.pos.copy_(torch.randn(m.pos.shape, generator=gen) * 0.02)
    return module
