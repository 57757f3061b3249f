# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Decentralized gossip optimizers over stacked worker tensors.

Counterpart of ``bluefog_tpu/optimizers.py`` for the neighbor-allreduce
family: :func:`DistributedNeighborAllreduceOptimizer` (combine-then-adapt,
CTA) and :func:`DistributedAdaptThenCombineOptimizer` (adapt-then-combine,
ATC), with the ``compression`` attribute (``None``, ``"int8"``,
``"int4"``) selecting the exact combine or the quantized wire.

A parameter tree is a tensor or a (nested) dict of tensors, each
``[size, ...]`` with the worker axis first. Leaves are ordered as
``jax.tree_util`` orders a dict (keys sorted at every level) and packed
per dtype group into one flat payload before the combine, exactly as the
JAX ``_packed_gossip`` does — the quantized wire's 512-element scale
blocks span leaf boundaries, so the packing order is part of the wire
format. A single-leaf group (e.g. the flat parameter buffer of
:class:`bluefog_tpu_torch.models.stacked.StackedModel`) is gossiped in
place with no pack copy.

Unlike optax's pure functions, :meth:`_GossipOptimizer.step` updates the
given parameter and state tensors in place (it saves a model-sized copy
per step) and returns them.
"""

from typing import Callable, List, Optional

import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch.collective import inner

__all__ = [
    "SGD",
    "sgd",
    "tree_leaves",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedAdaptThenCombineOptimizer",
]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _tree_zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _tree_zeros_like(v) for k, v in tree.items()}
    return type(tree)(_tree_zeros_like(t) for t in tree)


class SGD:
    """Functional SGD whose numbers equal ``optax.sgd(lr, momentum)``:
    the trace is ``g + momentum * trace`` from zero, and the update
    ``-lr * trace`` (``-lr * g`` without momentum) is added to the
    parameters — each as its own rounding step, never fused."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None):
        self.learning_rate = float(learning_rate)
        self.momentum = None if momentum is None else float(momentum)

    def init(self, params):
        """The momentum trace (zeros like ``params``), or ``()``."""
        return () if self.momentum is None else _tree_zeros_like(params)

    def apply_(self, params, state, grads) -> None:
        """One update of ``params`` (and the trace in ``state``) in place."""
        p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        t_leaves = tree_leaves(state) if self.momentum is not None else g_leaves
        if not len(p_leaves) == len(g_leaves) == len(t_leaves):
            raise ValueError("params, grads and state differ in structure")
        for p, g, t in zip(p_leaves, g_leaves, t_leaves):
            if self.momentum is not None:
                t.mul_(self.momentum).add_(g)
            p.add_(t * (-self.learning_rate))


def sgd(learning_rate: float, momentum: Optional[float] = None) -> SGD:
    """``optax.sgd`` counterpart (no Nesterov)."""
    return SGD(learning_rate, momentum)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _packed_gossip(tree, gossip_fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    """Gossip every leaf of ``tree`` in place, packed per dtype group in
    JAX leaf order (groups sorted by dtype name, as ``_dtype_groups``)."""
    leaves = tree_leaves(tree)
    groups = {}
    for leaf in leaves:
        groups.setdefault(_dtype_name(leaf.dtype), []).append(leaf)
    for _name, group in sorted(groups.items()):
        if len(group) == 1:
            leaf = group[0]
            out = gossip_fn(leaf)
            if out.data_ptr() != leaf.data_ptr():
                leaf.copy_(out)
            continue
        n_workers = group[0].shape[0]
        flat = torch.cat([leaf.reshape(n_workers, -1) for leaf in group], dim=1)
        out = gossip_fn(flat)
        off = 0
        for leaf in group:
            n = leaf[0].numel()
            leaf.copy_(out[:, off:off + n].reshape(leaf.shape))
            off += n


def _combine_update(order: str, tx: SGD, gossip_fn, params, state, grads) -> None:
    """CTA gossips the parameters before the inner update, ATC after."""
    if order == "cta":
        _packed_gossip(params, gossip_fn)
    tx.apply_(params, state, grads)
    if order == "atc":
        _packed_gossip(params, gossip_fn)


class _GossipOptimizer:
    """Shared engine of the neighbor-allreduce optimizers.

    ``compression``: ``None`` (exact combine), ``"int8"`` or ``"int4"``
    (block-scaled quantized wire, difference form, through the CUDA wire
    kernels on the card)."""

    _COMPRESSIONS = (None, "int8", "int4")

    def __init__(self, base_optimizer: SGD, order: str):
        if order not in ("cta", "atc"):
            raise ValueError(f"order must be 'cta' or 'atc', got {order!r}")
        self.tx = base_optimizer
        self.order = order
        self.compression: Optional[str] = None

    def init(self, params):
        """Per-worker inner-optimizer state (stacked like ``params``)."""
        return self.tx.init(params)

    def _gossip_fn(self, ctx):
        if self.compression not in self._COMPRESSIONS:
            raise ValueError(
                f"compression must be one of {self._COMPRESSIONS}, got "
                f"{self.compression!r}"
            )
        plan = ctx.static_plan()
        src, self_w, recv_w = inner.plan_operands(plan, ctx.device)
        if self.compression is None:
            return lambda t: inner.weighted_combine_operands(t, src, self_w, recv_w)
        inner._check_combine_normalized(plan, f"compression={self.compression!r}")
        wire = self.compression
        return lambda t: inner.weighted_combine_quantized_operands(
            t, src, recv_w, wire=wire, inplace=True
        )

    def step(self, params, state, grads):
        """One decentralized step over the active topology; updates
        ``params`` and ``state`` in place and returns ``(params, state)``."""
        ctx = ctx_mod.get_context()
        _combine_update(
            self.order, self.tx, self._gossip_fn(ctx), params, state, grads
        )
        return params, state


def DistributedNeighborAllreduceOptimizer(base_optimizer: SGD) -> _GossipOptimizer:
    """CTA with neighbor weight gossip, the flagship decentralized
    optimizer."""
    return _GossipOptimizer(base_optimizer, order="cta")


def DistributedAdaptThenCombineOptimizer(base_optimizer: SGD) -> _GossipOptimizer:
    """ATC: local step first, then gossip the updated weights."""
    return _GossipOptimizer(base_optimizer, order="atc")
