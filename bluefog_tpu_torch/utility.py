# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Initial-state synchronization of parameter trees.

Counterpart of ``bluefog_tpu/utility.py``. A tree is a tensor or a
(nested) dict, list or tuple of worker tensors ``[size, ...]``; each
helper returns a new tree of the same structure. Across processes the
leaves are this process's rows ``[n_local, ...]``.
"""

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch.collective import inner

__all__ = [
    "broadcast_parameters",
    "broadcast_optimizer_state",
    "allreduce_parameters",
]


def _tree_map(fn, tree):
    """``fn`` on every worker tensor of ``tree``, checked to be
    worker-stacked on the context's device."""
    ctx = ctx_mod.get_context()

    def visit(t):
        if isinstance(t, dict):
            return {k: visit(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(visit(v) for v in t)
        if t.dim() < 1 or t.shape[0] != ctx.n_local:
            raise ValueError(
                f"leaf must be worker-stacked [size={ctx.n_local}, ...]; got shape "
                f"{tuple(t.shape)}"
            )
        return fn(t)

    return visit(tree)


def _check_root(root_rank: int) -> None:
    size = ctx_mod.get_context().size
    if not 0 <= root_rank < size:
        raise ValueError(f"root_rank {root_rank} out of range for {size} workers")


def broadcast_parameters(params, root_rank: int = 0):
    """Every worker's slot of every leaf becomes the root worker's."""
    _check_root(root_rank)
    return _tree_map(lambda t: inner.broadcast(t, root_rank), params)


def broadcast_optimizer_state(opt_state, root_rank: int = 0):
    """:func:`broadcast_parameters` of an optimizer state tree."""
    _check_root(root_rank)
    return _tree_map(lambda t: inner.broadcast(t, root_rank), opt_state)


def allreduce_parameters(params):
    """Every leaf averaged over the workers."""
    return _tree_map(lambda t: inner.allreduce(t, average=True), params)
