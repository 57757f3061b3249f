# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Distributed wrappers for ``torch.optim`` over the port's facade.

Counterpart of ``bluefog_tpu/torch/optimizers.py``. Every parameter
handled here is a worker tensor ``[size, ...]``, one slot per worker.
The factories specialize the user's optimizer **in place**: its class is
swapped for a subclass whose ``step`` does the communication first, so
the result is the user's own ``torch.optim.Optimizer`` and LR schedulers,
``state_dict`` round trips and ``add_param_group`` keep working.
"""

from typing import Dict, Iterable, Union

import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch.torch import mpi_ops

__all__ = [
    "DistributedGradientAllreduceOptimizer",
    "DistributedNeighborAllreduceOptimizer",
    "broadcast_parameters",
]


def _check_stacked(p: torch.Tensor) -> None:
    n = ctx_mod.get_context().n_local
    if p.dim() < 1 or p.shape[0] != n:
        raise ValueError(
            f"distributed torch parameters must be worker-stacked "
            f"[size={n}, ...]; got shape {tuple(p.shape)}"
        )


def _specialize(optimizer: torch.optim.Optimizer, name: str, communicate):
    """Swap the instance's class for a subclass whose ``step`` runs
    ``communicate(self)`` before the base step (state, param groups and
    schedulers are kept)."""
    base = optimizer.__class__

    @torch.no_grad()
    def step(self, closure=None):
        communicate(self)
        return base.step(self, closure)

    def add_param_group(self, group):
        # materialize first (params is often a generator, which validation
        # would exhaust), and validate before the base registers the group,
        # so a failure leaves the optimizer as it was
        params = group["params"]
        params = [params] if isinstance(params, torch.Tensor) else list(params)
        group["params"] = params
        for p in params:
            _check_stacked(p)
        return base.add_param_group(self, group)

    for group in optimizer.param_groups:
        for p in group["params"]:
            _check_stacked(p)
    optimizer.__class__ = type(name, (base,), {"step": step, "add_param_group": add_param_group})
    return optimizer


def _iter_params(optimizer):
    for group in optimizer.param_groups:
        yield from group["params"]


def DistributedGradientAllreduceOptimizer(optimizer: torch.optim.Optimizer):
    """Average the gradients across workers before the inner step
    (Horovod-style synchronous data parallelism)."""

    def communicate(self):
        for p in _iter_params(self):
            if p.grad is not None:
                p.grad.copy_(mpi_ops.allreduce(p.grad, average=True))

    return _specialize(optimizer, "DistributedGradientAllreduceOptimizer", communicate)


def DistributedNeighborAllreduceOptimizer(optimizer: torch.optim.Optimizer):
    """Combine-then-adapt neighbour gossip of the parameters. Dynamic
    weights follow the reference idiom: assign ``opt.self_weight``,
    ``opt.src_weights``, ``opt.dst_weights`` (and ``enable_topo_check``,
    ``compression``) between steps."""

    def communicate(self):
        for p in _iter_params(self):
            p.data.copy_(mpi_ops.neighbor_allreduce(
                p.data,
                self_weight=self.self_weight,
                src_weights=self.src_weights,
                dst_weights=self.dst_weights,
                enable_topo_check=self.enable_topo_check,
                compression=self.compression,
            ))

    opt = _specialize(optimizer, "DistributedNeighborAllreduceOptimizer", communicate)
    opt.self_weight = None
    opt.src_weights = None
    opt.dst_weights = None
    opt.enable_topo_check = True
    opt.compression = None
    return opt


@torch.no_grad()
def broadcast_parameters(
    params: Union[Iterable[torch.Tensor], Dict[str, torch.Tensor]],
    root_rank: int = 0,
) -> None:
    """Broadcast worker tensors in place so that every slot starts from
    the root's values. Takes an iterable of tensors or a dict of them (a
    module's ``state_dict()``); values that are not tensors are skipped,
    a tensor that is not worker-stacked raises."""
    size = ctx_mod.get_context().size
    if not 0 <= root_rank < size:
        raise ValueError(f"root_rank {root_rank} out of range for {size} workers")
    tensors = params.values() if isinstance(params, dict) else params
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        _check_stacked(t)
        t.data.copy_(mpi_ops.broadcast(t.data, root_rank))
