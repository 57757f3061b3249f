# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Eager collective facade over the active context.

Counterpart of ``bluefog_tpu/collective/ops.py`` for the static-topology
neighbor averaging. Inputs are worker tensors ``[size, ...]`` on the
context's device; calls run eagerly (no handles to synchronise).
"""

from typing import Optional

import numpy as np
import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch.collective import inner

__all__ = ["worker_values", "neighbor_allreduce"]

_COMPRESSIONS = (None, "int8", "int4")


def worker_values(values, dtype=None) -> torch.Tensor:
    """Stack per-worker values into a ``[size, ...]`` tensor on the
    context's device. ``values`` is a callable ``rank -> array``, a
    sequence of per-rank arrays, or one array broadcast to every worker."""
    ctx = ctx_mod.get_context()
    if callable(values):
        stacked = np.stack([np.asarray(values(r)) for r in range(ctx.size)])
    elif isinstance(values, (list, tuple)):
        if len(values) != ctx.size:
            raise ValueError(
                f"expected {ctx.size} per-worker values, got {len(values)}"
            )
        stacked = np.stack([np.asarray(v) for v in values])
    else:
        arr = np.asarray(values)
        stacked = np.broadcast_to(arr, (ctx.size,) + arr.shape)
    out = torch.from_numpy(np.ascontiguousarray(stacked)).to(ctx.device)
    return out if dtype is None else out.to(dtype)


def _check_worker_tensor(ctx, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[0] != ctx.size:
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(
            f"expected a worker tensor with leading axis {ctx.size}, got {shape}"
        )
    if x.device != ctx.device:
        raise ValueError(f"x is on {x.device}, the context on {ctx.device}")
    return x


def neighbor_allreduce(x: torch.Tensor, *, compression: Optional[str] = None,
                       name: Optional[str] = None) -> torch.Tensor:
    """Weighted averaging with in-neighbors over the active topology
    (topology weights if the context is weighted, else the uniform
    ``1/(in_degree+1)``). ``compression='int8'`` or ``'int4'`` ships the
    block-scaled quantized wire through the CUDA ``encode`` and
    ``decode_accumulate`` kernels. ``name`` is accepted for API parity."""
    if compression not in _COMPRESSIONS:
        raise ValueError(
            f"compression must be one of {_COMPRESSIONS}, got {compression!r}"
        )
    ctx = ctx_mod.get_context()
    x = _check_worker_tensor(ctx, x)
    plan = ctx.static_plan()
    if compression is None:
        return inner.neighbor_allreduce(x, plan)
    return inner.weighted_combine_quantized(x, plan, wire=compression)
