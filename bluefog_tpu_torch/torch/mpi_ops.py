# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Differentiable collectives over the port's facade.

Counterpart of ``bluefog_tpu/torch/mpi_ops.py``. Tensors are worker
tensors (leading axis = worker) on the context's device; the forwards are
the facade's calls (:mod:`bluefog_tpu_torch.collective.ops`), with its
timeline spans and flight records, and ``torch.autograd`` gets the JAX
frontend's adjoints:

- ``allreduce``: the same reduction of the incoming gradient;
- ``broadcast``: reduce-to-root (the root's slot gets the sum of every
  slot's gradient, the others zero);
- ``neighbor_allreduce``: ``y = W^T x`` forward, exact or on the bf16,
  int8 or int4 wire (on the card int8 and int4 go through the ``encode``
  and ``decode_accumulate`` kernels); the adjoint ``W g`` always in full
  precision, the exact combine over the transposed weights.

A forward runs with gradients off, so the facade's in-place work on its
own buffers is never recorded. ``allgather`` and ``neighbor_allgather``
are not differentiable, as in JAX.

dtypes follow the JAX frontend on every input it accepts: int64 sums and
the ops that only move bits return int64, averages and
``neighbor_allreduce`` float32. The JAX frontend refuses four inputs only
because its mesh computes in 32 bits: float64 and complex128, int64
outside int32, an int64 sum that overflows int32, and an int64 average
past 2**24 (where float32 stops being exact). The port has no such mesh
and answers them in 64 bits: the 64-bit dtypes flow through, int64 sums
stay int64, and those int64 averages (and a ``neighbor_allreduce`` of
int64 outside int32) run in float64.
"""

from typing import List

import numpy as np
import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch.collective import ops as col_ops
from bluefog_tpu_torch.collective import transport
from bluefog_tpu_torch.collective.plan import plan_from_matrix

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_F32_EXACT = 2**24  # the largest |integer| below which float32 is exact


def _int64_magnitude(t: torch.Tensor) -> int:
    """The largest ``|value|`` of an int64 worker tensor over every
    process's rows (0 when empty)."""
    mx = max(t.max().item(), -t.min().item()) if t.numel() else 0
    return transport.fleet_max([mx], ctx_mod.get_context())[0]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Torch -> numpy. A bfloat16 tensor leaves as its bits in
    ``np.uint16`` (numpy has no bf16; they are the bits of JAX's
    ``ml_dtypes.bfloat16`` array, and :func:`from_numpy` with
    ``dtype=torch.bfloat16`` reads them back). int64 whose values fit
    int32 is narrowed without loss, as the JAX frontend narrows it; other
    int64, float64 and complex128 pass through as they are."""
    t = t.detach()
    if t.dtype == torch.int64 and t.numel() and (
        _INT32_MIN <= t.min().item() and t.max().item() <= _INT32_MAX
    ):
        t = t.to(torch.int32)
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(a, dtype=None) -> torch.Tensor:
    """numpy -> torch (a copy). ``dtype=torch.bfloat16`` reads 16-bit
    bits (:func:`to_numpy`'s ``np.uint16``) as bfloat16; any other
    ``dtype`` converts."""
    a = np.array(a)
    if dtype == torch.bfloat16 and a.dtype in (np.uint16, np.int16):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


class _Allreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, average):
        ctx.average = average
        x = t
        if average and t.dtype == torch.int64:
            size = ctx_mod.get_context().size
            if _int64_magnitude(t) * size > _F32_EXACT:
                x = t.to(torch.float64)  # float32 would round the mean
        return col_ops.allreduce(x, average=average)

    @staticmethod
    def backward(ctx, grad):
        # y_j = (1/n) sum_i x_i (or the sum): the same reduction of the
        # incoming gradients
        return col_ops.allreduce(grad, average=ctx.average), None


def allreduce(t: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Global mean (or sum) across workers; differentiable."""
    return _Allreduce.apply(t, average)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, root_rank):
        ctx.root_rank = root_rank
        return col_ops.broadcast(t, root_rank)

    @staticmethod
    def backward(ctx, grad):
        # every slot's gradient flows back to the root slot
        summed = col_ops.allreduce(grad, average=False)
        g = torch.zeros_like(summed)
        rows = ctx_mod.get_context().rows
        if ctx.root_rank in rows:
            i = ctx.root_rank - rows.start
            g[i] = summed[i]
        return g, None


def broadcast(t: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every worker slot becomes the root's value; differentiable."""
    return _Broadcast.apply(t, root_rank)


def _combine_with_plan(t: torch.Tensor, plan, compression=None) -> torch.Tensor:
    """The facade's combine over an explicit plan (forward and backward
    share it): one ``ENQUEUE`` span and one blocking wait."""
    x = col_ops._check_worker_tensor(ctx_mod.get_context(), t)
    return col_ops.synchronize(col_ops._combine_nonblocking(x, plan, compression))


class _NeighborAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, self_weight, src_weights, dst_weights, enable_topo_check,
                compression):
        # resolved once: the backward transposes these weights even if the
        # topology changes in between
        ctx.plan = col_ops._resolve_plan(ctx_mod.get_context(), self_weight, src_weights,
                                         dst_weights, enable_topo_check)
        x = t
        if compression is None and t.dtype == torch.int64:
            if _int64_magnitude(t) > _INT32_MAX:
                x = t.to(torch.float64)
        return _combine_with_plan(x, ctx.plan, compression)

    @staticmethod
    def backward(ctx, grad):
        # forward y = W^T x (rows = workers); the adjoint W g is the exact
        # combine over the transposed matrix: a quantized gradient would
        # bias training beyond the forward's bounded rounding error
        plan_t = plan_from_matrix(ctx.plan.weight_matrix().T)
        return _combine_with_plan(grad, plan_t), None, None, None, None, None


def neighbor_allreduce(
    t: torch.Tensor,
    *,
    self_weight=None,
    src_weights=None,
    dst_weights=None,
    enable_topo_check: bool = True,
    compression=None,
) -> torch.Tensor:
    """Weighted neighbour combine over the active (or explicit, or
    dynamic) weights, the facade's weight policy; differentiable (the
    adjoint is the transposed-weight combine, always full precision).
    ``compression='int8'|'bf16'|'int4'`` quantizes the forward wire."""
    col_ops._check_compression(compression)
    return _NeighborAllreduce.apply(
        t, self_weight, src_weights, dst_weights, enable_topo_check, compression,
    )


def allgather(t: torch.Tensor) -> torch.Tensor:
    """Every worker's slot concatenated along dim 0, per worker (not
    differentiable)."""
    return col_ops.allgather(t.detach())


def neighbor_allgather(t: torch.Tensor) -> List[torch.Tensor]:
    """Raw in-neighbour values per rank, rank-ascending; entry ``r`` has
    shape ``[in_degree_r, ...]`` (not differentiable)."""
    return col_ops.neighbor_allgather(t.detach())
