# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""bluefog_tpu_torch — the PyTorch/CUDA port of bluefog_tpu.

N virtual workers live on one GPU as the leading axis of ``[N, ...]``
tensors; a gossip round is a gather along that axis. The facade mirrors
``bluefog_tpu``'s names for the ported slice: ``init`` and the topology
queries, ``worker_values`` and ``neighbor_allreduce`` (exact or with the
int8/int4 wire), the neighbor-allreduce gossip optimizers (with the
int8/int4 wires and their error-feedback tiers int8_ef/int4_ef), the
window ops (``win_*``, the associated-p lane) and the window optimizers
(win-put, pull-get, push-sum), and ``ops`` (``flash_attention``,
``flash_attention_with_lse``, ``reference_attention``); the models
(ResNet, ``TransformerLM``) are in :mod:`bluefog_tpu_torch.models`. The
quantized wires and the attention run through hand-written CUDA kernels
for Hopper (``csrc/wire_kernels.cu``, ``csrc/flash_kernels.cu``). Entry
points run on ``"cuda"`` unless ``device="cpu"`` is passed.
"""

from bluefog_tpu_torch import ops, topology
from bluefog_tpu_torch.collective.ops import neighbor_allreduce, worker_values
from bluefog_tpu_torch.context import (
    BluefogContext,
    get_context,
    init,
    is_initialized,
    shutdown,
)
from bluefog_tpu_torch.optimizers import (
    DistributedAdaptThenCombineOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedPullGetOptimizer,
    DistributedPushSumOptimizer,
    DistributedWinPutOptimizer,
    sgd,
)
from bluefog_tpu_torch.windows import (
    get_current_created_window_names,
    get_win_version,
    turn_off_win_ops_with_associated_p,
    turn_on_win_ops_with_associated_p,
    win_accumulate,
    win_accumulate_nonblocking,
    win_associated_p,
    win_create,
    win_free,
    win_get,
    win_get_nonblocking,
    win_poll,
    win_put,
    win_put_nonblocking,
    win_read,
    win_update,
    win_update_then_collect,
    win_wait,
)


def size() -> int:
    return get_context().size


def set_topology(topology, is_weighted: bool = False) -> bool:
    return get_context().set_topology(topology, is_weighted)


def load_topology():
    return get_context().load_topology()


def is_topo_weighted() -> bool:
    return get_context().is_topo_weighted()


def in_neighbor_ranks(rank: int = None):
    return get_context().in_neighbor_ranks(rank)


def out_neighbor_ranks(rank: int = None):
    return get_context().out_neighbor_ranks(rank)


__all__ = [
    "ops",
    "topology",
    "BluefogContext",
    "init",
    "shutdown",
    "is_initialized",
    "get_context",
    "size",
    "set_topology",
    "load_topology",
    "is_topo_weighted",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "worker_values",
    "neighbor_allreduce",
    "sgd",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedAdaptThenCombineOptimizer",
    "DistributedWinPutOptimizer",
    "DistributedPullGetOptimizer",
    "DistributedPushSumOptimizer",
    "win_create",
    "win_free",
    "win_read",
    "win_put",
    "win_put_nonblocking",
    "win_get",
    "win_get_nonblocking",
    "win_accumulate",
    "win_accumulate_nonblocking",
    "win_update",
    "win_update_then_collect",
    "win_wait",
    "win_poll",
    "get_win_version",
    "get_current_created_window_names",
    "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
    "win_associated_p",
]
