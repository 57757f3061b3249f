# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""bluefog_tpu_torch — the PyTorch/CUDA port of bluefog_tpu.

N virtual workers live on one GPU as the leading axis of ``[N, ...]``
tensors; a gossip round is a gather along that axis. The facade mirrors
``bluefog_tpu``'s names for the ported slice: ``init`` and the topology
queries, ``worker_values`` and ``neighbor_allreduce`` (exact or with the
int8/int4 wire), and the neighbor-allreduce gossip optimizers. The
quantized wire runs through hand-written CUDA kernels for Hopper
(``csrc/wire_kernels.cu``). Entry points run on ``"cuda"`` unless
``device="cpu"`` is passed.
"""

from bluefog_tpu_torch import topology
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
    sgd,
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
]
