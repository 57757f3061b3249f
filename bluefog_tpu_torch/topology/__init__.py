# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Topology generators (numpy weight matrices), their comparisons and
spectral analysis (:mod:`~bluefog_tpu_torch.topology.spectral`), the
dynamic one-peer schedules, the inference of one direction of a dynamic
graph from the other, and the fabric model of the plan compiler's relay
routes (:mod:`~bluefog_tpu_torch.topology.placement`)."""

from bluefog_tpu_torch.topology.dynamic import (
    GetDynamicOnePeerSendRecvRanks,
    GetExp2DynamicSendRecvMachineRanks,
    GetInnerOuterExpo2DynamicSendRecvRanks,
    GetInnerOuterRingDynamicSendRecvRanks,
    one_peer_period_edges,
    one_peer_period_matrices,
)
from bluefog_tpu_torch.topology.graphs import (
    ExponentialGraph,
    ExponentialTwoGraph,
    FullyConnectedGraph,
    GetRecvWeights,
    GetSendWeights,
    IsRegularGraph,
    IsTopologyEquivalent,
    MeshGrid2DGraph,
    RandomRegularDigraph,
    RingGraph,
    StarGraph,
    SymmetricExponentialGraph,
    consensus_decay_rate,
    consensus_decay_rate_info,
    edges,
    isPowerOf,
    mixing_matrix,
    second_largest_eigenvalue_modulus,
    second_largest_eigenvalue_modulus_info,
    spectral_gap,
)
from bluefog_tpu_torch.topology.infer import (
    InferDestinationFromSourceRanks,
    InferSourceFromDestinationRanks,
)
from bluefog_tpu_torch.topology.placement import (
    serpentine_device_order,
    worker_device_order,
)
from bluefog_tpu_torch.topology.spectral import (
    EdgeMatrix,
    edges_from_dense,
    live_submatrix_edges,
    spectral_dense_max,
)

__all__ = [
    "ExponentialGraph",
    "ExponentialTwoGraph",
    "SymmetricExponentialGraph",
    "MeshGrid2DGraph",
    "RandomRegularDigraph",
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "InferSourceFromDestinationRanks",
    "InferDestinationFromSourceRanks",
    "FullyConnectedGraph",
    "GetRecvWeights",
    "GetSendWeights",
    "RingGraph",
    "StarGraph",
    "edges",
    "isPowerOf",
    "GetDynamicOnePeerSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "one_peer_period_matrices",
    "one_peer_period_edges",
    "mixing_matrix",
    "second_largest_eigenvalue_modulus",
    "second_largest_eigenvalue_modulus_info",
    "spectral_gap",
    "consensus_decay_rate",
    "consensus_decay_rate_info",
    "EdgeMatrix",
    "edges_from_dense",
    "live_submatrix_edges",
    "spectral_dense_max",
    "serpentine_device_order",
    "worker_device_order",
]
