# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Topology generators (numpy weight matrices), their comparisons, the
dynamic one-peer schedules and the inference of one direction of a
dynamic graph from the other."""

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
    edges,
    isPowerOf,
)
from bluefog_tpu_torch.topology.infer import (
    InferDestinationFromSourceRanks,
    InferSourceFromDestinationRanks,
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
]
