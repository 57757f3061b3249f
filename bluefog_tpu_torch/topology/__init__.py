# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Topology generators (numpy weight matrices) and the dynamic one-peer
schedules."""

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
    RingGraph,
    StarGraph,
    edges,
    isPowerOf,
)

__all__ = [
    "ExponentialGraph",
    "ExponentialTwoGraph",
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
