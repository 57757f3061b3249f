# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Topology generators (numpy weight matrices)."""

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
]
