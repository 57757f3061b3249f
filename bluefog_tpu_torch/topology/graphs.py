# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Static virtual-graph topology generators, as numpy weight matrices.

Counterpart of ``bluefog_tpu/topology/graphs.py``. The JAX package returns
``networkx.DiGraph`` objects; this package holds a topology as the dense
combination matrix ``W`` itself (``W[i, j]`` is the weight rank ``j``
applies to the value received from rank ``i``; the diagonal holds the self
weights), because networkx is not part of the port's dependencies. An edge
is a nonzero off-diagonal entry, exactly as ``nx.from_numpy_array`` reads
the same matrix, so edge sets and weights match the JAX generators entry
for entry.
"""

from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "StarGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "isPowerOf",
    "edges",
    "GetRecvWeights",
    "GetSendWeights",
]


def _circulant(row: np.ndarray) -> np.ndarray:
    """Circulant matrix whose rank-``i`` row is ``row`` rolled by ``i``:
    ``row[d]`` weights the edge ``i -> (i + d) % size``."""
    size = row.shape[0]
    mat = np.empty((size, size))
    for i in range(size):
        mat[i] = np.roll(row, i)
    return mat


def isPowerOf(x: int, base: int) -> bool:
    """True iff ``x == base ** k`` for some integer ``k >= 0``."""
    if base <= 1 or x <= 0:
        raise ValueError(f"need base > 1 and x > 0, got x={x} base={base}")
    while x % base == 0:
        x //= base
    return x == 1


def ExponentialTwoGraph(size: int) -> np.ndarray:
    """Rank ``i`` sends to ``i + 2**k`` (mod size), uniform weights over
    the out-neighbors and itself."""
    row = np.array(
        [1.0 if i == 0 or (i & (i - 1)) == 0 else 0.0 for i in range(size)]
    )
    return _circulant(row / row.sum())


def ExponentialGraph(size: int, base: int = 2) -> np.ndarray:
    """Rank ``i`` sends to the offsets that are powers of ``base``; the
    default topology of :func:`bluefog_tpu_torch.init`."""
    row = np.array(
        [1.0 if i == 0 or isPowerOf(i, base) else 0.0 for i in range(size)]
    )
    return _circulant(row / row.sum())


def StarGraph(size: int, center_rank: int = 0) -> np.ndarray:
    """Bidirectional star centred on ``center_rank``: every round of its
    plan is a partial permutation (leaves receive in one round only)."""
    mat = np.zeros((size, size))
    for i in range(size):
        mat[i, i] = 1 - 1 / size
        mat[center_rank, i] = 1 / size
        mat[i, center_rank] = 1 / size
    return mat


def RingGraph(size: int, connect_style: int = 0) -> np.ndarray:
    """Ring; ``connect_style`` 0 = bidirectional, 1 = left, 2 = right."""
    if not 0 <= connect_style <= 2:
        raise ValueError(f"connect_style must be 0, 1 or 2, got {connect_style}")
    if size == 1:
        return np.array([[1.0]])
    if size == 2:
        return np.array([[0.5, 0.5], [0.5, 0.5]])
    row = np.zeros(size)
    if connect_style == 0:
        row[0] = row[1] = row[-1] = 1 / 3.0
    elif connect_style == 1:
        row[0] = row[-1] = 0.5
    else:
        row[0] = row[1] = 0.5
    return _circulant(row)


def FullyConnectedGraph(size: int) -> np.ndarray:
    """All-to-all with uniform ``1/size`` weights."""
    return _circulant(np.full(size, 1.0 / size))


def edges(topo: np.ndarray) -> List[Tuple[int, int]]:
    """Directed off-diagonal edges ``(src, dst)`` in row-major order."""
    return [(int(i), int(j)) for i, j in zip(*np.nonzero(topo)) if i != j]


def GetRecvWeights(topo: np.ndarray, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {in_neighbor: weight})`` for ``rank`` (column
    ``rank`` of ``W``)."""
    col = topo[:, rank]
    nbrs = {int(i): float(col[i]) for i in np.nonzero(col)[0] if i != rank}
    return float(col[rank]), nbrs


def GetSendWeights(topo: np.ndarray, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {out_neighbor: weight})`` for ``rank`` (row
    ``rank`` of ``W``)."""
    row = topo[rank]
    nbrs = {int(j): float(row[j]) for j in np.nonzero(row)[0] if j != rank}
    return float(row[rank]), nbrs
