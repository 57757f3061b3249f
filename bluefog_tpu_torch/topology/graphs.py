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

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "MeshGrid2DGraph",
    "StarGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "RandomRegularDigraph",
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "isPowerOf",
    "edges",
    "GetRecvWeights",
    "GetSendWeights",
    "mixing_matrix",
    "second_largest_eigenvalue_modulus",
    "second_largest_eigenvalue_modulus_info",
    "spectral_gap",
    "consensus_decay_rate",
    "consensus_decay_rate_info",
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


def SymmetricExponentialGraph(size: int, base: int = 4) -> np.ndarray:
    """The exponential offsets mirrored around ``size / 2``: offset ``i``
    is an edge when ``min(i, size - i)`` is a power of ``base``."""
    if size < 1:
        raise ValueError(f"size must be positive, got {size}")
    row = np.zeros(size)
    row[0] = 1.0
    for i in range(1, size):
        index = i if i <= size // 2 else size - i
        if isPowerOf(index, base):
            row[i] = 1.0
    return _circulant(row / row.sum())


def MeshGrid2DGraph(size: int, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """2-D grid (``shape`` rows x columns, default the most square split)
    with Metropolis-Hastings weights: ``1 / max(deg(i), deg(j))`` between
    grid neighbours, self loops counted, and the self weight the rest of
    the row."""
    if size < 1:
        raise ValueError(f"size must be positive, got {size}")
    if shape is None:
        i = int(np.sqrt(size))
        while size % i != 0:
            i -= 1
        shape = (i, size // i)
    nrow, ncol = shape
    if size != nrow * ncol:
        raise ValueError(f"grid shape {shape} covers {nrow * ncol} nodes, not size={size}")
    adj = np.zeros((size, size))
    for i in range(size):
        adj[i, i] = 1.0
        if (i + 1) % ncol != 0:  # right neighbour within the row
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        if i + ncol < size:  # neighbour in the row below
            adj[i, i + ncol] = adj[i + ncol, i] = 1.0
    degree = [np.count_nonzero(adj[i]) for i in range(size)]
    mat = np.zeros((size, size))
    for i in range(size):
        for j in np.nonzero(adj[i])[0]:
            if i != j:
                mat[i, j] = 1.0 / max(degree[i], degree[j])
        mat[i, i] = 1.0 - mat[i].sum()
    return mat


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


def RandomRegularDigraph(size: int, degree: int, seed: int = 0) -> np.ndarray:
    """Random ``degree``-regular digraph: the union of ``degree``
    edge-disjoint random derangements drawn from
    ``np.random.RandomState(seed)`` (the JAX generator's stream, draw for
    draw), uniform weights ``1 / (degree + 1)`` over self and the
    in-neighbours. Where rejection sampling fails 1000 times (the dense
    regime), the untaken complement is split into perfect matchings by the
    plan compiler's edge colouring and one is drawn at random."""
    if not (size > 1 and 0 < degree < size):
        raise ValueError(
            f"need 0 < degree < size for a simple digraph, got degree={degree} size={size}"
        )
    rng = np.random.RandomState(seed)
    taken = set()
    mat = np.zeros((size, size))
    uniform = 1.0 / (degree + 1)
    for _ in range(degree):
        for _attempt in range(1000):
            perm = rng.permutation(size)
            if (perm == np.arange(size)).any():
                continue  # not a derangement
            if any((i, int(perm[i])) in taken for i in range(size)):
                continue  # would repeat an edge
            break
        else:
            from bluefog_tpu_torch.collective.compiler import coloring_perms

            remaining = [(i, j) for i in range(size) for j in range(size)
                         if i != j and (i, j) not in taken]
            classes = coloring_perms(remaining, size)
            cls = classes[rng.randint(len(classes))]
            perm = np.empty(size, np.intp)
            for i, j in cls:
                perm[i] = j
        for i in range(size):
            taken.add((i, int(perm[i])))
            mat[i, perm[i]] = uniform
    for i in range(size):
        mat[i, i] = uniform
    return mat


# -- spectral analysis (the mixing observatory's predicted-rate core) ---------


def mixing_matrix(topo: np.ndarray) -> np.ndarray:
    """The combination matrix ``W`` of a topology as a float64 array
    (``W[i, j]`` = weight rank ``j`` applies to rank ``i``'s value). The
    port holds a topology as that matrix already, so this is a float64
    copy of it, the array ``nx.to_numpy_array`` gives for the JAX
    package's graph. One gossip step maps the stacked iterate ``x`` to
    ``W^T x``."""
    return np.array(topo, dtype=np.float64)


def second_largest_eigenvalue_modulus(w) -> float:
    """SLEM of a stochastic combine matrix: the modulus of the largest
    eigenvalue once one Perron root (the eigenvalue nearest 1) is
    removed. A disconnected (or periodic) matrix reports 1.0: no
    contraction is promised.

    Routed through :mod:`bluefog_tpu_torch.topology.spectral`: dense
    eigvals at ``N <= BLUEFOG_SPECTRAL_DENSE_MAX`` (default 64, the
    oracle), deflated Arnoldi over the edge list above. Accepts a dense
    array, an :class:`~bluefog_tpu_torch.topology.spectral.EdgeMatrix`,
    or an ``(n, {(i, j): w})`` edge-dict pair."""
    return second_largest_eigenvalue_modulus_info(w)[0]


def second_largest_eigenvalue_modulus_info(w) -> Tuple[float, dict]:
    """:func:`second_largest_eigenvalue_modulus` plus the engine info
    dict (``engine`` / ``matvecs`` / ``residual`` / ``converged``)."""
    from bluefog_tpu_torch.topology import spectral as _spectral

    return _spectral.slem_info(w)


def spectral_gap(w: np.ndarray) -> float:
    """``1 - SLEM``: the per-step consensus contraction margin the
    matrix promises (0: no mixing guarantee, 1: one-step consensus)."""
    return 1.0 - second_largest_eigenvalue_modulus(w)


def consensus_decay_rate(mats) -> float:
    """Predicted per-step consensus decay rate of one matrix or of a
    periodic sequence of matrices (the dynamic one-peer schedules, the
    elastic repair's per-period plans): a single matrix gives its SLEM, a
    sequence ``SLEM(W_K^T ... W_1^T)^(1/K)``."""
    return consensus_decay_rate_info(mats)[0]


def consensus_decay_rate_info(mats) -> Tuple[float, dict]:
    """:func:`consensus_decay_rate` plus the engine info dict (``engine``
    / ``matvecs`` / ``residual`` / ``converged`` / ``period``)."""
    from bluefog_tpu_torch.topology import spectral as _spectral

    return _spectral.decay_info(mats)


def IsTopologyEquivalent(topo1: Optional[np.ndarray], topo2: Optional[np.ndarray]) -> bool:
    """Weighted-adjacency equality (not isomorphism): the same size and
    the same nonzero entries with the same weights."""
    if topo1 is None or topo2 is None:
        return False
    a, b = np.asarray(topo1), np.asarray(topo2)
    if a.shape != b.shape:
        return False
    nz1, nz2 = a != 0, b != 0
    return bool(np.array_equal(nz1, nz2) and np.array_equal(a[nz1], b[nz2]))


def IsRegularGraph(topo: np.ndarray) -> bool:
    """True iff every node has the same degree, in-edges plus out-edges
    (a self loop counts once each way, as ``networkx`` counts it)."""
    nz = np.asarray(topo) != 0
    degree = nz.sum(axis=0) + nz.sum(axis=1)
    return bool((degree == degree[0]).all())


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
