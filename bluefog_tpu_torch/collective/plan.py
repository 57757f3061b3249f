# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Lower a topology to a static communication plan.

Counterpart of ``bluefog_tpu/collective/plan.py``. A :class:`CommPlan` is a
short sequence of partial permutations plus per-round receiver weights:
after round ``r`` rank ``j`` multiplies what it received by
``recv_weights[r][j]``. On the stacked transport (N workers as the leading
axis of one tensor) a round is a gather along that axis, described by
:meth:`CommPlan.sources`: ``src[r, j]`` is the rank that sends to ``j`` in
round ``r``, or -1 when ``j`` receives nothing (a partial permutation, for
which ``ppermute`` delivers zeros and the weight is 0).
"""

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.collective.compiler import CompiledEdges
from bluefog_tpu_torch.topology.graphs import edges as topo_edges

__all__ = [
    "CommRound",
    "CommPlan",
    "perms_from_edges",
    "plan_from_matrix",
    "plan_from_topology",
]


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One permutation round: ``(src, dst)`` pairs and receiver weights
    (0.0 where a rank is not a destination)."""

    perm: Tuple[Tuple[int, int], ...]
    recv_weights: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """``y_j = self_weights[j] * x_j + sum_r recv_weights[r][j] *
    x_{src[r, j]}``."""

    size: int
    self_weights: Tuple[float, ...]
    rounds: Tuple[CommRound, ...]
    compile_info: Optional[CompiledEdges] = dataclasses.field(
        default=None, compare=False
    )

    @property
    def perms(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        return tuple(r.perm for r in self.rounds)

    def weight_operands(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(self_w [size], recv_w [rounds, size])`` float32, the same
        arrays the JAX plan hands its combines."""
        self_w = np.asarray(self.self_weights, np.float32)
        recv = np.zeros((len(self.rounds), self.size), np.float32)
        for r, rnd in enumerate(self.rounds):
            recv[r] = rnd.recv_weights
        return self_w, recv

    @functools.cached_property
    def _sources(self) -> np.ndarray:
        src = np.full((len(self.rounds), self.size), -1, np.int32)
        for r, rnd in enumerate(self.rounds):
            for s, d in rnd.perm:
                src[r, d] = s
        src.setflags(write=False)
        return src

    def sources(self) -> np.ndarray:
        """``[rounds, size]`` int32: the sender of each rank per round, -1
        for none (read-only)."""
        return self._sources

    @functools.cached_property
    def in_neighbors(self) -> Tuple[Tuple[int, ...], ...]:
        ins: List[List[int]] = [[] for _ in range(self.size)]
        for rnd in self.rounds:
            for s, d in rnd.perm:
                ins[d].append(s)
        return tuple(tuple(sorted(lst)) for lst in ins)

    def weight_matrix(self) -> np.ndarray:
        """The effective combine matrix ``W`` (``W[i, j]`` = weight rank
        ``j`` applies to rank ``i``'s value)."""
        w = np.zeros((self.size, self.size))
        for j in range(self.size):
            w[j, j] = self.self_weights[j]
        for rnd in self.rounds:
            for s, d in rnd.perm:
                w[s, d] = rnd.recv_weights[d]
        return w


def perms_from_edges(
    edges: Iterable[Tuple[int, int]], size: int
) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Pack directed edges into partial-permutation rounds (the compiler's
    ``auto`` decomposition): the structure lowering of the window ops
    (:mod:`bluefog_tpu_torch.windows`)."""
    return compiler.compile_edges(edges, size).perms


def plan_from_matrix(
    w: np.ndarray,
    edges: Optional[Iterable[Tuple[int, int]]] = None,
    method: str = "auto",
) -> CommPlan:
    """Build a plan from a combine matrix ``W``; edges default to the
    off-diagonal nonzeros (pass them to keep zero-weighted links)."""
    w = np.asarray(w, dtype=np.float64)
    size = w.shape[0]
    if w.shape != (size, size):
        raise ValueError(f"weight matrix must be square, got {w.shape}")
    if edges is None:
        edges = zip(*np.nonzero(w))
    compiled = compiler.compile_edges(edges, size, method=method)
    rounds = []
    for perm in compiled.perms:
        weights = [0.0] * size
        for s, d in perm:
            weights[d] = float(w[s, d])
        rounds.append(CommRound(perm=perm, recv_weights=tuple(weights)))
    return CommPlan(
        size=size,
        self_weights=tuple(float(w[i, i]) for i in range(size)),
        rounds=tuple(rounds),
        compile_info=compiled,
    )


def plan_from_topology(
    topo: np.ndarray, weighted: bool = True, method: str = "auto"
) -> CommPlan:
    """Lower a topology matrix to a plan. ``weighted=False`` is the
    reference's uniform default: every rank combines itself and its
    in-neighbors with ``1 / (in_degree + 1)``."""
    w = np.asarray(topo, dtype=np.float64)
    size = w.shape[0]
    edge_list = topo_edges(w)
    if not weighted:
        u = np.zeros_like(w)
        in_lists: Dict[int, List[int]] = {j: [] for j in range(size)}
        for i, j in edge_list:
            in_lists[j].append(i)
        for j in range(size):
            uniform = 1.0 / (len(in_lists[j]) + 1)
            u[j, j] = uniform
            for i in in_lists[j]:
                u[i, j] = uniform
        w = u
    return plan_from_matrix(w, edges=edge_list, method=method)
