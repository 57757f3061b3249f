# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Infer the reverse direction of a dynamic graph from per-rank peer lists.

Counterpart of ``bluefog_tpu/topology/infer.py`` (pure numpy, copied so
the port imports nothing of the JAX package). The caller holds every
rank's list, so the inversion needs no communication: pass all ranks'
lists; a single rank's flat list raises.
"""

import collections
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "InferSourceFromDestinationRanks",
    "InferDestinationFromSourceRanks",
]


def _check_ranks(rank_list: Sequence[Any], self_rank: int, size: int) -> Tuple[bool, str]:
    # the four rules of the JAX package, in its order
    for rank in rank_list:
        if not isinstance(rank, (int, np.integer)):
            return False, "has a non-integer entry."
        if rank < 0 or rank >= size:
            return False, "has an entry outside the valid range [0, size)."
    if len(set(rank_list)) != len(rank_list):
        return False, "lists the same rank more than once."
    if self_rank in rank_list:
        return False, "includes the rank itself as its own peer."
    return True, ""


def _infer_topo(
    ranks_per_rank: Sequence[Sequence[int]],
    transpose: bool,
    construct_adjacency_matrix: bool,
):
    size = len(ranks_per_rank)
    adjacency = {i: sorted(lst) for i, lst in enumerate(ranks_per_rank)}

    inverse = collections.defaultdict(list)
    for src, adj in adjacency.items():
        for dst in adj:
            inverse[dst].append(src)
    inferred = [inverse.get(r, []) for r in range(size)]

    if not construct_adjacency_matrix:
        return inferred, None

    # the JAX package's matrix, its normalisation (by row sums) included
    w = np.eye(size)
    for src, adj in adjacency.items():
        w[src, adj] = 1
    if transpose:
        w = w.T
    return inferred, w / w.sum(axis=1)


def InferSourceFromDestinationRanks(
    dst_ranks: Union[Sequence[Sequence[int]], Sequence[int]],
    construct_adjacency_matrix: bool = False,
    *,
    rank: Optional[int] = None,
    size: Optional[int] = None,
) -> Any:
    """Who sends to each rank, given who every rank sends to. The caller
    passes every rank's list; a flat list raises.

    Args:
        dst_ranks: per-rank destination lists ``[[dst...] for each rank]``.
        construct_adjacency_matrix: also return the column-normalized W.
        rank: if given, return only this rank's inferred list; otherwise
            the list of every rank.
        size: optional expected world size; validated against
            ``len(dst_ranks)`` when given.
    """
    per_rank = _normalize(dst_ranks, rank, size)
    n = len(per_rank)
    for r, lst in enumerate(per_rank):
        ok, msg = _check_ranks(lst, r, n)
        assert ok, f"The format of dst_ranks is wrong: {msg}"
    inferred, w = _infer_topo(per_rank, False, construct_adjacency_matrix)
    out = inferred[rank] if rank is not None else inferred
    return (out, w) if construct_adjacency_matrix else out


def InferDestinationFromSourceRanks(
    src_ranks: Union[Sequence[Sequence[int]], Sequence[int]],
    construct_adjacency_matrix: bool = False,
    *,
    rank: Optional[int] = None,
    size: Optional[int] = None,
) -> Any:
    """Who I send to, given who everyone receives from. See
    :func:`InferSourceFromDestinationRanks`."""
    per_rank = _normalize(src_ranks, rank, size)
    n = len(per_rank)
    for r, lst in enumerate(per_rank):
        ok, msg = _check_ranks(lst, r, n)
        assert ok, f"The format of src_ranks is wrong: {msg}"
    inferred, w = _infer_topo(per_rank, True, construct_adjacency_matrix)
    out = inferred[rank] if rank is not None else inferred
    return (out, w) if construct_adjacency_matrix else out


def _normalize(ranks, rank, size) -> List[List[int]]:
    if len(ranks) and isinstance(ranks[0], (list, tuple, np.ndarray)):
        per_rank = [list(map(int, lst)) for lst in ranks]
        if size is not None and size != len(per_rank):
            raise ValueError(
                f"size={size} does not match the {len(per_rank)} per-rank "
                "lists given"
            )
        if rank is not None and not (0 <= rank < len(per_rank)):
            raise ValueError(f"rank={rank} out of range for {len(per_rank)} ranks")
        return per_rank
    raise ValueError(
        "Expected per-rank lists [[...] for each rank]; a single rank's flat "
        "list cannot determine the global topology. Pass every rank's list "
        "(e.g. from the dynamic generators)."
    )
