# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Dynamic (per-iteration) one-peer topology schedules.

Counterpart of ``bluefog_tpu/topology/dynamic.py`` on the port's numpy
weight matrices (:mod:`bluefog_tpu_torch.topology.graphs`): the
out-neighbors of rank ``r`` are the off-diagonal nonzeros of row ``r``.
The generators are infinite iterators yielding ``([send_ranks],
[recv_ranks])`` per iteration; the schedules are periodic, and
:func:`bluefog_tpu_torch.collective.plan.schedule_from_dynamic` lowers one
period to a stack of plans indexed by the step.
"""

import math
from typing import Iterator, List, Tuple

import numpy as np

__all__ = [
    "GetDynamicOnePeerSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "one_peer_period_matrices",
    "one_peer_period_edges",
]


def _size(topo: np.ndarray) -> int:
    return np.asarray(topo).shape[0]


def _one_peer_period(topo: np.ndarray, period):
    """Shared period walk: yields per-iteration ``[(send, recv_list)]``
    for every rank over one full period (default = lcm of the per-rank
    out-degrees)."""
    size = _size(topo)
    if period is None:
        period = 1
        for r in range(size):
            deg = max(len(_sorted_out_neighbors(topo, r)), 1)
            period = period * deg // math.gcd(period, deg)
    iters = [GetDynamicOnePeerSendRecvRanks(topo, r) for r in range(size)]
    for _ in range(period):
        yield [next(it) for it in iters]


def _sorted_out_neighbors(topo: np.ndarray, rank: int) -> List[int]:
    """Out-neighbors of ``rank`` (the nonzeros of its row) sorted by
    clockwise ring distance, self-loop removed."""
    size = _size(topo)
    succ = [int(j) for j in np.nonzero(np.asarray(topo)[rank])[0]]
    ranks = sorted(succ, key=lambda r: (r - rank) % size if r != rank else 0)
    return [r for r in ranks if r != rank]


def GetDynamicOnePeerSendRecvRanks(
    topo: np.ndarray, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Cycle through the base topology's out-neighbors one at a time.

    At iteration t every rank r sends to its (t mod out_degree(r))-th
    clockwise out-neighbor; the recv list is every rank whose pick lands on
    ``self_rank``."""
    size = _size(topo)
    send_lists = [_sorted_out_neighbors(topo, r) for r in range(size)]
    index = 0
    while True:
        send_rank = send_lists[self_rank][index % len(send_lists[self_rank])]
        recv_ranks = [
            r
            for r in range(size)
            if r != self_rank
            and send_lists[r][index % len(send_lists[r])] == self_rank
        ]
        yield [send_rank], recv_ranks
        index += 1


def one_peer_period_matrices(topo: np.ndarray, period: int = None) -> List[np.ndarray]:
    """Per-iteration mixing matrices of the one-peer schedule over one full
    period: at each iteration rank ``j`` averages itself and its receive
    set with ``1 / (len(recv) + 1)`` (the weights of
    ``schedule_from_dynamic(uniform=True)``)."""
    size = _size(topo)
    mats: List[np.ndarray] = []
    for step in _one_peer_period(topo, period):
        w = np.zeros((size, size))
        for j, (_send, recv) in enumerate(step):
            wt = 1.0 / (len(recv) + 1)
            w[j, j] = wt
            for i in recv:
                w[i, j] = wt
        mats.append(w)
    return mats


def one_peer_period_edges(topo: np.ndarray, period: int = None):
    """Sparse twin of :func:`one_peer_period_matrices`: one ``(size, {(i,
    j): w})`` pair per iteration of the period."""
    size = _size(topo)
    out = []
    for step in _one_peer_period(topo, period):
        edges = {}
        for j, (_send, recv) in enumerate(step):
            wt = 1.0 / (len(recv) + 1)
            edges[(j, j)] = wt
            for i in recv:
                edges[(i, j)] = wt
        out.append((size, edges))
    return out


def GetExp2DynamicSendRecvMachineRanks(
    world_size: int, local_size: int, self_rank: int, local_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """One-peer Exponential-2 schedule at machine granularity: machine m
    sends to machine m + 2^(t mod K) and receives from m - 2^(t mod K)."""
    assert (self_rank % local_size) == local_rank, (
        "machine schedule requires a homogeneous layout: self_rank % "
        "local_size must equal local_rank"
    )
    assert (world_size % local_size) == 0, (
        "machine schedule requires a homogeneous layout: local_size must "
        "divide world_size"
    )
    assert world_size > local_size, (
        "machine schedule needs at least two machines (world_size > local_size)"
    )
    machine_id = self_rank // local_size
    machine_size = world_size // local_size
    exp_2_size = int(np.log2(machine_size - 1)) if machine_size > 1 else 0
    index = 0
    while True:
        dist = 2 ** (index % (exp_2_size + 1))
        yield [(machine_id + dist) % machine_size], [(machine_id - dist) % machine_size]
        index += 1


def GetInnerOuterRingDynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-ring / outer-ring one-peer schedule: each iteration one local
    slot exchanges with the same slot on the neighboring machines; the
    others walk a ring inside the machine that skips that slot."""
    num_machines = world_size // local_size
    nodes_per_machine = local_size
    assert world_size % local_size == 0, (
        "inner/outer ring schedule requires a homogeneous layout: local_size "
        "must divide world_size"
    )
    assert local_size > 2, (
        "inner/outer ring schedule needs more than 2 workers per machine "
        "(the inner ring is empty otherwise); use "
        "hierarchical_neighbor_allreduce or GetDynamicOnePeerSendRecvRanks "
        "for small machines"
    )
    machine_id = self_rank // nodes_per_machine
    local_rank_id = self_rank % nodes_per_machine
    index = 0
    while True:
        outside_slot = index % nodes_per_machine
        if outside_slot == local_rank_id:
            send_rank = ((machine_id + 1) % num_machines) * nodes_per_machine + local_rank_id
            recv_rank = ((machine_id - 1) % num_machines) * nodes_per_machine + local_rank_id
        else:
            target = (local_rank_id + 1) % nodes_per_machine
            if target == outside_slot:
                target = (target + 1) % nodes_per_machine
            send_rank = machine_id * nodes_per_machine + target
            source = (local_rank_id - 1) % nodes_per_machine
            if source == outside_slot:
                source = (source - 1) % nodes_per_machine
            recv_rank = machine_id * nodes_per_machine + source
        yield [send_rank], [recv_rank]
        index += 1


def GetInnerOuterExpo2DynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-Exp2 / outer-Exp2 one-peer schedule: like the inner/outer ring,
    but both rings hop by powers of two; the inner hop is shifted past the
    slot that talks across machines this round."""
    num_machines = world_size // local_size
    nodes_per_machine = local_size
    assert world_size % local_size == 0, (
        "inner/outer Exp2 schedule requires a homogeneous layout: local_size "
        "must divide world_size"
    )
    assert local_size > 2, (
        "inner/outer Exp2 schedule needs more than 2 workers per machine "
        "(the inner ring is empty otherwise); use "
        "hierarchical_neighbor_allreduce or GetDynamicOnePeerSendRecvRanks "
        "for small machines"
    )
    exp_2_out_size = int(np.log2(num_machines - 1))
    if nodes_per_machine == 2:
        exp_2_in_size = 0
    else:
        # -2: the slot talking outside is excluded from the inner ring.
        exp_2_in_size = int(np.log2(nodes_per_machine - 2))
    machine_id = self_rank // nodes_per_machine
    local_rank_id = self_rank % nodes_per_machine
    index = 0
    while True:
        outside_slot = index % nodes_per_machine
        if outside_slot == local_rank_id:
            dist = 2 ** (index % (exp_2_out_size + 1))
            send_rank = ((machine_id + dist) % num_machines) * nodes_per_machine + local_rank_id
            recv_rank = ((machine_id - dist) % num_machines) * nodes_per_machine + local_rank_id
        else:
            base_dist = 2 ** (index % (exp_2_in_size + 1))
            dist_to_out = (outside_slot - local_rank_id) % nodes_per_machine
            send_dist = base_dist + 1 if base_dist >= dist_to_out else base_dist
            target = (local_rank_id + send_dist) % nodes_per_machine
            send_rank = machine_id * nodes_per_machine + target
            reverse_dist_to_out = (local_rank_id - outside_slot) % nodes_per_machine
            recv_dist = base_dist + 1 if base_dist >= reverse_dist_to_out else base_dist
            source = (local_rank_id - recv_dist) % nodes_per_machine
            recv_rank = machine_id * nodes_per_machine + source
        yield [send_rank], [recv_rank]
        index += 1
