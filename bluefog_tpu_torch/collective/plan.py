# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Lower a topology to a static communication plan.

Counterpart of ``bluefog_tpu/collective/plan.py``. A :class:`CommPlan` is a
short sequence of partial permutations plus per-round receiver weights:
after round ``r`` rank ``j`` multiplies what it received by
``recv_weights[r][j]``. On the stacked transport (N workers as the leading
axis of one tensor) a round is a gather along that axis, described by
:meth:`CommPlan.sources`: ``src[r, j]`` is the rank that sends to ``j`` in
round ``r``, or -1 when ``j`` receives nothing (a partial permutation, for
which ``ppermute`` delivers zeros and the weight is 0). A
:class:`SchedulePlan` is a periodic sequence of plans for the dynamic
(one-peer) topologies, lowered by :func:`schedule_from_dynamic`.

A short-cut (relay) plan (``method="shortcut"``) keeps the JAX plan's
rounds: its perm pairs are unit hops, not edges, and the compiler's
delivery table (``compile_info.delivery``) says in which round each edge
arrives, where its weight applies and from which the neighbour relations
come. A relay forwards verbatim, so :meth:`CommPlan.sources` of such a plan
names each round's origin row (:func:`compiler.relay_sources`): the
stacked combine stays one gather a round and computes the JAX relay's
arithmetic.
"""

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.collective.compiler import CompiledEdges
from bluefog_tpu_torch.topology.graphs import edges as topo_edges

__all__ = [
    "CommRound",
    "CommPlan",
    "SchedulePlan",
    "check_send_recv_symmetry",
    "perms_from_edges",
    "plan_from_matrix",
    "plan_from_topology",
    "plan_from_weights",
    "schedule_from_dynamic",
]


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One permutation round: ``(src, dst)`` pairs and receiver weights
    (0.0 where a rank is not a destination)."""

    perm: Tuple[Tuple[int, int], ...]
    recv_weights: Tuple[float, ...]

    @property
    def sources(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in self.perm)

    @property
    def destinations(self) -> Tuple[int, ...]:
        return tuple(d for _, d in self.perm)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """``y_j = self_weights[j] * x_j + sum_r recv_weights[r][j] *
    x_{src[r, j]}``."""

    size: int
    self_weights: Tuple[float, ...]
    rounds: Tuple[CommRound, ...]
    compile_info: CompiledEdges = dataclasses.field(compare=False)

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

    @property
    def relay(self) -> bool:
        """Whether the rounds are a short-cut relay schedule."""
        return self.compile_info.route == "shortcut"

    @functools.cached_property
    def _sources(self) -> np.ndarray:
        src = compiler.relay_sources(self.perms, self.compile_info.inject, self.size)
        src.setflags(write=False)
        return src

    def sources(self) -> np.ndarray:
        """``[rounds, size]`` int32: the rank whose value each rank receives
        per round, -1 for none (read-only): the round's sender, or on a
        relay plan the origin of what the relay carries."""
        return self._sources

    def _edge_rounds(self) -> List[Tuple[int, int, int]]:
        """``(src, dst, delivering round)`` of every edge, from the
        compiler's delivery table (a relay plan's pairs are transport, not
        neighbour relations)."""
        return [(s, d, r) for (s, d), r in self.compile_info.delivery]

    @functools.cached_property
    def in_neighbors(self) -> Tuple[Tuple[int, ...], ...]:
        ins: List[List[int]] = [[] for _ in range(self.size)]
        for s, d, _r in self._edge_rounds():
            ins[d].append(s)
        return tuple(tuple(sorted(lst)) for lst in ins)

    @property
    def max_in_degree(self) -> int:
        return max((len(n) for n in self.in_neighbors), default=0)

    def wire_bytes(self, n_elems: int, itemsize: int = 4, wire: Optional[str] = None) -> int:
        """Wire bytes a worker ships in one gossip step over this plan for
        an ``n_elems`` payload: every round re-ships it, priced by
        :func:`bluefog_tpu_torch.scaling.wire_bytes_per_step` (the value
        the facade's ``bluefog.wire_bytes`` counter records)."""
        from bluefog_tpu_torch import scaling  # scaling imports this module

        return scaling.wire_bytes_per_step({itemsize: n_elems}, len(self.rounds), wire)

    def weight_matrix(self) -> np.ndarray:
        """The effective combine matrix ``W`` (``W[i, j]`` = weight rank
        ``j`` applies to rank ``i``'s value)."""
        w = np.zeros((self.size, self.size))
        for j in range(self.size):
            w[j, j] = self.self_weights[j]
        for s, d, r in self._edge_rounds():
            w[s, d] = self.rounds[r].recv_weights[d]
        return w


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """A periodic sequence of :class:`CommPlan` for dynamic topologies: all
    plans share one ``size``, and step ``t`` uses ``plans[t % period]``."""

    plans: Tuple[CommPlan, ...]

    @property
    def period(self) -> int:
        return len(self.plans)

    @property
    def size(self) -> int:
        return self.plans[0].size

    @property
    def max_in_degree(self) -> int:
        return max(p.max_in_degree for p in self.plans)

    @functools.cached_property
    def stacked_operands(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(src [period, R, N] int32, self_w [period, N] f32, recv_w
        [period, R, N] f32)`` over the period, each plan's rounds padded to
        the most rounds ``R`` of any step with sender -1 and weight 0
        (read-only)."""
        rounds = max(max(len(p.rounds) for p in self.plans), 1)
        src = np.full((self.period, rounds, self.size), -1, np.int32)
        self_w = np.zeros((self.period, self.size), np.float32)
        recv_w = np.zeros((self.period, rounds, self.size), np.float32)
        for t, plan in enumerate(self.plans):
            n = len(plan.rounds)
            src[t, :n] = plan.sources()
            self_w[t], recv_w[t, :n] = plan.weight_operands()
        for a in (src, self_w, recv_w):
            a.setflags(write=False)
        return src, self_w, recv_w


def perms_from_edges(
    edges: Iterable[Tuple[int, int]], size: int, method: str = "auto"
) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Pack directed edges into partial-permutation rounds (the compiler's
    ``method`` decomposition): the structure lowering of the window ops
    (:mod:`bluefog_tpu_torch.windows`). A relay schedule is not a set of
    bare perms (its rounds carry transit, not deliveries), so ``shortcut``
    gets the direct ``auto`` decomposition here, as in the JAX package."""
    if method == "shortcut":
        method = "auto"
    return compiler.compile_edges(edges, size, method=method).perms


def plan_from_matrix(
    w: np.ndarray,
    edges: Optional[Iterable[Tuple[int, int]]] = None,
    method: str = "auto",
    link_class: str = "ici",
) -> CommPlan:
    """Build a plan from a combine matrix ``W``; edges default to the
    off-diagonal nonzeros (pass them to keep zero-weighted links). On a
    relay plan an edge's weight applies at the round its chain delivers.
    ``link_class`` is the compiler's (:func:`compiler.compile_edges`): a
    federation's gateway leg compiles under ``"dcn"``."""
    w = np.asarray(w, dtype=np.float64)
    size = w.shape[0]
    if w.shape != (size, size):
        raise ValueError(f"weight matrix must be square, got {w.shape}")
    if edges is None:
        edges = zip(*np.nonzero(w))
    compiled = compiler.compile_edges(edges, size, method=method, link_class=link_class)
    per_round = [[0.0] * size for _ in compiled.perms]
    for (s, d), r in compiled.delivery:
        per_round[r][d] = float(w[s, d])
    rounds = [CommRound(perm=perm, recv_weights=tuple(per_round[r]))
              for r, perm in enumerate(compiled.perms)]
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


def _normalize_per_rank(
    size: int,
    value: Union[Dict[int, Dict[int, float]], Sequence[Dict[int, float]],
                 Sequence[Sequence[int]], None],
) -> Optional[List[Dict[int, float]]]:
    """Per-rank weight specs as ``[{peer: weight}] * size``: a sequence
    indexed by rank or a dict keyed by rank, each entry a ``{peer:
    weight}`` dict or a bare peer list (weights 1.0)."""
    if value is None:
        return None
    if isinstance(value, dict):
        per_rank: List = [value.get(r, {}) for r in range(size)]
    else:
        per_rank = list(value)
        if len(per_rank) != size:
            raise ValueError(
                f"per-rank weight spec must have one entry per rank "
                f"(got {len(per_rank)}, size {size})"
            )
    out: List[Dict[int, float]] = []
    for entry in per_rank:
        if isinstance(entry, dict):
            out.append({int(k): float(v) for k, v in entry.items()})
        else:
            out.append({int(k): 1.0 for k in entry})
    return out


def plan_from_weights(
    size: int,
    self_weight: Union[float, Sequence[float]],
    src_weights: Union[Dict[int, Dict[int, float]], Sequence[Dict[int, float]]],
    dst_weights: Union[Dict[int, Dict[int, float]], Sequence, None] = None,
    enable_topo_check: bool = True,
    method: str = "auto",
) -> CommPlan:
    """A plan from explicit per-rank weights (the dynamic-graph path):
    ``src_weights[j]`` is rank ``j``'s ``{in_neighbor: weight}``,
    ``dst_weights[i]`` rank ``i``'s ``{out_neighbor: scale}`` (or a bare
    list, scale 1.0). With ``dst_weights`` both ends scale the value:
    ``W[i, j] = dst_w_i[j] * src_w_j[i]``. ``enable_topo_check`` refuses a
    send pattern that is not the transpose of the receive pattern."""
    srcs = _normalize_per_rank(size, src_weights)
    if srcs is None:
        raise ValueError("src_weights is required")
    dsts = _normalize_per_rank(size, dst_weights)
    if isinstance(self_weight, (int, float)):
        self_w = [float(self_weight)] * size
    else:
        self_w = [float(v) for v in self_weight]
        if len(self_w) != size:
            raise ValueError(f"self_weight has {len(self_w)} entries for {size} ranks")
    if dsts is not None and enable_topo_check:
        check_send_recv_symmetry(srcs, dsts)
    w = np.zeros((size, size))
    edge_list: List[Tuple[int, int]] = []
    for j in range(size):
        w[j, j] = self_w[j]
        for i, wt in srcs[j].items():
            if not (0 <= i < size and i != j):
                raise ValueError(f"src_weights for rank {j} has invalid in-neighbor {i}")
            scale = dsts[i].get(j, 1.0) if dsts is not None else 1.0
            w[i, j] = wt * scale
            edge_list.append((i, j))
    return plan_from_matrix(w, edges=edge_list, method=method)


def check_send_recv_symmetry(
    src_per_rank: Sequence[Dict[int, float]],
    dst_per_rank: Sequence[Dict[int, float]],
) -> None:
    """Raise unless the declared send pattern is the transpose of the
    receive pattern (``src_per_rank[j]``: rank ``j``'s in-neighbors,
    ``dst_per_rank[i]``: rank ``i``'s out-neighbors)."""
    sends = {(i, j) for i, dsts in enumerate(dst_per_rank) for j in dsts}
    recvs = {(i, j) for j, srcs in enumerate(src_per_rank) for i in srcs}
    if sends != recvs:
        missing_recv = sorted(sends - recvs)
        missing_send = sorted(recvs - sends)
        raise ValueError(
            "Send/recv neighbor pattern mismatch (topology check failed): "
            f"declared sends with no matching recv: {missing_recv[:8]}; "
            f"declared recvs with no matching send: {missing_send[:8]}."
        )


def schedule_from_dynamic(
    size: int,
    make_iterator,
    period: Optional[int] = None,
    self_weight: Optional[float] = None,
    uniform: bool = True,
    method: str = "auto",
) -> SchedulePlan:
    """Lower a dynamic generator (``make_iterator(rank)`` yields ``([send],
    [recv])`` per iteration, :mod:`bluefog_tpu_torch.topology.dynamic`) to a
    periodic schedule. The period is found by replaying the iterators
    until the send pattern repeats, or given.

    ``uniform=True``: rank ``j`` averages itself and its ``recv`` with
    ``1 / (len(recv) + 1)``. ``uniform=False`` (push-sum): each sender keeps
    ``self_weight`` (default 0.5) and splits ``1 - self_weight`` equally over
    its destinations, so every column of the send pattern sums to 1."""
    iters = [make_iterator(r) for r in range(size)]
    max_period = period or 4 * size + 8
    steps: List[Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]] = []
    for _ in range(max_period):
        steps.append(tuple((tuple(send), tuple(recv))
                           for send, recv in (next(it) for it in iters)))
    if period is None:
        period = _detect_period(steps)
        steps = steps[:period]

    plans = []
    for step in steps:
        dst_per_rank = [{d: 1.0 for d in send} for send, _ in step]
        src_per_rank = [{s: 1.0 for s in recv} for _, recv in step]
        check_send_recv_symmetry(src_per_rank, dst_per_rank)
        w = np.zeros((size, size))
        edge_list = [(i, j) for j, (_, recv) in enumerate(step) for i in recv]
        if uniform:
            for j, (_, recv) in enumerate(step):
                wt = 1.0 / (len(recv) + 1)
                w[j, j] = wt
                for i in recv:
                    w[i, j] = wt
        else:
            sw = 0.5 if self_weight is None else self_weight
            for i, (send, _) in enumerate(step):
                if not send:
                    w[i, i] = 1.0
                else:
                    w[i, i] = sw
                    for j in send:
                        w[i, j] = (1.0 - sw) / len(send)
        plans.append(plan_from_matrix(w, edges=edge_list, method=method))
    return SchedulePlan(plans=tuple(plans))


def _detect_period(steps: Sequence) -> int:
    """Smallest p with steps[t] == steps[t + p] over the observed window."""
    n = len(steps)
    for p in range(1, n // 2 + 1):
        if all(steps[t] == steps[t + p] for t in range(n - p)):
            return p
    return n
