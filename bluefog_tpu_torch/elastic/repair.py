# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Consensus-preserving topology repair.

Counterpart of ``bluefog_tpu/elastic/repair.py`` on the port's numpy
weight matrices: a topology is its combine matrix, so
:func:`repaired_topology` returns the repaired matrix itself (what
``nx.to_numpy_array`` gives for the JAX package's repaired graph), and the
survivor components are counted by a breadth-first search.

Given the active combine matrix and a live set, rebuild a mixing matrix
over the survivors that (a) never references a dead rank, (b) keeps the
stochasticity the optimizer family relies on, and (c) stays strongly
connected so gossip still mixes. The repaired matrix is installed through
the normal ``ctx.set_topology`` path, so it recompiles through the
edge-coloring plan compiler like any other topology — repair is a
*graph* operation, not a new execution path.

Convention reminder (:mod:`bluefog_tpu_torch.topology.graphs`): ``W[i, j]`` is
the weight rank ``j`` applies to the value received from rank ``i`` —
the combine is ``y = W^T x``. "Row-stochastic" in the standard gossip
convention (``x' = A x`` with rows of ``A`` summing to 1) therefore means
the *columns* of this repo's ``W`` sum to 1; this module documents every
policy in both forms.

Policies
--------

``average`` (CTA/ATC weight-gossip families)
    Symmetrize the surviving edge set (every edge is just a ppermute —
    the repair engine may add the reverse direction) and apply
    Metropolis–Hastings weights: ``W[i, j] = 1 / (1 + max(deg_i,
    deg_j))`` for surviving edges, self weights absorbing the remainder.
    The result is symmetric, hence doubly stochastic: the unique fixed
    point of repeated gossip is the *uniform average of the survivors*
    (the survivor-consensus oracle tier-1 pins bitwise). If the survivor
    graph is disconnected (a star losing its center), the survivor ring
    is unioned in first.

``receiver`` (structure-preserving fallback)
    Keep the surviving directed edges and renormalize each receiver's
    weights (self + live in-neighbors) to sum to 1 — row-stochastic in
    the standard convention. Consensus is preserved but lands on the
    stationary-distribution-weighted average, not necessarily uniform.

``push_sum`` (push-sum / window family, incl. the asynchronous gossip
engine)
    Renormalize each live *sender's* outgoing mass split (self + live
    out-neighbors) to sum to 1 — column-stochastic in the standard
    convention, i.e. mass-conserving: ``sum(p)`` over survivors is
    invariant after repair, so the push-sum correction ``x / p``
    converges to ``sum(x_live) / sum(p_live)`` — the mass-corrected
    survivor consensus (dead mass is lost exactly once, at the kill).
    The async engine (:mod:`bluefog_tpu_torch.async_gossip`, ``mode =
    'push_sum'``) receives exactly these renormalized weights from the
    repair install, and additionally *re-windows* on a membership
    change: the pre-repair estimate ``x / p`` seeds the new window's
    mass with ``p`` reset to 1, so mass accounting restarts cleanly
    over the live set.

Degraded (live but slow) ranks are handled by scaling their cross edges
by the recorded link factor before normalization; the ``average`` policy
scales symmetrically and reabsorbs into the diagonal so double
stochasticity survives.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "repaired_matrix",
    "repaired_topology",
    "repair_schedule",
    "survivor_consensus",
    "receiver_sums",
    "sender_sums",
]

POLICIES = ("average", "receiver", "push_sum")


def receiver_sums(w: np.ndarray, live: Sequence[int]) -> np.ndarray:
    """Per-live-rank receiver weight totals (column sums restricted to
    live senders) — 1.0 everywhere for a receiver-normalized matrix."""
    live = list(live)
    return np.asarray(w)[np.ix_(live, live)].sum(axis=0)


def sender_sums(w: np.ndarray, live: Sequence[int]) -> np.ndarray:
    """Per-live-rank outgoing mass totals (row sums restricted to live
    destinations) — 1.0 everywhere for a mass-conserving matrix."""
    live = list(live)
    return np.asarray(w)[np.ix_(live, live)].sum(axis=1)


def survivor_consensus(x: np.ndarray, live: Sequence[int]) -> np.ndarray:
    """The survivor-consensus oracle: the uniform average of the live
    slots of a worker-stacked array (axis 0 = worker)."""
    live = np.asarray(sorted(live), dtype=np.intp)
    return np.mean(np.asarray(x)[live], axis=0)


def _validate(w: np.ndarray, live: Sequence[int]) -> Tuple[np.ndarray, list]:
    w = np.asarray(w, dtype=np.float64)
    size = w.shape[0]
    assert w.shape == (size, size), "combine matrix must be square"
    live = sorted(int(r) for r in set(live))
    if not live:
        raise ValueError("cannot repair to an empty live set")
    if not all(0 <= r < size for r in live):
        raise ValueError(f"live set {live} out of range for size {size}")
    return w, live


def _isolate_dead(out: np.ndarray, live: Sequence[int]) -> None:
    """Freeze dead slots in place: weight 1 on self, no edges. The mesh
    device still exists (single-controller SPMD cannot shrink the mesh),
    it just stops participating in any wire round."""
    size = out.shape[0]
    dead = [r for r in range(size) if r not in set(live)]
    for d in dead:
        out[d, :] = 0.0
        out[:, d] = 0.0
        out[d, d] = 1.0


def _survivor_components(adj: np.ndarray, live: list) -> int:
    """Connected components of the undirected graph ``adj`` restricted to
    ``live``, by breadth-first search."""
    sub = adj[np.ix_(live, live)] != 0
    n = len(live)
    seen = np.zeros(n, bool)
    count = 0
    for start in range(n):
        if seen[start]:
            continue
        count += 1
        seen[start] = True
        frontier = [start]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(sub[i] | sub[:, i])[0]:
                if not seen[j]:
                    seen[j] = True
                    frontier.append(int(j))
    return count


def repaired_matrix(
    w: np.ndarray,
    live: Sequence[int],
    policy: str = "average",
    degraded: Optional[Dict[int, float]] = None,
) -> np.ndarray:
    """Rebuild the full-size combine matrix for the given live set.

    Dead slots are frozen (self weight 1, no edges); the live submatrix
    follows the module-level policy contract. Pure numpy — the oracle
    tests call this directly.
    """
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    w, live = _validate(w, live)
    size = w.shape[0]
    degraded = {
        int(r): float(f)
        for r, f in (degraded or {}).items()
        if int(r) in set(live)
    }
    out = np.zeros_like(w)

    if len(live) == 1:
        out[live[0], live[0]] = 1.0
        _isolate_dead(out, live)
        return out

    if policy == "average":
        # symmetrized surviving edge set (reverse edges are free: every
        # directed edge is one more entry in a ppermute round)
        adj = np.zeros((size, size))
        for i in live:
            for j in live:
                if i != j and (w[i, j] != 0.0 or w[j, i] != 0.0):
                    adj[i, j] = adj[j, i] = 1.0
        if _survivor_components(adj, live) > 1:
            # disconnected survivors (e.g. a star losing its center):
            # union in the survivor ring so gossip still mixes
            for k, i in enumerate(live):
                j = live[(k + 1) % len(live)]
                adj[i, j] = adj[j, i] = 1.0
        deg = {i: int(np.count_nonzero(adj[i])) for i in live}
        for i in live:
            for j in live:
                if i != j and adj[i, j]:
                    out[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        # symmetric degrade: scale both directions of the slow rank's
        # edges, reabsorb into BOTH diagonals below — symmetry (hence
        # double stochasticity) is preserved
        for r, f in degraded.items():
            for j in live:
                if j != r:
                    out[r, j] *= f
                    out[j, r] *= f
        for i in live:
            out[i, i] = 1.0 - out[i, :].sum()
        _isolate_dead(out, live)
        return out

    if policy == "receiver":
        for i in live:
            for j in live:
                out[i, j] = w[i, j]
        for r, f in degraded.items():  # down-weight data FROM slow ranks
            for j in live:
                if j != r:
                    out[r, j] *= f
        for j in live:  # renormalize each receiver's column
            col = out[:, j].sum()
            if col <= 0.0:
                out[:, j] = 0.0
                out[j, j] = 1.0  # isolated receiver: keeps its value
            else:
                out[:, j] /= col
        _isolate_dead(out, live)
        return out

    # push_sum: renormalize each live sender's outgoing mass
    for i in live:
        for j in live:
            out[i, j] = w[i, j]
    for r, f in degraded.items():
        for j in live:
            if j != r:
                out[r, j] *= f
    for i in live:
        row = out[i, :].sum()
        if row <= 0.0:
            out[i, :] = 0.0
            out[i, i] = 1.0  # nowhere to push: keep all mass
        else:
            out[i, :] /= row
    _isolate_dead(out, live)
    return out


def repaired_topology(
    topo: np.ndarray,
    live: Sequence[int],
    policy: str = "average",
    degraded: Optional[Dict[int, float]] = None,
) -> np.ndarray:
    """:func:`repaired_matrix` of a topology matrix, in the form
    ``ctx.set_topology`` takes (install with ``is_weighted=True``): the
    float64 matrix ``nx.to_numpy_array`` gives for the JAX package's
    repaired graph, zero entries and node order included."""
    w = np.asarray(topo, dtype=np.float64)
    return repaired_matrix(w, live, policy=policy, degraded=degraded)


def repair_schedule(schedule, live: Sequence[int], policy: str = "receiver"):
    """Repair a dynamic :class:`~bluefog_tpu_torch.collective.plan.SchedulePlan`:
    every period step drops edges incident to dead ranks and renormalizes
    per ``policy``. The period is preserved by construction — one-peer
    schedules keep their cadence, they just skip dead peers (a rank whose
    peer-of-the-round died gossips with itself that round)."""
    from bluefog_tpu_torch.collective.plan import SchedulePlan, plan_from_matrix

    live_set = set(int(r) for r in live)
    plans = []
    for p in schedule.plans:
        w = repaired_matrix(p.weight_matrix(), sorted(live_set), policy=policy)
        edges = [
            (i, j)
            for i, j in zip(*np.nonzero(w))
            if i != j and i in live_set and j in live_set
        ]
        plans.append(plan_from_matrix(w, edges=edges))
    return SchedulePlan(plans=tuple(plans))
