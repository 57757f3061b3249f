# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Thousand-rank fleet simulator (``bft.fleetsim``).

Counterpart of ``bluefog_tpu/fleetsim.py``: host-only numpy, no device
dispatch. Hundreds to thousands of *virtual* ranks run in one process on
the elastic fault-plan step clock, every control-plane mechanism driven
for real:

- **Virtual membership** is the port's
  :class:`~bluefog_tpu_torch.elastic.membership.Membership` state machine,
  plus an incrementally maintained live-set token (O(1) per transition)
  standing in for the O(N) live tuple the device path hashes into its
  plan-cache keys.
- **Repair-weight algebra** reimplements the
  :func:`~bluefog_tpu_torch.elastic.repair.repaired_matrix` policy contract
  over per-rank edge dicts: ``receiver`` and ``push_sum`` repairs touch only
  the killed ranks' neighbourhoods (O(degree^2) per killed rank), while
  ``average`` rebuilds its Metropolis-Hastings weights per event (its
  connectivity audit is O(edges)).
- **Plan-cache keys** follow the dispatch discipline of the static plan,
  ``("static_plan", topo_version, weighted, method, live_token)``, with the
  elastic session's zero-stale-dispatch tripwire.
- **Advisories** are :class:`~bluefog_tpu_torch.attribution.Advisory`
  records (``fleet_churn`` on simultaneous-loss storms, ``fleet_partition``
  when the survivor graph disconnects, ``fleet_suspect`` for the fault kinds
  with no membership consequence).
- **Fleet aggregation** runs the health plane's push-sum lanes as sparse
  scatter-adds over the live edge list, the same report as
  :func:`bluefog_tpu_torch.health.fleet_aggregate_np`.
- **Decision latency**: :meth:`VirtualFleet.decision_probe` scores the
  incumbent, the live ring and the live Exp2 through the sparse spectral
  engine and measures the decision.

``mesh``, ``star`` and ``rrd`` base topologies are read from the port's
generator matrices (:mod:`bluefog_tpu_torch.topology`), their nonzeros in
row-major order with their weights: the order and the weights of the JAX
package's networkx edge dicts. ``BLUEFOG_FLEETSIM_FILE`` appends every
event as a JSONL row (``tools/fleetsim_report.py`` renders it).
"""

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch import metrics as metrics_mod
from bluefog_tpu_torch.logging_util import logger, warn_once

__all__ = [
    "VirtualFleet",
    "base_edges",
    "ring_edges",
    "exp2_edges",
    "storm_plan",
    "cascade_plan",
    "region_plan",
    "FLEETSIM_FILE_ENV",
]

FLEETSIM_FILE_ENV = "BLUEFOG_FLEETSIM_FILE"

# a simultaneous kill batch at least this large (and >= 2) files a
# fleet_churn advisory
_CHURN_FRACTION = 0.01


def _rank_salt(rank: int) -> int:
    """Per-rank 64-bit mixing salt for the incremental live-set hash:
    the XOR of live ranks' salts is order-independent and updates in
    O(1) per membership transition (the fleet-scale stand-in for
    hashing the O(N) live tuple into every plan-cache key)."""
    x = (rank + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


# -- sparse topology constructors ---------------------------------------------


def ring_edges(size: int) -> Dict[Tuple[int, int], float]:
    """Bidirectional ring combine weights as an edge dict — sparse twin
    of :func:`bluefog_tpu_torch.topology.RingGraph` (connect_style=0)."""
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    if size == 1:
        return {(0, 0): 1.0}
    if size == 2:
        return {(0, 0): 0.5, (0, 1): 0.5, (1, 0): 0.5, (1, 1): 0.5}
    out: Dict[Tuple[int, int], float] = {}
    w = 1.0 / 3.0
    for i in range(size):
        out[(i, i)] = w
        out[(i, (i + 1) % size)] = w
        out[(i, (i - 1) % size)] = w
    return out


def exp2_edges(size: int) -> Dict[Tuple[int, int], float]:
    """Exponential-2 combine weights as an edge dict — sparse twin of
    :func:`bluefog_tpu_torch.topology.ExponentialTwoGraph` (O(N log N)
    construction; the generator's dense N x N array never exists)."""
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    offsets = [0]
    d = 1
    while d < size:
        offsets.append(d)
        d *= 2
    w = 1.0 / len(offsets)
    out: Dict[Tuple[int, int], float] = {}
    for i in range(size):
        for d in offsets:
            out[(i, (i + d) % size)] = w
    return out


def base_edges(size: int, kind: str = "exp2",
               seed: int = 0) -> Dict[Tuple[int, int], float]:
    """Base-topology edge dict by name. ``ring`` and ``exp2`` build
    sparsely (the fleet-scale families); ``mesh`` / ``star`` / ``rrd``
    read the dense generator matrices of
    :mod:`bluefog_tpu_torch.topology` (their nonzeros, diagonal included,
    row-major) and are intended for small-N oracle tests."""
    if kind == "ring":
        return ring_edges(size)
    if kind == "exp2":
        return exp2_edges(size)
    from bluefog_tpu_torch import topology as topo_mod

    if kind == "mesh":
        w = topo_mod.MeshGrid2DGraph(size)
    elif kind == "star":
        w = topo_mod.StarGraph(size)
    elif kind == "rrd":
        w = topo_mod.RandomRegularDigraph(size, min(3, size - 1), seed=seed)
    else:
        raise ValueError(
            f"unknown fleet topology {kind!r} "
            "(ring / exp2 / mesh / star / rrd)"
        )
    rows, cols = np.nonzero(w)
    return {(int(u), int(v)): float(w[u, v]) for u, v in zip(rows, cols)}


# -- fault-plan builders -------------------------------------------------------


def storm_plan(size: int, fraction: float, step: int, seed: int = 0):
    """A churn storm: ``fraction`` of the fleet killed simultaneously
    at ``step`` (the 10%-loss storm). Deterministic in
    ``seed``."""
    from bluefog_tpu_torch.elastic.faults import Fault, FaultPlan

    rng = np.random.RandomState(seed)
    k = max(1, int(round(size * fraction)))
    ranks = rng.choice(size, size=k, replace=False)
    return FaultPlan(
        [Fault(kind="kill", rank=int(r), step=step) for r in sorted(ranks)]
    )


def cascade_plan(size: int, count: int, start_step: int,
                 stride: int = 1, seed: int = 0):
    """A cascading failure: ``count`` kills spread ``stride`` steps
    apart — every kill lands on an already-repaired fleet, so each
    event re-runs the full detect/repair/recompile discipline."""
    from bluefog_tpu_torch.elastic.faults import Fault, FaultPlan

    rng = np.random.RandomState(seed)
    ranks = rng.choice(size, size=min(count, size - 1), replace=False)
    return FaultPlan([
        Fault(kind="kill", rank=int(r), step=start_step + k * stride)
        for k, r in enumerate(sorted(ranks))
    ])


def region_plan(size: int, lo: int, hi: int, step: int):
    """Whole-region loss: every rank in ``[lo, hi)`` killed at once
    (a pod / availability-zone outage)."""
    from bluefog_tpu_torch.elastic.faults import Fault, FaultPlan

    return FaultPlan([
        Fault(kind="kill", rank=r, step=step) for r in range(lo, hi)
    ])


def classify_loss(detected: Sequence[int], n: int,
                  layout=None) -> Dict[str, object]:
    """Classify one batched detection into a loss class for the repair
    event record (rendered as distinct classes by
    ``tools/fleetsim_report.py`` — a whole-pod outage must not read
    like scattered churn in the storm timeline).

    - ``pod_loss``: a declared pod layout
      (:class:`bluefog_tpu_torch.federation.PodLayout`) and the detected set
      covers >= 1 whole pod — ``pods_lost`` lists them.
    - ``region_loss``: no pod knowledge, but the detected ranks form
      one contiguous block of at least ``max(4, 2%)`` of the fleet (a
      rack / availability-zone outage under serpentine placement).
    - ``storm``: simultaneous scattered loss at or above the churn
      advisory threshold.
    - ``churn``: everything smaller.
    """
    ranks = sorted(int(r) for r in set(detected))
    if not ranks:
        return {"loss_class": "none"}
    if layout is not None:
        covered = set(ranks)
        pods_lost = [
            p for p in range(layout.n_pods)
            if all(r in covered for r in layout.ranks(p))
        ]
        if pods_lost:
            return {"loss_class": "pod_loss", "pods_lost": pods_lost}
    block = (
        len(ranks) >= max(4, int(n * 0.02))
        and ranks[-1] - ranks[0] + 1 == len(ranks)
    )
    if block:
        return {
            "loss_class": "region_loss",
            "region": [ranks[0], ranks[-1]],
        }
    if len(ranks) >= max(2, int(n * _CHURN_FRACTION)):
        return {"loss_class": "storm"}
    return {"loss_class": "churn"}


# -- sparse repair-weight algebra ---------------------------------------------


class FleetTopology:
    """The live combine matrix held as per-rank edge dicts with the
    :func:`~bluefog_tpu_torch.elastic.repair.repaired_matrix` policy contract
    applied lazily: ``receiver`` / ``push_sum`` normalizers are cached
    per rank and invalidated only in the killed ranks' neighborhoods
    (O(degree^2) per killed rank), ``average`` rebuilds its
    Metropolis–Hastings weights per event (O(edges) — the connectivity
    audit that unions in the survivor ring needs the whole graph)."""

    def __init__(self, n: int, edges: Dict[Tuple[int, int], float],
                 policy: str = "receiver"):
        from bluefog_tpu_torch.elastic.repair import POLICIES

        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        self.n = int(n)
        self.policy = policy
        self.base_out: List[Dict[int, float]] = [dict() for _ in range(n)]
        self.base_in: List[Dict[int, float]] = [dict() for _ in range(n)]
        self.base_self = np.zeros(n)
        for (i, j), w in edges.items():
            if w == 0.0:
                continue
            if i == j:
                self.base_self[i] = float(w)
            else:
                self.base_out[i][j] = float(w)
                self.base_in[j][i] = float(w)
        self.live = np.ones(n, dtype=bool)
        self.degraded: Dict[int, float] = {}
        # lazy normalizers: rank -> 1/sum (None = dirty). Start clean
        # with everything live.
        self._col: List[Optional[float]] = [None] * n
        self._row: List[Optional[float]] = [None] * n
        self._avg: Optional[List[Dict[int, float]]] = None
        self.partitioned = False

    # -- membership events ----------------------------------------------------

    def _touch_neighborhood(self, rank: int) -> int:
        """Invalidate the normalizer caches of every rank adjacent to
        ``rank`` — the only ranks whose repaired weights can change.
        Returns the number of touched ranks (the per-event cost the
        cost of an event)."""
        touched = 0
        for j in self.base_out[rank]:
            self._col[j] = None
            touched += 1
        for i in self.base_in[rank]:
            self._row[i] = None
            touched += 1
        self._col[rank] = None
        self._row[rank] = None
        return touched + 1

    def kill(self, ranks: Sequence[int]) -> int:
        touched = 0
        for r in ranks:
            r = int(r)
            if self.live[r]:
                self.live[r] = False
                self.degraded.pop(r, None)
                touched += self._touch_neighborhood(r)
        self._avg = None
        return touched

    def revive(self, rank: int) -> int:
        rank = int(rank)
        if not self.live[rank]:
            self.live[rank] = True
            self._avg = None
            return self._touch_neighborhood(rank)
        return 0

    def degrade(self, rank: int, factor: float) -> int:
        rank = int(rank)
        if not self.live[rank]:
            return 0
        self.degraded[rank] = float(factor)
        self._avg = None
        return self._touch_neighborhood(rank)

    # -- policy weights -------------------------------------------------------

    def _dfac(self, sender: int, receiver: int) -> float:
        """Degrade discount of edge ``(sender, receiver)``: a degraded
        rank's outgoing edges (self loop excluded) carry its factor —
        the `repaired_matrix` pre-normalization scaling."""
        if sender == receiver:
            return 1.0
        return self.degraded.get(sender, 1.0)

    def _col_scale(self, j: int) -> float:
        s = self._col[j]
        if s is None:
            tot = self.base_self[j]
            for i, w in self.base_in[j].items():
                if self.live[i]:
                    tot += w * self._dfac(i, j)
            s = (1.0 / tot) if tot > 0.0 else 0.0
            self._col[j] = s
        return s

    def _row_scale(self, i: int) -> float:
        s = self._row[i]
        if s is None:
            tot = self.base_self[i]
            for j, w in self.base_out[i].items():
                if self.live[j]:
                    tot += w * self._dfac(i, j)
            s = (1.0 / tot) if tot > 0.0 else 0.0
            self._row[i] = s
        return s

    def _average_weights(self) -> List[Dict[int, float]]:
        """Per-rank ``{dst: w}`` out-edge weights (self loop included as
        ``{rank: w}``) under the ``average`` policy: symmetrized
        surviving edge set, survivor-ring union when disconnected,
        Metropolis–Hastings weights, symmetric degrade reabsorbed into
        both diagonals — the dense `repaired_matrix` recipe verbatim,
        rebuilt per membership event."""
        if self._avg is not None:
            return self._avg
        n = self.n
        live = [r for r in range(n) if self.live[r]]
        adj: List[set] = [set() for _ in range(n)]
        for i in live:
            for j in self.base_out[i]:
                if i != j and self.live[j]:
                    adj[i].add(j)
                    adj[j].add(i)
        # survivor connectivity audit (BFS over the symmetrized live
        # graph); disconnected -> union in the survivor ring
        self.partitioned = False
        if len(live) > 1:
            seen = {live[0]}
            stack = [live[0]]
            while stack:
                u = stack.pop()
                for v in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        stack.append(v)
            if len(seen) != len(live):
                self.partitioned = True
                for k, i in enumerate(live):
                    j = live[(k + 1) % len(live)]
                    if i != j:
                        adj[i].add(j)
                        adj[j].add(i)
        deg = {i: len(adj[i]) for i in live}
        out: List[Dict[int, float]] = [dict() for _ in range(n)]
        for i in live:
            row_sum = 0.0
            row = out[i]
            for j in adj[i]:
                w = 1.0 / (1.0 + max(deg[i], deg[j]))
                w *= self._dfac(i, j) * self._dfac(j, i)
                row[j] = w
                row_sum += w
            row[i] = 1.0 - row_sum
        for d in range(n):
            if not self.live[d]:
                out[d] = {d: 1.0}
        self._avg = out
        return out

    def send_weights(self, i: int) -> Dict[int, float]:
        """Effective out-edge weights of live rank ``i`` (self loop
        included) under the active policy — the operand a dispatch
        round actually ships."""
        if not self.live[i]:
            return {i: 1.0}
        if self.policy == "average":
            return dict(self._average_weights()[i])
        out: Dict[int, float] = {}
        if self.policy == "receiver":
            s = self._col_scale(i)
            out[i] = self.base_self[i] * s if s > 0.0 else 1.0
            for j, w in self.base_out[i].items():
                if self.live[j]:
                    sj = self._col_scale(j)
                    if sj > 0.0:
                        out[j] = w * self._dfac(i, j) * sj
            return out
        # push_sum: sender-normalized
        s = self._row_scale(i)
        if s <= 0.0:
            return {i: 1.0}
        out[i] = self.base_self[i] * s
        for j, w in self.base_out[i].items():
            if self.live[j]:
                out[j] = w * self._dfac(i, j) * s
        return out

    def recv_weights(self, j: int) -> Tuple[float, Dict[int, float]]:
        """(self_weight, {in_neighbor: weight}) of live rank ``j`` —
        the :func:`bluefog_tpu_torch.topology.GetRecvWeights` view of the
        repaired matrix, O(degree)."""
        if not self.live[j]:
            return 1.0, {}
        if self.policy == "average":
            # the average adjacency is symmetric (incl. any ring-union
            # edges), so j's in-neighbors are exactly the keys of its
            # own out row
            row_all = self._average_weights()
            self_w = row_all[j].get(j, 0.0)
            nbrs = {
                i: row_all[i][j]
                for i in row_all[j]
                if i != j
            }
            return self_w, nbrs
        if self.policy == "receiver":
            s = self._col_scale(j)
            if s <= 0.0:
                return 1.0, {}
            nbrs = {
                i: w * self._dfac(i, j) * s
                for i, w in self.base_in[j].items()
                if self.live[i]
            }
            return self.base_self[j] * s, nbrs
        # push_sum
        nbrs = {}
        for i, w in self.base_in[j].items():
            if self.live[i]:
                si = self._row_scale(i)
                if si > 0.0:
                    nbrs[i] = w * self._dfac(i, j) * si
        return self.base_self[j] * self._row_scale(j), nbrs

    # -- whole-matrix views (tests / verdicts) --------------------------------

    def live_ranks(self) -> List[int]:
        return [r for r in range(self.n) if self.live[r]]

    def edges_dict(self) -> Dict[Tuple[int, int], float]:
        """Full repaired edge dict (dead ranks isolated at self weight
        1) — O(edges); the oracle-test and verdict view, not the
        per-event path."""
        out: Dict[Tuple[int, int], float] = {}
        if self.policy == "average":
            rows = self._average_weights()
            for i in range(self.n):
                for j, w in rows[i].items():
                    if w != 0.0:
                        out[(i, j)] = w
            return out
        for i in range(self.n):
            for j, w in self.send_weights(i).items():
                if w != 0.0:
                    out[(i, j)] = w
        return out

    def to_dense(self) -> np.ndarray:
        w = np.zeros((self.n, self.n))
        for (i, j), v in self.edges_dict().items():
            w[i, j] = v
        return w

    def decay_info(self) -> Tuple[Optional[float], dict]:
        """Post-repair verdict: predicted per-step consensus decay on
        the live submatrix through the spectral engine (sparse above
        ``BLUEFOG_SPECTRAL_DENSE_MAX``). ``None`` = no contraction
        promised."""
        from bluefog_tpu_torch import topology as topo_mod

        live = self.live_ranks()
        n_sub, sub = topo_mod.live_submatrix_edges(self.edges_dict(), live)
        rate, spec = topo_mod.second_largest_eigenvalue_modulus_info(
            (n_sub, sub)
        )
        if rate >= 1.0 - 1e-9:
            return None, spec
        return float(rate), spec


# -- the simulator -------------------------------------------------------------


class VirtualFleet:
    """N virtual ranks on the fault-plan step clock. One
    :meth:`tick` = one communicating step: due faults apply through the
    real :class:`Membership` state machine, detection + repair run
    *before* the dispatch (the elastic engine's synchronous
    discipline), and the dispatch fetches its plan under the real
    cache-key shape with the zero-stale tripwire."""

    def __init__(self, n: int, topology: str = "exp2",
                 policy: str = "receiver", plan=None,
                 method: str = "neighbor_allreduce",
                 audit_edges: bool = True, seed: int = 0,
                 edges: Optional[Dict[Tuple[int, int], float]] = None):
        from bluefog_tpu_torch.elastic.faults import FaultPlan
        from bluefog_tpu_torch.elastic.membership import Membership

        self.n = int(n)
        self.topology = topology
        self.topo = FleetTopology(
            n,
            edges if edges is not None else base_edges(n, topology, seed),
            policy,
        )
        # pod layout (bluefog_tpu_torch.federation.PodLayout) for loss-class
        # annotation on repair events; federated fleets install a
        # repair_hook that runs INSIDE the timed repair pass (gateway
        # re-election) so membership + rewiring stay one event
        self.pod_layout = None
        self.repair_hook = None
        if os.environ.get("BLUEFOG_PODS", "").strip():
            try:
                from bluefog_tpu_torch import federation

                self.pod_layout = federation.layout_from_env(self.n)
            except ValueError:
                warn_once(
                    "fleetsim-pods",
                    "BLUEFOG_PODS does not parse for a %d-rank fleet; "
                    "repair events stay unclassified", self.n,
                )
        self.membership = Membership(n)
        self.fault_plan = plan if plan is not None else FaultPlan()
        self.fault_plan.validate(n)
        self.method = method
        self.audit_edges = bool(audit_edges)
        self.step = 0
        self.topo_version = 0
        self.events: List[dict] = []
        self.advisories: List[object] = []
        self.repairs = 0
        self.stale_dispatches = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.plan_cache: Dict[tuple, dict] = {}
        self.last_event_ms: Optional[float] = None
        self.last_decision_ms: Optional[float] = None
        self._live_hash = 0
        self._live_count = self.n
        for r in range(self.n):
            self._live_hash ^= _rank_salt(r)
        self._dead_seen: set = set()
        self._degrade_dirty = False
        self._file = os.environ.get(FLEETSIM_FILE_ENV)
        self._file_ok = True
        metrics_mod.gauge("bluefog.fleetsim.ranks").set(self.n)
        metrics_mod.gauge("bluefog.fleetsim.live").set(self.n)

    # -- plan-cache key discipline --------------------------------------------

    def live_token(self) -> tuple:
        """The plan-cache live token, maintained incrementally: the
        membership epoch plus an order-independent XOR hash of the live
        set (O(1) per transition vs the O(N) live tuple the device
        path hashes — same discipline: any membership change changes
        the token)."""
        return (self.membership.epoch, self._live_hash, self._live_count)

    def _cache_key(self) -> tuple:
        # the `ops._static_plan` key shape: fleet topologies are always
        # weighted
        return ("static_plan", self.topo_version, True, self.method,
                self.live_token())

    def _compile_plan(self) -> dict:
        plan = {
            "topo_version": self.topo_version,
            "token": self.live_token(),
        }
        if self.audit_edges:
            # compile-time edge snapshot (O(edges)) for the per-dispatch
            # stale audit; ``audit_edges=False`` (a timed run)
            # disables it and audits version/token only
            edges = []
            for i in self.topo.live_ranks():
                for j in self.topo.send_weights(i):
                    if i != j:
                        edges.append((i, j))
            plan["edges"] = edges
        return plan

    # -- event application ----------------------------------------------------

    def _record(self, row: dict) -> None:
        self.events.append(row)
        if self._file and self._file_ok:
            try:
                with open(self._file, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
            except OSError:
                self._file_ok = False
                warn_once(
                    "fleetsim-file",
                    "fleetsim JSONL path %s is not writable; fleet "
                    "events stay in memory only", self._file,
                )

    def _advise(self, kind: str, step: int, detail: dict) -> None:
        from bluefog_tpu_torch.attribution import Advisory

        adv = Advisory(kind=kind, step=step, detail=detail)
        self.advisories.append(adv)
        metrics_mod.counter("bluefog.fleetsim.advisories").inc()
        self._record({"metric": "fleetsim_advisory", **adv.to_json()})

    def _repair(self, newly_dead: List[int], step: int) -> float:
        """Synchronous repair: prune + renormalize the killed ranks'
        neighborhoods, bump the topology version (old plan-cache keys
        can never match again), file the advisory, and record the
        event. Returns the measured event cost in ms."""
        t0 = time.perf_counter()
        touched = self.topo.kill(newly_dead)
        for r, f in self.membership.degraded().items():
            if self.topo.degraded.get(r) != f:
                touched += self.topo.degrade(r, f)
        hook_detail = None
        if self.repair_hook is not None:
            # federated fleets re-elect gateways and rewire the
            # inter-pod ring HERE — inside the timed window, before the
            # single version bump, so the whole transition is one event
            hook_detail = self.repair_hook(newly_dead, step)
        self.topo_version += 1
        self.repairs += 1
        self._degrade_dirty = False
        ms = (time.perf_counter() - t0) * 1e3
        self.last_event_ms = ms
        metrics_mod.counter("bluefog.fleetsim.repairs").inc()
        metrics_mod.gauge("bluefog.fleetsim.live").set(self._live_count)
        metrics_mod.gauge("bluefog.fleetsim.epoch").set(
            self.membership.epoch
        )
        metrics_mod.histogram("bluefog.fleetsim.event_ms").observe(ms)
        row = {
            "metric": "fleetsim_repair",
            "step": int(step),
            "detected": [int(r) for r in newly_dead],
            "dead": self.n - self._live_count,
            "live": self._live_count,
            "epoch": int(self.membership.epoch),
            "topo_version": int(self.topo_version),
            "policy": self.topo.policy,
            "touched_ranks": int(touched),
            "event_ms": round(ms, 6),
        }
        row.update(classify_loss(newly_dead, self.n, self.pod_layout))
        if hook_detail:
            row.update(hook_detail)
        self._record(row)
        if len(newly_dead) >= max(2, int(self.n * _CHURN_FRACTION)):
            self._advise("fleet_churn", step, {
                "killed": len(newly_dead),
                "live": self._live_count,
                "epoch": int(self.membership.epoch),
                "event_ms": round(ms, 6),
            })
        if self.topo.partitioned:
            self._advise("fleet_partition", step, {
                "live": self._live_count,
                "note": "survivor graph disconnected; ring unioned in",
            })
        return ms

    def kill(self, rank: int, step: Optional[int] = None) -> bool:
        """Out-of-plan kill (a storm scenario calls this directly)."""
        rank = int(rank)
        if not self.membership.mark_dead(rank, step=step):
            return False
        self._live_hash ^= _rank_salt(rank)
        self._live_count -= 1
        self._dead_seen.add(rank)
        metrics_mod.counter("bluefog.fleetsim.events").inc()
        return True

    def rejoin(self, rank: int) -> bool:
        """Re-admit a dead rank and repair — the elastic rejoin path on
        the virtual fleet."""
        rank = int(rank)
        if not self.membership.revive(rank, step=self.step):
            return False
        self._live_hash ^= _rank_salt(rank)
        self._live_count += 1
        self._dead_seen.discard(rank)
        self.topo.revive(rank)
        metrics_mod.counter("bluefog.fleetsim.events").inc()
        self.topo_version += 1
        self.repairs += 1
        self._record({
            "metric": "fleetsim_rejoin",
            "step": int(self.step),
            "rank": rank,
            "live": self._live_count,
            "epoch": int(self.membership.epoch),
            "topo_version": int(self.topo_version),
        })
        return True

    def tick(self) -> dict:
        """One communicating step on the fault-plan clock: apply due
        faults, repair before dispatch, dispatch under the cache-key
        discipline. Returns the step summary row."""
        step = self.step
        newly: List[int] = []
        for f in self.fault_plan.due(step):
            if f.kind == "kill":
                if self.kill(f.rank, step=step):
                    newly.append(f.rank)
            elif f.kind == "degrade":
                if self.membership.mark_degraded(f.rank, f.factor,
                                                 step=step):
                    self._degrade_dirty = True
                    metrics_mod.counter("bluefog.fleetsim.events").inc()
            else:
                # stall/slow/oom have no membership consequence here;
                # they are suspects for the advisory join
                self._advise("fleet_suspect", step, {
                    "rank": int(f.rank), "kind": f.kind,
                })
        if newly or self._degrade_dirty:
            self._repair(newly, step)
        row = self.dispatch()
        self.step += 1
        return row

    def run(self, steps: int) -> None:
        for _ in range(int(steps)):
            self.tick()

    def dispatch(self) -> dict:
        """One virtual dispatch: fetch the plan under the real cache
        key; audit it against the dead set (the zero-stale tripwire —
        any fetched plan carrying an edge into a dead rank is a stale
        dispatch, and the counter must stay 0)."""
        key = self._cache_key()
        plan = self.plan_cache.get(key)
        if plan is None:
            plan = self._compile_plan()
            self.plan_cache[key] = plan
            self.cache_misses += 1
        else:
            self.cache_hits += 1
        stale = (
            plan["topo_version"] != self.topo_version
            or plan["token"] != self.live_token()
        )
        if not stale and self.audit_edges:
            for (i, j) in plan.get("edges", ()):
                if not (self.topo.live[i] and self.topo.live[j]):
                    stale = True
                    break
        if stale:
            self.stale_dispatches += 1
            metrics_mod.counter(
                "bluefog.fleetsim.stale_dispatches"
            ).inc()
            logger.warning(
                "fleetsim stale dispatch at step %d (topo v%d)",
                self.step, self.topo_version,
            )
        return {
            "step": int(self.step),
            "live": self._live_count,
            "epoch": int(self.membership.epoch),
            "topo_version": int(self.topo_version),
            "stale": bool(stale),
        }

    # -- fleet aggregation (push-sum lanes, sparse) ---------------------------

    def aggregate(self, values: np.ndarray, rounds: int) -> dict:
        """The health plane's in-band push-sum aggregate over the
        virtual fleet: ``rounds`` applications of ``x <- P^T x``,
        ``p <- P^T p`` plus min/max neighbor folds, as sparse
        scatter-adds over the live edge list. Same per-application
        semantics as :func:`bluefog_tpu_torch.health.fleet_aggregate_np`
        (the small-N oracle); same report shape."""
        from bluefog_tpu_torch.health import _fleet_estimates

        values = np.asarray(values, np.float64)
        n, _k = values.shape
        assert n == self.n, f"values rows {n} != fleet size {self.n}"
        live = self.topo.live_ranks()
        dead = [r for r in range(self.n) if not self.topo.live[r]]
        # push matrix: each live sender's current row (self + live out
        # edges) normalized to sum 1 — assembled as COO over the live
        # edge list
        rows: List[int] = []
        cols: List[int] = []
        vals: List[float] = []
        for i in live:
            sw = self.topo.send_weights(i)
            tot = sum(sw.values())
            if tot <= 0.0:
                rows.append(i)
                cols.append(i)
                vals.append(1.0)
                continue
            for j, w in sw.items():
                if w != 0.0:
                    rows.append(i)
                    cols.append(j)
                    vals.append(w / tot)
        rows_a = np.asarray(rows, np.intp)
        cols_a = np.asarray(cols, np.intp)
        vals_a = np.asarray(vals, np.float64)
        off = rows_a != cols_a
        x = values.copy()
        p = np.ones(self.n)
        mn = values.copy()
        mx = values.copy()
        for r in dead:
            x[r] = 0.0
            p[r] = 0.0
            mn[r] = np.inf
            mx[r] = -np.inf
        for _ in range(int(rounds)):
            x2 = np.zeros_like(x)
            np.add.at(x2, cols_a, vals_a[:, None] * x[rows_a])
            p2 = np.zeros_like(p)
            np.add.at(p2, cols_a, vals_a * p[rows_a])
            mn0, mx0 = mn.copy(), mx.copy()
            np.minimum.at(mn, cols_a[off], mn0[rows_a[off]])
            np.maximum.at(mx, cols_a[off], mx0[rows_a[off]])
            x, p = x2, p2
        return _fleet_estimates(x, p, mn, mx, live)

    # -- autotune decision latency --------------------------------------------

    def decision_probe(self,
                       factors: Optional[Dict[Tuple[int, int], float]]
                       = None) -> dict:
        """One controller decision at fleet scale: score the candidate
        set (incumbent / live ring / live Exp2) through the sparse
        spectral engine and pick the best predicted rate, measuring the
        decision latency. Wire pricing is
        the per-step round count proxy (max live out-degree); the
        spectral term is the real engine with its convergence
        disclosure."""
        from bluefog_tpu_torch import topology as topo_mod

        t0 = time.perf_counter()
        live = self.topo.live_ranks()
        sub_n, current = topo_mod.live_submatrix_edges(
            self.topo.edges_dict(), live
        )
        cands = {
            "current": current,
            "ring": ring_edges(sub_n),
            "exp2": exp2_edges(sub_n),
        }
        if factors:
            for edges in cands.values():
                for (s, d), f in factors.items():
                    w = edges.get((s, d))
                    if w is None or s == d:
                        continue
                    lost = (1.0 - min(max(float(f), 0.0), 1.0)) * w
                    edges[(s, d)] = w - lost
                    edges[(d, d)] = edges.get((d, d), 0.0) + lost
        scored = {}
        for name, edges in cands.items():
            rate, spec = topo_mod.consensus_decay_rate_info((sub_n, edges))
            out_deg: Dict[int, int] = {}
            for (i, j) in edges:
                if i != j:
                    out_deg[i] = out_deg.get(i, 0) + 1
            rounds = max(out_deg.values()) if out_deg else 0
            scored[name] = {
                "rate": float(rate),
                "rounds": int(rounds),
                "steps_to_eps": (
                    float(math.log(1e-6) / math.log(rate))
                    if 0.0 < rate < 1.0 - 1e-12 else None
                ),
                "spectral": {
                    "engine": spec.get("engine"),
                    "matvecs": spec.get("matvecs", 0),
                    "residual": spec.get("residual", 0.0),
                    "converged": spec.get("converged", True),
                },
            }
        def _objective(s):
            if s["steps_to_eps"] is None:
                return float("inf")
            return s["steps_to_eps"] * max(s["rounds"], 1)
        chosen = min(scored, key=lambda k: _objective(scored[k]))
        ms = (time.perf_counter() - t0) * 1e3
        self.last_decision_ms = ms
        metrics_mod.histogram("bluefog.fleetsim.decision_ms").observe(ms)
        row = {
            "metric": "fleetsim_decision",
            "step": int(self.step),
            "n_live": sub_n,
            "chosen": chosen,
            "decision_ms": round(ms, 3),
            "candidates": scored,
        }
        self._record(row)
        return row

    # -- summary ---------------------------------------------------------------

    def summary(self) -> dict:
        """The storm-timeline summary the report tool renders."""
        worst = None
        for e in self.events:
            if e.get("metric") == "fleetsim_repair":
                if worst is None or e["event_ms"] > worst["event_ms"]:
                    worst = e
        return {
            "n": self.n,
            "topology": self.topology,
            "policy": self.topo.policy,
            "steps": int(self.step),
            "live": self._live_count,
            "dead": self.n - self._live_count,
            "epoch": int(self.membership.epoch),
            "topo_version": int(self.topo_version),
            "repairs": int(self.repairs),
            "stale_dispatches": int(self.stale_dispatches),
            "cache_hits": int(self.cache_hits),
            "cache_misses": int(self.cache_misses),
            "advisories": [
                a.to_json() for a in self.advisories
            ],
            "worst_event_ms": (
                worst["event_ms"] if worst is not None else None
            ),
            "last_decision_ms": self.last_decision_ms,
        }
