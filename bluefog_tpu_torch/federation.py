# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Two-level federation: one gossip fabric across pods (``bft.federation``).

Counterpart of ``bluefog_tpu/federation.py``. The fabric has two levels:

- **Intra-pod (ICI)**: each pod keeps its gossip graph (Exp2 by default),
  compiled by the plan compiler under the ``"ici"`` link class and
  dispatched every communicating step.
- **Inter-pod (DCN)**: one **gateway** rank per pod (the lowest live rank,
  deterministic, re-elected on a membership change) gossips with the other
  pods' gateways on a ring, every ``BLUEFOG_DCN_PERIOD`` communicating
  steps, on the quantized wire ``BLUEFOG_DCN_WIRE`` (default int4),
  compiled under the ``"dcn"`` link class.

The composed two-level mixing is scored by the sparse spectral engine
(:mod:`bluefog_tpu_torch.topology.spectral`): a period-``T`` window is
``T`` intra-pod combines and one gateway combine, its per-step rate
``slem ** (1/T)``, so :func:`choose_dcn_period` chooses the period from a
target rate. Pods are contiguous rank ranges (the serpentine placement
contract of :mod:`bluefog_tpu_torch.topology.placement`), cross-checked
against a declared ``BLUEFOG_TORUS_DIMS``.

In the port the pods are contiguous ranges of the virtual workers on one
card: a gateway round is one more gather in device memory, so the per-leg
byte counts (:func:`wire_summary`, the ``bluefog.federation.*`` counters)
are what a real DCN link would carry, not what the card moves. The
optimizers' federated dispatch is
:meth:`bluefog_tpu_torch.optimizers._GossipOptimizer._fed_dispatch`.

Nothing here activates unless ``BLUEFOG_PODS`` is set: a flat run builds
no ``"fed"`` key and dispatches what it dispatched before.

Environment:

- ``BLUEFOG_PODS``: a pod count (``"2"``), a ``pods x ranks`` shape
  (``"2x8"``), or inclusive rank ranges (``"0-7,8-15"``) that partition
  ``0..N-1`` contiguously.
- ``BLUEFOG_DCN_PERIOD``: the inter-pod period in communicating steps
  (default 8).
- ``BLUEFOG_DCN_WIRE``: the DCN leg's wire, ``int4`` (default), ``int8``,
  ``bf16`` or ``exact``; ``int4_ef``/``int8_ef`` fall back to their
  memoryless base with a one-time warning (residuals would go stale across
  the period).
"""

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.logging_util import warn_once

__all__ = [
    "PODS_ENV",
    "DCN_PERIOD_ENV",
    "DCN_WIRE_ENV",
    "DEFAULT_DCN_PERIOD",
    "DEFAULT_DCN_WIRE",
    "PodLayout",
    "parse_pods",
    "enabled",
    "layout_from_env",
    "dcn_period",
    "dcn_wire",
    "elect_gateways",
    "intra_edges",
    "inter_edges",
    "federated_union_edges",
    "composed_rate",
    "choose_dcn_period",
    "simulate_consensus",
    "intra_plan",
    "inter_plan",
    "wire_summary",
    "Fabric",
    "get_fabric",
    "clear_fabric_cache",
    "FederatedFleet",
]

PODS_ENV = "BLUEFOG_PODS"
DCN_PERIOD_ENV = "BLUEFOG_DCN_PERIOD"
DCN_WIRE_ENV = "BLUEFOG_DCN_WIRE"

DEFAULT_DCN_PERIOD = 8
DEFAULT_DCN_WIRE = "int4"

# Memoryless tiers the DCN leg may ride (None = exact f32). The _ef
# tiers are deliberately absent — see dcn_wire().
_DCN_WIRES = (None, "int8", "bf16", "int4")


def enabled() -> bool:
    """True when a pod spec is declared — the single activation gate.
    Everything in this module is inert without it."""
    return bool(os.environ.get(PODS_ENV, "").strip())


# -- pod layout ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PodLayout:
    """A partition of ranks ``0..size-1`` into contiguous pods.

    ``bounds[p] = (lo, hi)`` half-open: pod ``p`` owns ranks ``lo..hi-1``.
    Contiguity is a contract, not a convenience: the serpentine device
    order (:mod:`bluefog_tpu_torch.topology.placement`) lays consecutive
    virtual ranks onto physically adjacent chips, so a contiguous rank
    range IS a physically compact region — the thing a "pod" means.
    """

    size: int
    bounds: Tuple[Tuple[int, int], ...]
    spec: str = ""

    @property
    def n_pods(self) -> int:
        return len(self.bounds)

    def ranks(self, pod: int) -> range:
        lo, hi = self.bounds[pod]
        return range(lo, hi)

    def pod_of(self, rank: int) -> int:
        for p, (lo, hi) in enumerate(self.bounds):
            if lo <= rank < hi:
                return p
        raise ValueError(f"rank {rank} outside the {self.size}-rank layout")

    def gateways(
        self, live: Optional[Sequence[int]] = None
    ) -> Tuple[Optional[int], ...]:
        """The designated gateway per pod: the LOWEST live rank (None
        for a fully dead pod). Deterministic in the live set, so every
        survivor elects the same gateways without coordination."""
        if live is None:
            return tuple(lo for lo, _hi in self.bounds)
        live_set = set(int(r) for r in live)
        out: List[Optional[int]] = []
        for lo, hi in self.bounds:
            g = next((r for r in range(lo, hi) if r in live_set), None)
            out.append(g)
        return tuple(out)

    def to_json(self) -> dict:
        return {
            "size": self.size,
            "n_pods": self.n_pods,
            "bounds": [list(b) for b in self.bounds],
            "spec": self.spec,
        }


def parse_pods(spec: str, size: int) -> PodLayout:
    """Parse a ``BLUEFOG_PODS`` spec into a validated :class:`PodLayout`.

    Three forms: a pod count (``"2"`` — equal split, size must divide),
    a ``pods x ranks`` shape (``"2x8"`` — product must equal ``size``),
    or explicit inclusive rank ranges (``"0-7,8-15"`` — must partition
    ``0..size-1`` contiguously, in order). A declared torus fabric
    (``BLUEFOG_TORUS_DIMS``) is cross-checked: pod boundaries that slice
    through an inner torus plane warn once (the pods are still usable,
    but the serpentine-compactness argument weakens)."""
    from bluefog_tpu_torch.topology import placement

    spec = str(spec).strip()
    size = int(size)
    if size < 2:
        raise ValueError(f"{PODS_ENV} needs at least 2 ranks, got {size}")
    if not spec:
        raise ValueError(f"empty {PODS_ENV} spec")

    bounds: List[Tuple[int, int]] = []
    if "-" in spec:
        cursor = 0
        for part in spec.split(","):
            part = part.strip()
            try:
                lo_s, hi_s = part.split("-")
                lo, hi = int(lo_s), int(hi_s) + 1
            except ValueError:
                raise ValueError(
                    f"{PODS_ENV} range {part!r} is not 'lo-hi'"
                ) from None
            if lo != cursor:
                raise ValueError(
                    f"{PODS_ENV} ranges must partition 0..{size - 1} "
                    f"contiguously in order; pod {len(bounds)} starts at "
                    f"{lo}, expected {cursor}"
                )
            if hi <= lo:
                raise ValueError(f"{PODS_ENV} range {part!r} is empty")
            bounds.append((lo, hi))
            cursor = hi
        if cursor != size:
            raise ValueError(
                f"{PODS_ENV} ranges cover 0..{cursor - 1} but the world "
                f"has {size} ranks"
            )
    else:
        try:
            dims = tuple(
                int(d) for d in spec.replace("x", ",").split(",")
                if d.strip()
            )
        except ValueError:
            raise ValueError(
                f"{PODS_ENV}={spec!r} is not a pod count, 'PxR' shape, "
                "or 'lo-hi,...' range list"
            ) from None
        if len(dims) == 1:
            n_pods = dims[0]
            if n_pods < 2 or size % n_pods != 0:
                raise ValueError(
                    f"{PODS_ENV}={spec!r}: {size} ranks do not split "
                    f"into {n_pods} equal pods (need >= 2 pods and an "
                    "even division)"
                )
            per = size // n_pods
        elif len(dims) == 2:
            n_pods, per = dims
            if n_pods < 2 or per < 1 or n_pods * per != size:
                raise ValueError(
                    f"{PODS_ENV}={spec!r}: {n_pods} pods x {per} ranks "
                    f"!= {size} world ranks"
                )
        else:
            raise ValueError(
                f"{PODS_ENV}={spec!r} has {len(dims)} dims; expected a "
                "pod count or 'pods x ranks'"
            )
        bounds = [(p * per, (p + 1) * per) for p in range(n_pods)]

    if len(bounds) < 2:
        raise ValueError(
            f"{PODS_ENV}={spec!r} declares one pod; federation needs >= 2"
        )

    torus = placement.declared_torus_dims(size)
    if torus is not None and len(torus) > 1:
        inner = 1
        for d in torus[1:]:
            inner *= d
        if any((hi - lo) % inner != 0 for lo, hi in bounds):
            warn_once(
                f"pods-torus-misaligned-{size}",
                "%s=%r pod boundaries do not align to whole %s-rank "
                "planes of the declared torus %s; pods remain usable "
                "but are not physically compact regions",
                PODS_ENV, spec, inner, "x".join(str(d) for d in torus),
            )
    return PodLayout(size=size, bounds=tuple(bounds), spec=spec)


def layout_from_env(size: int) -> Optional[PodLayout]:
    """The env-declared layout for ``size`` ranks, or None when
    ``BLUEFOG_PODS`` is unset. Raises on a malformed spec — a declared
    federation that cannot be honored must not silently run flat."""
    spec = os.environ.get(PODS_ENV, "").strip()
    if not spec:
        return None
    return parse_pods(spec, size)


def dcn_period() -> int:
    raw = os.environ.get(DCN_PERIOD_ENV, "").strip()
    if not raw:
        return DEFAULT_DCN_PERIOD
    try:
        period = int(raw)
    except ValueError:
        raise ValueError(
            f"{DCN_PERIOD_ENV} must be a positive int, got {raw!r}"
        ) from None
    if period < 1:
        raise ValueError(
            f"{DCN_PERIOD_ENV} must be a positive int, got {raw!r}"
        )
    return period


def dcn_wire() -> Optional[str]:
    """The DCN leg's wire tier. Error-feedback tiers degrade to their
    memoryless base with a one-shot warning: CHOCO residuals integrated
    once per ``T``-step period would correct against ``T``-step-stale
    iterates — a bias, not an error feedback."""
    raw = os.environ.get(DCN_WIRE_ENV, "").strip().lower()
    if not raw:
        return DEFAULT_DCN_WIRE
    if raw in ("exact", "none", "f32", "fp32"):
        return None
    if raw in ("int8_ef", "int4_ef"):
        base = raw[:-3]
        warn_once(
            "dcn-wire-ef",
            "%s=%r: error-feedback wires are not supported on the "
            "periodic DCN leg (residual state would stale across the "
            "period); using the memoryless %r tier",
            DCN_WIRE_ENV, raw, base,
        )
        return base
    if raw not in ("int8", "bf16", "int4"):
        raise ValueError(
            f"{DCN_WIRE_ENV} must be one of int4/int8/bf16/exact "
            f"(got {raw!r})"
        )
    return raw


def elect_gateways(
    layout: PodLayout, live: Optional[Sequence[int]] = None
) -> Tuple[Optional[int], ...]:
    """Module-level alias of :meth:`PodLayout.gateways` (the elastic
    layer's entry point at repair time)."""
    return layout.gateways(live)


# -- two-level edge builders --------------------------------------------------


def intra_edges(
    layout: PodLayout, kind: str = "exp2"
) -> Dict[Tuple[int, int], float]:
    """The block-diagonal intra-pod combine: each pod's base topology
    (:func:`bluefog_tpu_torch.fleetsim.base_edges` — self loops included,
    receiver-normalized), remapped to global ranks."""
    from bluefog_tpu_torch import fleetsim

    out: Dict[Tuple[int, int], float] = {}
    for p in range(layout.n_pods):
        lo, hi = layout.bounds[p]
        for (a, b), w in fleetsim.base_edges(hi - lo, kind).items():
            out[(lo + a, lo + b)] = w
    return out


def inter_edges(
    layout: PodLayout,
    gateways: Optional[Sequence[Optional[int]]] = None,
) -> Dict[Tuple[int, int], float]:
    """The gateway combine: a ring over the (live) gateways,
    receiver-normalized, identity everywhere else. Applied AFTER the
    intra combine on a DCN step, so each gateway's payload already
    carries its pod's mixed value."""
    from bluefog_tpu_torch import fleetsim

    if gateways is None:
        gateways = layout.gateways()
    gws = [g for g in gateways if g is not None]
    out: Dict[Tuple[int, int], float] = {
        (r, r): 1.0 for r in range(layout.size) if r not in set(gws)
    }
    if len(gws) <= 1:
        # zero or one pod left: the inter leg is the identity
        for g in gws:
            out[(g, g)] = 1.0
        return out
    ring = fleetsim.ring_edges(len(gws))
    for (a, b), w in ring.items():
        out[(gws[a], gws[b])] = w
    return out


def federated_union_edges(
    layout: PodLayout,
    kind: str = "exp2",
    gateways: Optional[Sequence[Optional[int]]] = None,
) -> Dict[Tuple[int, int], float]:
    """The UNION graph (intra edges + cross-pod gateway edges) for
    consumers that hold one combine matrix — the fleet simulator's
    repair algebra. Off-diagonal gateway edges are added at the intra
    self-weight scale; a receiver-normalizing policy owns the final
    column sums."""
    if gateways is None:
        gateways = layout.gateways()
    out = dict(intra_edges(layout, kind))
    gws = [g for g in gateways if g is not None]
    for k in range(len(gws)):
        for d in (-1, 1):
            src, dst = gws[k], gws[(k + d) % len(gws)]
            if src != dst:
                out[(src, dst)] = out.get((src, dst), 0.0) + 0.5
    return out


# -- spectral scoring / the period chooser ------------------------------------


def composed_rate(
    layout: PodLayout, period: int, kind: str = "exp2",
    gateways: Optional[Sequence[Optional[int]]] = None,
) -> Tuple[float, dict]:
    """Per-communicating-step consensus decay rate of the two-level
    fabric at DCN period ``T``: the sparse spectral engine scores the
    ``T``-step window product (``T`` intra combines, one gateway
    combine) and the per-step rate is ``slem ** (1/T)`` — the window
    spans ``T`` gossip steps however many matrices compose it. The
    ``N x N`` product is never formed (period composes as mat-vecs)."""
    from bluefog_tpu_torch.topology import spectral

    period = int(period)
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    n = layout.size
    w_ici = (n, intra_edges(layout, kind))
    w_dcn = (n, inter_edges(layout, gateways))
    mats = [w_ici] * period + [w_dcn]
    _rate, info = spectral.decay_info(mats)
    rate = float(info["slem"]) ** (1.0 / period)
    info = dict(info)
    info["dcn_period"] = period
    info["rate_per_comm_step"] = rate
    return rate, info


def choose_dcn_period(
    layout: PodLayout,
    target_rate: float,
    kind: str = "exp2",
    max_period: int = 64,
) -> dict:
    """Choose the DCN period FROM a target per-step consensus rate.

    Scans ``T = 1..max_period`` (each window scored end-to-end by
    :func:`composed_rate`) and returns the LARGEST period whose
    composed per-step rate still meets ``target_rate`` — the least DCN
    traffic that keeps the promised contraction. When even ``T = 1``
    misses the target (the pod graph itself is the bottleneck) the
    result is ``period = 1`` with ``met = False`` disclosed.

    Returns ``{"period", "predicted_rate", "target_rate", "met",
    "table"}`` where ``table`` discloses every scored candidate."""
    target_rate = float(target_rate)
    best: Optional[Tuple[int, float]] = None
    table: List[dict] = []
    for period in range(1, int(max_period) + 1):
        rate, info = composed_rate(layout, period, kind)
        table.append({
            "period": period,
            "rate": round(rate, 8),
            "slem": round(float(info["slem"]), 8),
            "engine": info.get("engine"),
        })
        if rate <= target_rate:
            best = (period, rate)
        elif best is not None:
            # rate degrades monotonically past the knee; once the
            # target is lost after having been met, longer periods
            # cannot recover it
            break
    if best is None:
        rate1 = table[0]["rate"]
        return {
            "period": 1,
            "predicted_rate": rate1,
            "target_rate": target_rate,
            "met": False,
            "table": table,
        }
    return {
        "period": best[0],
        "predicted_rate": best[1],
        "target_rate": target_rate,
        "met": True,
        "table": table,
    }


def simulate_consensus(
    edges_sequence: Sequence[Tuple[int, Dict[Tuple[int, int], float]]],
    steps: int,
    seed: int = 0,
    comm_steps_per_cycle: Optional[int] = None,
) -> float:
    """MEASURED per-communicating-step consensus decay over a periodic
    matrix sequence: gossip a random mean-zero vector for ``steps``
    cycles of the sequence and fit the geometric rate of its deviation
    norm. The empirical check the spectral prediction is matched
    against (the prediction is a promise; this is the run).

    ``comm_steps_per_cycle`` is how many COMMUNICATING STEPS one pass
    of the sequence represents (default: one per matrix). A federated
    period-``T`` window lists ``T + 1`` matrices but spans ``T`` steps
    — the DCN combine rides the last step's dispatch — so pass ``T`` to
    make the measured rate comparable with :func:`composed_rate`."""
    n = edges_sequence[0][0]
    cycle = (
        len(edges_sequence) if comm_steps_per_cycle is None
        else int(comm_steps_per_cycle)
    )
    rng = np.random.RandomState(seed)
    x = rng.randn(n)
    x -= x.mean()
    d0 = float(np.linalg.norm(x))
    if d0 == 0.0:
        return 0.0
    mats = []
    for size, edges in edges_sequence:
        w = np.zeros((size, size))
        for (i, j), v in edges.items():
            w[i, j] = v
        mats.append(w)
    comm_steps = 0
    for _ in range(int(steps)):
        for w in mats:
            x = w.T @ x
        comm_steps += cycle
        x -= x.mean()
    d1 = float(np.linalg.norm(x))
    if d1 <= 0.0 or comm_steps == 0:
        return 0.0
    return (d1 / d0) ** (1.0 / comm_steps)


# -- CommPlan lowering --------------------------------------------------------


def _matrix_from_edges(
    n: int, edges: Dict[Tuple[int, int], float]
) -> np.ndarray:
    w = np.zeros((n, n))
    for (i, j), v in edges.items():
        w[i, j] = v
    return w


def intra_plan(layout: PodLayout, kind: str = "exp2", method: str = "auto"):
    """The ICI leg as a :class:`~bluefog_tpu_torch.collective.plan.CommPlan`,
    compiled against the ICI-class calibration (the default class — the
    flat fabric's exact compile path)."""
    from bluefog_tpu_torch.collective import plan as plan_mod

    w = _matrix_from_edges(layout.size, intra_edges(layout, kind))
    return plan_mod.plan_from_matrix(w, method=method)


def inter_plan(
    layout: PodLayout,
    live: Optional[Sequence[int]] = None,
    method: str = "auto",
):
    """The DCN leg as a :class:`~bluefog_tpu_torch.collective.plan.CommPlan`
    over the CURRENT gateways, compiled against the DCN-class
    calibration (``link_class="dcn"``)."""
    from bluefog_tpu_torch.collective import plan as plan_mod

    w = _matrix_from_edges(
        layout.size, inter_edges(layout, layout.gateways(live))
    )
    return plan_mod.plan_from_matrix(w, method=method, link_class="dcn")


def wire_summary(
    layout: PodLayout,
    n_elems: int,
    itemsize: int = 4,
    ici_wire: Optional[str] = None,
    dcn_wire_tier: Optional[str] = None,
    period: Optional[int] = None,
    kind: str = "exp2",
) -> dict:
    """Per-leg wire accounting for one communicating step: ICI bytes at
    full rate, DCN bytes amortized over the period, and the flat
    baseline — the per-step DCN bytes a FLAT fabric of the same base
    topology would push through cross-pod links (every cross-pod edge
    rides DCN every step at the gossip wire); ``dcn_cut_ratio`` is their
    ratio."""
    from bluefog_tpu_torch import fleetsim, metrics

    period = dcn_period() if period is None else int(period)
    if dcn_wire_tier is None:
        dcn_wire_tier = dcn_wire()
    intra = intra_plan(layout, kind)
    by_item = {int(itemsize): int(n_elems)}
    ici_bytes = metrics.wire_bytes_per_step(
        by_item, len(intra.rounds), ici_wire
    )
    # DCN legs are counted per-EDGE (fleet totals): only the gateway
    # pairs put bytes on DCN, so the per-worker round convention the
    # ICI counter uses would overcount every silent rank
    inter_e = inter_edges(layout)
    n_inter_edges = sum(1 for (i, j) in inter_e if i != j)
    per_edge_dcn = metrics.wire_bytes_per_step(by_item, 1, dcn_wire_tier)
    dcn_event_bytes = n_inter_edges * per_edge_dcn
    # flat baseline: the same base topology spanning all pods; its
    # cross-pod edges would each carry one payload per step on DCN
    flat = fleetsim.base_edges(layout.size, kind)
    per_edge = metrics.wire_bytes_per_step(by_item, 1, ici_wire)
    cross = sum(
        1 for (i, j) in flat
        if i != j and layout.pod_of(i) != layout.pod_of(j)
    )
    flat_dcn_bytes = cross * per_edge
    fed_dcn_bytes = dcn_event_bytes / max(period, 1)
    return {
        "ici_wire_bytes_per_step": int(ici_bytes),
        "dcn_wire_bytes_per_event": int(dcn_event_bytes),
        "dcn_wire_bytes_per_step": fed_dcn_bytes,
        "dcn_period": period,
        "dcn_wire": dcn_wire_tier or "exact",
        "flat_cross_pod_edges": cross,
        "flat_dcn_bytes_per_step": int(flat_dcn_bytes),
        "dcn_cut_ratio": (
            round(flat_dcn_bytes / fed_dcn_bytes, 4)
            if fed_dcn_bytes > 0 else float("inf")
        ),
    }


# -- the active fabric (optimizer dispatch surface) ---------------------------


@dataclasses.dataclass(frozen=True)
class Fabric:
    """The resolved two-level fabric one optimizer dispatches against:
    the layout, the per-leg plans, the DCN period and wire. Built once
    per (env signature, size) and cached — the dispatch gate reads it
    every communicating step."""

    layout: PodLayout
    period: int
    wire: Optional[str]
    intra: object  # CommPlan
    inter: object  # CommPlan
    kind: str = "exp2"

    def dcn_step(self, comm_count: int) -> bool:
        """Whether communicating step ``comm_count`` carries the DCN
        leg (every ``period``-th step, starting at the first)."""
        return int(comm_count) % self.period == 0

    def to_json(self) -> dict:
        try:
            rate = float(
                composed_rate(self.layout, self.period, self.kind)[0]
            )
        except Exception:
            rate = None
        return {
            "layout": self.layout.to_json(),
            "gateways": [
                g for g in self.layout.gateways() if g is not None
            ],
            "dcn_period": self.period,
            "dcn_wire": self.wire or "exact",
            "intra_rounds": len(self.intra.rounds),
            "inter_rounds": len(self.inter.rounds),
            "kind": self.kind,
            "predicted_rate": rate,
        }


_FABRIC_CACHE: Dict[tuple, Fabric] = {}


def _env_signature(size: int) -> tuple:
    return (
        int(size),
        os.environ.get(PODS_ENV, "").strip(),
        os.environ.get(DCN_PERIOD_ENV, "").strip(),
        os.environ.get(DCN_WIRE_ENV, "").strip().lower(),
    )


def get_fabric(size: int, kind: str = "exp2") -> Optional[Fabric]:
    """The active fabric for ``size`` ranks, or None when federation is
    off. Cached on the full env signature, so flipping any knob
    rebuilds (and the optimizer's cache keys change with the plans).

    Under an elastic session with a dead rank the fabric follows the
    session's live set (:meth:`~bluefog_tpu_torch.context.BluefogContext.live_token`):
    the gateways are re-elected among the live ranks
    (:meth:`PodLayout.gateways`) and the intra-pod combine is pruned to
    them and renormalized per receiver
    (:func:`bluefog_tpu_torch.elastic.repair.repaired_matrix`, policy
    ``receiver``; a dead rank keeps its row). Every process derives the
    same fabric from the same live set. With every rank live the fabric
    is the JAX package's; under a dead rank the JAX package's
    ``get_fabric`` keeps the full fabric, and this one equals its pieces
    for the live set (``repaired_matrix`` of the intra-pod matrix,
    ``inter_plan(layout, live)``), as its ``FederatedFleet`` repairs."""
    if not enabled():
        return None
    from bluefog_tpu_torch import context as ctx_mod

    ctx = ctx_mod._context
    token = None if ctx is None or ctx.size != size else ctx.live_token()
    live = None if token is None or len(token[1]) >= size else token[1]
    sig = _env_signature(size) + (kind, live)
    fab = _FABRIC_CACHE.get(sig)
    if fab is None:
        from bluefog_tpu_torch import metrics

        layout = parse_pods(os.environ[PODS_ENV], size)
        if live is None:
            intra = intra_plan(layout, kind)
        else:
            from bluefog_tpu_torch.collective import plan as plan_mod
            from bluefog_tpu_torch.elastic import repair

            w = repair.repaired_matrix(_matrix_from_edges(size, intra_edges(layout, kind)),
                                       live, policy="receiver")
            intra = plan_mod.plan_from_matrix(w)
        fab = Fabric(
            layout=layout,
            period=dcn_period(),
            wire=dcn_wire(),
            intra=intra,
            inter=inter_plan(layout, live),
            kind=kind,
        )
        _FABRIC_CACHE[sig] = fab
        metrics.gauge("bluefog.federation.pods").set(layout.n_pods)
        metrics.gauge("bluefog.federation.dcn_period").set(fab.period)
    return fab


def clear_fabric_cache() -> None:
    _FABRIC_CACHE.clear()


# -- whole-pod elastic semantics (the fleet-scale exercise) -------------------


class FederatedFleet:
    """A federated :class:`~bluefog_tpu_torch.fleetsim.VirtualFleet`: the
    union graph (intra blocks + gateway ring) under the same repair
    algebra, with GATEWAY RE-ELECTION folded into the repair event.

    Whole-pod loss is ONE repair event: the fault plan delivers every
    kill at the same step, detection batches them, and the single
    ``_repair`` pass prunes the pod, re-elects gateways among the
    survivors, rewires the inter-pod ring, and bumps the topology
    version ONCE — the plan cache can never serve a stale gateway."""

    def __init__(self, layout: PodLayout, kind: str = "exp2",
                 policy: str = "receiver", plan=None,
                 audit_edges: bool = True, seed: int = 0):
        from bluefog_tpu_torch import fleetsim

        self.layout = layout
        self.kind = kind
        self._gateways = [g for g in layout.gateways() if g is not None]
        fleet = fleetsim.VirtualFleet(
            layout.size, topology=kind, policy=policy, plan=plan,
            audit_edges=audit_edges, seed=seed,
            edges=federated_union_edges(layout, kind),
        )
        fleet.pod_layout = layout
        # fold gateway re-election into the fleet's repair event: the
        # hook runs inside the timed, single-version-bump repair pass
        fleet.repair_hook = self._on_repair
        self.fleet = fleet

    def _on_repair(self, newly_dead: List[int], step: int) -> dict:
        """Runs inside ``VirtualFleet._repair`` after the prune: re-elect
        gateways over the survivors and rewire the inter-pod ring in
        place (normalizer caches of touched ranks invalidated — the
        same lazy-repair discipline as the prune itself)."""
        topo = self.fleet.topo
        live = [r for r in range(self.layout.size) if topo.live[r]]
        new_gws = [
            g for g in self.layout.gateways(live) if g is not None
        ]
        old_gws = self._gateways
        if new_gws == old_gws:
            return {"gateways": list(old_gws), "gateway_change": False}
        # drop every cross-pod edge of the OLD ring...
        for k in range(len(old_gws)):
            for d in (-1, 1):
                src = old_gws[k]
                dst = old_gws[(k + d) % len(old_gws)]
                if src == dst:
                    continue
                topo.base_out[src].pop(dst, None)
                topo.base_in[dst].pop(src, None)
                topo._touch_neighborhood(src)
                topo._touch_neighborhood(dst)
        # ...and wire the NEW ring between the re-elected gateways
        if len(new_gws) > 1:
            for k in range(len(new_gws)):
                for d in (-1, 1):
                    src = new_gws[k]
                    dst = new_gws[(k + d) % len(new_gws)]
                    if src == dst:
                        continue
                    topo.base_out[src][dst] = 0.5
                    topo.base_in[dst][src] = 0.5
                    topo._touch_neighborhood(src)
                    topo._touch_neighborhood(dst)
        topo._avg = None
        self._gateways = new_gws
        return {"gateways": list(new_gws), "gateway_change": True}

    # thin delegation — the fleet keeps its own clock and records
    def tick(self) -> dict:
        return self.fleet.tick()

    def run(self, steps: int) -> None:
        self.fleet.run(steps)

    def summary(self) -> dict:
        out = self.fleet.summary()
        out["federation"] = {
            "n_pods": self.layout.n_pods,
            "gateways": list(self._gateways),
            "dcn_period": dcn_period() if enabled() else None,
        }
        return out
