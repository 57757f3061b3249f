# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Closed-loop topology controller (``bft.autotune``), the port of the JAX
package's ``bluefog_tpu.autotune``.

The observability tiers *measure* the runtime — per-edge blame
(:mod:`bluefog_tpu_torch.attribution`), measured-vs-promised mixing
(:mod:`bluefog_tpu_torch.health`), the calibrated alpha-beta model
(:mod:`bluefog_tpu_torch.collective.compiler`), delivered parameter age
(:mod:`bluefog_tpu_torch.staleness`) — and none of them *acts*. This
module closes the loop: a host-side controller that, on a sampled
cadence, reads the advisory stream, searches a bounded candidate space of
(topology generator, static-vs-dynamic schedule, wire tier) against a
two-term objective, and migrates the live session through the elastic
repair path, with every decision recorded as a first-class observable.

**Sampling discipline.** One communicating step in every
``BLUEFOG_AUTOTUNE_INTERVAL`` (default 50) is a *sample*; every other
step pays one integer compare. The controller never touches the
dispatched combine: it is host arithmetic, and a migration goes through
``ctx.set_topology`` (or the session's ``adopt_topology``) under a fresh
``topo_version`` exactly like an elastic repair: the next dispatch
re-resolves its plan from the context (the live token in its key, zero
stale dispatches), the optimizer state is untouched, and the CHOCO copies
and the delay buffer, whose signatures hold the plan's rounds and the
tier, start fresh when the structure or the wire changed. Steps with the
controller on and no migration run the same combine on the same plan,
bit for bit, and add no ``ctx.op_cache`` entry. The port holds a topology
as its float64 weight matrix, so a migration installs the candidate's
matrix itself where the JAX package builds a networkx graph from it; the
installed ``mixing_matrix(load_topology())`` is the same array.

**Across processes** the triggers come from the doctor's and the health
plane's advisories, which every process holds alike, and the clock from
the slowest process's step time, so every process scores the same
candidates and swaps, or rolls back, at the same step; before a swap or a
rollback one ``all_gather_object`` of the decision raises
``RuntimeError`` in every process if they differ.

**Triggers.** A sample harvests *new* advisories since the previous
sample: the doctor's ``degraded_link``/``straggler`` (per-edge measured
blame) and the health plane's ``mixing_degraded`` (broken spectral
contract). The blamed edges' slowdown factors — from the advisory's
measured/predicted ratio, corroborated by the elastic ``degrade`` fault's
factors exactly as the doctor's own probes are
(:meth:`bluefog_tpu_torch.attribution.StepDoctor._chaos_delay_s`) — feed
the candidate pricing below.

**Candidate space** (bounded; every candidate is pre-repaired to the
current live set with the active elastic policy, so what is scored IS
what would be installed):

- the incumbent (always scored — the no-move baseline);
- the incumbent minus the blamed edges (repair-engine exclusion);
- generator candidates: ring, ``ExponentialTwoGraph``, 2-D mesh,
  ``RandomRegularDigraph`` at ``BLUEFOG_AUTOTUNE_DEGREES`` degrees (a
  generator that refuses the size, such as Exp2 off a power of two, is
  skipped);
- a dynamic one-peer schedule over the incumbent (period-product rate
  vs one-edge-per-step wire cost — the static-vs-dynamic axis);
- optionally a wire tier per candidate (``BLUEFOG_AUTOTUNE_WIRE``, a
  comma list drawn from ``fp32,bf16,int8,int8_ef,int4,int4_ef``; the
  non-EF quantized tiers carry a consensus floor and are only searched
  when explicitly listed).

**Objective.** Predicted *seconds to consensus*: per-step wire cost
(minimal round count x ``round_cost_s`` at the measured payload, plus the
chaos-calibrated penalty for every blamed edge the candidate still
carries) x predicted steps-to-epsilon from the candidate's
``consensus_decay_rate`` on the *degrade-discounted* matrix. Lower is
better; a disconnected candidate prices at infinity. The cost is the
``ici`` link class's, as in the JAX package: on one card every round is a
gather, so the predicted gain is a model's, reported and not timed.

**Guardrails.** Hysteresis (``TRIGGER_STREAK`` consecutive samples),
minimum gain (``MIN_GAIN_FRAC``), cooldown (``BLUEFOG_AUTOTUNE_COOLDOWN``
samples, floored at the advisory re-fire window), verification with
rollback (delivered step time against the pre-swap EWMA+MAD band, and
delivered mixing efficiency; a regression past ``ROLLBACK_FRAC``
re-installs the previous topology under another fresh version and
blocklists the candidate), and dry run (``BLUEFOG_AUTOTUNE_DRY_RUN=1``:
score and record, never migrate). Window optimizers (``mode`` in
``put``/``get``/``push_sum``) are scored but never migrated.

**Audit trail.** Every decision (swap / hold / rollback / dry-run) is a
:class:`DecisionRecord` emitted to the ``bluefog.autotune.*`` metrics, the
flight ring and its side table (:func:`bluefog_tpu_torch.flight.note_decision`),
a timeline instant, ``BLUEFOG_AUTOTUNE_FILE`` JSONL, and the health
plane's ``/fleet`` report (``autotune`` block); ``tools/autotune_report.py``
and ``tools/doctor.py --autotune`` read the dump and the JSONL.

Env knobs: ``BLUEFOG_AUTOTUNE=1`` enables (default off),
``BLUEFOG_AUTOTUNE_INTERVAL`` (sampling period, default 50),
``BLUEFOG_AUTOTUNE_DRY_RUN`` (score + record, never migrate),
``BLUEFOG_AUTOTUNE_COOLDOWN`` (samples between migrations, default 8),
``BLUEFOG_AUTOTUNE_FILE`` (JSONL decisions + verifications),
``BLUEFOG_AUTOTUNE_WIRE`` (wire tiers to search, default off),
``BLUEFOG_AUTOTUNE_DEGREES`` (random-regular degrees, default ``2,3``).
"""

import collections
import dataclasses
import math
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DecisionRecord",
    "TopologyAutotuner",
    "enabled",
    "autotune_interval",
    "dry_run_enabled",
    "cooldown_samples",
    "wire_tiers",
    "candidate_degrees",
    "degraded_matrix",
    "score_candidate",
    "start",
    "stop",
    "activate",
    "active",
    "observe_step",
    "dump",
    "on_init",
    "on_shutdown",
]

ENABLE_ENV = "BLUEFOG_AUTOTUNE"
INTERVAL_ENV = "BLUEFOG_AUTOTUNE_INTERVAL"
FILE_ENV = "BLUEFOG_AUTOTUNE_FILE"
DRY_RUN_ENV = "BLUEFOG_AUTOTUNE_DRY_RUN"
COOLDOWN_ENV = "BLUEFOG_AUTOTUNE_COOLDOWN"
WIRE_ENV = "BLUEFOG_AUTOTUNE_WIRE"
DEGREES_ENV = "BLUEFOG_AUTOTUNE_DEGREES"

# Hysteresis: triggers must persist across this many samples before
# the controller even searches — one advisory on a noisy fabric is
# jitter, not a regime change (the mixing_degraded streak discipline
# applied to the actuator). The streak tolerates short quiet gaps
# (advisory emitters run on their own sampling cadence, typically
# coarser than the controller's) and resets only after
# TRIGGER_QUIET_RESET trigger-free samples. A ``mixing_degraded``
# trigger latches the full streak at once: its emitter already applied
# an EWMA+MAD streak gate, and stacking a second streak on top would
# mute the controller exactly on the advisory designed to drive it.
TRIGGER_STREAK = 2
TRIGGER_QUIET_RESET = 2
# Migration floor: the winning candidate must beat the incumbent's
# predicted objective by this fraction, or the decision is a hold — a
# sub-threshold "win" inside the cost model's own error bars would
# thrash topologies for nothing.
MIN_GAIN_FRAC = 0.05
# Cooldown default, in controller samples, between migrations. MUST be
# >= the advisory re-fire window (the health plane re-fires a
# persistent mixing_degraded every FIT_WINDOW = 8 samples): a shorter
# cooldown would let one persistent condition drive a swap per re-fire.
COOLDOWN_SAMPLES = 8
# Post-swap verification: delivered step time beyond the pre-swap
# EWMA baseline by max(3 MAD, this fraction) — or delivered mixing
# efficiency below the pre-swap one by this fraction — is a regression:
# roll back.
ROLLBACK_FRAC = 0.10
# Samples of post-swap measurement folded into the verification
# verdict before it is issued.
VERIFY_SAMPLES = 2
# Consensus contraction target for the steps-to-epsilon term of the
# objective (a RATIO, not an absolute distance — candidates are
# compared on how fast they contract, wherever the iterate sits today).
EPS_RATIO = 1e-6
# One-peer schedule periods larger than this are scored on a truncated
# period (bounded host cost per sample).
MAX_SCHEDULE_PERIOD = 8

# Wire tiers the controller may search when BLUEFOG_AUTOTUNE_WIRE asks
# for tiers. The plain quantized tiers (int8/int4) carry a consensus
# floor (the memoryless quantizer stalls where its EF twin converges), so
# they are valid only when the user lists them explicitly.
_DEFAULT_SAFE_TIERS = ("fp32", "bf16", "int8_ef", "int4_ef")
_ALL_TIERS = ("fp32", "bf16", "int8", "int8_ef", "int4", "int4_ef")


def enabled() -> bool:
    """Controller switch: ``BLUEFOG_AUTOTUNE=1`` (default off). Like
    every other observability tier the controller is opt-in — and being
    an *actuator*, it stays off unless asked twice as deliberately as a
    recorder would."""
    return os.environ.get(ENABLE_ENV, "0").lower() in (
        "1", "true", "on", "yes",
    )


def autotune_interval() -> int:
    """Sampling period in communicating steps
    (``BLUEFOG_AUTOTUNE_INTERVAL``, default 50). A sample is host
    arithmetic only (advisory harvest + at most one bounded candidate
    search); the default keeps the amortized cost well under the 1 %
    acceptance bound."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int(INTERVAL_ENV, 50))


def dry_run_enabled() -> bool:
    """``BLUEFOG_AUTOTUNE_DRY_RUN=1``: score and record full decision
    history, never migrate (the audit-before-trust deployment mode)."""
    return os.environ.get(DRY_RUN_ENV, "0").lower() in (
        "1", "true", "on", "yes",
    )


def cooldown_samples() -> int:
    """Samples between migrations (``BLUEFOG_AUTOTUNE_COOLDOWN``,
    default :data:`COOLDOWN_SAMPLES`); the env knob is FLOORED at the
    advisory re-fire window (:data:`COOLDOWN_SAMPLES` — the health
    plane re-fires a persistent ``mixing_degraded``, which latches a
    full streak, every fit window) so an operator cannot accidentally
    configure swap-per-re-fire topology thrash. Tests and benches that
    need a faster clock pass ``cooldown=`` to the constructor, which
    is deliberately not floored."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(COOLDOWN_SAMPLES,
               env_int(COOLDOWN_ENV, COOLDOWN_SAMPLES))


def wire_tiers() -> Tuple[str, ...]:
    """Wire tiers the candidate search crosses with each topology
    (``BLUEFOG_AUTOTUNE_WIRE``, comma list; empty/unset = the wire is
    not searched and the active tier is kept). Unknown names are
    dropped; the plain int8/int4 tiers participate only when named
    explicitly (they trade a consensus floor for bytes — a trade the
    controller must not make silently)."""
    raw = os.environ.get(WIRE_ENV, "")
    if not raw.strip():
        return ()
    out = []
    for t in raw.split(","):
        t = t.strip().lower()
        if t in _ALL_TIERS and t not in out:
            out.append(t)
    return tuple(out)


def candidate_degrees() -> Tuple[int, ...]:
    """Degrees for the ``RandomRegularDigraph`` candidates
    (``BLUEFOG_AUTOTUNE_DEGREES``, default ``2,3``)."""
    raw = os.environ.get(DEGREES_ENV, "2,3")
    out = []
    for t in raw.split(","):
        try:
            d = int(t)
        except ValueError:
            continue
        if d >= 1 and d not in out:
            out.append(d)
    return tuple(out) or (2, 3)


# -- pure scoring core (unit-testable without a context) -----------------------


def degraded_matrix(w: np.ndarray,
                    factors: Dict[Tuple[int, int], float]) -> np.ndarray:
    """Discount a combine matrix by measured per-edge delivery factors:
    edge ``(s, d)`` at factor ``f`` delivers only ``f`` of its weight,
    and the receiver keeps its own value for the dropped fraction —
    the lossy-link model the health plane's chaos evidence replays.
    The result is what the degraded fabric *actually* mixes with, so
    its :func:`~bluefog_tpu_torch.topology.consensus_decay_rate` prices a
    candidate that still carries a blamed edge honestly."""
    w = np.asarray(w, np.float64).copy()
    for (s, d), f in factors.items():
        s, d = int(s), int(d)
        if s == d or not (0 <= s < w.shape[0] and 0 <= d < w.shape[0]):
            continue
        f = min(max(float(f), 0.0), 1.0)
        lost = (1.0 - f) * w[s, d]
        if lost > 0.0:
            w[s, d] -= lost
            w[d, d] += lost
    return w


def _edges_of(w: np.ndarray) -> List[Tuple[int, int]]:
    return [
        (int(i), int(j)) for i, j in zip(*np.nonzero(w)) if i != j
    ]


def score_candidate(
    cand: dict,
    payload_bytes: float,
    factors: Dict[Tuple[int, int], float],
) -> dict:
    """Score one candidate against the two-term objective. ``cand``
    carries ``name`` plus either ``matrix`` (static) or ``mats`` (one
    period of a dynamic schedule) and optionally ``wire``. Returns the
    decision-record entry: predicted per-step decay rate on the
    degrade-discounted matrix, steps to the ``EPS_RATIO`` contraction,
    per-step wire cost from the calibrated alpha-beta model (with the
    chaos-calibrated penalty for every blamed edge the candidate still
    crosses), and their product — predicted seconds to consensus."""
    from bluefog_tpu_torch import scaling
    from bluefog_tpu_torch import topology as topo_mod
    from bluefog_tpu_torch.collective import compiler

    wire = cand.get("wire")
    n_elems = max(1, int(payload_bytes // 4))
    tier = None if wire in (None, "fp32") else wire
    wire_bytes = float(scaling.wire_payload_bytes(n_elems, 4, wire=tier))

    # spectral scoring runs on the LIVE submatrix: a dead rank is
    # isolated (self weight 1) by the repair, which adds a second
    # Perron root to the full matrix and would misread every candidate
    # as "no contraction promised"
    live = cand.get("live")
    ix = (
        np.ix_(list(live), list(live))
        if live is not None and len(live) else None
    )

    mats = cand.get("mats")
    if mats is not None:
        size = mats[0].shape[0]
        use = (
            [degraded_matrix(m, factors) for m in mats]
            if factors else mats
        )
        if ix is not None:
            use = [np.asarray(m, np.float64)[ix] for m in use]
        rate, spec = topo_mod.consensus_decay_rate_info(use)
        # per-step wire cost of the schedule: mean over the period of
        # each step's minimal round count
        rounds = float(np.mean([
            max(compiler.min_rounds(_edges_of(m), size), 0)
            for m in mats
        ]))
        # a blamed edge used k times per period pays its penalty on
        # those steps only
        penalty = 0.0
        for (s, d), f in factors.items():
            uses = sum(1 for m in mats if m[s, d] != 0.0)
            penalty += (uses / len(mats)) * \
                compiler.degraded_round_penalty_s(wire_bytes, f)
    else:
        w = np.asarray(cand["matrix"], np.float64)
        size = w.shape[0]
        edges = _edges_of(w)
        rounds = float(max(compiler.min_rounds(edges, size), 0))
        penalty = sum(
            compiler.degraded_round_penalty_s(wire_bytes, f)
            for (s, d), f in factors.items() if w[s, d] != 0.0
        )
        use = degraded_matrix(w, factors) if factors else w
        rate, spec = topo_mod.consensus_decay_rate_info(
            use[ix] if ix is not None else use
        )

    step_cost_s = rounds * compiler.round_cost_s(wire_bytes) + penalty
    if 0.0 < rate < 1.0 - 1e-12:
        tts_steps = math.log(EPS_RATIO) / math.log(rate)
        objective_s = step_cost_s * tts_steps
    else:
        tts_steps = None
        objective_s = None  # no contraction promised: never chosen
    out = {
        "name": cand["name"],
        "kind": "schedule" if mats is not None else "static",
        "rate": round(float(rate), 6),
        "tts_steps": (
            round(tts_steps, 1) if tts_steps is not None else None
        ),
        "rounds": round(rounds, 2),
        "step_cost_ms": round(step_cost_s * 1e3, 6),
        "objective_s": (
            round(objective_s, 6) if objective_s is not None else None
        ),
        "eligible": bool(cand.get("eligible", True)),
        # how the rate was obtained: dense oracle below
        # BLUEFOG_SPECTRAL_DENSE_MAX, deflated Arnoldi over edge lists
        # above — with the convergence residual the decision record
        # discloses at fleet scale
        "spectral": {
            "engine": spec.get("engine"),
            "matvecs": spec.get("matvecs", 0),
            "residual": spec.get("residual", 0.0),
            "converged": spec.get("converged", True),
        },
    }
    if wire is not None:
        out["wire"] = wire
        out["wire_bytes"] = int(wire_bytes)
    if mats is not None:
        out["period"] = len(mats)
    return out


def _better(a: Optional[float], b: Optional[float],
            margin: float = 0.0) -> bool:
    """True when objective ``a`` beats ``b`` by at least ``margin``
    (fraction of b). None = no contraction = never better / always
    beatable."""
    if a is None:
        return False
    if b is None:
        return True
    return a < b * (1.0 - margin)


# -- the decision record -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One controller decision — the first-class observable. ``detail``
    fields are all JSON-serializable: the record rides verbatim into
    the flight side table, the JSONL export, and
    ``tools/autotune_report.py``."""

    seq: int
    step: int
    comm_steps: int
    action: str  # "swap" | "hold" | "rollback" | "dry_run_swap"
    triggers: List[dict]
    blamed: List[list]
    candidates: List[dict]
    chosen: Optional[str]
    predicted: Dict[str, Any]
    hysteresis: Dict[str, Any]
    topo_version_before: int
    topo_version_after: int
    dry_run: bool
    # whether an asynchronous gossip engine (bft.make_async_train_step)
    # was live when the decision was taken: the audit trail must
    # distinguish choices scored for a synchronous combine from ones
    # made while the async push-sum lane owned the wire
    async_mode: bool = False
    # whether the memory observatory had an un-cooled-down
    # memory_pressure advisory on record when the decision was taken:
    # a topology choice made on a device near OOM reads differently in a
    # postmortem than one made with headroom to spare
    memory_pressure: bool = False
    # which leg of the gossip fabric this decision searched: "flat" for
    # the single-level default, "ici" / "dcn" when bft.federation splits
    # the search per level (the intra-pod and gateway legs have
    # different candidate pools AND different cost models, so their
    # decisions must be attributable separately in the audit trail)
    level: str = "flat"
    # the worst fast-window SLO burn rate (bluefog_tpu_torch.slo) at
    # decision time: the controller's audit trail must show whether a
    # swap was chosen while the fleet was actively burning its error
    # budget — a topology gamble under budget pressure reads
    # differently in a postmortem than the same gamble while green
    slo_burn: float = 0.0

    def to_json(self) -> dict:
        return {
            "kind": "decision",
            "seq": self.seq,
            "step": self.step,
            "comm_steps": self.comm_steps,
            "action": self.action,
            "triggers": self.triggers,
            "blamed": self.blamed,
            "candidates": self.candidates,
            "chosen": self.chosen,
            "predicted": self.predicted,
            "hysteresis": self.hysteresis,
            "topo_version_before": self.topo_version_before,
            "topo_version_after": self.topo_version_after,
            "dry_run": self.dry_run,
            "async_mode": self.async_mode,
            "memory_pressure": self.memory_pressure,
            "level": self.level,
            "slo_burn": self.slo_burn,
        }


def _async_mode() -> bool:
    """True when an asynchronous gossip engine is live in this process
    (decision records carry it; import deferred to avoid a cycle)."""
    try:
        from bluefog_tpu_torch import async_gossip

        return async_gossip.active() is not None
    except Exception:
        return False


def _slo_burn() -> float:
    """Worst fast-window SLO burn rate at decision time (0.0 when the
    SLO engine is off) — decision records carry it so the audit trail
    shows which choices were made under budget pressure."""
    try:
        from bluefog_tpu_torch import slo as slo_mod

        return float(slo_mod.worst_burn())
    except Exception:
        return 0.0


def _memory_pressure() -> bool:
    """True when the memory observatory has an un-cooled-down
    ``memory_pressure`` advisory — i.e. one inside its re-fire window
    right now, not merely somewhere in history (decision records
    carry it — the audit trail must show which choices were made on a
    device near OOM, and a pressure episode resolved hours ago must not
    taint every later record)."""
    try:
        from bluefog_tpu_torch import memory as mem_mod

        obs = mem_mod.active()
        return obs is not None and obs.pressure_active()
    except Exception:
        return False


def _search_level(ctx) -> str:
    """Which gossip-fabric level this controller's candidate search
    covers: ``"flat"`` for the single-level default, ``"ici"`` when
    :mod:`bluefog_tpu_torch.federation` is active — the controller's
    candidate pool (ring/exp2/mesh generators over the full rank set)
    maps onto the intra-pod leg; the gateway leg is period-scheduled
    by ``federation.choose_dcn_period`` against a consensus-rate
    target, not swap-searched, so its decisions never appear under
    this record stream."""
    try:
        from bluefog_tpu_torch import federation

        if federation.enabled() and (
            federation.get_fabric(ctx.size) is not None
        ):
            return "ici"
    except Exception:
        pass
    return "flat"


# -- the controller ------------------------------------------------------------


class TopologyAutotuner:
    """One controller session. Built by :func:`start` (or implicitly by
    ``bft.init()`` under ``BLUEFOG_AUTOTUNE=1``); fed by the optimizer
    layer through :func:`observe_step` on every communicating step, or
    directly (``tuner.observe(ctx, step=..., step_s=...,
    triggers=...)``) by an eager loop or the chaos tests — the explicit
    arguments exist so every guardrail is drivable on the deterministic
    fault-plan step clock."""

    def __init__(self, interval: Optional[int] = None,
                 dry_run: Optional[bool] = None,
                 cooldown: Optional[int] = None,
                 history: int = 256):
        from bluefog_tpu_torch import attribution

        self.interval = (
            int(interval) if interval else autotune_interval()
        )
        self.dry_run = (
            bool(dry_run) if dry_run is not None else dry_run_enabled()
        )
        self.cooldown = (
            int(cooldown) if cooldown else cooldown_samples()
        )
        self._count = 0
        self.decisions: List[DecisionRecord] = []
        self.verifications: List[dict] = []
        self.samples: collections.deque = collections.deque(
            maxlen=history
        )
        self._streak = 0
        self._quiet = 0
        self._cooldown_left = 0
        # triggers accumulated since the streak opened: the decision
        # record names EVERY advisory that contributed to the window,
        # not just the ones harvested at the deciding sample (an
        # audit that dropped the first advisory of a two-sample streak
        # would misname what drove the swap)
        self._window_triggers: List[dict] = []
        # advisory high-water marks: a sample harvests only NEW
        # advisories — re-reading the whole history would turn one old
        # diagnosis into a permanent trigger
        self._seen_doctor = 0
        self._seen_health = 0
        self._step_tracker = attribution.BaselineTracker()
        self._last_sample_wall: Optional[float] = None
        self._last_sample_count = 0
        self._last_wire_bytes: Optional[float] = None
        self._payload_estimate: Optional[float] = None
        # post-swap verification state: decision seq, the pre-swap
        # baseline (step EWMA + MAD band, mixing efficiency), the
        # rollback target, and the delivered samples collected so far
        self._pending: Optional[dict] = None
        # candidates that regressed on delivery, blocked from
        # re-selection for a decaying window — without this a
        # persistent trigger re-chooses the exact candidate that just
        # rolled back, forever (swap -> regress -> rollback -> swap)
        self._blocked: Dict[str, int] = {}
        # rollback target for the LAST migration (matrix + optimizer
        # schedule/wire as they stood before)
        self._prev: Optional[dict] = None
        self.swaps = 0
        self.rollbacks = 0
        self.holds = 0
        self.last_action = "none"

    # -- signal harvest --------------------------------------------------------

    def _harvest_triggers(self) -> List[dict]:
        """NEW advisories since the last sample, shaped into trigger
        entries. The controller is advisory-driven: the chaos layer's
        degrade faults feed the *pricing* (like the doctor's probe
        simulation) but never the trigger set — detection must come
        from the telemetry stack."""
        out: List[dict] = []
        try:
            from bluefog_tpu_torch import attribution

            doc = attribution.active()
        except Exception:
            doc = None
        if doc is not None:
            for adv in doc.advisories[self._seen_doctor:]:
                if adv.kind in ("degraded_link", "straggler"):
                    entry = {"kind": adv.kind, "source": "doctor",
                             "step": adv.step}
                    if "edge" in adv.detail:
                        entry["edge"] = adv.detail["edge"]
                        if adv.detail.get("ratio"):
                            entry["ratio"] = adv.detail["ratio"]
                    if "rank" in adv.detail:
                        entry["rank"] = adv.detail["rank"]
                    out.append(entry)
            self._seen_doctor = len(doc.advisories)
        try:
            from bluefog_tpu_torch import health as health_mod

            plane = health_mod.active()
        except Exception:
            plane = None
        if plane is not None:
            for adv in plane.advisories[self._seen_health:]:
                if adv.kind == "mixing_degraded":
                    out.append({
                        "kind": adv.kind, "source": "health",
                        "step": adv.step,
                        "suspect_edges": adv.detail.get(
                            "suspect_edges", []
                        ),
                    })
            self._seen_health = len(plane.advisories)
        return out

    def _blame_factors(self, triggers: Sequence[dict],
                       size: int) -> Dict[Tuple[int, int], float]:
        """Measured per-edge slowdown/delivery factors for pricing:
        the advisory's measured/predicted ratio (factor = 1/ratio),
        corroborated by the chaos layer's deterministic degrade factors
        — the same simulation parity the doctor's probes use, so
        tier-1 candidate pricing is reproducible."""
        factors: Dict[Tuple[int, int], float] = {}
        for t in triggers:
            edge = t.get("edge")
            if edge is not None:
                f = 1.0 / float(t["ratio"]) if t.get("ratio") else 0.5
                key = (int(edge[0]), int(edge[1]))
                factors[key] = min(factors.get(key, 1.0), f)
            for e in t.get("suspect_edges", []) or []:
                if isinstance(e, (list, tuple)) and len(e) == 2:
                    key = (int(e[0]), int(e[1]))
                    factors.setdefault(key, 0.5)
        try:
            from bluefog_tpu_torch import elastic as elastic_mod

            session = elastic_mod.active_session()
        except Exception:
            session = None
        if session is not None:
            for key, f in session.simulated_wire_factors().items():
                if isinstance(key, tuple):
                    factors[key] = min(factors.get(key, 1.0), float(f))
                else:  # rank-wide: every edge touching the rank
                    r = int(key)
                    for other in range(size):
                        if other == r:
                            continue
                        for e in ((r, other), (other, r)):
                            if e in factors:
                                factors[e] = min(factors[e], float(f))
        return factors

    def _payload_bytes(self, steps: int) -> float:
        """Per-round wire payload estimate from the metrics wire-byte
        counter (bytes since last sample / ``steps`` / rounds); the
        compiler's class default when the counter is dark. Every
        candidate shares the estimate, so only the alpha-beta crossover
        depends on its accuracy. ``steps`` is the caller's
        steps-since-last-sample count — measured BEFORE
        :meth:`_measure_step_s` resets the sample clock."""
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch.collective import compiler

        c = metrics_mod.peek("bluefog.wire_bytes")
        cur = float(c.value) if c is not None else None
        if cur is not None and self._last_wire_bytes is not None \
                and steps > 0 and cur > self._last_wire_bytes:
            g = metrics_mod.peek("bluefog.gossip.rounds")
            rounds = max(float(g.value) if g is not None else 1.0, 1.0)
            self._payload_estimate = (
                (cur - self._last_wire_bytes) / steps / rounds
            )
        if cur is not None:
            self._last_wire_bytes = cur
        if self._payload_estimate:
            return self._payload_estimate
        return float(compiler.DEFAULT_PAYLOAD_BYTES)

    def _mixing_efficiency(self) -> Optional[float]:
        try:
            from bluefog_tpu_torch import health as health_mod

            plane = health_mod.active()
            if plane is None:
                return None
            for s in reversed(plane.samples):
                eff = s.get("mixing_efficiency")
                if eff is not None:
                    return float(eff)
        except Exception:
            pass
        return None

    @staticmethod
    def _stale_age_mean() -> Optional[float]:
        """Mean delivered parameter age from the staleness observatory
        (None when it is off). Age applies to every candidate equally
        under the active execution mode, so it rides the decision
        record as context — the auditable 'this fleet was mixing
        1-step-stale data when the controller acted' — rather than
        reweighting the candidate comparison."""
        try:
            from bluefog_tpu_torch import staleness as stal_mod

            obs = stal_mod.active()
            age = obs.last_age_mean() if obs is not None else None
            return float(age) if age else None
        except Exception:
            return None

    # -- candidate space -------------------------------------------------------

    def _live_and_policy(self, ctx, optimizer):
        try:
            from bluefog_tpu_torch import elastic as elastic_mod

            session = elastic_mod.active_session()
        except Exception:
            session = None
        if session is not None:
            live = list(session.membership.live_ranks())
            policy = session._policy_for(optimizer)
        else:
            live = list(range(ctx.size))
            policy = "average"
        return live, policy, session

    def _candidates(self, ctx, optimizer,
                    factors: Dict[Tuple[int, int], float]) -> List[dict]:
        """The bounded search space, every static entry already
        repaired to the live set under the active elastic policy —
        scoring and installation see the same matrix (the repair is
        idempotent: Metropolis–Hastings weights depend only on the
        surviving adjacency)."""
        from bluefog_tpu_torch import topology as topo_mod
        from bluefog_tpu_torch.elastic import repair as repair_mod

        live, policy, session = self._live_and_policy(ctx, optimizer)
        size = ctx.size
        window_mode = getattr(optimizer, "mode", None) in (
            "push_sum", "put", "get",
        )
        # window families carry create-time buffer structure: the
        # controller records for them but never migrates (dry-scored)
        can_migrate = not window_mode

        def repaired(w):
            return repair_mod.repaired_matrix(
                w, live,
                policy=policy if policy in repair_mod.POLICIES
                else "average",
            )

        cands: List[dict] = []
        cur_topo = ctx.load_topology()
        cur_w = topo_mod.mixing_matrix(cur_topo)
        sched = getattr(optimizer, "schedule", None)
        if sched is not None:
            cands.append({
                "name": "current", "mats": [
                    p.weight_matrix() for p in sched.plans
                ][:MAX_SCHEDULE_PERIOD],
                "eligible": True, "live": live,
            })
        else:
            cands.append({
                "name": "current", "matrix": cur_w,
                "eligible": True, "live": live,
            })

        if factors:
            masked = cur_w.copy()
            for (s, d) in factors:
                masked[s, d] = 0.0
                masked[d, s] = 0.0
            cands.append({
                "name": "current_minus_blamed",
                "matrix": repaired(masked),
                "eligible": can_migrate, "live": live,
            })

        gens = [("ring", lambda n: topo_mod.RingGraph(n))]
        if size >= 2:
            gens.append(
                ("exp2", lambda n: topo_mod.ExponentialTwoGraph(n))
            )
            gens.append(
                ("mesh", lambda n: topo_mod.MeshGrid2DGraph(n))
            )
        for d in candidate_degrees():
            if d < len(live):
                gens.append((
                    f"rrd{d}",
                    lambda n, d=d: topo_mod.RandomRegularDigraph(n, d),
                ))
        for name, gen in gens:
            try:
                g = gen(size)
            except (AssertionError, ValueError, ZeroDivisionError):
                continue  # generator invalid at this size (e.g. exp2
                # off a power of two): not a candidate
            cands.append({
                "name": name,
                "matrix": repaired(topo_mod.mixing_matrix(g)),
                "eligible": can_migrate, "live": live,
            })

        # dynamic one-peer over the incumbent: the static-vs-dynamic
        # axis (requires an optimizer to install a schedule on)
        try:
            mats = topo_mod.one_peer_period_matrices(cur_topo)
            if len(mats) > MAX_SCHEDULE_PERIOD:
                mats = mats[:MAX_SCHEDULE_PERIOD]
            cands.append({
                "name": "one_peer(current)", "mats": mats,
                "eligible": bool(
                    can_migrate and optimizer is not None
                    and hasattr(optimizer, "schedule")
                ),
                "live": live,
            })
        except Exception:
            pass

        tiers = wire_tiers()
        if tiers:
            crossed: List[dict] = []
            wire_ok = optimizer is not None and hasattr(
                optimizer, "compression"
            )
            for c in cands:
                for t in tiers:
                    cc = dict(c)
                    cc["name"] = f"{c['name']}|{t}"
                    cc["wire"] = t
                    cc["eligible"] = bool(c["eligible"] and wire_ok)
                    crossed.append(cc)
            cands = cands + crossed
        return cands

    # -- migration -------------------------------------------------------------

    def _snapshot_state(self, ctx, optimizer) -> dict:
        from bluefog_tpu_torch import topology as topo_mod

        return {
            "matrix": topo_mod.mixing_matrix(ctx.load_topology()),
            "schedule": getattr(optimizer, "schedule", None),
            "wire": getattr(optimizer, "compression", None),
            "topo_version": int(ctx.topo_version),
        }

    def _migrate(self, ctx, optimizer, cand: dict) -> None:
        """Install the winning candidate through the elastic repair
        path: the new matrix arrives under a fresh ``topo_version``, so
        the next dispatch re-resolves its plan exactly as after an
        elastic repair — optimizer state untouched, CHOCO/delay buffers
        fresh on a structure or wire change, zero stale dispatch."""
        from bluefog_tpu_torch.elastic import recovery as recovery_mod

        _live, _policy, session = self._live_and_policy(ctx, optimizer)
        mats = cand.get("mats")
        if mats is not None:
            from bluefog_tpu_torch.collective.plan import (
                SchedulePlan, plan_from_matrix,
            )

            optimizer.schedule = SchedulePlan(plans=tuple(
                plan_from_matrix(m) for m in mats
            ))
        else:
            if optimizer is not None and \
                    getattr(optimizer, "schedule", None) is not None:
                optimizer.schedule = None
            topo = np.asarray(cand["matrix"], np.float64)
            if session is not None:
                session.adopt_topology(topo, optimizer)
            else:
                ctx.set_topology(topo, is_weighted=True)
                recovery_mod.rebind(optimizer)
        wire = cand.get("wire")
        if wire is not None and optimizer is not None and \
                hasattr(optimizer, "compression"):
            optimizer.compression = None if wire == "fp32" else wire

    def _restore(self, ctx, optimizer, prev: dict) -> None:
        """Roll the migration back: reinstall the pre-swap matrix /
        schedule / wire under another fresh version (the rollback is a
        migration too, and audits like one)."""
        from bluefog_tpu_torch.elastic import recovery as recovery_mod

        _live, _policy, session = self._live_and_policy(ctx, optimizer)
        if optimizer is not None and hasattr(optimizer, "schedule"):
            optimizer.schedule = prev.get("schedule")
        topo = np.asarray(prev["matrix"], np.float64)
        if session is not None:
            session.adopt_topology(topo, optimizer)
        else:
            ctx.set_topology(topo, is_weighted=True)
            recovery_mod.rebind(optimizer)
        if optimizer is not None and hasattr(optimizer, "compression"):
            optimizer.compression = prev.get("wire")

    # -- observation -----------------------------------------------------------

    def observe(self, ctx, *, step: int, optimizer=None, plan=None,
                step_s: Optional[float] = None,
                triggers: Optional[Sequence[dict]] = None
                ) -> Optional[DecisionRecord]:
        """Called once per communicating step. Unsampled steps cost one
        compare + one increment; a sampled step harvests signals, runs
        verification of a pending swap, and — when the hysteresis gate
        opens — searches and (outside dry-run) migrates. ``step_s`` and
        ``triggers`` may be fed explicitly (bench simulation, chaos
        tests); they default to the controller's own wall clock and the
        live advisory streams."""
        sampled = self._count % self.interval == 0
        self._count += 1
        if not sampled:
            return None
        return self._sample(ctx, step=step, optimizer=optimizer,
                            plan=plan, step_s=step_s,
                            triggers=triggers)

    def _measure_step_s(self, explicit: Optional[float], ctx=None
                        ) -> Optional[float]:
        """The step time since the last sample (``explicit`` when given);
        across processes the slowest process's, the same in every one
        (:func:`~bluefog_tpu_torch.collective.transport.fleet_max`), so the
        controller's clock and its rollback verdicts agree."""
        from bluefog_tpu_torch.collective import transport

        t_now = time.perf_counter()
        steps = self._count - self._last_sample_count
        measured = None
        if explicit is not None:
            measured = float(explicit)
        elif self._last_sample_wall is not None and steps > 0:
            measured = (t_now - self._last_sample_wall) / steps
        self._last_sample_wall = t_now
        self._last_sample_count = self._count
        return transport.fleet_max([measured], ctx)[0]

    @staticmethod
    def _agree_decision(ctx, action: str, seq: int, step: int,
                        chosen: Optional[str], blamed) -> None:
        """Across processes: raise ``RuntimeError`` in every process
        before a migration whose decision differs between them (the next
        dispatch's elastic agreement would only catch it a step later)."""
        if ctx is None or ctx.process_count == 1:
            return
        from bluefog_tpu_torch.collective import transport

        transport.agree((action, seq, int(step), chosen, [list(e) for e in blamed],
                         int(ctx.topo_version)), "autotune decision")

    def _sample(self, ctx, *, step, optimizer, plan, step_s,
                triggers) -> Optional[DecisionRecord]:
        from bluefog_tpu_torch import metrics as metrics_mod

        steps_elapsed = self._count - self._last_sample_count
        measured_s = self._measure_step_s(step_s, ctx)
        tr = self._step_tracker
        if measured_s is not None:
            tr.update(measured_s)

        found = list(triggers) if triggers is not None else \
            self._harvest_triggers()
        payload = self._payload_bytes(steps_elapsed)
        eff = self._mixing_efficiency()

        sample = {
            "kind": "sample", "step": int(step),
            "comm_steps": self._count,
            "topo_version": int(ctx.topo_version),
            "triggers": len(found),
        }
        if measured_s is not None:
            sample["step_ms"] = round(measured_s * 1e3, 4)
        if eff is not None:
            sample["mixing_efficiency"] = eff
        self.samples.append(sample)
        metrics_mod.counter("bluefog.autotune.samples").inc()

        # -- hysteresis bookkeeping ---------------------------------------
        # runs BEFORE the verification gate: advisories harvested while
        # a swap is under verification must still accumulate into the
        # streak window (the harvest above already advanced the
        # high-water marks — dropping them here would delay the
        # controller's next reaction until the emitter's re-fire)
        if found:
            self._streak += 1
            self._quiet = 0
            for t in found:
                if t not in self._window_triggers:
                    self._window_triggers.append(t)
            del self._window_triggers[:-32]
            if any(
                t.get("kind") == "mixing_degraded" for t in found
            ):
                # already streak-gated at its emitter: latch in full
                self._streak = max(self._streak, TRIGGER_STREAK)
        else:
            self._quiet += 1
            if self._quiet >= TRIGGER_QUIET_RESET:
                self._streak = 0
                self._window_triggers = []
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        for name in list(self._blocked):
            self._blocked[name] -= 1
            if self._blocked[name] <= 0:
                del self._blocked[name]

        # -- verification of a pending migration -------------------------
        if self._pending is not None:
            self._verify(ctx, optimizer, step, measured_s, eff)
            if self._pending is not None:
                # still collecting delivered samples: the search gate
                # stays closed while a move is under verification
                return None

        if self._streak < TRIGGER_STREAK or self._cooldown_left > 0:
            return None
        self._streak = 0
        self._quiet = 0
        found = list(self._window_triggers) or list(found)
        self._window_triggers = []

        # -- search -------------------------------------------------------
        factors = self._blame_factors(found, ctx.size)
        cands = self._candidates(ctx, optimizer, factors)
        scored = [score_candidate(c, payload, factors) for c in cands]
        by_name = {c["name"]: c for c in cands}
        incumbent = next(
            s for s in scored if s["name"] == "current"
        )
        best = incumbent
        for s in scored:
            if not s["eligible"] or s is incumbent or \
                    s["name"] in self._blocked:
                continue
            if _better(s["objective_s"], best["objective_s"],
                       MIN_GAIN_FRAC if best is incumbent else 0.0):
                best = s

        v_before = int(ctx.topo_version)
        predicted: Dict[str, Any] = {
            "objective_before_s": incumbent["objective_s"],
            "payload_bytes": int(payload),
        }
        if eff is not None:
            predicted["mixing_efficiency_before"] = eff
        age = self._stale_age_mean()
        if age is not None:
            predicted["stale_age_mean"] = round(age, 4)
        if best is not incumbent:
            predicted.update({
                "objective_after_s": best["objective_s"],
                "gain_frac": (
                    round(
                        1.0 - best["objective_s"]
                        / incumbent["objective_s"], 4,
                    )
                    if best["objective_s"] is not None
                    and incumbent["objective_s"] else None
                ),
                "rate": best["rate"],
                "step_cost_ms": best["step_cost_ms"],
            })
            action = "dry_run_swap" if self.dry_run else "swap"
        else:
            action = "hold"
            self.holds += 1

        if action == "swap":
            self._agree_decision(ctx, action, len(self.decisions), step, best["name"],
                                 sorted(factors))
            self._prev = self._snapshot_state(ctx, optimizer)
            self._migrate(ctx, optimizer, by_name[best["name"]])
            self.swaps += 1
            self._cooldown_left = self.cooldown
            self._pending = {
                "decision_seq": len(self.decisions),
                "baseline_step_s": tr.mean,
                "baseline_step_mad": tr.mad,
                "baseline_efficiency": eff,
                "promised": dict(predicted),
                "delivered": [],
            }
            # a fresh fabric gets a fresh step baseline — the old
            # topology's EWMA must not judge the new one's steady state
            from bluefog_tpu_torch import attribution

            self._step_tracker = attribution.BaselineTracker()
        elif action == "dry_run_swap":
            self._cooldown_left = self.cooldown

        record = DecisionRecord(
            seq=len(self.decisions),
            step=int(step),
            comm_steps=self._count,
            action=action,
            triggers=list(found),
            blamed=[[s, d] for (s, d) in sorted(factors)],
            candidates=scored,
            chosen=best["name"] if best is not incumbent else None,
            predicted=predicted,
            hysteresis={
                "streak": TRIGGER_STREAK,
                "cooldown_left": self._cooldown_left,
                "cooldown": self.cooldown,
            },
            topo_version_before=v_before,
            topo_version_after=int(ctx.topo_version),
            dry_run=self.dry_run,
            async_mode=_async_mode(),
            memory_pressure=_memory_pressure(),
            level=_search_level(ctx),
            slo_burn=_slo_burn(),
        )
        self._emit(record)
        return record

    # -- verification / rollback ----------------------------------------------

    def _chosen_of(self, seq: int) -> Optional[str]:
        for d in self.decisions:
            if d.seq == seq:
                return d.chosen
        return None

    def _verify(self, ctx, optimizer, step, measured_s,
                eff: Optional[float]) -> None:
        pend = self._pending
        if not pend.get("warmed"):
            # the FIRST post-swap sample pays the migration's one-time
            # plan rebuild and first-call costs — excluded from the
            # delivered set as every timing excludes its warm-up from its
            # windows (counting it here rolled back perfectly good
            # migrations for the cost of their own warm-up)
            pend["warmed"] = True
            return
        # every later post-swap sample counts toward the verdict, even
        # a blind one (no step clock, no health plane): the gate must
        # not stay closed forever on a measurement-free run
        pend["delivered"].append(
            {"step_s": measured_s, "efficiency": eff}
        )
        if len(pend["delivered"]) < VERIFY_SAMPLES:
            return
        self._pending = None
        steps = [
            d["step_s"] for d in pend["delivered"]
            if d["step_s"] is not None
        ]
        effs = [
            d["efficiency"] for d in pend["delivered"]
            if d["efficiency"] is not None
        ]
        delivered_step = (
            sorted(steps)[(len(steps) - 1) // 2] if steps else None
        )
        delivered_eff = effs[-1] if effs else None
        base = pend.get("baseline_step_s")
        base_mad = pend.get("baseline_step_mad") or 0.0
        base_eff = pend.get("baseline_efficiency")
        step_regressed = (
            delivered_step is not None and base is not None
            and delivered_step > base + max(
                3.0 * base_mad, ROLLBACK_FRAC * abs(base)
            )
        )
        eff_regressed = (
            delivered_eff is not None and base_eff is not None
            and delivered_eff < base_eff * (1.0 - ROLLBACK_FRAC)
        )
        regressed = step_regressed or eff_regressed
        verdict = {
            "kind": "verification",
            "decision_seq": pend["decision_seq"],
            "step": int(step),
            "promised": pend["promised"],
            "delivered": {
                "step_ms": (
                    round(delivered_step * 1e3, 4)
                    if delivered_step is not None else None
                ),
                "step_ms_baseline": (
                    round(base * 1e3, 4) if base is not None else None
                ),
                "mixing_efficiency": delivered_eff,
                "mixing_efficiency_baseline": base_eff,
            },
            "step_regressed": bool(step_regressed),
            "efficiency_regressed": bool(eff_regressed),
            "verdict": "regressed" if regressed else "delivered",
            "rolled_back": False,
        }
        if regressed and not self.dry_run and self._prev is not None:
            self._agree_decision(ctx, "rollback", len(self.decisions), step,
                                 self._chosen_of(pend["decision_seq"]), [])
            v_before = int(ctx.topo_version)
            self._restore(ctx, optimizer, self._prev)
            self._prev = None
            self.rollbacks += 1
            self._cooldown_left = self.cooldown
            # the regressed candidate sits out long enough for the
            # fabric (and the baselines) to move on — re-selecting it
            # on the very next window is the definition of thrash
            chosen = self._chosen_of(pend["decision_seq"])
            if chosen:
                self._blocked[chosen] = 4 * self.cooldown
            verdict["rolled_back"] = True
            record = DecisionRecord(
                seq=len(self.decisions),
                step=int(step),
                comm_steps=self._count,
                action="rollback",
                triggers=[{
                    "kind": "verification_regression",
                    "source": "autotune",
                    "decision_seq": pend["decision_seq"],
                }],
                blamed=[],
                candidates=[],
                chosen=None,
                predicted={
                    "promised": pend["promised"],
                    "delivered": verdict["delivered"],
                },
                hysteresis={
                    "streak": TRIGGER_STREAK,
                    "cooldown_left": self._cooldown_left,
                    "cooldown": self.cooldown,
                },
                topo_version_before=v_before,
                topo_version_after=int(ctx.topo_version),
                dry_run=self.dry_run,
                async_mode=_async_mode(),
                memory_pressure=_memory_pressure(),
                level=_search_level(ctx),
                slo_burn=_slo_burn(),
            )
            self._emit_verification(verdict)
            self._emit(record)
            return
        self._emit_verification(verdict)

    # -- emission --------------------------------------------------------------

    def _emit(self, record: DecisionRecord) -> None:
        """One decision, every surface: ``bluefog.autotune.*`` metrics,
        flight ring + eviction-proof side table, timeline instant,
        JSONL."""
        from bluefog_tpu_torch import flight as flight_mod
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch import timeline as tl

        self.decisions.append(record)
        self.last_action = record.action
        metrics_mod.counter("bluefog.autotune.decisions").inc()
        metrics_mod.counter(
            f"bluefog.autotune.action.{record.action}"
        ).inc()
        metrics_mod.gauge("bluefog.autotune.last_decision_step").set(
            record.step
        )
        obj = record.predicted.get("objective_after_s") or \
            record.predicted.get("objective_before_s")
        if obj is not None:
            metrics_mod.gauge("bluefog.autotune.objective_s").set(obj)
        gain = record.predicted.get("gain_frac")
        if gain is not None:
            metrics_mod.gauge("bluefog.autotune.predicted_gain").set(
                gain
            )
        flight_mod.note_decision(
            action=record.action, step=record.step, seq=record.seq,
            chosen=record.chosen,
            trigger_kinds=sorted({
                t.get("kind", "?") for t in record.triggers
            }),
            blamed=record.blamed,
            topo_version_before=record.topo_version_before,
            topo_version_after=record.topo_version_after,
            dry_run=record.dry_run,
        )
        tl.timeline_record_instant(
            f"autotune:{record.action}"
            + (f" -> {record.chosen}" if record.chosen else ""),
            "AUTOTUNE",
        )
        self._export_line(record.to_json())

    def _emit_verification(self, verdict: dict) -> None:
        from bluefog_tpu_torch import metrics as metrics_mod

        self.verifications.append(verdict)
        metrics_mod.counter("bluefog.autotune.verifications").inc()
        if verdict["verdict"] == "regressed":
            metrics_mod.counter(
                "bluefog.autotune.regressions"
            ).inc()
        self._export_line(verdict)

    def _export_line(self, obj: dict) -> None:
        path = os.environ.get(FILE_ENV)
        if path:
            from bluefog_tpu_torch.logging_util import append_jsonl

            append_jsonl(FILE_ENV, path, obj)

    # -- artifact --------------------------------------------------------------

    def summary(self) -> dict:
        """The compact block the health plane's ``/fleet`` endpoint and
        ``tools/fleet_report.py`` carry: counts + last action."""
        return {
            "decisions": len(self.decisions),
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "holds": self.holds,
            "last_action": self.last_action,
            "last_decision_step": (
                self.decisions[-1].step if self.decisions else None
            ),
            "dry_run": self.dry_run,
            "cooldown_left": self._cooldown_left,
        }

    def report(self) -> dict:
        """The audit artifact ``tools/autotune_report.py`` and
        ``tools/doctor.py --autotune`` consume: the full decision +
        verification history plus the guardrail configuration."""
        return {
            "kind": "autotune_dump",
            "interval": self.interval,
            "comm_steps": self._count,
            "dry_run": self.dry_run,
            "cooldown": self.cooldown,
            "trigger_streak": TRIGGER_STREAK,
            "min_gain_frac": MIN_GAIN_FRAC,
            "rollback_frac": ROLLBACK_FRAC,
            "summary": self.summary(),
            "decisions": [d.to_json() for d in self.decisions],
            "verifications": list(self.verifications),
            "samples": list(self.samples),
        }

    def dump(self, path: str) -> str:
        from bluefog_tpu_torch.logging_util import json_safe

        with open(path, "w") as f:
            json.dump(json_safe(self.report()), f)
        return path


# -- module-level session ------------------------------------------------------

_tuner: Optional[TopologyAutotuner] = None


def start(interval: Optional[int] = None, **kwargs) -> TopologyAutotuner:
    """Open a controller session (replacing any active one)."""
    global _tuner
    _tuner = TopologyAutotuner(interval=interval, **kwargs)
    return _tuner


def stop() -> None:
    global _tuner
    _tuner = None


def activate(tuner: Optional[TopologyAutotuner]
             ) -> Optional[TopologyAutotuner]:
    """Install (or clear, with None) a pre-built session WITHOUT
    resetting its baselines — an on/off comparison toggles one
    session on and off around individual steps."""
    global _tuner
    _tuner = tuner
    return tuner


def active() -> Optional[TopologyAutotuner]:
    return _tuner


def observe_step(ctx, *, step: int, optimizer=None, plan=None) -> None:
    """Optimizer-layer hook, called after every communicating dispatch
    (next to the doctor/health/staleness hooks). No-op (one attribute
    read) when no controller session is active."""
    tuner = _tuner
    if tuner is None:
        return
    tuner.observe(ctx, step=step, optimizer=optimizer, plan=plan)


def dump(path: str) -> Optional[str]:
    """Write the active session's audit artifact (None when no session
    is active)."""
    tuner = _tuner
    if tuner is None:
        return None
    return tuner.dump(path)


def on_init(ctx) -> None:
    """``bft.init()`` hook: fresh session under ``BLUEFOG_AUTOTUNE=1``
    (a new context must not inherit a torn-down context's hysteresis state or
    rollback target)."""
    if enabled():
        start()
    else:
        stop()


def on_shutdown() -> None:
    """``bft.shutdown()`` hook: flush the JSONL tail, drop the
    session."""
    tuner = _tuner
    if tuner is not None and tuner.decisions:
        tuner._export_line({
            "kind": "session_end",
            "comm_steps": tuner._count,
            "summary": tuner.summary(),
        })
    stop()
