# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Deterministic fault injection (chaos layer) for elastic gossip.

A copy of ``bluefog_tpu/elastic/faults.py`` (stdlib only): the same
grammar, the same :class:`Fault` checks, so a plan parses alike in both
packages.

Real multi-host failures are irreproducible; tier-1 tests run on a
single-process virtual CPU mesh where nothing ever actually dies. This
module closes the gap with a *deterministic chaos plan*: a list of
(kind, rank, step) faults that the elastic session replays at exact step
indices, so every failure mode — crash, stall past the liveness
deadline, degraded link — is a reproducible unit test rather than a
3 a.m. page.

Plan grammar (``BLUEFOG_FAULT_PLAN``), semicolon-separated clauses::

    kill:rank=3,step=5
    stall:rank=2,step=10,seconds=120
    stall:rank=2,step=10,steps=6,peer=3
    degrade:rank=1,step=4,factor=0.25
    slow:rank=5,step=0,factor=10
    slow:rank=5,step=20,factor=4,steps=50
    oom:rank=3,step=12

- ``kill``     — the rank is dead from ``step`` on (process crash).
- ``stall``    — the rank blocks for ``seconds`` at ``step``. A stall at
  or past the liveness deadline (``BLUEFOG_LIVENESS_TIMEOUT``) is
  condemned exactly like a kill; a shorter one is recorded (counter +
  timeline marker) and survives — transient slowness must NOT trigger
  repair. An optional ``steps=S`` declares the stall's length on the
  session step clock: for ``S`` steps from ``step`` on, the rank's
  outbound payload is frozen at its pre-stall version, so the
  staleness observatory's lineage lane measures a growing delivered
  age on its out-edges (:meth:`~bluefog_tpu_torch.elastic.recovery.
  ElasticSession.simulated_stale_steps` — the wire-age analogue of the
  degrade faults' ``simulated_wire_factors``). ``peer=P`` narrows the
  hold to the single directed edge ``(rank, P)``.
- ``degrade``  — from ``step`` on the rank's gossip edges are scaled by
  ``factor`` (and receiver weights renormalized) at the next repair:
  the TopoOpt-style "co-optimize around a slow link" response. An
  optional ``peer=P`` narrows the fault to the single directed edge
  ``(rank, P)`` — a wire-level chaos primitive: repair re-weighting is
  rank-granular and is deliberately NOT triggered by a narrowed fault
  (it would down-weight the rank's healthy edges too). Active degrade
  faults, narrowed or not, slow the attribution doctor's wire probes
  deterministically (:meth:`~bluefog_tpu_torch.elastic.recovery.
  ElasticSession.simulated_wire_factors`) so degraded-link *detection*
  is testable on a mesh with no physically slow link.
- ``slow``     — rank-scoped COMPUTE dilation: from ``step`` on the
  rank's local steps take ``factor`` (≥ 1) times as long, so on the
  asynchronous gossip engine's tick clock its cadence period
  multiplies by ``ceil(factor)``
  (:meth:`~bluefog_tpu_torch.elastic.recovery.ElasticSession.
  simulated_compute_dilation` — the compute analogue of the
  link-scoped ``degrade``). An optional ``steps=S`` bounds the
  dilation to ``S`` session steps; without it the fault is permanent.
  This is the 10x-straggler chaos primitive the ``BENCH_MODE=async``
  evidence drives: rank-scoped by definition (``peer=`` is rejected —
  a slow *chip* has no single slow edge).
- ``oom``      — simulated device allocation failure: at its step the
  memory observatory's OOM forensics run (:func:`bluefog_tpu_torch.memory.
  on_oom`: ranked census, flight advisory and dump) and the dispatch
  raises :class:`~bluefog_tpu_torch.memory.SimulatedResourceExhausted`.
  Rank-scoped like ``slow``: ``peer=``/``seconds=``/``factor=`` are
  rejected.

Programmatic equivalent: :func:`bluefog_tpu_torch.elastic.inject`.
"""

import dataclasses
import os
from typing import List, Optional, Tuple

__all__ = ["Fault", "FaultPlan", "parse_fault_plan", "FAULT_PLAN_ENV"]

FAULT_PLAN_ENV = "BLUEFOG_FAULT_PLAN"

_KINDS = ("kill", "stall", "degrade", "slow", "oom")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``step`` indexes the elastic session's own
    monotonic step counter (a dispatch = one step)."""

    kind: str
    rank: int
    step: int
    seconds: float = 0.0  # stall duration (simulated wall time)
    factor: float = 1.0  # degrade link-quality scale
    # fault target: -1 covers every edge of `rank`; a peer rank narrows
    # a degrade (slow link) or a stall hold (stale link) to the single
    # directed edge (rank, peer) — the form the attribution doctor's
    # degraded-link localization and the staleness observatory's
    # breach naming are tested against
    peer: int = -1
    # stall length on the session STEP clock: while active, the rank's
    # outbound payload is frozen at its pre-stall version (the
    # staleness observatory's deterministic age simulation); 0 = the
    # stall has no step-clock extent (wall-time only)
    hold_steps: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"fault kind must be one of {_KINDS}, got {self.kind!r}"
            )
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "stall" and self.seconds < 0:
            raise ValueError(
                f"stall seconds must be >= 0, got {self.seconds}"
            )
        if self.kind == "degrade" and not 0.0 < self.factor <= 1.0:
            raise ValueError(
                f"degrade factor must be in (0, 1], got {self.factor}"
            )
        if self.kind == "slow" and self.factor < 1.0:
            raise ValueError(
                f"slow factor is a compute dilation and must be >= 1, "
                f"got {self.factor} (a value below 1 would mean a "
                "SPEEDUP; for a slow link use degrade)"
            )
        if self.kind == "slow" and self.seconds:
            raise ValueError(
                "seconds= does not apply to slow faults (the dilation "
                "is a per-step factor; bound it with steps=)"
            )
        if self.kind == "oom" and (
            self.seconds or self.factor != 1.0
        ):
            raise ValueError(
                "seconds=/factor= do not apply to oom faults (an "
                "allocation failure is instantaneous and total)"
            )
        if self.peer >= 0 and self.kind not in ("degrade", "stall"):
            raise ValueError(
                f"peer= only applies to degrade and stall faults, got "
                f"kind {self.kind!r} (a slow fault dilates the RANK's "
                "compute — there is no per-edge form)"
            )
        if self.hold_steps and self.kind not in ("stall", "slow"):
            raise ValueError(
                f"steps= only applies to stall and slow faults, got "
                f"kind {self.kind!r}"
            )
        if self.hold_steps < 0:
            raise ValueError(
                f"stall steps must be >= 0, got {self.hold_steps}"
            )


def _parse_clause(clause: str) -> Fault:
    head, _, body = clause.partition(":")
    kind = head.strip().lower()
    fields = {}
    if body.strip():
        for pair in body.split(","):
            if "=" not in pair:
                raise ValueError(
                    f"fault clause field {pair!r} is not key=value "
                    f"(in {clause!r})"
                )
            k, v = pair.split("=", 1)
            fields[k.strip().lower()] = v.strip()
    unknown = set(fields) - {
        "rank", "step", "seconds", "factor", "peer", "steps",
    }
    if unknown:
        raise ValueError(
            f"unknown fault fields {sorted(unknown)} in {clause!r}; "
            "accepted: rank, step, seconds, factor, peer, steps"
        )
    for required in ("rank", "step"):
        if required not in fields:
            raise ValueError(
                f"fault clause {clause!r} is missing {required}="
            )
    return Fault(
        kind=kind,
        rank=int(fields["rank"]),
        step=int(fields["step"]),
        seconds=float(fields.get("seconds", 0.0)),
        factor=float(fields.get("factor", 1.0)),
        peer=int(fields.get("peer", -1)),
        hold_steps=int(fields.get("steps", 0)),
    )


def parse_fault_plan(text: Optional[str]) -> "FaultPlan":
    """Parse the ``BLUEFOG_FAULT_PLAN`` grammar into a :class:`FaultPlan`
    (empty plan for empty/None input)."""
    faults: List[Fault] = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if clause:
            faults.append(_parse_clause(clause))
    return FaultPlan(faults)


class FaultPlan:
    """An ordered, step-indexed set of scheduled faults."""

    def __init__(self, faults=()):
        self._faults: List[Fault] = sorted(
            faults, key=lambda f: (f.step, f.rank)
        )

    @classmethod
    def from_env(cls, env=None) -> "FaultPlan":
        env = os.environ if env is None else env
        return parse_fault_plan(env.get(FAULT_PLAN_ENV))

    @property
    def faults(self) -> Tuple[Fault, ...]:
        return tuple(self._faults)

    def __len__(self):
        return len(self._faults)

    def __bool__(self):
        return bool(self._faults)

    def add(self, fault: Fault) -> None:
        self._faults.append(fault)
        self._faults.sort(key=lambda f: (f.step, f.rank))

    def due(self, step: int) -> Tuple[Fault, ...]:
        """Faults scheduled at exactly ``step``."""
        return tuple(f for f in self._faults if f.step == int(step))

    def validate(self, world_size: int) -> None:
        for f in self._faults:
            if not 0 <= f.rank < world_size:
                raise ValueError(
                    f"fault plan names rank {f.rank} but the mesh has "
                    f"{world_size} workers"
                )
            if f.peer >= world_size:
                raise ValueError(
                    f"fault plan names peer {f.peer} but the mesh has "
                    f"{world_size} workers"
                )
