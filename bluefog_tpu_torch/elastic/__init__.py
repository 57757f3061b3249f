# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""``bft.elastic``: fault injection, liveness, and consensus-preserving
topology repair for decentralized runs.

Counterpart of ``bluefog_tpu/elastic/``, with its names. A dead or stalled
rank is detected (injected verdicts of the chaos plan, watchdog liveness
deadlines on blocking waits), pruned from the mixing matrix with the
stochasticity each optimizer family needs
(:mod:`bluefog_tpu_torch.elastic.repair`), and the repaired topology is
lowered through the ordinary plan compiler under a live-set-aware key, so
no stale plan ever dispatches. The ZeRO layout re-shards on the new live
set, the async engine re-windows, and a checkpoint records and restores the
live set.

Quick start::

    import bluefog_tpu_torch as bft
    bft.init()
    session = bft.elastic.start()          # reads BLUEFOG_FAULT_PLAN
    session.inject("kill", rank=3, step=5)
    guard = bft.elastic.guard(opt)         # wraps opt.step / make_train_step
    ...
    bft.elastic.stop()

An ``oom`` fault runs the memory observatory's forensics
(:mod:`bluefog_tpu_torch.memory`) at its step and raises
``SimulatedResourceExhausted``.
"""

from typing import Optional

from bluefog_tpu_torch.elastic.membership import Membership, RankState
from bluefog_tpu_torch.elastic.faults import (
    FAULT_PLAN_ENV,
    Fault,
    FaultPlan,
    parse_fault_plan,
)
from bluefog_tpu_torch.elastic.repair import (
    POLICIES,
    repair_schedule,
    repaired_matrix,
    repaired_topology,
    survivor_consensus,
)
from bluefog_tpu_torch.elastic.recovery import (
    ElasticGuard,
    ElasticSession,
    RepairRecord,
    consensus_restore,
    liveness_timeout,
    rebind,
)

__all__ = [
    "Membership",
    "RankState",
    "Fault",
    "FaultPlan",
    "FAULT_PLAN_ENV",
    "parse_fault_plan",
    "POLICIES",
    "repaired_matrix",
    "repaired_topology",
    "repair_schedule",
    "survivor_consensus",
    "ElasticSession",
    "ElasticGuard",
    "RepairRecord",
    "consensus_restore",
    "liveness_timeout",
    "rebind",
    "start",
    "stop",
    "active_session",
    "inject",
    "guard",
]

_session: Optional[ElasticSession] = None


def start(plan=None, policy: str = "average",
          liveness_timeout_s: Optional[float] = None) -> ElasticSession:
    """Open the elastic session for the current context (at most one).
    ``plan`` defaults to the ``BLUEFOG_FAULT_PLAN`` environment grammar.
    Across processes every process opens its session on the same plan
    (the launcher forwards the environment) and the sessions agree before
    every dispatch (:mod:`bluefog_tpu_torch.elastic.recovery`); an ``oom``
    fault runs the memory observatory's forensics in every process."""
    global _session
    if _session is not None:
        raise RuntimeError(
            "an elastic session is already active; call bft.elastic.stop() "
            "first"
        )
    _session = ElasticSession(
        plan=plan, policy=policy, liveness_timeout_s=liveness_timeout_s
    )
    return _session


def stop() -> None:
    """Close the active session (idempotent)."""
    global _session
    if _session is not None:
        _session.close()
        _session = None


def active_session() -> Optional[ElasticSession]:
    return _session


def inject(kind: str, rank: int, step: int, *, seconds: float = 0.0,
           factor: float = 1.0, peer: int = -1, steps: int = 0) -> Fault:
    """Schedule a fault on the active session's step clock (the
    programmatic twin of ``BLUEFOG_FAULT_PLAN``). ``peer`` narrows a
    degrade or stall fault to the single directed edge ``(rank,
    peer)``; ``steps`` gives a stall its step-clock extent (payload
    held for the staleness observatory's wire-age simulation)."""
    if _session is None:
        raise RuntimeError(
            "no active elastic session; call bft.elastic.start() first"
        )
    return _session.inject(
        kind, rank, step, seconds=seconds, factor=factor, peer=peer,
        steps=steps,
    )


def guard(optimizer) -> ElasticGuard:
    """Bind ``optimizer`` to the active session: the returned guard's
    ``step`` / ``make_train_step`` run liveness + repair before every
    dispatch."""
    if _session is None:
        raise RuntimeError(
            "no active elastic session; call bft.elastic.start() first"
        )
    return ElasticGuard(_session, optimizer)
