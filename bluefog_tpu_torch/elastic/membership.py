# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Live-set tracking for elastic gossip runs.

A copy of ``bluefog_tpu/elastic/membership.py`` that records through the
port's flight recorder. One process drives every worker of the stacked
axis, so what dies is a simulated rank of the chaos harness.

The reference has no membership model at all: a dead MPI rank aborts the
job (``mpirun`` kills the world). Under single-controller SPMD the mesh
devices cannot leave the process either — what *can* die is a remote host
backing part of the mesh, or (in the deterministic chaos harness,
:mod:`bluefog_tpu_torch.elastic.faults`) a simulated rank. Either way the
controller needs one authoritative answer to "who is still in the
gossip?", versioned so every compiled-plan cache can key on it.

:class:`Membership` is that answer: per-rank liveness states with a
monotonic ``epoch`` that bumps on every transition. The epoch plus the
live tuple form the *live token* (:meth:`Membership.token`) that
:meth:`bluefog_tpu_torch.context.BluefogContext.static_plan` folds into its key,
so a membership change can never dispatch a stale :class:`CommPlan`.
"""

import enum
import threading
from typing import Dict, Optional, Tuple

from bluefog_tpu_torch import flight

__all__ = ["RankState", "Membership"]


class RankState(enum.Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"  # a liveness deadline fired; not yet condemned
    DEAD = "dead"


class Membership:
    """Authoritative per-rank liveness with a monotonic epoch.

    Thread-safe: the stall-watchdog thread files suspicions
    (:meth:`mark_suspect`) concurrently with the training loop's
    :meth:`mark_dead` / :meth:`revive`.
    """

    def __init__(self, world_size: int):
        assert world_size > 0
        self.world_size = int(world_size)
        self.epoch = 0  # bumps on EVERY state transition
        self._lock = threading.Lock()
        self._states: Dict[int, RankState] = {
            r: RankState.ALIVE for r in range(self.world_size)
        }
        # rank -> (reason, step reported); kept across revive for forensics
        self.history: list = []
        self._reasons: Dict[int, Tuple[str, Optional[int]]] = {}
        # rank -> link-quality factor in (0, 1]; 1.0 = healthy. Degraded
        # ranks stay ALIVE but the repair engine down-weights their edges.
        self._degraded: Dict[int, float] = {}

    def _check(self, rank: int) -> int:
        rank = int(rank)
        if not 0 <= rank < self.world_size:
            raise ValueError(
                f"rank {rank} out of range for world size {self.world_size}"
            )
        return rank

    def state(self, rank: int) -> RankState:
        return self._states[self._check(rank)]

    def is_live(self, rank: int) -> bool:
        """SUSPECT still counts as live: suspicion gates *detection*, not
        the combine — only a DEAD verdict removes a rank from the wire."""
        return self._states[self._check(rank)] is not RankState.DEAD

    def live_ranks(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(
                r for r in range(self.world_size)
                if self._states[r] is not RankState.DEAD
            )

    def dead_ranks(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(
                r for r in range(self.world_size)
                if self._states[r] is RankState.DEAD
            )

    def degraded(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._degraded)

    def reason(self, rank: int) -> Optional[Tuple[str, Optional[int]]]:
        return self._reasons.get(self._check(rank))

    def token(self):
        """Hashable (epoch, live tuple) for compiled-plan cache keys."""
        with self._lock:
            live = tuple(
                r for r in range(self.world_size)
                if self._states[r] is not RankState.DEAD
            )
            return (self.epoch, live)

    # -- transitions ---------------------------------------------------------

    def _transition(self, rank, state, reason, step, forbid=()) -> bool:
        """State change under the lock; ``forbid`` lists current states
        the transition must NOT override (checked INSIDE the lock — the
        watchdog thread files suspicions concurrently with the training
        thread's death verdicts, and a pre-lock check would let a racing
        suspicion resurrect a just-condemned rank)."""
        rank = self._check(rank)
        with self._lock:
            cur = self._states[rank]
            if cur in forbid or cur is state:
                return False
            self._states[rank] = state
            if state is RankState.DEAD:
                self._degraded.pop(rank, None)
            self.epoch += 1
            self._reasons[rank] = (reason, step)
            self.history.append((rank, state.value, reason, step))
            epoch = self.epoch
        # flight-recorder event outside the lock: every verdict is part
        # of the postmortem record (who was condemned, when, and why)
        flight.record(
            "membership", rank=rank, state=state.value, reason=reason,
            step=step, epoch=epoch,
        )
        return True

    def mark_suspect(self, rank: int, reason: str = "deadline",
                     step: Optional[int] = None) -> bool:
        """File a liveness suspicion (e.g. a combine dispatch outlived its
        deadline). Idempotent; DEAD ranks stay dead."""
        return self._transition(
            rank, RankState.SUSPECT, reason, step, forbid=(RankState.DEAD,)
        )

    def mark_dead(self, rank: int, reason: str = "killed",
                  step: Optional[int] = None) -> bool:
        """Condemn a rank. Returns True if the state changed."""
        return self._transition(rank, RankState.DEAD, reason, step)

    def mark_degraded(self, rank: int, factor: float,
                      step: Optional[int] = None) -> bool:
        """Record a degraded (but live) rank; ``factor`` in (0, 1] scales
        its gossip edge weights at the next repair."""
        rank = self._check(rank)
        factor = float(factor)
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"degrade factor must be in (0, 1], got {factor}")
        with self._lock:
            if self._states[rank] is RankState.DEAD:
                return False
            prev = self._degraded.get(rank)
            if prev == factor:
                return False
            self._degraded[rank] = factor
            self.epoch += 1
            self.history.append((rank, "degraded", f"factor={factor}", step))
            epoch = self.epoch
        flight.record(
            "membership", rank=rank, state="degraded",
            reason=f"factor={factor}", step=step, epoch=epoch,
        )
        return True

    def revive(self, rank: int, step: Optional[int] = None) -> bool:
        """Re-admit a rank (rejoin path,
        :meth:`bluefog_tpu_torch.elastic.recovery.ElasticSession.rejoin`)."""
        return self._transition(rank, RankState.ALIVE, "rejoined", step)
