# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Elastic session: liveness verdicts -> repair -> recovery, end to end.

Counterpart of ``bluefog_tpu/elastic/recovery.py``. :class:`ElasticSession`
owns the run's :class:`~bluefog_tpu_torch.elastic.membership.Membership`,
replays the deterministic chaos plan (:mod:`bluefog_tpu_torch.elastic.faults`),
and drives the repair engine (:mod:`bluefog_tpu_torch.elastic.repair`) the
moment a dead rank would have taken part in a combine. The detection model:

- **Simulation**: fault verdicts are injected; a kill at step k is
  *detected* at the first dispatch whose active edge set touches the dead
  rank (``steps_to_detect = detect_step - kill_step``).
- **Blocking waits**: the stall watchdog's deadlines double as liveness
  deadlines. A wait (``synchronize``, ``win_wait``, the async fold) that
  outlives ``BLUEFOG_LIVENESS_TIMEOUT`` files SUSPECT verdicts for every
  rank of the last dispatch (``Membership.mark_suspect``); condemnation
  stays a policy decision above (a suspect rank is still on the wire).

Repair is synchronous and on the host: prune and renormalize the mixing
matrix (the policy of the optimizer family), install it with
``ctx.set_topology`` (a topology version bump), and let the plan compiler
lower it; the static plan's key carries the live token
(:meth:`~bluefog_tpu_torch.context.BluefogContext.live_token`), so no stale
plan dispatches. Optimizer state survives by construction: the inner state
is worker-stacked and no graph change touches it; the CHOCO copies and the
delay buffers carry a structure signature and are zeroed exactly when the
edge set changed; a ZeRO layout re-shards on the new live set
(``_GossipOptimizer._shard_prepare``) and the async engine re-windows
(``AsyncGossipEngine._ensure_window``).

An ``oom`` fault runs the memory observatory's forensics at its step
(:func:`bluefog_tpu_torch.memory.on_oom`: ranked census, flight advisory
and dump) and raises :class:`~bluefog_tpu_torch.memory.SimulatedResourceExhausted`
before the dispatch; it is no verdict and triggers no repair.

**Across processes** (a context whose ``process_count > 1``) every process
opens its session on the same fault plan and runs the same host-side
numpy: the membership, the repaired matrix and the plans are global and
equal in every process, the tensors are the local rows. What one process
alone can observe, a watchdog verdict (:meth:`ElasticSession._on_stall`,
timing-based), is queued, not applied; each :meth:`ElasticSession.before_dispatch`
ends with one ``all_gather_object`` of every process's queued verdicts
and of its view ``(epoch, live set, topology version, the next
dispatch's plan)``, applies the union of the verdicts in every process
and raises ``RuntimeError`` naming the processes whose view differs from
process 0's, before the dispatch (a process that took another branch
would leave the others waiting in the transport). :meth:`~ElasticSession.rejoin`
and :meth:`~ElasticSession.adopt_live_set` end with the same agreement.
:func:`consensus_restore` takes every row through
:func:`bluefog_tpu_torch.collective.transport.gather_rows` and writes the
survivors' mean into the rejoining rank's row in its owner process. The
``oom`` fault fires at the same step in every process; each runs the
memory observatory's forensics, whose ranked census is the fleet's (the
last sample's, summed over the processes), the same in every process.
"""

import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import flight
from bluefog_tpu_torch import metrics as metrics_mod
from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch import watchdog
from bluefog_tpu_torch.logging_util import logger
from bluefog_tpu_torch.elastic import repair as repair_mod
from bluefog_tpu_torch.elastic.faults import Fault, FaultPlan
from bluefog_tpu_torch.elastic.membership import Membership
from bluefog_tpu_torch.topology.graphs import edges as topo_edges

__all__ = [
    "ElasticSession",
    "ElasticGuard",
    "RepairRecord",
    "liveness_timeout",
    "consensus_restore",
    "rebind",
]

LIVENESS_TIMEOUT_ENV = "BLUEFOG_LIVENESS_TIMEOUT"


def liveness_timeout() -> float:
    """Seconds a combine dispatch may block before the liveness layer
    files SUSPECT verdicts (default: the watchdog stall timeout; 0
    disables). A *simulated* stall of at least this length is condemned
    like a kill."""
    env = os.environ.get(LIVENESS_TIMEOUT_ENV)
    if env is not None:
        return float(env)
    return watchdog.stall_timeout()


@dataclasses.dataclass(frozen=True)
class RepairRecord:
    """One completed repair, for evidence files and tests."""

    step: int  # session step the repair ran at
    dead: Tuple[int, ...]  # full dead set after this repair
    detected: Tuple[int, ...]  # ranks newly detected this repair
    steps_to_detect: Dict[int, int]  # rank -> detect_step - fault_step
    steps_to_repair: int  # dispatches between detection and repair (0 =
    # repaired before the detecting dispatch ran — the synchronous path)
    policy: str
    epoch: int  # membership epoch after repair
    live: Tuple[int, ...]
    topo_version: int  # ctx.topo_version after install


def consensus_restore(params, rank: int, live: Sequence[int]):
    """A copy of a worker-stacked tree (a tensor or a nested dict, list or
    tuple of tensors) whose worker slot ``rank`` holds the survivors'
    consensus: their uniform mean, taken in float32 and cast back, on each
    tensor's own device. The state a rejoining rank resumes from. Across
    processes the tree is this process's rows, every process calls it, and
    only the owner of ``rank`` writes the mean of the gathered rows (bitwise
    the stacked mean)."""
    from bluefog_tpu_torch.collective import transport
    from bluefog_tpu_torch.optimizers import _tree_unflatten, tree_leaves

    survivors = sorted(int(r) for r in live if int(r) != int(rank))
    if not survivors:
        raise ValueError("no survivors to restore consensus from")
    ctx = ctx_mod._context
    multi = ctx is not None and ctx.process_count > 1

    def fix(leaf):
        # across processes every row first (the leaf is this process's rows)
        full = transport.gather_rows(leaf.contiguous(), ctx) if multi else leaf
        idx = torch.as_tensor(survivors, dtype=torch.long, device=leaf.device)
        mean = torch.mean(full.index_select(0, idx).to(torch.float32), dim=0).to(leaf.dtype)
        out = leaf.clone()
        if not multi:
            out[int(rank)] = mean
        elif int(rank) in ctx.rows:
            out[int(rank) - ctx.rows.start] = mean
        return out

    return _tree_unflatten(params, [fix(leaf) for leaf in tree_leaves(params)])


def rebind(optimizer) -> None:
    """Re-point an optimizer at the repaired topology.

    Deliberately small: the step path re-resolves the plan from the
    context every dispatch, so the version bump alone retargets it. What
    this adds: drops the per-structure wire-byte accounting cache (its
    entries are keyed by now-dead plans) so the metrics layer reports the
    repaired rounds. The inner state is untouched (worker-stacked, graph-
    independent); the CHOCO copies and the delay buffers carry a
    structure signature and are zeroed exactly when the edge set changed,
    and kept when it did not.
    """
    if optimizer is None:
        return
    if hasattr(optimizer, "_acct_cache"):
        optimizer._acct_cache = {}


class ElasticSession:
    """One elastic run: chaos replay, liveness, repair, recovery.

    Usage (the :func:`bluefog_tpu_torch.elastic.start` facade builds one)::

        session = bft.elastic.start(policy="average")   # reads env plan
        guard = bft.elastic.guard(opt)                  # wraps opt.step
        for batch in data:
            params, state = guard.step(params, state, grads)

    Every wrapped dispatch advances the session's step counter, replays
    due faults, and repairs before the combine when a dead rank would
    have been on the wire.
    """

    def __init__(
        self,
        plan: Optional[FaultPlan] = None,
        policy: str = "average",
        liveness_timeout_s: Optional[float] = None,
    ):
        if policy not in repair_mod.POLICIES:
            raise ValueError(
                f"policy must be one of {repair_mod.POLICIES}, got {policy!r}"
            )
        ctx = ctx_mod.get_context()
        plan = plan if plan is not None else FaultPlan.from_env()
        plan.validate(ctx.size)
        self.ctx = ctx
        self.policy = policy
        self.membership = Membership(ctx.size)
        ctx.elastic_membership = self.membership
        self.plan = plan
        self._liveness_timeout = liveness_timeout_s
        self.step = 0
        self.repairs: List[RepairRecord] = []
        self.stale_dispatches = 0  # MUST stay 0; counted as a tripwire
        # rank -> fault step, for kills/condemnations awaiting detection
        self._unrepaired: Dict[int, int] = {}
        self._degrade_dirty = False
        self._applied: set = set()  # fault identity, replay-once
        # the base (pre-fault) topology repairs are computed from, so a
        # rejoin can restore pruned edges; refreshed if the USER installs
        # a new topology mid-session (see before_dispatch)
        self._base_topo = ctx.load_topology()
        self._base_topo_version = ctx.topo_version
        self._installed_topo_version = None  # versions this session set
        # static-topology edge list, cached by (topo_version), rebuilt
        # only when a repair (or user set_topology) bumps the version
        self._edges_cache = None
        # ranks of the most recent dispatch, for watchdog suspicion
        self._last_dispatch_ranks: Tuple[int, ...] = tuple(range(ctx.size))
        # across processes: watchdog verdicts queued for the next agreement
        self._queued: List[Tuple[int, str, int]] = []
        self._queued_lock = threading.Lock()  # the watchdog thread appends
        watchdog.add_stall_handler(self._on_stall)
        metrics_mod.gauge("bluefog.elastic.dead_ranks").set(0)

    # -- liveness ------------------------------------------------------------

    def liveness_timeout_s(self) -> float:
        if self._liveness_timeout is not None:
            return float(self._liveness_timeout)
        return liveness_timeout()

    def _on_stall(self, name: str, waited: float) -> None:
        """Watchdog callback: a blocking wait outlived its deadline.
        Files SUSPECT verdicts for every rank of the last dispatched
        plan — on a real mesh the controller cannot tell *which* peer
        hung a ppermute, only that the program did."""
        limit = self.liveness_timeout_s()
        if limit <= 0 or waited < limit:
            return
        verdicts = [(int(r), f"stall:{name}", self.step) for r in self._last_dispatch_ranks]
        if self.ctx.process_count > 1:
            # one process's timing: every process applies it at the next
            # agreement (before_dispatch), so the memberships stay equal
            with self._queued_lock:
                self._queued.extend(verdicts)
            return
        self._suspect(verdicts, name)

    def _suspect(self, verdicts, name: str) -> None:
        """File SUSPECT verdicts ``(rank, reason, step)``."""
        suspected = [
            r for r, reason, step in verdicts
            if self.membership.mark_suspect(r, reason, step)
        ]
        for _ in suspected:
            metrics_mod.counter("bluefog.elastic.suspects").inc()
        tl.timeline_record_instant(f"elastic:suspect {name}", "LIVENESS")
        if suspected:
            # SUSPECT verdicts are a dump trigger: the run may be about
            # to die, so the black box goes to disk while it still can
            flight.maybe_dump(f"verdict:suspect:{name}")

    def close(self) -> None:
        watchdog.remove_stall_handler(self._on_stall)
        if self.ctx.elastic_membership is self.membership:
            self.ctx.elastic_membership = None

    # -- chaos replay --------------------------------------------------------

    def inject(self, kind: str, rank: int, step: int, *, seconds: float = 0.0,
               factor: float = 1.0, peer: int = -1,
               steps: int = 0) -> Fault:
        """Programmatic fault injection (the ``BLUEFOG_FAULT_PLAN`` API
        twin): schedule a fault on this session's own step clock.
        ``peer`` narrows a degrade (or stall) fault to the single
        directed edge ``(rank, peer)``; ``steps`` gives a stall its
        step-clock extent (the staleness observatory's deterministic
        payload-hold simulation) or bounds a ``slow`` fault's
        compute-dilation window; ``factor`` is the link scale for
        ``degrade`` (in (0, 1]) and the compute dilation for ``slow``
        (>= 1)."""
        fault = Fault(kind=kind, rank=int(rank), step=int(step),
                      seconds=float(seconds), factor=float(factor),
                      peer=int(peer), hold_steps=int(steps))
        if not 0 <= fault.rank < self.ctx.size:
            raise ValueError(
                f"rank {fault.rank} out of range for {self.ctx.size} workers"
            )
        if fault.peer >= self.ctx.size:
            raise ValueError(
                f"peer {fault.peer} out of range for {self.ctx.size} workers"
            )
        self.plan.add(fault)
        return fault

    def simulated_wire_factors(self) -> Dict:
        """Degrade faults active at the current session step, as a
        ``{(src, dst) | rank: factor}`` map — the deterministic wire
        simulation the attribution doctor's probes consult
        (:meth:`bluefog_tpu_torch.attribution.StepDoctor._chaos_delay_s`).
        A stacked transport has no physically slow link;
        this is the chaos layer's stand-in, so degraded-link
        *localization from timings alone* is a reproducible unit test."""
        out: Dict = {}
        for f in self.plan.faults:
            if f.kind == "degrade" and f.step <= self.step:
                key = (f.rank, f.peer) if f.peer >= 0 else f.rank
                out[key] = min(out.get(key, 1.0), f.factor)
        return out

    def simulated_compute_dilation(self) -> Dict[int, float]:
        """``slow`` faults active at the current session step, as a
        ``{rank: factor >= 1}`` compute-dilation map — the chaos
        layer's deterministic stand-in for a physically slow chip
        (the compute analogue of :meth:`simulated_wire_factors`). The
        asynchronous gossip engine multiplies a dilated rank's cadence
        period by ``ceil(factor)``
        (:meth:`bluefog_tpu_torch.async_gossip.AsyncGossipEngine._periods`). A fault with ``steps=S`` expires after ``S`` session
        steps; without it the dilation is permanent."""
        out: Dict[int, float] = {}
        for f in self.plan.faults:
            if f.kind != "slow" or self.step < f.step:
                continue
            if f.hold_steps > 0 and self.step >= f.step + f.hold_steps:
                continue
            out[f.rank] = max(out.get(f.rank, 1.0), f.factor)
        return out

    def simulated_stale_steps(self) -> Dict:
        """Stall faults with a step-clock extent (``steps=``) active at
        the current session step, as a ``{(src, dst) | rank:
        extra_age}`` map — the staleness observatory's deterministic
        wire simulation (the age analogue of
        :meth:`simulated_wire_factors`), read when it stamps the lineage
        lane (:mod:`bluefog_tpu_torch.staleness`) and by the breach
        suspects (:func:`bluefog_tpu_torch.attribution.suspect_join`).

        A rank stalled since fault step ``s`` keeps shipping its
        step-``s`` payload: at session step ``t`` in ``[s, s +
        steps)`` the held payload is ``t - s + 1`` steps older than a
        live sender's would be (the rank froze BEFORE this step's
        send), so the measured age ramps 1, 2, ..., ``steps`` and then
        recovers — exactly the spike the chaos evidence pins."""
        out: Dict = {}
        for f in self.plan.faults:
            if f.kind != "stall" or f.hold_steps <= 0:
                continue
            k = self.step - f.step
            if 0 <= k < f.hold_steps:
                key = (f.rank, f.peer) if f.peer >= 0 else f.rank
                out[key] = max(out.get(key, 0), k + 1)
        return out

    def _apply_fault(self, fault: Fault, step: int) -> None:
        metrics_mod.counter("bluefog.elastic.faults").inc()
        # the fault event carries the topology version it fired under:
        # the postmortem resolves "which edge/round were the neighbors
        # waiting on" against the plan compiled for THAT version (the
        # repair below bumps it)
        flight.note_fault(
            fault_kind=fault.kind, rank=fault.rank, step=step,
            seconds=fault.seconds, factor=fault.factor,
            peer=fault.peer, hold_steps=fault.hold_steps,
            topo_version=self.ctx.topo_version,
        )
        if fault.kind == "kill":
            if self.membership.mark_dead(fault.rank, "killed", step):
                self._unrepaired[fault.rank] = step
                tl.timeline_record_instant(
                    f"elastic:kill rank={fault.rank}", "FAULT"
                )
                flight.maybe_dump(f"verdict:dead:rank={fault.rank}")
        elif fault.kind == "stall":
            limit = self.liveness_timeout_s()
            if limit > 0 and fault.seconds >= limit:
                # a stall past the liveness deadline IS a death verdict
                self.membership.mark_suspect(
                    fault.rank, f"stalled {fault.seconds:g}s", step
                )
                if self.membership.mark_dead(
                    fault.rank,
                    f"stalled {fault.seconds:g}s >= deadline {limit:g}s",
                    step,
                ):
                    self._unrepaired[fault.rank] = step
                    flight.maybe_dump(
                        f"verdict:dead:rank={fault.rank}"
                    )
                tl.timeline_record_instant(
                    f"elastic:stall-condemned rank={fault.rank}", "FAULT"
                )
            else:
                # transient slowness: observable, never repair-triggering
                metrics_mod.counter("bluefog.elastic.stalls").inc()
                tl.timeline_record_instant(
                    f"elastic:stall rank={fault.rank} "
                    f"{fault.seconds:g}s", "FAULT"
                )
        elif fault.kind == "degrade":
            if fault.peer >= 0:
                # edge-narrowed degrade: a wire-level chaos primitive.
                # Repair re-weighting is rank-granular (repair.py's
                # degraded map keys ranks) — triggering it here would
                # down-weight the rank's HEALTHY edges too, so the
                # narrowed fault only feeds the deterministic wire
                # simulation (simulated_wire_factors -> the attribution
                # doctor's probes) and the record surfaces (note_fault
                # above already carries peer=). Single-edge topology
                # response is ROADMAP item 5's job.
                tl.timeline_record_instant(
                    f"elastic:degrade edge={fault.rank}->{fault.peer} "
                    f"factor={fault.factor:g}", "FAULT"
                )
            elif self.membership.mark_degraded(fault.rank, fault.factor,
                                               step):
                self._degrade_dirty = True
                tl.timeline_record_instant(
                    f"elastic:degrade rank={fault.rank} "
                    f"factor={fault.factor:g}", "FAULT"
                )
        elif fault.kind == "slow":
            # compute dilation: never a death verdict, never a repair
            # trigger — a slow rank is exactly the rank the async
            # engine must keep (its throughput cost stays its own);
            # the dilation feeds simulated_compute_dilation
            metrics_mod.counter("bluefog.elastic.slow_faults").inc()
            tl.timeline_record_instant(
                f"elastic:slow rank={fault.rank} "
                f"factor={fault.factor:g}", "FAULT"
            )
        elif fault.kind == "oom":
            # a simulated allocation failure: the memory observatory's
            # forensics (ranked census -> flight side table -> dump), then
            # the raise a real one gives; the dispatch of this step never
            # runs. No verdict and no repair: the fault is consumed, so a
            # retry proceeds past it.
            from bluefog_tpu_torch import memory as memory_mod

            metrics_mod.counter("bluefog.elastic.oom_faults").inc()
            tl.timeline_record_instant(f"elastic:oom rank={fault.rank}", "FAULT")
            memory_mod.on_oom(f"chaos:rank={fault.rank}",
                              "RESOURCE_EXHAUSTED: injected allocation failure")
            exc = memory_mod.SimulatedResourceExhausted(f"rank={fault.rank} step={step}")
            # the forensics ran: the memory excepthook must not count the
            # uncaught raise a second time
            exc._bf_oom_forensics_done = True
            raise exc

    # -- detection + repair --------------------------------------------------

    def _active_edges(self, optimizer) -> List[Tuple[int, int]]:
        """The directed edges the NEXT dispatch would put on the wire."""
        sched = getattr(optimizer, "schedule", None)
        if sched is not None:
            comm = getattr(optimizer, "_comm_count", 0)
            p = sched.plans[comm % sched.period]
            return [(s, d) for rnd in p.rounds for (s, d) in rnd.perm]
        topo = self.ctx.load_topology()
        if topo is None:
            return []
        # static topology: O(E) edge-list build cached per topo version
        # (per-step host work is hot-path noise, same rationale as the
        # window layer's default-spec cache)
        cached = self._edges_cache
        if cached is not None and cached[0] == self.ctx.topo_version:
            return cached[1]
        edges = topo_edges(topo)
        self._edges_cache = (self.ctx.topo_version, edges)
        return edges

    def _policy_for(self, optimizer) -> str:
        mode = getattr(optimizer, "mode", None)
        if mode == "push_sum":
            return "push_sum"
        if mode in ("put", "get"):
            # window buffers exist only for create-time neighbors, so the
            # repair must never ADD edges (the symmetrizing 'average'
            # policy would); 'receiver' only prunes and renormalizes
            return "receiver"
        return self.policy

    def before_dispatch(self, optimizer=None) -> int:
        """The per-step entry point: replay due faults, detect dead
        participants of the imminent dispatch, repair before it runs.
        Returns the membership epoch the dispatch executes under."""
        step = self.step
        # a USER set_topology since our last install becomes the new base
        # for future repairs — silently reverting it would train on a
        # topology the user explicitly replaced
        v = self.ctx.topo_version
        if v not in (self._installed_topo_version, self._base_topo_version):
            self._base_topo = self.ctx.load_topology()
            self._base_topo_version = v
        for fault in self.plan.due(step):
            if id(fault) not in self._applied:
                self._applied.add(id(fault))
                self._apply_fault(fault, step)

        edges = self._active_edges(optimizer)
        touched = {r for e in edges for r in e}
        repaired = False
        if (self._unrepaired and touched & set(self._unrepaired)) or (
            self._degrade_dirty and edges
        ):
            # the repair prunes EVERY dead rank from the topology, so all
            # of them count as detected now — popping only the touched
            # subset would strand the rest in _unrepaired with their
            # edges already gone (never touched again)
            self._repair(optimizer, dict(self._unrepaired), step)
            repaired = True

        # tripwire: nothing about to dispatch may reference a dead rank
        # (edge set only changed if a repair just ran — skip the second
        # O(E) walk on the no-fault fast path)
        post_edges = self._active_edges(optimizer) if repaired else edges
        dead = set(self.membership.dead_ranks())
        if any(r in dead for e in post_edges for r in e):
            self.stale_dispatches += 1
            logger.error(
                "elastic: dispatch at step %d still references dead ranks "
                "%s after repair", step, sorted(dead),
            )
        self._last_dispatch_ranks = tuple(
            sorted({r for e in post_edges for r in e})
        ) or self.membership.live_ranks()
        self.step += 1
        self._agree(optimizer, f"before the dispatch of step {step}")
        return self.membership.epoch

    # -- agreement across processes ------------------------------------------

    def _view(self, optimizer):
        """What every process must hold alike before a dispatch: the
        membership epoch, the live set, the topology version and the perms
        of the plan the next dispatch runs (a dynamic schedule's plan at
        the optimizer's communication index, else the static plan), the
        perms as the first 16 hex digits of their sha1."""
        sched = getattr(optimizer, "schedule", None)
        if sched is not None:
            perms = sched.plans[getattr(optimizer, "_comm_count", 0) % sched.period].perms
        elif self.ctx.load_topology() is not None:
            perms = self.ctx.static_plan().perms
        else:
            perms = ()
        digest = hashlib.sha1(repr(perms).encode()).hexdigest()[:16]
        return (self.membership.epoch, self.membership.live_ranks(),
                self.ctx.topo_version, digest)

    def _agree(self, optimizer, when: str) -> None:
        """Across processes: one ``all_gather_object`` of the queued
        watchdog verdicts and of :meth:`_view`; raises ``RuntimeError``
        naming the processes whose view differs from process 0's, else
        applies the union of the verdicts, in one order, in every process.
        With one process nothing runs."""
        if self.ctx.process_count == 1:
            return
        import torch.distributed as dist

        with self._queued_lock:
            queued, self._queued = self._queued, []
        views = [None] * self.ctx.process_count
        dist.all_gather_object(views, (self._view(optimizer), queued))
        differ = [p for p, (view, _q) in enumerate(views) if view != views[0][0]]
        if differ:
            raise RuntimeError(
                f"elastic: the processes disagree {when}: process 0 holds (epoch, live, "
                f"topology version, plan digest) = {views[0][0]!r}; processes {differ} hold "
                f"{[views[p][0] for p in differ]!r}. Every process must replay the same "
                "faults at the same step (the same BLUEFOG_FAULT_PLAN and inject calls)"
            )
        verdicts = sorted({v for _view, q in views for v in q})
        if verdicts:
            self._suspect(verdicts, "agreement")

    def _install_topology(self, optimizer, live, policy, degraded) -> None:
        """Build + install the repaired graph for ``live`` and re-point
        the optimizer at it — the one path both repair and rejoin go
        through, so a rank change can never update the topology but
        leave optimizer-side weights stale."""
        w = repair_mod.repaired_topology(
            self._base_topo, live, policy=policy, degraded=degraded
        )
        self.ctx.set_topology(w, is_weighted=True)
        self._installed_topo_version = self.ctx.topo_version
        sched = getattr(optimizer, "schedule", None)
        if sched is not None:
            optimizer.schedule = repair_mod.repair_schedule(
                sched, live, policy="receiver"
            )
        mode = getattr(optimizer, "mode", None)
        if mode in ("push_sum", "put", "get"):
            # window neighbor structure is create-time; the repaired
            # wire rides in as explicit per-rank weights (always a
            # subset of the create-time neighbors — these policies only
            # prune edges, never add)
            size = self.ctx.size
            if mode == "push_sum":
                optimizer.dst_weights = [
                    {
                        j: float(w[i, j])
                        for j in range(size)
                        if j != i and w[i, j] != 0.0
                    }
                    for i in range(size)
                ]
                optimizer.self_weight = [
                    float(w[i, i]) for i in range(size)
                ]
            elif mode == "put":
                # exchange ships at the default scale 1.0 to LIVE
                # out-neighbors only; the update combine re-resolves its
                # receiver weights from the installed repaired topology
                optimizer.dst_weights = [
                    {
                        j: 1.0
                        for j in range(size)
                        if j != i and w[i, j] != 0.0
                    }
                    for i in range(size)
                ]
            else:  # get: receiver-keyed pull spec over live in-neighbors
                optimizer.src_weights = [
                    {
                        i: 1.0
                        for i in range(size)
                        if i != j and w[i, j] != 0.0
                    }
                    for j in range(size)
                ]
        rebind(optimizer)

    def _repair(self, optimizer, pending: Dict[int, int], step: int) -> None:
        t0 = time.perf_counter()
        policy = self._policy_for(optimizer)
        live = self.membership.live_ranks()
        degraded = self.membership.degraded()
        detected = tuple(sorted(pending))
        steps_to_detect = {r: step - s for r, s in pending.items()}

        self._install_topology(optimizer, live, policy, degraded)

        for r in detected:
            self._unrepaired.pop(r, None)
        self._degrade_dirty = False

        record = RepairRecord(
            step=step,
            dead=self.membership.dead_ranks(),
            detected=detected,
            steps_to_detect=steps_to_detect,
            steps_to_repair=0,  # synchronous: repaired before the
            # detecting dispatch executes
            policy=policy,
            epoch=self.membership.epoch,
            live=live,
            topo_version=self.ctx.topo_version,
        )
        self.repairs.append(record)

        metrics_mod.counter("bluefog.elastic.repairs").inc()
        metrics_mod.gauge("bluefog.elastic.dead_ranks").set(
            len(record.dead)
        )
        metrics_mod.gauge("bluefog.elastic.epoch").set(record.epoch)
        if steps_to_detect:
            metrics_mod.gauge("bluefog.elastic.last_detect_steps").set(
                max(steps_to_detect.values())
            )
        metrics_mod.histogram("bluefog.elastic.repair_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
        tl.timeline_record_instant(
            f"elastic:repair step={step} dead={list(record.dead)} "
            f"policy={policy}", "REPAIR",
        )
        flight.record(
            "repair", step=step, dead=list(record.dead),
            live=list(live), policy=policy, epoch=record.epoch,
            topo_version=record.topo_version,
        )
        logger.warning(
            "elastic repair at step %d: dead=%s live=%s policy=%s "
            "(topology v%d)", step, list(record.dead), list(live), policy,
            record.topo_version,
        )

    # -- controller migration ------------------------------------------------

    def adopt_topology(self, topo, optimizer=None) -> None:
        """Adopt a new BASE topology (a weight matrix) mid-run — the
        topology controller's migration path
        (:mod:`bluefog_tpu_torch.autotune` calls it for a swap and for a
        rollback). The given matrix becomes the base future
        repairs (and rejoins) compute from, and what is INSTALLED now
        is its repair to the *current* live set through the same
        prune + renormalize + ``set_topology`` path a failure repair
        takes — so a controller migration can never update the
        topology but leave optimizer-side weights stale, and a later
        rejoin restores the NEW base's edges, not the pre-migration
        graph's."""
        self._base_topo = np.asarray(topo, dtype=np.float64)
        self._install_topology(
            optimizer,
            self.membership.live_ranks(),
            self._policy_for(optimizer),
            self.membership.degraded(),
        )
        metrics_mod.counter("bluefog.elastic.migrations").inc()
        tl.timeline_record_instant(
            f"elastic:migrate step={self.step} "
            f"(topology v{self.ctx.topo_version})", "REPAIR",
        )
        flight.record(
            "migrate", step=self.step,
            live=list(self.membership.live_ranks()),
            topo_version=self.ctx.topo_version,
        )

    # -- rejoin --------------------------------------------------------------

    def rejoin(self, rank: int, params=None, optimizer=None):
        """Re-admit ``rank``: restore the base topology's edges for the
        new live set and (optionally) overwrite its parameter slot with
        the survivors' consensus. Returns the (possibly) updated
        ``params``."""
        survivors = self.membership.live_ranks()
        if not self.membership.revive(rank, self.step):
            return params
        self._unrepaired.pop(rank, None)
        live = self.membership.live_ranks()
        self._install_topology(
            optimizer, live, self._policy_for(optimizer),
            self.membership.degraded(),
        )
        metrics_mod.counter("bluefog.elastic.rejoins").inc()
        metrics_mod.gauge("bluefog.elastic.dead_ranks").set(
            len(self.membership.dead_ranks())
        )
        tl.timeline_record_instant(f"elastic:rejoin rank={rank}", "REPAIR")
        self._agree(optimizer, f"after the rejoin of rank {rank}")
        if params is not None:
            params = consensus_restore(params, rank, survivors)
        return params

    def adopt_live_set(self, live: Sequence[int], optimizer=None) -> None:
        """Force membership to an externally recorded live set (the
        checkpoint-restore repair path): ranks absent from ``live`` are
        condemned, ranks present but currently dead are revived (the
        checkpoint's membership is the source of truth for the state
        being loaded), and the topology is repaired to match."""
        live = set(int(r) for r in live)
        changed = False
        for r in range(self.ctx.size):
            if r not in live:
                if self.membership.mark_dead(
                    r, "checkpoint live set", self.step
                ):
                    self._unrepaired[r] = self.step
                    changed = True
            elif not self.membership.is_live(r):
                if self.membership.revive(r, self.step):
                    self._unrepaired.pop(r, None)
                    changed = True
        if changed:
            self._repair(
                optimizer,
                {r: s for r, s in self._unrepaired.items()},
                self.step,
            )
        self._agree(optimizer, "after adopting a recorded live set")


class ElasticGuard:
    """Thin wrapper binding an optimizer to a session: every dispatch
    goes through :meth:`ElasticSession.before_dispatch` first."""

    def __init__(self, session: ElasticSession, optimizer):
        self.session = session
        self.optimizer = optimizer

    def step(self, *args, **kwargs):
        """Gossip-family signature ``step(params, opt_state, grads)``;
        window-family ``step(opt_state, grads)`` — forwarded verbatim."""
        self.session.before_dispatch(self.optimizer)
        return self.optimizer.step(*args, **kwargs)

    def make_train_step(self, loss_fn, has_aux: bool = False,
                        delayed: bool = False):
        inner = self.optimizer.make_train_step(
            loss_fn, has_aux=has_aux, delayed=delayed
        )

        def train_step(params, opt_state, *batch):
            self.session.before_dispatch(self.optimizer)
            return inner(params, opt_state, *batch)

        return train_step
