# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Asynchronous push-sum gossip: :func:`make_async_train_step`.

Counterpart of ``bluefog_tpu/async_gossip.py``. Each rank trains at its own
cadence, pushes weighted parameter mass into its out-neighbours' window
buffers and folds whatever mass has arrived, so a rank never waits on a
peer and a 10x straggler costs only its own share of the fleet's steps.

The engine runs on a virtual **tick** clock over the stacked workers.
Each tick:

1. ranks *due* this tick (``tick % period == 0``) take the gradient of
   ``loss_fn`` at the push-sum estimate ``z = x / p`` and apply the inner
   optimizer's update to the raw window mass ``x`` (the accumulated-p
   recursion of :func:`~bluefog_tpu_torch.optimizers.DistributedPushSumOptimizer`);
2. every rank pushes through :func:`bluefog_tpu_torch.windows._exchange_core`
   in ``'acc'`` mode with the p lane on, under column-stochastic weights
   masked in the operands: a rank that is not due has zero edge weights,
   self weight 1 and sent mass 0. On a quantized wire the sender keeps
   the residual of what it shipped, so sender mass is conserved exactly
   on every tier; on the int8/int4 wires the payload goes through the
   CUDA ``encode`` and ``decode`` kernels on the card;
3. each due rank folds the buffer slots the bounded-staleness gate admits
   (``v += sum_k fold_w[k] * buffer_k``, the p lane alike) and those slots
   are zeroed; mass left unfolded stays pending, never discarded.

A rank that sits a tick out passes its window value, p, momentum and any
module buffers its loss updates (BatchNorm statistics) through bitwise
unchanged: its gradient is never taken. It reports its loss (and aux) at
the current estimate on this tick's batch, as the JAX engine does: one
forward without a gradient, after which the rank's rows of the module
buffers named by ``buffers=`` are put back. A loss that updates state in
place must name it there (for a
:class:`~bluefog_tpu_torch.models.StackedModel`, ``buffers=sm.buffers``);
a bound ``worker_loss`` of a model with batch statistics given without it
is refused.

**Bounded staleness.** The gate reads the host age lane
(:func:`bluefog_tpu_torch.windows.get_win_age`). An in-edge whose buffer is
older than ``BLUEFOG_ASYNC_MAX_AGE`` local window steps is, per
``BLUEFOG_ASYNC_STALE_POLICY``, dropped from this fold (``drop``, the
default: its mass stays pending) or makes its receiver sit the tick out
(``throttle``). Either way an ``async_staleness``
:class:`~bluefog_tpu_torch.attribution.Advisory` naming the stale edges,
and so the slow rank, goes to ``engine.advisories``.

**Wire tiers** (``wire=`` or ``BLUEFOG_ASYNC_WIRE``, default the
optimizer's ``compression``): ``fp32`` (exact), ``bf16``, ``int8``,
``int4``, and ``int8_ef``/``int4_ef``, which map to ``int8``/``int4``: the
sender's residual absorption already feeds the quantization error back.

**Async off** (``BLUEFOG_ASYNC=0`` or ``enabled=False``):
:func:`make_async_train_step` returns ``opt.make_train_step(loss_fn)``
itself.

**Observability**, as in the JAX engine: every tick counts
``bluefog.async.ticks``, ``.local_steps`` and ``.wire_bytes``, sets
``.participants``, observes each in-edge's age in the ``bluefog.async.age``
histogram and ``.age_max``, and leaves an ``async_tick`` flight record; the
gate counts ``.throttled`` and ``.stale_drops``, a re-window
``.rewindows``; an advisory counts ``bluefog.doctor.advisory.<kind>``, sets
``bluefog.doctor.last_advisory_step`` and goes to the flight recorder and
the timeline. The tick's work runs inside ``watchdog.watch("async_fold:
<window>")`` as an ``async_tick`` timeline span. The exchange's rounds
follow ``BLUEFOG_PLAN_METHOD``.

**Elastic** (:mod:`bluefog_tpu_torch.elastic`), as in the JAX engine: with
a session open, each tick first runs ``session.before_dispatch(engine)``
(fault replay and repair; ``mode = "push_sum"`` makes the repair install its
mass-conserving weights on the engine's ``self_weight`` and
``dst_weights``); a ``slow`` fault multiplies its rank's period by
``ceil(factor)``; a dead rank never takes part; and on a change of the live
set the engine re-windows: the estimate ``x / p`` becomes the new mass with
``p = 1``, counting ``bluefog.async.rewindows``.

**Across processes** (a context whose ``process_count > 1``) the window
holds this process's rows (:mod:`bluefog_tpu_torch.windows`). The periods,
the due mask, the gate, the ages and the advisories are computed on the
global host lanes, equally in every process; the local step, the sat-out
losses and the fold run on the local rows; the exchange is the window
layer's route under the masked weights (a rank that is not due ships its
zero-weighted rows still, as the stacked gather reads them, so the rows
stay bitwise the stacked ones). The loss is ``[n_local]``;
:meth:`AsyncGossipEngine.summary`'s counts come from the global masks, so
they are the fleet's in every process. An elastic session runs there
too: every process replays the same faults and agrees before each tick,
and a re-window divides the local rows by their p and rebuilds the window
from the global live set in every process. The staleness observatory's
``async`` surface reads the host age lane, which is global, so its ages
are the fleet's in every process.

After each tick the window goes to the staleness observatory under
``surface="async"`` (:func:`bluefog_tpu_torch.staleness.observe_window`):
the ages it folds are the ones the gate read. The engine's
:meth:`AsyncGossipEngine.summary` is the ``async`` block of the health
plane's ``/fleet`` report (:mod:`bluefog_tpu_torch.health`). While an
engine is live, the topology controller's decision records carry
``async_mode`` (:func:`bluefog_tpu_torch.autotune._async_mode` reads
:func:`active`).
"""

import collections
import itertools
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import flight, metrics, watchdog
from bluefog_tpu_torch import staleness as stal_mod
from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch import windows as win_mod
from bluefog_tpu_torch.attribution import Advisory
from bluefog_tpu_torch.logging_util import env_int
from bluefog_tpu_torch.collective.ops import _enqueue
from bluefog_tpu_torch.optimizers import (
    _grad_store,
    _tree_unflatten,
    _worker_loss_grad,
    tree_leaves,
)

__all__ = [
    "AsyncGossipEngine",
    "make_async_train_step",
    "async_enabled",
    "async_max_age",
    "async_stale_policy",
    "async_wire",
    "active",
    "on_init",
    "on_shutdown",
]

ENABLE_ENV = "BLUEFOG_ASYNC"
MAX_AGE_ENV = "BLUEFOG_ASYNC_MAX_AGE"
POLICY_ENV = "BLUEFOG_ASYNC_STALE_POLICY"
WIRE_ENV = "BLUEFOG_ASYNC_WIRE"

_POLICIES = ("drop", "throttle")

# ticks an edge's advisory stays muted after it fires: a persistently
# stale edge does not file one advisory per tick
BREACH_COOLDOWN = 8

def async_enabled() -> bool:
    """The kill switch ``BLUEFOG_ASYNC`` (default on)."""
    return os.environ.get(ENABLE_ENV, "1").lower() not in ("0", "false", "off", "no")


def async_max_age() -> int:
    """The staleness bound in local window steps (``BLUEFOG_ASYNC_MAX_AGE``,
    default 8, at least 1)."""
    return max(1, env_int(MAX_AGE_ENV, 8))


def async_stale_policy() -> str:
    """``BLUEFOG_ASYNC_STALE_POLICY``: ``drop`` (default) or ``throttle``."""
    p = os.environ.get(POLICY_ENV, "drop").strip().lower()
    if p not in _POLICIES:
        raise ValueError(f"{POLICY_ENV} must be one of {_POLICIES}, got {p!r}")
    return p


def async_wire(requested: Optional[str] = None) -> Optional[str]:
    """The window wire of a wire tier (``requested``, else
    ``BLUEFOG_ASYNC_WIRE``): ``None`` for exact, ``'bf16'``, ``'int8'`` or
    ``'int4'``; ``int8_ef``/``int4_ef`` map to ``int8``/``int4``."""
    w = (requested if requested is not None else os.environ.get(WIRE_ENV, "")).strip().lower()
    if w in ("", "0", "off", "none", "fp32", "f32", "exact"):
        return None
    if w in ("int8_ef", "int4_ef"):
        return w[:4]
    if w in ("bf16", "int8", "int4"):
        return w
    raise ValueError(
        "async wire must be one of fp32/bf16/int8/int4/int8_ef/int4_ef "
        f"(or unset for exact), got {w!r}"
    )


def _runs(rows) -> List[Tuple[int, int]]:
    """Sorted row indices as ``[(start, end), ...]`` runs of consecutive
    rows."""
    out: List[Tuple[int, int]] = []
    for r in rows:
        if out and out[-1][1] == r:
            out[-1] = (out[-1][0], r + 1)
        else:
            out.append((int(r), int(r) + 1))
    return out


def _rows_of(tree, a: int, b: int):
    """The tree of rows ``a:b`` of every leaf (views)."""
    return _tree_unflatten(tree, [leaf[a:b] for leaf in tree_leaves(tree)])


_engine_uid = itertools.count()


class AsyncGossipEngine:
    """One asynchronous gossip lane over a combo push-sum window; built by
    :func:`make_async_train_step` and driven through its callable.
    ``mode = "push_sum"`` is the contract with the elastic repair: it
    installs its renormalized sender weights on ``dst_weights`` and
    ``self_weight``, as on the push-sum window optimizer."""

    mode = "push_sum"

    def __init__(self, opt, loss_fn, has_aux: bool = False,
                 cadence: Optional[Dict[int, int]] = None,
                 max_age: Optional[int] = None,
                 policy: Optional[str] = None,
                 wire: Optional[str] = None,
                 buffers=None):
        self._uid = next(_engine_uid)
        self.opt = opt
        self.loss_fn = loss_fn
        self.has_aux = bool(has_aux)
        self.buffers = _buffer_list(loss_fn, buffers)
        self.cadence = {int(r): int(p) for r, p in (cadence or {}).items()}
        for r, p in self.cadence.items():
            if p < 1:
                raise ValueError(f"cadence period for rank {r} must be >= 1, got {p}")
        if max_age is None:
            self.max_age = async_max_age()
        else:
            self.max_age = int(max_age)
            if self.max_age < 1:
                raise ValueError(f"max_age must be >= 1 local window steps, got {max_age!r}")
        self.policy = policy if policy is not None else async_stale_policy()
        if self.policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {self.policy!r}")
        # wire: explicit argument, then the env, then the optimizer's compression
        if wire is None and not os.environ.get(WIRE_ENV, "").strip():
            wire = getattr(opt, "compression", None)
        self.wire = async_wire(wire)
        self.wire_name = (wire or os.environ.get(WIRE_ENV, "") or "fp32").strip().lower() or "fp32"
        # explicit push weights, as on the window optimizers; an elastic
        # repair installs its push-sum weights here
        self.self_weight = None
        self.dst_weights = None
        self._name = f"_async{self._uid}.combo"
        self._win_sig = None  # (aval sig, live token) at creation
        self._win_slots: Optional[tuple] = None  # create-time in-neighbors
        self._template = None
        self._slots = None  # [(start, end, shape, dtype)] per leaf
        self._pack_dtype = None
        self._tick = 0
        self._local_steps = 0
        self._throttled = 0
        self._stale_drops = 0
        self._rewindows = 0
        self._default_dst = None
        self._default_sw = None
        self._default_topo_v = None
        self._breach_mutes: Dict[Tuple[int, int], int] = {}
        self.advisories: Any = collections.deque(maxlen=256)
        self._advisory_total = 0
        self._grads: List[torch.Tensor] = []
        self._losses: Optional[torch.Tensor] = None  # [N]: each rank's loss this tick
        self._auxes: List[Any] = []

    # -- packing ----------------------------------------------------------------

    def _prepare_layout(self, ctx, params) -> None:
        leaves = tree_leaves(params)
        for i, leaf in enumerate(leaves):
            if leaf.dim() < 1 or leaf.shape[0] != ctx.n_local:
                raise ValueError(
                    f"async parameter leaf {i} must be worker-stacked "
                    f"[{ctx.n_local}, ...]; got shape {tuple(leaf.shape)}"
                )
            if not leaf.dtype.is_floating_point:
                raise TypeError(
                    f"async parameter leaf {i} has dtype {leaf.dtype}: the "
                    "push-sum lane packs every leaf into one float combo "
                    "window (integer state would round-trip through float "
                    "each tick)"
                )
        pack_dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            pack_dtype = torch.promote_types(pack_dtype, leaf.dtype)
        self._pack_dtype = pack_dtype
        self._template = _tree_unflatten(params, [None] * len(leaves))
        self._slots, off = [], 0
        for leaf in leaves:
            n = leaf[0].numel()
            self._slots.append((off, off + n, tuple(leaf.shape[1:]), leaf.dtype))
            off += n

    def _pack(self, leaves, size: int) -> torch.Tensor:
        return torch.cat([leaf.reshape(size, -1).to(self._pack_dtype) for leaf in leaves], dim=1)

    def _leaf_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Per-leaf views ``[rows, *shape]`` of a ``[rows, D]`` tensor."""
        return [flat[:, a:b].view((flat.shape[0],) + shape) for a, b, shape, _ in self._slots]

    def _tree(self, flat: torch.Tensor):
        """The parameter tree of a ``[N, D]`` combo tensor, each leaf in its
        own dtype."""
        return _tree_unflatten(self._template, [
            v.to(dtype) for v, (_a, _b, _s, dtype) in zip(self._leaf_views(flat), self._slots)
        ])

    # -- window lifecycle -------------------------------------------------------

    @staticmethod
    def _aval_sig(params):
        return tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in tree_leaves(params))

    def _topology_fits_window(self, ctx) -> bool:
        """Every in-edge of the current topology has a create-time slot."""
        if self._win_slots is None:
            return False
        return all(set(srcs) <= set(self._win_slots[r])
                   for r, srcs in enumerate(ctx.in_neighbor_ranks()))

    def _ensure_window(self, ctx, params) -> None:
        sig = (self._aval_sig(params), ctx.live_token())
        win = ctx.windows.get(self._name)
        if win is not None and self._win_sig == sig and self._topology_fits_window(ctx):
            return
        if win is None or self._win_sig is None or self._win_sig[0] != sig[0]:
            # first creation or a parameter-shape change: the window mass is
            # seeded from the given params, p = 1
            self._prepare_layout(ctx, params)
            packed = self._pack(tree_leaves(params), ctx.n_local)
        else:
            # a change of the live set, or a topology the window cannot
            # carry: the current estimate x / p becomes the new mass with
            # p = 1, so the mass accounting restarts over the live set
            packed = win.value / win.p[:, None].to(win.value.dtype)
            self._rewindows += 1
            metrics.counter("bluefog.async.rewindows").inc()
        win_mod.win_free(self._name)
        created = win_mod.win_create(packed, self._name, zero_init=True)
        assert created, f"window {self._name} already exists"
        self._win_sig = sig
        self._win_slots = win_mod._get_win(ctx, self._name).in_neighbors
        self._default_topo_v = None

    def free(self) -> None:
        """Drop the engine's window and its gradient buffers."""
        if ctx_mod.is_initialized():
            win_mod.win_free(self._name)
        self._win_sig = None
        self._win_slots = None
        self._grads = []

    def params(self):
        """The current push-sum estimate ``x / p`` as the parameter tree."""
        win = win_mod._get_win(ctx_mod.get_context(), self._name)
        return self._tree(win.value / win.p[:, None].to(win.value.dtype))

    # -- cadence and the staleness gate ---------------------------------------------

    def _periods(self, ctx, session=None) -> np.ndarray:
        """Per-rank local-step period on the tick clock: ``cadence``, times
        ``ceil(factor)`` of an active ``slow`` fault of the elastic
        ``session`` (:meth:`~bluefog_tpu_torch.elastic.ElasticSession.simulated_compute_dilation`)."""
        periods = np.ones(ctx.size, np.int64)
        for r, p in self.cadence.items():
            if 0 <= r < ctx.size:
                periods[r] = p
        if session is not None:
            for r, f in session.simulated_compute_dilation().items():
                if 0 <= r < ctx.size:
                    periods[r] *= max(1, int(np.ceil(f)))
        return periods

    @staticmethod
    def _slot_ages(win) -> np.ndarray:
        """``[size, max(max_deg, 1)]`` local-step age of each buffer slot,
        -1 where there is no slot."""
        ages = np.full((len(win.in_neighbors), max(win.max_deg, 1)), -1, np.int64)
        clock = int(win.clock)
        for r, srcs in enumerate(win.in_neighbors):
            for k in range(len(srcs)):
                ages[r, k] = clock - int(win.slot_written[r, k])
        return ages

    def _gate(self, ctx, win, participating, ages):
        """The bounded-staleness policy: ``(participating, fold_mask [size,
        max(max_deg, 1)] bool, breached (src, dst) edges)``; an edge counts
        as breached only where its receiver is due, the gate acting on it."""
        size = ctx.size
        max_deg = max(win.max_deg, 1)
        slot_exists = np.zeros((size, max_deg), bool)
        stale = np.zeros((size, max_deg), bool)
        for r, srcs in enumerate(win.in_neighbors):
            for k in range(len(srcs)):
                slot_exists[r, k] = True
                stale[r, k] = ages[r, k] > self.max_age
        participating = participating.copy()
        breached = [
            (int(s), int(r))
            for r, srcs in enumerate(win.in_neighbors)
            for k, s in enumerate(srcs)
            if stale[r, k] and participating[r]
        ]
        if self.policy == "throttle":
            throttle_rows = stale.any(axis=1) & participating
            self._throttled += int(throttle_rows.sum())
            if throttle_rows.any():
                metrics.counter("bluefog.async.throttled").inc(int(throttle_rows.sum()))
            participating &= ~throttle_rows
            fold_mask = slot_exists & participating[:, None]
        else:
            fold_mask = slot_exists & participating[:, None] & ~stale
            drops = int((stale & participating[:, None]).sum())
            if drops:
                self._stale_drops += drops
                metrics.counter("bluefog.async.stale_drops").inc(drops)
        return participating, fold_mask, breached

    def _decay_mutes(self) -> None:
        """Advance the advisory mutes by one tick."""
        for k in list(self._breach_mutes):
            self._breach_mutes[k] -= 1
            if self._breach_mutes[k] <= 0:
                del self._breach_mutes[k]

    def _advise(self, ctx, ages_by_edge: Dict[Tuple[int, int], int],
                breached: List[Tuple[int, int]]) -> None:
        """File an ``async_staleness`` advisory for the breached edges not
        muted, naming them and their source ranks."""
        fresh = [e for e in breached if e not in self._breach_mutes]
        if not fresh:
            return
        for e in fresh:
            self._breach_mutes[e] = BREACH_COOLDOWN
        fresh.sort(key=lambda e: (-ages_by_edge.get(e, 0), e))
        adv = Advisory(
            kind="async_staleness", step=self._tick,
            detail={
                "edges": [[int(s), int(d)] for s, d in fresh[:8]],
                "ages": {f"{s}->{d}": int(ages_by_edge.get((s, d), 0)) for s, d in fresh[:8]},
                "slow_ranks": sorted({int(s) for s, _d in fresh}),
                "bound": self.max_age,
                "policy": self.policy,
                "action": ("dropped_from_fold" if self.policy == "drop"
                           else "throttled_receivers"),
                "surface": "async",
                "topo_version": int(ctx.topo_version),
            },
        )
        self.advisories.append(adv)
        self._advisory_total += 1
        metrics.counter(f"bluefog.doctor.advisory.{adv.kind}").inc()
        metrics.gauge("bluefog.doctor.last_advisory_step").set(adv.step)
        flight.note_advisory(kind=adv.kind, step=adv.step, **adv.detail)
        tl.timeline_record_advisory(adv.kind, adv.detail)

    # -- weights --------------------------------------------------------------------

    def _exchange_weights(self, ctx, win):
        """``(w_edges [size, size], self_vec [size])``: the explicit push
        weights, or the uniform column-stochastic split over self and the
        current topology's out-neighbours, cached per topology version."""
        size = ctx.size
        if self._default_topo_v != ctx.topo_version:
            self._default_dst = self._default_sw = None
            self._default_topo_v = ctx.topo_version
        if (self.dst_weights is None or self.self_weight is None) and self._default_dst is None:
            outs = ctx.out_neighbor_ranks()
            self._default_dst = [{d: 1.0 / (len(outs[r]) + 1) for d in outs[r]}
                                 for r in range(size)]
            self._default_sw = [1.0 / (len(outs[r]) + 1) for r in range(size)]
        dst = self.dst_weights if self.dst_weights is not None else self._default_dst
        sw = self.self_weight if self.self_weight is not None else self._default_sw
        w, participating = win_mod._per_rank_edges(ctx, dst, win.out_neighbors, "dst_weights")
        return w, win_mod._self_weight_vec(ctx, sw, participating)

    # -- the tick -------------------------------------------------------------------

    def _local_step(self, win, opt_state, batch, due: np.ndarray) -> None:
        """The due ranks' gradients at ``x / p`` and the inner update of
        their raw mass rows (in place); the other rows are not touched.
        ``due`` holds rows of the window's lanes (the local rows)."""
        est = self._tree(win.value / win.p[:, None].to(win.value.dtype))
        store = _grad_store(est, self._grads)
        if self._losses is None or self._losses.device != win.value.device:
            self._losses = torch.zeros(win.value.shape[0], dtype=torch.float32,
                                       device=win.value.device)
            self._auxes = [None] * win.value.shape[0]
        for j in due:
            self._losses[j], self._auxes[j] = _worker_loss_grad(
                self.loss_fn, self.has_aux, est, batch, int(j), store)
        self._sat_out_losses(est, batch, sorted(set(range(win.value.shape[0])) - set(due.tolist())))
        del est
        grads = _tree_unflatten(self._template, store)
        for a, b in _runs(due):
            views = self._leaf_views(win.value[a:b])
            cur = [v.to(dtype) for v, (_a, _b, _s, dtype) in zip(views, self._slots)]
            self.opt.tx.apply_(_tree_unflatten(self._template, cur),
                               _rows_of(opt_state, a, b), _rows_of(grads, a, b))
            for view, c in zip(views, cur):
                if c.data_ptr() != view.data_ptr():
                    view.copy_(c)

    def _sat_out_losses(self, est, batch, rows) -> None:
        """The loss (and aux) of each rank in ``rows`` at the estimate on
        this tick's batch, without a gradient; the rank's rows of the
        ``buffers`` are restored afterwards."""
        if not rows:
            return
        bufs = self.buffers
        for j in rows:
            saved = [b[j].clone() for b in bufs]
            with torch.no_grad():
                out = self.loss_fn(
                    _tree_unflatten(est, [leaf[j] for leaf in tree_leaves(est)]),
                    *(_tree_unflatten(b, [t[j] for t in tree_leaves(b)]) for b in batch))
            for b, v in zip(bufs, saved):
                b[j].copy_(v)
            loss, aux = out if self.has_aux else (out, None)
            self._losses[j] = loss.detach()
            if self.has_aux:
                aux = _tree_unflatten(aux, [t.detach() for t in tree_leaves(aux)])
            self._auxes[j] = aux

    def _fold(self, win, fold_mask: np.ndarray) -> None:
        """Fold the admitted slots into the value and p, zero them and clear
        their versions (``fold_mask`` the lanes' rows)."""
        k_max = win.max_deg
        if not k_max:
            return
        dev = win.value.device
        kw = win_mod._f32(fold_mask[:, :k_max].astype(np.float64), dev)
        keep = 1.0 - kw
        win.value = win.value + win_mod._slot_dot(kw.to(win.value.dtype), win.buffers, k_max)
        win.buffers.mul_(keep.to(win.buffers.dtype).view(keep.shape + (1,) * (win.buffers.dim() - 2)))
        win.p = win.p + win_mod._slot_dot(kw.to(win.p.dtype), win.p_buffers, k_max)
        win.p_buffers = win.p_buffers * keep.to(win.p_buffers.dtype)
        win.versions = torch.where(kw > 0, torch.zeros_like(win.versions), win.versions)

    def step(self, params, opt_state, *batch):
        """One tick: the due ranks take a local step and push; they fold
        what the staleness gate admits. Returns ``(params estimate,
        opt_state, loss [N])`` (``(loss, aux)`` with ``has_aux``); a rank
        that sat out reports its loss at the estimate on this tick's batch.
        ``params`` seeds
        the window on the first call (and after a shape change); after
        that the window is the state and the returned estimate is what the
        next call is given. ``opt_state`` is updated in place."""
        from bluefog_tpu_torch import elastic

        ctx = ctx_mod.get_context()
        session = elastic.active_session()
        if session is not None:
            # fault replay and repair before the window and weights are
            # resolved: a repair this tick shapes this tick's exchange
            session.before_dispatch(self)
        self._ensure_window(ctx, params)
        win = win_mod._get_win(ctx, self._name)

        live = np.ones(ctx.size, bool)
        if session is not None:
            live[:] = False
            live[list(session.membership.live_ranks())] = True
        participating = live & (self._tick % self._periods(ctx, session) == 0)
        ages = self._slot_ages(win)
        self._decay_mutes()
        participating, fold_mask, breached = self._gate(ctx, win, participating, ages)
        ages_by_edge = {(int(s), int(r)): int(ages[r, k])
                        for r, srcs in enumerate(win.in_neighbors)
                        for k, s in enumerate(srcs)}
        if breached:
            self._advise(ctx, ages_by_edge, breached)
        if ages_by_edge:  # the gate computed the ages anyway
            hist = metrics.histogram("bluefog.async.age")
            for a in ages_by_edge.values():
                hist.observe(a)
            metrics.gauge("bluefog.async.age_max").set(float(max(ages_by_edge.values())))

        w_edges, self_vec = self._exchange_weights(ctx, win)
        # a rank that is not due: zero edge weights, self weight 1, sent 0
        w_masked = w_edges * participating[:, None]
        self_masked = np.where(participating, self_vec, 1.0)
        sent_masked = w_masked.sum(axis=1)
        low = win_mod._lowered_exchange(ctx, win, w_edges)
        flight.record("async_tick", tick=self._tick, participants=int(participating.sum()))
        # the tick's host blocking point: a hung fold is what the watchdog sees
        with watchdog.watch(f"async_fold:{self._name}"):
            written = _enqueue("async_tick", self._tick_work, win, opt_state, batch,
                               participating, fold_mask, low, w_masked, self_masked,
                               sent_masked, ctx.device)
        win_mod._note_async_tick(win, written, fold_mask)

        n_part = int(participating.sum())
        self._local_steps += n_part
        metrics.counter("bluefog.async.ticks").inc()
        metrics.counter("bluefog.async.local_steps").inc(n_part)
        metrics.gauge("bluefog.async.participants").set(n_part)
        n_elems = int(np.prod(win.shape)) if win.shape else 1
        metrics.counter("bluefog.async.wire_bytes").inc(metrics.wire_bytes_per_step(
            {win.dtype.itemsize: n_elems}, len(low.perms), self.wire))
        stal_mod.observe_window(ctx, win, step=self._tick, surface="async")
        self._tick += 1
        out = self.params()
        loss = self._losses.clone()
        if self.has_aux:
            aux = _tree_unflatten(self._auxes[0], [
                torch.stack(ts) for ts in zip(*(tree_leaves(a) for a in self._auxes))])
            return out, opt_state, (loss, aux)
        return out, opt_state, loss

    def _tick_work(self, win, opt_state, batch, participating, fold_mask, low, w_masked,
                   self_masked, sent_masked, dev):
        """The tick's work: the due ranks' local step, the exchange and the
        fold; returns the slots written (global)."""
        ctx = ctx_mod.get_context()
        rows = slice(ctx.rows.start, ctx.rows.stop)
        self._local_step(win, opt_state, batch, np.nonzero(participating[rows])[0])

        vers_before = win.versions
        win.value, win.buffers, vers, win.p, win.p_buffers = win_mod._exchange_core(
            "acc", low, True, win.max_deg,
            win.value, win.buffers, win.versions, win.p, win.p_buffers, win.value,
            win_mod._f32(win_mod._round_weights(low.perms, w_masked)[:, rows], dev),
            win_mod._f32(self_masked[rows], dev),
            wire=self.wire, sent_w=win_mod._f32(sent_masked[rows], dev),
        )
        # versions count only the writes of senders that took part
        written = np.zeros_like(fold_mask)
        for r, srcs in enumerate(win.in_neighbors):
            for k, s in enumerate(srcs):
                written[r, k] = participating[s]
        if win.max_deg:
            gate = torch.from_numpy(written[rows, :win.max_deg].astype(np.int32)).to(dev)
            win.versions = vers_before + (vers - vers_before) * gate
        self._fold(win, fold_mask[rows])
        return written

    def summary(self) -> dict:
        """The engine's counters and settings (the fleet's in every process:
        they count the global masks)."""
        return {
            "ticks": self._tick,
            "local_steps": self._local_steps,
            "throttled": self._throttled,
            "stale_drops": self._stale_drops,
            "rewindows": self._rewindows,
            "advisories": self._advisory_total,
            "policy": self.policy,
            "wire": self.wire_name,
            "max_age": self.max_age,
            "cadence": {str(r): int(p) for r, p in sorted(self.cadence.items())},
        }


# -- the engine registry ---------------------------------------------------------

_active: Optional[AsyncGossipEngine] = None


def active() -> Optional[AsyncGossipEngine]:
    """The most recently built engine of this context, or None."""
    return _active


def on_init(ctx) -> None:
    """``init`` hook: a new context does not inherit an engine whose window
    died with the old one."""
    global _active
    _active = None


def on_shutdown() -> None:
    global _active
    _active = None


def _buffer_list(loss_fn, buffers) -> List[torch.Tensor]:
    """The ``[N, ...]`` tensors ``loss_fn`` updates in place, from a dict or
    a sequence; a bound ``StackedModel.worker_loss`` of a model with batch
    statistics must name them."""
    from bluefog_tpu_torch.models.stacked import StackedModel

    if buffers is None:
        owner = getattr(loss_fn, "__self__", None)
        if isinstance(owner, StackedModel) and owner.buffers:
            raise ValueError(
                "loss_fn is a StackedModel's worker_loss and the model has batch "
                "statistics: pass buffers=model.buffers, so that a rank that sits "
                "a tick out keeps its statistics"
            )
        return []
    out = list(buffers.values()) if isinstance(buffers, dict) else list(buffers)
    if not all(isinstance(b, torch.Tensor) for b in out):
        raise TypeError("buffers must be a dict or a sequence of [N, ...] tensors")
    return out


def make_async_train_step(opt, loss_fn, has_aux: bool = False,
                          cadence: Optional[Dict[int, int]] = None,
                          max_age: Optional[int] = None,
                          policy: Optional[str] = None,
                          wire: Optional[str] = None,
                          enabled: Optional[bool] = None,
                          buffers=None):
    """The asynchronous train step over the gossip-family optimizer
    ``opt`` (its inner optimizer makes the local updates, its
    ``compression`` is the default wire)::

        step = bft.make_async_train_step(opt, loss_fn, cadence={6: 10})
        params, opt_state, loss = step(params, opt_state, *batch)

    Each call is one tick (see the module docstring); ``cadence`` maps a
    rank to its period in ticks (default 1). ``loss_fn(params, *batch)``
    runs per worker on unstacked trees, as in
    :meth:`~bluefog_tpu_torch.optimizers._GossipOptimizer.make_train_step`.
    ``buffers`` (a dict or a sequence of ``[N, ...]`` tensors, such as
    ``StackedModel.buffers``) is the state ``loss_fn`` updates in place: a
    rank that sits a tick out gets its rows back after its loss is taken.
    The callable's ``engine`` attribute is the :class:`AsyncGossipEngine`.
    Across processes the trees and ``buffers`` are the local rows and the
    returned loss ``[n_local]`` (see the module docstring).
    With async off (``enabled=False`` or ``BLUEFOG_ASYNC=0``) this returns
    ``opt.make_train_step(loss_fn, has_aux=has_aux)``."""
    on = async_enabled() if enabled is None else bool(enabled)
    if not on:
        return opt.make_train_step(loss_fn, has_aux=has_aux)
    global _active
    engine = AsyncGossipEngine(opt, loss_fn, has_aux=has_aux, cadence=cadence,
                               max_age=max_age, policy=policy, wire=wire, buffers=buffers)
    _active = engine

    def train_step(params, opt_state, *batch):
        return engine.step(params, opt_state, *batch)

    train_step.engine = engine
    return train_step
