# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Decentralized optimizers over stacked worker tensors.

Counterpart of ``bluefog_tpu/optimizers.py`` for two families:

- the gossip family, one engine (:class:`_GossipOptimizer`) behind six
  factories: gradient allreduce (:func:`DistributedGradientAllreduceOptimizer`),
  weight allreduce (:func:`DistributedAllreduceOptimizer`), neighbor
  gossip combine-then-adapt (:func:`DistributedNeighborAllreduceOptimizer`,
  :func:`DistributedAdaptWithCombineOptimizer`) and adapt-then-combine
  (:func:`DistributedAdaptThenCombineOptimizer`), and the machine-level
  gossip (:func:`DistributedHierarchicalNeighborAllreduceOptimizer`); with
  the ``compression`` attribute (``None``, ``"int8"``, ``"bf16"``,
  ``"int4"``, ``"int8_ef"``, ``"int4_ef"``) selecting the exact combine, the
  quantized wire, or the quantized wire with error feedback (CHOCO copies kept by
  the optimizer, one pair per dtype group), per-step weights, dynamic
  schedules, communication every K-th step, and the fused train step
  :meth:`_GossipOptimizer.make_train_step` (``delayed=True``: one-step
  stale mixing);
- windows: :func:`DistributedWinPutOptimizer`,
  :func:`DistributedPullGetOptimizer` and :func:`DistributedPushSumOptimizer`
  over one packed window of :mod:`bluefog_tpu_torch.windows`.

The inner optimizers are :func:`sgd` and :func:`adam`, whose numbers are
``optax.sgd``'s and ``optax.adam``'s.

Bucketing and chunking: each packed group is gossiped in buckets of at
most :func:`~bluefog_tpu_torch.collective.inner.transport_bucket_cap`
bytes, snapped to the 512-element wire blocks, and the static-plan
neighbor combine and the ZeRO-2 scatter split their transfers into the
chunk count the JAX package's chooser gives for the port's transport
(:meth:`_GossipOptimizer._plan_chunks`, link class
:data:`~bluefog_tpu_torch.collective.compiler.TRANSPORT_LINK_CLASS`); both
are bitwise the monolithic combine. One process on one card has no wire to
overlap, so that is one bucket and one chunk unless
``BLUEFOG_BUCKET_BYTES`` (``BLUEFOG_OVERLAP=0``: one bucket) or
``BLUEFOG_PLAN_CHUNKS`` asks for more. A bucket is a column slice of the
stacked ``[N, n]`` payload, not contiguous, so the quantized wire copies
it, and the EF copies' columns, chunk-major (each chunk contiguous, as the
wire kernels take their operands) and writes the results back.

Weight-update sharding (:mod:`bluefog_tpu_torch.sharding`): with
``BLUEFOG_SHARD=1`` the gradient-allreduce family keeps each worker's
1/N slot of the inner state (a :class:`~bluefog_tpu_torch.sharding.ShardedOptState`),
updates the slots and gathers them back into every worker's parameters
(ZeRO-1); ``BLUEFOG_SHARD_GRADS=1`` replaces the gradient allreduce by
:func:`bluefog_tpu_torch.collective.inner.reduce_scatter` on the wire of
``compression`` (ZeRO-2). Every other family warns once and runs the
replicated path.

A parameter tree is a tensor or a (nested) dict of tensors, each
``[size, ...]`` with the worker axis first. Leaves are ordered as
``jax.tree_util`` orders a dict (keys sorted at every level) and packed
per dtype group into one flat payload before the combine, exactly as the
JAX ``_packed_gossip`` does — the quantized wire's 512-element scale
blocks span leaf boundaries, so the packing order is part of the wire
format. A single-leaf group (e.g. the flat parameter buffer of
:class:`bluefog_tpu_torch.models.stacked.StackedModel`) is gossiped in
place with no pack copy.

Unlike optax's pure functions, :meth:`_GossipOptimizer.step` updates the
given parameter and state tensors in place (it saves a model-sized copy
per step) and returns them; with order ``"grad"`` it also overwrites the
gradients with their average. The window optimizers update their
window's value in place.

Observability, on both dispatch paths (:meth:`_GossipOptimizer.step` and
the fused train step), as in the JAX package: ``step_begin`` /
``step_dispatched`` flight records around an ``ENQUEUE`` timeline span
(``optimizer_step``, ``fused_train_step``, ``window_optimizer_step``),
inside which the gossip family's step opens its phase spans
(:data:`bluefog_tpu_torch.timeline.PHASE`): ``forward`` and ``backward``
once a worker (:func:`_worker_loss_grad`), ``update`` around the inner
update (:func:`_apply_update`) and ``combine`` around the gossip, the
gradient allreduce, ZeRO-2's reduce-scatter and ZeRO's gather of the
owned slots (the probe of the metrics stays outside all four); the
plans noted in the flight recorder; with ``BLUEFOG_METRICS=1`` the rounds,
wire bytes and ``bluefog.shard.*`` accounting of every communicating step,
and on one communicating step in ``BLUEFOG_METRICS_INTERVAL`` the
sub-gossip probe of :mod:`bluefog_tpu_torch.metrics`
(:meth:`_GossipOptimizer._probe`), whose payload is folded at the next
sample or at :func:`bluefog_tpu_torch.metrics.flush`. A step that is not
sampled runs the code it runs with metrics off. The JAX package's
``compile`` records and ``bluefog.recompiles`` have no counterpart here
(see :mod:`bluefog_tpu_torch.metrics`), nor has the memory observatory's
``compile`` phase (eager PyTorch builds no program).

The observatories, as in the JAX package: every communicating step of
both dispatch paths times its enqueue for the doctor when it will sample
(:func:`bluefog_tpu_torch.attribution.dispatch_timer`), and after the
enqueue hands the step to :func:`bluefog_tpu_torch.attribution.observe_step`,
the health plane's :func:`bluefog_tpu_torch.health.observe_step`,
:func:`bluefog_tpu_torch.staleness.observe_step` (the fused path with the
delay buffer's payload age and ``surface="delayed"``) and
:func:`bluefog_tpu_torch.memory.observe_step`; the window optimizers hand
their window to :func:`bluefog_tpu_torch.staleness.observe_window`; last,
:func:`bluefog_tpu_torch.slo.observe_step` (the SLO engine, whose canary
dispatches under its own op-cache key). With a
memory session open each enqueue runs inside its ``dispatch`` phase
(:func:`_timed_dispatch`). A step that none of them samples runs the code
it runs with them off.

Under ``BLUEFOG_PODS`` the static-plan neighbor combine is the two-level
federated one (:meth:`_GossipOptimizer._fed_dispatch`), with the
``bluefog.federation.ici_wire_bytes`` and ``.dcn_wire_bytes`` counters.

Across processes (a context whose ``process_count > 1``, see
:mod:`bluefog_tpu_torch.context`) the leaves are this process's rows
``[n_local, ...]`` and the gossip family's combines run over the
multi-process transport (:mod:`bluefog_tpu_torch.collective.transport`),
bitwise the stacked rows: the static, explicit-weight and dynamic
neighbor combines on every tier, the hierarchical machine leg (one
machine per process by default), the gradient and weight allreduce, the
fused train step and the delayed mix; the window optimizers on the combo
window's local rows (:mod:`bluefog_tpu_torch.windows`); ZeRO-1 and ZeRO-2,
each process updating its workers' owned slots, the updated slots of
every live owner coming back through one
:func:`~bluefog_tpu_torch.collective.transport.gather_rows` a dtype group
and the ZeRO-2 gradient leg through the reduce-scatter's routes
(:func:`bluefog_tpu_torch.collective.inner.reduce_scatter`); the
federated legs (:meth:`_GossipOptimizer._fed_dispatch`, the same DCN-step
cadence in every process), relay plans (forwarded hop by hop,
:class:`~bluefog_tpu_torch.collective.transport.RelayRoute`) and elastic
sessions (agreed by every process before each dispatch; ZeRO re-shards
through one ``gather_rows`` a dtype group, :meth:`_GossipOptimizer._reshard_state`).
The samplers the hooks feed run there too and report the fleet's numbers
in every process: the metrics probe gathers its payload's prefix rows
(:meth:`_GossipOptimizer._probe`), so the fold is the stacked fold.

Under ``BLUEFOG_PLAN_METHOD=shortcut`` the static plan is a relay plan:
its combine gathers each round's origin rows (see
:mod:`bluefog_tpu_torch.collective.inner`), its injection table joins the
gossip keys, and the error-feedback tiers refuse it with the JAX package's
``ValueError`` (their copies integrate a fixed per-round source).
"""

import enum
import itertools
import time
from typing import Callable, List, Optional, Union

import torch

import numpy as np

from bluefog_tpu_torch import attribution, flight, metrics, sharding
from bluefog_tpu_torch import autotune as autotune_mod
from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import health as health_mod
from bluefog_tpu_torch import memory as mem_mod
from bluefog_tpu_torch import slo as slo_mod
from bluefog_tpu_torch import staleness as stal_mod
from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch import windows as win_mod
from bluefog_tpu_torch.collective import compiler, inner, transport
from bluefog_tpu_torch.collective import ops as col_ops
from bluefog_tpu_torch.collective.plan import CommPlan, SchedulePlan, plan_from_weights
from bluefog_tpu_torch.logging_util import warn_once

__all__ = [
    "SGD",
    "sgd",
    "Adam",
    "adam",
    "tree_leaves",
    "CommunicationType",
    "DistributedGradientAllreduceOptimizer",
    "DistributedAllreduceOptimizer",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedHierarchicalNeighborAllreduceOptimizer",
    "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer",
    "DistributedWinPutOptimizer",
    "DistributedPullGetOptimizer",
    "DistributedPushSumOptimizer",
]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    return _build_tree(template, iter(leaves))


def _build_tree(t, it):
    # a module-level function, not a closure over ``it``: a recursive
    # closure is a reference cycle that keeps the leaves alive until the
    # garbage collector runs
    if isinstance(t, dict):
        return {k: _build_tree(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):  # a NamedTuple
        return type(t)(*(_build_tree(x, it) for x in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build_tree(x, it) for x in t)
    return next(it)


def _tree_zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _tree_zeros_like(v) for k, v in tree.items()}
    return type(tree)(_tree_zeros_like(t) for t in tree)


def _worker_count(params) -> torch.Tensor:
    """A zero step count per worker, ``[size]`` int32 on the parameters'
    device (the optax ``count``, stacked like the rest of the state)."""
    leaf = tree_leaves(params)[0]
    return torch.zeros(leaf.shape[0], dtype=torch.int32, device=leaf.device)


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-worker vector ``[N]`` shaped to broadcast against ``like``."""
    return v.to(like.dtype).view((-1,) + (1,) * (like.dim() - 1))


class SGD:
    """Functional SGD whose numbers equal ``optax.sgd(lr, momentum)``:
    the trace is ``g + momentum * trace`` from zero, and the update
    ``-lr * trace`` (``-lr * g`` without momentum) is added to the
    parameters — each as its own rounding step, never fused.

    ``learning_rate`` may be a schedule ``count -> lr`` of the per-worker
    step count (an int32 tensor ``[size]``, from 0), as an optax schedule;
    the state is then ``{"count": [size] int32, "trace": trace or ()}``."""

    def __init__(self, learning_rate: Union[float, Callable], momentum: Optional[float] = None):
        self.learning_rate = learning_rate if callable(learning_rate) else float(learning_rate)
        self.momentum = None if momentum is None else float(momentum)

    def init(self, params):
        """The momentum trace (zeros like ``params``), or ``()``; with a
        schedule, the trace beside the step count."""
        trace = () if self.momentum is None else _tree_zeros_like(params)
        if callable(self.learning_rate):
            return {"count": _worker_count(params), "trace": trace}
        return trace

    def apply_(self, params, state, grads) -> None:
        """One update of ``params`` (and the trace in ``state``) in place."""
        scheduled = callable(self.learning_rate)
        trace = state["trace"] if scheduled else state
        p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        t_leaves = tree_leaves(trace) if self.momentum is not None else g_leaves
        if not len(p_leaves) == len(g_leaves) == len(t_leaves):
            raise ValueError("params, grads and state differ in structure")
        if scheduled:
            step_size = -torch.as_tensor(self.learning_rate(state["count"]),
                                         dtype=torch.float32)
        for p, g, t in zip(p_leaves, g_leaves, t_leaves):
            if self.momentum is not None:
                t.mul_(self.momentum).add_(g)
            if scheduled:
                p.add_(t * _col(step_size, t))
            else:
                p.add_(t * (-self.learning_rate))
        if scheduled:
            state["count"].add_(1)


def sgd(learning_rate: Union[float, Callable], momentum: Optional[float] = None) -> SGD:
    """``optax.sgd`` counterpart (no Nesterov)."""
    return SGD(learning_rate, momentum)


class Adam:
    """Functional Adam whose numbers equal ``optax.adam(learning_rate, b1,
    b2, eps, eps_root)``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 +
    b2 nu``, both bias-corrected by ``1 - b ** count`` (count from 1), and
    the update ``-lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)``. The
    state is ``{"count": [size] int32, "mu": tree, "nu": tree}``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)

    def init(self, params):
        return {"count": _worker_count(params), "mu": _tree_zeros_like(params),
                "nu": _tree_zeros_like(params)}

    def apply_(self, params, state, grads) -> None:
        """One update of ``params`` and ``state`` in place."""
        p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        mu_leaves, nu_leaves = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        if not len(p_leaves) == len(g_leaves) == len(mu_leaves) == len(nu_leaves):
            raise ValueError("params, grads and state differ in structure")
        count = state["count"].add_(1).to(torch.float32)
        f32 = dict(dtype=torch.float32, device=count.device)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, **f32), count)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, **f32), count)
        for p, g, mu, nu in zip(p_leaves, g_leaves, mu_leaves, nu_leaves):
            torch.add(g * (1.0 - self.b1), mu * self.b1, out=mu)
            torch.add((g * g) * (1.0 - self.b2), nu * self.b2, out=nu)
            mu_hat = mu / _col(bc1, mu)
            nu_hat = nu / _col(bc2, nu)
            update = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
            p.add_(update * (-self.learning_rate))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Adam:
    """``optax.adam`` counterpart."""
    return Adam(learning_rate, b1, b2, eps, eps_root)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_groups(leaves):
    """Same-dtype leaf groups sorted by dtype name (``_dtype_groups``)."""
    groups = {}
    for leaf in leaves:
        groups.setdefault(_dtype_name(leaf.dtype), []).append(leaf)
    return sorted(groups.items())


def _pack(group) -> torch.Tensor:
    """The packed ``[N, n]`` payload of one dtype group: the leaf itself
    (a view) for a single leaf, else a concatenated copy."""
    n_workers = group[0].shape[0]
    if len(group) == 1:
        return group[0].reshape(n_workers, -1)
    return torch.cat([leaf.reshape(n_workers, -1) for leaf in group], dim=1)


def _unpack_(group, out: torch.Tensor) -> None:
    """Write a packed ``[N, n]`` result back into the group's leaves."""
    off = 0
    for leaf in group:
        n = leaf[0].numel()
        part = out[:, off:off + n]
        if part.data_ptr() != leaf.data_ptr():
            leaf.copy_(part.reshape(leaf.shape))
        off += n


def _buckets(flat: torch.Tensor, cap_bytes: int):
    return inner.bucket_bounds(flat.shape[1], flat.element_size(), cap_bytes)


def _bucketed_flat_gossip(flat: torch.Tensor, fn, cap_bytes: int) -> torch.Tensor:
    """``fn`` over the size-capped buckets of a packed ``[N, n]`` payload,
    the results put back together (``_bucketed_flat_gossip``): the combine
    is elementwise along the flat axis and the bounds sit on the wire's
    block grid, so the result is bitwise ``fn(flat)``."""
    bounds = _buckets(flat, cap_bytes)
    if len(bounds) == 1:
        return fn(flat)
    return torch.cat([fn(flat[:, a:b]) for a, b in bounds], dim=1)


def _gossip_group(group, fn, cap_bytes: int = 0) -> None:
    """Gossip one dtype group in place, bucket by bucket: ``fn`` takes a
    packed ``[N, n]`` payload (the leaf itself for a single leaf in one
    bucket, else a column slice) and returns the result."""
    packed = _pack(group)
    bounds = _buckets(packed, cap_bytes)
    if len(bounds) == 1:
        _unpack_(group, fn(packed))
        return
    for a, b in bounds:
        part = packed[:, a:b]
        out = fn(part)
        if out.data_ptr() != part.data_ptr():
            part.copy_(out)
    if len(group) > 1:
        _unpack_(group, packed)


def _packed_gossip(tree, gossip_fn: Callable[[torch.Tensor], torch.Tensor],
                   cap_bytes: int = 0) -> None:
    """Gossip every leaf of ``tree`` in place, packed per dtype group in
    JAX leaf order, in buckets of at most ``cap_bytes`` (0: one)."""
    for _name, group in _dtype_groups(tree_leaves(tree)):
        _gossip_group(group, gossip_fn, cap_bytes)


def _packed_gossip_ef(tree, ef_state, ef_combine, cap_bytes: int = 0) -> None:
    """:func:`_packed_gossip` with error feedback: one ``(xhat_self,
    xhat_recv)`` pair per dtype group, threaded through ``ef_combine(flat,
    state)`` and updated in place. A bucket takes the copies' columns of
    its own blocks (views, which the combine updates in place), so each
    bucket carries its own error feedback and the copies keep their
    layout."""
    for (_name, group), (xs, xr) in zip(_dtype_groups(tree_leaves(tree)), ef_state):
        packed = _pack(group)
        bounds = _buckets(packed, cap_bytes)
        if len(bounds) == 1:
            _unpack_(group, ef_combine(packed, (xs, xr)))
            continue
        for a, b in bounds:
            end = min(-(-b // inner._QUANT_CHUNK) * inner._QUANT_CHUNK, xs.shape[1])
            part = packed[:, a:b]
            out = ef_combine(part, (xs[:, a:end], xr[:, :, a:end]))
            if out.data_ptr() != part.data_ptr():
                part.copy_(out)
        if len(group) > 1:
            _unpack_(group, packed)


def _group_sig(tree):
    """``((dtype, elements per worker), ...)`` of a tree's dtype groups."""
    return tuple((name, sum(leaf[0].numel() for leaf in group))
                 for name, group in _dtype_groups(tree_leaves(tree)))


def _packed_prefix(tree, cap: int):
    """``[(sub [N, k], scale)]`` per dtype group: a new tensor holding the
    first ``k`` columns of the group's packed payload, ``k`` the probe's
    512-aligned prefix (:func:`metrics.prefix_elems`), cut from whole
    leaves and at most one partial leaf (the JAX ``_packed_prefix``);
    ``scale`` is the group's elements over ``k``."""
    out = []
    for _name, group in _dtype_groups(tree_leaves(tree)):
        n_workers = group[0].shape[0]
        total = sum(leaf[0].numel() for leaf in group)
        keep = metrics.prefix_elems(total, cap)
        parts, got = [], 0
        for leaf in group:
            if got >= keep:
                break
            take = min(leaf[0].numel(), keep - got)
            parts.append(leaf.reshape(n_workers, -1)[:, :take])
            got += take
        sub = (torch.cat(parts, dim=1) if len(parts) > 1
               else parts[0].clone(memory_format=torch.contiguous_format))
        out.append((sub, total / keep))
    return out


class CommunicationType(enum.Enum):
    """What a gossip-family optimizer communicates (the JAX package's
    ``CommunicationType``)."""

    neighbor_allreduce = "neighbor.allreduce"
    hierarchical_neighbor_allreduce = "hierarchical.neighbor.allreduce"
    allreduce = "allreduce"
    empty = "empty"


_EF_TIERS = ("int8_ef", "int4_ef")


def _timed_dispatch(name: str, fn, *args, **kwargs):
    """An optimizer's enqueue (:func:`bluefog_tpu_torch.collective.ops._enqueue`),
    inside the memory observatory's ``dispatch`` phase when a session is
    open (the JAX ``_timed_dispatch``)."""
    if mem_mod.active() is None:
        return col_ops._enqueue(name, fn, *args, **kwargs)
    with mem_mod.phase_scope("dispatch"):
        return col_ops._enqueue(name, fn, *args, **kwargs)


def _elapsed(t0: Optional[float]) -> Optional[float]:
    return time.perf_counter() - t0 if t0 is not None else None


class _Dispatch:
    """One step's resolved communication: ``combine`` maps a packed ``[N,
    n]`` payload to its combine (``combine(flat, ef_pair)`` for the EF
    tiers), ``key`` names its structure, ``self_weight()`` gives each
    worker's self weight ``[N]`` f32 (for the delayed mix), and ``ef`` says
    whether the combine threads the CHOCO copies."""

    def __init__(self, key, combine, self_weight, ef=False):
        self.key, self.combine, self.self_weight, self.ef = key, combine, self_weight, ef
        self.cap_bytes = 0  # the bucket cap of this step's packed gossip
        self.shard = None  # the ShardLayout of a sharded step
        self.scatter_wire = None  # ZeRO-2: the reduce-scatter's wire tier
        self.scatter_chunks = ()  # ZeRO-2: its chunk count per dtype group

    @property
    def identity(self) -> bool:
        """No communication: an off-step, or ``CommunicationType.empty``."""
        return self.key in (("local",), ("empty",))


class _GossipOptimizer:
    """Shared engine of the allreduce, neighbor and hierarchical families.

    ``order``: ``"cta"`` gossips the parameters before the inner update,
    ``"atc"`` after, ``"grad"`` averages the gradients instead (allreduce
    communication only). The knobs are attributes, as in the JAX package:

    - ``compression``: ``None`` (exact combine), ``"int8"`` or ``"int4"``
      (block-scaled quantized wire, difference form, through the CUDA wire
      kernels on the card), ``"bf16"`` (the payload rounded to bf16, the
      same difference form), ``"int8_ef"`` or ``"int4_ef"`` (the same wires
      with error feedback: the optimizer keeps the CHOCO copies in ``_ef``,
      one ``(xhat_self [N, d], xhat_recv [R, N, d])`` pair per dtype group,
      zeroed whenever the group sizes, the plan's rounds or the tier
      change); the quantized wires on the static or explicit-weight
      neighbor path and the machine leg of the hierarchical path, the EF
      tiers on the neighbor path only; under ZeRO-2 every tier is the
      gradient reduce-scatter's wire (the EF tiers' residuals per slot);
    - ``self_weight``, ``src_weights``, ``dst_weights``,
      ``enable_topo_check``: per-step weights, resolved as
      :func:`bluefog_tpu_torch.neighbor_allreduce` resolves them;
    - ``schedule``: a dynamic :class:`SchedulePlan` (machine-level for the
      hierarchical path), indexed by the communication count;
    - ``neighbor_machine_weights``, ``send_neighbor_machines``: explicit
      machine-level weights of the hierarchical path (with
      ``self_weight``, default 0.5);
    - ``num_steps_per_communication``: communicate on every K-th call; the
      calls between run the inner update alone, or, for ``"grad"``,
      accumulate the gradients and leave the parameters as they are."""

    _COMPRESSIONS = (None, "int8", "bf16", "int4") + _EF_TIERS

    def __init__(self, base_optimizer, communication_type: CommunicationType, order: str,
                 num_steps_per_communication: int = 1):
        if not isinstance(communication_type, CommunicationType):
            raise TypeError(
                f"communication_type must be a CommunicationType, got {communication_type!r}"
            )
        if order not in ("cta", "atc", "grad"):
            raise ValueError(f"order must be 'cta', 'atc' or 'grad', got {order!r}")
        if order == "grad" and communication_type != CommunicationType.allreduce:
            raise ValueError("gradient gossip is only defined for allreduce communication")
        self.tx = base_optimizer
        self.communication_type = communication_type
        self.order = order
        self.self_weight = None
        self.src_weights = None
        self.dst_weights = None
        self.enable_topo_check = True
        self.compression: Optional[str] = None
        self.schedule: Optional[SchedulePlan] = None
        self.neighbor_machine_weights = None
        self.send_neighbor_machines = None
        self.num_steps_per_communication = num_steps_per_communication
        self._step_count = 0
        self._comm_count = 0  # schedule index: advances per communication
        self._grad_accum = None  # "grad" order: the gradient sum between communications
        self._ef = self._ef_sig = None
        self._delay_buf = self._delay_sig = None
        # the communication count the delay buffer was last written at: the
        # delayed combine's payload age is the distance to it
        self._delay_birth_comm = 0
        # the plan this step's gossip runs (None for allreduce, hierarchical
        # and empty communication): what the doctor and the lineage probe
        self._last_plan = None
        self._shard_layout = None  # the active ShardLayout under BLUEFOG_SHARD=1
        self._shard_reshards = 0  # re-shards onto a changed live set
        self._elementwise = None  # (inner optimizer, whether the probe found it elementwise)
        self._scatter_ef = self._scatter_ef_sig = None
        # the device tier: the sampled probe's payload on its way to the
        # host, (wire, host payload, event); folded at the next sample or flush
        self._pending_drain = None
        self._metrics_hooked = False
        self._acct_cache = {}  # per-structure rounds and wire bytes
        self._last_probe = None  # the latest probe's (sub_x, sub_y, scale, ef) per group
        self._last_payload = None  # the latest probe's payload, on the device

    def init(self, params):
        """Per-worker inner-optimizer state (stacked like ``params``); under
        ``BLUEFOG_SHARD=1`` on the gradient-allreduce family a
        :class:`~bluefog_tpu_torch.sharding.ShardedOptState`: each worker's
        state over its owned slot, and the f32 master slices with
        ``BLUEFOG_SHARD_MASTER=1``."""
        if self._shard_active():
            return self._shard_init(ctx_mod.get_context(), params)
        return self.tx.init(params)

    def free(self) -> None:
        """Drop the error-feedback copies (the scatter's residuals too), the
        delay buffers and the gradient accumulator (a later step starts
        them anew)."""
        self._ef = self._ef_sig = None
        self._delay_buf = self._delay_sig = None
        self._grad_accum = None
        self._scatter_ef = self._scatter_ef_sig = None

    # -- weight-update sharding -----------------------------------------------------

    def _shard_active(self) -> bool:
        """Sharding applies where it keeps the trajectory: order
        ``"grad"`` without a schedule, whose update inputs are the same on
        every worker after the allreduce. Any other family warns once and
        runs the replicated path."""
        if not sharding.enabled():
            return False
        if self.order == "grad" and self.schedule is None:
            return True
        warn_once(
            f"shard-family:{self.order}:{self.communication_type.value}",
            "BLUEFOG_SHARD=1 ignored for the %s/%s family: its inner state "
            "integrates each worker's own gradient stream, so a "
            "coordinate-partitioned update would change the algorithm; running "
            "the replicated path. Weight-update sharding applies to the "
            "gradient-allreduce family.",
            self.order, self.communication_type.value,
        )
        return False

    def _ensure_shard_layout(self, ctx, params):
        """``(layout, changed)``: the layout of ``params``' dtype groups over
        the live workers (:meth:`~bluefog_tpu_torch.context.BluefogContext.live_token`;
        every worker without an elastic session), ``changed`` when a stored
        layout no longer fits the live set, the groups or the master mode
        (a flip of ``BLUEFOG_SHARD_GRADS`` alone swaps the gradient leg, not
        the slots, and is not a change)."""
        token = ctx.live_token()
        groups = _group_sig(params)
        master = sharding.master_enabled()
        grads = sharding.grads_enabled()
        lay = self._shard_layout
        if (lay is not None and lay.token == token and lay.master == master
                and tuple((g.dtype, g.elems) for g in lay.groups) == groups):
            if lay.grads != grads:
                lay = sharding.build_layout(groups, lay.live, ctx.size, master=master,
                                            token=token, grads=grads)
                self._shard_layout = lay
            return lay, False
        live = token[1] if token is not None else tuple(range(ctx.size))
        new = sharding.build_layout(groups, live, ctx.size, master=master, token=token,
                                    grads=grads)
        changed = lay is not None
        self._shard_layout = new
        return new, changed

    def _shard_check_elementwise(self) -> None:
        """Refuse an inner optimizer whose update of a coordinate depends on
        other coordinates (global-norm clipping, trust ratios): update a
        vector twice, alike in its first half and not in its second, and
        require the first half's updates to be equal. Re-run whenever
        ``tx`` is rebound."""
        if self._elementwise is None or self._elementwise[0] is not self.tx:
            d = 2 * sharding.ALIGN_ELEMS
            half = d // 2
            rng = np.random.RandomState(0)
            p = rng.randn(d).astype(np.float32)
            g1 = rng.randn(d).astype(np.float32)
            g2 = g1.copy()
            g2[half:] = rng.randn(half).astype(np.float32)
            outs = []
            for g in (g1, g2):
                pt = torch.from_numpy(p.copy())[None]
                self.tx.apply_(pt, self.tx.init(pt), torch.from_numpy(g)[None])
                outs.append(pt[0, :half])
            self._elementwise = (self.tx, bool(torch.equal(outs[0], outs[1])))
        if not self._elementwise[1]:
            raise ValueError(
                "BLUEFOG_SHARD=1 requires an ELEMENTWISE inner transformation: "
                "this optimizer's update of a coordinate depends on other "
                "coordinates (global-norm clipping, LARS/LAMB-style trust "
                "ratios, ...), so a 1/N-slot update would silently diverge from "
                "the replicated trajectory. Use an elementwise transform (adam, "
                "sgd, per-element clipping) or run with BLUEFOG_SHARD=0"
            )

    def _shard_init(self, ctx, params):
        self._shard_check_elementwise()
        layout, _ = self._ensure_shard_layout(ctx, params)
        own = _shard_own_slices(params, layout)
        if layout.master:
            master = tuple(o.to(torch.float32).clone() for o in own)
            # the moments live beside the f32 master slices
            state = sharding.ShardedOptState(self.tx.init(master), master)
        else:
            state = sharding.ShardedOptState(self.tx.init(own), ())
        self._register_shard(layout, state)
        return state

    def _register_shard(self, layout, state) -> None:
        from bluefog_tpu_torch import scaling

        # the state holds the local workers' rows: bytes a worker over them
        sharding.register_active(layout, reshards=self._shard_reshards,
                                 measured_state_bytes=scaling.optimizer_state_bytes(
                                     state=state, world=len(_local_workers(layout))))

    @staticmethod
    def _shard_slot_group(shape, layout, rows=None):
        """The group a worker-stacked state leaf of ``shape`` (``rows``
        worker rows, every worker by default) belongs to, or None for a
        leaf that is not a slot (step counts): slot lengths are unique per
        layout."""
        if len(shape) != 2 or shape[0] != (layout.size if rows is None else rows):
            return None
        for gi, g in enumerate(layout.groups):
            if shape[1] == g.slot:
                return gi
        return None

    def _reshard_state(self, ctx, old, new, opt_state) -> None:
        """The membership-change re-shard, in place: each slot leaf's full
        per-coordinate vector is gathered from the old owners' rows
        (:func:`_gather_slot_rows`) and re-sliced under the new owner map
        (:func:`_slice_slot_rows`), on the leaf's device, and the leaf takes
        the new ``[size, slot]`` array (``Tensor.set_``, so every holder of
        the state sees it). Other leaves (step counts) stay as they are.

        Across processes a leaf is this process's ``[n_local, slot]`` rows:
        the slot leaves of one dtype group and dtype come side by side
        through one :func:`transport.gather_rows` (every worker's rows, so
        the old owners' of any process), and each process keeps its
        workers' rows of the new slot arrays, bitwise the stacked rows."""
        multi = ctx.process_count > 1
        groups = {}
        for leaf in tree_leaves(opt_state):
            gi = self._shard_slot_group(tuple(leaf.shape), old, ctx.n_local)
            if gi is not None:
                groups.setdefault((gi, leaf.dtype), []).append(leaf)
        for (gi, _dtype), leaves in groups.items():
            parts = leaves
            if multi:
                rows = transport.gather_rows(torch.cat(leaves, dim=1).contiguous(), ctx)
                parts = rows.split(old.groups[gi].slot, dim=1)
            for leaf, part in zip(leaves, parts):
                full = _slice_slot_rows(_gather_slot_rows(part, old, gi), new, gi)
                leaf.set_(full[ctx.rows.start:ctx.rows.stop].clone() if multi else full)
        self._shard_reshards += 1
        metrics.counter("bluefog.shard.reshards").inc()
        flight.record("shard_reshard", live=len(new.live), was=len(old.live))

    def _shard_prepare(self, ctx, params, opt_state):
        """The sharded step's prologue: the state must be the sharded form
        and the inner optimizer elementwise; on a change of the live set
        the state is re-sharded in place onto the new layout. A change of
        the master mode or of the dtype groups raises."""
        if not isinstance(opt_state, sharding.ShardedOptState):
            raise ValueError(
                "BLUEFOG_SHARD=1 but the optimizer state is not sharded (was it "
                "created with BLUEFOG_SHARD=0, or restored from a replicated "
                "checkpoint?); re-run init(params) or restore a gather-on-save "
                "sharded checkpoint"
            )
        self._shard_check_elementwise()
        old = self._shard_layout
        layout, changed = self._ensure_shard_layout(ctx, params)
        if changed:
            if old.master != layout.master:
                raise ValueError(
                    "BLUEFOG_SHARD_MASTER changed mid-run (was "
                    f"{int(old.master)}, now {int(layout.master)}); the master "
                    "slices are part of the optimizer state — re-run "
                    "init(params) (or restore a checkpoint saved under the same "
                    "master mode)"
                )
            if [(g.dtype, g.elems) for g in old.groups] != \
                    [(g.dtype, g.elems) for g in layout.groups]:
                raise ValueError(
                    f"the parameters' dtype groups changed from {old.groups} to "
                    f"{layout.groups} under BLUEFOG_SHARD=1; re-run init(params)"
                )
            self._reshard_state(ctx, old, layout, opt_state)
            self._register_shard(layout, opt_state)
        return layout

    def _scatter_chunks(self, ctx, layout):
        """The reduce-scatter's chunk count per dtype group, priced on one
        round's slot on the wire of ``compression`` over the port's
        transport."""
        from bluefog_tpu_torch import scaling

        out = []
        for g in layout.groups:
            itemsize = getattr(torch, g.dtype).itemsize
            payload = (scaling.wire_payload_bytes(g.slot, itemsize, self.compression)
                       if self.compression is not None else g.slot * itemsize)
            out.append(compiler.reduce_scatter_chunks(
                ctx.size, payload, n_elems=g.slot, link_class=compiler.TRANSPORT_LINK_CLASS))
        return tuple(out)

    def _ensure_scatter_ef(self, ctx, layout) -> None:
        """The ZeRO-2 EF tiers' residuals, ``[N, padded]`` f32 per dtype
        group, zeroed whenever the layout or the tier changes."""
        sig = (layout.sig(), self.compression, ctx.device)
        if self._scatter_ef_sig == sig:
            return
        self._scatter_ef = [torch.zeros((ctx.n_local, g.padded), dtype=torch.float32,
                                        device=ctx.device) for g in layout.groups]
        self._scatter_ef_sig = sig

    def _shard_dispatch(self, ctx, d: _Dispatch, params, opt_state, comm_now: bool) -> None:
        """Resolve this step's sharding onto ``d``, shared by :meth:`step`
        and the fused train step: the layout, and under ZeRO-2 the
        scatter's wire, chunk counts and residuals."""
        if not (comm_now and self._shard_active()):
            return
        d.shard = self._shard_prepare(ctx, params, opt_state)
        if d.shard.grads:
            d.scatter_wire = self.compression
            d.scatter_chunks = self._scatter_chunks(ctx, d.shard)
            if d.scatter_wire in _EF_TIERS:
                self._ensure_scatter_ef(ctx, d.shard)

    def _scatter_own_grads(self, d: _Dispatch, grads):
        """The ZeRO-2 gradient leg: each dtype group's packed gradient
        reduce-scattered (``inner.reduce_scatter``, mean over workers) so
        each worker gets only its owned slot, ``[N, slot]`` per group; the
        EF tiers update their residuals in place."""
        layout = d.shard
        _shard_check_groups(grads, layout, "gradient")
        lidx = tuple(int(v) for v in layout.live_index())
        live = set(layout.live)
        mask = tuple(1.0 if r in live else 0.0 for r in range(layout.size))
        own = []
        for gi, (g, (_name, group)) in enumerate(zip(
                layout.groups, _dtype_groups(tree_leaves(grads)))):
            packed = _pack(group)
            k = d.scatter_chunks[gi] if gi < len(d.scatter_chunks) else 1
            # the unpadded payload: the slots past it read as zeros, and the
            # exact tier on one chunk takes the one-sum form
            if d.scatter_wire in _EF_TIERS:
                y, self._scatter_ef[gi] = inner._reduce_scatter(
                    packed, lidx, g.slot, True, d.scatter_wire, k, self._scatter_ef[gi], mask)
            else:
                y = inner._reduce_scatter(packed, lidx, g.slot, True, d.scatter_wire, k,
                                          None, None, fast=True)
            own.append(y)
        return tuple(own)

    # -- resolution of the communication --------------------------------------

    def _validate_compression(self) -> None:
        if self.compression is None:
            return
        if self.compression not in self._COMPRESSIONS:
            raise ValueError(
                "compression must be None, 'int8', 'bf16', 'int4', "
                f"'int8_ef', or 'int4_ef', got {self.compression!r}"
            )
        comm = self.communication_type
        if (comm == CommunicationType.allreduce and self.order == "grad"
                and self.schedule is None and sharding.enabled()
                and sharding.grads_enabled()):
            # ZeRO-2: every tier rides the reduce-scatter gradient leg (the EF
            # tiers' residuals are held per slot by the scatter)
            return
        if self.compression in _EF_TIERS and (
            comm != CommunicationType.neighbor_allreduce or self.schedule is not None
        ):
            raise ValueError(
                f"compression={self.compression!r} (error feedback carries "
                "per-worker state) is only supported on the static-plan "
                "neighbor_allreduce path"
            )
        if comm not in (CommunicationType.neighbor_allreduce,
                        CommunicationType.hierarchical_neighbor_allreduce) \
                or self.schedule is not None:
            raise ValueError(
                f"compression={self.compression!r} is only supported on the "
                "static-plan neighbor_allreduce and hierarchical paths (not "
                "schedules, allreduce, or empty communication)"
            )

    def _comm_now(self) -> bool:
        """Communicate on the K-th call; validates K on every call."""
        k = int(self.num_steps_per_communication)
        if k < 1:
            raise ValueError(
                "num_steps_per_communication must be a positive int, got "
                f"{self.num_steps_per_communication!r}"
            )
        return self._step_count % k == k - 1

    def _ensure_ef_state(self, ctx, params, plan) -> None:
        """Zeroed copies whenever the per-worker group sizes, the plan's
        rounds or the tier change: ``xhat_recv[r]`` integrates round
        ``r``'s fixed source, so a stale copy would break the
        bit-identical-copy invariant."""
        sig = (_group_sig(params), plan.perms, self.compression, ctx.device)
        if self._ef_sig == sig:
            return
        self._ef = tuple(
            inner.ef_state_zeros(ctx.n_local, n, len(plan.perms), ctx.device)
            for _name, n in sig[0]
        )
        self._ef_sig = sig

    @staticmethod
    def _wire_payload(params):
        """``(bytes, elements)`` per worker of the largest bucket this step
        ships: the payload the chunk chooser prices."""
        cap = inner.transport_bucket_cap()
        best = None
        for name, n in _group_sig(params):
            if n == 0:
                continue
            itemsize = getattr(torch, name).itemsize
            elems = max(b - a for a, b in inner.bucket_bounds(n, itemsize, cap))
            if best is None or elems * itemsize > best[0]:
                best = (elems * itemsize, elems)
        return best

    @staticmethod
    def _plan_chunks(plan: CommPlan, payload, wire) -> int:
        """The chooser's chunk count for one static-plan step, priced on
        the payload of ``wire`` (scale sidecar included); 1 when there is no
        payload."""
        from bluefog_tpu_torch import scaling

        if payload is None:
            return 1
        payload_bytes, n_elems = payload
        if wire is not None:
            payload_bytes = scaling.wire_payload_bytes(
                n_elems, payload_bytes // max(n_elems, 1), wire)
        compiled = plan.compile_info
        return compiler.choose_chunks(
            compiled if compiled is not None else len(plan.perms), payload_bytes,
            n_elems=n_elems, method=compiler.plan_method(),
            link_class=compiler.TRANSPORT_LINK_CLASS)

    @staticmethod
    def _plan_leg(ctx, plan: CommPlan, wire, chunks: int, knob: str):
        """One memoryless combine over ``plan`` on ``wire`` (exact when
        None) and its self weight: ``(combine, self_weight)``. ``knob``
        names the setting that chose the wire in the normalization error."""
        src, self_w, recv_w = inner.plan_operands(plan, ctx.device)
        if wire is None:
            return (lambda t: inner.weighted_combine_operands(
                        t, src, self_w, recv_w, chunks=chunks),
                    lambda: self_w)
        inner._check_combine_normalized(plan, f"{knob}={wire!r}")
        return (lambda t: inner.weighted_combine_quantized_operands(
                    t, src, recv_w, wire=wire, inplace=True, chunks=chunks),
                lambda: 1.0 - recv_w.sum(0))

    def _plan_dispatch(self, ctx, params, plan: CommPlan) -> _Dispatch:
        """The neighbor combine over one plan, in this step's tier, with the
        chooser's chunk count."""
        wire = self.compression
        # a relay plan's injection table joins the gossip keys (the JAX
        # package's "na"/"na_q" keys): its rounds are transport, not edges
        inject = plan.compile_info.inject
        if wire in _EF_TIERS and plan.relay:
            raise ValueError(
                f"compression={wire!r} cannot ride a short-cut (relay) plan: the "
                "CHOCO copies integrate a fixed per-round source, which relay "
                "rounds do not have. Unset BLUEFOG_PLAN_METHOD=shortcut or use a "
                "memoryless wire (None/'int8'/'bf16'/'int4')."
            )
        chunks = self._plan_chunks(plan, self._wire_payload(params), wire)
        if wire in _EF_TIERS:
            src, _self_w, recv_w = inner.plan_operands(plan, ctx.device)
            inner._check_combine_normalized(plan, f"compression={wire!r}")
            self._ensure_ef_state(ctx, params, plan)
            base = wire[:-len("_ef")]
            return _Dispatch(
                ("na_q_ef", base, plan.perms, chunks),
                lambda flat, st: inner.weighted_combine_quantized_ef_operands(
                    flat, st, src, recv_w, wire=base, inplace=True, chunks=chunks),
                lambda: 1.0 - recv_w.sum(0), ef=True)
        combine, self_weight = self._plan_leg(ctx, plan, wire, chunks, "compression")
        key = (("na", plan.perms, chunks, inject) if wire is None
               else ("na_q", wire, plan.perms, chunks, inject))
        return _Dispatch(key, combine, self_weight)

    def _schedule_dispatch(self, ctx, sched: SchedulePlan, step: int, local_size=None):
        """A dynamic schedule at this communication's index (machine-level
        when ``local_size`` is given)."""
        size = ctx.size if local_size is None else ctx.machine_size
        if sched.size != size:
            what = "machines" if local_size is not None else "workers"
            raise ValueError(
                f"opt.schedule is sized for {sched.size} but there are {size} {what}"
            )
        # the whole period lands in the flight recorder once (deduplicated)
        for p in sched.plans:
            flight.note_plan(p, ctx.topo_version if local_size is None
                             else ctx.machine_topo_version, ctx.live_token(),
                             kind="worker" if local_size is None else "machine")
        if local_size is None:
            combine = lambda t: inner.neighbor_allreduce_step(t, step, sched)  # noqa: E731
        else:
            combine = lambda t: inner.hierarchical_neighbor_allreduce_step(  # noqa: E731
                t, step, sched, local_size)
        _src, self_w, _recv_w = inner.schedule_operands(sched, ctx.device)
        cols = slice(ctx.rows.start, ctx.rows.stop)  # this process's workers
        return _Dispatch(("sched", sched, local_size), combine,
                         lambda: self_w[step % sched.period][cols])

    def _machine_plan(self, ctx) -> CommPlan:
        if self.neighbor_machine_weights is not None:
            mplan = plan_from_weights(
                ctx.machine_size,
                self.self_weight if self.self_weight is not None else 0.5,
                self.neighbor_machine_weights,
                self.send_neighbor_machines,
                enable_topo_check=self.enable_topo_check
                and self.send_neighbor_machines is not None,
            )
            flight.note_plan(mplan, ctx.machine_topo_version, ctx.live_token(), kind="machine")
            return mplan
        if ctx.load_machine_topology() is None:
            raise ValueError(
                "hierarchical optimizer needs set_machine_topology() or "
                "explicit neighbor_machine_weights"
            )
        return ctx.machine_plan()

    def _hier_dispatch(self, ctx, step: int) -> _Dispatch:
        """The machine-level gossip: a machine schedule, or the machine
        plan with its exact combine or the quantized machine leg."""
        local = ctx.local_size
        if self.schedule is not None:
            return self._schedule_dispatch(ctx, self.schedule, step, local)
        mplan = self._machine_plan(ctx)
        src, self_w, recv_w = inner.plan_operands(mplan, ctx.device)
        no_self = lambda: None  # noqa: E731  (the delayed mix refuses this path)
        if self.compression is not None:
            inner._check_combine_normalized(mplan, f"compression={self.compression!r}")
            wire = self.compression
            return _Dispatch(
                ("hier_q", wire, mplan.perms),
                lambda t: inner.hierarchical_neighbor_allreduce_quantized(
                    t, src, recv_w, local, wire=wire),
                no_self)
        return _Dispatch(
            ("hier", mplan.perms),
            lambda t: inner.hierarchical_neighbor_allreduce_operands(
                t, src, self_w, recv_w, local),
            no_self)

    def _resolve_dispatch(self, ctx, params, comm_now: bool) -> _Dispatch:
        """This call's communication, shared by :meth:`step` and the fused
        train step, so a rule cannot reach one and skip the other; with
        this step's bucket cap."""
        d = self._dispatch(ctx, params, comm_now)
        d.cap_bytes = inner.transport_bucket_cap()
        return d

    def _dispatch(self, ctx, params, comm_now: bool) -> _Dispatch:
        self._validate_compression()
        comm = self.communication_type
        if self.schedule is not None and comm not in (
            CommunicationType.neighbor_allreduce,
            CommunicationType.hierarchical_neighbor_allreduce,
        ):
            raise ValueError(
                "opt.schedule (a SchedulePlan) only applies to "
                "neighbor_allreduce or hierarchical communication; "
                f"this optimizer uses {comm.value!r}"
            )
        ones = lambda: torch.ones(ctx.n_local, dtype=torch.float32, device=ctx.device)  # noqa: E731
        self._last_plan = None
        if not comm_now or comm == CommunicationType.empty:
            return _Dispatch(("local",) if not comm_now else ("empty",), lambda t: t, ones)
        step = self._comm_count
        if comm == CommunicationType.allreduce:
            return _Dispatch(("allreduce",), lambda t: inner.allreduce(t, average=True),
                             lambda: ones() / ctx.size)
        if comm == CommunicationType.hierarchical_neighbor_allreduce:
            return self._hier_dispatch(ctx, step)
        if self.schedule is not None:
            self._last_plan = self.schedule.plans[step % self.schedule.period]
            return self._schedule_dispatch(ctx, self.schedule, step)
        if self.self_weight is None and self.src_weights is None and self.dst_weights is None:
            from bluefog_tpu_torch import federation

            fed = federation.get_fabric(ctx.size) if federation.enabled() else None
            if fed is not None:
                return self._fed_dispatch(ctx, params, fed)
        plan = col_ops._resolve_plan(ctx, self.self_weight, self.src_weights,
                                     self.dst_weights, self.enable_topo_check)
        self._last_plan = plan
        return self._plan_dispatch(ctx, params, plan)

    def _fed_dispatch(self, ctx, params, fed) -> _Dispatch:
        """The two-level federated combine of :mod:`bluefog_tpu_torch.federation`
        (the JAX ``_federated_key_and_fn``): every communicating step
        combines over the intra-pod plan ``fed.intra`` on the optimizer's
        wire; on a DCN step (``fed.dcn_step`` of this communication's index,
        so the first is one) the gateway plan ``fed.inter`` then combines the
        intra leg's output on the DCN wire ``fed.wire``, in the same combine:
        ``x -> W_dcn^T (W_ici^T x)``, the step ``federation.composed_rate``
        scores. On an f32 payload of whole 512-element blocks with the
        int8/int4 wires each leg is one ``encode`` and one
        ``decode_accumulate`` in place.

        Keys (a flat run never builds one): ``("fed", "ici", wire, perms,
        chunks, inject)`` on an ICI-only step, ``("fed", "dcn", wire, perms,
        chunks, inject, dcn_wire, inter_perms, inter_chunks, inter_inject)``
        on a DCN step. ``int8_ef``/``int4_ef`` fall back to their memoryless
        base tier with a one-time warning (the CHOCO residuals would go stale
        across the DCN period), so no copies are kept; the delayed mix's self
        weight is the intra leg's in that tier. Both legs' chunk counts come
        from the port's chooser on the stacked transport
        (:meth:`_plan_chunks`: one chunk on one card unless
        ``BLUEFOG_PLAN_CHUNKS`` asks), where the JAX package prices the
        gateway leg on the ICI class of its own transport."""
        intra, inter = fed.intra, fed.inter
        self._last_plan = intra
        flight.note_plan(intra, ctx.topo_version, ctx.live_token())
        payload = self._wire_payload(params)
        wire = self.compression
        if wire in _EF_TIERS:
            warn_once("fed-ef-wire",
                      "compression=%r under bft.federation falls back to the memoryless %r "
                      "wire: error-feedback residuals would go stale across the "
                      "BLUEFOG_DCN_PERIOD gap", wire, wire[:-len("_ef")])
            wire = wire[:-len("_ef")]
        inject = intra.compile_info.inject
        chunks = self._plan_chunks(intra, payload, wire)
        intra_leg, self_weight = self._plan_leg(ctx, intra, wire, chunks, "compression")
        if not fed.dcn_step(self._comm_count):
            return _Dispatch(("fed", "ici", wire, intra.perms, chunks, inject), intra_leg,
                             self_weight)
        flight.note_plan(inter, ctx.topo_version, ctx.live_token())
        dcn_wire = fed.wire
        i_chunks = self._plan_chunks(inter, payload, dcn_wire)
        inter_leg, _ = self._plan_leg(ctx, inter, dcn_wire, i_chunks, "BLUEFOG_DCN_WIRE")
        key = ("fed", "dcn", wire, intra.perms, chunks, inject, dcn_wire, inter.perms,
               i_chunks, inter.compile_info.inject)
        return _Dispatch(key, lambda t: inter_leg(intra_leg(t)), self_weight)

    # -- the step -------------------------------------------------------------------

    def _accumulate(self, grads) -> None:
        """Add an off-step gradient to the ``"grad"`` order's sum."""
        if self._grad_accum is None:
            self._grad_accum = [g.clone() for g in tree_leaves(grads)]
        else:
            for a, g in zip(self._grad_accum, tree_leaves(grads)):
                a.add_(g)

    def _take_accumulated(self, grads):
        """The gradients a communication step applies: this step's plus
        the sum since the last communication."""
        if self._grad_accum is None:
            return grads
        for a, g in zip(self._grad_accum, tree_leaves(grads)):
            a.add_(g)
        out = _tree_unflatten(grads, self._grad_accum)
        self._grad_accum = None
        return out

    def _gossip(self, d: _Dispatch, tree) -> None:
        if d.identity:
            return
        with tl.span("combine", tl.PHASE):
            if d.ef:
                _packed_gossip_ef(tree, self._ef, d.combine, d.cap_bytes)
            else:
                _packed_gossip(tree, d.combine, d.cap_bytes)

    def _combine_update(self, d: _Dispatch, params, state, grads, with_metrics: bool = False,
                        wire: Optional[str] = None):
        """The gossip + inner-update core of :meth:`step` and the fused
        train step (the JAX ``_combine_update``), in place. Order
        ``"grad"`` averages the gradients in place, except under ZeRO-2,
        where the reduce-scatter leaves them as they are; a sharded step
        updates the owned slots and gathers them into the parameters.
        ``with_metrics`` runs the probe (:meth:`_probe`) on the combine's
        input just before the combine and returns its payload (else
        None)."""
        payload = None
        if self.order == "grad":
            allreduce = lambda t: inner.allreduce(t, average=True)  # noqa: E731
            if with_metrics:  # the iterate on the wire is the gradient
                payload = self._probe(allreduce, grads, grads, wire, ef=False)
            if d.shard is not None and d.shard.grads:
                with tl.span("combine", tl.PHASE):
                    own_g = self._scatter_own_grads(d, grads)
                _sharded_inner_update(self.tx, d.shard, params, state, own_g=own_g)
                return payload
            with tl.span("combine", tl.PHASE):
                _packed_gossip(grads, allreduce, d.cap_bytes)
        if d.shard is not None:
            _sharded_inner_update(self.tx, d.shard, params, state, grads=grads)
            return payload
        if self.order == "cta":
            if with_metrics:
                payload = self._probe(d.combine, params, grads, wire, ef=d.ef)
            self._gossip(d, params)
        _apply_update(self.tx, params, state, grads)
        if self.order == "atc":
            if with_metrics:
                payload = self._probe(d.combine, params, grads, wire, ef=d.ef)
            self._gossip(d, params)
        return payload

    # -- the device tier of the metrics -------------------------------------------

    def _probe(self, combine, tree, grads, wire, ef: bool):
        """The sub-gossip: ``combine`` on the 512-aligned prefix of each
        packed dtype group of ``tree`` (a new tensor, so the combine's
        input is never written), on the EF tiers with copies of the prefix
        of the CHOCO state, which are then dropped; the combine is
        elementwise and block-local, so its output is bitwise the first
        columns of the full combine's. Returns the payload of
        :func:`metrics.build_probe_payload`, across processes with every
        worker's prefix rows (:func:`metrics.gather_probe_payload`); the raw
        slices (this process's rows) stay in ``_last_probe``."""
        cap = metrics.sample_elems_cap()
        pairs = []
        for gi, (sub, scale) in enumerate(_packed_prefix(tree, cap)):
            if ef:
                xs, xr = self._ef[gi]
                k = sub.shape[1]
                dk = min(-(-k // inner._QUANT_CHUNK) * inner._QUANT_CHUNK, xs.shape[1])
                es, er = xs[:, :dk].clone(), xr[:, :, :dk].clone()
                y = combine(sub.clone(), (es, er))
                pairs.append((sub, y, scale, es[:, :k]))
            else:
                pairs.append((sub, combine(sub.clone()), scale, None))
        self._last_probe = pairs
        g_subs = _packed_prefix(grads, cap) if grads is not None else ()
        return metrics.gather_probe_payload(metrics.build_probe_payload(pairs, g_subs, wire=wire),
                                            ctx_mod.get_context())

    def _delayed_probe(self, d: _Dispatch, params, grads, sw: torch.Tensor):
        """The probe of the stale mix (:meth:`_stale_mix` on the prefix of
        the fresh parameters and of the carried buffers), run before the
        mix: bitwise the first columns of the full mix. No wire slots;
        gathered across processes as :meth:`_probe`'s."""
        cap = metrics.sample_elems_cap()
        pairs = []
        for (f_sub, scale), buf in zip(_packed_prefix(params, cap), self._delay_buf):
            b_sub = buf[:, :f_sub.shape[1]].clone()
            diff = f_sub.to(b_sub.dtype) - b_sub
            combined = _bucketed_flat_gossip(b_sub, d.combine, d.cap_bytes)
            pairs.append((f_sub, combined + _col(sw, combined) * diff.to(combined.dtype),
                          scale, None))
        self._last_probe = pairs
        return metrics.gather_probe_payload(
            metrics.build_probe_payload(pairs, _packed_prefix(grads, cap), wire=None),
            ctx_mod.get_context())

    def _metrics_wire(self, comm_now: bool, key=None) -> Optional[str]:
        """The quantized wire whose error this step's probe replays, or
        None: the flat paths' wires (the hierarchical machine leg quantizes
        a machine sum, not the packed payload); under ZeRO-2 an EF tier's
        base tier (its residual lives in the scatter); under federation the
        intra leg's wire of the dispatch ``key``."""
        if (not comm_now or self.schedule is not None
                or self.communication_type == CommunicationType.hierarchical_neighbor_allreduce):
            return None
        if key is not None and key[0] == "fed":
            return key[2]
        wire = self.compression
        if wire in ("int8", "bf16", "int8_ef", "int4", "int4_ef"):
            if wire in _EF_TIERS and self._shard_active() and sharding.grads_enabled():
                return wire[:-len("_ef")]
            return wire
        return None

    def _fold_pending(self, export: bool) -> None:
        wire, host, event = self._pending_drain
        self._pending_drain = None
        if event is not None:  # the copy to pinned memory has landed
            event.synchronize()
        metrics.fold_device_payload(host, wire=wire, export=export)

    def _drain_after_sample(self, wire, payload) -> None:
        """After a sampled step: fold the previous sample's payload (its copy
        long done), then start this one's copy to pinned host memory
        without blocking, with a CUDA event beside it."""
        if not self._metrics_hooked:
            metrics.register_flush_hook(self)
            self._metrics_hooked = True
        if self._pending_drain is not None:
            self._fold_pending(export=True)
        host, event = metrics.start_host_copy(payload)
        self._pending_drain = (wire, host, event)
        self._last_payload = payload

    def _flush_metrics(self) -> None:
        """Fold the pending payload now (no exporters: :func:`metrics.flush`'s
        caller decides)."""
        if self._pending_drain is not None:
            self._fold_pending(export=False)

    def _record_comm_accounting(self, d: _Dispatch, params, ctx) -> None:
        """Rounds and wire bytes of this communicating step (computed once
        per structure), and the ``bluefog.shard.*`` gauges of a sharded
        step (the JAX ``_record_comm_accounting``)."""
        from bluefog_tpu_torch import scaling

        shard = d.shard
        key = (d.key, _group_sig(params), None if shard is None else shard.sig(),
               self.compression)
        acct = self._acct_cache.get(key)
        if acct is None:
            tag = d.key[0]
            wire, rounds = None, 0
            if tag in ("na", "hier"):
                rounds = len(d.key[1])
            elif tag in ("na_q", "na_q_ef", "hier_q"):
                wire = d.key[1] + ("_ef" if tag == "na_q_ef" else "")
                rounds = len(d.key[2])
            elif tag == "sched":
                rounds = max(len(p.rounds) for p in d.key[1].plans)
            elif tag == "allreduce":
                rounds = 1
            elif tag == "fed":
                rounds = len(d.key[3]) + (len(d.key[7]) if d.key[1] == "dcn" else 0)
            by_item = {}
            for leaf in tree_leaves(params):
                n = leaf[0].numel() if leaf.dim() > 1 else 1
                by_item[leaf.element_size()] = by_item.get(leaf.element_size(), 0) + n
            scatter_bytes = ici_bytes = dcn_bytes = 0
            if tag == "fed":
                # per leg: the intra-pod rounds on the optimizer's wire, on a
                # DCN step the gateway rounds on the DCN wire
                ici_bytes = metrics.wire_bytes_per_step(by_item, len(d.key[3]), d.key[2])
                if d.key[1] == "dcn":
                    dcn_bytes = metrics.wire_bytes_per_step(by_item, len(d.key[7]), d.key[6])
                wire_bytes = ici_bytes + dcn_bytes
            elif tag == "allreduce":
                if shard is not None and shard.grads:
                    scatter_bytes = scaling.reduce_scatter_bytes(
                        tuple((g.slot, getattr(torch, g.dtype).itemsize) for g in shard.groups),
                        shard.size, wire=self.compression)
                    wire_bytes = scatter_bytes
                    rounds = shard.size - 1
                else:  # a ring allreduce ships ~2 (n - 1) / n payloads a worker
                    payload = sum(i * n for i, n in by_item.items())
                    wire_bytes = int(2 * (ctx.size - 1) / max(ctx.size, 1) * payload)
            else:
                wire_bytes = metrics.wire_bytes_per_step(by_item, rounds, wire)
            if shard is not None:
                wire_bytes += sharding.gather_wire_bytes(shard)
            acct = self._acct_cache[key] = (rounds, wire_bytes, scatter_bytes, ici_bytes,
                                            dcn_bytes)
        rounds, wire_bytes, scatter_bytes, ici_bytes, dcn_bytes = acct
        metrics.gauge("bluefog.gossip.rounds").set(rounds)
        metrics.counter("bluefog.wire_bytes").inc(wire_bytes)
        metrics.counter("bluefog.comm_steps").inc()
        if ici_bytes or dcn_bytes:
            metrics.counter("bluefog.federation.ici_wire_bytes").inc(ici_bytes)
            metrics.counter("bluefog.federation.dcn_wire_bytes").inc(dcn_bytes)
        if shard is not None:
            metrics.gauge("bluefog.shard.enabled").set(1)
            metrics.gauge("bluefog.shard.state_bytes").set(sharding.state_bytes(shard))
            metrics.gauge("bluefog.shard.ratio").set(
                sharding.state_bytes(shard) / max(sharding.state_bytes(shard, sharded=False), 1))
            metrics.counter("bluefog.shard.gather_bytes").inc(sharding.gather_wire_bytes(shard))
            metrics.gauge("bluefog.shard.grads").set(1 if shard.grads else 0)
            if shard.grads:
                metrics.counter("bluefog.shard.scatter_bytes").inc(scatter_bytes)
                metrics.gauge("bluefog.shard.grad_bytes").set(sharding.grad_bytes(shard))

    def step(self, params, opt_state, grads):
        """One decentralized step; updates ``params`` and ``opt_state`` in
        place and returns ``(params, opt_state)``."""
        ctx = ctx_mod.get_context()
        comm_now = self._comm_now()
        if not comm_now and self.order == "grad":
            self._step_count += 1
            self._accumulate(grads)
            return params, opt_state
        d = self._resolve_dispatch(ctx, params, comm_now)
        self._shard_dispatch(ctx, d, params, opt_state, comm_now)
        met_enabled = metrics.enabled() and comm_now
        # one communicating step in the interval runs the probe; the others
        # run exactly the code of metrics off
        met = met_enabled and self._comm_count % metrics.metrics_interval() == 0
        wire_now = self._metrics_wire(comm_now, d.key)
        if comm_now and self.order == "grad":
            grads = self._take_accumulated(grads)
        flight.record("step_begin", step=self._step_count, comm=comm_now)
        self._step_count += 1
        if comm_now:
            self._comm_count += 1
        if met_enabled:
            self._record_comm_accounting(d, params, ctx)
        doc_t0 = attribution.dispatch_timer(comm_now)
        payload = _timed_dispatch("optimizer_step", self._combine_update, d, params, opt_state,
                                  grads, with_metrics=met, wire=wire_now)
        flight.record("step_dispatched", step=self._step_count - 1)
        if comm_now:
            # host-side observers: the dispatched step above is untouched;
            # the two-program path always gossips the fresh iterate (age 0)
            step = self._step_count - 1
            attribution.observe_step(ctx, step=step, outputs=params, plan=self._last_plan,
                                     params=params, wire=self.compression,
                                     dispatch_s=_elapsed(doc_t0))
            health_mod.observe_step(ctx, step=step, plan=self._last_plan)
            stal_mod.observe_step(ctx, step=step, plan=self._last_plan, payload_age=0,
                                  surface="sync")
            # a migration lands as a topology-version bump that the next
            # dispatch re-resolves, as after an elastic repair
            autotune_mod.observe_step(ctx, step=step, optimizer=self, plan=self._last_plan)
            mem_mod.observe_step(ctx, step=step, optimizer=self, params=params,
                                 opt_state=opt_state, grads=grads)
            # last: its sampled pass reads the gauges the hooks above set
            slo_mod.observe_step(ctx, step=step, plan=self._last_plan, wire=self.compression)
        if met:
            self._drain_after_sample(wire_now, payload)
        return params, opt_state

    # -- the fused train step -----------------------------------------------------

    def _ensure_delay_state(self, params, key) -> None:
        """The ``delayed=True`` double buffer: one packed ``[N, n]`` copy
        per dtype group of the previous step's gossip input, seeded from
        the current parameters (step 0 then mixes fresh), rebuilt whenever
        the groups or the communication structure change."""
        sig = (_group_sig(params), key)
        if self._delay_sig == sig:
            return
        self._delay_buf = [_pack(group).clone()
                           for _name, group in _dtype_groups(tree_leaves(params))]
        self._delay_sig = sig
        # a (re)seeded buffer holds the current parameters: the next
        # combine's payload age is 0
        self._delay_birth_comm = self._comm_count

    def _stale_mix(self, d: _Dispatch, params, sw: torch.Tensor) -> None:
        """``y = C(buf) + s * (x - buf)`` per dtype group, in place on the
        parameters, with ``buf`` then refilled with ``x``: the neighbours'
        values are one step stale, the self weight applies to the fresh
        ``x`` (the JAX ``stale_mix``); a ``combine`` phase span."""
        with tl.span("combine", tl.PHASE):
            for (_name, group), buf in zip(_dtype_groups(tree_leaves(params)),
                                           self._delay_buf):
                fresh = _pack(group)
                diff = fresh.to(buf.dtype) - buf
                combined = _bucketed_flat_gossip(buf, d.combine, d.cap_bytes)
                mixed = combined + _col(sw, combined) * diff.to(combined.dtype)
                buf.copy_(fresh)
                _unpack_(group, mixed)

    def make_train_step(self, loss_fn, has_aux: bool = False, delayed: bool = False):
        """The train step: every worker's loss and gradient, the inner
        update and the gossip, through the same core as :meth:`step`, so
        the fused and two-program paths are the same arithmetic::

            train_step = opt.make_train_step(loss_fn)
            params, opt_state, loss = train_step(params, opt_state, *batch)

        ``loss_fn(params, *batch) -> loss`` (``(loss, aux)`` with
        ``has_aux``) runs per worker on unstacked trees: worker ``j`` gets
        ``leaf[j]`` of every parameter and ``b[j]`` of every batch operand
        (a worker-stacked tensor or tree). The gradients are taken worker
        after worker with ``torch.autograd.grad`` (``torch.func.vmap``
        cannot run BatchNorm's in-place statistics or the flash attention
        ``autograd.Function``). Returns ``(params, opt_state, loss [N])``,
        the loss as ``(loss, aux)`` with ``has_aux``; parameters and state
        are updated in place.

        ``delayed=True`` (CTA/ATC) mixes against the payload double-buffered
        from the previous step, the self weight on the fresh value (see
        :meth:`_stale_mix`); step 0 mixes fresh. It refuses the
        error-feedback tiers (the CHOCO copies would integrate a stale
        payload), the hierarchical path, and order ``"grad"``. On one card
        there is nothing to overlap, so the fused step is the two-program
        step in one call."""
        if delayed and self.order == "grad":
            raise ValueError(
                "delayed=True applies to the weight-gossip families "
                "(CTA/ATC); gradient allreduce has no stale-mix variant"
            )
        grads_store = []

        def train_step(params, opt_state, *batch):
            ctx = ctx_mod.get_context()
            if delayed and self.compression in _EF_TIERS:
                raise ValueError(
                    f"compression={self.compression!r} cannot carry error "
                    "feedback across a one-step delay (the CHOCO copies "
                    "would integrate a stale payload and desynchronize); use "
                    "delayed=False or a memoryless wire (None/'int8'/'int4')"
                )
            comm_now = self._comm_now()
            d = self._resolve_dispatch(ctx, params, comm_now)
            self._shard_dispatch(ctx, d, params, opt_state, comm_now)
            if delayed and self.communication_type == \
                    CommunicationType.hierarchical_neighbor_allreduce:
                raise ValueError(
                    "delayed=True is not supported for hierarchical "
                    "communication (the intra-machine sum has no stale-mix "
                    "form); use flat neighbor_allreduce or delayed=False"
                )
            delay_now = delayed and comm_now
            if delay_now:
                self._ensure_delay_state(params, d.key)
            met_enabled = metrics.enabled() and comm_now
            met = met_enabled and self._comm_count % metrics.metrics_interval() == 0
            wire_now = self._metrics_wire(comm_now, d.key)
            flight.record("step_begin", step=self._step_count, comm=comm_now, fused=True)
            if met_enabled:
                self._record_comm_accounting(d, params, ctx)
            # the age of the payload this step's combine consumes: 0 fresh,
            # the communications since the delay buffer was written delayed
            cur_comm = self._comm_count
            payload_age = cur_comm - self._delay_birth_comm if delay_now else 0
            doc_t0 = attribution.dispatch_timer(comm_now)
            loss, aux, payload = _timed_dispatch(
                "fused_train_step", self._fused_body, d, params, opt_state, batch, loss_fn,
                has_aux, grads_store, comm_now, delay_now, met, wire_now)
            flight.record("step_dispatched", step=self._step_count - 1)
            if comm_now:
                step = self._step_count - 1
                attribution.observe_step(ctx, step=step, outputs=loss, plan=self._last_plan,
                                         params=params, wire=self.compression,
                                         dispatch_s=_elapsed(doc_t0))
                health_mod.observe_step(ctx, step=step, plan=self._last_plan)
                stal_mod.observe_step(ctx, step=step, plan=self._last_plan,
                                      payload_age=payload_age,
                                      surface="delayed" if delay_now else "sync")
                autotune_mod.observe_step(ctx, step=step, optimizer=self,
                                          plan=self._last_plan)
                mem_mod.observe_step(ctx, step=step, optimizer=self, params=params,
                                     opt_state=opt_state)
                slo_mod.observe_step(ctx, step=step, plan=self._last_plan,
                                     wire=self.compression)
                if delay_now:  # the step refilled the buffer with its payload
                    self._delay_birth_comm = cur_comm
            if met:
                # the delayed probe measures the stale mix, with no wire slots
                self._drain_after_sample(None if delay_now else wire_now, payload)
            return params, opt_state, ((loss, aux) if has_aux else loss)

        return train_step

    def _fused_body(self, d: _Dispatch, params, opt_state, batch, loss_fn, has_aux,
                    grads_store, comm_now: bool, delay_now: bool, met: bool, wire_now):
        """One fused step after its dispatch is resolved: every worker's
        gradient, then the update and the gossip (``delay_now``: the stale
        mix); returns ``(loss, aux, probe payload or None)``."""
        loss, aux, grads = _worker_grads(loss_fn, has_aux, params, batch, grads_store)
        payload = None
        if self.order == "grad" and not comm_now:
            self._step_count += 1
            self._accumulate(grads)
            return loss, aux, payload
        if comm_now and self.order == "grad":
            grads = self._take_accumulated(grads)
        self._step_count += 1
        if comm_now:
            self._comm_count += 1
        if delay_now:
            sw = d.self_weight()
            if self.order == "cta":
                if met:
                    payload = self._delayed_probe(d, params, grads, sw)
                self._stale_mix(d, params, sw)
                _apply_update(self.tx, params, opt_state, grads)
            else:
                _apply_update(self.tx, params, opt_state, grads)
                if met:
                    payload = self._delayed_probe(d, params, grads, sw)
                self._stale_mix(d, params, sw)
        else:
            payload = self._combine_update(d, params, opt_state, grads, with_metrics=met,
                                           wire=wire_now)
        return loss, aux, payload

    def make_async_train_step(self, loss_fn, has_aux: bool = False, **kwargs):
        """The asynchronous train step of
        :func:`bluefog_tpu_torch.async_gossip.make_async_train_step`: this
        optimizer gives the inner optimizer and, through ``compression``,
        the default wire. With ``BLUEFOG_ASYNC=0`` it is
        :meth:`make_train_step`."""
        from bluefog_tpu_torch import async_gossip

        return async_gossip.make_async_train_step(self, loss_fn, has_aux=has_aux, **kwargs)


def _shard_check_groups(tree, layout, what: str) -> None:
    """The tree's dtype groups must be the ones the layout was built for."""
    got = _group_sig(tree)
    want = tuple((g.dtype, g.elems) for g in layout.groups)
    if got != want:
        raise ValueError(
            f"BLUEFOG_SHARD: the {what} tree packs into dtype groups {got} but the "
            f"shard layout was built for {want}; gradients must share the "
            "parameter tree's dtypes (re-init the optimizer state after changing "
            "the parameters)"
        )


def _gather_slot_rows(rows: torch.Tensor, layout, gi: int) -> torch.Tensor:
    """A group's full vector ``[d]`` from its ``[size, slot]`` slot array:
    the live owners' rows in owner order, padding cut
    (:func:`bluefog_tpu_torch.sharding.gather_rows` on a tensor)."""
    g = layout.groups[gi]
    if tuple(rows.shape) != (layout.size, g.slot):
        raise ValueError(
            f"group {gi} slot array has shape {tuple(rows.shape)}, layout expects "
            f"{(layout.size, g.slot)}"
        )
    return torch.cat([rows[r] for r in layout.live])[:g.elems]


def _slice_slot_rows(full: torch.Tensor, layout, gi: int) -> torch.Tensor:
    """A group's full vector distributed into the ``[size, slot]`` slot
    array on its device, dead workers zero
    (:func:`bluefog_tpu_torch.sharding.slice_rows` on a tensor)."""
    g = layout.groups[gi]
    full = full.reshape(-1)
    if full.numel() != g.elems:
        raise ValueError(
            f"group {gi} full vector has {full.numel()} elements, layout expects {g.elems}"
        )
    out = full.new_zeros((layout.size, g.slot))
    for i, r in enumerate(layout.live):
        part = full[i * g.slot:min((i + 1) * g.slot, g.elems)]
        out[r, :part.numel()] = part
    return out


def _local_workers(layout) -> range:
    """The workers whose rows this process holds: every worker with one
    process."""
    ctx = ctx_mod._context
    if ctx is None or ctx.process_count == 1:
        return range(layout.size)
    return ctx.rows


def _shard_own_slices(tree, layout):
    """Each worker's owned slot of every packed dtype group, ``[N, slot]``
    per group (zeros past the group's end); across processes the local
    workers' ``[n_local, slot]``."""
    live_index = layout.live_index()
    workers = _local_workers(layout)
    lidx = [int(live_index[r]) for r in workers]
    rows = range(len(workers))
    return tuple(inner._slot_rows(_pack(group), rows, lidx, g.slot)
                 for g, (_name, group) in zip(layout.groups, _dtype_groups(tree_leaves(tree))))


def _sharded_inner_update(tx, layout, params, state, grads=None, own_g=None) -> None:
    """The ZeRO-1 update, in place: each worker updates only its owned slot
    of every packed group with its slot of the inner state (against the
    f32 master slices under ``layout.master``), then the live workers'
    updated slots are gathered into every worker's parameters (across
    processes the local workers' slots, then one
    :func:`transport.gather_rows` a group brings every worker's). ``own_g``
    (ZeRO-2) is the scattered gradient slots; otherwise the slots are cut
    from ``grads``. The update is an ``update`` phase span, the gather a
    ``combine`` one."""
    _shard_check_groups(params, layout, "parameter")
    if own_g is None:
        _shard_check_groups(grads, layout, "gradient")
        own_g = _shard_own_slices(grads, layout)
    own_p = _shard_own_slices(params, layout)
    if layout.master:
        _apply_update(tx, state.master, state.inner,
                      tuple(g.to(torch.float32) for g in own_g))
        new_own = tuple(m.to(o.dtype) for m, o in zip(state.master, own_p))
    else:
        _apply_update(tx, own_p, state.inner, own_g)
        new_own = own_p
    live = list(layout.live)
    multi = len(_local_workers(layout)) != layout.size
    with tl.span("combine", tl.PHASE):
        for g, own, (_name, group) in zip(layout.groups, new_own,
                                          _dtype_groups(tree_leaves(params))):
            if multi:
                own = transport.gather_rows(own.contiguous())
            full = own[live].reshape(-1)[:g.elems]
            off = 0
            for leaf in group:
                n = leaf[0].numel()
                leaf.copy_(full[off:off + n].view(leaf.shape[1:]).expand_as(leaf))
                off += n


def _apply_update(tx, params, state, grads) -> None:
    """The inner update ``tx.apply_``, in an ``update`` phase span."""
    with tl.span("update", tl.PHASE):
        tx.apply_(params, state, grads)


def _grad_store(params, store) -> List[torch.Tensor]:
    """Gradient buffers like ``params``' leaves, ``store`` reused from call
    to call while the leaves keep their shapes."""
    leaves = tree_leaves(params)
    if len(store) != len(leaves) or any(
            s.shape != l.shape or s.dtype != l.dtype or s.device != l.device
            for s, l in zip(store, leaves)):
        store[:] = [torch.empty_like(l) for l in leaves]
    return store


def _worker_loss_grad(loss_fn, has_aux, params, batch, j: int, store):
    """Worker ``j``'s loss and gradient: the gradient into row ``j`` of the
    ``store`` leaves, returns ``(loss, aux)`` detached (``aux`` None
    without ``has_aux``). The loss is a ``forward`` phase span, the
    gradient with its copy into the store a ``backward`` one (the autograd
    engine launches the backward's kernels from its own thread while this
    one waits inside the span)."""
    wl = [l[j].detach().requires_grad_(True) for l in tree_leaves(params)]
    with tl.span("forward", tl.PHASE):
        out = loss_fn(_tree_unflatten(params, wl),
                      *(_tree_unflatten(b, [t[j] for t in tree_leaves(b)]) for b in batch))
    loss, aux = out if has_aux else (out, None)
    with tl.span("backward", tl.PHASE):
        for dst, g in zip(store, torch.autograd.grad(loss, wl, allow_unused=True)):
            if g is None:
                dst[j].zero_()
            else:
                dst[j].copy_(g)
    if has_aux:
        aux = _tree_unflatten(aux, [t.detach() for t in tree_leaves(aux)])
    return loss.detach(), aux


def _worker_grads(loss_fn, has_aux, params, batch, store):
    """Every worker's loss and gradient, one worker after another:
    ``(loss [N] f32, aux stacked or None, grads)``, the gradients in a tree
    like ``params`` whose buffers (``store``) are reused from call to call."""
    store = _grad_store(params, store)
    n_workers = store[0].shape[0]
    losses = torch.empty(n_workers, dtype=torch.float32, device=store[0].device)
    auxes = []
    for j in range(n_workers):
        losses[j], aux = _worker_loss_grad(loss_fn, has_aux, params, batch, j, store)
        auxes.append(aux)
    stacked_aux = (_tree_unflatten(auxes[0], [torch.stack(ts) for ts in zip(
        *(tree_leaves(a) for a in auxes))]) if has_aux else None)
    return losses, stacked_aux, _tree_unflatten(params, store)


def DistributedGradientAllreduceOptimizer(base_optimizer,
                                          num_steps_per_communication: int = 1
                                          ) -> _GossipOptimizer:
    """Synchronous gradient averaging (Horovod style)."""
    return _GossipOptimizer(base_optimizer, CommunicationType.allreduce, order="grad",
                            num_steps_per_communication=num_steps_per_communication)


def DistributedAllreduceOptimizer(base_optimizer,
                                  num_steps_per_communication: int = 1) -> _GossipOptimizer:
    """CTA with global weight averaging."""
    return _GossipOptimizer(base_optimizer, CommunicationType.allreduce, order="cta",
                            num_steps_per_communication=num_steps_per_communication)


def DistributedNeighborAllreduceOptimizer(base_optimizer,
                                          num_steps_per_communication: int = 1
                                          ) -> _GossipOptimizer:
    """CTA with neighbor weight gossip, the flagship decentralized
    optimizer."""
    return _GossipOptimizer(base_optimizer, CommunicationType.neighbor_allreduce,
                            order="cta",
                            num_steps_per_communication=num_steps_per_communication)


def DistributedHierarchicalNeighborAllreduceOptimizer(
        base_optimizer, num_steps_per_communication: int = 1) -> _GossipOptimizer:
    """CTA with the machine-level gossip: the average over each machine's
    workers, combined over the machine topology."""
    return _GossipOptimizer(base_optimizer,
                            CommunicationType.hierarchical_neighbor_allreduce, order="cta",
                            num_steps_per_communication=num_steps_per_communication)


def DistributedAdaptThenCombineOptimizer(
        base_optimizer,
        communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
        num_steps_per_communication: int = 1) -> _GossipOptimizer:
    """ATC: local step first, then gossip the updated weights."""
    return _GossipOptimizer(base_optimizer, communication_type, order="atc",
                            num_steps_per_communication=num_steps_per_communication)


def DistributedAdaptWithCombineOptimizer(
        base_optimizer,
        communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
        num_steps_per_communication: int = 1) -> _GossipOptimizer:
    """CTA with a selectable communication type."""
    return _GossipOptimizer(base_optimizer, communication_type, order="cta",
                            num_steps_per_communication=num_steps_per_communication)


# -- the window optimizers -----------------------------------------------------------


class _WindowOptimizer:
    """Shared engine of the win_put / pull-get / push-sum optimizers.

    Every leaf of the parameter tree is packed, in JAX leaf order, into
    ONE flat combo window ``[size, D]`` (for :class:`StackedModel` its flat
    parameter buffer; across processes ``[n_local, D]``, the local rows).
    A step runs the inner update on the window's raw
    value in place, then — on every ``num_steps_per_communication``-th
    call — the exchange and the combine of :mod:`bluefog_tpu_torch.windows`
    (push-sum: ``win_accumulate`` with the mass-residual absorption, then
    the collecting update). Gradients are taken at :meth:`params`."""

    _uids = itertools.count()

    def __init__(self, base_optimizer: SGD, mode: str, window_prefix=None,
                 num_steps_per_communication: int = 1):
        self.tx = base_optimizer
        self.mode = mode  # 'put' | 'get' | 'push_sum'
        self.self_weight = None
        self.dst_weights = None
        self.src_weights = None
        self.num_steps_per_communication = num_steps_per_communication
        self._step_count = 0
        self.prefix = f"_wopt{next(self._uids)}" if window_prefix is None else window_prefix
        self._name = None
        self._template = None
        self._slots = None  # [(start, end, shape, dtype)] per leaf
        self._p_ctx_uid = None
        self._default_topo_v = None
        self._default_sw = self._default_dst = None

    def init(self, params):
        """Create the combo window from ``params`` and return the inner
        optimizer's state."""
        ctx = ctx_mod.get_context()
        leaves = tree_leaves(params)
        for i, leaf in enumerate(leaves):
            if leaf.dim() < 1 or leaf.shape[0] != ctx.n_local:
                raise ValueError(
                    f"window-optimizer parameter leaf {i} must be worker-stacked "
                    f"[{ctx.n_local}, ...]; got shape {tuple(leaf.shape)}"
                )
            if not leaf.dtype.is_floating_point:
                raise TypeError(
                    f"window-optimizer parameter leaf {i} has dtype {leaf.dtype}: "
                    "all leaves share one packed float window; keep integer "
                    "state out of the optimized parameter tree"
                )
        pack_dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            pack_dtype = torch.promote_types(pack_dtype, leaf.dtype)
        self._template = _tree_unflatten(params, [None] * len(leaves))
        self._slots, off = [], 0
        for leaf in leaves:
            n = leaf[0].numel()
            self._slots.append((off, off + n, tuple(leaf.shape[1:]), leaf.dtype))
            off += n
        self._name = f"{self.prefix}.combo"
        packed = torch.cat([leaf.reshape(ctx.n_local, -1).to(pack_dtype) for leaf in leaves],
                           dim=1)
        created = win_mod.win_create(packed, self._name, zero_init=self.mode == "push_sum")
        if not created:
            raise ValueError(f"window {self._name} already exists")
        if self.mode == "push_sum":
            self._p_ctx_uid = ctx.acquire_associated_p()
        return self.tx.init(params)

    def free(self) -> None:
        """Drop the window and this optimizer's hold on the p lane."""
        if self._name is not None and ctx_mod.is_initialized():
            win_mod.win_free(self._name)
        self._name = None
        if self._p_ctx_uid is not None:
            ctx_mod.release_associated_p(self._p_ctx_uid)
            self._p_ctx_uid = None

    def _leaf_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Per-leaf views ``[size, *shape]`` of a ``[size, D]`` tensor."""
        return [flat[:, a:b].view((flat.shape[0],) + shape) for a, b, shape, _ in self._slots]

    def _tree(self, flat: torch.Tensor):
        return _tree_unflatten(self._template, [
            v.to(dtype) for v, (_a, _b, _s, dtype) in zip(self._leaf_views(flat), self._slots)
        ])

    def _window(self):
        if self._name is None:
            raise RuntimeError("call init(params) first")
        return win_mod._get_win(ctx_mod.get_context(), self._name)

    def params(self):
        """The current parameter estimate (a fresh tree): the window value,
        divided by p for push-sum."""
        win = self._window()
        if self.mode == "push_sum":
            return self._tree(win.value / win.p[:, None].to(win.value.dtype))
        return self._tree(win.value.clone())

    def _pushsum_weights(self, ctx):
        """``(self_weight, dst_weights)`` of a push-sum exchange: x and p
        share a column-stochastic split over self and the out-neighbors,
        cached per topology version."""
        if self._default_topo_v != ctx.topo_version:
            outs = ctx.out_neighbor_ranks()
            self._default_sw = [1.0 / (len(o) + 1) for o in outs]
            self._default_dst = [{d: 1.0 / (len(o) + 1) for d in o} for o in outs]
            self._default_topo_v = ctx.topo_version
        return (
            self._default_sw if self.self_weight is None else self.self_weight,
            self._default_dst if self.dst_weights is None else self.dst_weights,
        )

    def step(self, opt_state, grads):
        """One step from gradients taken at :meth:`params`: the inner
        update on the window's raw value (in place), then, on a
        communication step, the exchange and the combine. Returns
        ``(params estimate, opt_state)``."""
        win = self._window()
        k = int(self.num_steps_per_communication)
        if k < 1:
            raise ValueError(
                "num_steps_per_communication must be a positive int, got "
                f"{self.num_steps_per_communication!r}"
            )
        comm_now = self._step_count % k == k - 1
        self._step_count += 1
        out = _timed_dispatch(
            "window_optimizer_step" if comm_now else "window_optimizer_step_local",
            self._step_body, win, opt_state, grads, comm_now)
        if comm_now:
            stal_mod.observe_window(ctx_mod.get_context(), win, step=self._step_count - 1)
        return out

    def _step_body(self, win, opt_state, grads, comm_now: bool):
        views = self._leaf_views(win.value)
        cur = [v.to(dtype) for v, (_a, _b, _s, dtype) in zip(views, self._slots)]
        self.tx.apply_(cur, opt_state, grads)
        for view, c in zip(views, cur):
            if c.data_ptr() != view.data_ptr():
                view.copy_(c)
        if not comm_now:
            win_mod._note_local_step(win)
            return self.params(), opt_state
        ctx = ctx_mod.get_context()
        # the exchange is this optimizer's, not a win_* op: it is not counted
        # in the window-op series (as the JAX package's fused window step)
        if self.mode == "push_sum":
            sw, dst = self._pushsum_weights(ctx)
            win_mod._exchange(ctx, win, "acc", None, sw, dst, hooks=False)
            update_sw, update_nw = win_mod._collect_weights(win)
        else:
            weights = self.dst_weights if self.mode == "put" else self.src_weights
            win_mod._exchange(ctx, win, self.mode, None, self.self_weight, weights, hooks=False)
            update_sw = update_nw = None
        # the exchange and the combine are one local step of the age lane,
        # as in the JAX package's fused window step
        win_mod._dispatch_update(win, ctx, update_sw, update_nw, reset=self.mode == "push_sum",
                                 tick=False)
        return self.params(), opt_state


def DistributedWinPutOptimizer(base_optimizer: SGD, window_prefix=None,
                               num_steps_per_communication: int = 1) -> _WindowOptimizer:
    """Diffusion by pushing the updated weights into the neighbors'
    buffers."""
    return _WindowOptimizer(base_optimizer, "put", window_prefix, num_steps_per_communication)


def DistributedPullGetOptimizer(base_optimizer: SGD, window_prefix=None,
                                num_steps_per_communication: int = 1) -> _WindowOptimizer:
    """Diffusion by pulling the neighbors' current weights."""
    return _WindowOptimizer(base_optimizer, "get", window_prefix, num_steps_per_communication)


def DistributedPushSumOptimizer(base_optimizer: SGD, window_prefix=None,
                                num_steps_per_communication: int = 1) -> _WindowOptimizer:
    """Push-sum SGD on directed graphs: a sender-stochastic
    ``win_accumulate`` of ``(x, p)``, the collecting update, and the
    estimate ``x / p``. The recursion is the accumulated-p one of the JAX
    package (raw ``x`` pushed, ``p`` never reset), which keeps push-sum's
    exact average on graphs that are not weight-balanced."""
    return _WindowOptimizer(base_optimizer, "push_sum", window_prefix,
                            num_steps_per_communication)
