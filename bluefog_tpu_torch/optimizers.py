# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Decentralized optimizers over stacked worker tensors.

Counterpart of ``bluefog_tpu/optimizers.py`` for two families:

- neighbor-allreduce gossip: :func:`DistributedNeighborAllreduceOptimizer`
  (combine-then-adapt, CTA) and :func:`DistributedAdaptThenCombineOptimizer`
  (adapt-then-combine, ATC), with the ``compression`` attribute (``None``,
  ``"int8"``, ``"int4"``, ``"int8_ef"``, ``"int4_ef"``) selecting the exact
  combine, the quantized wire, or the quantized wire with error feedback
  (CHOCO copies kept by the optimizer, one pair per dtype group);
- windows: :func:`DistributedWinPutOptimizer`,
  :func:`DistributedPullGetOptimizer` and :func:`DistributedPushSumOptimizer`
  over one packed window of :mod:`bluefog_tpu_torch.windows`.

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
per step) and returns them; the window optimizers update their window's
value in place.
"""

import itertools
from typing import Callable, List, Optional

import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import windows as win_mod
from bluefog_tpu_torch.collective import inner

__all__ = [
    "SGD",
    "sgd",
    "tree_leaves",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedAdaptThenCombineOptimizer",
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
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _tree_zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _tree_zeros_like(v) for k, v in tree.items()}
    return type(tree)(_tree_zeros_like(t) for t in tree)


class SGD:
    """Functional SGD whose numbers equal ``optax.sgd(lr, momentum)``:
    the trace is ``g + momentum * trace`` from zero, and the update
    ``-lr * trace`` (``-lr * g`` without momentum) is added to the
    parameters — each as its own rounding step, never fused."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None):
        self.learning_rate = float(learning_rate)
        self.momentum = None if momentum is None else float(momentum)

    def init(self, params):
        """The momentum trace (zeros like ``params``), or ``()``."""
        return () if self.momentum is None else _tree_zeros_like(params)

    def apply_(self, params, state, grads) -> None:
        """One update of ``params`` (and the trace in ``state``) in place."""
        p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        t_leaves = tree_leaves(state) if self.momentum is not None else g_leaves
        if not len(p_leaves) == len(g_leaves) == len(t_leaves):
            raise ValueError("params, grads and state differ in structure")
        for p, g, t in zip(p_leaves, g_leaves, t_leaves):
            if self.momentum is not None:
                t.mul_(self.momentum).add_(g)
            p.add_(t * (-self.learning_rate))


def sgd(learning_rate: float, momentum: Optional[float] = None) -> SGD:
    """``optax.sgd`` counterpart (no Nesterov)."""
    return SGD(learning_rate, momentum)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_groups(leaves):
    """Same-dtype leaf groups sorted by dtype name (``_dtype_groups``)."""
    groups = {}
    for leaf in leaves:
        groups.setdefault(_dtype_name(leaf.dtype), []).append(leaf)
    return sorted(groups.items())


def _gossip_group(group, fn) -> None:
    """Gossip one dtype group in place: ``fn`` takes its packed ``[N, n]``
    payload (the leaf itself for a single leaf) and returns the result."""
    if len(group) == 1:
        leaf = group[0]
        out = fn(leaf)
        if out.data_ptr() != leaf.data_ptr():
            leaf.copy_(out)
        return
    n_workers = group[0].shape[0]
    out = fn(torch.cat([leaf.reshape(n_workers, -1) for leaf in group], dim=1))
    off = 0
    for leaf in group:
        n = leaf[0].numel()
        leaf.copy_(out[:, off:off + n].reshape(leaf.shape))
        off += n


def _packed_gossip(tree, gossip_fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    """Gossip every leaf of ``tree`` in place, packed per dtype group in
    JAX leaf order."""
    for _name, group in _dtype_groups(tree_leaves(tree)):
        _gossip_group(group, gossip_fn)


def _packed_gossip_ef(tree, ef_state, ef_combine) -> None:
    """:func:`_packed_gossip` with error feedback: one ``(xhat_self,
    xhat_recv)`` pair per dtype group, threaded through ``ef_combine(flat,
    state)`` and updated in place (``_packed_gossip_ef``, no bucketing)."""
    for (_name, group), state in zip(_dtype_groups(tree_leaves(tree)), ef_state):
        _gossip_group(group, lambda flat, st=state: ef_combine(flat, st))


_EF_TIERS = ("int8_ef", "int4_ef")


class _GossipOptimizer:
    """Shared engine of the neighbor-allreduce optimizers.

    ``compression``: ``None`` (exact combine), ``"int8"`` or ``"int4"``
    (block-scaled quantized wire, difference form, through the CUDA wire
    kernels on the card), ``"int8_ef"`` or ``"int4_ef"`` (the same wires
    with error feedback: the optimizer keeps the CHOCO copies in ``_ef``,
    one ``(xhat_self [N, d], xhat_recv [R, N, d])`` pair per dtype group,
    zeroed whenever the group sizes, the plan's rounds or the tier
    change)."""

    _COMPRESSIONS = (None, "int8", "int4") + _EF_TIERS

    def __init__(self, base_optimizer: SGD, order: str):
        if order not in ("cta", "atc"):
            raise ValueError(f"order must be 'cta' or 'atc', got {order!r}")
        self.tx = base_optimizer
        self.order = order
        self.compression: Optional[str] = None
        self._ef = None
        self._ef_sig = None

    def init(self, params):
        """Per-worker inner-optimizer state (stacked like ``params``)."""
        return self.tx.init(params)

    def free(self) -> None:
        """Drop the error-feedback copies (a later step starts them anew)."""
        self._ef = self._ef_sig = None

    def _ensure_ef_state(self, ctx, params, plan) -> None:
        """Zeroed copies whenever the per-worker group sizes, the plan's
        rounds or the tier change: ``xhat_recv[r]`` integrates round
        ``r``'s fixed source, so a stale copy would break the
        bit-identical-copy invariant."""
        sig = (
            tuple((name, sum(leaf[0].numel() for leaf in group))
                  for name, group in _dtype_groups(tree_leaves(params))),
            plan.perms,
            self.compression,
            ctx.device,
        )
        if self._ef_sig == sig:
            return
        self._ef = tuple(
            inner.ef_state_zeros(ctx.size, n, len(plan.perms), ctx.device)
            for _name, n in sig[0]
        )
        self._ef_sig = sig

    def _gossip(self, ctx, params):
        """This step's in-place gossip of a parameter tree."""
        if self.compression not in self._COMPRESSIONS:
            raise ValueError(
                f"compression must be one of {self._COMPRESSIONS}, got "
                f"{self.compression!r}"
            )
        plan = ctx.static_plan()
        src, self_w, recv_w = inner.plan_operands(plan, ctx.device)
        if self.compression is None:
            return lambda tree: _packed_gossip(
                tree, lambda t: inner.weighted_combine_operands(t, src, self_w, recv_w)
            )
        inner._check_combine_normalized(plan, f"compression={self.compression!r}")
        if self.compression in _EF_TIERS:
            self._ensure_ef_state(ctx, params, plan)
            wire = self.compression[:-len("_ef")]
            return lambda tree: _packed_gossip_ef(
                tree, self._ef,
                lambda flat, st: inner.weighted_combine_quantized_ef_operands(
                    flat, st, src, recv_w, wire=wire, inplace=True
                ),
            )
        wire = self.compression
        return lambda tree: _packed_gossip(
            tree, lambda t: inner.weighted_combine_quantized_operands(
                t, src, recv_w, wire=wire, inplace=True
            )
        )

    def step(self, params, state, grads):
        """One decentralized step over the active topology; updates
        ``params`` and ``state`` in place and returns ``(params, state)``.
        CTA gossips the parameters before the inner update, ATC after."""
        gossip = self._gossip(ctx_mod.get_context(), params)
        if self.order == "cta":
            gossip(params)
        self.tx.apply_(params, state, grads)
        if self.order == "atc":
            gossip(params)
        return params, state


def DistributedNeighborAllreduceOptimizer(base_optimizer: SGD) -> _GossipOptimizer:
    """CTA with neighbor weight gossip, the flagship decentralized
    optimizer."""
    return _GossipOptimizer(base_optimizer, order="cta")


def DistributedAdaptThenCombineOptimizer(base_optimizer: SGD) -> _GossipOptimizer:
    """ATC: local step first, then gossip the updated weights."""
    return _GossipOptimizer(base_optimizer, order="atc")


# -- the window optimizers -----------------------------------------------------------


class _WindowOptimizer:
    """Shared engine of the win_put / pull-get / push-sum optimizers.

    Every leaf of the parameter tree is packed, in JAX leaf order, into
    ONE flat combo window ``[size, D]`` (for :class:`StackedModel` its flat
    parameter buffer). A step runs the inner update on the window's raw
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
            if leaf.dim() < 1 or leaf.shape[0] != ctx.size:
                raise ValueError(
                    f"window-optimizer parameter leaf {i} must be worker-stacked "
                    f"[size={ctx.size}, ...]; got shape {tuple(leaf.shape)}"
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
        packed = torch.cat([leaf.reshape(ctx.size, -1).to(pack_dtype) for leaf in leaves], dim=1)
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
        views = self._leaf_views(win.value)
        cur = [v.to(dtype) for v, (_a, _b, _s, dtype) in zip(views, self._slots)]
        self.tx.apply_(cur, opt_state, grads)
        for view, c in zip(views, cur):
            if c.data_ptr() != view.data_ptr():
                view.copy_(c)
        if comm_now:
            if self.mode == "push_sum":
                sw, dst = self._pushsum_weights(ctx_mod.get_context())
                win_mod.win_accumulate(name=self._name, self_weight=sw, dst_weights=dst)
                win_mod.win_update_then_collect(self._name)
            else:
                if self.mode == "put":
                    win_mod.win_put(name=self._name, self_weight=self.self_weight,
                                    dst_weights=self.dst_weights)
                else:
                    win_mod.win_get(self._name, src_weights=self.src_weights)
                win_mod.win_update(self._name)
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
