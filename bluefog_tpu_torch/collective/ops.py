# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Eager collective facade over the active context.

Counterpart of ``bluefog_tpu/collective/ops.py``. Inputs are worker
tensors ``[size, ...]`` on the context's device; row ``r`` is worker
``r``'s value. Every op has a blocking form and a ``*_nonblocking`` form
that returns an integer handle for :func:`poll`, :func:`synchronize` and
:func:`wait`. On the card a handle holds a ``torch.cuda.Event`` recorded
on the current stream after the op's work, so :func:`poll` asks the event
and :func:`synchronize` waits on it; on the CPU an op has finished when
it returns. No thread is involved either way.

Weight policy (the JAX facade's): per-rank weight specs are sequences, or
dicts keyed by rank, with one entry per rank; a flat ``{rank: float}``
dict raises. With no weights the active topology's plan is used (its
weights if the context is weighted, else the uniform ``1/(in_degree+1)``);
``self_weight`` with ``src_weights`` gives explicit weights, whose keys
must be in-neighbours of the topology unless ``dst_weights`` (dynamic
mode, both ends scale the value) is given too. Plans follow
``BLUEFOG_PLAN_METHOD``.

Across processes (a context whose ``process_count > 1``) a worker tensor
is this process's rows ``[n_local, ...]`` (:attr:`BluefogContext.rows`),
:func:`worker_values` builds them, the weights stay global (one entry per
rank) and each op's result is the local rows of the stacked result
(:mod:`bluefog_tpu_torch.collective.inner`).

Observability, as in the JAX facade: each op's dispatch is an ``ENQUEUE``
span of the timeline (and, while ``torch.profiler`` records, a
``bluefog.<op>`` range of its trace); :func:`synchronize` is a host
blocking point, with ``sync_begin`` / ``sync_ready`` flight records, a
watchdog ``watch`` and a ``SYNCHRONIZE`` span (``bluefog.handle_<n>`` in
the profiler's trace); a new plan is noted in the flight recorder; a
compressed ``neighbor_allgather`` counts its wire bytes and, with
``BLUEFOG_METRICS=1``, samples its quantization error. The JAX facade also
counts ``bluefog.recompiles`` on a fresh program; the port dispatches
eagerly and counts none.
"""

import itertools
import numbers
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import flight, metrics, watchdog
from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch.collective import compiler, inner
from bluefog_tpu_torch.collective.plan import CommPlan, plan_from_weights

__all__ = [
    "worker_values",
    "allreduce",
    "allreduce_nonblocking",
    "allgather",
    "allgather_nonblocking",
    "broadcast",
    "broadcast_nonblocking",
    "neighbor_allreduce",
    "neighbor_allreduce_nonblocking",
    "neighbor_allgather",
    "neighbor_allgather_nonblocking",
    "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_nonblocking",
    "pair_gossip",
    "pair_gossip_nonblocking",
    "poll",
    "synchronize",
    "wait",
    "barrier",
]

_COMPRESSIONS = (None, "int8", "bf16", "int4")

# -- handle model ----------------------------------------------------------------------

# handle -> (result, event or None, post)
_handle_map: Dict[int, Tuple] = {}
_handle_counter = itertools.count()

# Above this many outstanding handles each new one reaps the oldest whose
# results are ready: a caller that never synchronizes (gossip-and-move-on)
# would otherwise pin every superseded result. Pending results are never
# reaped; <= 0 disables reaping.
_HANDLE_REAP_THRESHOLD = int(os.environ.get("BLUEFOG_HANDLE_REAP_THRESHOLD", "1024"))


def _ready(entry) -> bool:
    event = entry[1]
    return event is None or event.query()


def _reap_ready_handles() -> None:
    if _HANDLE_REAP_THRESHOLD <= 0 or len(_handle_map) <= _HANDLE_REAP_THRESHOLD:
        return
    excess = len(_handle_map) - _HANDLE_REAP_THRESHOLD
    for handle in sorted(_handle_map)[: 4 * excess]:
        if excess <= 0:
            break
        if _ready(_handle_map[handle]):
            del _handle_map[handle]
            excess -= 1


def _new_handle(result, post=None) -> int:
    """Register an op's result; ``post`` runs at :func:`synchronize`, so
    nonblocking + synchronize returns what the blocking op does."""
    _reap_ready_handles()
    device = ctx_mod.get_context().device
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    handle = next(_handle_counter)
    _handle_map[handle] = (result, event, post)
    return handle


def poll(handle: int) -> bool:
    """True when the op behind ``handle`` has finished; a handle no longer
    held (synchronized, or reaped when ready) polls True."""
    entry = _handle_map.get(handle)
    return True if entry is None else _ready(entry)


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its output."""
    entry = _handle_map.pop(handle, None)
    if entry is None:
        raise ValueError(
            f"unknown handle {handle}: already synchronized, or reclaimed "
            "as fire-and-forget (a ready handle left unsynchronized past "
            f"{_HANDLE_REAP_THRESHOLD} outstanding ops). Synchronize "
            "handles promptly when you need their results."
        )
    result, event, post = entry
    _blocking_wait(handle, event)
    return post(result) if post is not None else result


def _blocking_wait(handle: int, event) -> None:
    """Wait on ``event`` (None: the op has finished) as a host blocking
    point, where a hang becomes observable: ``sync_begin`` / ``sync_ready``
    flight records, a watchdog ``watch`` and a ``SYNCHRONIZE`` span."""
    flight.record("sync_begin", handle=handle)
    with watchdog.watch(f"synchronize(handle {handle})"):
        with tl.span(f"handle_{handle}", "SYNCHRONIZE"):
            if event is not None:
                event.synchronize()
    flight.record("sync_ready", handle=handle)


def wait(handle: int):
    """Alias of :func:`synchronize`."""
    return synchronize(handle)


def barrier() -> None:
    """Return when the device has finished all work queued so far."""
    _enqueue("barrier", inner.barrier, ctx_mod.get_context().device)


def _enqueue(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: an op's or an optimizer step's dispatch, an
    ``ENQUEUE`` :func:`~bluefog_tpu_torch.timeline.span` (the JAX
    ``_timed_dispatch``; the optimizers' ``_timed_dispatch`` adds the
    memory observatory's phase)."""
    with tl.span(name, "ENQUEUE"):
        return fn(*args, **kwargs)


# -- helpers ---------------------------------------------------------------------------


def worker_values(values, dtype=None) -> torch.Tensor:
    """Stack per-worker values into a ``[size, ...]`` tensor on the
    context's device (across processes ``[n_local, ...]``, this process's
    rows). ``values`` is a callable ``rank -> array``, a sequence of
    per-rank arrays (one per rank of all processes), or one array
    broadcast to every worker."""
    ctx = ctx_mod.get_context()
    if callable(values):
        stacked = np.stack([np.asarray(values(r)) for r in ctx.rows])
    elif isinstance(values, (list, tuple)):
        if len(values) != ctx.size:
            raise ValueError(
                f"expected {ctx.size} per-worker values, got {len(values)}"
            )
        stacked = np.stack([np.asarray(values[r]) for r in ctx.rows])
    else:
        arr = np.asarray(values)
        stacked = np.broadcast_to(arr, (ctx.n_local,) + arr.shape)
    out = torch.from_numpy(np.ascontiguousarray(stacked)).to(ctx.device)
    return out if dtype is None else out.to(dtype)


def _check_worker_tensor(ctx, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[0] != ctx.n_local:
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(
            f"expected a worker tensor with leading axis {ctx.n_local}, got {shape}"
        )
    if x.device != ctx.device:
        raise ValueError(f"x is on {x.device}, the context on {ctx.device}")
    return x


def _reject_flat_weight_dict(arg_name, value) -> None:
    if isinstance(value, dict) and value and all(
        isinstance(v, numbers.Number) for v in value.values()
    ):
        raise ValueError(
            f"{arg_name} looks like a single rank's flat {{rank: weight}} "
            "dict. Pass per-rank specs: a sequence (or {rank: ...} dict) of "
            f"one entry per rank, e.g. {arg_name}=[{{...}} for each rank]."
        )


def _resolve_plan(ctx, self_weight, src_weights, dst_weights,
                  enable_topo_check: bool) -> CommPlan:
    """The weight policy: the static plan with no weights; explicit
    combine weights with ``self_weight`` + ``src_weights`` (keys must be
    in-neighbours unless ``dst_weights`` is given); dynamic mode with
    ``dst_weights`` (send/recv symmetry checked unless disabled)."""
    if (self_weight is None) != (src_weights is None):
        raise ValueError(
            "Arguments self_weight and src_weights have to be presented at "
            "the same time."
        )
    _reject_flat_weight_dict("src_weights", src_weights)
    if self_weight is None and src_weights is None:
        if dst_weights is not None:
            raise ValueError(
                "Arguments self_weight and src_weights should be presented "
                "if enabling dynamic topology (dst_weights)."
            )
        return ctx.static_plan()
    if dst_weights is None:
        in_sets = ctx.in_neighbor_sets()
        per_rank = (
            [src_weights.get(r, {}) for r in range(ctx.size)]
            if isinstance(src_weights, dict) else list(src_weights)
        )
        for r, entry in enumerate(per_rank):
            keys = set(entry.keys() if isinstance(entry, dict) else entry)
            if not keys.issubset(in_sets[r]):
                raise ValueError(
                    f"src_weights for rank {r} contains {sorted(keys - in_sets[r])} "
                    "which are not in-neighbors of the current topology."
                )
    plan = plan_from_weights(
        ctx.size, self_weight, src_weights, dst_weights,
        enable_topo_check=enable_topo_check and dst_weights is not None,
        method=compiler.plan_method(),
    )
    # rebuilt each call; the recorder keeps each distinct structure once
    flight.note_plan(plan, ctx.topo_version, ctx.live_token())
    return plan


# -- classic collectives ---------------------------------------------------------------


def allreduce_nonblocking(x, average: bool = True, name: Optional[str] = None) -> int:
    x = _check_worker_tensor(ctx_mod.get_context(), x)
    return _new_handle(_enqueue("allreduce", inner.allreduce, x, average=average))


def allreduce(x, average: bool = True, name: Optional[str] = None):
    """Every worker's slot becomes the mean (or the sum) over all workers."""
    return synchronize(allreduce_nonblocking(x, average, name))


def allgather_nonblocking(x, name: Optional[str] = None) -> int:
    x = _check_worker_tensor(ctx_mod.get_context(), x)
    return _new_handle(_enqueue("allgather", inner.allgather, x))


def allgather(x, name: Optional[str] = None):
    """``[size, d0, ...]`` -> ``[size, size * d0, ...]``: row ``r`` is
    worker ``r``'s copy of all workers' slots concatenated."""
    return synchronize(allgather_nonblocking(x, name))


def broadcast_nonblocking(x, root_rank: int, name: Optional[str] = None) -> int:
    x = _check_worker_tensor(ctx_mod.get_context(), x)
    return _new_handle(_enqueue("broadcast", inner.broadcast, x, root_rank))


def broadcast(x, root_rank: int, name: Optional[str] = None):
    """Every worker's slot becomes the root's value."""
    return synchronize(broadcast_nonblocking(x, root_rank, name))


# -- neighbor collectives --------------------------------------------------------------


def neighbor_allreduce_nonblocking(
    x,
    *,
    self_weight=None,
    src_weights=None,
    dst_weights=None,
    enable_topo_check: bool = True,
    compression: Optional[str] = None,
    name: Optional[str] = None,
) -> int:
    _check_compression(compression)
    ctx = ctx_mod.get_context()
    x = _check_worker_tensor(ctx, x)
    plan = _resolve_plan(ctx, self_weight, src_weights, dst_weights, enable_topo_check)
    return _combine_nonblocking(x, plan, compression)


def _check_compression(compression: Optional[str]) -> None:
    """Refuse a ``neighbor_allreduce`` wire other than None, int8, bf16
    or int4."""
    if compression not in _COMPRESSIONS:
        raise ValueError(
            "compression must be None, 'int8', 'bf16', or 'int4', got "
            f"{compression!r}"
        )


def _combine_nonblocking(x, plan: CommPlan, compression: Optional[str]) -> int:
    """The combine of a checked worker tensor over a resolved plan, exact
    or on the ``compression`` wire."""
    if compression is None:
        return _new_handle(_enqueue("neighbor_allreduce", inner.neighbor_allreduce, x, plan))
    return _new_handle(_enqueue("neighbor_allreduce", inner.weighted_combine_quantized, x,
                                plan, wire=compression))


def neighbor_allreduce(
    x,
    *,
    self_weight=None,
    src_weights=None,
    dst_weights=None,
    enable_topo_check: bool = True,
    compression: Optional[str] = None,
    name: Optional[str] = None,
):
    """Weighted averaging with in-neighbours over the active topology, or
    with explicit (``self_weight``, ``src_weights``) or dynamic
    (``dst_weights`` too) weights. ``compression='int8'`` or ``'int4'``
    ships the block-scaled quantized wire through the CUDA ``encode`` and
    ``decode_accumulate`` kernels, ``'bf16'`` the payload rounded to bf16,
    each in the difference form, and each refuses weights whose receiver
    sums are not 1."""
    return synchronize(neighbor_allreduce_nonblocking(
        x, self_weight=self_weight, src_weights=src_weights, dst_weights=dst_weights,
        enable_topo_check=enable_topo_check, compression=compression, name=name,
    ))


def neighbor_allgather_nonblocking(
    x, name: Optional[str] = None, *, compression: Optional[str] = None,
) -> int:
    ctx = ctx_mod.get_context()
    x = _check_worker_tensor(ctx, x)
    if compression is not None:
        if compression not in ("bf16", "int8", "int4"):
            raise ValueError(
                "neighbor_allgather compression must be None, 'bf16', "
                f"'int8', or 'int4', got {compression!r}"
            )
        if not x.is_floating_point():
            raise ValueError(
                f"quantized neighbor_allgather needs a float payload, got {x.dtype}"
            )
    plan = ctx.static_plan()
    in_neighbors = plan.in_neighbors
    if compression is not None and metrics.enabled():
        metrics.record_allgather_wire(
            x, compression, plan.wire_bytes(x[0].numel(), x.element_size(), wire=compression))

    def post(result):
        vals, _mask = result
        return [vals[i, :len(in_neighbors[r])] for i, r in enumerate(ctx.rows)]

    return _new_handle(_enqueue("neighbor_allgather", inner.neighbor_allgather, x, plan,
                                wire=compression), post)


def neighbor_allgather(
    x, name: Optional[str] = None, *, compression: Optional[str] = None,
) -> List[torch.Tensor]:
    """In-neighbour values, rank-ascending, as a per-rank list: entry
    ``r`` is ``[in_degree_r, ...]``. ``compression='bf16'|'int8'|'int4'``
    ships the values on that wire (int8/int4 through the CUDA ``encode``
    and ``decode`` kernels); receivers get ``dequant(Q(x))``."""
    return synchronize(neighbor_allgather_nonblocking(x, name, compression=compression))


def _machine_plan(ctx, self_weight, neighbor_machine_weights, send_neighbor_machines,
                  enable_topo_check: bool) -> CommPlan:
    if self_weight is None and neighbor_machine_weights is None:
        return ctx.machine_plan(compiler.plan_method())
    if self_weight is None or neighbor_machine_weights is None:
        raise ValueError(
            "self_weight and neighbor_machine_weights must be presented together"
        )
    _reject_flat_weight_dict("neighbor_machine_weights", neighbor_machine_weights)
    return plan_from_weights(
        ctx.machine_size, self_weight, neighbor_machine_weights, send_neighbor_machines,
        enable_topo_check=enable_topo_check and send_neighbor_machines is not None,
    )


def hierarchical_neighbor_allreduce_nonblocking(
    x,
    *,
    self_weight: Optional[float] = None,
    neighbor_machine_weights=None,
    send_neighbor_machines=None,
    enable_topo_check: bool = True,
    name: Optional[str] = None,
) -> int:
    ctx = ctx_mod.get_context()
    x = _check_worker_tensor(ctx, x)
    mplan = _machine_plan(ctx, self_weight, neighbor_machine_weights,
                          send_neighbor_machines, enable_topo_check)
    return _new_handle(_enqueue("hier_neighbor_allreduce", inner.hierarchical_neighbor_allreduce,
                                x, mplan, ctx.local_size))


def hierarchical_neighbor_allreduce(
    x,
    *,
    self_weight=None,
    neighbor_machine_weights=None,
    send_neighbor_machines=None,
    enable_topo_check: bool = True,
    name: Optional[str] = None,
):
    """Machine-level gossip: the sum over each machine's workers, the
    machine plan's combine (the machine topology's, or explicit
    ``self_weight`` + ``neighbor_machine_weights``, dynamic with
    ``send_neighbor_machines``), divided by the machine's worker count and
    given to each of them."""
    return synchronize(hierarchical_neighbor_allreduce_nonblocking(
        x, self_weight=self_weight, neighbor_machine_weights=neighbor_machine_weights,
        send_neighbor_machines=send_neighbor_machines,
        enable_topo_check=enable_topo_check, name=name,
    ))


def _resolve_pairs(ctx, target_ranks) -> Tuple[Tuple[int, int], ...]:
    """Disjoint ``[(a, b), ...]`` pairs, or a per-rank ``target_ranks``
    list (an involution; -1 or None sits out)."""
    target_ranks = list(target_ranks)
    if target_ranks and isinstance(target_ranks[0], (tuple, list)):
        pairs = tuple((int(a), int(b)) for a, b in target_ranks)
        seen = set()
        for a, b in pairs:
            if not (0 <= a < ctx.size and 0 <= b < ctx.size):
                raise ValueError(
                    f"pair_gossip pair ({a}, {b}) out of range for {ctx.size} workers"
                )
            if a == b:
                raise ValueError(f"pair_gossip partner must differ (rank {a})")
            if a in seen or b in seen:
                raise ValueError(f"pair_gossip: rank in more than one pair: ({a}, {b})")
            seen.update((a, b))
        return pairs
    if len(target_ranks) != ctx.size:
        raise ValueError(
            "per-rank target_ranks must list one partner per rank (use -1 for "
            "ranks that sit out)"
        )
    pairs = []
    for a, b in enumerate(target_ranks):
        if b is None or b < 0:
            continue
        if b >= ctx.size:
            raise ValueError(f"pair_gossip target {b} out of range for {ctx.size} workers")
        if b == a:
            raise ValueError(f"pair_gossip partner must differ (rank {a})")
        if target_ranks[b] != a:
            raise ValueError(
                f"pair_gossip targets must be mutual: rank {a} -> {b} but "
                f"rank {b} -> {target_ranks[b]}"
            )
        if a < b:
            pairs.append((a, b))
    return tuple(pairs)


def pair_gossip_nonblocking(x, target_ranks, self_weight=None, extra_weight=None,
                            name=None) -> int:
    ctx = ctx_mod.get_context()
    x = _check_worker_tensor(ctx, x)
    pairs = _resolve_pairs(ctx, target_ranks)
    return _new_handle(_enqueue("pair_gossip", inner.pair_gossip, x, pairs, self_weight,
                                extra_weight))


def pair_gossip(x, target_ranks: Sequence, self_weight=None, extra_weight=None, name=None):
    """Average with exactly one partner: ``self_weight * x + extra_weight *
    x_partner`` (1/2 each by default); ranks without a partner keep
    their value."""
    return synchronize(pair_gossip_nonblocking(x, target_ranks, self_weight, extra_weight,
                                               name))
