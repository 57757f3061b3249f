# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Weighted combines over the stacked worker axis.

Counterpart of ``bluefog_tpu/collective/inner.py``. There every function
runs inside ``shard_map`` on one worker's block and a round is a
``lax.ppermute``; here ``x`` is the whole ``[N, ...]`` worker tensor and a
round is a gather along the leading axis: row ``j`` of round ``r`` is
``x[src[r, j]]``, or zeros when ``src[r, j] == -1`` (what ``ppermute``
delivers to a non-destination, whose weight is 0). The arithmetic follows
the JAX functions op for op, so the stacked results equal the mesh
results slot for slot.

A short-cut (relay) plan's rounds are unit hops along which a relay
forwards, verbatim, the value it received in the round before (the JAX
``_chunked_exact_combine`` with ``inject``, and the relay branches of the
quantized combine and of :func:`neighbor_allgather`). The transit
recursion is replayed on the host (:func:`compiler.relay_sources`), so
the value worker ``j`` receives in round ``r`` is bit for bit one origin's
row, and :meth:`CommPlan.sources` names it: every combine below takes the
relay plan's origin rows as its ``src`` and stays one gather a round (the
int8/int4 combine one ``encode`` and one ``decode_accumulate`` over every
round). A round in which a receiver only passes the value on carries
weight 0 and is added all the same, as JAX adds ``recv * 0`` (a NaN
included). :func:`neighbor_allgather` reads the neighbour relations of
the delivery table, so a relay plan gathers exactly what the direct plan
does.

Across processes (a context whose ``process_count > 1``) ``x`` is this
process's rows ``[n_local, ...]``: :func:`plan_operands` returns a
:class:`~bluefog_tpu_torch.collective.transport.Route` in place of the
``src`` tensor (a relay plan's
:class:`~bluefog_tpu_torch.collective.transport.RelayRoute`, which
forwards each row hop by hop as the relay does, one batch a round), with
the weights' local columns, and each combine ships
the rows the route names first (:meth:`Route.exchange`) and then runs the
stacked arithmetic on the extended buffer, receiver by receiver in the
same round order, so the local rows are bitwise the stacked ones: the
exact and bf16 combines gather from it, the int8/int4 combine runs one
``encode`` of the local rows, the transport and one ``decode_accumulate``
over the extended payload, the EF combine ``encode_diff`` of the local rows
and a ``decode_add`` a round from the extended payload into the local
copies. The transport ships whole rows, so ``chunks`` is not used there
(a chunked combine is bitwise the monolithic one anyway). The step-indexed
combine reads its step on the host (the route depends on it); the machine
leg of the hierarchical combines runs over the machines' partition (one
machine per process by default); :func:`allreduce` and :func:`allgather`
gather every row first (:func:`transport.gather_rows`) and reduce in the
stacked order, so they are bitwise the stacked results; :func:`broadcast`
ships the root's row from its owner; :func:`barrier` adds the group's
barrier; :func:`reduce_scatter` runs each circulant round as a route
with one sender row per receiver (one batch a round, see
:func:`_reduce_scatter_route`); :func:`lineage_exchange` ships each
round's tags on that round's route.

Chunking (``chunks > 1``) splits only the transfers, on the 512-element
grid, in wavefront order (chunk ``c`` of round ``r`` beside chunk ``c + 1``
of round ``r - 1``): the exact and bf16 combines and the reduce-scatter
gather each ``(round, chunk)`` and put each round back together before the
accumulate; the int8/int4 combines copy the payload chunk-major and launch
their decoders per chunk (per ``(round, chunk)`` for the EF copies). The
arithmetic is the monolithic one, so the result is bitwise the monolithic
result. On one card no wire overlaps, so a chunked or bucketed combine
costs copies and launches and buys nothing: the optimizers price the
stacked transport (:data:`compiler.TRANSPORT_LINK_CLASS`) and bucket at
:func:`transport_bucket_cap`, one chunk and one bucket unless
``BLUEFOG_PLAN_CHUNKS`` or ``BLUEFOG_BUCKET_BYTES`` asks for more.
"""

import contextlib
import os
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.collective import kernels, transport
from bluefog_tpu_torch.collective.plan import CommPlan, SchedulePlan
from bluefog_tpu_torch.collective.transport import Route

__all__ = [
    "bucket_bytes_cap",
    "transport_bucket_cap",
    "bucket_bounds",
    "chunk_bounds",
    "weighted_combine",
    "weighted_combine_operands",
    "weighted_combine_quantized",
    "weighted_combine_quantized_operands",
    "weighted_combine_quantized_ef_operands",
    "ef_state_zeros",
    "neighbor_allreduce",
    "neighbor_allreduce_step",
    "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_operands",
    "hierarchical_neighbor_allreduce_step",
    "hierarchical_neighbor_allreduce_quantized",
    "neighbor_allgather",
    "allreduce",
    "allgather",
    "reduce_scatter",
    "broadcast",
    "pair_gossip",
    "barrier",
    "lineage_exchange",
    "plan_operands",
    "schedule_operands",
    "record_transfers",
]


# The quantization block: bucket and chunk bounds snap to it, so a bucketed
# or chunked payload splits into exactly the blocks of the whole payload.
_QUANT_CHUNK = kernels.CHUNK


def bucket_bytes_cap() -> int:
    """The gossip bucket cap in bytes: ``BLUEFOG_BUCKET_BYTES`` (default 4
    MiB); ``BLUEFOG_OVERLAP=0`` turns bucketing off (0, no cap)."""
    if os.environ.get("BLUEFOG_OVERLAP", "1").lower() in ("0", "false", "off"):
        return 0
    from bluefog_tpu_torch.logging_util import env_int

    return env_int("BLUEFOG_BUCKET_BYTES", 4 << 20)


def transport_bucket_cap() -> int:
    """The bucket cap of the port's stacked transport: buckets let one
    bucket's wire time hide behind the next one's work, and one process
    on one card has no wire, so one bucket (0) unless
    ``BLUEFOG_BUCKET_BYTES`` is set; then :func:`bucket_bytes_cap`
    (``BLUEFOG_OVERLAP=0`` still turns it off)."""
    if not os.environ.get("BLUEFOG_BUCKET_BYTES", "").strip():
        return 0
    return bucket_bytes_cap()


def bucket_bounds(n_elems: int, itemsize: int,
                  cap_bytes: Optional[int] = None) -> List[Tuple[int, int]]:
    """Contiguous ``[start, end)`` bucket bounds of a flat payload of
    ``n_elems`` per worker: one bucket under the cap (or with ``cap_bytes
    <= 0``), else buckets of the cap's width snapped down to whole 512-element
    blocks (at least one block), so the quantized wire's block scales are
    those of the whole payload."""
    if cap_bytes is None:
        cap_bytes = bucket_bytes_cap()
    if cap_bytes <= 0 or n_elems == 0:
        return [(0, n_elems)]
    per = max(1, cap_bytes // max(1, itemsize))
    per = max(per - per % _QUANT_CHUNK, _QUANT_CHUNK)
    if per >= n_elems:
        return [(0, n_elems)]
    return [(i, min(i + per, n_elems)) for i in range(0, n_elems, per)]


def chunk_bounds(n_elems: int, chunks: int) -> List[Tuple[int, int]]:
    """Contiguous splits of a flat payload into about ``chunks`` pipeline
    chunks, every interior bound on the 512-element grid; ``chunks <= 1``
    or a payload of one block gives one chunk, and a payload too small for
    the count gives fewer."""
    k = max(1, int(chunks))
    if k <= 1 or n_elems <= _QUANT_CHUNK:
        return [(0, n_elems)]
    per = -(-n_elems // k)
    if per % _QUANT_CHUNK:
        per += _QUANT_CHUNK - per % _QUANT_CHUNK
    if per >= n_elems:
        return [(0, n_elems)]
    return [(i, min(i + per, n_elems)) for i in range(0, n_elems, per)]


def _chunk_group_bounds(bounds: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Element bounds -> quantization block bounds: chunk ``[a, b)`` covers
    blocks ``a // 512 .. ceil(b / 512)`` of the whole payload's wire pair."""
    return [(a // _QUANT_CHUNK, -(-b // _QUANT_CHUNK)) for a, b in bounds]


def _wavefront(n_rounds: int, n_chunks: int):
    """The pipelined issue order: wave ``w`` holds every ``(round r, chunk
    c)`` with ``r + c == w``."""
    for wave in range(n_rounds + n_chunks - 1):
        for c in range(n_chunks):
            r = wave - c
            if 0 <= r < n_rounds:
                yield r, c


def _chunk_layout(n_elems: int, chunks: int) -> Tuple[int, int]:
    """``(chunk count, chunk width)`` of :func:`chunk_bounds`, the width
    padded to whole 512-element blocks."""
    bounds = chunk_bounds(n_elems, chunks)
    return len(bounds), -(-(bounds[0][1] - bounds[0][0]) // _QUANT_CHUNK) * _QUANT_CHUNK


def _to_chunk_major(t: torch.Tensor, n_chunks: int, width: int) -> torch.Tensor:
    """A chunk-major copy of ``t [..., N, m]`` (unit stride along ``m``):
    ``[..., n_chunks, N, width]``, chunk ``c`` holding columns ``[c *
    width, (c + 1) * width)``, zeros past ``m``; each chunk of it is
    contiguous, as the wire kernels take their operands."""
    lead, (rows, m) = tuple(t.shape[:-2]), tuple(t.shape[-2:])
    full = min(m // width, n_chunks)
    shape = lead + (n_chunks, rows, width)
    out = t.new_empty(shape) if full * width == m and full == n_chunks else t.new_zeros(shape)
    if full:
        out[..., :full, :, :] = t[..., :full * width].view(lead + (rows, full, width)) \
            .transpose(-3, -2)
    if m > full * width:
        out[..., full, :, :m - full * width] = t[..., full * width:]
    return out


def _from_chunk_major(cm: torch.Tensor, t: torch.Tensor) -> None:
    """Write a chunk-major tensor back into ``t [..., N, m]`` (its first
    ``m`` columns), the inverse of :func:`_to_chunk_major`."""
    lead, (rows, m) = tuple(t.shape[:-2]), tuple(t.shape[-2:])
    width = cm.shape[-1]
    full = min(m // width, cm.shape[-3])
    if full:
        t[..., :full * width].view(lead + (rows, full, width)).copy_(
            cm[..., :full, :, :].transpose(-3, -2))
    if m > full * width:
        t[..., full * width:] = cm[..., full, :, :m - full * width]


def _weight_dtype(x: torch.Tensor) -> torch.dtype:
    """Float and complex inputs combine in their own dtype (JAX's
    ``inexact``); integers in float32."""
    return x.dtype if x.is_floating_point() or x.is_complex() else torch.float32


def _multi_process():
    """The active context when it spans several processes, else None."""
    from bluefog_tpu_torch import context as ctx_mod

    ctx = ctx_mod._context
    return ctx if ctx is not None and ctx.process_count > 1 else None


def _local_operands(rt: Route, self_w: np.ndarray, recv_w: np.ndarray, device):
    """The route ``rt`` and the weights' local columns (``self_w [n]``,
    ``recv_w [R, n]``), on ``device``."""
    cols = slice(rt.lo, rt.hi)
    return (rt, torch.from_numpy(np.array(self_w[cols])).to(device),
            torch.from_numpy(np.array(recv_w[:, cols])).to(device))


def plan_operands(plan: CommPlan, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(src [R, N] int32, self_w [N] f32, recv_w [R, N] f32)`` of a plan,
    on ``device``: ``src`` is :meth:`CommPlan.sources`, a relay plan's
    origin rows. Across processes ``src`` is the plan's
    :class:`~bluefog_tpu_torch.collective.transport.Route` (a relay plan's
    :class:`~bluefog_tpu_torch.collective.transport.RelayRoute`, which
    forwards hop by hop) and the weights are this process's columns
    (``[n_local]``, ``[R, n_local]``)."""
    self_w, recv_w = plan.weight_operands()
    ctx = _multi_process()
    if ctx is not None:
        # a relay hop by hop, as it ships (not straight from the origin)
        rt = (transport.relay_route(plan, ctx) if plan.relay else transport.route(np.array(plan.sources()), plan.size, ctx))
        return _local_operands(rt, self_w, recv_w, device)
    return (
        torch.from_numpy(np.array(plan.sources())).to(device),
        torch.from_numpy(self_w).to(device),
        torch.from_numpy(recv_w).to(device),
    )


# The logs of the open record_transfers() blocks.
_RECORDERS: List[list] = []


@contextlib.contextmanager
def record_transfers():
    """Log the transfers the combines make inside the block, in order:
    ``("gather", bytes)`` for each gather along the worker axis (the
    stacked ``ppermute``; the bytes are one worker's row), ``("route",
    route)`` for each :class:`Route` a combine posted across processes,
    ``("all-reduce", bytes)`` for each :func:`allreduce` (one worker's
    logical payload). Yields the log, a list
    (:func:`bluefog_tpu_torch.scaling.gossip_comm_stats` counts it)."""
    log: list = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def _note(kind: str, value) -> None:
    for log in _RECORDERS:
        log.append((kind, value))


def _row_bytes(t: torch.Tensor) -> int:
    return t[0].numel() * t.element_size() if t.shape[0] else 0


def _gather(x: torch.Tensor, src_r: torch.Tensor) -> torch.Tensor:
    """One round of the stacked ``ppermute``: row ``j`` is
    ``x[src_r[j]]``, zeros where ``src_r[j] < 0``."""
    if _RECORDERS:
        _note("gather", _row_bytes(x))
    idx = src_r.to(torch.long)
    got = x.index_select(0, idx.clamp(min=0))
    has = (idx >= 0).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(has, got, torch.zeros((), dtype=x.dtype, device=x.device))


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-worker vector ``[N]`` shaped to broadcast against ``like``."""
    return v.to(like.dtype).view((-1,) + (1,) * (like.dim() - 1))


def _zero_unsent(t: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """``t`` with the rows of no sender (``has`` False) zeroed."""
    return torch.where(has.view((-1,) + (1,) * (t.dim() - 1)), t,
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _wavefront_gathers(parts: List[Tuple[torch.Tensor, ...]], src: torch.Tensor):
    """The transfers of a chunked combine: chunk ``c`` of round ``r`` is
    every tensor of ``parts[c]`` gathered by ``src[r]``, issued in
    wavefront order; returns each round's chunks put back together along
    the flat axis (one list per round, one tensor per tensor of a part).
    A row with no sender (``src[r, j] == -1``) holds worker 0's values: the
    caller zeroes or skips it."""
    n_rounds, n_chunks = src.shape[0], len(parts)
    safe = [src[r].to(torch.long).clamp(min=0) for r in range(n_rounds)]
    recv = [[None] * n_chunks for _ in range(n_rounds)]
    for r, c in _wavefront(n_rounds, n_chunks):
        if _RECORDERS:
            _note("gather", sum(_row_bytes(t) for t in parts[c]))
        recv[r][c] = [t.index_select(0, safe[r]) for t in parts[c]]
    return [[row[0][k] if n_chunks == 1 else torch.cat([p[k] for p in row], dim=1)
             for k in range(len(parts[0]))]
            for row in recv]


def _chunked_rounds(parts: List[torch.Tensor], src: torch.Tensor) -> List[torch.Tensor]:
    """:func:`_wavefront_gathers` of single tensors: each round's received
    ``[N, n]`` payload, zeros where no sender sent (as ``ppermute``
    delivers)."""
    return [_zero_unsent(got, src[r] >= 0)
            for r, (got,) in enumerate(_wavefront_gathers([(p,) for p in parts], src))]


def _chunked_exact_combine(xw: torch.Tensor, src: torch.Tensor, self_w: torch.Tensor,
                           recv_w: torch.Tensor, chunks: int) -> torch.Tensor:
    """The exact combine with chunked transfers (``_chunked_exact_combine``
    without the relay rounds): the flat payload's chunks are gathered per
    ``(round, chunk)`` in wavefront order, each round's chunks are put back
    together at full width, and the accumulate is the monolithic one."""
    flat = xw.reshape(xw.shape[0], -1)
    parts = [flat[:, a:b] for a, b in chunk_bounds(flat.shape[1], chunks)]
    y = xw * _col(self_w, xw)
    for r, recv in enumerate(_chunked_rounds(parts, src)):
        y = y + recv.reshape(xw.shape) * _col(recv_w[r], xw)
    return y


def weighted_combine_operands(
    x: torch.Tensor, src: torch.Tensor, self_w: torch.Tensor, recv_w: torch.Tensor,
    chunks: int = 1,
) -> torch.Tensor:
    """``y_j = self_w[j] * x_j + sum_r recv_w[r, j] * x_{src[r, j]}``, the
    weights as runtime operands; ``chunks > 1`` chunks the transfers
    (:func:`_chunked_exact_combine`, bitwise the same result). ``src`` of a
    relay plan names each round's origin rows (:func:`plan_operands`)."""
    xw = x.to(_weight_dtype(x))
    if isinstance(src, Route):
        if _RECORDERS:
            _note("route", src)
        ext = src.exchange([xw])[0]
        y = xw * _col(self_w, xw)
        for r in range(src.n_rounds):
            y = y + _gather(ext, src[r]) * _col(recv_w[r], xw)
        return y
    if chunks > 1:
        return _chunked_exact_combine(xw, src, self_w, recv_w, chunks)
    y = xw * _col(self_w, xw)
    for r in range(src.shape[0]):
        y = y + _gather(xw, src[r]) * _col(recv_w[r], xw)
    return y


def weighted_combine(x: torch.Tensor, plan: CommPlan, chunks: int = 1) -> torch.Tensor:
    """:func:`weighted_combine_operands` with the plan's weights."""
    return weighted_combine_operands(x, *plan_operands(plan, x.device), chunks=chunks)


def neighbor_allreduce(x: torch.Tensor, plan: CommPlan, chunks: int = 1) -> torch.Tensor:
    """Weighted neighbor averaging over a static plan."""
    return weighted_combine(x, plan, chunks=chunks)


# {schedule: {device: stacked operands on it}}, dropped with the schedule
_SCHEDULE_OPERANDS: "weakref.WeakKeyDictionary[SchedulePlan, dict]" = weakref.WeakKeyDictionary()


def schedule_operands(schedule: SchedulePlan, device):
    """``(src [period, R, N] int32, self_w [period, N] f32, recv_w [period,
    R, N] f32)`` of a schedule (:attr:`SchedulePlan.stacked_operands`) on
    ``device``, moved there once per schedule and device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = _SCHEDULE_OPERANDS.setdefault(schedule, {})
    if device not in cache:
        cache[device] = tuple(torch.from_numpy(np.array(a)).to(device)
                              for a in schedule.stacked_operands)
    return cache[device]


def neighbor_allreduce_step(x: torch.Tensor, step, schedule: SchedulePlan) -> torch.Tensor:
    """Dynamic-topology neighbor averaging selected by the step index
    (``lax.switch`` over the period in the JAX function): the period's
    operands are stacked on the device once (:func:`schedule_operands`) and
    indexed with ``step % period``, so a changing peer set rebuilds nothing
    and ``step`` (an int or an integer tensor on ``x``'s device) is never
    read back to the host. Rounds a step does not use have sender -1 and
    weight 0."""
    ctx = _multi_process()
    if ctx is not None:  # the route depends on the step: read it on the host
        k = int(step) % schedule.period
        src, self_w, recv_w = (a[k] for a in schedule.stacked_operands)
        return weighted_combine_operands(x, *_local_operands(
            transport.route(src, src.shape[-1], ctx), self_w, recv_w, x.device))
    idx = torch.as_tensor(step, device=x.device).reshape(1).long() % schedule.period
    src, self_w, recv_w = (a.index_select(0, idx)[0]
                           for a in schedule_operands(schedule, x.device))
    return weighted_combine_operands(x, src, self_w, recv_w)


def _hierarchical(x: torch.Tensor, local_size: int, combine) -> torch.Tensor:
    """Sum over each machine's ``local_size`` workers (worker ``m * local +
    l``, the JAX mesh ``(machines, local)`` in row-major order), combine the
    ``[machines, ...]`` sums, divide by ``local_size`` and give every local
    slot its machine's result."""
    if local_size < 1 or x.shape[0] % local_size:
        raise ValueError(f"{x.shape[0]} workers do not split into machines of {local_size}")
    local_sum = x.reshape((x.shape[0] // local_size, local_size) + tuple(x.shape[1:])).sum(1)
    combined = combine(local_sum) / local_size
    return combined.unsqueeze(1).expand(
        (combined.shape[0], local_size) + tuple(combined.shape[1:])
    ).reshape((x.shape[0],) + tuple(combined.shape[1:]))


def hierarchical_neighbor_allreduce(
    x: torch.Tensor, machine_plan: CommPlan, local_size: int
) -> torch.Tensor:
    """Machine-level gossip: the local sum over each machine's workers (the
    JAX ``psum`` over the local axis), the machine plan's combine over the
    machines, divided by ``local_size``, broadcast back to every local slot."""
    return _hierarchical(x, local_size, lambda y: weighted_combine(y, machine_plan))


def hierarchical_neighbor_allreduce_operands(
    x: torch.Tensor, src: torch.Tensor, self_w: torch.Tensor, recv_w: torch.Tensor,
    local_size: int,
) -> torch.Tensor:
    """:func:`hierarchical_neighbor_allreduce` with the machine-level
    weights as runtime operands (see :func:`weighted_combine_operands`)."""
    return _hierarchical(x, local_size,
                         lambda y: weighted_combine_operands(y, src, self_w, recv_w))


def hierarchical_neighbor_allreduce_step(
    x: torch.Tensor, step, machine_schedule: SchedulePlan, local_size: int
) -> torch.Tensor:
    """Dynamic machine-topology variant (one-peer Exp2 at machine level,
    :func:`bluefog_tpu_torch.topology.GetExp2DynamicSendRecvMachineRanks`)."""
    return _hierarchical(x, local_size,
                         lambda y: neighbor_allreduce_step(y, step, machine_schedule))


def hierarchical_neighbor_allreduce_quantized(
    x: torch.Tensor, src: torch.Tensor, recv_w: torch.Tensor, local_size: int,
    wire: str = "int8",
) -> torch.Tensor:
    """:func:`hierarchical_neighbor_allreduce` with the machine-level leg
    on the quantized wire (``"bf16"``, ``"int8"`` or ``"int4"``): the local
    sum stays exact, the ``[machines, ...]`` sums go through
    :func:`weighted_combine_quantized_operands` (on the integer wires
    ``encode`` + ``decode_accumulate`` on the card). ``src``/``recv_w``
    are the machine plan's (:func:`plan_operands`), normalized."""
    return _hierarchical(x, local_size, lambda y: weighted_combine_quantized_operands(
        y, src, recv_w, wire=wire, inplace=True))


# -- the classic collectives ----------------------------------------------------------


def _gathered(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every process's rows ``[N, ...]`` (:func:`transport.gather_rows`)."""
    if x.shape[0] != ctx.n_local:
        raise ValueError(f"expected this process's {ctx.n_local} worker rows, "
                         f"got {tuple(x.shape)}")
    return transport.gather_rows(x.contiguous(), ctx)


def allreduce(x: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Every worker's slot becomes the sum over the workers, or with
    ``average`` the mean in :func:`_weight_dtype`, divided by the static
    worker count (the JAX ``psum`` of a literal). Across processes every
    row is gathered first and reduced in the stacked order, so the local
    rows are bitwise the stacked result."""
    if _RECORDERS:
        dtype = _weight_dtype(x) if average else x.dtype
        _note("all-reduce", (x[0].numel() if x.shape[0] else 0) * dtype.itemsize)
    ctx = _multi_process()
    if ctx is not None:
        return _stacked_allreduce(_gathered(x, ctx), average)[:x.shape[0]].clone()
    return _stacked_allreduce(x, average)


def _stacked_allreduce(x: torch.Tensor, average: bool) -> torch.Tensor:
    if not average:
        total = x.sum(0, keepdim=True, dtype=x.dtype)
    else:
        wdt = _weight_dtype(x)
        total = x.to(wdt).sum(0, keepdim=True) / torch.tensor(x.shape[0], dtype=wdt)
    return total.expand(x.shape).clone()


def allgather(x: torch.Tensor) -> torch.Tensor:
    """``[N, d0, ...]`` -> ``[N, N * d0, ...]``: every worker's copy of the
    concatenation of all workers' slots along their first axis (a scalar
    slot per worker gives ``[N, N]``)."""
    n = x.shape[0]
    ctx = _multi_process()
    full = x if ctx is None else _gathered(x, ctx)
    flat = full.reshape((1, -1) + tuple(x.shape[2:]))
    return flat.expand((n,) + tuple(flat.shape[1:])).clone()


# device index tensors of the slot gathers, by (values, device): a few per
# worker count, so a gather never copies its indices to the card again
_ROW_INDEX = {}


def _row_index(values: Sequence[int], device, dtype=torch.long) -> torch.Tensor:
    key = (tuple(values), str(device), dtype)
    t = _ROW_INDEX.get(key)
    if t is None:
        t = _ROW_INDEX[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return t


def _slot_rows(x2: torch.Tensor, senders: Sequence[int], positions: Sequence[int], slot: int,
               a: int = 0, b: Optional[int] = None) -> torch.Tensor:
    """``[N, b - a]`` rows of a ``[N, m]`` payload: row ``j`` holds columns
    ``[a, b)`` of worker ``senders[j]``'s slot at owner position
    ``positions[j]``, zeros past the payload's end (the padding of the
    shard layout, which the payload need not carry). One gather for the
    rows whose slot the payload holds whole; a copy each for the others."""
    b = slot if b is None else b
    m = x2.shape[1]
    n_full = m // slot
    whole = [j for j, pos in enumerate(positions) if pos < n_full]
    if x2.stride(1) != 1:
        whole = []
    x3 = x2[:, :n_full * slot].view(x2.shape[0], n_full, slot) if whole else None
    if len(whole) == len(positions):
        return x3[_row_index(senders, x2.device), _row_index(positions, x2.device), a:b]
    out = x2.new_zeros((len(senders), b - a))
    if whole:
        out[_row_index(whole, x2.device)] = x3[
            _row_index([senders[j] for j in whole], x2.device),
            _row_index([positions[j] for j in whole], x2.device), a:b]
    for j, (snd, pos) in enumerate(zip(senders, positions)):
        if pos < n_full and whole:
            continue
        lo, hi = pos * slot + a, min(pos * slot + b, m)
        if hi > lo:
            out[j, :hi - lo] = x2[snd, lo:hi]
    return out


def _quantize_rows(rows: torch.Tensor, wire: str):
    """The plain block quantizer of ``[N, slot]`` f32 rows: ``(payload,
    scales, reconstruction [N, slot])`` (the JAX composite quantizer)."""
    p, s = kernels.encode_reference(kernels.pad_blocks(rows), wire)
    return p, s, kernels.unpad_blocks(kernels.dequantize(p, s), rows.shape[1])


def reduce_scatter(
    x: torch.Tensor,
    live_index: Sequence[int],
    slot: int,
    average: bool = True,
    wire: Optional[str] = None,
    chunks: int = 1,
    ef: Optional[torch.Tensor] = None,
    live_mask: Optional[Sequence[float]] = None,
    fast: bool = True,
):
    """Ring reduce-scatter, the ZeRO-2 gradient leg: worker ``j`` gets only
    its owned ``[slot]`` row of the sum over workers, ``[N, slot]`` in
    all (divided by the full worker count under ``average``, dead workers'
    rows included, as :func:`allreduce`).

    ``x`` is ``[N, n_live * slot]`` (a flat payload per worker, ``slot`` on
    the 512-element grid in the shard layout); ``live_index[r]`` is worker
    ``r``'s owner position among the live set (dead workers 0,
    :meth:`bluefog_tpu_torch.sharding.ShardLayout.live_index`).

    Lowering: ``size - 1`` circulant rounds of
    :func:`compiler.compile_reduce_scatter`; in round ``t`` every worker
    ships the slot owned by the worker ``t`` ahead of it. A receiver adds
    its own row first, then the rounds in order, a fixed order, so chunked
    (transfers per ``(round, chunk)`` in wavefront order, each round put
    back together at full slot width before the add) is bitwise
    monolithic. ``fast`` takes the one-sum form (the JAX ``psum_scatter``)
    on the exact tier with one chunk and every worker live.

    ``wire`` compresses what the rounds ship, per 512-element block:
    ``'bf16'``; ``'int8'``/``'int4'`` through :func:`kernels.encode` (one
    launch per round: the rows of one round, ``[N, slot]``, so no copy of
    all rounds' rows exists) and :func:`kernels.decode` (one per round, the
    gather fused in); ``'int8_ef'``/``'int4_ef'`` through the plain
    quantizer on every device (the JAX function uses its composite there),
    with the residual ``ef [N, n_live * slot]`` f32: each round ships ``Q(x +
    e)`` of its row and keeps the quantization error in ``e``, except where
    the destination is dead (``live_mask``). The own row is always exact.
    The EF tiers return ``(own, new_ef)``.

    Across processes ``x`` (and ``ef``) is this process's rows ``[n_local,
    n_live * slot]``, ``live_index`` and ``live_mask`` stay global, and the
    result is the local rows of the stacked result, bitwise
    (:func:`_reduce_scatter_route`)."""
    ctx = _multi_process()
    n_workers = x.shape[0] if ctx is None else ctx.size
    if ctx is not None and x.shape[0] != ctx.n_local:
        raise ValueError(f"expected this process's {ctx.n_local} worker rows, "
                         f"got {tuple(x.shape)}")
    size = len(live_index)
    slot = int(slot)
    flat = x.reshape(x.shape[0], -1)
    if slot <= 0 or flat.shape[1] % slot:
        raise ValueError(
            f"reduce_scatter payload of {flat.shape[1]} is not a multiple of slot {slot}"
        )
    if size != n_workers:
        raise ValueError(f"live_index has {size} entries for {n_workers} workers")
    if live_mask is not None and len(live_mask) != size:
        raise ValueError(f"live_mask has {len(live_mask)} entries for a mesh of {size}")
    if ef is not None and wire in ("int8_ef", "int4_ef") and ef.numel() != flat.numel():
        raise ValueError(
            f"residual has {ef.numel() // flat.shape[0]} elements, payload has {flat.shape[1]}"
        )
    return _reduce_scatter(flat, live_index, slot, average, wire, chunks, ef, live_mask, fast)


def _one_sum_scatter(flat: torch.Tensor, slot: int, average: bool) -> torch.Tensor:
    """The one-sum form of the reduce-scatter (the JAX ``psum_scatter``)
    over every worker: ``[N, slot]``, row ``j`` the sum over workers of
    slot ``j``. The sum is :func:`allreduce`'s, over the unpadded ``[N,
    m]`` payload, so its bits are the allreduce's; only that ``[m]`` sum is
    padded to the slots, never the whole payload."""
    size, m = flat.shape
    wdt = _weight_dtype(flat)
    y = flat.to(wdt).sum(0)
    if m < size * slot:
        y = torch.nn.functional.pad(y, (0, size * slot - m))
    y = y[:size * slot].view(size, slot)
    return y / torch.tensor(size, dtype=wdt) if average else y


def _reduce_scatter(flat, live_index, slot, average, wire, chunks, ef, live_mask,
                    fast=False):
    """:func:`reduce_scatter` on a ``[N, m]`` payload whose slots past
    ``m`` read as zeros (the shard layout's padding)."""
    from bluefog_tpu_torch.collective import compiler

    ctx = _multi_process()
    size = flat.shape[0] if ctx is None else ctx.size
    lidx = [int(v) for v in live_index]
    if (fast and ef is None and wire in (None, "fp32") and chunks <= 1
            and lidx == list(range(size))):
        if ctx is not None:  # every row gathered, summed in the stacked order
            return _one_sum_scatter(_gathered(flat, ctx), slot, average)[
                ctx.rows.start:ctx.rows.stop].clone()
        return _one_sum_scatter(flat, slot, average)
    if ctx is not None:
        return _reduce_scatter_route(ctx, flat, lidx, slot, average, wire, ef, live_mask)
    wdt = _weight_dtype(flat)
    norm = torch.tensor(size, dtype=torch.float32)
    perms = compiler.compile_reduce_scatter(size).perms
    # round t: receiver j's sender, and the owner position it ships
    senders = []
    for perm in perms:
        src_of = [0] * size
        for snd, dst in perm:
            src_of[dst] = snd
        senders.append(src_of)
    own_pos = lidx
    me = list(range(size))
    bounds = chunk_bounds(slot, chunks)

    def rounds(rows_of):
        """Each round's received rows put back together at full slot
        width, in round order as each round's last chunk arrives, from
        ``rows_of(r, a, b)``: the ``[a, b)`` columns round ``r`` ships,
        issued per (round, chunk) in wavefront order (round ``r`` ends on
        wave ``r + chunks - 1``, so at most ``chunks`` rounds are in
        flight)."""
        n_c = len(bounds)
        recv = {}
        for r, c in _wavefront(len(perms), n_c):
            recv.setdefault(r, [None] * n_c)[c] = rows_of(r, *bounds[c])
            if c == n_c - 1:
                row = recv.pop(r)
                yield row[0] if n_c == 1 else torch.cat(row, dim=1)

    if wire in (None, "fp32"):
        xw = flat.to(wdt)
        y = _slot_rows(xw, me, own_pos, slot)
        for got in rounds(lambda r, a, b: _slot_rows(xw, senders[r], own_pos, slot, a, b)):
            y = y + got
        return y / norm.to(wdt) if average else y

    xf = flat.to(torch.float32)
    y = _slot_rows(xf, me, own_pos, slot)
    if wire == "bf16":
        for got in rounds(lambda r, a, b: _slot_rows(
                xf, senders[r], own_pos, slot, a, b).to(torch.bfloat16)):
            y = y + got.to(torch.float32)
        if average:
            y = y / norm
        return y.to(wdt)

    if wire in ("int8", "int4"):
        groups = _chunk_group_bounds(bounds)
        for r, perm in enumerate(perms):
            # sender s ships its row for the worker r + 1 ahead of it
            dest = [lidx[d] for _s, d in sorted(perm)]
            payload, scales = kernels.encode(
                kernels.pad_blocks(_slot_rows(xf, me, dest, slot)).contiguous(), wire)
            if len(groups) == 1:
                got = kernels.decode(payload, scales, _row_index(senders[r], xf.device, torch.int32),
                                     wire, src_in_range=True)
            else:
                # the round's chunks, each gathered from its sender (every
                # worker sends in every round), put back together
                idx = _row_index(senders[r], xf.device)
                got = kernels.decode(
                    torch.cat([payload[:, ga:gb].index_select(0, idx) for ga, gb in groups], 1),
                    torch.cat([scales[:, ga:gb].index_select(0, idx) for ga, gb in groups], 1),
                    None, wire)
            y = y + kernels.unpad_blocks(got, slot)
        if average:
            y = y / norm
        return y.to(wdt)

    if wire not in ("int8_ef", "int4_ef"):
        raise ValueError(
            "reduce_scatter wire must be None/'fp32'/'bf16'/'int8'/"
            f"'int4'/'int8_ef'/'int4_ef', got {wire!r}"
        )
    if ef is None:
        raise ValueError(f"wire {wire!r} needs the per-slot residual ef")
    e = ef.reshape(size, -1).to(torch.float32)
    if e.shape[1] % slot or e.shape[1] < flat.shape[1]:
        raise ValueError(
            f"residual has {e.shape[1]} elements a worker, payload has {flat.shape[1]}"
        )
    e_new = e.clone()
    live = [True] * size if live_mask is None else [bool(v) for v in live_mask]
    groups = _chunk_group_bounds(bounds)
    for r, perm in enumerate(perms):
        dest_rank = [d for _s, d in sorted(perm)]
        dest = [lidx[d] for d in dest_rank]
        row_d = _slot_rows(xf, me, dest, slot) + _slot_rows(e, me, dest, slot)
        q, sc, rowhat = _quantize_rows(row_d, wire[:-3])
        # the shipped error stays in the residual where the destination is
        # live; a dead destination never consumes the payload
        for s_, pos in enumerate(dest):
            if live[dest_rank[s_]]:
                e_new[s_, pos * slot:(pos + 1) * slot] = row_d[s_] - rowhat[s_]
        del row_d, rowhat
        idx = _row_index(senders[r], xf.device)
        got = kernels.dequantize(
            torch.cat([q[:, ga:gb].index_select(0, idx) for ga, gb in groups], dim=1),
            torch.cat([sc[:, ga:gb].index_select(0, idx) for ga, gb in groups], dim=1))
        y = y + kernels.unpad_blocks(got.reshape(size, -1), slot)
    if average:
        y = y / norm
    return y.to(wdt), e_new.reshape(ef.shape)


def _reduce_scatter_route(ctx, flat, lidx, slot, average, wire, ef, live_mask):
    """:func:`_reduce_scatter` across processes on the local rows ``flat
    [n_local, m]``: each circulant round of
    :func:`compiler.compile_reduce_scatter` is a route with one sender row
    per receiver, sender ``s`` shipping its slot row for its destination
    (the wire pair of that row on int8/int4, through one ``encode`` of the
    round's local rows and one ``decode`` over the extended payload; the
    plain quantizer's pair on the EF tiers). The receiver adds its own row
    first, then the rounds in order, as the stacked ring does, so the
    local rows are bitwise its rows. Whole rows ship (``chunks`` is not
    used; chunked is bitwise monolithic there too).

    One batch a round, not one for all rounds: every round ships different
    rows (the slots for another destination), so a single batch would hold
    every round's send rows at once, about ``(N - 1) / N`` of the payload
    again, and as much received, where the stacked ring holds one round's
    rows at a time. A batch a round keeps that bound for ``N - 2`` more
    round trips a call, which the staged transport pays in milliseconds
    against the payload's own transfer."""
    from bluefog_tpu_torch.collective import compiler

    size = ctx.size
    lo, n_local = ctx.rows.start, ctx.n_local
    here = range(n_local)
    wdt = _weight_dtype(flat)
    norm = torch.tensor(size, dtype=torch.float32)
    perms = compiler.compile_reduce_scatter(size).perms
    own = [lidx[lo + i] for i in here]
    rounds = []  # (the round's route, its local senders' owner positions, destinations)
    for perm in perms:
        src = np.full((1, size), -1, np.int64)
        dest_of = [0] * size
        for snd, dst in perm:
            src[0, dst] = snd
            dest_of[snd] = dst
        dest = [dest_of[lo + i] for i in here]
        rounds.append((transport.route(src, size, ctx), [lidx[d] for d in dest], dest))

    def received(rt, rows):
        return _gather(rt.exchange([rows.contiguous()])[0], rt[0])

    if wire in (None, "fp32"):
        xw = flat.to(wdt)
        y = _slot_rows(xw, here, own, slot)
        for rt, pos, _dest in rounds:
            y = y + received(rt, _slot_rows(xw, here, pos, slot))
        return y / norm.to(wdt) if average else y

    xf = flat.to(torch.float32)
    y = _slot_rows(xf, here, own, slot)
    if wire == "bf16":
        for rt, pos, _dest in rounds:
            y = y + received(rt, _slot_rows(xf, here, pos, slot).to(torch.bfloat16)).to(
                torch.float32)
        if average:
            y = y / norm
        return y.to(wdt)

    if wire in ("int8", "int4"):
        for rt, pos, _dest in rounds:
            payload, scales = rt.exchange(kernels.encode(
                kernels.pad_blocks(_slot_rows(xf, here, pos, slot)).contiguous(), wire))
            got = kernels.decode(payload, scales, rt[0], wire, src_in_range=True)
            y = y + kernels.unpad_blocks(got, slot)
        if average:
            y = y / norm
        return y.to(wdt)

    if wire not in ("int8_ef", "int4_ef"):
        raise ValueError(
            "reduce_scatter wire must be None/'fp32'/'bf16'/'int8'/"
            f"'int4'/'int8_ef'/'int4_ef', got {wire!r}"
        )
    if ef is None:
        raise ValueError(f"wire {wire!r} needs the per-slot residual ef")
    e = ef.reshape(n_local, -1).to(torch.float32)
    if e.shape[1] % slot or e.shape[1] < flat.shape[1]:
        raise ValueError(
            f"residual has {e.shape[1]} elements a worker, payload has {flat.shape[1]}"
        )
    e_new = e.clone()
    live = [True] * size if live_mask is None else [bool(v) for v in live_mask]
    for rt, pos, dest in rounds:
        row_d = _slot_rows(xf, here, pos, slot) + _slot_rows(e, here, pos, slot)
        q, sc, rowhat = _quantize_rows(row_d, wire[:-3])
        for i, p in enumerate(pos):
            if live[dest[i]]:
                e_new[i, p * slot:(p + 1) * slot] = row_d[i] - rowhat[i]
        del row_d, rowhat
        eq, es = rt.exchange([q, sc])
        got = kernels.dequantize(_gather(eq, rt[0]), _gather(es, rt[0]))
        y = y + kernels.unpad_blocks(got.reshape(n_local, -1), slot)
    if average:
        y = y / norm
    return y.to(wdt), e_new.reshape(ef.shape)


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every worker's slot becomes worker ``root_rank``'s (across
    processes, its owner ships it to every other process)."""
    ctx = _multi_process()
    size = x.shape[0] if ctx is None else ctx.size
    if not 0 <= root_rank < size:
        raise ValueError(f"root_rank {root_rank} out of range for {size} workers")
    if ctx is not None:
        return transport.broadcast_row(x.contiguous(), root_rank, ctx).expand(x.shape).clone()
    return x[root_rank:root_rank + 1].expand(x.shape).clone()


def pair_gossip(
    x: torch.Tensor,
    pairs: Sequence[Tuple[int, int]],
    self_weight: Optional[float] = None,
    pair_weight: Optional[float] = None,
) -> torch.Tensor:
    """Each pair ``(a, b)`` averages with its partner, ``self_weight * x +
    pair_weight * x_partner`` (default 1/2 each), in :func:`_weight_dtype`
    with the weights in that dtype; ranks outside every pair keep their
    value, in that dtype."""
    ctx = _multi_process()
    n = x.shape[0] if ctx is None else ctx.size
    partner = [-1] * n
    for a, b in pairs:
        if a == b:
            raise ValueError("pair_gossip partner must differ from self")
        if partner[a] >= 0 or partner[b] >= 0:
            raise ValueError("pair_gossip: each rank may appear in at most one pair")
        partner[a], partner[b] = b, a
    wdt = _weight_dtype(x)
    xw = x.to(wdt)
    sw = torch.tensor(0.5 if self_weight is None else self_weight, dtype=wdt, device=x.device)
    pw = torch.tensor(0.5 if pair_weight is None else pair_weight, dtype=wdt, device=x.device)
    if ctx is not None:
        rt = transport.route(np.array([partner]), n, ctx)
        src, got = rt[0], _gather(rt.exchange([xw])[0], rt[0])
    else:
        src = torch.tensor(partner, dtype=torch.int32, device=x.device)
        got = _gather(xw, src)
    gossiped = xw * sw + got * pw
    paired = (src >= 0).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(paired, gossiped, xw)


def lineage_exchange(tags: torch.Tensor, src) -> torch.Tensor:
    """The staleness observatory's provenance lane: each round's int32
    lineage tag shipped along that round's gather. ``tags`` is ``[n_rounds,
    N, k]`` (row ``j`` of round ``r`` the stamp worker ``j`` sends in round
    ``r``), ``src`` the rounds' sources ``[n_rounds, N]``; returns the
    delivered tags ``[n_rounds, N, k]``, zeros where a worker receives
    nothing in a round (the JAX ``lineage_exchange``, stacked).

    Across processes ``tags`` is this process's rows ``[n_rounds, n_local,
    k]`` and ``src`` the global sources (host or device); each round's tags
    travel on that round's route, one batch a round (every round ships
    other tags, as :func:`_reduce_scatter_route` ships other slots), and
    the local receivers' delivered tags ``[n_rounds, n_local, k]`` come
    back, bitwise the stacked lane's rows."""
    if src.shape[0] == 0:
        return torch.zeros_like(tags)
    ctx = _multi_process()
    if ctx is not None:
        src = np.asarray(src.cpu() if isinstance(src, torch.Tensor) else src, np.int64)
        out = []
        for r in range(src.shape[0]):
            rt = transport.route(src[r:r + 1], ctx.size, ctx)
            out.append(_gather(rt.exchange([tags[r].contiguous()])[0], rt[0]))
        return torch.stack(out)
    return torch.stack([_gather(tags[r], src[r]) for r in range(src.shape[0])])


def barrier(device) -> None:
    """Wait until the device has finished all work queued so far (across
    processes, then until every process has reached the barrier)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx = _multi_process()
    if ctx is not None:
        transport.barrier(ctx)


def neighbor_allgather(
    x: torch.Tensor, plan: CommPlan, wire: Optional[str] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (unweighted) in-neighbour values, rank-ascending:
    ``(gathered [N, max_in_degree, ...], mask [N, max_in_degree] bool)``,
    row ``k`` of worker ``j`` the value of its ``k``-th in-neighbour, zeros
    past its in-degree (the JAX layout, with the worker axis in front).

    ``wire`` ships the values as ``'bf16'``, or block-quantized as
    ``'int8'``/``'int4'``: one :func:`kernels.encode` of every worker's
    flat f32 payload, then one :func:`kernels.decode` per neighbour slot
    of the senders' rows, cast back to ``x.dtype`` — receivers get
    ``dequant(Q(x))``, as in the JAX function. Float payloads only."""
    if wire not in (None, "bf16", "int8", "int4"):
        raise ValueError(
            "neighbor_allgather wire must be None, 'bf16', 'int8', or "
            f"'int4', got {wire!r}"
        )
    if wire is not None and not x.is_floating_point():
        raise ValueError(f"quantized neighbor_allgather needs a float payload, got {x.dtype}")
    n_workers = x.shape[0]
    ins = plan.in_neighbors
    degree = plan.max_in_degree
    src = np.full((degree, plan.size), -1, np.int32)
    for j, nbrs in enumerate(ins):
        src[:len(nbrs), j] = nbrs
    ctx = _multi_process()
    rt = slots = None
    if ctx is not None and degree and plan.relay:
        # hop by hop: neighbour k's row is the one its delivering round brings
        rt = transport.relay_route(plan, ctx)
        slots = rt.neighbors
    elif ctx is not None and degree:
        rt = transport.route(src, plan.size, ctx)
        slots = rt.local
    if ctx is not None:
        src = src[:, ctx.rows.start:ctx.rows.stop]
    mask = torch.from_numpy(np.ascontiguousarray(src.T >= 0)).to(x.device)
    src_t = torch.from_numpy(src).to(x.device)
    if degree == 0:
        return x.new_zeros((n_workers, 0) + tuple(x.shape[1:])), mask
    if rt is not None:
        # across processes: the senders' rows (their wire pairs) through the
        # transport, then each slot gathered; decoding every row and then
        # gathering is bitwise the decode of the gathered rows
        if wire in ("int8", "int4"):
            flat = x.reshape(n_workers, -1).to(torch.float32)
            n = flat.shape[1]
            ext = kernels.decode(*rt.exchange(kernels.encode(kernels.pad_blocks(flat), wire)),
                                 None, wire)
            rows = [kernels.unpad_blocks(_gather(ext, slots[k]), n).reshape(x.shape).to(x.dtype)
                    for k in range(degree)]
        else:
            ext = rt.exchange([x if wire is None else x.to(torch.bfloat16)])[0]
            rows = [_gather(ext, slots[k]).to(x.dtype) for k in range(degree)]
        return torch.stack(rows, dim=1), mask
    if wire in ("int8", "int4"):
        flat = x.reshape(n_workers, -1).to(torch.float32)
        n = flat.shape[1]
        payload, scales = kernels.encode(kernels.pad_blocks(flat), wire)
        rows = [
            kernels.unpad_blocks(
                kernels.decode(payload, scales, src_t[k], wire, src_in_range=True), n
            ).reshape(x.shape).to(x.dtype)
            for k in range(degree)
        ]
    else:
        sent = x if wire is None else x.to(torch.bfloat16)
        rows = [_gather(sent, src_t[k]).to(x.dtype) for k in range(degree)]
    return torch.stack(rows, dim=1), mask


def _check_combine_normalized(plan: CommPlan, what: str) -> None:
    """The difference-form quantized combine equals the exact combine
    only when each receiver's weights sum to 1; refuse otherwise (the
    error would be O(x) and silent)."""
    col_sums = plan.weight_matrix().sum(axis=0)
    if not np.allclose(col_sums, 1.0, atol=1e-6):
        bad = int(np.argmax(np.abs(col_sums - 1.0)))
        raise ValueError(
            f"{what} requires a normalized combine (receiver weights "
            f"summing to 1); rank {bad} sums to {col_sums[bad]:.6f}. "
            "Push-sum/column-stochastic plans are not supported."
        )


def _chunk_quantize(xf: torch.Tensor):
    """Stacked int8 block quantization of ``[N, n]`` f32: ``(q [N, C,
    512] int8, s [N, C] f32, xhat [N, n])`` (``inner._chunk_quantize``
    per worker)."""
    q, s = kernels.encode_reference(kernels.pad_blocks(xf), "int8")
    return q, s, _dequant8(q, s, xf.shape[1])


def _chunk_quantize4(xf: torch.Tensor):
    """Stacked int4 block quantization: ``(packed [N, C, 256], s16 [N, C]
    bf16, xhat [N, n])`` (``inner._chunk_quantize4`` per worker)."""
    p, s16 = kernels.encode_reference(kernels.pad_blocks(xf), "int4")
    return p, s16, _dequant4(p, s16, xf.shape[1])


def _dequant8(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    return kernels.unpad_blocks(kernels.dequantize(q, s), n)


def _dequant4(packed: torch.Tensor, s16: torch.Tensor, n: int) -> torch.Tensor:
    return kernels.unpad_blocks(kernels.dequantize(packed, s16), n)


def _chunked_wire_rounds(payload: torch.Tensor, scales: torch.Tensor, src: torch.Tensor,
                         chunks: int, n: int):
    """The transfers of a chunked quantized combine: the wire pair of the
    whole payload (``n`` elements a worker) sliced into the blocks of
    :func:`chunk_bounds`, each ``(round, chunk)`` slice gathered by
    ``src[r]`` in wavefront order; returns each round's ``(payload, scales,
    rows)`` put back together at full width, ``rows [N]`` int32 naming the
    row each worker decodes: its own gathered row, or -1 where no sender
    sent (the decoders' zero payload)."""
    parts = [(payload[:, ga:gb], scales[:, ga:gb])
             for ga, gb in _chunk_group_bounds(chunk_bounds(n, chunks))]
    own = torch.arange(payload.shape[0], dtype=torch.int32, device=payload.device)
    minus = torch.full_like(own, -1)
    return [(p, s, torch.where(src[r] >= 0, own, minus))
            for r, (p, s) in enumerate(_wavefront_gathers(parts, src))]


def weighted_combine_quantized_operands(
    x: torch.Tensor,
    src: torch.Tensor,
    recv_w: torch.Tensor,
    wire: str = "int8",
    inplace: bool = False,
    chunks: int = 1,
) -> torch.Tensor:
    """Quantized-wire combine in the difference form
    ``y = x + sum_r w_r (x_hat_r - x_hat_self)`` (exact consensus is a
    fixed point), in :func:`_weight_dtype`, as the JAX function computes it:

    - ``"bf16"``: every worker ships ``x`` rounded to bf16; each round adds
      ``((recv - x_hat) * w_r)`` computed in f32 and cast to the weight
      dtype, rounds in plan order. Data movement and elementwise
      arithmetic, as JAX computes it outside any kernel.
    - ``"int8"``/``"int4"`` on a float32 (or integer) ``x``: one
      :func:`kernels.encode` of every worker's flat payload, then one
      :func:`kernels.decode_accumulate` with all rounds folded in. With
      ``inplace=True`` the result overwrites an f32 ``x``: a contiguous
      ``x`` whose per-worker size is a multiple of 512 is itself the
      accumulator, otherwise a padded contiguous copy is, written back.
    - ``"int8"``/``"int4"`` on a bf16 or f16 ``x``: the payload is encoded
      from ``x`` cast to f32 (:func:`kernels.encode`), each round's payload
      and the sender's own are decoded to f32 (:func:`kernels.decode`) and
      cast to the weight dtype, and the rounds are added in it, as the JAX
      composite branch does (the f32 accumulator of ``decode_accumulate``
      would round differently).

    ``chunks > 1`` chunks the transfers on the 512-element grid, bitwise
    the monolithic result: the bf16 payload and the bf16/f16 path's wire
    pair are gathered per ``(round, chunk)`` in wavefront order and put
    back together before the accumulate; on the f32 path the payload is
    copied chunk-major (each chunk's columns contiguous), encoded once, and
    each chunk accumulated over every round by one ``decode_accumulate``
    (the chunk's transfers are the sender rows that launch reads). A
    column slice that is not contiguous (a bucket) takes that copy too.

    A float64 or complex ``x`` is refused: the JAX package quantizes
    neither."""
    if wire not in ("int8", "bf16", "int4"):
        raise ValueError(
            f"wire must be 'int8', 'bf16', or 'int4', got {wire!r}"
        )
    wdt = _weight_dtype(x)
    if wdt == torch.float64 or wdt.is_complex:
        raise ValueError(
            "the quantized wire combines float32, bfloat16 or float16 "
            f"payloads (integers in float32), got {x.dtype}"
        )
    n_workers = x.shape[0]
    if wire == "bf16":
        xw = x.to(wdt)
        q16 = xw.to(torch.bfloat16)
        xhat = q16.to(torch.float32)
        y = xw
        if isinstance(src, Route):
            ext = src.exchange([q16])[0]
            received = [_gather(ext, src[r]) for r in range(src.n_rounds)]
        elif chunks > 1:
            flat16 = q16.reshape(n_workers, -1)
            parts = [flat16[:, a:b] for a, b in chunk_bounds(flat16.shape[1], chunks)]
            received = [t.reshape(x.shape) for t in _chunked_rounds(parts, src)]
        else:
            received = [_gather(q16, src[r]) for r in range(src.shape[0])]
        for r, got in enumerate(received):
            recv = got.to(torch.float32)
            y = y + ((recv - xhat) * _col(recv_w[r], recv)).to(wdt)
        return y
    if wdt != torch.float32:
        xw = x.to(wdt)
        flat = xw.to(torch.float32).reshape(n_workers, -1)
        n = flat.shape[1]
        payload, scales = kernels.encode(kernels.pad_blocks(flat).contiguous(), wire)

        def full(p, s, src_r):
            out = kernels.decode(p, s, src_r, wire, src_in_range=True)
            return kernels.unpad_blocks(out, n).reshape(x.shape).to(wdt)

        xhat = full(payload, scales, None)
        if isinstance(src, Route):
            # every received row decoded, then gathered: bitwise the decode
            # of the gathered rows
            dec = kernels.decode(*src.exchange([payload, scales]), None, wire)
            received = [kernels.unpad_blocks(_gather(dec, src[r]), n).reshape(x.shape).to(wdt)
                        for r in range(src.n_rounds)]
        elif chunks > 1:
            received = [full(p, s, rows)
                        for p, s, rows in _chunked_wire_rounds(payload, scales, src, chunks, n)]
        else:
            received = [full(payload, scales, src[r]) for r in range(src.shape[0])]
        y = xw
        for r, got in enumerate(received):
            y = y + (got - xhat) * _col(recv_w[r], xhat)
        return y
    if x.dtype != torch.float32:  # an integer payload combines in f32
        x, inplace = x.to(torch.float32), False
    flat = x.reshape(n_workers, -1)
    n = flat.shape[1]
    in_x = inplace and flat.data_ptr() == x.data_ptr()
    if isinstance(src, Route):
        # one encode of the local rows, the transport, one decode_accumulate
        # over the extended payload (the local rows first)
        if in_x and n % kernels.CHUNK == 0 and flat.is_contiguous():
            acc = flat
        else:
            acc = kernels.pad_blocks(flat)
            acc = (flat.clone(memory_format=torch.contiguous_format) if acc is flat
                   else acc.contiguous())
        payload, scales = src.exchange(kernels.encode(acc, wire))
        kernels.decode_accumulate(acc, payload, scales, src.local, recv_w, wire)
        if acc is flat:
            return x
        if in_x:
            flat.copy_(kernels.unpad_blocks(acc, n))
            return x
        return kernels.unpad_blocks(acc, n).reshape(x.shape)
    n_chunks, width = _chunk_layout(n, chunks)
    if in_x and n_chunks == 1 and n % kernels.CHUNK == 0 and flat.is_contiguous():
        payload, scales = kernels.encode(flat, wire)
        kernels.decode_accumulate(flat, payload, scales, src, recv_w, wire)
        return x
    # a chunk-major copy: one encode of every chunk's blocks, then one
    # decode_accumulate over every round per chunk (the chunk's transfers
    # are the sender rows that launch reads)
    acc = _to_chunk_major(flat, n_chunks, width)
    payload, scales = kernels.encode(acc.view(-1, width), wire)
    payload = payload.view((n_chunks, n_workers) + tuple(payload.shape[1:]))
    scales = scales.view(n_chunks, n_workers, -1)
    for c in range(n_chunks):
        kernels.decode_accumulate(acc[c], payload[c], scales[c], src, recv_w, wire)
    out = flat if in_x else torch.empty((n_workers, n), dtype=torch.float32, device=x.device)
    _from_chunk_major(acc, out)
    return x if out is flat else out.reshape(x.shape)


def weighted_combine_quantized(
    x: torch.Tensor, plan: CommPlan, wire: str = "int8", chunks: int = 1
) -> torch.Tensor:
    """:func:`weighted_combine_quantized_operands` with the plan's
    weights; validates that the plan is normalized."""
    _check_combine_normalized(plan, f"compression={wire!r}")
    src, _self_w, recv_w = plan_operands(plan, x.device)
    return weighted_combine_quantized_operands(x, src, recv_w, wire=wire, chunks=chunks)


def ef_state_zeros(n_workers: int, n: int, n_rounds: int, device):
    """Fresh CHOCO copies for an ``[N, n]`` payload on ``n_rounds``
    rounds: ``(xhat_self [N, d], xhat_recv [R, N, d])`` f32 zeros, with
    ``d`` = ``n`` padded to whole 512-element blocks (the padded tail
    stays zero)."""
    d = -(-n // kernels.CHUNK) * kernels.CHUNK
    return (
        torch.zeros((n_workers, d), dtype=torch.float32, device=device),
        torch.zeros((n_rounds, n_workers, d), dtype=torch.float32, device=device),
    )


def weighted_combine_quantized_ef_operands(
    x: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],
    src: torch.Tensor,
    recv_w: torch.Tensor,
    wire: str = "int8",
    inplace: bool = False,
    chunks: int = 1,
) -> torch.Tensor:
    """Quantized wire with memory (CHOCO-style difference compression),
    the monolithic branch of the JAX function: every worker keeps a
    public copy ``xhat_self`` of itself and integrated copies
    ``xhat_recv[r]`` of its round-``r`` source, ships ``q = Q(x -
    xhat_self)``, and sender and receivers add the same dequantized
    update to their copies, so the copies stay bit-identical
    (``xhat_recv[r][j] == xhat_self[src[r, j]]``). The combine uses the
    copies: ``y = x + sum_r w_r (xhat_recv[r] - xhat_self)``.

    ``state = (xhat_self [N, d], xhat_recv [R, N, d])`` f32 (see
    :func:`ef_state_zeros`) is updated in place — the JAX function
    returns a new state; here each round's copy is one contiguous
    ``[N, d]`` slab. Step 1 is one :func:`kernels.encode_diff`, step 2
    one :func:`kernels.decode_add` per round, step 3 the accumulate in
    plain torch, round by round, as JAX computes it outside any kernel.

    ``src [R, N]`` is a compiled plan's (:func:`plan_operands`): its
    ranks are in range by construction. ``x`` must be float32 ``[N,
    ...]`` with ``n`` elements per worker;
    with ``inplace=True`` and a contiguous, block-aligned ``x`` the result
    overwrites ``x``.

    ``chunks > 1`` chunks the transfers: ``x`` and the copies are copied
    chunk-major (each chunk's columns contiguous, the copies written back
    after), step 2 is one ``decode_add`` per ``(round, chunk)`` in
    wavefront order, and the accumulate runs at full width; copies, output
    and state are bitwise the monolithic ones. Copies given as column
    slices (a bucket's) take the same path."""
    kernels._check_wire(wire)
    if x.dtype != torch.float32:
        raise ValueError(
            f"the quantized wire combines float32 payloads, got {x.dtype}"
        )
    xhat_self, xhat_recv = state
    n_workers = x.shape[0]
    flat = x.reshape(n_workers, -1)
    n = flat.shape[1]
    d = -(-n // kernels.CHUNK) * kernels.CHUNK
    if (tuple(xhat_self.shape) != (n_workers, d)
            or tuple(xhat_recv.shape) != (src.shape[0], n_workers, d)):
        raise ValueError(
            f"error-feedback state {tuple(xhat_self.shape)} / "
            f"{tuple(xhat_recv.shape)} does not fit x {tuple(x.shape)} on "
            f"{src.shape[0]} rounds"
        )
    route = isinstance(src, Route)
    if route and not (xhat_self.is_contiguous() and xhat_recv.is_contiguous()):
        # a bucket's columns of the copies: contiguous copies, written back
        hs, hr = xhat_self.contiguous(), xhat_recv.contiguous()
        out = weighted_combine_quantized_ef_operands(x, (hs, hr), src, recv_w, wire, inplace)
        xhat_self.copy_(hs)
        xhat_recv.copy_(hr)
        return out
    n_chunks, width = (1, 0) if route else _chunk_layout(n, chunks)
    if n_chunks == 1 and xhat_self.is_contiguous() and xhat_recv.is_contiguous():
        aligned = n % kernels.CHUNK == 0 and flat.is_contiguous()
        if inplace and aligned and flat.data_ptr() == x.data_ptr():
            y = flat
        else:
            y = kernels.pad_blocks(flat)
            if y is flat:
                y = flat.clone()
        payload, scales = kernels.encode_diff(y, xhat_self, wire)
        if route:  # the senders' payloads after the local rows
            payload, scales = src.exchange([payload, scales])
        diff = torch.empty_like(y)
        for r in range(src.shape[0]):
            hat_r = kernels.decode_add(xhat_recv[r], payload, scales, src[r], wire,
                                       src_in_range=True)
            torch.sub(hat_r, xhat_self, out=diff)
            y.add_(diff.mul_(_col(recv_w[r], diff)))
        if y is flat:
            return x
        return kernels.unpad_blocks(y, n).reshape(x.shape)
    # chunk-major copies of x and of the copies (each chunk contiguous): one
    # encode_diff, then a decode_add per (round, chunk) in wavefront order,
    # the round's transfers of that chunk; the accumulate at full width
    y = _to_chunk_major(flat, n_chunks, width)
    hs = _to_chunk_major(xhat_self, n_chunks, width)
    hr = _to_chunk_major(xhat_recv, n_chunks, width)
    payload, scales = kernels.encode_diff(y.view(-1, width), hs.view(-1, width), wire)
    payload = payload.view((n_chunks, n_workers) + tuple(payload.shape[1:]))
    scales = scales.view(n_chunks, n_workers, -1)
    for r, c in _wavefront(src.shape[0], n_chunks):
        kernels.decode_add(hr[r, c], payload[c], scales[c], src[r], wire, src_in_range=True)
    diff = torch.empty_like(y)
    for r in range(src.shape[0]):
        torch.sub(hr[r], hs, out=diff)
        y.add_(diff.mul_(recv_w[r].view(1, -1, 1)))
    _from_chunk_major(hs, xhat_self)
    _from_chunk_major(hr, xhat_recv)
    in_x = inplace and flat.data_ptr() == x.data_ptr()
    out = flat if in_x else torch.empty((n_workers, n), dtype=torch.float32, device=x.device)
    _from_chunk_major(y, out)
    return x if out is flat else out.reshape(x.shape)
