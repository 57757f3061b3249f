# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The multi-process transport: a plan's rounds over ``torch.distributed``
point-to-point messages.

The JAX package has no file here: XLA lowers a ``ppermute`` across
processes itself. In the port, each process holds a contiguous range of
the global worker rows (:attr:`bluefog_tpu_torch.context.BluefogContext.rows`),
and a combine over a plan whose sources ``src [R, N]`` (global rows, -1
for none) name rows of other processes needs those rows first.

A :class:`Route` is one plan's rounds seen from one process. For each
round ``r`` and peer process ``q`` it lists the local rows some receiver
of ``q`` reads in round ``r`` (the sends), and the rows of ``q`` some local
receiver reads (the receives). Both sides compute the same lists from the
same ``src``, so every message has its match; a (round, peer) with no row
posts nothing on either side (an empty message would leave gloo waiting).
:meth:`Route.exchange` posts one ``isend`` of the ``index_select``-ed
contiguous rows and one ``irecv`` per (round, peer), all rounds of a
combine in one ``batch_isend_irecv`` (every round ships the same payload,
which exists before the first round, so nothing orders one round after
another), each tagged with its round. It returns the extended buffer
``[n_local + received, ...]``, the local rows first and the received ones
in (round, peer, row) order, and :attr:`Route.local` is ``src``'s local
columns remapped into it, -1 kept: row ``i`` of round ``r`` of the
extended buffer is exactly the row the stacked gather delivers, so a
combine over it is bitwise the stacked combine's local rows.

The exact tiers ship their f32 or bf16 rows. The quantized tiers ship
each row's wire pair in :mod:`bluefog_tpu_torch.collective.wire_ref`'s
format, the int8 payload ``[C, 512]`` (packed int4: ``[C, 256]``) and its
scale sidecar (f32 / bf16) as one byte row, so a (round, peer) is still
one message. The bytes handed to ``isend`` are counted (the metric
``bluefog.transport.bytes``, a ``transport`` flight event per combine and
:func:`stats`): for a combine they are the edges ``j -> i`` with ``j``
local and ``i`` remote, summed over the rounds, times
:func:`bluefog_tpu_torch.scaling.wire_payload_bytes`.

Backends (:func:`bluefog_tpu_torch.context.select_backend`): on the CPU
gloo moves the tensors themselves. With NCCL (a card per process) the
device rows are sent as they are. With gloo on CUDA (processes sharing a
card: NCCL refuses two ranks of one communicator on one device) the rows
are staged through pinned host memory: the device-to-host copies of every
round, then one CUDA event, synchronized before the batch is posted (the
copies must land before ``isend`` reads them); after the batch's waits the
host-to-device copies into the extended buffer, then a stream
synchronize, so the decoders read landed rows and the time a combine
spends in the transport (staging and gloo together) is what
:func:`stats` holds.

A short-cut (relay) plan is routed hop by hop (:class:`RelayRoute`, from
the plan's ``perms`` and ``inject``), as the JAX package's transit
recursion ships it: in round ``r`` a sender ships its own row where it
injects, else the row it received in round ``r - 1``, verbatim (the wire
pair of the quantized tiers as one byte row), so a transit row crosses
only the unit hops of its chain, never straight from its origin's
process. A round forwards what the round before delivered, so the rounds
are ordered: one ``batch_isend_irecv`` a round that has a message (on the
staged path the round's host-to-device copies are queued on the stream
before the next round's device-to-host copies, whose event is synchronized
before its ``isend``). A hop between two local rows is an index into the
extended buffer, with no copy; a hop that carries nothing (a forward of
nothing, which delivers zeros) posts nothing. The extended buffer and
:attr:`Route.local` have :class:`Route`'s form, so row ``i`` of round
``r`` is bitwise the origin row the stacked gather of
:func:`bluefog_tpu_torch.collective.compiler.relay_sources` delivers, and
the combines run on it unchanged. The bytes handed to ``isend`` are the
hops ``a -> b`` with ``a`` local and ``b`` remote, summed over the rounds,
times :func:`bluefog_tpu_torch.scaling.wire_payload_bytes`.
"""

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Route",
    "RelayRoute",
    "route",
    "relay_route",
    "partition",
    "exchange_rows",
    "gather_rows",
    "broadcast_row",
    "barrier",
    "gather_objects",
    "fleet_max",
    "agree",
    "stats",
    "reset_stats",
    "on_init",
]

_STATS = {"bytes": 0, "messages": 0, "combines": 0, "seconds": 0.0}


def stats() -> dict:
    """Bytes handed to ``isend``, messages sent, exchanges and their
    seconds (staging included) since the last :func:`reset_stats`."""
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0.0 if k == "seconds" else 0


def _ctx():
    from bluefog_tpu_torch import context as ctx_mod

    return ctx_mod.get_context()


def partition(ctx, n: int) -> Tuple[int, ...]:
    """Rows per process of a plan over ``n`` ranks: the workers' counts
    for a worker plan, the machines' for a machine plan (a machine must
    not straddle two processes)."""
    if n == ctx.size:
        return tuple(ctx.worker_counts)
    if n == ctx.machine_size:
        if any(c % ctx.local_size for c in ctx.worker_counts):
            raise ValueError(
                f"machines of {ctx.local_size} workers straddle the processes' worker "
                f"counts {ctx.worker_counts}; set BLUEFOG_NODES_PER_MACHINE to a divisor "
                "of every process's count"
            )
        return tuple(c // ctx.local_size for c in ctx.worker_counts)
    raise ValueError(f"a plan over {n} ranks matches neither the {ctx.size} workers nor "
                     f"the {ctx.machine_size} machines")


def _bounds(counts: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


class Route:
    """One plan's rounds across processes, seen from process ``index`` of
    a partition ``counts`` of the ``N`` rows (see the module docstring).
    ``shape`` is ``(R, n_local)``, the shape of :attr:`local`."""

    def __init__(self, src: np.ndarray, counts: Sequence[int], index: int, device):
        src = np.asarray(src, dtype=np.int64)
        if src.ndim != 2 or src.shape[1] != sum(counts):
            raise ValueError(f"src {src.shape} does not cover {sum(counts)} rows")
        bounds = _bounds(counts)
        self.counts, self.index = tuple(int(c) for c in counts), int(index)
        self.lo, self.hi = int(bounds[index]), int(bounds[index + 1])
        self.n_local = self.hi - self.lo
        self.n_rounds = src.shape[0]
        self.shape = (self.n_rounds, self.n_local)
        self.device = torch.device(device)
        owner = np.repeat(np.arange(len(counts)), counts)
        # (round, peer, local rows) it sends and (round, peer, global rows,
        # offset in the extended buffer) it receives, round-major, peers
        # ascending: the order both ends post in
        self.sends: List[Tuple[int, int, np.ndarray]] = []
        self.recvs: List[Tuple[int, int, np.ndarray, int]] = []
        local = np.full((self.n_rounds, self.n_local), -1, np.int64)
        offset = self.n_local
        for r in range(self.n_rounds):
            row = src[r]
            for q in range(len(counts)):
                if q == self.index:
                    continue
                qs = row[bounds[q]:bounds[q + 1]]
                out = np.unique(qs[(qs >= self.lo) & (qs < self.hi)])
                if out.size:
                    self.sends.append((r, q, out - self.lo))
            mine = row[self.lo:self.hi]
            remote = mine[(mine >= 0) & (owner[np.clip(mine, 0, None)] != self.index)]
            slot = {}
            for q in range(len(counts)):
                if q == self.index:
                    continue
                got = np.unique(remote[(remote >= bounds[q]) & (remote < bounds[q + 1])])
                if got.size:
                    self.recvs.append((r, q, got, offset))
                    slot.update((int(j), offset + k) for k, j in enumerate(got))
                    offset += got.size
            for i, j in enumerate(mine):
                if j < 0:
                    continue
                local[r, i] = j - self.lo if self.lo <= j < self.hi else slot[int(j)]
        self.n_received = offset - self.n_local
        self.local = torch.from_numpy(local.astype(np.int32)).to(self.device)
        self._send_index = [torch.from_numpy(rows).to(self.device) for _r, _q, rows in self.sends]

    def __getitem__(self, r):
        """Round ``r``'s remapped sources (the stacked code's ``src[r]``)."""
        return self.local[r]

    def exchange(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The extended buffers ``[n_local + received, ...]`` of ``tensors``
        (each ``[n_local, ...]``, on this route's device): the local rows,
        then the received rows of every (round, peer); the tensors' rows
        travel together, one message per (round, peer)."""
        return exchange_rows(tensors, [(q, idx, r) for (r, q, _), idx in
                                       zip(self.sends, self._send_index)],
                             [(q, len(rows), off, r) for r, q, rows, off in self.recvs],
                             self.n_local + self.n_received, self.n_rounds)


# (src bytes, shape, counts, index, device) -> Route, newest last
_ROUTES: "collections.OrderedDict[tuple, Route]" = collections.OrderedDict()
_ROUTE_CACHE = 64


def _cached(key, build):
    """``_ROUTES[key]``, built by ``build()`` on a miss (least recently
    used first out)."""
    hit = _ROUTES.get(key)
    if hit is None:
        hit = _ROUTES[key] = build()
        while len(_ROUTES) > _ROUTE_CACHE:
            _ROUTES.popitem(last=False)
    else:
        _ROUTES.move_to_end(key)
    return hit


def route(src: np.ndarray, n: Optional[int] = None, ctx=None) -> Route:
    """The cached :class:`Route` of ``src [R, n]`` on the active context's
    partition of ``n`` ranks (workers or machines)."""
    ctx = _ctx() if ctx is None else ctx
    src = np.ascontiguousarray(np.asarray(src, dtype=np.int64))
    counts = partition(ctx, src.shape[1] if n is None else n)
    key = (src.tobytes(), src.shape, counts, ctx.process_index, str(ctx.device))
    return _cached(key, lambda: Route(src, counts, ctx.process_index, ctx.device))


class RelayRoute(Route):
    """A relay plan's rounds across processes, seen from process ``index``
    (see the module docstring): built from the plan's ``perms`` and
    ``inject``, it forwards hop by hop. :attr:`sends` are ``(round, peer,
    rows of the extended buffer)`` (a local row where the sender injects,
    else the row it received the round before), :attr:`recvs` ``(round,
    peer, receivers (global), offset)``, each message's rows in receiver
    order on both ends; :attr:`local` and :meth:`exchange` are
    :class:`Route`'s. :attr:`neighbors` ``[max in-degree, n_local]`` is, for
    each local receiver, the extended-buffer row of each in-neighbour's own
    payload (rank-ascending, from the plan's ``delivery``: the round that
    brings it), -1 past its in-degree."""

    def __init__(self, perms, inject, delivery, counts: Sequence[int], index: int, device):
        from bluefog_tpu_torch.collective import compiler

        bounds = _bounds(counts)
        self.counts, self.index = tuple(int(c) for c in counts), int(index)
        self.lo, self.hi = int(bounds[index]), int(bounds[index + 1])
        self.n_local = self.hi - self.lo
        self.n_rounds = len(perms)
        self.shape = (self.n_rounds, self.n_local)
        self.device = torch.device(device)
        owner = np.repeat(np.arange(len(counts)), counts)
        origins = compiler._relay_origins(perms, inject)
        mine = range(self.lo, self.hi)
        local = np.full((self.n_rounds, self.n_local), -1, np.int64)
        self.sends: List[Tuple[int, int, np.ndarray]] = []
        self.recvs: List[Tuple[int, int, np.ndarray, int]] = []
        carry: Dict[int, int] = {}  # local rank -> buffer row it received last round
        offset = self.n_local
        for r, perm in enumerate(perms):
            inj = set(inject[r])
            arriving: Dict[int, int] = {}
            out: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
            got: Dict[int, List[int]] = collections.defaultdict(list)
            for a, b in perm:
                if origins[r].get(b) is None or (a not in mine and b not in mine):
                    continue  # a forward of nothing, or a hop of two other ranks
                if a in mine:
                    row = a - self.lo if a in inj else carry[a]
                    if b in mine:
                        arriving[b] = row
                    else:
                        out[int(owner[b])].append((b, row))
                else:
                    got[int(owner[a])].append(b)
            for q in sorted(out):
                self.sends.append((r, q, np.array([row for _b, row in sorted(out[q])],
                                                  np.int64)))
            for q in sorted(got):
                receivers = np.array(sorted(got[q]), np.int64)
                self.recvs.append((r, q, receivers, offset))
                for k, b in enumerate(receivers):
                    arriving[int(b)] = offset + k
                offset += receivers.size
            for b, row in arriving.items():
                local[r, b - self.lo] = row
            carry = arriving
        self.n_received = offset - self.n_local
        self.local = torch.from_numpy(local.astype(np.int32)).to(self.device)
        ins: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
        for (s, d), r in delivery:
            ins[d].append((s, r))
        neighbors = np.full((max((len(v) for v in ins.values()), default=0), self.n_local), -1,
                            np.int32)
        for d in mine:
            for k, (_s, r) in enumerate(sorted(ins[d])):
                neighbors[k, d - self.lo] = local[r, d - self.lo]
        self.neighbors = torch.from_numpy(neighbors).to(self.device)
        # the batch of each round with a message, in round order, tagged
        # with the round
        batches = collections.defaultdict(lambda: ([], []))
        for r, q, rows in self.sends:
            batches[r][0].append((q, torch.from_numpy(rows).to(self.device), r))
        for r, q, rows, off in self.recvs:
            batches[r][1].append((q, len(rows), off, r))
        self._batches = [batches[r] for r in sorted(batches)]

    def exchange(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """:meth:`Route.exchange`, round by round: a round's sends read the
        extended buffers, which hold what the rounds before received."""
        t0 = time.perf_counter()
        outs = _extended([t.contiguous() for t in tensors], self.n_local + self.n_received)
        post = _Poster(outs, outs)
        for sends, recvs in self._batches:
            post(sends, recvs)
        post.finish(t0, self.n_rounds)
        return outs


def relay_route(plan, ctx=None) -> RelayRoute:
    """The cached :class:`RelayRoute` of a relay plan over its ranks
    (workers or machines) on the active context's partition."""
    ctx = _ctx() if ctx is None else ctx
    counts = partition(ctx, plan.size)
    info = plan.compile_info
    key = ("relay", tuple(plan.perms), tuple(info.inject), tuple(info.delivery), counts,
           ctx.process_index, str(ctx.device))
    return _cached(key, lambda: RelayRoute(plan.perms, info.inject, info.delivery, counts,
                                           ctx.process_index, ctx.device))


def _byte_rows(t: torch.Tensor) -> torch.Tensor:
    """``[k, ...]`` contiguous -> its ``[k, bytes]`` uint8 view."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def exchange_rows(tensors: Sequence[torch.Tensor], sends, recvs, n_total: int,
                  n_rounds: int = 1, local_at: int = 0) -> List[torch.Tensor]:
    """Post the messages of one exchange and return the filled buffers.

    ``sends`` are ``(peer, local row indices, tag)``, ``recvs`` ``(peer,
    rows, offset, tag)``; each buffer is ``[n_total, ...]`` like its tensor,
    the local rows at ``local_at`` and each receive at its offset. One tensor
    is sent as its rows, several as one byte row per row (their rows side
    by side)."""
    t0 = time.perf_counter()
    tensors = [t.contiguous() for t in tensors]
    outs = _extended(tensors, n_total, local_at)
    post = _Poster(outs, tensors)
    post(sends, recvs)
    post.finish(t0, n_rounds)
    return outs


def _extended(tensors: Sequence[torch.Tensor], n_total: int, local_at: int = 0):
    """Buffers ``[n_total, ...]`` like ``tensors``, their rows at
    ``local_at``."""
    n_local = tensors[0].shape[0]
    outs = [t.new_empty((n_total,) + tuple(t.shape[1:])) for t in tensors]
    for out, t in zip(outs, tensors):
        out[local_at:local_at + n_local].copy_(t)
    return outs


class _Poster:
    """Posts batches of messages into the extended buffers ``outs``,
    reading each send's rows from ``sources`` (the local tensors, or the
    buffers themselves when a relay forwards a received row); counts the
    bytes, messages and receives of every batch for :meth:`finish`."""

    def __init__(self, outs, sources):
        self.outs, self.sources = outs, sources
        self.packed = len(outs) > 1
        self.row_bytes = (sum(_byte_rows(t[:1]).shape[1] for t in outs) if self.packed
                          else None)
        self.staged = _ctx().staged and outs[0].device.type == "cuda"
        self.n_bytes = self.n_sent = self.n_recv = 0

    def _wire(self, k):
        """A message buffer of ``k`` rows: pinned host memory when staged."""
        where = (dict(device="cpu", pin_memory=True) if self.staged
                 else dict(device=self.outs[0].device))
        if self.packed:
            return torch.empty((k, self.row_bytes), dtype=torch.uint8, **where)
        return torch.empty((k,) + tuple(self.outs[0].shape[1:]), dtype=self.outs[0].dtype,
                           **where)

    def __call__(self, sends, recvs) -> None:
        """One ``batch_isend_irecv``: ``sends`` ``(peer, row indices into
        the sources, tag)``, ``recvs`` ``(peer, rows, offset, tag)``."""
        import torch.distributed as dist

        outs, staged = self.outs, self.staged
        send_bufs = []
        for peer, idx, tag in sends:
            if self.packed:
                buf = torch.cat([_byte_rows(t.index_select(0, idx)) for t in self.sources],
                                dim=1)
            else:
                buf = self.sources[0].index_select(0, idx)
            if staged:
                host = self._wire(buf.shape[0])
                host.copy_(buf, non_blocking=True)
                buf = host
            send_bufs.append((peer, buf, tag))
            self.n_bytes += buf.numel() * buf.element_size()
        if staged and send_bufs:
            # the device-to-host copies must land before isend reads the rows
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(outs[0].device))
            ev.synchronize()
        ops, recv_bufs = [], []
        for peer, k, off, tag in recvs:
            buf = self._wire(k) if self.packed or staged else outs[0][off:off + k]
            recv_bufs.append((buf, off, k))
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        ops += [dist.P2POp(dist.isend, buf, peer, tag=tag) for peer, buf, tag in send_bufs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for buf, off, k in recv_bufs:
            if self.packed:
                dev = buf.to(outs[0].device, non_blocking=True) if staged else buf
                start = 0
                for out in outs:
                    width = _byte_rows(out[:1]).shape[1]
                    _byte_rows(out[off:off + k]).copy_(dev[:, start:start + width])
                    start += width
            elif staged:
                outs[0][off:off + k].copy_(buf, non_blocking=True)
        self.n_sent += len(send_bufs)
        self.n_recv += len(recv_bufs)

    def finish(self, t0: float, n_rounds: int) -> None:
        """Wait for the last host-to-device copies and count the exchange
        (one combine) in :func:`stats`, the metric and the flight
        recorder."""
        from bluefog_tpu_torch import flight, metrics

        if self.staged and self.n_recv:
            torch.cuda.current_stream(self.outs[0].device).synchronize()
        dt = time.perf_counter() - t0
        _STATS["bytes"] += self.n_bytes
        _STATS["messages"] += self.n_sent
        _STATS["combines"] += 1
        _STATS["seconds"] += dt
        metrics.counter("bluefog.transport.bytes").inc(self.n_bytes)
        flight.record("transport", bytes=self.n_bytes, messages=self.n_sent,
                      receives=self.n_recv, rounds=n_rounds, staged=bool(self.staged),
                      ms=round(dt * 1e3, 3))


def gather_rows(x, ctx=None):
    """Every process's rows, ``[N, ...]`` in global order: each process
    sends all its rows to every other process (one message a peer). ``x``
    may be a list of ``[n_local, ...]`` tensors on one device, which travel
    together (one byte row a worker); a list comes back."""
    ctx = _ctx() if ctx is None else ctx
    tensors = [x] if isinstance(x, torch.Tensor) else list(x)
    bounds = _bounds(ctx.worker_counts)
    me = ctx.process_index
    idx = torch.arange(tensors[0].shape[0], device=tensors[0].device)
    peers = [q for q in range(ctx.process_count) if q != me]
    out = exchange_rows(tensors, [(q, idx, 0) for q in peers],
                        [(q, int(bounds[q + 1] - bounds[q]), int(bounds[q]), 0) for q in peers],
                        ctx.size, local_at=int(bounds[me]))
    return out[0] if isinstance(x, torch.Tensor) else out


def broadcast_row(x: torch.Tensor, root: int, ctx=None) -> torch.Tensor:
    """Worker ``root``'s row ``[1, ...]`` on every process: its owner
    sends it to every other process."""
    ctx = _ctx() if ctx is None else ctx
    bounds = _bounds(ctx.worker_counts)
    owner = int(np.searchsorted(bounds, root, side="right") - 1)
    me = ctx.process_index
    if owner == me:
        row = x[root - int(bounds[me]):root - int(bounds[me]) + 1]
        idx = torch.tensor([root - int(bounds[me])], device=x.device)
        sends = [(q, idx, 0) for q in range(ctx.process_count) if q != me]
        exchange_rows([x], sends, [], x.shape[0])
        return row
    return exchange_rows([x[:0]], [], [(owner, 1, 0, 0)], 1)[0]


def gather_objects(obj, ctx=None) -> list:
    """Every process's ``obj`` (picklable), in process order: one
    ``all_gather_object``; ``[obj]`` with one process. The fleet samplers
    reduce a per-process host reading (a wall time, the allocator's bytes)
    from it by a stated rule, the same in every process."""
    ctx = _ctx() if ctx is None else ctx
    if ctx.process_count == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * ctx.process_count
    dist.all_gather_object(out, obj)
    return out


def fleet_max(values: Sequence[Optional[float]], ctx=None) -> List[Optional[float]]:
    """Each value's maximum over the processes (one :func:`gather_objects`;
    None where any process holds None), the same in every process: the
    fleet samplers' rule for a per-process wall time. With one process (or
    no context) ``values`` itself."""
    if ctx is None or ctx.process_count == 1:
        return list(values)
    views = gather_objects(list(values), ctx)
    return [None if any(v[i] is None for v in views) else max(v[i] for v in views)
            for i in range(len(values))]


def agree(obj, what: str, ctx=None) -> None:
    """Raise ``RuntimeError`` in every process when some process holds
    another ``obj`` than process 0 (one :func:`gather_objects`): a branch
    that launches communication taken in one process only would leave the
    others waiting in the transport."""
    views = gather_objects(obj, ctx)
    differ = [p for p, v in enumerate(views) if v != views[0]]
    if differ:
        raise RuntimeError(
            f"{what}: the processes disagree: process 0 holds {views[0]!r}; processes "
            f"{differ} hold {[views[p] for p in differ]!r}. Every process must set the same "
            "switches and replay the same faults"
        )


def barrier(ctx=None) -> None:
    import torch.distributed as dist

    ctx = _ctx() if ctx is None else ctx
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    dist.barrier()


_LOGGED: Dict[tuple, bool] = {}


def on_init(ctx) -> None:
    """Log the process group's backend once per choice and set the
    ``bluefog.transport.staged`` gauge (1: CUDA rows through pinned host
    memory)."""
    from bluefog_tpu_torch import metrics
    from bluefog_tpu_torch.logging_util import logger

    key = (ctx.backend, ctx.staged, ctx.process_count)
    if key not in _LOGGED:
        _LOGGED[key] = True
        logger.info("bluefog_tpu_torch: %d processes on backend %s%s; this process holds "
                    "worker rows %d..%d", ctx.process_count, ctx.backend,
                    " (CUDA rows staged through pinned host memory)" if ctx.staged else "",
                    ctx.rows.start, ctx.rows.stop - 1)
    metrics.gauge("bluefog.transport.staged").set(1 if ctx.staged else 0)
