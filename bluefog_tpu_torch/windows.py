# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Window ops: one-sided semantics as buffered neighbor state.

Counterpart of ``bluefog_tpu/windows.py``. A window is explicit state on
the context's device, stacked on the worker axis: the value ``[N, *S]``,
one buffer slot per create-time in-neighbor ``[N, max_deg, *S]``, a write
counter per slot ``[N, max_deg]`` int32, and the associated-p lane (``p``
``[N]`` f32, ``p_buffers`` ``[N, max_deg]``). ``win_put`` /
``win_accumulate`` / ``win_get`` are exchanges whose rounds (partial
permutations from :func:`bluefog_tpu_torch.collective.plan.perms_from_edges`)
are gathers along the worker axis; they land in the destinations' buffer
slots in dispatch order. ``win_update`` is the local weighted combine.
The arithmetic follows the JAX functions op for op.

Semantics (the reference test suite's, as in the JAX package):

- buffers start as copies of the creating value (zeros with
  ``zero_init``);
- ``win_put`` replaces a destination's buffer with ``dst_weight * x``,
  ``win_accumulate`` adds it, ``win_get`` pulls ``src_weight *`` the
  source's current value;
- ``self_weight`` rescales the caller's own value (push-sum mass);
- versions count writes per buffer since the last ``win_update``;
- the p lane undergoes the same linear ops as the value while it is on
  (init 1.0, buffers 0.0).

``BLUEFOG_WINDOW_WIRE`` (``bf16``, ``int8``, ``int4``) compresses the
exchange payload. On the int8/int4 wire the sender encodes once
(:func:`kernels.encode`), decodes its own payload (the ``x_hat`` of the
mass-residual absorption) and decodes each round's received payload
(:func:`kernels.decode`, the ``ppermute`` fused into the gather). In
``acc`` mode the sender keeps the residual of the mass it shipped, so the
column sums stay exact. The p lane is never quantized.

Per-rank weight specs are sequences indexed by rank; entry ``None`` means
that rank sits out the call. Calls run eagerly: a ``*_nonblocking`` op
returns a handle whose op has already completed. ``require_mutex`` is
taken for the JAX package's signatures and changes nothing: one process
drives each worker group's ops in order (across processes every process
runs the same exchange sequence, and each window lane is written only by
its owner process), so no two writers ever race, and ``win_mutex`` only
checks that the window exists.

Across processes (a context whose ``process_count > 1``) the lanes hold
this process's rows (``value [n_local, *S]``, ``buffers [n_local, max_deg,
*S]``, versions, p, p_buffers), ``max_deg`` the global in-degree maximum,
so each process's lanes are the same rows of the stacked state. The
weights, the rounds, the slot table and the host age lane stay global
and identical in every process. An exchange runs over
:func:`bluefog_tpu_torch.collective.transport.route` of the rounds'
global senders: the local sender rows ship once (with the p lane, ``[n_local]``
f32, in the same messages while it is on), and each round reads the
extended buffer at :attr:`Route.local`, so the rows are bitwise the
stacked ones. On the int8/int4 wire the process runs one ``encode`` of its
rows, ships the wire pairs, one ``decode`` of its own payload (``x_hat``)
and one ``decode`` a round over the extended payload. The bytes handed to
``isend`` are the edges ``j -> i`` with ``j`` local and ``i`` remote,
summed over the rounds, times
:func:`bluefog_tpu_torch.scaling.wire_payload_bytes` of the window wire,
plus 4 an edge while the p lane is on. ``win_update`` reads only the
process's own buffers. :func:`win_read`, :func:`get_win_version` and
:func:`win_associated_p` answer for the local rows (a ``rank`` of another
process raises); :func:`get_win_age` reads the global host lane.

The host age lane follows the JAX package's: each window counts its
local window steps (``clock``: every exchange, update, local adapt of a
window optimizer and asynchronous tick), stamps each buffer slot with the
clock of its last write (``slot_written``) and each slot's oldest
uncollected accumulate with its clock (``mass_birth``, -1 for none);
:func:`get_win_age` reads them.

Observability, as in the JAX package: each exchange of the ``win_*`` ops
counts ``bluefog.window_ops.<mode>`` and ``bluefog.window_wire_bytes`` and
leaves a ``window_op`` flight record, and so does each ``win_update``
(``bluefog.window_ops.update``); the window optimizers' and the
asynchronous engine's own exchanges are counted by their own series, as
the JAX programs are. The rounds follow ``BLUEFOG_PLAN_METHOD``. Each
``win_update`` hands the window to the staleness observatory
(:func:`bluefog_tpu_torch.staleness.observe_window`) before its combine, at
the point the ages are consumed.
"""

import contextlib
import itertools
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import flight, metrics
from bluefog_tpu_torch import staleness as stal_mod
from bluefog_tpu_torch.collective import compiler, inner, kernels, transport
from bluefog_tpu_torch.collective.ops import _check_worker_tensor, worker_values
from bluefog_tpu_torch.collective.transport import Route
from bluefog_tpu_torch.collective.plan import perms_from_edges
from bluefog_tpu_torch.topology import GetRecvWeights

__all__ = [
    "win_create",
    "win_free",
    "win_read",
    "win_update",
    "win_update_then_collect",
    "win_put",
    "win_put_nonblocking",
    "win_get",
    "win_get_nonblocking",
    "win_accumulate",
    "win_accumulate_nonblocking",
    "win_wait",
    "win_poll",
    "get_win_version",
    "get_win_age",
    "win_mutex",
    "get_current_created_window_names",
    "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
    "win_associated_p",
    "window_wire",
]


class _Window:
    """State of one named window, stacked on the worker axis: value
    ``[N, *S]``, buffers ``[N, max_deg, *S]``, versions ``[N, max_deg]``
    int32, p ``[N]`` f32, p_buffers ``[N, max_deg]`` f32 (across processes
    ``n_local`` rows each); the topology and the host age lane global."""

    def __init__(self, name, value, buffers, versions, p, p_buffers,
                 in_neighbors, out_neighbors):
        self.name = name
        self.value = value
        self.buffers = buffers
        self.versions = versions
        self.p = p
        self.p_buffers = p_buffers
        self.in_neighbors = in_neighbors  # tuple of tuples, create-time topology
        self.out_neighbors = out_neighbors
        self.shape = tuple(value.shape[1:])
        self.dtype = value.dtype
        # the host age lane (numpy, see the module docstring)
        size = len(in_neighbors)
        self.clock = 0
        self.slot_written = np.zeros((size, max(self.max_deg, 1)), np.int64)
        self.mass_birth = np.full((size, max(self.max_deg, 1)), -1, np.int64)

    @property
    def max_deg(self) -> int:
        return max((len(n) for n in self.in_neighbors), default=0)


def _get_win(ctx, name: str) -> _Window:
    win = ctx.windows.get(name)
    if win is None:
        raise ValueError(
            f"window {name!r} does not exist; call win_create first "
            f"(created: {sorted(ctx.windows)})"
        )
    return win


# -- lifecycle ---------------------------------------------------------------


def win_create(x, name: str, zero_init: bool = False) -> bool:
    """Allocate window state for the worker tensor ``x`` (or per-worker
    values, as :func:`worker_values` takes) under ``name``: the value is a
    copy of ``x``, one buffer slot per create-time in-neighbor holds a
    copy of it too (zeros with ``zero_init``). Returns False when the
    name is taken. Across processes ``x`` is this process's rows
    ``[n_local, *S]``."""
    ctx = ctx_mod.get_context()
    if name in ctx.windows:
        return False
    x = x if isinstance(x, torch.Tensor) else worker_values(x)
    if x.dim() < 1 or x.shape[0] != ctx.n_local:
        raise ValueError(
            f"win_create expects a worker tensor with leading axis {ctx.n_local}, "
            f"got shape {tuple(x.shape)}"
        )
    in_neighbors = tuple(tuple(lst) for lst in ctx.in_neighbor_ranks())
    out_neighbors = tuple(tuple(lst) for lst in ctx.out_neighbor_ranks())
    max_deg = max((len(n) for n in in_neighbors), default=0)
    value = x.to(ctx.device).clone()
    rows = ctx.n_local
    shape = (rows, max_deg) + tuple(value.shape[1:])
    if zero_init:
        buffers = torch.zeros(shape, dtype=value.dtype, device=ctx.device)
    else:
        buffers = value.unsqueeze(1).expand(shape).clone()
    ctx.windows[name] = _Window(
        name, value, buffers,
        torch.zeros((rows, max_deg), dtype=torch.int32, device=ctx.device),
        torch.ones((rows,), dtype=torch.float32, device=ctx.device),
        torch.zeros((rows, max_deg), dtype=torch.float32, device=ctx.device),
        in_neighbors, out_neighbors,
    )
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Drop one window, or all of them with ``name=None``."""
    ctx = ctx_mod.get_context()
    if name is None:
        ctx.windows.clear()
        return True
    return ctx.windows.pop(name, None) is not None


def get_current_created_window_names() -> List[str]:
    return sorted(ctx_mod.get_context().windows)


def win_read(name: str) -> torch.Tensor:
    """The current window value ``[N, *S]`` (the window's own tensor;
    across processes the local rows)."""
    return _get_win(ctx_mod.get_context(), name).value


def _local_cols(ctx, a: np.ndarray) -> np.ndarray:
    """The local workers' entries of a host array over every worker (its
    last axis); the array itself with one process."""
    if ctx.process_count == 1:
        return a
    return a[..., ctx.rows.start:ctx.rows.stop]


def _local_row(ctx, rank: int) -> int:
    """``rank``'s row in this process's lanes; a rank another process
    holds raises, naming its owner."""
    if not 0 <= rank < ctx.size:
        raise ValueError(f"rank {rank} out of range for {ctx.size} workers")
    if rank not in ctx.rows:
        owner = int(np.searchsorted(np.cumsum(ctx.worker_counts), rank, side="right"))
        raise ValueError(f"rank {rank} is held by process {owner}; this process "
                         f"({ctx.process_index}) holds ranks {ctx.rows.start}.."
                         f"{ctx.rows.stop - 1}")
    return rank - ctx.rows.start


# -- weight specs ------------------------------------------------------------


def _reject_flat_weight_dict(arg_name, value) -> None:
    if isinstance(value, dict) and value and all(
        isinstance(v, (int, float)) for v in value.values()
    ):
        raise ValueError(
            f"{arg_name} looks like a single rank's flat {{rank: weight}} "
            "dict; pass per-rank specs: a sequence (or {rank: ...} dict) of "
            f"one entry per rank, e.g. {arg_name}=[{{...}} for each rank]"
        )


def _per_rank_edges(ctx, spec, default_peers: Sequence[Sequence[int]],
                    arg_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """A per-rank peer-weight spec as ``(w [size, size], participating
    [size] bool)``, ``w[i, j]`` the weight on edge ``i -> j`` (or ``j``'s
    weight for source ``i``, as the caller reads it). ``spec=None``: every
    rank takes part with its default peers at weight 1.0; entry ``None``:
    that rank sits out."""
    size = ctx.size
    if spec is None:
        key = ("win_default_edges", tuple(map(tuple, default_peers)))
        cached = ctx.op_cache.get(key)
        if cached is None:
            w = np.zeros((size, size))
            for r, peers in enumerate(default_peers):
                for d in peers:
                    w[r, d] = 1.0
            participating = np.ones((size,), bool)
            w.setflags(write=False)
            participating.setflags(write=False)
            cached = ctx.op_cache[key] = (w, participating)
        return cached
    w = np.zeros((size, size))
    participating = np.zeros((size,), bool)
    if isinstance(spec, dict):
        _reject_flat_weight_dict(arg_name, spec)
        spec = [spec.get(r) for r in range(size)]
    spec = list(spec)
    if len(spec) != size:
        raise ValueError(
            f"{arg_name} must have one entry per rank ({size}), got {len(spec)}"
        )
    for r, entry in enumerate(spec):
        if entry is None:
            continue
        participating[r] = True
        pairs = entry.items() if isinstance(entry, dict) else ((d, 1.0) for d in entry)
        for d, wt in pairs:
            d = int(d)
            if not 0 <= d < size or d == r:
                raise ValueError(f"{arg_name} for rank {r} has invalid peer {d}")
            w[r, d] = float(wt)
    return w, participating


def _self_weight_vec(ctx, self_weight, participating) -> np.ndarray:
    """Per-rank self scale: a scalar broadcasts, a dict overrides (absent
    ranks keep 1.0), a sequence covers every rank; ranks sitting out are
    forced to 1.0."""
    size = ctx.size
    if self_weight is None:
        vec = np.ones((size,))
    elif isinstance(self_weight, (int, float)):
        vec = np.full((size,), float(self_weight))
    elif isinstance(self_weight, dict):
        vec = np.asarray([float(self_weight.get(r, 1.0)) for r in range(size)])
    else:
        vec = np.asarray([float(v) for v in self_weight])
        if vec.shape != (size,):
            raise ValueError(
                f"per-rank self_weight must have one entry per rank "
                f"({size}), got {vec.shape}"
            )
    return np.where(participating, vec, 1.0)


def _round_weights(perms, w: np.ndarray) -> np.ndarray:
    """``[rounds, size]`` receiver-side weights of each round, read out of
    the edge-weight matrix ``w[src, dst]``."""
    out = np.zeros((len(perms), w.shape[0]), np.float64)
    for r, perm in enumerate(perms):
        if perm:
            s, d = np.asarray(perm, np.intp).T
            out[r, d] = w[s, d]
    return out


def _slot_table(win: _Window, perms) -> np.ndarray:
    """``[size, max(max_deg, 1)]``: the round that writes each buffer slot
    this call, -1 where untouched. A write from a rank that is not a
    create-time in-neighbor has no slot and raises."""
    size = len(win.in_neighbors)
    slot_of = [{s: k for k, s in enumerate(srcs)} for srcs in win.in_neighbors]
    table = np.full((size, max(win.max_deg, 1)), -1, np.int32)
    for r, perm in enumerate(perms):
        for s, d in perm:
            if s not in slot_of[d]:
                raise ValueError(
                    f"window {win.name!r}: rank {s} writes to rank {d} but is "
                    f"not an in-neighbor of {d} in the window's create-time "
                    f"topology {win.in_neighbors[d]}"
                )
            table[d, slot_of[d][s]] = r
    return table


# -- the host age lane ------------------------------------------------------------


def _note_exchange_age(win: _Window, slot_table, mode: str) -> None:
    """After an exchange: advance the clock and stamp the written slots;
    an accumulate also records the birth of the oldest pending mass."""
    win.clock += 1
    written = np.asarray(slot_table) >= 0
    if written.any():
        win.slot_written[written] = win.clock
        if mode == "acc":
            fresh = written & (win.mass_birth < 0)
            win.mass_birth[fresh] = win.clock


def _note_update_age(win: _Window, participating, reset: bool,
                     tick: bool = True) -> None:
    """After a ``win_update``: advance the clock (not with ``tick=False``,
    the window optimizer's exchange and combine being one local step) and,
    when the update collects (``reset``), clear the participating ranks'
    pending-mass births. The slot ages persist."""
    if tick:
        win.clock += 1
    if reset:
        win.mass_birth[np.asarray(participating, bool)] = -1


def _note_local_step(win: _Window) -> None:
    """A local adapt between exchanges is one local step."""
    win.clock += 1


def _note_async_tick(win: _Window, written, folded) -> None:
    """One asynchronous gossip tick: advance the clock, stamp the slots a
    participating sender wrote (``written [size, max_deg]`` bool), record
    their pending-mass births, then clear the births of the ``folded``
    slots."""
    win.clock += 1
    w = np.asarray(written, bool)
    if w.any():
        win.slot_written[w] = win.clock
        fresh = w & (win.mass_birth < 0)
        win.mass_birth[fresh] = win.clock
    f = np.asarray(folded, bool)
    if f.any():
        win.mass_birth[f] = -1


# -- the quantized window wire -------------------------------------------------


_WINDOW_WIRES = ("bf16", "int8", "int4")


def window_wire() -> Optional[str]:
    """The window wire tier from ``BLUEFOG_WINDOW_WIRE``: ``None`` (exact,
    the default), ``'bf16'``, ``'int8'`` or ``'int4'``."""
    w = os.environ.get("BLUEFOG_WINDOW_WIRE", "").strip().lower()
    if w in ("", "0", "off", "none", "fp32", "f32", "exact"):
        return None
    if w not in _WINDOW_WIRES:
        raise ValueError(
            f"BLUEFOG_WINDOW_WIRE must be one of {_WINDOW_WIRES} (or "
            f"unset for the exact wire), got {w!r}"
        )
    return w


# -- the exchange ----------------------------------------------------------------


class _Lowering(NamedTuple):
    """An exchange's structure: the rounds, the slot each writes, and the
    device operands derived from them (across processes ``src`` is the
    rounds' :class:`Route` and the slot operands hold the local columns)."""

    perms: tuple
    slot_table: np.ndarray  # [size, max(max_deg, 1)] round per slot, -1
    src: object  # [R, size] int32 sender per round, -1 for none; or a Route
    slot_round: torch.Tensor  # [max_deg, n_local] int64 round per slot, clipped at 0
    slot_written: torch.Tensor  # [max_deg, n_local] bool


def _lowered_exchange(ctx, win: _Window, w_edges: np.ndarray) -> _Lowering:
    """The rounds and slot table of an edge pattern, cached per (edge
    structure, window topology): training loops repeat one pattern, and
    weight values are not part of the key."""
    mask = w_edges != 0
    method = compiler.plan_method()
    key = ("win_lowering", win.in_neighbors, np.packbits(mask).tobytes(), method)
    cached = ctx.op_cache.get(key)
    if cached is None:
        size = w_edges.shape[0]
        edges = tuple((int(i), int(j)) for i, j in zip(*np.nonzero(mask)))
        perms = perms_from_edges(edges, size, method=method)
        table = _slot_table(win, perms)
        src = np.full((len(perms), size), -1, np.int32)
        for r, perm in enumerate(perms):
            for s, d in perm:
                src[r, d] = s
        cols = _local_cols(ctx, table[:, :win.max_deg].T)
        src_op = (torch.from_numpy(src).to(ctx.device) if ctx.process_count == 1
                  else transport.route(src, size, ctx))
        cached = ctx.op_cache[key] = _Lowering(
            perms, table, src_op,
            torch.from_numpy(np.ascontiguousarray(np.clip(cols, 0, None).astype(np.int64)))
            .to(ctx.device),
            torch.from_numpy(np.ascontiguousarray(cols >= 0)).to(ctx.device),
        )
    return cached


def _f32(a, device) -> torch.Tensor:
    """Host weights (float64) as the f32 device operand the window
    arithmetic uses."""
    return torch.from_numpy(np.asarray(a, np.float64).astype(np.float32)).to(device)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-worker vector ``[N]`` shaped to broadcast against ``like``."""
    return v.to(like.dtype).view((-1,) + (1,) * (like.dim() - 1))


def _received(wire: Optional[str], xb: torch.Tensor, src, pv: Optional[torch.Tensor] = None):
    """``(x_hat, [round r's received payload, decoded], [round r's
    received p] or None)`` of the sender payloads ``xb [N, *S]`` (and of
    the p lane ``pv [N]`` when given): ``x_hat`` is the sender's own
    reconstruction (None on the exact wire). Across processes ``src`` is a
    :class:`Route`: the local rows (their wire pairs) and p ship in one
    exchange."""
    if isinstance(src, Route):
        return _received_route(wire, xb, src, pv)
    n_rounds = src.shape[0]
    prounds = None if pv is None else [inner._gather(pv, src[r]) for r in range(n_rounds)]
    return _received_stacked(wire, xb, src, n_rounds) + (prounds,)


def _received_route(wire: Optional[str], xb: torch.Tensor, rt: Route, pv):
    """:func:`_received` over the multi-process transport."""
    extra = [] if pv is None else [pv.contiguous()]
    n_rounds = rt.n_rounds
    xhat = None
    if wire in ("int8", "int4"):
        flat = xb.to(torch.float32).reshape(xb.shape[0], -1)
        n = flat.shape[1]
        payload, scales = kernels.encode(kernels.pad_blocks(flat).contiguous(), wire)
        ext = rt.exchange([payload, scales] + extra)

        def full(p, s, src_r):
            out = kernels.decode(p, s, src_r, wire, src_in_range=True)
            return kernels.unpad_blocks(out, n).reshape(xb.shape)

        xhat = full(payload, scales, None)
        rounds = [full(ext[0], ext[1], rt[r]) for r in range(n_rounds)]
    else:
        sent = xb.to(torch.bfloat16) if wire == "bf16" else xb
        ext = rt.exchange([sent.contiguous()] + extra)
        rounds = [inner._gather(ext[0], rt[r]) for r in range(n_rounds)]
        if wire == "bf16":
            xhat = sent.to(torch.float32)
            rounds = [t.to(torch.float32) for t in rounds]
    prounds = None if pv is None else [inner._gather(ext[-1], rt[r]) for r in range(n_rounds)]
    return xhat, rounds, prounds


def _received_stacked(wire: Optional[str], xb: torch.Tensor, src: torch.Tensor, n_rounds: int):
    """:func:`_received`'s ``(x_hat, rounds)`` on the stacked rows."""
    if wire == "bf16":
        q16 = xb.to(torch.bfloat16)
        rounds = [inner._gather(q16, src[r]).to(torch.float32) for r in range(n_rounds)]
        return q16.to(torch.float32), rounds
    if wire in ("int8", "int4"):
        flat = xb.to(torch.float32).reshape(xb.shape[0], -1)
        n = flat.shape[1]
        payload, scales = kernels.encode(kernels.pad_blocks(flat).contiguous(), wire)

        def full(src_r):
            out = kernels.decode(payload, scales, src_r, wire, src_in_range=True)
            return kernels.unpad_blocks(out, n).reshape(xb.shape)

        return full(None), [full(src[r]) for r in range(n_rounds)]
    return None, [inner._gather(xb, src[r]) for r in range(n_rounds)]


def _exchange_core(mode: str, low: _Lowering, update_p: bool, max_deg: int,
                   v, bufs, vers, pv, pbufs, xb, recv_w, self_w,
                   wire: Optional[str] = None, sent_w=None):
    """The exchange math on the stacked state: ``'put'`` replaces the written
    slots with ``w * x``, ``'acc'`` adds it, ``'get'`` pulls ``w *`` the
    source's value (``xb`` is then the window value). ``recv_w [R, N]``,
    ``self_w [N]`` and ``sent_w [N]`` are f32 device weights. In ``'acc'``
    mode on a quantized wire the sender also keeps the residual of the
    mass it shipped, ``sent_w * (x - x_hat)``, so ``self_w * x + sum_d w_d
    * x_hat + sent_w * (x - x_hat) == x`` column by column.

    ``bufs`` is updated in place; returns ``(v, bufs, vers, p,
    p_buffers)``, the others new tensors."""
    xhat, rounds, prounds = _received(wire, xb, low.src, pv if update_p else None)
    n_rounds = len(rounds)
    if n_rounds and max_deg:
        recvs = torch.empty((n_rounds,) + tuple(v.shape), dtype=v.dtype, device=v.device)
        for r in range(n_rounds):
            got = rounds[r].to(v.dtype)
            torch.mul(got, _rows(recv_w[r], got), out=recvs[r])
        rounds = None
        workers = torch.arange(v.shape[0], device=v.device)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if update_p:
            precvs = torch.stack([prounds[r] * recv_w[r].to(pv.dtype) for r in range(n_rounds)])
            pcols = []
        for k in range(max_deg):
            written = low.slot_written[k]
            wmask = written.view((-1,) + (1,) * (v.dim() - 1))
            delivered = torch.where(wmask, recvs[low.slot_round[k], workers], zero)
            slot = bufs[:, k]
            if mode == "acc":
                slot.add_(delivered)
            else:
                slot.copy_(torch.where(wmask, delivered, slot))
            if update_p:
                pdel = torch.where(written, precvs[low.slot_round[k], workers],
                                   torch.zeros((), dtype=pv.dtype, device=pv.device))
                pcols.append(pbufs[:, k] + pdel if mode == "acc"
                             else torch.where(written, pdel, pbufs[:, k]))
        if update_p:
            pbufs = torch.stack(pcols, dim=1)
        vers = vers + low.slot_written.T.to(vers.dtype)
    new_v = v * _rows(self_w, v)
    if wire is not None and mode == "acc" and sent_w is not None:
        resid = xb.to(torch.float32) - xhat
        new_v = new_v + (_rows(sent_w, resid) * resid).to(v.dtype)
    new_p = pv * self_w.to(pv.dtype) if update_p else pv
    return new_v, bufs, vers, new_p, pbufs


def _dispatch_exchange(win: _Window, ctx, mode: str, w_edges, participating,
                       self_weight, x, hooks: bool = True) -> None:
    """Run one exchange on the window's lanes and note it in the age lane;
    ``hooks`` counts it in the window-op series and the flight recorder
    (after the checks: a refused exchange counts nothing)."""
    wire = window_wire()
    if wire is not None and not win.dtype.is_floating_point:
        raise ValueError(
            f"BLUEFOG_WINDOW_WIRE={wire!r} needs a float window; "
            f"{win.name!r} holds {win.dtype}"
        )
    if x is None:
        x = win.value
    else:
        x = _check_worker_tensor(ctx, x).to(win.dtype)
        if tuple(x.shape[1:]) != win.shape:
            raise ValueError(
                f"window {win.name!r} holds shape {win.shape}, got "
                f"{tuple(x.shape[1:])}"
            )
    if hooks:
        metrics.counter(f"bluefog.window_ops.{mode}").inc()
        flight.record("window_op", op=mode, window=win.name)
    self_vec = _self_weight_vec(ctx, self_weight, participating)
    low = _lowered_exchange(ctx, win, w_edges)
    if hooks:
        n_elems = int(np.prod(win.shape)) if win.shape else 1
        metrics.counter("bluefog.window_wire_bytes").inc(metrics.wire_bytes_per_step(
            {win.dtype.itemsize: n_elems}, len(low.perms), wire))
    dev = ctx.device
    win.value, win.buffers, win.versions, win.p, win.p_buffers = _exchange_core(
        mode, low, ctx.p_enabled(), win.max_deg,
        win.value, win.buffers, win.versions, win.p, win.p_buffers, x,
        _f32(_local_cols(ctx, _round_weights(low.perms, w_edges)), dev),
        _f32(_local_cols(ctx, self_vec), dev),
        wire=wire, sent_w=_f32(_local_cols(ctx, w_edges.sum(axis=1)), dev),
    )
    _note_exchange_age(win, low.slot_table, mode)


def _exchange(ctx, win: _Window, mode: str, x=None, self_weight=None, weights=None,
              hooks: bool = True) -> None:
    """A ``'put'`` or ``'acc'`` exchange under per-rank ``dst_weights``, or
    a ``'get'`` under receiver-keyed ``src_weights`` (``weights``), as the
    ``win_*`` ops resolve them."""
    if mode == "get":
        w_recv, participating = _per_rank_edges(ctx, weights, win.in_neighbors, "src_weights")
        _dispatch_exchange(win, ctx, "get", w_recv.T, np.zeros_like(participating), None, None,
                           hooks)
    else:
        w, participating = _per_rank_edges(ctx, weights, win.out_neighbors, "dst_weights")
        _dispatch_exchange(win, ctx, mode, w, participating, self_weight, x, hooks)


# -- put / accumulate / get ------------------------------------------------------

_handle_ids = itertools.count()


def _completed(ctx, result: torch.Tensor) -> int:
    """A handle, kept on the context, for an op that already ran."""
    handle = next(_handle_ids)
    ctx.handles[handle] = result
    return handle


def win_wait(handle: int) -> torch.Tensor:
    """The result of a ``*_nonblocking`` window op (already complete); a
    host blocking point like :func:`bluefog_tpu_torch.synchronize`."""
    from bluefog_tpu_torch.collective.ops import _blocking_wait

    handles = ctx_mod.get_context().handles
    if handle not in handles:
        raise ValueError(f"unknown handle {handle}: already waited on")
    _blocking_wait(handle, None)
    return handles.pop(handle)


def win_poll(handle: int) -> bool:
    """Window ops run eagerly: every handle is complete."""
    return True


def win_put_nonblocking(x=None, name: str = None, self_weight=None,
                        dst_weights=None, require_mutex: bool = False) -> int:
    """Write ``dst_weight * x`` into each destination's buffer for me
    (replacing it) and rescale my window value by ``self_weight``."""
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    _exchange(ctx, win, "put", x, self_weight, dst_weights)
    return _completed(ctx, win.value)


def win_put(x=None, name: str = None, self_weight=None, dst_weights=None,
            require_mutex: bool = False) -> torch.Tensor:
    return win_wait(win_put_nonblocking(x, name, self_weight, dst_weights, require_mutex))


def win_accumulate_nonblocking(x=None, name: str = None, self_weight=None,
                               dst_weights=None, require_mutex: bool = False) -> int:
    """Add ``dst_weight * x`` into each destination's buffer for me."""
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    _exchange(ctx, win, "acc", x, self_weight, dst_weights)
    return _completed(ctx, win.value)


def win_accumulate(x=None, name: str = None, self_weight=None,
                   dst_weights=None, require_mutex: bool = False) -> torch.Tensor:
    return win_wait(win_accumulate_nonblocking(x, name, self_weight, dst_weights,
                                               require_mutex))


def win_get_nonblocking(name: str = None, src_weights=None,
                        require_mutex: bool = False) -> int:
    """Fetch ``src_weight *`` each source's current window value into my
    buffer for that source; ``src_weights[j] = {src: w}``."""
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    _exchange(ctx, win, "get", weights=src_weights)
    return _completed(ctx, win.value)


def win_get(name: str = None, src_weights=None, require_mutex: bool = False) -> torch.Tensor:
    return win_wait(win_get_nonblocking(name, src_weights, require_mutex))


# -- update ----------------------------------------------------------------------


def _check_update_sources(ctx, win: _Window, w_recv: np.ndarray) -> None:
    """Weights on sources without a create-time buffer slot raise."""
    key = ("win_allowed_sources", win.in_neighbors)
    allowed = ctx.op_cache.get(key)
    if allowed is None:
        size = len(win.in_neighbors)
        allowed = np.eye(size, dtype=bool)
        for r, srcs in enumerate(win.in_neighbors):
            allowed[r, list(srcs)] = True
        allowed.setflags(write=False)
        ctx.op_cache[key] = allowed
    viol = (w_recv != 0) & ~allowed
    if viol.any():
        r = int(np.nonzero(viol.any(axis=1))[0][0])
        extra = sorted(int(s) for s in np.nonzero(viol[r])[0])
        raise ValueError(
            f"win_update weights for rank {r} reference {extra}, which have "
            f"no buffer slot in window {win.name!r} (create-time "
            f"in-neighbors: {win.in_neighbors[r]}); re-create the window "
            "after changing the topology"
        )


def _update_weights(ctx, win: _Window, self_weight, neighbor_weights):
    """``(self_vec [size], w_recv [size, size], participating)`` of a
    ``win_update``: explicit, the topology's weights (weighted context),
    or uniform ``1 / (in_degree + 1)``."""
    size = ctx.size
    if (self_weight is None) != (neighbor_weights is None):
        raise ValueError("self_weight and neighbor_weights must be given together")
    if self_weight is not None:
        w_recv, participating = _per_rank_edges(
            ctx, neighbor_weights, win.in_neighbors, "neighbor_weights"
        )
        self_vec = _self_weight_vec(ctx, self_weight, participating)
        _check_update_sources(ctx, win, w_recv)
        return self_vec, w_recv, participating
    key = ("win_update_weights", win.in_neighbors, ctx.topo_version)
    cached = ctx.op_cache.get(key)
    if cached is None:
        for stale in [k for k in ctx.op_cache
                      if k[0] == "win_update_weights" and k[1] == win.in_neighbors]:
            del ctx.op_cache[stale]
        participating = np.ones(size, bool)
        w_recv = np.zeros((size, size))
        self_vec = np.zeros((size,))
        if ctx.is_topo_weighted():
            topo = ctx.load_topology()
            for r in range(size):
                sw, nw = GetRecvWeights(topo, r)
                self_vec[r] = sw
                for s, wt in nw.items():
                    w_recv[r, s] = wt
        else:
            for r, srcs in enumerate(win.in_neighbors):
                u = 1.0 / (len(srcs) + 1)
                self_vec[r] = u
                w_recv[r, list(srcs)] = u
        _check_update_sources(ctx, win, w_recv)
        for a in (self_vec, w_recv, participating):
            a.setflags(write=False)
        cached = ctx.op_cache[key] = (self_vec, w_recv, participating)
    return cached


def _slot_weights(win: _Window, w_recv: np.ndarray, size: int) -> np.ndarray:
    """``[size, max(max_deg, 1)]``: each buffer slot's combine weight."""
    slot_w = np.zeros((size, max(win.max_deg, 1)))
    for r, srcs in enumerate(win.in_neighbors):
        for k, s in enumerate(srcs):
            slot_w[r, k] = w_recv[r, s]
    return slot_w


def _slot_dot(slot_w: torch.Tensor, t: torch.Tensor, max_deg: int) -> torch.Tensor:
    """``sum_k slot_w[:, k] * t[:, k]`` in slot order (``t [N, K, ...]``)."""
    out = None
    for k in range(max_deg):
        term = _rows(slot_w[:, k], t[:, k]) * t[:, k]
        out = term if out is None else out + term
    return out


def _update_core(reset: bool, update_p: bool, max_deg: int,
                 v, bufs, vers, pv, pbufs, self_w, slot_w, part):
    """The combine on the stacked state: ``v <- self_w * v + sum_k slot_w[:, k] * buffer_k``, versions of
    the participating ranks reset, their buffers zeroed with ``reset``,
    the p lane mirrored. ``self_w [N]``, ``slot_w [N, K]`` f32 and
    ``part [N]`` bool are device operands. ``bufs`` is reset in place;
    returns ``(v, bufs, vers, p, p_buffers)``."""
    new_v = v * _rows(self_w, v)
    if max_deg:
        new_v = new_v + _slot_dot(slot_w.to(v.dtype), bufs, max_deg)
    if update_p:
        new_p = pv * self_w.to(pv.dtype)
        if max_deg:
            new_p = new_p + _slot_dot(slot_w.to(pv.dtype), pbufs, max_deg)
        new_p = torch.where(part, new_p, pv)
        if reset:
            pbufs = torch.where(part[:, None], torch.zeros_like(pbufs), pbufs)
    else:
        new_p = pv
    if reset and max_deg:
        bufs[part] = 0
    vers = torch.where(part[:, None], torch.zeros_like(vers), vers)
    return new_v, bufs, vers, new_p, pbufs


def _dispatch_update(win: _Window, ctx, self_weight, neighbor_weights, reset: bool,
                     tick: bool = True) -> None:
    """Run one combine on the window's lanes and note it in the age lane
    (``tick=False``: as part of the exchange's local step)."""
    self_vec, w_recv, participating = _update_weights(ctx, win, self_weight, neighbor_weights)
    dev = ctx.device
    rows = slice(ctx.rows.start, ctx.rows.stop)
    win.value, win.buffers, win.versions, win.p, win.p_buffers = _update_core(
        reset, ctx.p_enabled(), win.max_deg,
        win.value, win.buffers, win.versions, win.p, win.p_buffers,
        _f32(self_vec[rows], dev), _f32(_slot_weights(win, w_recv, ctx.size)[rows], dev),
        torch.from_numpy(np.array(participating[rows], bool)).to(dev),
    )
    _note_update_age(win, participating, reset, tick=tick)


def _collect_weights(win: _Window):
    """``(self_weight, neighbor_weights)`` of the push-sum collect: self and
    every buffer at weight 1."""
    return 1.0, [{s: 1.0 for s in srcs} for srcs in win.in_neighbors]


def win_update(name: str = None, self_weight=None, neighbor_weights=None,
               reset: bool = False, clone: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
    """Combine the window value with its buffers and return the new
    value: ``v_j <- self_w[j] * v_j + sum_k w[j, src_k] * buffer_k``.
    Default weights follow the active topology (weighted) or the uniform
    average. Versions reset to zero; ``reset`` also zeroes the buffers.
    ``clone`` returns a copy rather than the window's own tensor."""
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    metrics.counter("bluefog.window_ops.update").inc()
    flight.record("window_op", op="update", window=win.name)
    stal_mod.observe_window(ctx, win)
    _dispatch_update(win, ctx, self_weight, neighbor_weights, reset)
    return win.value.clone() if clone else win.value


def win_update_then_collect(name: str = None, require_mutex: bool = False) -> torch.Tensor:
    """Sum self and all neighbor buffers, then zero the buffers: the
    push-sum collect."""
    win = _get_win(ctx_mod.get_context(), name)
    self_weight, ones = _collect_weights(win)
    return win_update(name, self_weight=self_weight, neighbor_weights=ones, reset=True)


# -- versions / associated p ------------------------------------------------------


def get_win_version(name: str = None, rank: Optional[int] = None, ages: bool = False):
    """Writes per in-neighbor buffer since the last ``win_update``:
    per-rank dicts ``{in_neighbor: count}`` (across processes, of the
    local ranks), or one dict for ``rank`` (a local one).
    ``ages=True`` answers with :func:`get_win_age` instead: the write
    counter resets at every update, the age counts on from the write."""
    if ages:
        return get_win_age(name, rank)
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    vers = win.versions.cpu().numpy()
    out = [
        {s: int(vers[i, k]) for k, s in enumerate(win.in_neighbors[r])}
        for i, r in enumerate(ctx.rows)
    ]
    return out[_local_row(ctx, rank)] if rank is not None else out


def get_win_age(name: str = None, rank: Optional[int] = None, mass: bool = False):
    """Per in-neighbor buffer age in local window steps: how many of this
    window's local steps (exchanges, updates, local adapts, asynchronous
    ticks) have passed since neighbor ``k``'s slot was last written; 0
    everywhere on a fresh window. ``mass=True`` gives the age of the oldest
    uncollected ``win_accumulate`` mass per slot instead (``None`` when
    none is pending). Per-rank dicts ``{in_neighbor: age}``, or one dict
    for ``rank``."""
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    clock = int(win.clock)
    out = []
    for r in range(ctx.size):
        entry = {}
        for k, s in enumerate(win.in_neighbors[r]):
            if mass:
                b = int(win.mass_birth[r, k])
                entry[s] = (clock - b) if b >= 0 else None
            else:
                entry[s] = clock - int(win.slot_written[r, k])
        out.append(entry)
    return out[rank] if rank is not None else out


@contextlib.contextmanager
def win_mutex(name: str = None, for_self: bool = False,
              ranks: Optional[Sequence[int]] = None):
    """Checks that the window exists and holds nothing: one process drives
    each worker group's ops in order, so there is no concurrent writer to
    keep out."""
    _get_win(ctx_mod.get_context(), name)
    yield


def turn_on_win_ops_with_associated_p() -> None:
    """Window ops carry the associated-p lane from now on (until the
    context shuts down or the switch is turned off)."""
    ctx_mod.get_context().p_switch = True


def turn_off_win_ops_with_associated_p() -> None:
    if ctx_mod.is_initialized():
        ctx_mod.get_context().p_switch = False


def win_associated_p(name: str = None, rank: Optional[int] = None):
    """The push-sum weights of the window: a ``[size]`` numpy array (across
    processes ``[n_local]``, the local ranks'), or a float for one (local)
    rank."""
    ctx = ctx_mod.get_context()
    win = _get_win(ctx, name)
    p = win.p.cpu().numpy()
    return float(p[_local_row(ctx, rank)]) if rank is not None else p
