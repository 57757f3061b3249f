# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Byte models of the wire, the optimizer state and the reduce-scatter,
and the accounting of the transfers a combine makes.

Counterpart of ``bluefog_tpu/scaling.py``: what one round of a wire tier
ships (:func:`wire_payload_bytes`, the single accounting the chunk chooser
prices from), a step's wire bytes, the temporaries of the quantized wire,
the optimizer state per worker (measured from a state tree, or analytic),
a plan's round and byte summary, and the ring allreduce, one-peer gossip
and ring reduce-scatter costs.

The JAX package compiles one combine and reads its collectives out of the
optimized HLO (:func:`hlo_collective_stats`, kept here as the same regex
reader). The port runs eagerly, so :func:`gossip_comm_stats` runs one
combine and counts the transfers it made (``inner.record_transfers``): in one
process a gather along the worker axis is a ``collective-permute`` of one
worker's payload, across processes a round of the :class:`Route` the
combine posted. :func:`weak_scaling_times` times a step over 1, 2, 4, ...
stacked workers (CUDA events on the card, the host clock on the CPU).
"""

import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import sharding
from bluefog_tpu_torch.collective.compiler import (  # noqa: F401  (re-export)
    ICI_LINK_BYTES_PER_S,
    ROUND_ALPHA_S,
    calibration,
    pipelined_cost_s,
    plan_cost_s,
)
from bluefog_tpu_torch.collective.plan import CommPlan

__all__ = [
    "hlo_collective_stats",
    "gossip_comm_stats",
    "weak_scaling_times",
    "plan_comm_summary",
    "wire_payload_bytes",
    "wire_bytes_per_step",
    "quantized_temporaries_bytes",
    "optimizer_state_bytes",
    "LINEAGE_TAG_BYTES",
    "ring_allreduce_cost",
    "reduce_scatter_bytes",
    "ring_reduce_scatter_cost",
    "one_peer_gossip_cost",
    "ROUND_ALPHA_S",
    "ICI_LINK_BYTES_PER_S",
    "plan_cost_s",
    "pipelined_cost_s",
    "calibration",
]

_QUANT_CHUNK = 512

# The scale sidecar per 512-element block: an f32 scale on the int8 tiers,
# a bf16 one on the int4 tiers.
_SCALE_BYTES_PER_BLOCK = {"int8": 4, "int8_ef": 4, "int4": 2, "int4_ef": 2}

# The JAX package's staleness lineage tag: one int32 per field (birth step,
# topology version, membership epoch).
LINEAGE_TAG_BYTES = 4 * 3


def wire_payload_bytes(n_elems: int, itemsize: int, wire: Optional[str] = None,
                       lineage: bool = False) -> int:
    """Bytes one round of a wire tier ships for an ``n_elems`` payload,
    scale sidecar included: the block-scaled tiers ship whole 512-element
    blocks (int8: 512 B + a 4-byte scale a block; int4: 256 B + a 2-byte
    scale), bf16 two bytes an element, the exact tier ``itemsize``;
    ``lineage`` adds the lineage tag."""
    extra = LINEAGE_TAG_BYTES if lineage else 0
    if wire in ("int8", "int8_ef", "int4", "int4_ef"):
        blocks = -(-int(n_elems) // _QUANT_CHUNK) if n_elems else 0
        per_block = _QUANT_CHUNK if wire in ("int8", "int8_ef") else _QUANT_CHUNK // 2
        return blocks * (per_block + _SCALE_BYTES_PER_BLOCK[wire]) + extra
    if wire == "bf16":
        return 2 * int(n_elems) + extra
    return int(itemsize) * int(n_elems) + extra


def wire_bytes_per_step(n_elems_by_itemsize, n_rounds: int, wire: Optional[str] = None,
                        lineage: bool = False) -> int:
    """Wire bytes of one gossip step per worker: ``{itemsize: elements}``
    per dtype group, re-shipped every round."""
    per_round = sum(
        wire_payload_bytes(n, itemsize, wire) for itemsize, n in n_elems_by_itemsize.items()
    ) + (LINEAGE_TAG_BYTES if lineage else 0)
    return per_round * n_rounds


def quantized_temporaries_bytes(n_elems: int, wire: Optional[str] = None,
                                fused: bool = False) -> int:
    """The JAX package's model of the full-width temporaries one round of
    the quantized wire stages: the composite chain's int8 (and packed int4)
    staging plus the f32 reconstruction; ``fused=True`` the kernels' (the
    local wire pair and one received pair, no reconstruction)."""
    if not n_elems:
        return 0
    if wire in ("int8", "int8_ef", "int4", "int4_ef"):
        blocks = -(-int(n_elems) // _QUANT_CHUNK)
        padded = blocks * _QUANT_CHUNK
        if fused:
            if wire in ("int4", "int4_ef"):
                packed, sidecar = padded // 2, blocks * 2
            else:
                packed, sidecar = padded, blocks * 4
            return 2 * (packed + sidecar)
        staging = padded + (padded // 2 if wire in ("int4", "int4_ef") else 0)
        return 4 * padded + staging
    if wire == "bf16":
        return 4 * int(n_elems)
    return 0


def _tree_bytes(tree) -> int:
    from bluefog_tpu_torch.optimizers import tree_leaves

    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))


def optimizer_state_bytes(params=None, opt=None, *, shard: bool = False,
                          master: Optional[bool] = None, live: Optional[Sequence[int]] = None,
                          state=None, world: Optional[int] = None) -> int:
    """Optimizer-state bytes per worker.

    - measured: ``state=`` (a worker-stacked state tree): its bytes over
      the worker count (``world``, default the leading axis of its first
      leaf);
    - analytic: ``params`` (worker-stacked) and ``opt`` (a distributed
      optimizer or an inner one): the inner optimizer's state of one
      worker, built on the ``meta`` device (nothing is allocated), over
      the full parameters, or with ``shard=True`` over the owned slots of
      :func:`bluefog_tpu_torch.sharding.build_layout` (``master`` adds the
      f32 master slices, default ``BLUEFOG_SHARD_MASTER``; ``live`` the
      owner set, default every worker)."""
    from bluefog_tpu_torch.optimizers import _dtype_name, tree_leaves

    if state is not None:
        leaves = tree_leaves(state)
        if not leaves:
            return 0
        n = int(world) if world else int(leaves[0].shape[0])
        return _tree_bytes(state) // max(n, 1)
    if params is None or opt is None:
        raise ValueError(
            "optimizer_state_bytes needs either state= (measured) or params + opt (analytic)"
        )
    tx = getattr(opt, "tx", opt)
    leaves = tree_leaves(params)
    size = int(leaves[0].shape[0])
    if not shard:
        return _tree_bytes(tx.init([torch.empty((1,) + tuple(l.shape[1:]), dtype=l.dtype,
                                                device="meta") for l in leaves]))
    if master is None:
        master = sharding.master_enabled()
    by_dtype: Dict[str, int] = {}
    for l in leaves:
        by_dtype[_dtype_name(l.dtype)] = by_dtype.get(_dtype_name(l.dtype), 0) + l[0].numel()
    layout = sharding.build_layout(sorted(by_dtype.items()),
                                   live if live is not None else range(size), size,
                                   master=master)
    slices = [torch.empty((1, g.slot), dtype=getattr(torch, g.dtype), device="meta")
              for g in layout.groups]
    total = _tree_bytes(tx.init(tuple(slices)))
    if master:
        total += sum(4 * g.slot for g in layout.groups)
    return total


def plan_comm_summary(plan: CommPlan, payload_bytes: int, wire: Optional[str] = None,
                      itemsize: int = 4) -> Dict[str, object]:
    """One plan's rounds and bytes: the compiler's decomposition, the naive
    and chosen round counts, the König bound, the wire bytes a round at
    ``payload_bytes`` (uncompressed, per bucket) and the compression ratio,
    the predicted cost, and the chunk count the chooser would pipeline at
    with its cost."""
    from bluefog_tpu_torch.collective import compiler as _compiler

    info = plan.compile_info
    rounds = len(plan.perms)
    naive_rounds = info.offset_rounds if info else rounds
    congestion = info.congestion if info and info.congestion else (1.0,) * rounds
    link_class = getattr(info, "link_class", "ici") if info else "ici"
    n_elems = int(payload_bytes) // max(int(itemsize), 1)
    wire_bytes = wire_payload_bytes(n_elems, itemsize, wire)
    auto_chunks, chunked_cost = _compiler.chunk_option(wire_bytes, congestion, n_elems=n_elems,
                                                       link_class=link_class)
    return {
        "rounds": rounds,
        "decomposition": info.method if info else "offset",
        "route": info.route if info else "direct",
        "link_class": link_class,
        "naive_rounds": naive_rounds,
        "lower_bound": info.lower_bound if info else rounds,
        "wire": wire or "exact",
        "wire_bytes_per_round": wire_bytes,
        "effective_compression_ratio": (
            round(payload_bytes / wire_bytes, 4) if wire_bytes else 1.0
        ),
        "max_congestion": max(congestion, default=1.0),
        "lineage_sidecar_bytes_per_round": LINEAGE_TAG_BYTES,
        "predicted_cost_us": plan_cost_s(rounds, wire_bytes, link_class=link_class) * 1e6,
        "naive_cost_us": plan_cost_s(naive_rounds, wire_bytes, link_class=link_class) * 1e6,
        "auto_chunks": auto_chunks,
        "chunked_cost_us": chunked_cost * 1e6,
    }


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "f8e4m3fnuz": 1, "f8e5m2fnuz": 1,
}

# ``dtype[d0,d1,...]{layout} collective-permute(``: the instruction's result
# shape is its payload. An async ``-start`` carries the op and the payload
# (counted), its ``-done`` does not; the shape may be a tuple (an async
# start's operands, results and contexts, or a variadic collective's
# results), so the whole shape string is captured and every element read.
_COLLECTIVE_RE = re.compile(
    r"=\s*((?:\()?\w+\[[\d,]*\][^=\n]*?)\s"
    r"(collective-permute|all-reduce|all-gather|reduce-scatter|"
    r"all-to-all)(-start)?\("
)

_SHAPE_ELEM_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


# Async starts whose result tuple is ``(operands..., results...,
# contexts...)``, the operands aliasing the results shape for shape; the
# all-reduce, reduce-scatter and all-to-all starts return results only.
_ALIASING_STARTS = ("collective-permute", "all-gather")


def _instruction_bytes(shape_str: str, kind: str, is_start: bool) -> int:
    """Payload bytes of one collective from its (possibly tuple) shape: a
    plain shape is the payload; a variadic collective's tuple sums its
    results; an aliasing async start's tuple, its scalar context lanes
    dropped, is counted by its second half (the results). An unknown dtype
    counts 4 bytes an element rather than none."""
    elems = _SHAPE_ELEM_RE.findall(shape_str)
    if not shape_str.lstrip().startswith("("):
        return _shape_bytes(*elems[0]) if elems else 0
    if is_start and kind in _ALIASING_STARTS:
        data = [e for e in elems if e[1]]
        if len(data) % 2 == 0 and data:
            data = data[len(data) // 2:]
        return sum(_shape_bytes(dt, dims) for dt, dims in data)
    return sum(_shape_bytes(dt, dims) for dt, dims in elems)


def hlo_collective_stats(hlo_text: str) -> Dict[str, Dict[str, int]]:
    """Collective instructions and their payload bytes in optimized HLO
    text: ``{kind: {"count", "bytes"}}`` over collective-permute,
    all-reduce, all-gather, reduce-scatter and all-to-all. For a permute
    the bytes are one device's wire transfer; for an all-reduce the
    logical payload. The JAX package's reader, for HLO written by it."""
    stats: Dict[str, Dict[str, int]] = {}
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        shape_str, kind, start = m.group(1), m.group(2), m.group(3)
        entry = stats.setdefault(kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += _instruction_bytes(shape_str, kind, start is not None)
    return stats


def gossip_comm_stats(plan: CommPlan, payload_elems: int, dtype=torch.float32,
                      mode: str = "neighbor_allreduce",
                      include_plan: bool = False) -> Dict[str, Dict[str, int]]:
    """Run one combine over ``plan`` on ``[N, payload_elems]`` zeros and
    count the transfers it made, in the JAX function's form ``{kind: {"count",
    "bytes"}}``.

    ``mode`` is ``"neighbor_allreduce"`` (the plan's rounds) or
    ``"allreduce"`` (one ``all-reduce`` of the logical payload). In one
    process each gather along the worker axis is one
    ``collective-permute`` of one worker's payload; across processes
    (``x`` is then this process's rows) a round counts once if some process
    posted a message in it on the combine's
    :class:`~bluefog_tpu_torch.collective.transport.Route` or read a row
    of it, however many peers it has, agreed over the processes, so every
    process returns the stacked run's dict. ``include_plan=True`` adds
    :func:`plan_comm_summary` under ``"plan"``. The zeros lie on the
    context's device (``"cuda"`` without a context)."""
    from bluefog_tpu_torch import context as ctx_mod
    from bluefog_tpu_torch.collective import inner, transport

    if mode not in ("neighbor_allreduce", "allreduce"):
        raise ValueError(f"unknown mode {mode!r}")
    ctx = ctx_mod._context
    device = ctx.device if ctx is not None else torch.device("cuda")
    multi = inner._multi_process()
    rows = plan.size
    if multi is not None:
        if plan.size != multi.size:
            raise ValueError(f"a plan over {plan.size} ranks across processes of "
                             f"{multi.size} workers")
        rows = multi.n_local
    x = torch.zeros((rows, int(payload_elems)), dtype=dtype, device=device)
    with inner.record_transfers() as log:
        if mode == "neighbor_allreduce":
            inner.neighbor_allreduce(x, plan)
        else:
            inner.allreduce(x, average=True)
    stats: Dict[str, Dict[str, int]] = {}

    def add(kind, n_bytes):
        entry = stats.setdefault(kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += int(n_bytes)

    routes = [v for k, v in log if k == "route"]
    for kind, value in log:
        if kind == "all-reduce":
            add("all-reduce", value)
        elif kind == "gather" and not routes:
            add("collective-permute", value)
    if routes:
        row_bytes = int(payload_elems) * inner._weight_dtype(x).itemsize
        for rt in routes:
            mine = {int(r) for r, *_ in rt.sends} | {int(r) for r, *_ in rt.recvs}
            mine |= {int(r) for r in np.nonzero((rt.local >= 0).any(dim=1).cpu().numpy())[0]}
            for _ in set().union(*transport.gather_objects(sorted(mine), multi)):
                add("collective-permute", row_bytes)
    if include_plan:
        stats["plan"] = plan_comm_summary(plan, int(payload_elems) * dtype.itemsize)
    return stats


def ring_allreduce_cost(n: int, payload_bytes: int) -> Dict[str, float]:
    """Ring allreduce per worker: ``2 (N - 1)`` hops moving ``2 (N - 1) /
    N`` of the payload."""
    return {"latency_hops": 2 * (n - 1), "wire_bytes": 2.0 * (n - 1) / n * payload_bytes}


def one_peer_gossip_cost(payload_bytes: int) -> Dict[str, float]:
    """Dynamic one-peer gossip: one hop, one payload, whatever ``N``."""
    return {"latency_hops": 1, "wire_bytes": float(payload_bytes)}


def reduce_scatter_bytes(groups, n: int, wire: Optional[str] = None) -> int:
    """Wire bytes per worker of one ZeRO-2 reduce-scatter: ``N - 1`` rounds
    each shipping one slot per dtype group (``groups`` = ``[(slot elements,
    itemsize)]``), priced by :func:`wire_payload_bytes`."""
    return sum(
        (max(int(n), 1) - 1) * wire_payload_bytes(slot, itemsize, wire)
        for slot, itemsize in groups
    )


def ring_reduce_scatter_cost(n: int, slot_bytes: int) -> Dict[str, float]:
    """Ring reduce-scatter per worker: ``N - 1`` hops of one slot each."""
    return {"latency_hops": n - 1, "wire_bytes": float((n - 1) * slot_bytes)}


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def _read_back(out) -> None:
    t = _first_tensor(out)
    if t is not None:
        t.reshape(-1)[:1].tolist()


def weak_scaling_times(make_step: Callable[[int], Tuple[Callable, tuple]], ns: Sequence[int],
                       steps: int = 10, warmup: int = 3) -> List[Dict[str, float]]:
    """Time one step at each worker count in ``ns``.

    ``make_step(n)`` returns ``(fn, args)``: ``fn(*args)`` runs one step of
    ``n`` stacked workers and returns outputs whose first tensor lies on
    the device the step runs on. Each worker's work must stay the same
    over ``ns`` (weak scaling), so ``efficiency = t[0] / t[n]``. After
    ``warmup`` steps (at least one: its output names the device),
    ``steps`` steps are timed: with CUDA events on a
    CUDA output, else with the host clock, reading the first output back
    before and after. Returns ``[{"n", "ms_per_step", "efficiency"}]``."""
    out: List[Dict[str, float]] = []
    t1 = None
    for n in ns:
        fn, args = make_step(n)
        res = fn(*args)
        for _ in range(max(int(warmup) - 1, 0)):
            res = fn(*args)
        first = _first_tensor(res)
        if first is not None and first.is_cuda:
            with torch.cuda.device(first.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(steps):
                    res = fn(*args)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / steps
        else:
            _read_back(res)
            t0 = time.perf_counter()
            for _ in range(steps):
                res = fn(*args)
            _read_back(res)
            dt = (time.perf_counter() - t0) / steps
        if t1 is None:
            t1 = dt
        out.append({"n": n, "ms_per_step": dt * 1e3, "efficiency": t1 / dt})
    return out
