# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Byte models of the wire, the optimizer state and the reduce-scatter.

Counterpart of the analytic half of ``bluefog_tpu/scaling.py``: what one
round of a wire tier ships (:func:`wire_payload_bytes`, the single
accounting the chunk chooser prices from), a step's wire bytes, the
temporaries of the quantized wire, the optimizer state per worker
(measured from a state tree, or analytic), a plan's round and byte
summary, and the ring allreduce, one-peer gossip and ring reduce-scatter
costs. The JAX module's HLO-reading half (``hlo_collective_stats``,
``gossip_comm_stats``, ``weak_scaling_times``) waits for a transport whose
calls can be counted.
"""

from typing import Dict, Optional, Sequence

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
    congestion = (1.0,) * rounds
    n_elems = int(payload_bytes) // max(int(itemsize), 1)
    wire_bytes = wire_payload_bytes(n_elems, itemsize, wire)
    auto_chunks, chunked_cost = _compiler.chunk_option(wire_bytes, congestion, n_elems=n_elems)
    return {
        "rounds": rounds,
        "decomposition": info.method if info else "offset",
        "route": "direct",
        "link_class": "ici",
        "naive_rounds": naive_rounds,
        "lower_bound": info.lower_bound if info else rounds,
        "wire": wire or "exact",
        "wire_bytes_per_round": wire_bytes,
        "effective_compression_ratio": (
            round(payload_bytes / wire_bytes, 4) if wire_bytes else 1.0
        ),
        "max_congestion": max(congestion, default=1.0),
        "lineage_sidecar_bytes_per_round": LINEAGE_TAG_BYTES,
        "predicted_cost_us": plan_cost_s(rounds, wire_bytes) * 1e6,
        "naive_cost_us": plan_cost_s(naive_rounds, wire_bytes) * 1e6,
        "auto_chunks": auto_chunks,
        "chunked_cost_us": chunked_cost * 1e6,
    }


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
