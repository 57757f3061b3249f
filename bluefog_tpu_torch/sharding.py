# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Weight-update sharding (ZeRO-1/2): layout math and accounting.

A copy of ``bluefog_tpu/sharding.py`` (stdlib + numpy, no torch). Under
``BLUEFOG_SHARD=1`` each worker of the gradient-allreduce family keeps and
updates only its 1/N slot of the packed parameter vector, with 1/N of the
inner optimizer's state; the updated slots are gathered back to every
worker (arxiv 2004.13336). ``BLUEFOG_SHARD_GRADS=1`` also lowers the
gradient allreduce to a ring reduce-scatter that delivers each worker only
its own slot (ZeRO-2). The gossip families hold per-worker state that no
other worker repeats, so they warn once and run the replicated path bit
for bit.

Layout: each dtype group's flat length ``d`` is padded to ``n_live *
slot``, ``slot = ceil(d / n_live)`` rounded up to the 512-element
quantization grid, so a shard edge never splits a wire scale block; slot
lengths are unique across groups (a state leaf's trailing dimension names
its group). The ``i``-th live rank owns ``[i * slot, (i + 1) * slot)``.

The sharded update itself lives in :mod:`bluefog_tpu_torch.optimizers`;
the registry below is read by :func:`summary`, the ``shard`` block of the
health plane's ``/fleet`` report (:mod:`bluefog_tpu_torch.health`).
"""

import os
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ALIGN_ELEMS",
    "enabled",
    "master_enabled",
    "grads_enabled",
    "GroupShard",
    "ShardLayout",
    "build_layout",
    "gather_rows",
    "slice_rows",
    "ShardedOptState",
    "state_bytes",
    "gather_wire_bytes",
    "scatter_wire_bytes",
    "allreduce_wire_bytes",
    "grad_bytes",
    "register_active",
    "clear_active",
    "summary",
]

# Shard boundaries snap to the 512-element quantization grid
# (collective.inner._QUANT_CHUNK): a shard edge that split a scale
# block would make the quantized wires' per-block scales depend on the
# shard layout and break their bitwise pins.
ALIGN_ELEMS = 512


def enabled() -> bool:
    """``BLUEFOG_SHARD=1`` requests weight-update sharding (the family
    check is the optimizer's: non-replicated-state families warn once
    and run replicated)."""
    return os.environ.get("BLUEFOG_SHARD", "0") == "1"


def master_enabled() -> bool:
    """``BLUEFOG_SHARD_MASTER=1`` additionally keeps an fp32 master
    copy of each rank's OWNED parameter slice: the inner update runs in
    fp32 against the master and the redistributed slice is the master
    narrowed back to the parameter dtype (only meaningful for sub-fp32
    parameter dtypes; fp32 parameters gain nothing but pay the copy)."""
    return os.environ.get("BLUEFOG_SHARD_MASTER", "0") == "1"


def grads_enabled() -> bool:
    """``BLUEFOG_SHARD_GRADS=1`` (under ``BLUEFOG_SHARD=1``) lowers the
    gradient leg from full-width allreduce to reduce-scatter (ZeRO-2,
    the full weight-update-sharding formulation of arxiv 2004.13336):
    each rank receives only its owned 512-aligned slot of the reduced
    gradient, cutting peak gradient memory to ~1/N and the gradient
    wire to ~half of allreduce. Ignored without ``BLUEFOG_SHARD=1``."""
    return os.environ.get("BLUEFOG_SHARD_GRADS", "0") == "1"


class GroupShard(NamedTuple):
    """One dtype group's shard geometry."""

    dtype: str      # numpy dtype name of the packed group
    elems: int      # true flat length d of the packed group
    slot: int       # per-live-rank owned length (512-aligned)
    padded: int     # n_live * slot  (>= elems)


class ShardLayout(NamedTuple):
    """The full shard map of one optimizer's parameter tree."""

    groups: Tuple[GroupShard, ...]
    live: Tuple[int, ...]       # live ranks, ascending — owner order
    size: int                   # mesh size (rows of worker-stacked trees)
    master: bool
    token: Any                  # ctx.live_token() at build (None = all live)
    grads: bool = False         # ZeRO-2: gradient leg is reduce-scatter

    def sig(self) -> tuple:
        """Hashable key of everything that changes the sharded step or
        the state it runs on; the ZeRO-2 layout gains a trailing
        ``"grads"`` marker (the JAX package's cache-key shape)."""
        base = ("shard", self.live, self.master, tuple(self.groups))
        return base + (("grads",) if self.grads else ())

    def live_index(self) -> np.ndarray:
        """int32 ``[size]``: rank -> its owner index among the live set
        (dead ranks map to 0 — they compute an unused slot whose output
        the gather never selects)."""
        idx = np.zeros(self.size, np.int32)
        for i, r in enumerate(self.live):
            idx[r] = i
        return idx

    def owner_of(self, gi: int, elem: int) -> int:
        """The rank owning element ``elem`` of group ``gi``."""
        g = self.groups[gi]
        if not 0 <= elem < g.elems:
            raise IndexError(f"element {elem} outside group of {g.elems}")
        return self.live[elem // g.slot]

    def owner_map(self) -> list:
        """``[{group, dtype, rank, start, stop}]`` rows, one per live
        rank per group."""
        rows = []
        for gi, g in enumerate(self.groups):
            for i, r in enumerate(self.live):
                # clamp to the true element range: once the cumulative
                # start passes `elems` a rank owns pure padding, and its
                # row must read [elems, elems) + slot pad, never an
                # inverted interval
                start = min(i * g.slot, g.elems)
                stop = min((i + 1) * g.slot, g.elems)
                rows.append({
                    "group": gi,
                    "dtype": g.dtype,
                    "rank": int(r),
                    "start": start,
                    "stop": stop,
                    "padding": g.slot - (stop - start),
                })
        return rows


def _align_up(n: int, align: int = ALIGN_ELEMS) -> int:
    return -(-int(n) // align) * align


def build_layout(
    groups: Sequence[Tuple[str, int]],
    live: Sequence[int],
    size: int,
    master: bool = False,
    token: Any = None,
    grads: bool = False,
) -> ShardLayout:
    """Build the shard layout for ``groups`` = [(dtype_name, elems)] in
    packed-wire order over the ``live`` ranks of a ``size`` mesh."""
    live_list = [int(r) for r in live]
    live = tuple(sorted(live_list))
    if not live:
        raise ValueError("shard layout needs at least one live rank")
    if len(set(live)) != len(live):
        raise ValueError(
            f"duplicate live ranks in {sorted(live_list)}: each owner "
            "slot must belong to exactly one rank"
        )
    if live[0] < 0 or live[-1] >= size:
        raise ValueError(f"live ranks {live} outside mesh of {size}")
    n = len(live)
    shards = []
    used = set()
    for dt, d in groups:
        d = int(d)
        if d <= 0:
            raise ValueError(f"group {dt!r} has no elements")
        slot = _align_up(-(-d // n))
        # slot lengths are made UNIQUE across groups (bump by one grid
        # step on collision): a state leaf's trailing dimension then
        # identifies its group unambiguously, which is what lets the
        # re-shard and checkpoint transforms classify per-coordinate
        # state leaves structurally — inner transforms may cast state
        # to a different dtype (mu_dtype=...), so dtype cannot be the
        # discriminator. Costs at most one extra 512-block per group.
        while slot in used:
            slot += ALIGN_ELEMS
        used.add(slot)
        shards.append(GroupShard(str(dt), d, slot, slot * n))
    return ShardLayout(tuple(shards), live, int(size), bool(master), token,
                       bool(grads))


# -- host-side slice algebra (reshard / checkpoint gather) -------------------


def gather_rows(rows: np.ndarray, layout: ShardLayout, gi: int) -> np.ndarray:
    """Reconstruct a group's full flat vector ``[d]`` from its
    worker-stacked slot array ``[size, slot]`` (owner rows concatenated
    in owner order, padding trimmed)."""
    g = layout.groups[gi]
    rows = np.asarray(rows)
    if rows.shape != (layout.size, g.slot):
        raise ValueError(
            f"group {gi} slot array has shape {rows.shape}, layout "
            f"expects {(layout.size, g.slot)}"
        )
    return np.concatenate([rows[r] for r in layout.live])[:g.elems]


def slice_rows(full: np.ndarray, layout: ShardLayout, gi: int) -> np.ndarray:
    """Distribute a group's full flat vector ``[d]`` into the
    worker-stacked slot array ``[size, slot]`` (dead ranks zero)."""
    g = layout.groups[gi]
    full = np.asarray(full).reshape(-1)
    if full.size != g.elems:
        raise ValueError(
            f"group {gi} full vector has {full.size} elements, layout "
            f"expects {g.elems}"
        )
    padded = np.zeros(g.padded, full.dtype)
    padded[:g.elems] = full
    out = np.zeros((layout.size, g.slot), full.dtype)
    for i, r in enumerate(layout.live):
        out[r] = padded[i * g.slot:(i + 1) * g.slot]
    return out


class ShardedOptState(NamedTuple):
    """The optimizer-state pytree under ``BLUEFOG_SHARD=1``: the inner
    optax state evaluated on the per-rank owned slices (a tuple of flat
    slot vectors, one per dtype group) plus the optional fp32 master
    slices (empty tuple when ``BLUEFOG_SHARD_MASTER`` is off)."""

    inner: Any
    master: Tuple[Any, ...]


# -- accounting --------------------------------------------------------------

_DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}


def _itemsize(dtype: str) -> int:
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return _DTYPE_BYTES.get(str(dtype), 4)


def state_bytes(
    layout: ShardLayout,
    slots_per_param: int = 2,
    sharded: bool = True,
) -> int:
    """Analytic per-rank optimizer-state bytes: ``slots_per_param``
    per-coordinate state copies (Adam: mu + nu = 2) over the owned slot
    (sharded) or the full group (replicated), master slices included
    when the layout carries them. Scalar state (step counts) is ignored
    — it does not scale with the model. The *measured* counterpart
    (summing real state-tree leaves) is
    :func:`bluefog_tpu_torch.scaling.optimizer_state_bytes`."""
    total = 0
    for g in layout.groups:
        elems = g.slot if sharded else g.elems
        total += slots_per_param * elems * _itemsize(g.dtype)
        if sharded and layout.master:
            total += 4 * g.slot
    return total


def gather_wire_bytes(layout: ShardLayout, live_only: bool = False) -> int:
    """Per-rank redistribution cost of one sharded step: the all-gather
    ships every *other* rank's updated slot to this rank. Over the full
    mesh (what the gather of every worker's slot does) that is
    ``(size-1) * slot`` per group; ``live_only=True`` prices the ideal
    live-set-restricted exchange instead (the real-fleet lower bound)."""
    n = len(layout.live) if live_only else layout.size
    return sum((n - 1) * g.slot * _itemsize(g.dtype) for g in layout.groups)


def scatter_wire_bytes(layout: ShardLayout, live_only: bool = False) -> int:
    """Per-rank gradient wire of one ZeRO-2 step: the ring
    reduce-scatter ships one slot to every *other* rank — ``(size-1) *
    slot`` per group at the exact (fp32) tier, the mirror image of the
    redistribution all-gather. ``live_only=True`` prices the ideal
    live-set-restricted ring. Quantized scatter tiers price through
    ``scaling.wire_payload_bytes`` on the slot width (the accounting
    the optimizer layer records)."""
    n = len(layout.live) if live_only else layout.size
    return sum((n - 1) * g.slot * _itemsize(g.dtype) for g in layout.groups)


def allreduce_wire_bytes(layout: ShardLayout) -> int:
    """Per-rank gradient wire of the ZeRO-1 baseline the scatter
    replaces: a bandwidth-optimal ring allreduce on the full packed
    width ships ``2*(size-1)/size * elems`` per group
    (``scaling.ring_allreduce_cost``)."""
    n = layout.size
    return sum(
        int(2 * (n - 1) / max(n, 1) * g.elems * _itemsize(g.dtype))
        for g in layout.groups
    )


def grad_bytes(layout: ShardLayout, sharded: bool = True) -> int:
    """Peak per-rank reduced-gradient bytes: the owned slot under
    ZeRO-2 (``sharded=True``) vs the full packed group under the
    allreduce baseline. This is the ×1/N gradient-memory claim the
    memory observatory's census measures against (the backward pass's
    full-width gradient still exists upstream of the scatter; what
    shrinks is the *reduced* gradient the update consumes)."""
    return sum(
        (g.slot if sharded else g.elems) * _itemsize(g.dtype)
        for g in layout.groups
    )


# -- observability registry --------------------------------------------------

# The most recent active layout + counters, published by the optimizer
# layer (one optimizer at a time is the overwhelmingly common case; the
# last writer wins).
_ACTIVE: dict = {}


def register_active(layout: ShardLayout, slots_per_param: int = 2,
                    reshards: int = 0,
                    measured_state_bytes: Optional[int] = None) -> None:
    _ACTIVE.clear()
    _ACTIVE.update({
        "enabled": True,
        "n_live": len(layout.live),
        "mesh_size": layout.size,
        "master": layout.master,
        "groups": [
            {"dtype": g.dtype, "elems": g.elems, "slot": g.slot}
            for g in layout.groups
        ],
        "state_bytes_sharded": state_bytes(layout, slots_per_param, True),
        "state_bytes_replicated": state_bytes(layout, slots_per_param,
                                              False),
        "gather_bytes_per_step": gather_wire_bytes(layout),
        "grads": layout.grads,
        "scatter_bytes_per_step": (
            scatter_wire_bytes(layout) if layout.grads else 0
        ),
        "grad_bytes_sharded": grad_bytes(layout, True),
        "grad_bytes_replicated": grad_bytes(layout, False),
        "reshards": reshards,
    })
    if measured_state_bytes is not None:
        # the real per-rank footprint of the live state tree (scalar
        # state included), measured by scaling.optimizer_state_bytes —
        # next to the analytic model so a reader can see both
        _ACTIVE["state_bytes_measured"] = int(measured_state_bytes)


def clear_active() -> None:
    _ACTIVE.clear()


def summary() -> Optional[dict]:
    """The active shard block: layout, byte model, counters (None when
    no sharded optimizer is active)."""
    return dict(_ACTIVE) if _ACTIVE else None
