# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Virtual-rank placement and the fabric model of the plan compiler.

Counterpart of ``bluefog_tpu/topology/placement.py``. On a TPU slice the
fabric is a torus of links, and the serpentine (boustrophedon) walk of
:func:`serpentine_device_order` makes consecutive virtual ranks physical
neighbours; the compiler's relay family (``method="shortcut"``) and its
per-round congestion model route over that walk: the 1-D ring of virtual
ranks by default, dimension-ordered unit moves on the torus
``BLUEFOG_TORUS_DIMS`` declares. These are host-side model functions,
equal to the JAX package's, so the compiler's relay schedules are too.

The port's workers are the leading axis of one tensor on one card, so its
own transport has no fabric: a relay round is one more gather in device
memory. :func:`worker_device_order` keeps the JAX signature; CUDA devices
carry no coordinates and keep their order within a process. With several
processes (``multi_process=True``) it groups the devices by their
``process_index``, in ascending order, as the JAX context's
``order_devices_for_mesh`` does: process ``p`` holds a contiguous range
of worker rows. Placing cards by their NVLink or PCIe distance waits for
a machine with several cards (ROADMAP A item 4).
"""

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "serpentine_device_order",
    "worker_device_order",
    "declared_torus_dims",
    "serpentine_positions",
    "route_ranks",
    "hop_distance",
    "perm_congestion",
]


def serpentine_device_order(devices: Sequence) -> List:
    """Order TPU devices in a boustrophedon walk over their (x, y[, z]) coords.

    For a full rectangular 2-D or 3-D grid of coordinates, every pair of
    consecutive devices in the returned list differs by exactly one unit step
    on one axis: x snakes within each y-row (direction alternating with a
    global row counter), y snakes within each z-plane (direction alternating
    with plane parity, so a plane change keeps the same y-row), and z only
    ever advances by one. The closing ring edge (last -> first device) is a
    torus wrap link when the grid dimensions are even. This makes the virtual
    ring of :func:`bluefog_tpu_torch.topology.RingGraph` — and the +-1 offsets of
    every one-peer schedule — single-hop on ICI.

    Devices without coords (CUDA and CPU devices) are returned unchanged.
    """
    coords = []
    for d in devices:
        c = getattr(d, "coords", None)
        if c is None:
            return list(devices)
        coords.append(tuple(c))

    ndim = len(coords[0])
    # Group into z-planes of y-rows. Missing axes collapse to a single group.
    planes: dict = {}
    for c, d in zip(coords, devices):
        z = c[2:] if ndim > 2 else ()
        y = c[1] if ndim > 1 else 0
        planes.setdefault(z, {}).setdefault(y, []).append((c, d))

    ordered = []
    row_counter = 0
    for pi, z in enumerate(sorted(planes)):
        rows = planes[z]
        y_keys = sorted(rows)
        if pi % 2 == 1:
            y_keys = list(reversed(y_keys))  # re-enter the plane on the same row
        for y in y_keys:
            row = sorted(rows[y], key=lambda cd: cd[0][0])
            if row_counter % 2 == 1:
                row = list(reversed(row))  # continue from the x we ended on
            ordered.extend(d for _, d in row)
            row_counter += 1
    return ordered


def worker_device_order(devices: Optional[Sequence] = None,
                        multi_process: bool = False) -> List:
    """Device order of the worker mesh: :func:`serpentine_device_order` of
    ``devices``, by default every visible CUDA device (none visible
    raises). CUDA devices carry no coordinates, so they keep their order.
    With ``multi_process`` the devices are grouped by ``process_index``,
    ascending, each group walked on its own (the JAX
    ``order_devices_for_mesh``)."""
    if devices is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("worker_device_order: no CUDA device is visible; pass "
                               "devices= explicitly")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not multi_process:
        return serpentine_device_order(devices)
    by_proc: Dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    return [d for proc in sorted(by_proc) for d in serpentine_device_order(by_proc[proc])]


# -- virtual-fabric routing model (used by the comm-plan compiler) -----------
#
# The compiler's bandwidth families (shortcut routes, per-round link
# congestion) need to know which virtual-rank pairs are physically
# adjacent. Under the serpentine placement above, consecutive virtual
# ranks ARE physically adjacent, so the 1-D ring of virtual ranks is the
# always-available fabric model; a declared torus (`BLUEFOG_TORUS_DIMS`,
# matching the slice the serpentine walk was laid onto) refines it to
# dimension-ordered unit moves in the same coordinate space the walk
# produced. These are host-side model functions — nothing here touches
# devices.


def declared_torus_dims(size: int) -> Optional[Tuple[int, ...]]:
    """The declared physical fabric for ``size`` ranks, or None.

    ``BLUEFOG_TORUS_DIMS`` names the torus the serpentine order was laid
    onto, e.g. ``4,4`` / ``4x8`` / ``16`` (a single dim = the 1-D ring).
    Dims that do not multiply to ``size`` are rejected AT PARSE with a
    one-shot warning naming the knob (a topology half the slice, a CPU
    test mesh, a typo) — the congestion/route model then stays
    conservative (no fabric ⇒ every round is modeled congestion-free and
    shortcut routes fall back to the virtual ring). Silently carrying a
    mismatched fabric used to surface only deep inside route planning.
    """
    from bluefog_tpu_torch.logging_util import warn_once

    raw = os.environ.get("BLUEFOG_TORUS_DIMS", "").strip()
    if not raw:
        return None
    try:
        dims = tuple(
            int(d) for d in raw.replace("x", ",").split(",") if d.strip()
        )
    except ValueError:
        warn_once(
            "torus-dims-unparseable",
            "BLUEFOG_TORUS_DIMS=%r is not a dims list (e.g. '4,8' or "
            "'4x8'); treating the fabric as undeclared",
            raw,
        )
        return None
    if not dims or any(d <= 0 for d in dims):
        warn_once(
            "torus-dims-unparseable",
            "BLUEFOG_TORUS_DIMS=%r is not a dims list (e.g. '4,8' or "
            "'4x8'); treating the fabric as undeclared",
            raw,
        )
        return None
    n = 1
    for d in dims:
        n *= d
    if n != size:
        warn_once(
            f"torus-dims-mismatch-{size}",
            "BLUEFOG_TORUS_DIMS=%r multiplies to %d but the world has "
            "%d ranks; treating the fabric as undeclared (routes fall "
            "back to the virtual ring, congestion modeled 1)",
            raw, n, size,
        )
        return None
    return dims


def serpentine_positions(dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """``position -> coordinate`` for a full grid walked in the same
    boustrophedon order :func:`serpentine_device_order` uses, so virtual
    rank ``p`` (mesh position ``p``) sits at physical coordinate
    ``serpentine_positions(dims)[p]``."""

    class _D:
        def __init__(self, c):
            self.coords = c

    grid = np.indices(tuple(dims)).reshape(len(dims), -1).T
    devs = [_D(tuple(int(v) for v in c)) for c in grid]
    return [d.coords for d in serpentine_device_order(devs)]


_ROUTE_CACHE: Dict[Tuple, Tuple[Tuple[int, ...], ...]] = {}


def _pos_tables(dims: Tuple[int, ...]):
    key = ("tables", dims)
    hit = _ROUTE_CACHE.get(key)
    if hit is None:
        pos2coord = serpentine_positions(dims)
        coord2pos = {c: p for p, c in enumerate(pos2coord)}
        hit = (pos2coord, coord2pos)
        _ROUTE_CACHE[key] = hit
    return hit


def route_ranks(
    i: int, j: int, size: int, dims: Optional[Sequence[int]] = None
) -> Tuple[int, ...]:
    """Unit-hop relay chain ``(i, m1, ..., j)`` between virtual ranks.

    Every consecutive pair in the chain is physically adjacent: on the
    default virtual ring, hops are ±1 in serpentine order (single ICI
    hops by construction of the placement); on a declared torus, hops
    are dimension-ordered unit coordinate moves taking the shortest wrap
    direction per axis. Deterministic, memoized per (i, j, size, dims).
    """
    assert 0 <= i < size and 0 <= j < size and i != j
    dims_t = tuple(dims) if dims else None
    key = (i, j, size, dims_t)
    hit = _ROUTE_CACHE.get(key)
    if hit is not None:
        return hit
    if dims_t is None or len(dims_t) == 1:
        fwd = (j - i) % size
        step = 1 if fwd <= size - fwd else -1
        chain = [i]
        cur = i
        while cur != j:
            cur = (cur + step) % size
            chain.append(cur)
        route = tuple(chain)
    else:
        pos2coord, coord2pos = _pos_tables(dims_t)
        cur = list(pos2coord[i])
        dst = pos2coord[j]
        chain = [i]
        for ax, d in enumerate(dims_t):
            delta = (dst[ax] - cur[ax]) % d
            step = 1 if delta <= d - delta else -1
            while cur[ax] != dst[ax]:
                cur[ax] = (cur[ax] + step) % d
                chain.append(coord2pos[tuple(cur)])
        route = tuple(chain)
    _ROUTE_CACHE[key] = route
    return route


def hop_distance(
    i: int, j: int, size: int, dims: Optional[Sequence[int]] = None
) -> int:
    """Physical hop count of the modeled route between virtual ranks."""
    if i == j:
        return 0
    return len(route_ranks(i, j, size, dims)) - 1


def perm_congestion(
    perm: Sequence[Tuple[int, int]],
    size: int,
    dims: Optional[Sequence[int]] = None,
) -> int:
    """Max directed-link load of one ppermute round under the route model.

    Each pair routes over its unit-hop chain; a directed physical link
    shared by L routes serializes them, so the round's effective wire
    time is L x the single-transfer time — the congestion factor the
    compiler's alpha-beta model prices. Single-hop rounds (circulant ±1
    offsets under serpentine placement) are 1 by construction.
    """
    load: Dict[Tuple[int, int], int] = {}
    top = 1
    for s, d in perm:
        chain = route_ranks(s, d, size, dims)
        for a, b in zip(chain[:-1], chain[1:]):
            load[(a, b)] = load.get((a, b), 0) + 1
            top = max(top, load[(a, b)])
    return top
