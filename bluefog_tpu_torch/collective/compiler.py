# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Comm-plan compiler: pack a directed edge set into permutation rounds.

Counterpart of ``bluefog_tpu/collective/compiler.py`` (the offset grouping,
the König edge coloring and the ``auto`` choice between them). Each round
is a partial permutation: every rank sends at most once and receives at
most once, which is all the stacked combine (a gather along the worker
axis per round) relies on.

It also holds the alpha-beta cost model of the chunked wavefront (the
class constants, the calibration store, :func:`pipelined_cost_s`), the
chunk chooser (:func:`chunk_option`, :func:`choose_chunks`, with
``BLUEFOG_PLAN_CHUNKS``) and the reduce-scatter family
(:func:`compile_reduce_scatter`, :func:`reduce_scatter_chunks`), equal to
the JAX package's, and the short-cut relay family (:func:`shortcut_perms`,
``method="shortcut"``): every edge becomes a chain of unit hops on the
fabric model of :mod:`bluefog_tpu_torch.topology.placement` (the virtual
ring, or the torus ``BLUEFOG_TORUS_DIMS`` declares) scheduled over
consecutive rounds, with the JAX package's relay schedule, ``inject`` and
``delivery`` tables and host-side relay simulation (:func:`_check_relay`).
A round is priced at congestion 1 unless a torus is declared, then at its
route model's link load. The port's own transport, the stacked worker axis of one
process, is the link class ``"stacked"`` (:data:`TRANSPORT_LINK_CLASS`): a
round is a gather in device memory and the chunks of a wavefront run one
after another on one stream, so pipelining gains nothing and the chooser
picks one chunk unless ``BLUEFOG_PLAN_CHUNKS`` asks for more; a relay
forwards verbatim, so on that transport the value a worker receives in a
relay round is one origin's row (:func:`relay_sources`), one gather.
:func:`compile_edges` memoizes its structures under the JAX package's key
(the method and the declared dims in it) and counts
``bluefog.plan_cache.hits`` and ``.misses``.

The measured calibration (:func:`calibrate`) times the port's own round,
a gather of a stacked ``[8, elems]`` f32 tensor on the context's device
(CUDA events on the card, the calls queued behind a device sleep so that
the host's launches do not pace them; the host clock on the CPU): one
full-ring round
at a small and a large payload gives ``alpha_s`` and
``beta_bytes_per_s`` (one worker's bytes over the round, as in the JAX
package), two rounds monolithic against the 4-chunk wavefront give
``pipeline_eff``. It installs them under :data:`TRANSPORT_LINK_CLASS`;
``BLUEFOG_PLAN_CALIBRATE=1`` runs it before the chooser prices. The
attribution doctor prices its probes with the same class
(:func:`predicted_round_costs_s`, :func:`degraded_round_penalty_s`).
Across processes the round it times is the multi-process transport's route
(:func:`_route_round_times`), whose constants every process agrees on and
installs under the same class.
"""

import dataclasses
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bluefog_tpu_torch.topology import placement as _placement

__all__ = [
    "ROUND_ALPHA_S",
    "ICI_LINK_BYTES_PER_S",
    "DCN_ROUND_ALPHA_S",
    "DCN_LINK_BYTES_PER_S",
    "LINK_CLASSES",
    "TRANSPORT_LINK_CLASS",
    "DEFAULT_PAYLOAD_BYTES",
    "CompiledEdges",
    "compile_edges",
    "offset_perms",
    "coloring_perms",
    "shortcut_perms",
    "relay_sources",
    "min_rounds",
    "round_cost_s",
    "plan_cost_s",
    "degraded_round_penalty_s",
    "pipelined_cost_s",
    "predicted_round_costs_s",
    "chunk_option",
    "choose_chunks",
    "CompiledReduceScatter",
    "compile_reduce_scatter",
    "reduce_scatter_chunks",
    "calibrate",
    "calibration",
    "set_calibration",
    "clear_calibration",
    "clear_compile_cache",
    "plan_method",
]

# The alpha-beta constants of the JAX package's cost model (its ICI and
# DCN link classes): the defaults until a calibration is installed.
ROUND_ALPHA_S = 1.0e-6
ICI_LINK_BYTES_PER_S = 9.0e10
DCN_ROUND_ALPHA_S = 5.0e-5
DCN_LINK_BYTES_PER_S = 2.5e10

LINK_CLASSES = ("ici", "dcn", "stacked")

# The link class the port's optimizers price their chunks with: the stacked
# transport of one process. Across processes a round is a
# ``transport.Route``, which ``calibrate()`` times and installs under this
# same class.
TRANSPORT_LINK_CLASS = "stacked"

# ResNet50 f32 model payload: the default basis of a compiled structure's
# recorded predicted cost.
DEFAULT_PAYLOAD_BYTES = 25_557_032 * 4

# Chunk splits snap to the quantization block.
CHUNK_ALIGN_ELEMS = 512

# Search cap of the chunk chooser (powers of two up to this).
MAX_CHUNKS = 64

_CAL: Dict[str, Dict[str, float]] = {}

_CLASS_DEFAULTS: Dict[str, Dict[str, object]] = {
    "ici": {
        "alpha_s": ROUND_ALPHA_S,
        "beta_bytes_per_s": ICI_LINK_BYTES_PER_S,
        "pipeline_eff": 1.0,
        "source": "class-constants",
    },
    "dcn": {
        "alpha_s": DCN_ROUND_ALPHA_S,
        "beta_bytes_per_s": DCN_LINK_BYTES_PER_S,
        "pipeline_eff": 0.0,
        "source": "class-constants",
    },
    # no wire: a round is a gather in device memory, and chunks on one
    # stream cannot overlap, so only the extra launches are priced
    "stacked": {
        "alpha_s": ROUND_ALPHA_S,
        "beta_bytes_per_s": float("inf"),
        "pipeline_eff": 0.0,
        "source": "class-constants",
    },
}


def _check_link_class(link_class: str) -> str:
    if link_class not in LINK_CLASSES:
        raise ValueError(
            f"link_class must be one of {LINK_CLASSES}, got {link_class!r}"
        )
    return link_class


def calibration(link_class: str = "ici") -> Dict[str, object]:
    """The active constants of one link class: an installed calibration,
    else the class defaults (``pipeline_eff`` is the fraction of the ideal
    chunk-pipeline overlap the fabric delivers)."""
    cal = _CAL.get(_check_link_class(link_class))
    out = dict(cal) if cal is not None else dict(_CLASS_DEFAULTS[link_class])
    out["link_class"] = link_class
    return out


def set_calibration(alpha_s: float, beta_bytes_per_s: float, pipeline_eff: float = 1.0,
                    source: str = "manual", link_class: str = "ici") -> None:
    """Install the cost model's constants for one link class."""
    _CAL[_check_link_class(link_class)] = {
        "alpha_s": float(alpha_s),
        "beta_bytes_per_s": float(beta_bytes_per_s),
        "pipeline_eff": min(1.0, max(0.0, float(pipeline_eff))),
        "source": source,
    }


def clear_calibration(link_class: Optional[str] = None) -> None:
    """Drop the installed calibration of ``link_class``, or of every class."""
    if link_class is None:
        _CAL.clear()
    else:
        _CAL.pop(_check_link_class(link_class), None)


def plan_method() -> str:
    """The structure method of the plans of the active topology, the
    explicit-weight plans and the window exchanges:
    ``BLUEFOG_PLAN_METHOD`` (default ``auto``; ``offset``, ``coloring`` and
    ``shortcut`` force one pass and pin the chunk count to 1, as in the JAX
    package; the window exchanges take ``auto`` for ``shortcut``, see
    :func:`bluefog_tpu_torch.collective.plan.perms_from_edges`). Other
    values raise in :func:`compile_edges`."""
    return os.environ.get("BLUEFOG_PLAN_METHOD", "auto").strip() or "auto"


def _timed_round_s(body, x, device, steps: int, windows: int) -> float:
    """Seconds per call of ``body(x)``: ``windows`` timed windows of
    ``steps`` calls each after two warm-ups, the best window's mean. On the
    card CUDA events time the device: a window's calls are queued behind a
    device sleep, so the host's launches (which alone outlast a small
    round) do not starve it; the sleep grows until the queue outlasts the
    launches. Elsewhere the host clock."""
    for _ in range(2):
        body(x)
    best = None
    for _ in range(max(1, int(windows))):
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
            cycles = 1 << 24
            for _attempt in range(4):
                queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                queued.record()
                torch.cuda._sleep(cycles)
                start.record()
                t0 = time.perf_counter()
                for _ in range(steps):
                    body(x)
                launch_ms = (time.perf_counter() - t0) * 1e3
                end.record()
                end.synchronize()
                if launch_ms < queued.elapsed_time(start):
                    break
                cycles *= 4
            else:
                raise RuntimeError(
                    f"calibrate: {steps} calls took {launch_ms:.3f} ms to launch, longer than "
                    "the device sleep queued before them; the probe would time the host")
            dt = start.elapsed_time(end) / 1e3 / steps
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                body(x)
            dt = (time.perf_counter() - t0) / steps
        best = dt if best is None else min(best, dt)
    return best


def calibrate(force: bool = False, small_elems: int = 2048, large_elems: int = 1 << 21,
              steps: int = 4, windows: int = 2,
              link_class: str = TRANSPORT_LINK_CLASS) -> Dict[str, object]:
    """The measured probe of the cost model's constants, on the stacked
    transport: a round is ``inner._gather`` of an ``[8, elems]`` f32
    tensor (``RandomState(0)``) on the context's device, timed on the
    device (:func:`_timed_round_s`).

    - one full-ring round at ``small_elems`` gives ``alpha_s``;
    - the same at ``large_elems`` gives ``beta_bytes_per_s``, one worker's
      byte delta over the time delta (the JAX package's definition; the
      gather itself reads and writes all eight rows);
    - two rounds (forward and backward ring) at ``large_elems``,
      monolithic against the 4-chunk wavefront of
      ``inner._wavefront_gathers``, give ``pipeline_eff``, the measured
      share of the ideal pipelined gain ``8 / 5``.

    The result is installed under :data:`TRANSPORT_LINK_CLASS` with
    ``source="measured-probe"`` and priced from then on; an installed
    calibration is returned as it is unless ``force``. ``"ici"`` and
    ``"dcn"`` are fabrics the port does not have: their pin, else their
    class constants, come back unprobed. A probe that fails raises."""
    _check_link_class(link_class)
    from bluefog_tpu_torch import context as ctx_mod

    ctx = ctx_mod._context
    if ctx is not None and ctx.process_count > 1 and link_class == TRANSPORT_LINK_CLASS:
        from bluefog_tpu_torch.collective import transport

        # every process probes, or none: the probe is a collective
        transport.agree(_CAL.get(link_class) is not None and not force, "compiler.calibrate")
    if _CAL.get(link_class) is not None and not force:
        return calibration(link_class)
    if link_class != TRANSPORT_LINK_CLASS:
        return calibration(link_class)
    if ctx is not None and ctx.process_count > 1:
        times, probe = _route_round_times(ctx, small_elems, large_elems, steps, windows)
    else:
        times, probe = _stacked_round_times(small_elems, large_elems, steps, windows)
    t_small, t_large, t_mono, t_chunk = times
    alpha = max(t_small, 1e-9)
    beta = (large_elems - small_elems) * 4 / max(t_large - t_small, 1e-9)
    ideal_gain = (2 * 4) / (2 + 4 - 1)
    gain = t_mono / max(t_chunk, 1e-9)
    pipeline_eff = min(1.0, max(0.0, (gain - 1.0) / (ideal_gain - 1.0)))
    _CAL[link_class] = {
        "alpha_s": float(alpha),
        "beta_bytes_per_s": float(beta),
        "pipeline_eff": float(pipeline_eff),
        "source": "measured-probe",
        **probe,
        "probe_gain_2round_4chunk": float(gain),
    }
    return calibration(link_class)


def _stacked_round_times(small_elems: int, large_elems: int, steps: int, windows: int):
    """:func:`calibrate`'s four times on the stacked transport (a gather of
    an ``[8, elems]`` tensor, :func:`_timed_round_s`): one ring round small
    and large, two rounds monolithic and in the 4-chunk wavefront; and the
    probe's description."""
    import numpy as np
    import torch

    from bluefog_tpu_torch import context as ctx_mod
    from bluefog_tpu_torch.collective import inner

    device = ctx_mod.get_context().device
    n = 8
    fwd = torch.tensor([(j - 1) % n for j in range(n)], dtype=torch.int32, device=device)
    bwd = torch.tensor([(j + 1) % n for j in range(n)], dtype=torch.int32, device=device)
    src2 = torch.stack([fwd, bwd])

    def payload(elems):
        return torch.from_numpy(
            np.random.RandomState(0).randn(n, elems).astype(np.float32)).to(device)

    def one_round(t):
        return inner._gather(t, fwd)

    def two_round(t):
        return inner._gather(t, fwd) + inner._gather(t, bwd)

    def two_round_chunked(t):
        parts = [t[:, a:b] for a, b in inner.chunk_bounds(t.shape[1], 4)]
        recv = inner._chunked_rounds(parts, src2)
        return recv[0] + recv[1]

    x_small, x_large = payload(small_elems), payload(large_elems)
    times = tuple(_timed_round_s(body, x, device, steps, windows)
                  for body, x in ((one_round, x_small), (one_round, x_large),
                                  (two_round, x_large), (two_round_chunked, x_large)))
    return times, {"probe_devices": n, "probe_device": str(device)}


def _route_round_times(ctx, small_elems: int, large_elems: int, steps: int, windows: int):
    """:func:`calibrate`'s four times across processes: the round is the
    multi-process transport's
    :class:`~bluefog_tpu_torch.collective.transport.Route` of a full ring
    over every worker (each process's rows of the ``RandomState(0)``
    ``[size, elems]`` payload, exchanged, then the gather). Each call waits
    for its messages, so it is timed on the host clock around a device
    synchronize, ``windows`` windows of ``steps`` calls after two warm-ups,
    the best window's mean; each time is the slowest process's
    (:func:`~bluefog_tpu_torch.collective.transport.fleet_max`), so every
    process installs the same constants. The chunked form exchanges four
    512-aligned column chunks one after another."""
    import numpy as np
    import torch

    from bluefog_tpu_torch.collective import inner, transport

    n, lo, hi = ctx.size, ctx.rows.start, ctx.rows.stop
    fwd = [(j - 1) % n for j in range(n)]
    bwd = [(j + 1) % n for j in range(n)]
    one = transport.route(np.array([fwd]), n, ctx)
    two = transport.route(np.array([fwd, bwd]), n, ctx)

    def payload(elems):
        full = np.random.RandomState(0).randn(n, elems).astype(np.float32)
        return torch.from_numpy(full[lo:hi]).to(ctx.device)

    def one_round(t):
        return inner._gather(one.exchange([t])[0], one[0])

    def two_round(t):
        ext = two.exchange([t])[0]
        return inner._gather(ext, two[0]) + inner._gather(ext, two[1])

    def two_round_chunked(t):
        parts = []
        for a, b in inner.chunk_bounds(t.shape[1], 4):
            ext = two.exchange([t[:, a:b].contiguous()])[0]
            parts.append(inner._gather(ext, two[0]) + inner._gather(ext, two[1]))
        return torch.cat(parts, dim=1)

    def timed(body, x):
        for _ in range(2):
            body(x)
        best = None
        for _ in range(max(1, int(windows))):
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            t0 = time.perf_counter()
            for _ in range(steps):
                body(x)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            dt = (time.perf_counter() - t0) / steps
            best = dt if best is None else min(best, dt)
        return best

    x_small, x_large = payload(small_elems), payload(large_elems)
    times = transport.fleet_max([timed(one_round, x_small), timed(one_round, x_large),
                                 timed(two_round, x_large), timed(two_round_chunked, x_large)],
                                ctx)
    return tuple(times), {"probe_devices": n, "probe_device": str(ctx.device),
                          "probe_processes": ctx.process_count, "probe_backend": ctx.backend,
                          "probe_staged": bool(ctx.staged)}


def _maybe_autocalibrate(link_class: str = TRANSPORT_LINK_CLASS) -> None:
    """``BLUEFOG_PLAN_CALIBRATE=1``: run :func:`calibrate` for the class the
    chooser prices with (once; an installed calibration is kept)."""
    if os.environ.get("BLUEFOG_PLAN_CALIBRATE", "0") in ("1", "true", "on"):
        calibrate(link_class=link_class)


def round_cost_s(payload_bytes: float, congestion: float = 1.0,
                 link_class: str = "ici") -> float:
    """One round: fixed latency plus the payload over the link."""
    cal = calibration(link_class)
    return cal["alpha_s"] + congestion * payload_bytes / cal["beta_bytes_per_s"]


def plan_cost_s(n_rounds: int, payload_bytes: float, link_class: str = "ici") -> float:
    """Rounds are sequential: rounds x the cost of one."""
    return n_rounds * round_cost_s(payload_bytes, link_class=link_class)


def degraded_round_penalty_s(payload_bytes: float, factor: float, congestion: float = 1.0,
                             link_class: str = "ici") -> float:
    """Extra seconds a round pays when a crossing link runs at ``factor``
    of its bandwidth: the round's modeled cost times ``1 / factor - 1``
    (0 outside ``(0, 1)``); the chaos layer's delay of the doctor's
    probes."""
    if not 0.0 < factor < 1.0:
        return 0.0
    return (1.0 / factor - 1.0) * round_cost_s(payload_bytes, congestion, link_class)


def predicted_round_costs_s(info, payload_bytes: float, n_rounds: Optional[int] = None,
                            link_class: str = "ici") -> Tuple[float, ...]:
    """Per-round predicted cost at ``payload_bytes`` under the active
    calibration, the model the doctor holds its probes to: every round of
    ``info`` (a :class:`CompiledEdges`) at its congestion, or ``n_rounds``
    rounds at congestion 1 when ``info`` is None or has none."""
    if info is not None and info.congestion:
        return tuple(round_cost_s(payload_bytes, c, link_class) for c in info.congestion)
    n = n_rounds if n_rounds is not None else (info.rounds if info is not None else 0)
    return tuple(round_cost_s(payload_bytes, 1.0, link_class) for _ in range(n))


def pipelined_cost_s(payload_bytes: float, n_chunks: int, congestions: Sequence[float],
                     link_class: str = "ici") -> float:
    """Cost of a chunked wavefront over rounds with the given congestion
    factors: the serial plan for one chunk; for ``k > 1`` the ideal
    pipeline of ``R + k - 1`` waves of ``B / k`` bytes, weighed by
    ``pipeline_eff`` against the serial plan plus its ``R (k - 1)`` extra
    launches."""
    cal = calibration(link_class)
    alpha, beta, gamma = cal["alpha_s"], cal["beta_bytes_per_s"], cal["pipeline_eff"]
    k = max(1, int(n_chunks))
    serial = sum(alpha + c * payload_bytes / beta for c in congestions)
    if k == 1:
        return serial
    serial_k = serial + len(congestions) * (k - 1) * alpha
    b = payload_bytes / k
    bottleneck = alpha + max(congestions, default=1.0) * b / beta
    ideal = sum(alpha + c * b / beta for c in congestions) + (k - 1) * bottleneck
    return gamma * ideal + (1.0 - gamma) * serial_k

Perms = Tuple[Tuple[Tuple[int, int], ...], ...]


@dataclasses.dataclass(frozen=True)
class CompiledEdges:
    """The chosen round structure and how it was chosen.

    ``inject[r]`` lists the ranks that send their own payload in round
    ``r`` (every other sender forwards what it received in round ``r - 1``),
    and ``delivery`` maps each edge to the round whose receive completes it,
    where the receiver's weight for that edge applies. A direct
    decomposition (offset, coloring; ``route="direct"``) is the case in
    which every sender injects and every perm pair is an edge delivered in
    its own round (:func:`_direct_tables`; the JAX package leaves both None
    there). ``congestion`` is each round's link load under the route model
    (1 without a declared torus). ``link_class`` names the calibrated
    alpha-beta class the plan is priced under (``"dcn"`` for a federation's
    gateway leg)."""

    perms: Perms
    method: str  # "offset" | "coloring" | "shortcut"
    rounds: int
    offset_rounds: int  # the naive (offset-grouped) round count
    lower_bound: int  # König bound: max(max_in_degree, max_out_degree)
    route: str  # "direct" | "shortcut"
    inject: Tuple[Tuple[int, ...], ...]
    delivery: Tuple[Tuple[Tuple[int, int], int], ...]
    congestion: Tuple[float, ...]
    link_class: str = "ici"


def _canonical(edges: Iterable[Tuple[int, int]], size: int) -> Tuple[Tuple[int, int], ...]:
    """Dedupe, drop self loops, validate range, sort."""
    out = set()
    for i, j in edges:
        i, j = int(i), int(j)
        if i == j:
            continue
        if not (0 <= i < size and 0 <= j < size):
            raise ValueError(f"edge ({i}, {j}) out of range for size {size}")
        out.add((i, j))
    return tuple(sorted(out))


def offset_perms(edges: Iterable[Tuple[int, int]], size: int) -> Perms:
    """Group edges by ring offset ``(dst - src) % size``; circulant
    topologies yield one full permutation per offset."""
    by_offset: Dict[int, List[Tuple[int, int]]] = {}
    for i, j in _canonical(edges, size):
        by_offset.setdefault((j - i) % size, []).append((i, j))
    return tuple(tuple(sorted(by_offset[o])) for o in sorted(by_offset))


def min_rounds(edges: Iterable[Tuple[int, int]], size: int) -> int:
    """König lower bound: the busiest sender or receiver."""
    out_deg = [0] * size
    in_deg = [0] * size
    for i, j in _canonical(edges, size):
        out_deg[i] += 1
        in_deg[j] += 1
    return max(max(out_deg, default=0), max(in_deg, default=0))


def coloring_perms(edges: Iterable[Tuple[int, int]], size: int) -> Perms:
    """Minimum-round packing: bipartite edge coloring by Kempe chains,
    with exactly :func:`min_rounds` colors (same algorithm and edge order
    as the JAX compiler, so the rounds come out identical)."""
    edge_list = _canonical(edges, size)
    src_color: List[Dict[int, int]] = [dict() for _ in range(size)]
    dst_color: List[Dict[int, int]] = [dict() for _ in range(size)]

    def first_free(used: Dict[int, int]) -> int:
        c = 0
        while c in used:
            c += 1
        return c

    for u, v in edge_list:
        a = first_free(src_color[u])
        b = first_free(dst_color[v])
        if a != b:
            # flip the maximal a/b alternating chain starting at v
            chain: List[Tuple[int, int, int]] = []
            cur, want, at_dst = v, a, True
            while True:
                if at_dst:
                    s = dst_color[cur].get(want)
                    if s is None:
                        break
                    chain.append((s, cur, want))
                    cur, at_dst = s, False
                else:
                    d = src_color[cur].get(want)
                    if d is None:
                        break
                    chain.append((cur, d, want))
                    cur, at_dst = d, True
                want = b if want == a else a
            for s, d, c in chain:
                del src_color[s][c]
                del dst_color[d][c]
            for s, d, c in chain:
                nc = b if c == a else a
                src_color[s][nc] = d
                dst_color[d][nc] = s
        src_color[u][a] = v
        dst_color[v][a] = u

    n_colors = 1 + max((c for cols in src_color for c in cols), default=-1)
    rounds: List[List[Tuple[int, int]]] = [[] for _ in range(n_colors)]
    for s, cols in enumerate(src_color):
        for c, d in cols.items():
            rounds[c].append((s, d))
    perms = tuple(tuple(sorted(r)) for r in rounds if r)
    _check_rounds(perms, edge_list)
    return perms


def shortcut_perms(
    edges: Iterable[Tuple[int, int]], size: int, dims: Optional[Sequence[int]] = None,
) -> Tuple[Perms, Tuple[Tuple[int, ...], ...], Tuple[Tuple[Tuple[int, int], int], ...]]:
    """Short-cut (relay) pass: every edge becomes its unit-hop route
    (:func:`bluefog_tpu_torch.topology.placement.route_ranks`: the
    serpentine ring by default, dimension-ordered torus moves under a
    declared ``BLUEFOG_TORUS_DIMS``), and the hops are scheduled over
    consecutive rounds, so every round's transfers are single hops. The
    value moves verbatim (no arithmetic at relays), and the delivering
    round's receiver weight applies exactly as the direct lowering's.

    Scheduling is greedy earliest-start over the chains sorted longest
    first (deterministic, the JAX package's order): a chain occupies
    consecutive rounds (a relay forwards what it received in the previous
    round), each rank sends at most one value a round and receives at most
    one. Returns ``(perms, inject, delivery)``, validated by the relay
    simulation :func:`_check_relay`."""
    edge_list = _canonical(edges, size)
    chains = []
    for u, v in edge_list:
        ranks = _placement.route_ranks(u, v, size, dims)
        chains.append(((u, v), tuple(zip(ranks[:-1], ranks[1:]))))
    chains.sort(key=lambda c: (-len(c[1]), c[0]))

    rounds: List[List[Tuple[int, int]]] = []
    send_used: List[set] = []
    recv_used: List[set] = []
    inject: List[set] = []
    delivery: List[Tuple[Tuple[int, int], int]] = []

    def fits(start: int, hops) -> bool:
        for t, (a, b) in enumerate(hops):
            r = start + t
            if r < len(rounds) and (a in send_used[r] or b in recv_used[r]):
                return False
        return True

    for (u, v), hops in chains:
        start = 0
        while not fits(start, hops):
            start += 1
        for t, (a, b) in enumerate(hops):
            r = start + t
            while r >= len(rounds):
                rounds.append([])
                send_used.append(set())
                recv_used.append(set())
                inject.append(set())
            rounds[r].append((a, b))
            send_used[r].add(a)
            recv_used[r].add(b)
            if t == 0:
                inject[r].add(a)
        delivery.append(((u, v), start + len(hops) - 1))

    perms = tuple(tuple(sorted(r)) for r in rounds)
    inject_t = tuple(tuple(sorted(i)) for i in inject)
    delivery_t = tuple(sorted(delivery))
    _check_relay(perms, inject_t, delivery_t, edge_list, size)
    return perms, inject_t, delivery_t


def _relay_origins(perms: Perms, inject) -> List[Dict[int, Optional[int]]]:
    """The transit recursion of a relay schedule, replayed on the host:
    for each round, ``{receiver: origin}``, the rank whose own payload the
    receiver gets (None: a forward of nothing, which delivers zeros)."""
    out: List[Dict[int, Optional[int]]] = []
    transit: Dict[int, Optional[int]] = {}  # rank -> origin rank it carries
    for r, perm in enumerate(perms):
        arriving: Dict[int, Optional[int]] = {}
        inj = set(inject[r])
        for a, b in perm:
            arriving[b] = a if a in inj else transit.get(a)
        out.append(arriving)
        transit = arriving
    return out


def _check_relay(
    perms: Perms,
    inject: Tuple[Tuple[int, ...], ...],
    delivery: Tuple[Tuple[Tuple[int, int], int], ...],
    edge_list: Sequence[Tuple[int, int]],
    size: int,
) -> None:
    """Invariant pass of a relay schedule: every round is a partial
    permutation, and the host-side simulation of the transit recursion
    hands every declared delivery's receiver the original source's value."""
    for perm in perms:
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise AssertionError(f"relay round is not a partial permutation: {perm}")
    by_round = {r: {b: o for b, o in arriving.items() if o is not None}
                for r, arriving in enumerate(_relay_origins(perms, inject))}
    seen = []
    for (u, v), r in delivery:
        if by_round.get(r, {}).get(v) != u:
            raise AssertionError(f"relay schedule does not deliver {u}->{v} at round {r}")
        seen.append((u, v))
    if sorted(seen) != list(edge_list):
        raise AssertionError("relay deliveries do not cover the edge set exactly")


def _direct_tables(perms: Perms):
    """``(inject, delivery)`` of a direct schedule: every sender injects
    its own payload, and every perm pair is an edge delivered in its own
    round."""
    inject = tuple(tuple(sorted(s for s, _ in perm)) for perm in perms)
    delivery = tuple(sorted(((s, d), r) for r, perm in enumerate(perms) for s, d in perm))
    return inject, delivery


def relay_sources(perms: Perms, inject, size: int):
    """``[rounds, size]`` int32: the origin rank whose payload each rank
    receives in each round of a schedule, -1 where it receives nothing (or
    a forward of nothing); on a direct schedule, each round's sender. A
    relay forwards verbatim, so on the
    stacked transport round ``r`` of a relay plan is one gather from these
    rows: the JAX relay's transit bits, including the rounds a receiver
    only passes on (weight 0). An origin may feed two receivers in one
    round, so a row need not be a permutation."""
    import numpy as np

    src = np.full((len(perms), size), -1, np.int32)
    for r, arriving in enumerate(_relay_origins(perms, inject)):
        for b, o in arriving.items():
            if o is not None:
                src[r, b] = o
    return src


def _check_rounds(perms: Perms, edge_list) -> None:
    """Every round is a partial permutation and the rounds partition the
    edge set exactly."""
    seen = []
    for perm in perms:
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise AssertionError(f"round is not a partial permutation: {perm}")
        seen.extend(perm)
    if sorted(seen) != list(edge_list):
        raise AssertionError("compiled rounds do not partition the edge set")


_COMPILE_CACHE: Dict[Tuple, CompiledEdges] = {}
_COMPILE_CACHE_MAX = 1024


def compile_edges(
    edges: Iterable[Tuple[int, int]], size: int, method: str = "auto",
    link_class: str = "ici",
) -> CompiledEdges:
    """Compile a directed edge set into permutation rounds.

    ``auto`` takes the coloring only when it strictly reduces the round
    count and keeps the offset grouping on ties (the JAX compiler's rule,
    whose cost model is monotone in the round count; it never chooses
    ``shortcut``); ``offset`` and ``coloring`` force one pass;
    ``shortcut`` is the relay family (:func:`shortcut_perms`, which sets
    ``route``, ``inject`` and ``delivery``). Memoized under the JAX
    package's key ``(canonical edges, size, method, payload, torus dims)``,
    where the payload is the constant ``DEFAULT_PAYLOAD_BYTES`` (no port
    caller prices a plan by payload) and the dims are
    :func:`~bluefog_tpu_torch.topology.placement.declared_torus_dims`, so
    a change of either compiles its own entry; counts
    ``bluefog.plan_cache.hits`` and ``.misses``. ``link_class`` (one of
    :data:`LINK_CLASSES`) is recorded on the result; the default ``"ici"``
    keeps that key shape exactly, any other class appends itself to the
    key and so compiles its own entry, as in the JAX package."""
    if method not in ("auto", "offset", "coloring", "shortcut"):
        raise ValueError(
            "method must be 'auto', 'offset', 'coloring' or 'shortcut', "
            f"got {method!r}"
        )
    from bluefog_tpu_torch import metrics

    _check_link_class(link_class)
    canon = _canonical(edges, size)
    dims = _placement.declared_torus_dims(size)
    key = (canon, size, method, DEFAULT_PAYLOAD_BYTES, dims)
    if link_class != "ici":
        key += (link_class,)
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        metrics.counter("bluefog.plan_cache.hits").inc()
        return hit
    metrics.counter("bluefog.plan_cache.misses").inc()
    naive = offset_perms(canon, size)
    bound = min_rounds(canon, size)
    route = "direct"
    if method == "offset":
        perms, chosen = naive, "offset"
    elif method == "shortcut":
        perms, inject, delivery = shortcut_perms(canon, size, dims)
        chosen, route = "shortcut", "shortcut"
    else:
        colored = naive if len(naive) <= bound else coloring_perms(canon, size)
        if method == "coloring" or len(colored) < len(naive):
            perms, chosen = colored, "coloring"
        else:
            perms, chosen = naive, "offset"
    if route == "direct":
        inject, delivery = _direct_tables(perms)
    result = CompiledEdges(
        perms=perms,
        method=chosen,
        rounds=len(perms),
        offset_rounds=len(naive),
        lower_bound=bound,
        route=route,
        inject=inject,
        delivery=delivery,
        congestion=_round_congestions(perms, size, route),
        link_class=link_class,
    )
    if len(_COMPILE_CACHE) >= _COMPILE_CACHE_MAX:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
    _COMPILE_CACHE[key] = result
    return result


def _round_congestions(perms: Perms, size: int, route: str = "direct") -> Tuple[float, ...]:
    """Per-round max-link-load factors of the cost model. Unit-hop relay
    rounds are 1 by construction; direct rounds are priced by the route
    model only when a torus is declared (``BLUEFOG_TORUS_DIMS``), 1
    otherwise."""
    if route == "shortcut":
        return (1.0,) * len(perms)
    dims = _placement.declared_torus_dims(size)
    if dims is None:
        return (1.0,) * len(perms)
    return tuple(float(_placement.perm_congestion(p, size, dims)) for p in perms)


def chunk_option(payload_bytes: float, congestions: Sequence[float],
                 n_elems: Optional[int] = None, link_class: str = "ici") -> Tuple[int, float]:
    """The best chunk count for one round structure and its predicted
    cost: the argmin of :func:`pipelined_cost_s` over powers of two, capped
    so that every chunk keeps a whole 512-element block."""
    if not congestions:
        return 1, 0.0
    kmax = MAX_CHUNKS
    if n_elems is not None:
        kmax = min(kmax, max(1, int(n_elems) // CHUNK_ALIGN_ELEMS))
    best_k, best_c = 1, pipelined_cost_s(payload_bytes, 1, congestions, link_class=link_class)
    k = 2
    while k <= kmax:
        c = pipelined_cost_s(payload_bytes, k, congestions, link_class=link_class)
        if c < best_c:
            best_k, best_c = k, c
        k *= 2
    return best_k, best_c


def _env_chunks(n_elems: Optional[int]) -> Optional[int]:
    """The ``BLUEFOG_PLAN_CHUNKS`` override (capped at one block a chunk),
    or None when unset."""
    env = os.environ.get("BLUEFOG_PLAN_CHUNKS", "").strip()
    if not env:
        return None
    try:
        k = int(env)
    except ValueError:
        raise ValueError(f"BLUEFOG_PLAN_CHUNKS must be a positive int, got {env!r}")
    if k < 1:
        raise ValueError(f"BLUEFOG_PLAN_CHUNKS must be a positive int, got {env!r}")
    if n_elems is not None:
        k = min(k, max(1, int(n_elems) // CHUNK_ALIGN_ELEMS))
    return k


def choose_chunks(compiled, payload_bytes: float, n_elems: Optional[int] = None,
                  method: str = "auto", link_class: str = "ici") -> int:
    """The chunk count of one dispatch: ``BLUEFOG_PLAN_CHUNKS`` when set;
    1 under a forced structure method; else :func:`chunk_option` over the
    compiled structure's rounds at their congestion (a
    :class:`CompiledEdges`) or over a round count."""
    k = _env_chunks(n_elems)
    if k is not None:
        return k
    if method not in (None, "auto"):
        return 1
    _maybe_autocalibrate(link_class)
    if isinstance(compiled, CompiledEdges):
        congestions = compiled.congestion or (1.0,) * compiled.rounds
    else:
        congestions = (1.0,) * int(compiled)
    k, _cost = chunk_option(payload_bytes, congestions, n_elems, link_class=link_class)
    return k


@dataclasses.dataclass(frozen=True)
class CompiledReduceScatter:
    """The round structure of a ring reduce-scatter over ``size`` workers:
    ``size - 1`` circulant rounds, round ``t`` a full permutation ``r ->
    r + t`` in which every sender ships one slot."""

    perms: Perms
    size: int
    rounds: int
    congestion: Tuple[float, ...]
    predicted_cost_s: float


_RS_CACHE: Dict[int, CompiledReduceScatter] = {}


def compile_reduce_scatter(size: int,
                           payload_bytes: Optional[float] = None) -> CompiledReduceScatter:
    """The circulant reduce-scatter structure of ``size`` workers (memoized
    per size; the predicted cost is priced at the first call's payload)."""
    size = int(size)
    if size < 1:
        raise ValueError(f"reduce-scatter needs a positive mesh, got {size}")
    info = _RS_CACHE.get(size)
    if info is None:
        perms = tuple(
            tuple((r, (r + t) % size) for r in range(size))
            for t in range(1, size)
        )
        congestion = _round_congestions(perms, size, "direct")
        payload = DEFAULT_PAYLOAD_BYTES if payload_bytes is None else float(payload_bytes)
        info = CompiledReduceScatter(
            perms=perms, size=size, rounds=size - 1, congestion=congestion,
            predicted_cost_s=pipelined_cost_s(payload, 1, congestion),
        )
        _RS_CACHE[size] = info
    return info


def reduce_scatter_chunks(size: int, payload_bytes: float,
                          n_elems: Optional[int] = None, link_class: str = "ici") -> int:
    """The chunk count of a reduce-scatter whose rounds each ship
    ``payload_bytes`` (one slot of ``n_elems`` elements)."""
    info = compile_reduce_scatter(size, payload_bytes)
    k = _env_chunks(n_elems)
    if k is not None:
        return k
    _maybe_autocalibrate(link_class)
    k, _cost = chunk_option(payload_bytes, info.congestion or (1.0,) * info.rounds, n_elems,
                            link_class=link_class)
    return k


def clear_compile_cache() -> None:
    """Drop the memoized edge and reduce-scatter structures."""
    _COMPILE_CACHE.clear()
    _RS_CACHE.clear()
