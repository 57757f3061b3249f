# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Fleet health plane (``bft.health``): the mixing observatory, the
in-band push-sum fleet lane and the ``/healthz`` endpoint.

Counterpart of ``bluefog_tpu/health.py``, with its names, knobs, series
and JSON. Three parts:

**(a) Mixing observatory.** The predicted per-step consensus decay of the
active combine (the SLEM of a static plan's weight matrix, the period
product's rate of a dynamic schedule, the repaired matrix after an
elastic membership change), from the spectral engine of
:mod:`bluefog_tpu_torch.topology.spectral`, cached per ``(topo_version,
live_token, source)``, against the decay fitted over the sampled
consensus-distance series (the metrics probe's
``bluefog.gossip.disagreement`` gauge, or a series fed directly): the
mixing efficiency ``ln(measured) / ln(predicted)``, the time-to-ε
projection, and the ``mixing_degraded`` advisory when the efficiency
falls below its own EWMA + MAD baseline for two samples, naming the
suspects of :func:`bluefog_tpu_torch.attribution.suspect_join` (the
chaos layer's degrade faults and the doctor's ``degraded_link`` edges)
on the doctor's counters, the flight side table, the timeline and
``BLUEFOG_HEALTH_FILE``. With the staleness observatory on, the
prediction is also discounted for the measured age
(:func:`bluefog_tpu_torch.staleness.age_adjusted_rate`).

**(b) In-band aggregation.** Each worker's summary (:data:`FLEET_FIELDS`)
is aggregated fleet-wide min / mean / max by a push-sum lane over the
gossip fabric itself: sum and weight lanes under the sender-mass-conserving
push matrix of the active combine (:func:`push_matrix`), min/max lanes by
masked neighbour gossip. On the port the lane is a plain PyTorch function
over the stacked worker axis (the plan's gathers on ``[N, 3K + 1]`` f32),
cached in the context's op cache under its own ``health_pushsum`` key, so
no training key changes; a sampled step dispatches one application whose
result is copied to pinned host memory behind an event and read at the
next sample, so the step never waits on the card for it.

**Across processes** every process holds the lane's host state of every
row; a sample ships its rows to the device, runs the applications over
the push plan's route (the sum lanes through
:func:`~bluefog_tpu_torch.collective.inner.weighted_combine_operands`, the
min/max lanes' senders in one exchange an application) and gathers every
row back, so the estimates, ``mixing_degraded`` and the ``/healthz``
verdict's fleet fields are the stacked run's, bitwise, in every process;
the read one sample later and the min/max re-seed happen at the same
sample in every process. The step time is the slowest process's (one
``all_gather_object`` a sample, with each process's memory fields, which
fill its own rows). Two processes on one host that both ask for
``BLUEFOG_HEALTH_PORT``: the second warns and serves nothing.

**(c) Serving.** ``BLUEFOG_HEALTH_PORT`` starts a stdlib HTTP endpoint
(:class:`HealthServer`): ``/healthz`` (the RAG verdict of
:func:`healthz_verdict`: 200 on ok/warn, 503 on critical), ``/metrics``
(the Prometheus lines of :func:`bluefog_tpu_torch.metrics.prom_lines`),
``/fleet`` (:meth:`HealthPlane.report`, with the federated fabric and the
SLO engine's summary when they are on), ``/slo`` (the SLO engine's report,
:meth:`bluefog_tpu_torch.slo.SLOEngine.report`). ``/healthz`` goes critical
while an SLO budget is spent. The handler threads read host-side
snapshots only, never a CUDA tensor. A port in use logs a warning and
serves nothing. ``tools/fleet_report.py`` renders a dump.

Knobs: ``BLUEFOG_HEALTH=1`` (the observatory, default off),
``BLUEFOG_HEALTH_INTERVAL`` (communicating steps between samples, default
20), ``BLUEFOG_HEALTH_PORT`` (serve; 0 or unset: off),
``BLUEFOG_HEALTH_ROUNDS`` (push-sum applications of the one-shot
aggregate; 0 disables the lane; unset: from the predicted rate),
``BLUEFOG_HEALTH_EPS`` (the time-to-ε target, default 1e-6),
``BLUEFOG_HEALTH_FILE`` (JSONL samples and advisories). The
``slo_burn`` slot reads :func:`bluefog_tpu_torch.slo.worst_burn` (0 with
the engine off).
"""

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.logging_util import json_safe as _json_safe

__all__ = [
    "HealthPlane",
    "HealthServer",
    "enabled",
    "health_interval",
    "health_port",
    "health_eps",
    "fit_decay_rate",
    "mixing_efficiency",
    "time_to_consensus_steps",
    "push_matrix",
    "fleet_aggregate_np",
    "fleet_aggregate",
    "healthz_verdict",
    "FLEET_FIELDS",
    "start",
    "stop",
    "activate",
    "active",
    "observe_step",
    "serve",
    "server",
    "dump",
    "on_init",
    "on_shutdown",
]

ENABLE_ENV = "BLUEFOG_HEALTH"
INTERVAL_ENV = "BLUEFOG_HEALTH_INTERVAL"
PORT_ENV = "BLUEFOG_HEALTH_PORT"
ROUNDS_ENV = "BLUEFOG_HEALTH_ROUNDS"
EPS_ENV = "BLUEFOG_HEALTH_EPS"
FILE_ENV = "BLUEFOG_HEALTH_FILE"
# the address the endpoint binds: every interface, as in the JAX package
DEFAULT_HOST = "0.0.0.0"

# mixing_degraded gate: efficiency this fraction below its EWMA baseline
# AND a -3 MAD z-score, for MIXING_STREAK consecutive samples (dropping one
# directed edge of an 8-ring costs only ~24 % of the promised contraction,
# so a deeper gate would miss a single flaky link; the z-score and the
# streak carry the false-positive burden)
MIXING_DEGRADED_FRAC = 0.10
MIXING_STREAK = 2
# decay-rate fit: least squares over the last FIT_WINDOW sampled (step,
# distance) points of the current topology version; fewer than
# MIN_FIT_POINTS usable points (or distances at the noise floor): no fit
FIT_WINDOW = 8
MIN_FIT_POINTS = 4
DIST_FLOOR = 1e-12
# advisory recency window of the /healthz verdict, in samples; it exceeds
# the mixing_degraded re-fire cooldown (FIT_WINDOW samples), so a
# persistently degraded fabric does not flap between ok and warn
VERDICT_RECENT_SAMPLES = 20

# The per-worker summary the push-sum lane aggregates.
FLEET_FIELDS = (
    "step_ms",              # step-time EWMA
    "consensus",            # per-worker consensus distance (the metrics probe)
    "wire_bytes_per_step",  # wire bytes per communicating step
    "advisories",           # advisories on record (health + doctor)
    "live_digest",          # digest of the believed live set
    "stale_age_max",        # worst delivered parameter age (staleness; 0 off)
    "mem_bytes_per_rank",   # measured per-worker footprint (memory; 0 off)
    "mem_headroom",         # budget minus footprint (0 without a budget)
    "slo_burn",             # worst fast-window SLO burn rate (0: no SLO engine)
)


def enabled() -> bool:
    """``BLUEFOG_HEALTH=1`` (default off); serving also needs
    ``BLUEFOG_HEALTH_PORT``."""
    return os.environ.get(ENABLE_ENV, "0").lower() in ("1", "true", "on", "yes")


def health_interval() -> int:
    """Communicating steps between samples (``BLUEFOG_HEALTH_INTERVAL``,
    default 20)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int(INTERVAL_ENV, 20))


def health_port() -> int:
    """``BLUEFOG_HEALTH_PORT`` (0 or unset: no serving)."""
    from bluefog_tpu_torch.logging_util import env_int

    return env_int(PORT_ENV, 0)


def health_eps() -> float:
    """The consensus target of the time-to-ε projection
    (``BLUEFOG_HEALTH_EPS``, default 1e-6)."""
    from bluefog_tpu_torch.logging_util import env_float

    return env_float(EPS_ENV, 1e-6)


# -- measured-decay estimation ------------------------------------------------


def fit_decay_rate(points: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Per-step consensus decay rate fitted over sampled ``(comm_step,
    distance)`` points: ``exp`` of the least-squares slope of ``ln d``
    against the step. None with fewer than :data:`MIN_FIT_POINTS` usable
    points (distances at or under the noise floor are dropped). A rate >= 1
    means the series is not decaying."""
    usable = [(float(s), math.log(float(d))) for s, d in points
              if d is not None and d > DIST_FLOOR]
    if len(usable) < MIN_FIT_POINTS:
        return None
    xs = np.array([s for s, _ in usable])
    ys = np.array([y for _, y in usable])
    if float(xs.max() - xs.min()) <= 0:
        return None
    slope = float(np.polyfit(xs, ys, 1)[0])
    return float(math.exp(min(slope, 50.0)))


def mixing_efficiency(measured: Optional[float],
                      predicted: Optional[float]) -> Optional[float]:
    """``ln(measured) / ln(predicted)``: 1.0 on contract, < 1 lagging, 0
    not decaying; None when a rate is missing or the matrix promises
    nothing (predicted ~ 1)."""
    if measured is None or predicted is None:
        return None
    if predicted >= 1.0 - 1e-9 or predicted <= 0.0:
        return None
    if measured >= 1.0:
        return 0.0
    return float(math.log(max(measured, 1e-300)) / math.log(predicted))


def time_to_consensus_steps(distance: Optional[float], rate: Optional[float],
                            eps: Optional[float] = None) -> Optional[float]:
    """Projected communicating steps until the consensus distance reaches
    ``eps`` at ``rate`` (None when not decaying or unknown; 0 when there)."""
    eps = health_eps() if eps is None else float(eps)
    if distance is None or rate is None or not 0.0 < rate < 1.0:
        return None
    if distance <= eps:
        return 0.0
    return float(math.log(eps / distance) / math.log(rate))


# -- in-band push-sum aggregation ---------------------------------------------


def push_matrix(w: np.ndarray, dead: Sequence[int] = ()) -> np.ndarray:
    """Sender-mass-conserving push matrix of a combine matrix ``W``: the
    dead ranks' rows and columns zeroed, every live sender's row
    normalized to sum 1 (``sum_j x'_j == sum_i x_i``, so the push-sum ratio
    estimates the live-set mean); a live sender left with no mass keeps it
    all (``P[i, i] = 1``)."""
    w = np.asarray(w, np.float64).copy()
    dead = set(int(r) for r in dead)
    for r in dead:
        w[r, :] = 0.0
        w[:, r] = 0.0
    p = np.zeros_like(w)
    n = w.shape[0]
    for i in range(n):
        if i in dead:
            continue
        row = w[i]
        s = float(row.sum())
        if s <= 0.0:
            p[i, i] = 1.0
        else:
            p[i] = row / s
    return p


def _fleet_estimates(x, p, mn, mx, live) -> dict:
    """Fold the lane's outputs into the report: each live rank's mean
    estimate is ``x / p``; the published mean is the average of the live
    estimates, with the worst rank's relative deviation as ``residual``."""
    live = list(live)
    est = np.array([x[j] / max(p[j], 1e-12) for j in live])
    mean = est.mean(axis=0)
    denom = np.maximum(np.abs(mean), 1e-12)
    residual = float(np.max(np.abs(est - mean[None, :]) / denom[None, :])) if len(live) else 0.0
    mn_f = np.min(np.stack([mn[j] for j in live]), axis=0)
    mx_f = np.max(np.stack([mx[j] for j in live]), axis=0)
    return {
        "mean": [float(v) for v in mean],
        "min": [float(v) for v in mn_f],
        "max": [float(v) for v in mx_f],
        "per_rank_mean": {int(j): [float(v) for v in est[k]] for k, j in enumerate(live)},
        "residual": residual,
        "live": [int(j) for j in live],
    }


def fleet_aggregate_np(w: np.ndarray, values: np.ndarray, rounds: int,
                       dead: Sequence[int] = ()) -> dict:
    """The numpy oracle of the lane: ``rounds`` synchronous applications of
    (sum lanes ``x <- P^T x``, ``p <- P^T p``; min/max lanes one
    neighbour-min/max over the application-start snapshot)."""
    values = np.asarray(values, np.float64)
    n, k = values.shape
    dead = set(int(r) for r in dead)
    live = [j for j in range(n) if j not in dead]
    p_mat = push_matrix(w, dead)
    in_nbrs = [[i for i in range(n) if i != j and p_mat[i, j] > 0.0] for j in range(n)]
    x = values.copy()
    p = np.ones(n)
    mn = values.copy()
    mx = values.copy()
    for r in dead:
        x[r] = 0.0
        p[r] = 0.0
        mn[r] = np.inf
        mx[r] = -np.inf
    for _ in range(rounds):
        x = p_mat.T @ x
        p = p_mat.T @ p
        mn0, mx0 = mn.copy(), mx.copy()
        for j in range(n):
            for i in in_nbrs[j]:
                mn[j] = np.minimum(mn[j], mn0[i])
                mx[j] = np.maximum(mx[j], mx0[i])
    return _fleet_estimates(x, p, mn, mx, live)


def _lane_operands(w: np.ndarray, dead: Sequence[int]):
    """The push plan of the lane and its operands, one format for the
    one-shot and the streaming paths: ``(perms, sources [R, N] int32, self_w
    [N] f32, recv_w [R, N] f32, destination mask [R, N] f32)``."""
    from bluefog_tpu_torch.collective import plan as plan_mod

    lane_plan = plan_mod.plan_from_matrix(push_matrix(w, dead))
    self_w, recv_w = lane_plan.weight_operands()
    dmask = (recv_w > 0.0).astype(np.float32)
    return lane_plan.perms, np.array(lane_plan.sources()), self_w, recv_w, dmask


def _seed_state(values32: np.ndarray, dead: Sequence[int], k: int) -> np.ndarray:
    """The lane buffer ``[x (k) | p (1) | min (k) | max (k)]`` seeded from
    per-rank values, the dead ranks masked (zero mass, ±inf extrema)."""
    size = values32.shape[0]
    st = np.zeros((size, 3 * k + 1), np.float32)
    st[:, :k] = values32
    st[:, k] = 1.0
    _reseed_minmax(st, values32, dead, k)
    for r in dead:
        st[r, : k + 1] = 0.0
    return st


def _reseed_minmax(st: np.ndarray, values32: np.ndarray, dead: Sequence[int], k: int) -> None:
    """Reset the min/max lanes to the current values (a generation start)."""
    st[:, k + 1: 2 * k + 1] = values32
    st[:, 2 * k + 1:] = values32
    for r in dead:
        st[r, k + 1: 2 * k + 1] = np.inf
        st[r, 2 * k + 1:] = -np.inf


def _auto_rounds(size: int, predicted_rate: Optional[float]) -> int:
    """Push-sum applications a sample: enough for the mean to land within
    ~1 % (``rho^R <= 0.01``) and for the min/max gossip to cover any
    strongly connected diameter, clamped to [4, 32];
    ``BLUEFOG_HEALTH_ROUNDS`` overrides."""
    env = os.environ.get(ROUNDS_ENV)
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    rho = predicted_rate if predicted_rate and 0 < predicted_rate < 1 else 0.5
    need = math.log(0.01) / math.log(rho)
    return int(max(4, min(32, max(need, size))))


def _lane_program(ctx, perms, n_apps: int, k: int):
    """The push-sum lane: ``n_apps`` applications of the push plan on an
    ``[N, 3k + 1]`` f32 buffer: the sum lanes ``x|p`` through
    :func:`~bluefog_tpu_torch.collective.inner.weighted_combine_operands`
    with the weights as operands, the min/max lanes by masked neighbour
    gossip over the application-start snapshot (one gather a round each).
    Plain PyTorch on the stacked worker axis, cached in ``ctx.op_cache``
    under its own ``("health_pushsum", perms, n_apps, k)`` key, so no
    training key changes. Called as ``fn(state, src, self_w, recv_w,
    dmask)`` with tensors on one device."""
    key = ("health_pushsum", perms, n_apps, k)
    fn = ctx.op_cache.get(key)
    if fn is None:
        import torch

        from bluefog_tpu_torch.collective import inner, transport

        n_rounds = len(perms)

        def fn(v, src, self_w, recv_w, dmask):
            x = v[:, : k + 1]  # sum lanes: k fields and the mass p
            mn = v[:, k + 1: 2 * k + 1]
            mx = v[:, 2 * k + 1:]
            inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
            for _ in range(n_apps):
                x = inner.weighted_combine_operands(x, src, self_w, recv_w)
                mn0, mx0 = mn, mx
                if isinstance(src, transport.Route):
                    # across processes the senders' min/max rows arrive
                    # together, once an application
                    mn0, mx0 = src.exchange([mn0, mx0])
                for r in range(n_rounds):
                    m = (dmask[r] > 0).view(-1, 1)
                    mn = torch.minimum(mn, torch.where(m, inner._gather(mn0, src[r]), inf))
                    mx = torch.maximum(mx, torch.where(m, inner._gather(mx0, src[r]), -inf))
            return torch.cat([x, mn, mx], dim=1)

        ctx.op_cache[key] = fn
    return fn


def _to_device(a: np.ndarray, device):
    """A host array on ``device`` without waiting for the device: on the
    card through a pinned staging copy and a non-blocking transfer (a
    blocking one would wait for the training step queued before it)."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True)


def _lane_tensors(ctx, src, self_w, recv_w, dmask):
    """The lane's operands on the context's device; across processes the
    push plan's :class:`~bluefog_tpu_torch.collective.transport.Route` and
    this process's columns of the weights and the mask."""
    if ctx.process_count > 1:
        from bluefog_tpu_torch.collective import transport

        cols = slice(ctx.rows.start, ctx.rows.stop)
        return (transport.route(src, ctx.size, ctx),) + tuple(
            _to_device(a, ctx.device) for a in (self_w[cols], recv_w[:, cols], dmask[:, cols]))
    return tuple(_to_device(a, ctx.device) for a in (src, self_w, recv_w, dmask))


def _apply_lane(ctx, fn, st: np.ndarray, operands):
    """One call of the lane ``fn`` on the host state ``st [size, 3k + 1]``:
    the whole state on one process; across processes this process's rows,
    the applications over the route, and every row back through one
    :func:`~bluefog_tpu_torch.collective.transport.gather_rows`, so every
    process holds the stacked lane's output, bitwise."""
    if ctx.process_count == 1:
        return fn(_to_device(st, ctx.device), *operands)
    from bluefog_tpu_torch.collective import transport

    mine = fn(_to_device(st[ctx.rows.start:ctx.rows.stop], ctx.device), *operands)
    return transport.gather_rows(mine.contiguous(), ctx)


def fleet_aggregate(ctx, values: np.ndarray, rounds: Optional[int] = None,
                    w: Optional[np.ndarray] = None, dead: Sequence[int] = (),
                    predicted_rate: Optional[float] = None) -> dict:
    """Aggregate a ``[size, K]`` per-rank summary fleet-wide min / mean /
    max through the lane on the context's device (``rounds`` applications,
    the result read back). ``w`` defaults to the active topology's combine
    matrix, ``dead`` to the elastic membership's dead ranks. Held against
    :func:`fleet_aggregate_np`. Across processes ``values`` is the whole
    ``[size, K]`` summary in every process; the lane runs over the transport
    (:func:`_apply_lane`)."""
    values = np.asarray(values, np.float64)
    size, k = values.shape
    if w is None:
        from bluefog_tpu_torch import topology as topo_mod

        w = topo_mod.mixing_matrix(ctx.load_topology())
    if not dead:
        membership = getattr(ctx, "elastic_membership", None)
        if membership is not None:
            dead = list(membership.dead_ranks())
    dead = [int(r) for r in dead]
    live = [j for j in range(size) if j not in dead]
    if rounds is None:
        rounds = _auto_rounds(len(live), predicted_rate)
    if rounds <= 0 or not live:
        return _fleet_estimates(values.copy(), np.ones(size), values.copy(), values.copy(),
                                live or range(size))
    perms, src, self_w, recv_w, dmask = _lane_operands(w, dead)
    seed = _seed_state(values.astype(np.float32), dead, k)
    fn = _lane_program(ctx, perms, int(rounds), k)
    out = _apply_lane(ctx, fn, seed, _lane_tensors(ctx, src, self_w, recv_w, dmask))
    out = out.cpu().numpy()
    out = out.astype(np.float64)
    rep = _fleet_estimates(out[:, :k], out[:, k], out[:, k + 1: 2 * k + 1],
                           out[:, 2 * k + 1:], live)
    rep["rounds"] = int(rounds)
    return rep


class _Pending:
    """A lane application in flight: its output copied to pinned host
    memory behind an event on the card (nothing to wait for on the CPU)."""

    def __init__(self, out):
        import torch

        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host, self.event = out, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return np.array(self.host.numpy(), np.float32)


# -- the health plane session -------------------------------------------------


class HealthPlane:
    """One observatory session: built by :func:`start` (or by
    ``bft.init()`` under ``BLUEFOG_HEALTH=1``), fed by the optimizers
    through :func:`observe_step` on every communicating step, or directly
    (``plane.observe(ctx, step=..., consensus=...)``)."""

    def __init__(self, interval: Optional[int] = None, eps: Optional[float] = None,
                 history: int = 512):
        from bluefog_tpu_torch import attribution

        self.interval = int(interval) if interval else health_interval()
        self.eps = float(eps) if eps is not None else health_eps()
        self._count = 0
        # guards the sample history against the serving threads, which copy
        # it while the training thread appends
        self._report_lock = threading.Lock()
        self.samples: collections.deque = collections.deque(maxlen=history)
        self.advisories: List[Any] = []
        # communicating-step count at each emit, parallel to ``advisories``:
        # the /healthz recency window compares this clock
        self.advisory_marks: List[int] = []
        self._eff_tracker = attribution.BaselineTracker()
        self._mix_streak = 0
        self._mix_cooldown = 0
        self._oob_streak = 0
        # decay points of the current topology version only
        self._decay_points: collections.deque = collections.deque(maxlen=FIT_WINDOW)
        self._decay_topo_v: Optional[int] = None
        self._spectral_cache: Dict[Any, Tuple[Optional[float], dict]] = {}
        self._last_sample_wall: Optional[float] = None
        self._last_sample_count = 0
        self._step_ewma_ms: Optional[float] = None
        self._last_wire_bytes: Optional[float] = None
        self._wire_per_step: float = 0.0
        self.fleet: Optional[dict] = None
        # the streaming lane: one application a sample, read at the next
        self._lane_cache: Optional[tuple] = None
        self._lane_state: Optional[np.ndarray] = None
        self._lane_pending: Optional[_Pending] = None
        self._lane_prev: Optional[np.ndarray] = None
        self._lane_age = 0
        self._published_mm: Optional[tuple] = None
        # across processes, each process's memory fields at this sample
        self._mem_rows: Optional[list] = None

    # -- spectral side --------------------------------------------------------

    def predicted_rate(self, ctx, plan=None) -> Tuple[Optional[float], dict]:
        """The predicted per-round consensus decay of the active combine,
        cached per ``(topo_version, live_token, source)``: the dispatched
        plan's weight matrix when given (a :class:`CommPlan`, or a
        :class:`SchedulePlan`'s period product), else the topology's."""
        from bluefog_tpu_torch import topology as topo_mod
        from bluefog_tpu_torch.collective.plan import CommPlan, SchedulePlan

        source = ("schedule" if isinstance(plan, SchedulePlan)
                  else "plan" if isinstance(plan, CommPlan) else "topology")
        key = (ctx.topo_version, ctx.live_token(), source)
        hit = self._spectral_cache.get(key)
        if hit is not None:
            return hit
        kind = "topology"
        if isinstance(plan, SchedulePlan):
            mats = [p.weight_matrix() for p in plan.plans]
            rate, spec = topo_mod.consensus_decay_rate_info(mats)
            kind = f"schedule(period={len(mats)})"
            self_w = float(np.mean([np.mean(np.diag(m)) for m in mats]))
        elif isinstance(plan, CommPlan):
            w = plan.weight_matrix()
            rate, spec = topo_mod.consensus_decay_rate_info(w)
            kind = "plan"
            self_w = float(np.mean(np.diag(w)))
        else:
            w = topo_mod.mixing_matrix(ctx.load_topology())
            rate, spec = topo_mod.consensus_decay_rate_info(w)
            self_w = float(np.mean(np.diag(w)))
        # the mean self weight is the `s` of the stale-mixing polynomial of
        # staleness.age_adjusted_rate; `spectral` discloses the engine
        meta = {"kind": kind, "slem": float(rate), "self_weight": self_w,
                "spectral": {"engine": spec.get("engine"),
                             "matvecs": spec.get("matvecs", 0),
                             "residual": spec.get("residual", 0.0),
                             "converged": spec.get("converged", True)}}
        # no contraction promised (disconnected / periodic): no prediction
        out = (None, meta) if rate >= 1.0 - 1e-9 else (float(rate), meta)
        self._spectral_cache[key] = out
        return out

    @staticmethod
    def _suspect_edges() -> List[Any]:
        """The edges and ranks a ``mixing_degraded`` advisory names:
        :func:`bluefog_tpu_torch.attribution.suspect_join`."""
        from bluefog_tpu_torch.attribution import suspect_join

        return suspect_join()

    # -- observation ----------------------------------------------------------

    def observe(self, ctx, *, step: int, plan=None,
                consensus: Optional[float] = None) -> Optional[dict]:
        """Once per communicating step: an unsampled step costs a compare
        and an increment; the sampled step runs the observatory, the lane
        and the serving-state refresh."""
        sampled = self._count % self.interval == 0
        self._count += 1
        if not sampled:
            return None
        return self._sample(ctx, step=step, plan=plan, consensus=consensus)

    def _read_consensus(self) -> Optional[float]:
        from bluefog_tpu_torch import metrics as metrics_mod

        g = metrics_mod.peek("bluefog.gossip.disagreement")
        return float(g.value) if g is not None else None

    def _read_wire_rate(self, steps_elapsed: int) -> float:
        from bluefog_tpu_torch import metrics as metrics_mod

        c = metrics_mod.peek("bluefog.wire_bytes")
        cur = float(c.value) if c is not None else None
        if cur is not None and self._last_wire_bytes is not None and steps_elapsed > 0:
            self._wire_per_step = (cur - self._last_wire_bytes) / steps_elapsed
        self._last_wire_bytes = cur
        return self._wire_per_step

    @staticmethod
    def _doctor_advisory_count() -> int:
        from bluefog_tpu_torch import attribution

        doc = attribution.active()
        return len(doc.advisories) if doc is not None else 0

    @staticmethod
    def _live_set(ctx) -> Tuple[List[int], List[int]]:
        membership = getattr(ctx, "elastic_membership", None)
        if membership is None:
            return list(range(ctx.size)), []
        return list(membership.live_ranks()), list(membership.dead_ranks())

    def _local_vector(self, ctx, consensus, live) -> np.ndarray:
        """The ``[size, K]`` summary the lane aggregates: the per-worker
        consensus from the metrics drain's worker rows when there are any,
        the other fields the same on every row (agreed across processes),
        except the memory fields, which across processes are each
        process's own on its rows."""
        from bluefog_tpu_torch import metrics as metrics_mod

        size = ctx.size
        vec = np.zeros((size, len(FLEET_FIELDS)))
        vec[:, 0] = self._step_ewma_ms or 0.0
        per_worker = metrics_mod.last_worker_rows().get("bluefog.gossip.disagreement")
        if per_worker is not None and len(per_worker) == size:
            vec[:, 1] = np.asarray(per_worker)
        elif consensus is not None:
            vec[:, 1] = consensus
        vec[:, 2] = self._wire_per_step
        vec[:, 3] = len(self.advisories) + self._doctor_advisory_count()
        vec[:, 4] = float(sum((j + 1) * 31 ** i for i, j in enumerate(sorted(live)))
                          % 1_000_003)
        vec[:, 5] = self._staleness_age_max()
        if self._mem_rows is None:
            vec[:, 6], vec[:, 7] = self._memory_fields()
        else:  # across processes: each process's fields on its own rows
            lo = 0
            for count, fields in zip(ctx.worker_counts, self._mem_rows):
                vec[lo:lo + count, 6], vec[lo:lo + count, 7] = fields
                lo += count
        vec[:, 8] = self._slo_burn()
        return vec

    @staticmethod
    def _memory_fields() -> Tuple[float, float]:
        """The measured per-worker footprint and the headroom under the
        budget ((0.0, 0.0) with the memory observatory off)."""
        from bluefog_tpu_torch import memory as mem_mod

        obs = mem_mod.active()
        if obs is None:
            return 0.0, 0.0
        return float(obs.last_bytes_per_rank()), float(obs.last_headroom())

    @staticmethod
    def _slo_burn() -> float:
        """The worst fast-window SLO burn rate of the SLO engine (0.0 with
        the engine off); aggregated fleet-wide, its max names the worker
        burning its budget fastest."""
        from bluefog_tpu_torch import slo as slo_mod

        return float(slo_mod.worst_burn())

    @staticmethod
    def _staleness_age_max() -> float:
        """The worst delivered parameter age measured (0.0 with the
        staleness observatory off)."""
        from bluefog_tpu_torch import staleness as stal_mod

        obs = stal_mod.active()
        return float(obs.last_age_max()) if obs is not None else 0.0

    def _fleet_step(self, ctx, values: np.ndarray, dead: Sequence[int],
                    predicted: Optional[float]) -> dict:
        """One streaming push-sum application, the sampled-step form of
        :func:`fleet_aggregate`: the lane state stays on the host between
        samples; each sample adds the summary's change to the sum lanes (so
        ``x / p`` tracks the live mean with geometric forgetting) and
        dispatches one application, read at the next sample. The min/max
        lanes run in generations of ``_auto_rounds`` samples, reseeded at
        each, the last completed generation published (``warming`` until
        the first completes). A topology or membership change rebuilds the
        plan and reseeds everything."""
        from bluefog_tpu_torch import topology as topo_mod

        size, k = values.shape
        dead = [int(r) for r in dead]
        live = [j for j in range(size) if j not in set(dead)]
        key = (ctx.topo_version, ctx.live_token(), k)
        if self._lane_cache is None or self._lane_cache[0] != key:
            w = topo_mod.mixing_matrix(ctx.load_topology())
            perms, src, self_w, recv_w, dmask = _lane_operands(w, dead)
            fn = _lane_program(ctx, perms, 1, k)
            self._lane_cache = (key, fn, _lane_tensors(ctx, src, self_w, recv_w, dmask))
            self._lane_state = None
            self._lane_pending = None  # the old plan's application
        _key, fn, operands = self._lane_cache
        if self._lane_pending is not None:
            # the previous sample's application, dispatched an interval ago
            self._lane_state = self._lane_pending.numpy()
            self._lane_pending = None
        gen_len = _auto_rounds(len(live), predicted)
        st = self._lane_state
        values32 = values.astype(np.float32)
        if st is None:
            st = _seed_state(values32, dead, k)
            self._lane_prev = values.copy()
            self._lane_age = 0
            self._published_mm = None
        else:
            delta = (values - self._lane_prev).astype(np.float32)
            if dead:
                delta[dead] = 0.0
            st[:, :k] += delta
            self._lane_prev = values.copy()
            if self._lane_age >= gen_len:
                self._published_mm = (st[:, k + 1: 2 * k + 1].copy(), st[:, 2 * k + 1:].copy())
                _reseed_minmax(st, values32, dead, k)
                self._lane_age = 0
        # dispatch this sample's application without waiting for it: the
        # estimates below are one application behind
        self._lane_state = st
        self._lane_pending = _Pending(_apply_lane(ctx, fn, st, operands))
        self._lane_age += 1
        mm = (self._published_mm if self._published_mm is not None
              else (st[:, k + 1: 2 * k + 1], st[:, 2 * k + 1:]))
        rep = _fleet_estimates(st[:, :k].astype(np.float64), st[:, k].astype(np.float64),
                               np.asarray(mm[0], np.float64), np.asarray(mm[1], np.float64),
                               live)
        rep["rounds"] = 1
        rep["generation_len"] = int(gen_len)
        rep["warming"] = self._published_mm is None
        return rep

    def _sample(self, ctx, *, step, plan, consensus) -> dict:
        from bluefog_tpu_torch import attribution
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch import staleness as stal_mod

        t_now = time.perf_counter()
        steps_elapsed = self._count - self._last_sample_count
        step_s = None
        if self._last_sample_wall is not None and steps_elapsed > 0:
            step_s = (t_now - self._last_sample_wall) / steps_elapsed
        self._last_sample_wall = t_now
        self._last_sample_count = self._count
        self._mem_rows = None
        if ctx.process_count > 1:
            from bluefog_tpu_torch.collective import transport

            # the host readings of every process: the slowest step time in
            # every one, and each process's memory fields for its own rows
            views = transport.gather_objects((step_s, self._memory_fields()), ctx)
            times = [v[0] for v in views]
            step_s = None if any(t is None for t in times) else max(times)
            self._mem_rows = [v[1] for v in views]
        if step_s is not None:
            ms = step_s * 1e3
            self._step_ewma_ms = ms if self._step_ewma_ms is None \
                else 0.8 * self._step_ewma_ms + 0.2 * ms

        if consensus is None:
            consensus = self._read_consensus()
        wire_rate = self._read_wire_rate(steps_elapsed)
        live, dead = self._live_set(ctx)

        sample: Dict[str, Any] = {
            "kind": "sample",
            "step": int(step),
            "comm_steps": self._count,
            "topo_version": int(ctx.topo_version),
        }
        if self._step_ewma_ms is not None:
            sample["step_ms_ewma"] = round(self._step_ewma_ms, 4)
        if consensus is not None:
            sample["consensus"] = float(consensus)
        if wire_rate:
            sample["wire_bytes_per_step"] = wire_rate
        if dead:
            sample["dead_ranks"] = dead

        # -- mixing observatory ----------------------------------------------
        predicted, spec_meta = self.predicted_rate(ctx, plan)
        sample["predicted_rate"] = predicted
        sample["spectral"] = spec_meta
        if ctx.topo_version != self._decay_topo_v:
            # a new graph promises a new rate: the old baseline must not
            # advise (or silence) this one
            self._decay_points.clear()
            self._decay_topo_v = ctx.topo_version
            self._eff_tracker = attribution.BaselineTracker()
            self._mix_streak = 0
            self._mix_cooldown = 0
            self._oob_streak = 0
        if consensus is not None:
            self._decay_points.append((self._count, consensus))
        measured = fit_decay_rate(self._decay_points)
        eff = mixing_efficiency(measured, predicted)
        if measured is not None:
            sample["measured_rate"] = round(measured, 6)
        if eff is not None:
            sample["mixing_efficiency"] = round(eff, 4)
        tte = time_to_consensus_steps(
            consensus, measured if measured is not None and measured < 1.0 else predicted,
            self.eps)
        if tte is not None:
            sample["time_to_eps_steps"] = round(tte, 1)
            sample["eps"] = self.eps

        # -- the age-discounted prediction (staleness observatory) ------------
        eff_adj = None
        obs = stal_mod.active()
        age = obs.last_age_mean() if obs is not None else None
        if age and predicted is not None:
            adj = stal_mod.age_adjusted_rate(predicted, age, spec_meta.get("self_weight", 0.5))
            sample["age_mean"] = round(float(age), 4)
            if adj is not None and adj != predicted:
                sample["age_adjusted_rate"] = round(adj, 6)
                eff_adj = mixing_efficiency(measured, adj)
                if eff_adj is not None:
                    sample["mixing_efficiency_age_adjusted"] = round(eff_adj, 4)
                metrics_mod.gauge("bluefog.health.age_adjusted_rate").set(adj)

        found = []
        if eff is not None:
            tr = self._eff_tracker
            if tr.n < MIN_FIT_POINTS:
                # warm-up: the first fits ride a transient; absorb them
                tr.update(eff)
                base, degraded = tr.mean, False
                self._oob_streak = 0
            else:
                base = tr.mean
                floor = max(tr.mad, abs(base) * 0.01, 1e-12)
                z = (eff - base) / floor
                degraded = z < -3.0 and eff < base * (1.0 - MIXING_DEGRADED_FRAC)
                if abs(z) <= 3.0:
                    # only in-band samples teach the baseline
                    tr.update(eff)
                    self._oob_streak = 0
                elif degraded:
                    self._oob_streak = 0
                else:
                    # out of band but not degraded: a persistent shift is a
                    # new regime, re-baselined after a full fit window
                    self._oob_streak += 1
                    if self._oob_streak >= FIT_WINDOW:
                        tr.update(eff)
                        self._oob_streak = 0
            self._mix_streak = self._mix_streak + 1 if degraded else 0
            if self._mix_cooldown > 0:
                self._mix_cooldown -= 1
            if self._mix_streak >= MIXING_STREAK and self._mix_cooldown == 0:
                found.append(attribution.Advisory(
                    kind="mixing_degraded", step=int(step),
                    detail={
                        "mixing_efficiency": round(eff, 4),
                        "baseline_efficiency": round(base, 4),
                        "predicted_rate": predicted,
                        "measured_rate": round(measured, 6) if measured is not None else None,
                        "topo_version": int(ctx.topo_version),
                        "suspect_edges": self._suspect_edges(),
                    },
                ))
                self._mix_streak = 0
                # rate-limit a persistent condition; the counter and
                # /healthz stay raised
                self._mix_cooldown = FIT_WINDOW

        # -- in-band fleet aggregation ---------------------------------------
        try:
            vec = self._local_vector(ctx, consensus, live)
            fleet = self._fleet_step(ctx, vec, dead, predicted)
            fleet["fields"] = list(FLEET_FIELDS)
            self.fleet = fleet
            sample["fleet"] = {"mean": fleet["mean"], "min": fleet["min"],
                               "max": fleet["max"], "residual": fleet["residual"],
                               "rounds": fleet.get("rounds", 0), "live": fleet["live"]}
            if fleet.get("warming"):
                sample["fleet"]["warming"] = True
            metrics_mod.gauge("bluefog.health.fleet_residual").set(fleet["residual"])
        except Exception as e:  # the lane must never kill training ...
            if ctx.process_count > 1:
                # ... but one process's failure leaves the others' transport
                # waiting: never switched off quietly there
                raise
            sample["fleet_error"] = str(e)[:200]

        # -- emission ---------------------------------------------------------
        if eff is not None:
            metrics_mod.gauge("bluefog.health.mixing_efficiency").set(eff)
        if predicted is not None:
            metrics_mod.gauge("bluefog.health.predicted_rate").set(predicted)
        if measured is not None:
            metrics_mod.gauge("bluefog.health.measured_rate").set(measured)
        if eff_adj is not None:
            metrics_mod.gauge("bluefog.health.mixing_efficiency_age_adjusted").set(eff_adj)
        if tte is not None:
            metrics_mod.gauge("bluefog.health.time_to_eps_steps").set(tte)
        metrics_mod.counter("bluefog.health.samples").inc()

        if found:
            sample["advisories"] = [a.to_json() for a in found]
        for adv in found:
            self._emit(adv)
        with self._report_lock:
            self.samples.append(sample)
        self._export_line(sample)
        return sample

    def _emit(self, adv) -> None:
        """One advisory on the doctor's surfaces: the ``bluefog.doctor.*``
        series, the flight side table, a timeline instant, the JSONL."""
        from bluefog_tpu_torch import flight as flight_mod
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch import timeline as tl

        self.advisories.append(adv)
        self.advisory_marks.append(self._count)
        metrics_mod.counter(f"bluefog.doctor.advisory.{adv.kind}").inc()
        metrics_mod.gauge("bluefog.doctor.last_advisory_step").set(adv.step)
        flight_mod.note_advisory(kind=adv.kind, step=adv.step, **adv.detail)
        tl.timeline_record_advisory(adv.kind, adv.detail)
        self._export_line({"kind": "advisory", "advisory_kind": adv.kind, "step": adv.step,
                           **adv.detail})

    def _export_line(self, obj: dict) -> None:
        path = os.environ.get(FILE_ENV)
        if path:
            from bluefog_tpu_torch.logging_util import append_jsonl

            append_jsonl(FILE_ENV, path, obj)

    # -- serving state / artifact ---------------------------------------------

    def _build_report(self) -> dict:
        with self._report_lock:
            samples = list(self.samples)
        return {
            "kind": "health_dump",
            "interval": self.interval,
            "comm_steps": self._count,
            "eps": self.eps,
            "last_sample": samples[-1] if samples else {},
            "samples": samples,
            "advisories": [a.to_json() for a in self.advisories],
            "fleet": self.fleet,
            "fields": list(FLEET_FIELDS),
        }

    def report(self) -> dict:
        """The health artifact (``tools/fleet_report.py`` reads it), built
        on demand: the sample history, the fleet aggregate, the
        :func:`healthz_verdict`, and the topology controller's (``autotune``:
        decisions, swaps, rollbacks, holds, the last action), the async
        engine's, the shard layout's, the federated fabric's (``federation``: layout, gateways, DCN period
        and wire, predicted rate), the memory observatory's and the SLO
        engine's (``slo``: worst burn, spent budgets, alerts, the last canary
        verdict) blocks when they are on. Host data only."""
        from bluefog_tpu_torch import async_gossip as async_mod
        from bluefog_tpu_torch import autotune as autotune_mod
        from bluefog_tpu_torch import context as ctx_mod
        from bluefog_tpu_torch import federation as fed_mod
        from bluefog_tpu_torch import memory as mem_mod
        from bluefog_tpu_torch import sharding as sharding_mod
        from bluefog_tpu_torch import slo as slo_mod

        rep = self._build_report()
        rep["healthz"] = healthz_verdict(self)
        tuner = autotune_mod.active()
        if tuner is not None:
            rep["autotune"] = tuner.summary()
        engine = async_mod.active()
        if engine is not None:
            rep["async"] = engine.summary()
        shard = sharding_mod.summary()
        if shard is not None:
            rep["shard"] = shard
        if fed_mod.enabled() and ctx_mod.is_initialized():
            fab = fed_mod.get_fabric(ctx_mod.get_context().size)
            if fab is not None:
                rep["federation"] = fab.to_json()
        obs = mem_mod.active()
        if obs is not None:
            rep["memory"] = {
                "bytes_per_rank": int(obs.last_bytes_per_rank()),
                "headroom_bytes": int(obs.last_headroom()) if obs.budget else None,
                "budget_bytes": obs.budget or None,
                "peak_bytes_per_rank": int(obs._peak_bytes),
                "oom_events": obs.oom_events,
                "ranked_census": mem_mod.ranked_census(obs.last_census)[:4],
            }
        eng = slo_mod.active()
        if eng is not None:
            rep["slo"] = {
                "worst_burn": eng.worst_burn(),
                "exhausted": eng.exhausted_objectives(),
                "alerts": len(eng.alerts),
                "canary": eng.canary.last if eng.canary is not None else None,
            }
        return rep

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(_json_safe(self.report()), f)
        return path


# -- RAG verdict --------------------------------------------------------------


def healthz_verdict(plane: Optional["HealthPlane"] = None) -> dict:
    """The ``/healthz`` verdict: **critical** when the elastic membership
    holds dead or suspect ranks, or an SLO error budget is spent
    (``slo_exhausted``, :func:`bluefog_tpu_torch.slo.exhausted_objectives`);
    **warn** when an advisory (health or doctor) fired within the last
    :data:`VERDICT_RECENT_SAMPLES` samples of its own communicating-step
    clock; **ok** otherwise. HTTP: 200 for ok/warn, 503 for critical."""
    from bluefog_tpu_torch import attribution
    from bluefog_tpu_torch import context as ctx_mod
    from bluefog_tpu_torch import slo as slo_mod
    from bluefog_tpu_torch.elastic.membership import RankState

    plane = plane if plane is not None else _plane
    status = "ok"
    reasons: List[str] = []
    dead: List[int] = []
    suspects: List[int] = []
    ctx = ctx_mod.get_context() if ctx_mod.is_initialized() else None
    membership = getattr(ctx, "elastic_membership", None) if ctx else None
    if membership is not None:
        dead = [int(r) for r in membership.dead_ranks()]
        suspects = [int(r) for r in range(membership.world_size)
                    if membership.state(r) == RankState.SUSPECT]
        if dead:
            status = "critical"
            reasons.append(f"dead ranks: {dead}")
        if suspects:
            status = "critical"
            reasons.append(f"suspect ranks: {suspects}")
    exhausted = slo_mod.exhausted_objectives()
    if exhausted:
        status = "critical"
        reasons.append(f"slo budget exhausted: {exhausted}")
    recent: List[dict] = []
    if plane is not None:
        floor = plane._count - VERDICT_RECENT_SAMPLES * plane.interval
        recent = [a.to_json() for a, mark in zip(plane.advisories, plane.advisory_marks)
                  if mark >= max(floor, 0)]
    doc = attribution.active()
    if doc is not None:
        floor = doc._count - VERDICT_RECENT_SAMPLES * doc.interval
        recent += [a.to_json() for a, mark in zip(doc.advisories, doc.advisory_marks)
                   if mark >= max(floor, 0)]
    if recent and status == "ok":
        status = "warn"
        kinds = sorted({a.get("kind", "?") for a in recent})
        reasons.append(f"recent advisories: {kinds}")
    return {
        "status": status,
        "reasons": reasons,
        "dead_ranks": dead,
        "suspect_ranks": suspects,
        "slo_exhausted": exhausted,
        "recent_advisories": recent[-8:],
        "ts": time.time(),
    }


# -- serving surface ----------------------------------------------------------


class HealthServer:
    """A stdlib HTTP endpoint on a daemon thread: ``/healthz`` (the
    verdict, 503 on critical), ``/metrics`` (Prometheus text), ``/fleet``
    (:meth:`HealthPlane.report`), ``/slo`` (the SLO engine's report, an
    empty dump with the engine off). A bind
    failure is a logged no-op (:meth:`maybe_start`)."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread
        self.host = str(httpd.server_address[0])
        self.port = int(httpd.server_address[1])

    @classmethod
    def maybe_start(cls, port: Optional[int] = None,
                    host: Optional[str] = None) -> Optional["HealthServer"]:
        """Serve on ``host:port`` (``host`` default :data:`DEFAULT_HOST`,
        ``port`` default ``BLUEFOG_HEALTH_PORT``; 0 in an explicit call: a
        port the OS assigns). Returns None, with a
        warning and without raising, when the port is taken or the
        environment asks for nothing."""
        from http.server import BaseHTTPRequestHandler, HTTPServer
        from socketserver import ThreadingMixIn

        from bluefog_tpu_torch.logging_util import logger

        host = DEFAULT_HOST if host is None else host
        env_port = port is None
        if port is None:
            port = health_port()
            if port <= 0:
                return None

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr line per scrape
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code, body):
                # strict JSON: json_safe turned every non-finite value into
                # null, and allow_nan=False is the tripwire
                self._send(code, json.dumps(_json_safe(body), allow_nan=False))

            def do_GET(self):
                from bluefog_tpu_torch import metrics as metrics_mod

                path = self.path.split("?")[0].rstrip("/") or "/healthz"
                try:
                    if path == "/healthz":
                        v = healthz_verdict()
                        self._json(503 if v["status"] == "critical" else 200, v)
                    elif path == "/metrics":
                        self._send(200, "\n".join(metrics_mod.prom_lines()) + "\n",
                                   ctype="text/plain; version=0.0.4")
                    elif path == "/fleet":
                        plane = active()
                        self._json(200, plane.report() if plane is not None else {
                            "kind": "health_dump", "healthz": healthz_verdict(None),
                            "fleet": None, "samples": []})
                    elif path == "/slo":
                        from bluefog_tpu_torch import slo as slo_mod

                        eng = slo_mod.active()
                        self._json(200, eng.report() if eng is not None else {
                            "kind": "slo_dump", "objectives": [], "alerts": [],
                            "canary": None})
                    else:
                        self._json(404, {"error": f"unknown path {path!r}",
                                         "paths": ["/healthz", "/metrics", "/fleet", "/slo"]})
                except Exception as e:  # a scrape fault must not hang the client
                    try:
                        self._send(500, json.dumps({"error": str(e)[:200]}))
                    except Exception:
                        pass

        class _Server(ThreadingMixIn, HTTPServer):
            daemon_threads = True
            # fast rebinds between sessions; a port another process listens
            # on still refuses
            allow_reuse_address = True

        try:
            httpd = _Server((host, int(port)), _Handler)
        except OSError as e:
            logger.warning("health endpoint disabled: cannot bind %s:%s (%s)%s", host, port, e,
                           " - set BLUEFOG_HEALTH_PORT to a free port" if env_port else "")
            return None
        thread = threading.Thread(target=httpd.serve_forever, name="bft-healthz", daemon=True)
        thread.start()
        return cls(httpd, thread)

    def close(self) -> None:
        """Stop serving and join the serving thread."""
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)


# -- module-level session -----------------------------------------------------

_plane: Optional[HealthPlane] = None
_server: Optional[HealthServer] = None


def start(interval: Optional[int] = None, **kwargs) -> HealthPlane:
    """Open a health-plane session, replacing any active one."""
    global _plane
    _plane = HealthPlane(interval=interval, **kwargs)
    return _plane


def stop() -> None:
    global _plane
    _plane = None


def activate(plane: Optional[HealthPlane]) -> Optional[HealthPlane]:
    """Install (or clear, with None) a built session without resetting
    its baselines."""
    global _plane
    _plane = plane
    return plane


def active() -> Optional[HealthPlane]:
    return _plane


def serve(port: Optional[int] = None, host: Optional[str] = None) -> Optional[HealthServer]:
    """Start (or restart) the HTTP endpoint; None when the bind fails."""
    global _server
    if _server is not None:
        _server.close()
    _server = HealthServer.maybe_start(port, host=host)
    return _server


def server() -> Optional[HealthServer]:
    return _server


def observe_step(ctx, *, step: int, plan=None, consensus: Optional[float] = None) -> None:
    """The optimizers' hook after every communicating dispatch (beside the
    doctor's); one attribute read when no session is active."""
    plane = _plane
    if plane is None:
        return
    plane.observe(ctx, step=step, plan=plan, consensus=consensus)


def dump(path: str) -> Optional[str]:
    """Write the active session's artifact (None without a session)."""
    plane = _plane
    if plane is None:
        return None
    return plane.dump(path)


def on_init(ctx) -> None:
    """``bft.init()``'s hook: a fresh session under ``BLUEFOG_HEALTH=1``,
    the endpoint under ``BLUEFOG_HEALTH_PORT``."""
    global _server
    if enabled():
        start()
    else:
        stop()
    if _server is not None:
        _server.close()
        _server = None
    if health_port() > 0:
        serve()


def on_shutdown() -> None:
    """``bft.shutdown()``'s hook: the JSONL's ``session_end`` line, the
    endpoint closed, the session dropped."""
    global _server
    plane = _plane
    if plane is not None and plane.samples:
        plane._export_line({"kind": "session_end", "comm_steps": plane._count})
    if _server is not None:
        _server.close()
        _server = None
    stop()
