# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Step-time attribution observatory (``bft.doctor``).

Counterpart of ``bluefog_tpu/attribution.py``: where a step's time goes,
and the residual of each gossip round against the compiler's cost model
turned into diagnosis. The names, knobs, rules, advisory kinds and metric
series are the JAX module's.

**Sampling discipline.** One communicating step in every
``BLUEFOG_DOCTOR_INTERVAL`` (default 100) is a sample; every other step
pays one integer compare and runs exactly the code it runs with the doctor
off. A sample times host work and dispatches its probes on a throwaway
buffer, so it changes no training value: trajectories with the doctor on
and off are bitwise equal. Only a sample waits for the device.

**What one sample measures** (the JAX module's fields):

- ``step_ms``: mean wall time per communicating step since the previous
  sample; ``dispatch_ms``: host time of the sampled step's enqueue (on one
  card the eager step runs its host work inside it, and returns before
  the device has finished its kernels); ``sync_lag_ms``: the wait from
  the dispatch's return until the device is idle.
- per-round probes: for each round of the active plan, ``inner._gather``
  over that round's sources on a cached ``[size, elems]`` f32 buffer
  (``RandomState(0)``; the sources cached in ``ctx.op_cache`` under
  ``("doctor_probe", perm, elems)``, so no training key moves), best of
  ``probe_reps`` timed on the host clock around a device synchronize, less
  the synchronize's own latency; priced with
  :func:`bluefog_tpu_torch.collective.compiler.predicted_round_costs_s` in
  the port's link class (``compiler.TRANSPORT_LINK_CLASS``, calibrated on
  the first sample by :func:`~bluefog_tpu_torch.collective.compiler.calibrate`
  unless a calibration is installed). A round above ``DEGRADE_RATIO`` times
  both its prediction and the median round is drilled edge by edge.
- ``comm_wire_ms`` (the probes scaled to the step's wire bytes by the
  calibrated beta), ``compute_ms`` (the rest of ``step_ms``) and
  ``anchor_tflops`` (a 256 x 256 bf16 ``torch.matmul``, the ambient
  compute anchor).

**Across processes** a probe round is the multi-process transport's
:class:`~bluefog_tpu_torch.collective.transport.Route` over that round's
perm on the probe buffer's local rows, priced by the route's own
calibration (:func:`~bluefog_tpu_torch.collective.compiler.calibrate`
times the route there). Every per-process wall time is the slowest
process's (the anchor the lowest throughput), through one
``all_gather_object`` each for the host readings (the step, the
dispatch, the sync lag, the anchor), the rounds' probes and the drilled
edges, before ``blame_edges`` and the drill-down decide, so every process
probes the same edges and reports the same sample and advisories.

**Advisories**: ``degraded_link``, ``straggler``, ``recompile_storm``
(from ``bluefog.recompiles``, which the eager port never counts),
``consensus_stall`` and ``ambient_drift``; each counts
``bluefog.doctor.advisory.<kind>``, goes to the flight recorder's side
table and the timeline, and to ``BLUEFOG_DOCTOR_FILE``. ``tools/doctor.py``
triages the dump.

**Chaos parity.** One card has no slow link: an active elastic session's
``degrade`` faults (rank-wide, or one ``peer=`` edge) delay every probe
whose round crosses a degraded edge by
:func:`~bluefog_tpu_torch.collective.compiler.degraded_round_penalty_s`
(:meth:`~bluefog_tpu_torch.elastic.recovery.ElasticSession.simulated_wire_factors`),
so naming the degraded edge from timings alone is a reproducible test.

Knobs: ``BLUEFOG_DOCTOR=1`` (default off), ``BLUEFOG_DOCTOR_INTERVAL``
(default 100), ``BLUEFOG_DOCTOR_FILE`` (JSONL samples and advisories),
``BLUEFOG_DOCTOR_PROBE_ELEMS`` (probe payload cap, default 32 Ki elements).
"""

import collections
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BaselineTracker",
    "Advisory",
    "StepDoctor",
    "enabled",
    "doctor_interval",
    "probe_elems_cap",
    "start",
    "stop",
    "activate",
    "active",
    "dispatch_timer",
    "observe_step",
    "dump",
    "blame_edges",
    "on_init",
    "on_shutdown",
]

ENABLE_ENV = "BLUEFOG_DOCTOR"
INTERVAL_ENV = "BLUEFOG_DOCTOR_INTERVAL"
FILE_ENV = "BLUEFOG_DOCTOR_FILE"
PROBE_ELEMS_ENV = "BLUEFOG_DOCTOR_PROBE_ELEMS"

# A round (or a drilled-down edge) is anomalous above this multiple of BOTH
# its prediction and the median of its peers.
DEGRADE_RATIO = 3.0
# Recompiles between samples above max(this, steps / 2) are a storm.
RECOMPILE_STORM_MIN = 3
# Anchor throughput this fraction below its EWMA is ambient drift ...
AMBIENT_DRIFT_FRAC = 0.10
# ... for this many consecutive samples.
AMBIENT_STREAK = 2
# Consecutive rising-disagreement samples before consensus_stall fires.
CONSENSUS_STREAK = 2

# the wires whose every element is repriced identically
_COMPRESSED_WIRES = frozenset({"int8", "int8_ef", "bf16", "int4", "int4_ef"})


def enabled() -> bool:
    """``BLUEFOG_DOCTOR=1`` (default off)."""
    return os.environ.get(ENABLE_ENV, "0").lower() in ("1", "true", "on", "yes")


def doctor_interval() -> int:
    """Sampling period in communicating steps (``BLUEFOG_DOCTOR_INTERVAL``,
    default 100)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int(INTERVAL_ENV, 100))


def probe_elems_cap() -> int:
    """Per-probe payload budget in f32 elements
    (``BLUEFOG_DOCTOR_PROBE_ELEMS``, default 32 Ki, at least 512)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(512, env_int(PROBE_ELEMS_ENV, 1 << 15))


# -- online baseline ----------------------------------------------------------


class BaselineTracker:
    """EWMA mean and EWMA mean absolute deviation of one series.
    ``update(x)`` returns the signed z-score of ``x`` against the baseline
    as it stood before ``x``; the first observation seeds it and scores 0.
    The deviation is floored at 1 % of the mean."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.mad: float = 0.0
        self.n = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.n += 1
        if self.mean is None:
            self.mean = x
            return 0.0
        dev = x - self.mean
        floor = max(self.mad, abs(self.mean) * 0.01, 1e-12)
        z = dev / floor
        a = self.alpha
        self.mean += a * dev
        self.mad += a * (abs(dev) - self.mad)
        return z

    def describe(self) -> dict:
        return {"mean": self.mean, "mad": self.mad, "n": self.n}


@dataclasses.dataclass(frozen=True)
class Advisory:
    """One structured diagnosis; ``detail`` is JSON-serializable."""

    kind: str
    step: int
    detail: Dict[str, Any]

    def to_json(self) -> dict:
        return {"kind": self.kind, "step": self.step, **self.detail}


def blame_edges(
    round_times_s: Sequence[float],
    predicted_s: Sequence[float],
    perms: Sequence[Sequence[Tuple[int, int]]],
    ratio: float = DEGRADE_RATIO,
) -> List[int]:
    """Indices of the anomalous rounds: measured above ``ratio`` times both
    the prediction and the lower median of the rounds."""
    if not round_times_s:
        return []
    srt = sorted(round_times_s)
    # the lower median: with an even count and one slow round the upper
    # median would be the outlier itself
    median = srt[(len(srt) - 1) // 2]
    out = []
    for i, t in enumerate(round_times_s):
        pred = predicted_s[i] if i < len(predicted_s) else median
        if t > ratio * max(pred, 1e-12) and t > ratio * max(median, 1e-12):
            out.append(i)
    return out


def suspect_join(include_stall_holds: bool = False) -> List[Any]:
    """Edges and ranks that corroborate a fabric advisory: the active
    elastic session's degrade faults (and, with ``include_stall_holds``,
    its stall payload holds) and this doctor's recent ``degraded_link``
    edges. An edge renders as ``[src, dst]``, a rank-wide fault as
    ``{"rank": n}``."""
    from bluefog_tpu_torch import elastic as elastic_mod

    out: List[Any] = []

    def add(key):
        item = [int(key[0]), int(key[1])] if isinstance(key, tuple) else {"rank": int(key)}
        if item not in out:
            out.append(item)

    session = elastic_mod.active_session()
    if session is not None:
        if include_stall_holds:
            for key in sorted(session.simulated_stale_steps(), key=str):
                add(key)
        for key in sorted(session.simulated_wire_factors(), key=str):
            add(key)
    doc = active()
    if doc is not None:
        for adv in doc.advisories[-8:]:
            if adv.kind == "degraded_link":
                edge = adv.detail.get("edge")
                if edge is not None and edge not in out:
                    out.append(edge)
    return out


def _settle(device) -> None:
    """Wait for the device: a synchronize on the card, nothing on the CPU
    (its eager ops have already run)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


# -- the doctor ---------------------------------------------------------------


class StepDoctor:
    """One attribution session, built by :func:`start` (or by ``init``
    under ``BLUEFOG_DOCTOR=1``) and fed by the optimizers through
    :func:`observe_step` on every communicating step."""

    def __init__(self, interval: Optional[int] = None, probe_reps: int = 2,
                 history: int = 512):
        self.interval = int(interval) if interval else doctor_interval()
        self.probe_reps = max(1, int(probe_reps))
        self._count = 0  # communicating steps observed
        self._last_sample_wall: Optional[float] = None
        self._last_sample_count = 0
        self._last_counters: Dict[str, float] = {}
        self.samples: collections.deque = collections.deque(maxlen=history)
        self.advisories: List[Advisory] = []
        # the comm-step count at each emit, parallel to ``advisories``
        self.advisory_marks: List[int] = []
        self.trackers: Dict[str, BaselineTracker] = {}
        self._consensus_streak = 0
        self._ambient_streak = 0
        self._probe_bufs: Dict[Tuple, Any] = {}  # (device, elems) -> [size, elems] f32
        self._warm_probes: set = set()  # (perm, elems) warmed
        self._anchor_x = None
        self._calibrated = False

    # -- sampling gate --------------------------------------------------------

    def will_sample(self) -> bool:
        """Whether the next :meth:`observe` call is a sample."""
        return self._count % self.interval == 0

    # -- probe plumbing -------------------------------------------------------

    def _tracker(self, name: str) -> BaselineTracker:
        t = self.trackers.get(name)
        if t is None:
            t = self.trackers[name] = BaselineTracker()
        return t

    def _probe_buffer(self, ctx, elems: int):
        """The ``[size, elems]`` f32 probe buffer (``RandomState(0)``);
        across processes this process's rows of it."""
        key = (str(ctx.device), ctx.size, elems)
        buf = self._probe_bufs.get(key)
        if buf is None:
            import numpy as np
            import torch

            full = np.random.RandomState(0).randn(ctx.size, elems).astype(np.float32)
            buf = torch.from_numpy(full[ctx.rows.start:ctx.rows.stop]).to(ctx.device)
            self._probe_bufs[key] = buf
        return buf

    def _probe_fn(self, ctx, perm: Tuple[Tuple[int, int], ...], elems: int):
        """One round of the stacked transport over exactly ``perm``: a
        gather by the round's sources (-1 where a worker receives
        nothing); across processes that round's
        :class:`~bluefog_tpu_torch.collective.transport.Route` on the probe
        buffer's local rows, then the gather. Cached in ``ctx.op_cache``
        under its own ``doctor_probe`` family."""
        key = ("doctor_probe", perm, elems)
        fn = ctx.op_cache.get(key)
        if fn is None:
            import numpy as np
            import torch

            from bluefog_tpu_torch.collective import inner, transport

            src = np.full((1, ctx.size), -1, np.int64)
            for s, d in perm:
                src[0, d] = s
            if ctx.process_count > 1:
                rt = transport.route(src, ctx.size, ctx)
                fn = lambda t: inner._gather(rt.exchange([t])[0], rt[0])  # noqa: E731
            else:
                src_t = torch.from_numpy(src[0].astype(np.int32)).to(ctx.device)
                fn = lambda t: inner._gather(t, src_t)  # noqa: E731
            ctx.op_cache[key] = fn
        return fn

    def _chaos_delay_s(self, perm, payload_bytes: float) -> float:
        """The deterministic wire slowness of an active elastic session's
        degrade faults: every edge of ``perm`` that touches a degraded rank,
        or is a degraded ``peer=`` edge, adds
        :func:`~bluefog_tpu_torch.collective.compiler.degraded_round_penalty_s`
        in the port's link class."""
        from bluefog_tpu_torch import elastic as elastic_mod
        from bluefog_tpu_torch.collective import compiler

        session = elastic_mod.active_session()
        if session is None:
            return 0.0
        factors = session.simulated_wire_factors()
        if not factors:
            return 0.0
        delay = 0.0
        for s, d in perm:
            f = factors.get((s, d), min(factors.get(s, 1.0), factors.get(d, 1.0)))
            delay += compiler.degraded_round_penalty_s(
                payload_bytes, f, link_class=compiler.TRANSPORT_LINK_CLASS)
        return delay

    def _readback_s(self, ctx, elems: int) -> float:
        """The latency of a settle on an idle device: the fixed cost every
        timed probe subtracts (measured once a sample)."""
        self._probe_buffer(ctx, elems)
        _settle(ctx.device)
        t0 = time.perf_counter()
        _settle(ctx.device)
        return time.perf_counter() - t0

    def _time_probe(self, ctx, perm, elems: int, rb_s: float) -> float:
        """Wall time of one probe round (best of ``probe_reps``), less the
        settle latency ``rb_s``; the first visit of a ``(perm, elems)``
        shape runs once untimed."""
        fn = self._probe_fn(ctx, perm, elems)
        buf = self._probe_buffer(ctx, elems)
        payload_bytes = elems * 4.0
        if (perm, elems) not in self._warm_probes:
            fn(buf)
            _settle(ctx.device)
            self._warm_probes.add((perm, elems))
        best = None
        for _ in range(self.probe_reps):
            t0 = time.perf_counter()
            fn(buf)
            delay = self._chaos_delay_s(perm, payload_bytes)
            if delay > 0:
                time.sleep(delay)
            _settle(ctx.device)
            t1 = time.perf_counter()
            dt = (t1 - t0) - rb_s
            if dt <= 0:
                # an ambient stall distorted the correction: keep the raw
                # (upper-bound) time, never a fake ~0
                dt = max(t1 - t0, 1e-9)
            best = dt if best is None else min(best, dt)
        return best

    def _probe_rounds(self, ctx, plan, wire_bytes_per_round: float):
        """Probe every round of ``plan`` at the probe payload, price it,
        and drill into the anomalous rounds edge by edge. Returns (rounds
        report, advisories, probe bytes, summed probe seconds)."""
        from bluefog_tpu_torch.collective import compiler, transport

        link = compiler.TRANSPORT_LINK_CLASS
        perms = plan.perms
        elems = min(probe_elems_cap(), max(512, int(wire_bytes_per_round // 4) or 512))
        elems -= elems % 512
        elems = max(512, elems)
        probe_bytes = elems * 4.0
        preds = compiler.predicted_round_costs_s(plan.compile_info, probe_bytes,
                                                 n_rounds=len(perms), link_class=link)
        rb_s = self._readback_s(ctx, elems)
        times = transport.fleet_max([self._time_probe(ctx, p, elems, rb_s) for p in perms], ctx)
        suspect = blame_edges(times, preds, perms)
        rounds = []
        for i, p in enumerate(perms):
            rounds.append({
                "round": i,
                "edges": [[int(s), int(d)] for s, d in p],
                "probe_ms": round(times[i] * 1e3, 4),
                "predicted_ms": round(preds[i] * 1e3, 4),
                "residual_ratio": round(times[i] / max(preds[i], 1e-12), 2),
            })
        found: List[Advisory] = []
        blamed: List[Tuple[Tuple[int, int], float, float]] = []
        for i in suspect:
            # a round can only be blamed whole; one edge at a time names it
            edges = list(perms[i])
            edge_ts = dict(zip(edges, transport.fleet_max(
                [self._time_probe(ctx, (e,), elems, rb_s) for e in edges], ctx)))
            pred_edge = compiler.round_cost_s(probe_bytes, link_class=link)
            srt_e = sorted(edge_ts.values())
            med = srt_e[(len(srt_e) - 1) // 2]
            for e, t in edge_ts.items():
                if t > DEGRADE_RATIO * max(pred_edge, 1e-12) and (
                    len(edge_ts) == 1 or t > DEGRADE_RATIO * max(med, 1e-12)
                ):
                    blamed.append((e, t, pred_edge))
            rounds[i]["edge_probe_ms"] = {
                f"{s}->{d}": round(t * 1e3, 4) for (s, d), t in edge_ts.items()
            }
        for (s, d), t, pred in blamed:
            found.append(Advisory(
                kind="degraded_link", step=self._count,
                detail={
                    "edge": [int(s), int(d)],
                    "measured_ms": round(t * 1e3, 4),
                    "predicted_ms": round(pred * 1e3, 4),
                    "ratio": round(t / max(pred, 1e-12), 2),
                },
            ))
        # two or more blamed edges sharing an endpoint: the rank, not a link
        by_rank: Dict[int, List] = {}
        for (s, d), _t, _pred in blamed:
            by_rank.setdefault(int(s), []).append([int(s), int(d)])
            by_rank.setdefault(int(d), []).append([int(s), int(d)])
        for rank, edges in sorted(by_rank.items()):
            if len(edges) >= 2:
                found.append(Advisory(kind="straggler", step=self._count,
                                      detail={"rank": rank, "edges": edges}))
        return rounds, found, probe_bytes, sum(times)

    def _anchor_tflops(self) -> Optional[float]:
        """Throughput of a fixed 256 x 256 bf16 matmul on the context's
        device: the per-sample ambient anchor."""
        import torch

        from bluefog_tpu_torch import context as ctx_mod

        ctx = ctx_mod._context
        if ctx is None:
            return None
        n = 256
        if self._anchor_x is None or self._anchor_x.device != ctx.device:
            self._anchor_x = torch.ones((n, n), dtype=torch.bfloat16, device=ctx.device)
            torch.matmul(self._anchor_x, self._anchor_x).sum()
            _settle(ctx.device)
        reps = 4
        t0 = time.perf_counter()
        for _ in range(reps):
            torch.matmul(self._anchor_x, self._anchor_x).sum()
        _settle(ctx.device)
        t1 = time.perf_counter()
        _settle(ctx.device)
        dt = max((t1 - t0) - (time.perf_counter() - t1), 1e-9) / reps
        return 2.0 * n ** 3 / dt / 1e12

    # -- the observation entry point ------------------------------------------

    def observe(self, ctx, *, step: int, outputs=None, plan=None, params=None,
                wire: Optional[str] = None, dispatch_s: Optional[float] = None) -> Optional[dict]:
        """Called once per communicating step: one compare and one increment
        on an unsampled step, the attribution pass on a sampled one."""
        sampled = self._count % self.interval == 0
        self._count += 1
        if not sampled:
            return None
        return self._sample(ctx, step=step, outputs=outputs, plan=plan, params=params,
                            wire=wire, dispatch_s=dispatch_s)

    def _wire_bytes_per_round(self, params, wire) -> float:
        """Bytes one worker ships a round for this step (every dtype group,
        at the wire's width)."""
        if params is None:
            return float(probe_elems_cap() * 4)
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch.optimizers import tree_leaves

        by_item: Dict[int, int] = {}
        for leaf in tree_leaves(params):
            n = leaf[0].numel() if leaf.dim() > 1 else 1
            by_item[leaf.element_size()] = by_item.get(leaf.element_size(), 0) + n
        if wire in _COMPRESSED_WIRES:
            by_item = {1: sum(by_item.values())}
        return float(metrics_mod.wire_bytes_per_step(by_item, 1, wire))

    def _sample(self, ctx, *, step, outputs, plan, params, wire, dispatch_s) -> dict:
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch.collective import compiler, transport

        if not self._calibrated:
            # residuals only mean something against measured constants; an
            # installed calibration is kept
            self._calibrated = True
            if ctx is not None:
                compiler.calibrate(link_class=compiler.TRANSPORT_LINK_CLASS)

        t_now = time.perf_counter()
        steps_elapsed = self._count - self._last_sample_count
        step_s = None
        if self._last_sample_wall is not None and steps_elapsed > 0:
            step_s = (t_now - self._last_sample_wall) / steps_elapsed
        self._last_sample_wall = t_now
        self._last_sample_count = self._count

        sync_lag_s = None
        if outputs is not None and ctx is not None:
            t0 = time.perf_counter()
            _settle(ctx.device)
            sync_lag_s = time.perf_counter() - t0
        anchor = self._anchor_tflops()
        if ctx is not None and ctx.process_count > 1:
            # the host readings of every process, the slowest's in every one
            # (the anchor's lowest throughput: the largest negated)
            step_s, dispatch_s, sync_lag_s, neg = transport.fleet_max(
                [step_s, dispatch_s, sync_lag_s, None if anchor is None else -anchor], ctx)
            anchor = None if neg is None else -neg

        sample: Dict[str, Any] = {
            "kind": "sample",
            "step": int(step),
            "comm_steps": self._count,
            "steps_since_last": steps_elapsed,
        }
        if step_s is not None:
            sample["step_ms"] = round(step_s * 1e3, 4)
        if dispatch_s is not None:
            sample["dispatch_ms"] = round(dispatch_s * 1e3, 4)
        if sync_lag_s is not None:
            sample["sync_lag_ms"] = round(sync_lag_s * 1e3, 4)

        # -- per-round comm profile -------------------------------------------
        found: List[Advisory] = []
        comm_wire_s = None
        if plan is not None and getattr(plan, "perms", None) and ctx is not None:
            wire_bytes = self._wire_bytes_per_round(params, wire)
            rounds, found, probe_bytes, _probe_sum_s = self._probe_rounds(ctx, plan, wire_bytes)
            sample["rounds"] = rounds
            sample["probe_payload_bytes"] = int(probe_bytes)
            sample["wire_bytes_per_round"] = int(wire_bytes)
            # each probe round scaled to the step's payload by the
            # calibrated beta (the port prices every round at congestion 1)
            beta = float(compiler.calibration(compiler.TRANSPORT_LINK_CLASS)["beta_bytes_per_s"])
            comm_wire_s = 0.0
            for r in rounds:
                comm_wire_s += r["probe_ms"] / 1e3 + max(wire_bytes - probe_bytes, 0.0) / beta
            sample["comm_wire_ms"] = round(comm_wire_s * 1e3, 4)
            if step_s is not None:
                host = dispatch_s or 0.0
                sample["compute_ms"] = round(max(step_s - comm_wire_s - host, 0.0) * 1e3, 4)
                sample["exposed_comm_frac"] = round(min(comm_wire_s / max(step_s, 1e-12), 1.0), 4)

        # -- registry-fed series ----------------------------------------------
        deltas = {}
        for name in ("bluefog.recompiles", "bluefog.wire_bytes"):
            series = metrics_mod.peek(name)
            cur = float(series.value) if series is not None else 0.0
            prev = self._last_counters.get(name)
            self._last_counters[name] = cur
            deltas[name] = None if prev is None else cur - prev
        if deltas["bluefog.recompiles"] is not None:
            sample["recompiles_since_last"] = deltas["bluefog.recompiles"]
        if deltas["bluefog.wire_bytes"] is not None and steps_elapsed:
            sample["wire_bytes_per_step"] = deltas["bluefog.wire_bytes"] / steps_elapsed
        dis = metrics_mod.peek("bluefog.gossip.disagreement")
        consensus = float(dis.value) if dis is not None else None
        if consensus is not None:
            sample["consensus_distance"] = consensus

        if anchor is not None:
            sample["anchor_tflops"] = round(anchor, 4)

        # -- baselines and rule-based advisories --------------------------------
        z_step = self._tracker("step_s").update(step_s) if step_s is not None else 0.0
        if comm_wire_s is not None:
            self._tracker("comm_wire_s").update(comm_wire_s)
        if sample.get("wire_bytes_per_step") is not None:
            self._tracker("wire_bytes").update(sample["wire_bytes_per_step"])

        rec = deltas["bluefog.recompiles"]
        if rec is not None and rec >= max(RECOMPILE_STORM_MIN, steps_elapsed / 2.0):
            found.append(Advisory(kind="recompile_storm", step=int(step),
                                  detail={"recompiles": rec, "steps": steps_elapsed}))

        if consensus is not None:
            tr = self._tracker("consensus")
            z = tr.update(consensus)
            rising = z > 3.0 and consensus > (tr.mean or 0.0)
            self._consensus_streak = self._consensus_streak + 1 if rising else 0
            if self._consensus_streak >= CONSENSUS_STREAK:
                found.append(Advisory(
                    kind="consensus_stall", step=int(step),
                    detail={"consensus_distance": consensus, "baseline": tr.mean,
                            "streak": self._consensus_streak},
                ))
                self._consensus_streak = 0

        if anchor is not None:
            tr = self._tracker("anchor_tflops")
            z = tr.update(anchor)
            base = tr.mean or anchor
            drifted = tr.n > 2 and z < -3.0 and anchor < base * (1.0 - AMBIENT_DRIFT_FRAC)
            self._ambient_streak = self._ambient_streak + 1 if drifted else 0
            if self._ambient_streak >= AMBIENT_STREAK:
                detail = {
                    "anchor_tflops": round(anchor, 4),
                    "baseline_tflops": round(base, 4),
                    "streak": self._ambient_streak,
                }
                if step_s is not None and z_step > 3.0:
                    detail["step_ms"] = sample.get("step_ms")
                found.append(Advisory(kind="ambient_drift", step=int(step), detail=detail))
                self._ambient_streak = 0

        if found:
            sample["advisories"] = [a.to_json() for a in found]
        for adv in found:
            self._emit(adv)
        self.samples.append(sample)
        self._export_line(sample)

        if step_s is not None:
            metrics_mod.gauge("bluefog.doctor.step_ms").set(step_s * 1e3)
        if comm_wire_s is not None:
            metrics_mod.gauge("bluefog.doctor.comm_wire_ms").set(comm_wire_s * 1e3)
        if anchor is not None:
            metrics_mod.gauge("bluefog.doctor.anchor_tflops").set(anchor)
        metrics_mod.counter("bluefog.doctor.samples").inc()
        return sample

    # -- emission -------------------------------------------------------------

    def _emit(self, adv: Advisory) -> None:
        """One advisory on the metrics, the flight side table, the timeline
        and the doctor's JSONL."""
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

    # -- dump -----------------------------------------------------------------

    def report(self) -> dict:
        """The attribution dump ``tools/doctor.py`` triages: samples,
        advisories, baselines and the port's calibration."""
        from bluefog_tpu_torch.collective import compiler

        return {
            "kind": "doctor_dump",
            "interval": self.interval,
            "comm_steps": self._count,
            "samples": list(self.samples),
            "advisories": [a.to_json() for a in self.advisories],
            "baselines": {k: t.describe() for k, t in sorted(self.trackers.items())},
            "calibration": {
                k: v for k, v in compiler.calibration(compiler.TRANSPORT_LINK_CLASS).items()
                if isinstance(v, (int, float, str))
            },
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.report(), f)
        return path


# -- module-level session -----------------------------------------------------

_doctor: Optional[StepDoctor] = None


def start(interval: Optional[int] = None, **kwargs) -> StepDoctor:
    """Open an attribution session (replacing any active one)."""
    global _doctor
    _doctor = StepDoctor(interval=interval, **kwargs)
    return _doctor


def stop() -> None:
    global _doctor
    _doctor = None


def activate(doctor: Optional[StepDoctor]) -> Optional[StepDoctor]:
    """Install (or clear, with None) a session without resetting it."""
    global _doctor
    _doctor = doctor
    return doctor


def active() -> Optional[StepDoctor]:
    return _doctor


def dispatch_timer(comm_now: bool) -> Optional[float]:
    """``perf_counter()`` when the imminent dispatch is a doctor sample,
    else None: the optimizers time their enqueue only then."""
    doc = _doctor
    if doc is None or not comm_now or not doc.will_sample():
        return None
    return time.perf_counter()


def observe_step(ctx, *, step: int, outputs=None, plan=None, params=None,
                 wire: Optional[str] = None, dispatch_s: Optional[float] = None) -> None:
    """The optimizers' hook after every communicating dispatch; one
    attribute read without a session."""
    doc = _doctor
    if doc is None:
        return
    doc.observe(ctx, step=step, outputs=outputs, plan=plan, params=params, wire=wire,
                dispatch_s=dispatch_s)


def dump(path: str) -> Optional[str]:
    """Write the active session's dump (None without a session)."""
    doc = _doctor
    if doc is None:
        return None
    return doc.dump(path)


def on_init(ctx) -> None:
    """``init`` hook: a fresh session under ``BLUEFOG_DOCTOR=1``, else none."""
    if enabled():
        start()
    else:
        stop()


def on_shutdown() -> None:
    """``shutdown`` hook: the JSONL's closing line, and the session dropped."""
    doc = _doctor
    if doc is not None and doc.samples:
        doc._export_line({"kind": "session_end", "comm_steps": doc._count})
    stop()
