# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Staleness and provenance observatory (``bft.staleness``): how old is the
data that enters each worker's combine, per edge, per step.

Counterpart of ``bluefog_tpu/staleness.py``; the names, knobs, advisory and
metric series are the JAX module's.

**The provenance lane.** A sampled communicating step stamps an int32
lineage tag ``(birth_step, topo_version, membership_epoch)`` per worker
and round, and ships it along the rounds of the step's plan with
:func:`bluefog_tpu_torch.collective.inner.lineage_exchange` (the round
sources cached in ``ctx.op_cache`` under their own ``staleness_lane``
family). The delivered tags give each directed edge's age
(``receiver_comm_step - delivered_birth_step``), folded on the host. One
communicating step in ``BLUEFOG_STALENESS_INTERVAL`` is a sample; every
other step runs exactly the code it runs with the observatory off, and a
sample changes no training value. The tag is priced as
:data:`LINEAGE_TAG_BYTES` a round by
:func:`bluefog_tpu_torch.scaling.wire_payload_bytes` (``lineage=True``).

**The surfaces:**

- the synchronous combine: age 0 on every edge, checked each sample (a
  nonzero age is lane corruption, counted in
  ``bluefog.staleness.selfcheck_failures``);
- the ``delayed=True`` combine: age 1 in the steady state; a topology
  swap or an elastic repair reseeds the delay buffer, so that sample
  reads age 0;
- the window ops: :func:`observe_window` folds the window age lane
  (:func:`bluefog_tpu_torch.windows.get_win_age`) at ``win_update`` and
  the window optimizers' steps;
- the asynchronous gossip engine (:mod:`bluefog_tpu_torch.async_gossip`):
  the same lane under ``surface="async"``, the ages its gate reads.

**Across processes** each process stamps and ships its rows' tags on the
plan's routes and gathers the delivered tags of every row, so the ages
and the ``staleness_breach`` advisories are the fleet's, bitwise the
stacked run's, in every process; the window and ``async`` surfaces read
the window's host age lane, which is global.

**Chaos parity.** An elastic ``stall`` fault with ``steps=`` (and
``peer=``) holds the stamped birth step of its sender or edge
(:meth:`~bluefog_tpu_torch.elastic.recovery.ElasticSession.simulated_stale_steps`),
so the measured age spikes on exactly that edge and a
``staleness_breach`` advisory names it.

An advisory counts ``bluefog.doctor.advisory.staleness_breach``, goes to
the flight side table, the timeline and ``BLUEFOG_STALENESS_FILE``;
``tools/staleness_report.py`` triages the dump. The worst age
(:meth:`StalenessObservatory.last_age_max`) is the ``stale_age_max`` slot
of the health plane's fleet lane (:mod:`bluefog_tpu_torch.health`), and
the mean age discounts its predicted rate (:func:`age_adjusted_rate`).

Knobs: ``BLUEFOG_STALENESS=1`` (default off),
``BLUEFOG_STALENESS_INTERVAL`` (default 20 communicating steps),
``BLUEFOG_STALENESS_BOUND`` (the breach bound, default 4),
``BLUEFOG_STALENESS_FILE`` (JSONL samples and advisories).
"""

import collections
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "StalenessObservatory",
    "LINEAGE_FIELDS",
    "LINEAGE_TAG_BYTES",
    "enabled",
    "staleness_interval",
    "staleness_bound",
    "age_adjusted_rate",
    "start",
    "stop",
    "activate",
    "active",
    "observe_step",
    "observe_window",
    "dump",
    "on_init",
    "on_shutdown",
]

ENABLE_ENV = "BLUEFOG_STALENESS"
INTERVAL_ENV = "BLUEFOG_STALENESS_INTERVAL"
BOUND_ENV = "BLUEFOG_STALENESS_BOUND"
FILE_ENV = "BLUEFOG_STALENESS_FILE"

# one int32 per field, per edge per round on a sampled step
LINEAGE_FIELDS = ("birth_step", "topo_version", "epoch")
LINEAGE_TAG_BYTES = 4 * len(LINEAGE_FIELDS)

# samples of its surface a breached (surface, edge) stays muted
BREACH_COOLDOWN = 8
# past this many distinct edges no new per-edge histogram is created
MAX_EDGE_SERIES = 128


def enabled() -> bool:
    """``BLUEFOG_STALENESS=1`` (default off)."""
    return os.environ.get(ENABLE_ENV, "0").lower() in ("1", "true", "on", "yes")


def staleness_interval() -> int:
    """Sampling period in communicating steps
    (``BLUEFOG_STALENESS_INTERVAL``, default 20)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int(INTERVAL_ENV, 20))


def staleness_bound() -> int:
    """Delivered-age bound above which ``staleness_breach`` fires
    (``BLUEFOG_STALENESS_BOUND``, default 4)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int(BOUND_ENV, 4))


def age_adjusted_rate(rate: Optional[float], age: Optional[float],
                      self_weight: float = 0.5) -> Optional[float]:
    """Per-step consensus decay corrected for a delivered age ``A =
    round(age)``: the largest root magnitude of ``t^(A+1) - s t^A - (rate -
    s)``; ``rate`` itself at age 0, never below ``rate`` and below 1."""
    if rate is None or not 0.0 < rate < 1.0:
        return rate
    if age is None or age <= 0:
        return rate
    a = int(round(float(age)))
    if a <= 0:
        return rate
    s = min(max(float(self_weight), 0.0), 1.0 - 1e-9)
    coeffs = np.zeros(a + 2)
    coeffs[0] = 1.0
    coeffs[1] = -s
    coeffs[-1] = -(rate - s)
    roots = np.roots(coeffs)
    adj = float(np.max(np.abs(roots))) if roots.size else rate
    return float(min(max(adj, rate), 1.0 - 1e-12))


# -- the lineage lane ---------------------------------------------------------


def _lane_sources(ctx, perms):
    """The rounds' sources ``[n_rounds, size]`` on the device (-1 where a
    worker receives nothing; across processes on the host, where the
    transport builds its routes from them), cached in ``ctx.op_cache``
    under the ``staleness_lane`` family: no training key moves."""
    key = ("staleness_lane", perms)
    src = ctx.op_cache.get(key)
    if src is None:
        import torch

        rows = np.full((len(perms), ctx.size), -1, np.int32)
        for r, perm in enumerate(perms):
            for s, d in perm:
                rows[r, d] = s
        src = ctx.op_cache[key] = (rows if ctx.process_count > 1
                                   else torch.from_numpy(rows).to(ctx.device))
    return src


def _exchange_lane(ctx, tags: np.ndarray, src) -> np.ndarray:
    """The delivered tags ``[n_rounds, size, 3]`` of the stamps ``tags
    [size, n_rounds, 3]``. Across processes each process ships its rows'
    stamps (:func:`~bluefog_tpu_torch.collective.inner.lineage_exchange`)
    and the delivered rows of every process come back through one
    :func:`~bluefog_tpu_torch.collective.transport.gather_rows`, so every
    process folds the fleet's ages, bitwise the stacked lane's."""
    import torch

    from bluefog_tpu_torch.collective import inner, transport

    n_rounds = src.shape[0]
    sent = np.ascontiguousarray(tags[ctx.rows.start:ctx.rows.stop].transpose(1, 0, 2))
    out = inner.lineage_exchange(torch.from_numpy(sent).to(ctx.device), src)
    if ctx.process_count == 1:
        return out.cpu().numpy()
    rows = out.transpose(0, 1).reshape(ctx.n_local, -1).contiguous()
    full = transport.gather_rows(rows, ctx).cpu().numpy()
    return full.reshape(ctx.size, n_rounds, -1).transpose(1, 0, 2)


def _chaos_holds() -> Dict:
    """The active elastic session's stall holds, ``{(src, dst) | rank:
    extra_steps}`` (empty without a session)."""
    from bluefog_tpu_torch import elastic as elastic_mod

    session = elastic_mod.active_session()
    if session is None:
        return {}
    return session.simulated_stale_steps()


def _suspect_faults() -> List[Any]:
    """A breach's corroborating suspects: the doctor's join
    (:func:`bluefog_tpu_torch.attribution.suspect_join`) with the stall
    holds."""
    from bluefog_tpu_torch.attribution import suspect_join

    return suspect_join(include_stall_holds=True)


# -- the observatory session --------------------------------------------------


class StalenessObservatory:
    """One staleness session, built by :func:`start` (or by ``init`` under
    ``BLUEFOG_STALENESS=1``), fed by :func:`observe_step` after every
    communicating dispatch and by :func:`observe_window`."""

    def __init__(self, interval: Optional[int] = None, bound: Optional[int] = None,
                 history: int = 512):
        self.interval = int(interval) if interval else staleness_interval()
        self.bound = int(bound) if bound else staleness_bound()
        self._count = 0  # communicating steps observed
        # per-window observation clocks: a shared counter would alias the
        # modulo across windows
        self._wcounts: Dict[str, int] = {}
        self.samples: collections.deque = collections.deque(maxlen=history)
        self.advisories: List[Any] = []
        self.advisory_marks: List[int] = []
        self._breach_mutes: Dict[Tuple[str, Tuple[int, int]], int] = {}
        # the per-edge ages of the current (topo_version, live_token)
        self._age_key: Optional[tuple] = None
        self.edge_ages: Dict[Tuple[int, int], Dict[str, float]] = {}
        self._edge_series: set = set()
        self._last_gossip_mean: Optional[float] = None
        self._last_gossip_max: Optional[float] = None
        self._last_window_max: Optional[float] = None

    def last_age_mean(self) -> Optional[float]:
        """Mean delivered age of the latest gossip sample (None before one)."""
        return self._last_gossip_mean

    def last_age_max(self) -> float:
        """Worst delivered age on record across the surfaces (0.0 before a
        sample)."""
        vals = [v for v in (self._last_gossip_max, self._last_window_max) if v is not None]
        return float(max(vals)) if vals else 0.0

    def _unmuted_breaches(self, surface_kind: str,
                          ages: Dict[Tuple[int, int], int]) -> List[Tuple[int, int]]:
        """The edges past the bound that are not muted, worst first; they
        are muted for :data:`BREACH_COOLDOWN` samples of this surface."""
        for k in list(self._breach_mutes):
            if k[0] == surface_kind:
                self._breach_mutes[k] -= 1
                if self._breach_mutes[k] <= 0:
                    del self._breach_mutes[k]
        breached = sorted((e for e, a in ages.items() if a > self.bound),
                          key=lambda e: (-ages[e], e))
        out = [e for e in breached if (surface_kind, e) not in self._breach_mutes]
        for e in out:
            self._breach_mutes[(surface_kind, e)] = BREACH_COOLDOWN
        return out

    def observe(self, ctx, *, step: int, plan=None, payload_age: int = 0,
                surface: str = "sync") -> Optional[dict]:
        """Called once per communicating step; a step with no worker-axis
        edge set (allreduce, hierarchical) takes no sample slot."""
        if plan is None or not getattr(plan, "perms", None):
            return None
        sampled = self._count % self.interval == 0
        self._count += 1
        if not sampled:
            return None
        return self._sample(ctx, step=step, plan=plan, payload_age=int(payload_age),
                            surface=surface)

    def _reset_if_remapped(self, ctx) -> None:
        key = (ctx.topo_version, ctx.live_token())
        if self._age_key != key:
            # a repair or topology swap renames the edges
            self._age_key = key
            self.edge_ages = {}
            self._breach_mutes = {}

    def _sample(self, ctx, *, step, plan, payload_age, surface) -> dict:
        from bluefog_tpu_torch import flight as flight_mod
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch import scaling

        self._reset_if_remapped(ctx)
        t_now = self._count
        perms = tuple(plan.perms)
        n_rounds = len(perms)
        holds = _chaos_holds()
        tok = ctx.live_token()
        epoch = int(tok[0]) if tok else 0

        # stamp [size, rounds, 3]: the birth held back by the payload's age
        # and any stall hold on the sending edge
        size = ctx.size
        tags = np.zeros((size, max(n_rounds, 1), 3), np.int32)
        tags[:, :, 0] = t_now - payload_age
        tags[:, :, 1] = ctx.topo_version
        tags[:, :, 2] = epoch
        if holds:
            for r, perm in enumerate(perms):
                for s, d in perm:
                    h = holds.get((s, d), holds.get(s, 0))
                    if h:
                        tags[s, r, 0] = t_now - payload_age - int(h)

        out = _exchange_lane(ctx, tags[:, :n_rounds], _lane_sources(ctx, perms))

        ages: Dict[Tuple[int, int], int] = {}
        mismatches = 0
        for r, perm in enumerate(perms):
            for s, d in perm:
                got = out[r, d]
                ages[(s, d)] = t_now - int(got[0])
                if int(got[1]) != ctx.topo_version or int(got[2]) != epoch:
                    mismatches += 1
        expected = {
            (s, d): payload_age + int(holds.get((s, d), holds.get(s, 0)) if holds else 0)
            for perm in perms for s, d in perm
        }
        lane_ok = all(ages[e] == expected[e] for e in ages) and not mismatches
        if not lane_ok:
            metrics_mod.counter("bluefog.staleness.selfcheck_failures").inc()

        age_vals = list(ages.values())
        age_mean = float(np.mean(age_vals)) if age_vals else 0.0
        age_max = float(max(age_vals)) if age_vals else 0.0
        max_edge = max(ages, key=lambda e: (ages[e], e)) if ages else None
        self._last_gossip_mean = age_mean
        self._last_gossip_max = age_max

        hist = metrics_mod.histogram("bluefog.staleness.age")
        for (s, d), a in sorted(ages.items()):
            hist.observe(a)
            name = f"bluefog.staleness.edge_age.{s}_{d}"
            if name in self._edge_series or len(self._edge_series) < MAX_EDGE_SERIES:
                self._edge_series.add(name)
                metrics_mod.histogram(name).observe(a)
            rec = self.edge_ages.setdefault((s, d), {"last": 0.0, "max": 0.0, "n": 0})
            rec["last"] = float(a)
            rec["max"] = max(rec["max"], float(a))
            rec["n"] += 1
        metrics_mod.gauge("bluefog.staleness.age_mean").set(age_mean)
        metrics_mod.gauge("bluefog.staleness.age_max").set(age_max)
        metrics_mod.counter("bluefog.staleness.samples").inc()
        sidecar = scaling.wire_payload_bytes(0, 0, lineage=True)
        metrics_mod.counter("bluefog.staleness.wire_bytes").inc(sidecar * n_rounds)

        sample: Dict[str, Any] = {
            "kind": "sample",
            "surface": surface,
            "step": int(step),
            "comm_steps": t_now,
            "topo_version": int(ctx.topo_version),
            "live_epoch": epoch,
            "payload_age": payload_age,
            "rounds": n_rounds,
            "edges": len(ages),
            "age_mean": round(age_mean, 4),
            "age_max": age_max,
            "lane_ok": lane_ok,
            "lineage_bytes_per_round": sidecar,
        }
        if max_edge is not None:
            sample["max_edge"] = [int(max_edge[0]), int(max_edge[1])]
        if holds:
            sample["chaos_holds"] = {str(k): int(v) for k, v in sorted(holds.items(), key=str)}
        if mismatches:
            sample["provenance_mismatches"] = mismatches

        breached = self._unmuted_breaches("gossip", ages)
        if breached:
            from bluefog_tpu_torch.attribution import Advisory

            adv = Advisory(
                kind="staleness_breach", step=int(step),
                detail={
                    "edges": [[int(s), int(d)] for s, d in breached[:8]],
                    "ages": {f"{s}->{d}": int(ages[(s, d)]) for s, d in breached[:8]},
                    "age_max": age_max,
                    "bound": self.bound,
                    "surface": surface,
                    "payload_age": payload_age,
                    "topo_version": int(ctx.topo_version),
                    "suspect_faults": _suspect_faults(),
                },
            )
            sample["advisories"] = [adv.to_json()]
            self._emit(adv)

        flight_mod.record("staleness", surface=surface, age_max=age_max,
                          age_mean=round(age_mean, 4), edges=len(ages), lane_ok=lane_ok)
        self.samples.append(sample)
        self._export_line(sample)
        return sample

    def observe_window(self, ctx, win, step: Optional[int] = None,
                       surface: str = "window") -> Optional[dict]:
        """Fold one window's host age lane on the window's own sampling
        clock (``win_update``, the window optimizers, and the asynchronous
        engine with ``surface="async"``)."""
        wname = getattr(win, "name", "?")
        count = self._wcounts.get(wname, 0)
        self._wcounts[wname] = count + 1
        if count % self.interval != 0:
            return None
        from bluefog_tpu_torch import metrics as metrics_mod

        self._reset_if_remapped(ctx)
        clock = int(getattr(win, "clock", 0))
        slot_written = getattr(win, "slot_written", None)
        if slot_written is None:
            return None
        ages: Dict[Tuple[int, int], int] = {}
        mass_ages: Dict[Tuple[int, int], int] = {}
        mass_birth = getattr(win, "mass_birth", None)
        for r, srcs in enumerate(win.in_neighbors):
            for k, s in enumerate(srcs):
                ages[(int(s), int(r))] = clock - int(slot_written[r, k])
                if mass_birth is not None and mass_birth[r, k] >= 0:
                    mass_ages[(int(s), int(r))] = clock - int(mass_birth[r, k])
        if not ages:
            return None
        vals = list(ages.values())
        age_mean = float(np.mean(vals))
        age_max = float(max(vals))
        self._last_window_max = age_max
        hist = metrics_mod.histogram("bluefog.staleness.window_age")
        for a in vals:
            hist.observe(a)
        metrics_mod.gauge("bluefog.staleness.window_age_max").set(age_max)
        if mass_ages:
            metrics_mod.gauge("bluefog.staleness.window_mass_age_max").set(
                float(max(mass_ages.values())))
        sample: Dict[str, Any] = {
            "kind": "sample",
            "surface": surface,
            "window": win.name,
            "step": int(step) if step is not None else clock,
            "window_clock": clock,
            "edges": len(ages),
            "age_mean": round(age_mean, 4),
            "age_max": age_max,
        }
        if mass_ages:
            sample["mass_age_max"] = float(max(mass_ages.values()))
        breached = self._unmuted_breaches(surface, ages)
        if breached:
            from bluefog_tpu_torch.attribution import Advisory

            adv = Advisory(
                kind="staleness_breach",
                step=int(step) if step is not None else clock,
                detail={
                    "edges": [[int(s), int(d)] for s, d in breached[:8]],
                    "ages": {f"{s}->{d}": int(ages[(s, d)]) for s, d in breached[:8]},
                    "age_max": age_max,
                    "bound": self.bound,
                    "surface": surface,
                    "window": win.name,
                    "suspect_faults": _suspect_faults(),
                },
            )
            sample["advisories"] = [adv.to_json()]
            self._emit(adv)
        self.samples.append(sample)
        self._export_line(sample)
        return sample

    # -- emission -------------------------------------------------------------

    def _emit(self, adv) -> None:
        """One advisory on the doctor's counter, the flight side table, the
        timeline and the staleness JSONL."""
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

    def report(self) -> dict:
        """The dump ``tools/staleness_report.py`` reads."""
        return {
            "kind": "staleness_dump",
            "interval": self.interval,
            "bound": self.bound,
            "comm_steps": self._count,
            "window_observations": sum(self._wcounts.values()),
            "samples": list(self.samples),
            "advisories": [a.to_json() for a in self.advisories],
            "edge_ages": {f"{s}->{d}": dict(rec)
                          for (s, d), rec in sorted(self.edge_ages.items())},
            "age_mean": self._last_gossip_mean,
            "age_max": self.last_age_max(),
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.report(), f)
        return path


# -- module-level session -----------------------------------------------------

_observatory: Optional[StalenessObservatory] = None


def start(interval: Optional[int] = None, **kwargs) -> StalenessObservatory:
    """Open a staleness session (replacing any active one)."""
    global _observatory
    _observatory = StalenessObservatory(interval=interval, **kwargs)
    return _observatory


def stop() -> None:
    global _observatory
    _observatory = None


def activate(obs: Optional[StalenessObservatory]) -> Optional[StalenessObservatory]:
    """Install (or clear, with None) a session without resetting it."""
    global _observatory
    _observatory = obs
    return obs


def active() -> Optional[StalenessObservatory]:
    return _observatory


def observe_step(ctx, *, step: int, plan=None, payload_age: int = 0,
                 surface: str = "sync") -> None:
    """The optimizers' hook after every communicating dispatch."""
    obs = _observatory
    if obs is None:
        return
    obs.observe(ctx, step=step, plan=plan, payload_age=payload_age, surface=surface)


def observe_window(ctx, win, step: Optional[int] = None, surface: str = "window") -> None:
    """The window layer's and the asynchronous engine's hook."""
    obs = _observatory
    if obs is None:
        return
    obs.observe_window(ctx, win, step=step, surface=surface)


def dump(path: str) -> Optional[str]:
    """Write the active session's dump (None without a session)."""
    obs = _observatory
    if obs is None:
        return None
    return obs.dump(path)


def on_init(ctx) -> None:
    """``init`` hook: a fresh session under ``BLUEFOG_STALENESS=1``."""
    if enabled():
        start()
    else:
        stop()


def on_shutdown() -> None:
    """``shutdown`` hook: the JSONL's closing line, and the session dropped."""
    obs = _observatory
    if obs is not None and obs.samples:
        obs._export_line({"kind": "session_end", "comm_steps": obs._count})
    stop()
