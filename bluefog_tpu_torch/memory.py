# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Memory observatory (``bft.memory``): device and host memory accounting,
the analytic-against-measured reconciliation of the optimizer state, and
OOM forensics.

Counterpart of ``bluefog_tpu/memory.py``; the names, knobs, categories,
advisories and metric series are the JAX module's.

**Sampling discipline.** One communicating step in
``BLUEFOG_MEMORY_INTERVAL`` is a sample. The observatory is host-side (a
census of the trees the optimizer hands it, the CUDA allocator's counters
and the host RSS): unsampled and sampled steps run the code they run with
the observatory off.

**Per sample:**

- **census** (:func:`census`): the bytes of each owner category
  (:data:`CATEGORIES`) from the trees the optimizer hands the hook:
  ``params``, ``opt_state`` (a ``ShardedOptState``'s slots included),
  ``grads`` (the gradient tree and the ``"grad"`` order's accumulator),
  ``residuals`` (the CHOCO copies ``_ef`` and the scatter's
  ``_scatter_ef``), ``delay`` (``_delay_buf``) and ``windows`` (every
  window of the registry). PyTorch has no list of live arrays: a tensor is
  identified by its storage (``untyped_storage().data_ptr()``), counted
  once with its storage's bytes, since the port's leaves are often views
  of one packed buffer; the map is built anew each sample, as a re-shard
  re-points a leaf with ``Tensor.set_``. ``other`` is the CUDA
  allocator's allocated bytes (:func:`device_bytes_in_use`) less the
  classified bytes, clamped at 0, on the card, and 0 on the CPU.
- **reconciliation**: the census's per-worker ``opt_state`` bytes
  against :func:`bluefog_tpu_torch.scaling.optimizer_state_bytes` for the
  active shard layout; a residual past ``BLUEFOG_MEMORY_DRIFT_TOL``
  (default 10 %) for :data:`DRIFT_STREAK` samples files ``memory_drift``.
- **watermark and headroom**: with a per-worker budget
  (``BLUEFOG_MEMORY_BUDGET`` bytes), headroom below the predicted next
  watermark files ``memory_pressure``, whose ``shard_hint`` says when
  ``BLUEFOG_SHARD=1`` would buy the optimizer state back.
- **phase watermarks**: :func:`phase_scope` around each optimizer
  dispatch (``dispatch``) and ``checkpoint.save`` (``checkpoint_save``)
  records the host RSS peak. The JAX ``compile`` phase has no eager
  counterpart (PyTorch builds no program), as ``bluefog.recompiles`` has
  none.

**OOM forensics.** An uncaught ``MemoryError``, ``torch.OutOfMemoryError``
(a ``RuntimeError`` whose message says "CUDA out of memory") or an error
carrying ``RESOURCE_EXHAUSTED`` runs :func:`on_oom` through the crash hook
installed beside the flight recorder's: a ranked census from the last
sample, an ``oom`` flight event and advisory, and a flight dump. The
elastic ``oom`` fault runs the same path and raises
:class:`SimulatedResourceExhausted`. ``tools/memory_report.py`` rebuilds
the postmortem from the dump.

**Across processes** each process takes the census of its own rows and
one ``all_gather_object`` a sample sums the processes' censuses by
category, so the census, its ranked form and the reconciliation are the
fleet's (their byte counts the stacked census's) in every process, and an
``oom`` fault's forensics record is the same in every process. The
allocator fields (``device_bytes_in_use``, the measured footprint a worker,
the peak and the headroom) stay the process's own, over its own
``allocator_workers`` workers; on one card shared by several processes the
allocator's counters are still each process's. The SLO engine's
``memory_headroom`` objective reads :meth:`MemoryObservatory.fleet_headroom`,
the least headroom of any process.

The footprint and the headroom are the ``mem_bytes_per_rank`` and
``mem_headroom`` slots of the health plane's fleet lane, and the
observatory's summary is the ``memory`` block of its ``/fleet`` report
(:mod:`bluefog_tpu_torch.health`). The topology controller's decision
records carry ``memory_pressure`` from :meth:`MemoryObservatory.pressure_active`
(:func:`bluefog_tpu_torch.autotune._memory_pressure`).

Knobs: ``BLUEFOG_MEMORY=1`` (default off), ``BLUEFOG_MEMORY_INTERVAL``
(default 20), ``BLUEFOG_MEMORY_BUDGET`` (bytes a worker; 0 / unset: no
gate), ``BLUEFOG_MEMORY_DRIFT_TOL`` (default 0.10),
``BLUEFOG_MEMORY_FILE`` (JSONL samples and advisories).
"""

import collections
import contextlib
import json
import os
import sys
from typing import Any, Dict, List, Optional

__all__ = [
    "MemoryObservatory",
    "SimulatedResourceExhausted",
    "CATEGORIES",
    "enabled",
    "memory_interval",
    "memory_budget",
    "drift_tolerance",
    "device_bytes_in_use",
    "host_peak_rss_bytes",
    "census",
    "ranked_census",
    "phase_scope",
    "start",
    "stop",
    "activate",
    "active",
    "observe_step",
    "on_oom",
    "dump",
    "on_init",
    "on_shutdown",
]

ENABLE_ENV = "BLUEFOG_MEMORY"
INTERVAL_ENV = "BLUEFOG_MEMORY_INTERVAL"
BUDGET_ENV = "BLUEFOG_MEMORY_BUDGET"
DRIFT_TOL_ENV = "BLUEFOG_MEMORY_DRIFT_TOL"
FILE_ENV = "BLUEFOG_MEMORY_FILE"

# The owner categories, in ranking-tiebreak order. "wire_temp" is the JAX
# package's compiled-program scratch, which no census fills.
CATEGORIES = (
    "params", "opt_state", "grads", "residuals", "delay", "windows",
    "wire_temp", "other",
)

# consecutive drifted samples before memory_drift fires
DRIFT_STREAK = 2
# samples a fired memory_pressure / memory_drift stays muted
ADVISORY_COOLDOWN = 8
# the predicted next watermark: EWMA mean + this many deviations
WATERMARK_MADS = 3.0


class SimulatedResourceExhausted(MemoryError):
    """The elastic ``oom`` fault's stand-in for an allocation failure: a
    ``MemoryError`` whose message carries ``RESOURCE_EXHAUSTED``."""

    def __init__(self, detail: str = ""):
        super().__init__(
            "RESOURCE_EXHAUSTED: simulated allocation failure"
            + (f" ({detail})" if detail else "")
        )


def enabled() -> bool:
    """``BLUEFOG_MEMORY=1`` (default off). The OOM hooks do not depend on
    it: they install whenever the flight recorder has a dump directory."""
    return os.environ.get(ENABLE_ENV, "0").lower() in ("1", "true", "on", "yes")


def memory_interval() -> int:
    """Sampling period in communicating steps (``BLUEFOG_MEMORY_INTERVAL``,
    default 20)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int(INTERVAL_ENV, 20))


def memory_budget() -> int:
    """Per-worker budget in bytes (``BLUEFOG_MEMORY_BUDGET``; 0 / unset
    disables the headroom gate)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(0, env_int(BUDGET_ENV, 0))


def drift_tolerance() -> float:
    """Relative reconciliation tolerance (``BLUEFOG_MEMORY_DRIFT_TOL``,
    default 0.10)."""
    from bluefog_tpu_torch.logging_util import env_float

    tol = env_float(DRIFT_TOL_ENV, 0.10)
    return tol if tol > 0 else 0.10


# -- measurement primitives ---------------------------------------------------


def _device_of(ctx):
    if ctx is not None:
        return ctx.device
    from bluefog_tpu_torch import context as ctx_mod

    c = ctx_mod._context
    return c.device if c is not None else None


def device_bytes_in_use(ctx=None) -> Optional[int]:
    """The CUDA caching allocator's allocated bytes on the context's card
    (``allocated_bytes.all.current``, not the reserved pool); None on the
    CPU."""
    device = _device_of(ctx)
    if device is None or device.type != "cuda":
        return None
    import torch

    return int(torch.cuda.memory_stats(device).get("allocated_bytes.all.current", 0))


def host_peak_rss_bytes() -> int:
    """Peak resident set size of this process in bytes (0 where
    unavailable)."""
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return 0


def _tensors(tree):
    """The tensors of a (nested) tuple, list, dict or NamedTuple; None and
    other leaves are skipped."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def census(owners: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """Bytes and tensor counts by owner category.

    ``owners`` maps a category to a tree of tensors. A storage is counted
    once, with all its bytes, under the first category that holds a view
    of it. ``other`` is the context's card's allocated bytes less the
    classified bytes, clamped at 0 (:func:`device_bytes_in_use`), and 0 on
    the CPU. Every category is present, zeros included."""
    seen = set()
    out = {c: {"bytes": 0, "arrays": 0} for c in CATEGORIES}
    for cat, tree in owners.items():
        rec = out.setdefault(cat, {"bytes": 0, "arrays": 0})
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = (str(t.device), st.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            rec["bytes"] += int(st.nbytes())
            rec["arrays"] += 1
    dev_bytes = device_bytes_in_use()
    if dev_bytes is not None:
        classified = sum(rec["bytes"] for c, rec in out.items() if c != "other")
        out["other"]["bytes"] = max(dev_bytes - classified, 0)
    return out


def ranked_census(c: Optional[Dict[str, Dict[str, int]]] = None) -> List[dict]:
    """The census as a list, largest owner first; with no argument the
    active observatory's last census (or an empty one)."""
    if c is None:
        obs = _observatory
        c = obs.last_census if obs is not None else None
        if c is None:
            c = census({})
    rows = [
        {"category": cat, "bytes": rec["bytes"], "arrays": rec["arrays"]}
        for cat, rec in c.items() if rec["arrays"] or rec["bytes"]
    ]
    rows.sort(key=lambda r: (-r["bytes"], r["category"]))
    return rows


# -- phase watermarks ---------------------------------------------------------


@contextlib.contextmanager
def phase_scope(name: str):
    """Bracket one phase (``dispatch``, ``checkpoint_save``) for the host
    RSS watermark; one global read without a session. It never touches a
    device value (and leaves the CUDA allocator's peak counters alone)."""
    obs = _observatory
    if obs is None:
        yield
        return
    rss0 = host_peak_rss_bytes()
    try:
        yield
    finally:
        obs._note_phase(name, rss0)


# -- the observatory session --------------------------------------------------


class MemoryObservatory:
    """One memory session, built by :func:`start` (or by ``init`` under
    ``BLUEFOG_MEMORY=1``), fed by :func:`observe_step` after every
    communicating dispatch."""

    def __init__(self, interval: Optional[int] = None, budget: Optional[int] = None,
                 drift_tol: Optional[float] = None, history: int = 512):
        from bluefog_tpu_torch.attribution import BaselineTracker

        self.interval = int(interval) if interval else memory_interval()
        self.budget = int(budget) if budget is not None else memory_budget()
        self.drift_tol = float(drift_tol) if drift_tol else drift_tolerance()
        self._count = 0  # communicating steps observed
        self.samples: collections.deque = collections.deque(maxlen=history)
        self.advisories: List[Any] = []
        self.last_census: Optional[Dict[str, Dict[str, int]]] = None
        self._peak_tracker = BaselineTracker()
        self._drift_streak = 0
        self._mutes: Dict[str, int] = {}  # advisory kind -> samples muted
        self.phase_peaks: Dict[str, Dict[str, float]] = {}
        self._peak_bytes = 0.0
        self._last_total = 0.0
        self._last_per_rank = 0.0
        self._last_headroom: Optional[float] = None
        self._fleet_headroom: Optional[float] = None
        self._analytic_cache: Optional[tuple] = None
        self._last_step = 0
        self.oom_events = 0

    def last_bytes_per_rank(self) -> float:
        """Measured bytes a worker at the latest sample (0.0 before one)."""
        return self._last_per_rank

    def last_headroom(self) -> float:
        """Budget less the bytes a worker at the latest sample (0.0
        without a budget)."""
        h = self._last_headroom
        return float(h) if h is not None else 0.0

    def _note_phase(self, name: str, rss0: int) -> None:
        from bluefog_tpu_torch import metrics as metrics_mod

        rss1 = host_peak_rss_bytes()
        rec = self.phase_peaks.setdefault(
            name, {"peak_rss_bytes": 0.0, "rss_growth_bytes": 0.0, "count": 0})
        rec["peak_rss_bytes"] = max(rec["peak_rss_bytes"], float(rss1))
        rec["rss_growth_bytes"] += float(max(rss1 - rss0, 0))
        rec["count"] += 1
        metrics_mod.gauge(f"bluefog.memory.phase_peak_bytes.{name}").set(rec["peak_rss_bytes"])

    def _tick_mutes(self) -> None:
        """Advance the cooldowns by one sample."""
        for k in list(self._mutes):
            self._mutes[k] -= 1
            if self._mutes[k] <= 0:
                del self._mutes[k]

    def _unmuted(self, kind: str) -> bool:
        if kind in self._mutes:
            return False
        self._mutes[kind] = ADVISORY_COOLDOWN
        return True

    def pressure_active(self) -> bool:
        """Whether a ``memory_pressure`` advisory is inside its cooldown."""
        return "memory_pressure" in self._mutes

    def observe(self, ctx, *, step: int, optimizer=None, params=None, opt_state=None,
                grads=None) -> Optional[dict]:
        """Called once per communicating step; a sampled step takes the
        census and reconciles it."""
        sampled = self._count % self.interval == 0
        self._count += 1
        self._last_step = int(step)
        if not sampled:
            return None
        return self._sample(ctx, step=step, optimizer=optimizer, params=params,
                            opt_state=opt_state, grads=grads)

    def _owner_trees(self, ctx, optimizer, params, opt_state, grads=None) -> Dict:
        owners: Dict[str, Any] = {}
        if params is not None:
            owners["params"] = params
        if opt_state is not None:
            owners["opt_state"] = opt_state
        grad_trees = []
        if grads is not None:
            grad_trees.append(grads)
        if optimizer is not None:
            ef = getattr(optimizer, "_ef", None)
            scatter_ef = getattr(optimizer, "_scatter_ef", None)
            if ef or scatter_ef:
                owners["residuals"] = (ef or (), scatter_ef or ())
            buf = getattr(optimizer, "_delay_buf", None)
            if buf:
                owners["delay"] = buf
            accum = getattr(optimizer, "_grad_accum", None)
            if accum is not None:
                grad_trees.append(accum)
        if grad_trees:
            owners["grads"] = grad_trees
        wins = getattr(ctx, "windows", None)
        if wins:
            owners["windows"] = [(w.value, w.buffers, w.versions, w.p, w.p_buffers)
                                 for w in wins.values()]
        return owners

    def _analytic_state_bytes(self, ctx, optimizer, params, opt_state) -> Optional[int]:
        """The analytic per-worker optimizer state for the active shard
        layout (None with nothing to price), cached on the parameters'
        shapes and dtypes and the layout's signature."""
        if optimizer is None or params is None or getattr(optimizer, "tx", None) is None:
            return None
        from bluefog_tpu_torch import scaling
        from bluefog_tpu_torch.optimizers import tree_leaves

        layout = getattr(optimizer, "_shard_layout", None)
        key = (
            tuple((tuple(l.shape), str(l.dtype)) for l in tree_leaves(params)),
            layout.sig() if layout is not None else None,
            id(optimizer.tx),
        )
        cached = self._analytic_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        if layout is not None:
            val = scaling.optimizer_state_bytes(params, optimizer, shard=True,
                                                master=layout.master, live=layout.live)
        else:
            val = scaling.optimizer_state_bytes(params, optimizer)
        self._analytic_cache = (key, val)
        return val

    def _fleet_census(self, ctx, c, dev_bytes):
        """Across processes: the fleet census, every process's census
        summed by category (bytes and storages), and each process's
        allocator bytes, in process order (one ``all_gather_object``). With
        one process ``(c, [dev_bytes])``."""
        if getattr(ctx, "process_count", 1) == 1:
            return c, [dev_bytes]
        from bluefog_tpu_torch.collective import transport

        views = transport.gather_objects((c, dev_bytes), ctx)
        fleet = {cat: {"bytes": 0, "arrays": 0} for cat in CATEGORIES}
        for view, _dev in views:
            for cat, rec in view.items():
                out = fleet.setdefault(cat, {"bytes": 0, "arrays": 0})
                out["bytes"] += int(rec["bytes"])
                out["arrays"] += int(rec["arrays"])
        return fleet, [dev for _view, dev in views]

    def fleet_headroom(self) -> Optional[float]:
        """The least headroom of any process at the latest sample (None
        before a sample under a budget): across processes the value the SLO
        engine's ``memory_headroom`` objective reads, the same in every
        process; with one process :meth:`last_headroom`'s."""
        return self._fleet_headroom

    def _sample(self, ctx, *, step, optimizer, params, opt_state, grads=None) -> dict:
        from bluefog_tpu_torch import flight as flight_mod
        from bluefog_tpu_torch import metrics as metrics_mod

        self._tick_mutes()
        owners = self._owner_trees(ctx, optimizer, params, opt_state, grads=grads)
        dev_bytes = device_bytes_in_use(ctx)
        c, devs = self._fleet_census(ctx, census(owners), dev_bytes)
        self.last_census = c
        total = float(sum(rec["bytes"] for rec in c.values()))
        size = max(int(getattr(ctx, "size", 1)), 1)
        per_rank = total / size
        # the allocator's bytes are this process's, over its own workers
        n_local = max(int(getattr(ctx, "n_local", size)), 1)
        measured_per_rank = dev_bytes / n_local if dev_bytes is not None else per_rank
        self._last_total = total
        self._last_per_rank = measured_per_rank
        self._peak_bytes = max(self._peak_bytes, measured_per_rank)

        metrics_mod.counter("bluefog.memory.samples").inc()
        metrics_mod.gauge("bluefog.memory.live_bytes").set(total)
        for cat in CATEGORIES:
            if cat == "wire_temp":
                continue
            metrics_mod.gauge(f"bluefog.memory.live_bytes.{cat}").set(
                c.get(cat, {}).get("bytes", 0))
        metrics_mod.gauge("bluefog.memory.peak_bytes").set(self._peak_bytes)
        metrics_mod.gauge("bluefog.memory.host_rss_bytes").set(host_peak_rss_bytes())

        measured_state = c.get("opt_state", {}).get("bytes", 0) / size
        analytic_state = self._analytic_state_bytes(ctx, optimizer, params, opt_state)
        rel_err = None
        if analytic_state:
            rel_err = abs(measured_state - analytic_state) / analytic_state
            metrics_mod.gauge("bluefog.memory.drift_bytes").set(measured_state - analytic_state)

        sample: Dict[str, Any] = {
            "kind": "sample",
            "step": int(step),
            "comm_steps": self._count,
            "live_bytes_total": int(total),
            "live_bytes_per_rank": int(per_rank),
            "device_bytes_in_use": dev_bytes,
            # the allocator fields' scope: this process's workers
            "allocator_workers": n_local,
            "measured_source": ("device_memory_stats" if dev_bytes is not None
                                else "live_array_census"),
            "host_peak_rss_bytes": host_peak_rss_bytes(),
            "census": {cat: dict(rec) for cat, rec in c.items()
                       if rec["arrays"] or rec["bytes"]},
            "peak_bytes_per_rank": int(self._peak_bytes),
        }
        if analytic_state is not None:
            sample["measured_state_bytes"] = int(measured_state)
            sample["analytic_state_bytes"] = int(analytic_state)
            sample["reconcile_rel_err"] = round(rel_err, 6) if rel_err is not None else None

        if rel_err is not None and rel_err > self.drift_tol:
            self._drift_streak += 1
        else:
            self._drift_streak = 0
        if self._drift_streak >= DRIFT_STREAK and self._unmuted("memory_drift"):
            self._advise("memory_drift", step, {
                "measured_state_bytes": int(measured_state),
                "analytic_state_bytes": int(analytic_state),
                "rel_err": round(rel_err, 6),
                "tolerance": self.drift_tol,
                "streak": self._drift_streak,
                "census": ranked_census(c)[:4],
            }, sample)

        z = self._peak_tracker.update(measured_per_rank)
        if self.budget:
            headroom = float(self.budget) - measured_per_rank
            self._last_headroom = headroom
            counts = getattr(ctx, "worker_counts", (size,))
            self._fleet_headroom = min(
                float(self.budget) - (dev / counts[p] if dev is not None else per_rank)
                for p, dev in enumerate(devs))
            metrics_mod.gauge("bluefog.memory.headroom_bytes").set(headroom)
            tr = self._peak_tracker
            predicted_next = max(float(tr.mean or measured_per_rank)
                                 + WATERMARK_MADS * float(tr.mad), 0.0)
            sample["headroom_bytes"] = int(headroom)
            sample["predicted_next_watermark"] = int(predicted_next)
            pressed = headroom <= 0 or (float(self.budget) - predicted_next) <= 0
            if pressed and self._unmuted("memory_pressure"):
                from bluefog_tpu_torch import sharding

                shard_on = sharding.enabled()
                state_frac = measured_state / measured_per_rank if measured_per_rank else 0.0
                self._advise("memory_pressure", step, {
                    "budget_bytes": self.budget,
                    "bytes_per_rank": int(measured_per_rank),
                    "headroom_bytes": int(headroom),
                    "predicted_next_watermark": int(predicted_next),
                    "z": round(float(z), 3),
                    "census": ranked_census(c)[:4],
                    # BLUEFOG_SHARD=1 shrinks the optimizer state to 1/N:
                    # the hint names the knob exactly when it would help
                    "shard_hint": bool(not shard_on and state_frac >= 0.25),
                    "opt_state_fraction": round(state_frac, 4),
                    "shard_enabled": bool(shard_on),
                }, sample)
        if self.phase_peaks:
            sample["phase_peaks"] = {k: dict(v) for k, v in sorted(self.phase_peaks.items())}

        flight_mod.record("memory", live_bytes=int(total), per_rank=int(measured_per_rank),
                          headroom=sample.get("headroom_bytes"))
        self.samples.append(sample)
        self._export_line(sample)
        return sample

    # -- OOM forensics --------------------------------------------------------

    def note_oom(self, reason: str, message: str = "") -> List[dict]:
        """The forensics: ranked census (of the last sample), counter,
        flight event and advisory, timeline instant, JSONL line and flight
        dump. Returns the ranked census; never raises."""
        from bluefog_tpu_torch import flight as flight_mod
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch import timeline as tl

        self.oom_events += 1
        ranked = ranked_census(self.last_census)
        try:
            metrics_mod.counter("bluefog.memory.oom_events").inc()
            detail = {
                "reason": reason,
                "message": message[:300],
                "ranked_census": ranked,
                "top_category": ranked[0]["category"] if ranked else None,
                "bytes_per_rank": int(self._last_per_rank),
                "budget_bytes": self.budget or None,
                "host_peak_rss_bytes": host_peak_rss_bytes(),
            }
            flight_mod.record("oom", reason=reason, top_category=detail["top_category"])
            flight_mod.note_advisory(kind="oom", step=self._last_step, **detail)
            tl.timeline_record_advisory("oom", {"reason": reason})
            self._export_line({"kind": "advisory", "advisory_kind": "oom",
                               "step": self._last_step, **detail})
            flight_mod.maybe_dump(f"oom:{reason}")
        except Exception:  # forensics must not take the process down further
            pass
        return ranked

    def _advise(self, kind: str, step: int, detail: dict, sample: dict) -> None:
        """One advisory on the doctor's counter, the flight side table, the
        timeline and the memory JSONL."""
        from bluefog_tpu_torch import flight as flight_mod
        from bluefog_tpu_torch import metrics as metrics_mod
        from bluefog_tpu_torch import timeline as tl
        from bluefog_tpu_torch.attribution import Advisory

        adv = Advisory(kind=kind, step=int(step), detail=detail)
        self.advisories.append(adv)
        metrics_mod.counter(f"bluefog.doctor.advisory.{kind}").inc()
        metrics_mod.gauge("bluefog.doctor.last_advisory_step").set(adv.step)
        flight_mod.note_advisory(kind=kind, step=adv.step, **detail)
        tl.timeline_record_advisory(kind, detail)
        sample.setdefault("advisories", []).append(adv.to_json())
        self._export_line({"kind": "advisory", "advisory_kind": kind, "step": adv.step,
                           **detail})

    def _export_line(self, obj: dict) -> None:
        path = os.environ.get(FILE_ENV)
        if path:
            from bluefog_tpu_torch.logging_util import append_jsonl

            append_jsonl(FILE_ENV, path, obj)

    def report(self) -> dict:
        """The dump ``tools/memory_report.py`` reads."""
        return {
            "kind": "memory_dump",
            "interval": self.interval,
            "budget_bytes": self.budget or None,
            "drift_tol": self.drift_tol,
            "comm_steps": self._count,
            "samples": list(self.samples),
            "advisories": [a.to_json() for a in self.advisories],
            "phase_peaks": {k: dict(v) for k, v in sorted(self.phase_peaks.items())},
            "peak_bytes_per_rank": int(self._peak_bytes),
            "last_census_ranked": ranked_census(self.last_census),
            "oom_events": self.oom_events,
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.report(), f)
        return path


# -- module-level session -----------------------------------------------------

_observatory: Optional[MemoryObservatory] = None


def start(interval: Optional[int] = None, **kwargs) -> MemoryObservatory:
    """Open a memory session (replacing any active one)."""
    global _observatory
    _observatory = MemoryObservatory(interval=interval, **kwargs)
    return _observatory


def stop() -> None:
    global _observatory
    _observatory = None


def activate(obs: Optional[MemoryObservatory]) -> Optional[MemoryObservatory]:
    """Install (or clear, with None) a session without resetting it."""
    global _observatory
    _observatory = obs
    return obs


def active() -> Optional[MemoryObservatory]:
    return _observatory


def observe_step(ctx, *, step: int, optimizer=None, params=None, opt_state=None,
                 grads=None) -> None:
    """The optimizers' hook after every communicating dispatch."""
    obs = _observatory
    if obs is None:
        return
    obs.observe(ctx, step=step, optimizer=optimizer, params=params, opt_state=opt_state,
                grads=grads)


def on_oom(reason: str, message: str = "") -> List[dict]:
    """Run the OOM forensics, with or without an active session."""
    obs = _observatory
    if obs is None:
        obs = MemoryObservatory()
    return obs.note_oom(reason, message)


def dump(path: str) -> Optional[str]:
    """Write the active session's dump (None without a session)."""
    obs = _observatory
    if obs is None:
        return None
    return obs.dump(path)


# -- crash hooks --------------------------------------------------------------

_hook_installed = False
_prev_excepthook = None


def _is_oom(exc_type, exc) -> bool:
    """A host ``MemoryError``, a ``torch.OutOfMemoryError`` (the CUDA
    allocator's, a ``RuntimeError``), or an error whose message carries
    ``RESOURCE_EXHAUSTED``."""
    import torch

    kinds = (MemoryError, torch.OutOfMemoryError)
    if isinstance(exc, kinds) or (
        isinstance(exc_type, type) and issubclass(exc_type, kinds)
    ):
        return True
    return "RESOURCE_EXHAUSTED" in str(exc)


def _excepthook(exc_type, exc, tb):
    try:
        # the oom fault marks its raise: its forensics already ran
        if _is_oom(exc_type, exc) and not getattr(exc, "_bf_oom_forensics_done", False):
            on_oom(f"exception:{exc_type.__name__}", str(exc))
    except Exception:
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _install_oom_hooks() -> None:
    global _hook_installed, _prev_excepthook
    if _hook_installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    _hook_installed = True


def _uninstall_oom_hooks() -> None:
    global _hook_installed, _prev_excepthook
    if not _hook_installed:
        return
    if sys.excepthook is _excepthook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    _hook_installed = False
    _prev_excepthook = None


# -- session lifecycle (called by bluefog_tpu_torch.context) ------------------


def on_init(ctx) -> None:
    """``init`` hook: a fresh session under ``BLUEFOG_MEMORY=1``, and the
    OOM hooks beside the flight recorder's when it has a dump directory
    (installed after it, so this hook runs first)."""
    if enabled():
        start()
    else:
        stop()
    from bluefog_tpu_torch import flight as flight_mod

    if flight_mod.enabled() and flight_mod.dump_dir() is not None:
        _install_oom_hooks()


def on_shutdown() -> None:
    """``shutdown`` hook: the JSONL's closing line, the session dropped and
    the hooks detached."""
    obs = _observatory
    if obs is not None and obs.samples:
        obs._export_line({"kind": "session_end", "comm_steps": obs._count})
    _uninstall_oom_hooks()
    stop()
