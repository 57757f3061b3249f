# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Flight recorder: an always-on, bounded-memory black box of a run.

Counterpart of ``bluefog_tpu/flight.py``. A fixed ring of structured
events fed by the runtime, dumped to JSON when something goes wrong.

- **Cheap.** :func:`record` is a monotonic-clock read and one slot
  assignment: each call takes a unique sequence number from an
  ``itertools.count`` (atomic under the GIL) and writes slot ``seq %
  capacity``, so concurrent writers (the training loop, the watchdog
  thread) never share a slot.
- **Bounded.** ``BLUEFOG_FLIGHT_CAPACITY`` slots (default 8192, at least
  256); side tables (compiled plans, fault verdicts, advisories) keep
  what a postmortem needs after the ring has moved on, each bounded.
- **Always on** (``BLUEFOG_FLIGHT=0`` turns it off); recording never
  touches a device value, so the training bits are the same either way.

Events (``kind``): ``session_start`` / ``session_end`` (the clock triple:
unix ns, monotonic us, timeline us), ``plan_compile`` (a plan noted by
:func:`note_plan`, its rounds kept in the side table), ``step_begin`` /
``step_dispatched``, ``sync_begin`` / ``sync_ready`` (host blocking
points), ``window_op``, ``async_tick``, ``advisory``, ``stall``, ``crash``
and ``sigterm``; the elastic verdicts ``membership``, ``fault``,
``repair``, ``migrate`` and ``shard_reshard``. The JAX package also records ``compile`` for a fresh XLA
program; the port builds no program and records none (see
:mod:`bluefog_tpu_torch.metrics`).

Dumps: :func:`dump` (``bft.flight_dump()``) writes
``<BLUEFOG_FLIGHT_DIR or .>/flight_<process index>.json`` atomically. A
watchdog stall, an elastic SUSPECT or DEAD verdict, an unhandled exception
and SIGTERM dump automatically when ``BLUEFOG_FLIGHT_DIR`` is set (the
crash hooks are installed at ``init`` then, and removed at ``shutdown``).
Under an elastic session a dump carries the ``membership`` block (epoch,
live, dead, the last 64 transitions) and the plan's ``faults``.
"""

import itertools
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch import watchdog
from bluefog_tpu_torch.logging_util import logger

__all__ = [
    "FlightRecorder",
    "enabled",
    "record",
    "events",
    "note_plan",
    "note_fault",
    "note_advisory",
    "note_decision",
    "note_slo",
    "dump",
    "maybe_dump",
    "dump_dir",
    "reconfigure",
    "on_init",
    "on_shutdown",
    "DUMP_VERSION",
]

ENABLE_ENV = "BLUEFOG_FLIGHT"
CAPACITY_ENV = "BLUEFOG_FLIGHT_CAPACITY"
DIR_ENV = "BLUEFOG_FLIGHT_DIR"

DUMP_VERSION = 1

# How many compiled CommPlan structures the side table retains (newest
# kept). The postmortem needs the plan that was active at the fault;
# dynamic schedules add one entry per period step.
_MAX_PLANS = 32


def _now_us() -> int:
    return time.monotonic_ns() // 1000


class FlightRecorder:
    """Fixed-capacity event ring. See the module docstring for the
    lock-free-ish write protocol."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = int(capacity)
        self._buf: List[Optional[Tuple]] = [None] * self.capacity
        self._seq = itertools.count()

    def record(self, kind: str, data: Optional[dict] = None) -> int:
        seq = next(self._seq)  # GIL-atomic: unique slot per writer
        self._buf[seq % self.capacity] = (seq, _now_us(), kind, data)
        return seq

    def events(self) -> List[dict]:
        """Snapshot of the ring as dicts, oldest first. Taken without a
        lock: a slot overwritten mid-snapshot just reflects the newer
        event (the ring's contract is "the last N events", not a
        consistent cut)."""
        snap = [e for e in list(self._buf) if e is not None]
        snap.sort(key=lambda e: e[0])
        return [
            {"seq": s, "t_us": t, "kind": k, **({"data": d} if d else {})}
            for s, t, k, d in snap
        ]

    def __len__(self) -> int:
        return sum(1 for e in self._buf if e is not None)


# -- module state -------------------------------------------------------------

_enabled_cache: Optional[bool] = None
_recorder: Optional[FlightRecorder] = None
_plans: List[dict] = []  # bounded side table of compiled plan structures
_faults: List[dict] = []  # bounded side table of fault verdicts: the
# postmortem's fault -> plan linkage must survive ring eviction on long
# runs, exactly like the plan structures themselves
_advisories: List[dict] = []  # bounded side table of advisories (the
# async engine's async_staleness), kept past ring eviction like faults
# the dump keeps the JAX package's top-level keys: the controller
# decisions and SLO snapshots its autotune and SLO engines note
_decisions: List[dict] = []
_slo: List[dict] = []
_plans_lock = threading.Lock()
_hooks_installed = False
_prev_excepthook = None
_prev_sigterm = None
_dump_lock = threading.Lock()
# every dump reason this session, oldest first: the canonical dump file
# is rewritten in place, so a later explicit dump must not erase the
# fact that a verdict/stall trigger fired earlier (bounded)
_dump_history: List[str] = []


def enabled() -> bool:
    """Recorder switch, default ON (``BLUEFOG_FLIGHT=0`` disables). The
    value is cached for the hot path; :func:`reconfigure` (called by
    ``bf.init()``) re-reads the environment."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = os.environ.get(ENABLE_ENV, "1").lower() not in (
            "0", "false", "off", "no",
        )
    return _enabled_cache


def capacity() -> int:
    from bluefog_tpu_torch.logging_util import env_int

    return max(256, env_int(CAPACITY_ENV, 8192))


def dump_dir() -> Optional[str]:
    """Directory the automatic triggers dump into (``BLUEFOG_FLIGHT_DIR``),
    or None when unset (automatic dumps disabled; explicit :func:`dump`
    still works)."""
    return os.environ.get(DIR_ENV) or None


def _rec() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        _recorder = FlightRecorder(capacity())
    return _recorder


def reconfigure() -> None:
    """Re-read the env knobs and start a fresh ring (one flight per
    session: ``init`` calls this so a dump never mixes events of a
    torn-down context with the new one)."""
    global _enabled_cache, _recorder
    _enabled_cache = None
    _recorder = None
    with _plans_lock:
        _plans.clear()
        _faults.clear()
        _advisories.clear()
        _decisions.clear()
        _slo.clear()
    del _dump_history[:]


def record(kind: str, **data) -> int:
    """Append one structured event to the ring; returns its sequence
    number (-1 when the recorder is disabled). ``data`` values must be
    JSON-serializable — they go into the dump verbatim."""
    if not enabled():
        return -1
    return _rec().record(kind, data or None)


def events() -> List[dict]:
    if _recorder is None:
        return []
    return _recorder.events()


def note_plan(plan, topo_version: int, live_token=None,
              kind: str = "worker") -> None:
    """Retain a compiled CommPlan's structure in the bounded side table
    (and drop a ``plan_compile`` ring event). The postmortem resolves
    "which edge/round was rank j waiting on" from exactly this record,
    so it must survive ring eviction. ``kind`` distinguishes worker-rank
    plans from hierarchical *machine*-graph plans — their version
    counters are independent and their node ids mean different things,
    so the postmortem must never match a fault against the wrong kind."""
    if not enabled():
        return
    entry = {
        "kind": kind,
        "topo_version": int(topo_version),
        "n_rounds": len(plan.rounds),
        "rounds": [
            [[int(s), int(d)] for s, d in rnd.perm] for rnd in plan.rounds
        ],
        "live": (
            None if live_token is None
            else {"epoch": live_token[0], "ranks": list(live_token[1])}
        ),
    }
    with _plans_lock:
        if entry in _plans:
            # dynamic-weight plans are rebuilt per dispatch (no cache in
            # front of them): retain the structure once, and don't spam
            # the ring with a plan_compile event per step
            return
        _plans.append(entry)
        del _plans[:-_MAX_PLANS]
    record(
        "plan_compile", topo_version=entry["topo_version"],
        n_rounds=entry["n_rounds"],
        live_epoch=None if live_token is None else live_token[0],
    )


def note_fault(**data) -> None:
    """Record a fault verdict in BOTH the ring and a bounded side table:
    the postmortem resolves the fault's topology version against the
    plan side table, and that linkage must not depend on the fault event
    still being in the (evicted-on-overflow) ring when the dump fires."""
    if not enabled():
        return
    with _plans_lock:
        _faults.append(dict(data))
        del _faults[:-64]
    record("fault", **data)


def note_advisory(**data) -> None:
    """Record an advisory in BOTH the ring and a bounded side table,
    mirroring :func:`note_fault`: the history must survive ring
    eviction."""
    if not enabled():
        return
    with _plans_lock:
        _advisories.append(dict(data))
        del _advisories[:-64]
    # the ring event's own kind is "advisory"; the diagnosis kind rides
    # as advisory_kind (same convention as note_fault's fault_kind)
    record("advisory", **{
        ("advisory_kind" if k == "kind" else k): v
        for k, v in data.items()
    })


def note_decision(**data) -> None:
    """Record a controller decision in BOTH the ring and a bounded side
    table, mirroring :func:`note_advisory`."""
    if not enabled():
        return
    with _plans_lock:
        _decisions.append(dict(data))
        del _decisions[:-64]
    record("autotune", **data)


def note_slo(**data) -> None:
    """Record an SLO budget snapshot in BOTH the ring and a bounded side
    table, mirroring :func:`note_decision`."""
    if not enabled():
        return
    with _plans_lock:
        _slo.append(dict(data))
        del _slo[:-64]
    record("slo", **data)


def _clock_triple() -> dict:
    """The cross-rank alignment anchor: the same instant on all three
    clocks this process emits timestamps in — wall (shared across
    hosts), monotonic (flight events), timeline (Chrome-trace ts)."""
    return {
        "unix_ns": time.time_ns(),
        "mono_us": _now_us(),
        "timeline_us": (
            tl.timeline_now_us() if tl.timeline_enabled() else None
        ),
    }


def _owned_ranks(ctx) -> List[int]:
    """Worker slots this process drives: its rows of the stacked axis (all
    of them with one process)."""
    return list(ctx.rows)


def _build_dump(reason: str) -> dict:
    from bluefog_tpu_torch import context as ctx_mod
    from bluefog_tpu_torch import metrics as metrics_mod

    out: Dict[str, Any] = {
        "version": DUMP_VERSION,
        "reason": reason,
        "process_index": tl.process_file_index(),
        "clock": _clock_triple(),
    }
    ctx = ctx_mod._context  # no raise when uninitialized: a crash dump
    # must succeed before and after init
    if ctx is not None:
        out["world"] = {
            "size": ctx.size,
            "machine_size": ctx.machine_size,
            "local_size": ctx.local_size,
            "topo_version": ctx.topo_version,
            "ranks": _owned_ranks(ctx),
        }
        m = ctx.elastic_membership
        if m is not None:
            out["membership"] = {
                "epoch": m.epoch,
                "live": list(m.live_ranks()),
                "dead": list(m.dead_ranks()),
                "history": [list(h) for h in m.history[-64:]],
            }
    try:
        from bluefog_tpu_torch import elastic as elastic_mod

        session = elastic_mod.active_session()
        if session is not None:
            out["faults"] = [
                {"kind": f.kind, "rank": f.rank, "step": f.step,
                 "seconds": f.seconds, "factor": f.factor}
                for f in session.plan.faults
            ]
    except Exception:  # a broken elastic import must not lose the dump
        pass
    with _plans_lock:
        out["comm_plans"] = list(_plans)
        out["fault_events"] = list(_faults)
        out["advisories"] = list(_advisories)
        out["autotune_decisions"] = list(_decisions)
        out["slo_snapshots"] = list(_slo)
    try:
        out["metrics"] = metrics_mod.snapshot()
    except Exception:
        out["metrics"] = {}
    out["events"] = events()
    return out


def dump(path: Optional[str] = None, reason: str = "explicit") -> str:
    """Write the flight dump as JSON and return the path written.

    ``path`` defaults to ``<BLUEFOG_FLIGHT_DIR or .>/flight_<process
    index>.json``. The write is atomic (tmp + rename): a dump raced by a
    crashing process must never leave a half-written JSON — the file
    exists precisely to be read after something went wrong."""
    if path is None:
        base = dump_dir() or "."
        os.makedirs(base, exist_ok=True)
        path = os.path.join(
            base, f"flight_{tl.process_file_index()}.json"
        )
    with _dump_lock:
        _dump_history.append(reason)
        del _dump_history[:-32]
        payload = _build_dump(reason)
        payload["dump_history"] = list(_dump_history)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    return path


def maybe_dump(reason: str) -> Optional[str]:
    """Automatic-trigger dump: writes ``flight_<proc>.json`` into
    ``BLUEFOG_FLIGHT_DIR`` when that is configured, else does nothing
    (an unconfigured training run must not litter its cwd). Never
    raises — a failing dump must not take down the run it is trying to
    explain."""
    if not enabled() or dump_dir() is None:
        return None
    try:
        return dump(reason=reason)
    except Exception:
        logger.exception("flight dump (%s) failed", reason)
        return None


# -- automatic triggers -------------------------------------------------------


def _on_stall(name: str, waited: float) -> None:
    """Watchdog subscriber: a blocking wait outlived its deadline — the
    exact moment a hang becomes observable, so the black box goes to
    disk now, while the evidence is fresh."""
    record("stall", name=name, waited_s=round(float(waited), 3))
    maybe_dump(f"stall:{name}")


def _excepthook(exc_type, exc, tb):
    try:
        record(
            "crash", type=exc_type.__name__, message=str(exc)[:300]
        )
        maybe_dump(f"exception:{exc_type.__name__}")
    except Exception:
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _sigterm_handler(signum, frame):
    try:
        record("sigterm")
        maybe_dump("sigterm")
    except Exception:
        pass
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
        return
    # default/ignored disposition: restore it and re-deliver so the
    # process still dies with the expected SIGTERM status
    signal.signal(signal.SIGTERM, prev if prev is not None
                  else signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _install_crash_hooks() -> None:
    global _hooks_installed, _prev_excepthook, _prev_sigterm
    if _hooks_installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _sigterm_handler)
    except (ValueError, OSError):  # not the main thread / exotic platform
        _prev_sigterm = None
    _hooks_installed = True


def _uninstall_crash_hooks() -> None:
    global _hooks_installed, _prev_excepthook, _prev_sigterm
    if not _hooks_installed:
        return
    if sys.excepthook is _excepthook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    try:
        if signal.getsignal(signal.SIGTERM) is _sigterm_handler:
            signal.signal(
                signal.SIGTERM,
                _prev_sigterm if _prev_sigterm is not None
                else signal.SIG_DFL,
            )
    except (ValueError, OSError):
        pass
    _hooks_installed = False
    _prev_excepthook = None
    _prev_sigterm = None


# -- session lifecycle (called by bluefog_tpu_torch.context) ------------------


def on_init(ctx) -> None:
    """Open the black box for a fresh session: new ring, clock
    handshake event, watchdog subscription, and (when a dump directory
    is configured) the crash hooks."""
    reconfigure()
    if not enabled():
        return
    record(
        "session_start",
        **_clock_triple(),
        process_index=tl.process_file_index(),
        size=ctx.size,
        machine_size=ctx.machine_size,
        pid=os.getpid(),
        process_count=ctx.process_count,
        rows=[ctx.rows.start, ctx.rows.stop],
        backend=ctx.backend,
        staged=ctx.staged,
    )
    watchdog.add_stall_handler(_on_stall)  # idempotent (same fn object)
    if dump_dir() is not None:
        _install_crash_hooks()


def on_shutdown() -> None:
    record("session_end", **_clock_triple())
    watchdog.remove_stall_handler(_on_stall)
    _uninstall_crash_hooks()
