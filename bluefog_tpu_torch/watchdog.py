# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Stall watchdog: report blocking waits that exceed a deadline.

Counterpart of ``bluefog_tpu/watchdog.py``. What can hang on one card is
a wait on the device: :func:`bluefog_tpu_torch.synchronize` waiting on a
CUDA event behind a kernel that never finishes, or the asynchronous
engine's fold. Every such host blocking point registers itself with
:class:`watch`, and a daemon thread reports (through the port's logger)
any wait that outlives ``BLUEFOG_STALL_TIMEOUT`` seconds (default 60; 0
disables). A report also increments ``bluefog.stalls``, leaves a
``STALL`` instant in the timeline and calls the stall handlers (the
flight recorder writes its dump from one).
"""

import itertools
import threading
import time

from bluefog_tpu_torch.logging_util import logger

__all__ = [
    "watch",
    "stall_timeout",
    "set_stall_timeout",
    "add_stall_handler",
    "remove_stall_handler",
    "suspend",
    "resume",
    "is_suspended",
]

_pending = {}  # id -> (name, start_time, reported)
_pending_lock = threading.Lock()
_ids = itertools.count()
_thread = None
_timeout = None
_suspended = False
# Stall subscribers: fn(name, waited_seconds), called from the monitor
# thread when a wait outlives the deadline. The flight recorder
# registers here so a hung wait leaves a dump.
_handlers = []


def add_stall_handler(fn) -> None:
    """Subscribe ``fn(name, waited_seconds)`` to stall reports. Called on
    the watchdog thread — handlers must be quick and exception-safe."""
    if fn not in _handlers:
        _handlers.append(fn)


def remove_stall_handler(fn) -> None:
    try:
        _handlers.remove(fn)
    except ValueError:
        pass


def suspend() -> None:
    """Pause stall reporting (reference ``bf.suspend``, basics.py:548-568:
    there it parks the background communication thread between notebook
    cells; here the blocking-wait monitor is what runs in the background)."""
    global _suspended
    _suspended = True


def resume() -> None:
    """Re-arm stall reporting; pending waits restart their clocks so the
    suspended interval is not counted as a stall."""
    global _suspended
    now = time.monotonic()
    with _pending_lock:
        for key, (name, _t0, reported) in list(_pending.items()):
            _pending[key] = (name, now, reported)
    _suspended = False


def is_suspended() -> bool:
    return _suspended


def stall_timeout() -> float:
    global _timeout
    if _timeout is None:
        from bluefog_tpu_torch.logging_util import env_float

        _timeout = env_float("BLUEFOG_STALL_TIMEOUT", 60.0)
    return _timeout


def set_stall_timeout(seconds: float) -> None:
    """0 disables the watchdog."""
    global _timeout
    _timeout = float(seconds)


def _monitor() -> None:
    while True:
        # short fixed-bound poll so a runtime set_stall_timeout() takes
        # effect promptly regardless of the previous limit
        time.sleep(min(max(stall_timeout() / 4, 0.05), 0.25))
        limit = stall_timeout()
        if limit <= 0 or _suspended:
            continue
        now = time.monotonic()
        fired = []
        with _pending_lock:
            for key, (name, t0, reported) in list(_pending.items()):
                waited = now - t0
                if waited > limit and not reported:
                    _pending[key] = (name, t0, True)
                    fired.append((name, waited))
        # Everything below runs OUTSIDE _pending_lock: handlers can be
        # slow (the flight recorder writes a dump to disk on stall),
        # and watch.__enter__/__exit__ take the same lock — a handler
        # holding it would turn a recoverable stall into a training
        # thread blocked on its own watchdog.
        for name, waited in fired:
            logger.error(
                "Stall detected: %s has been blocking for %.1f s "
                "(limit %g s). The device may be hung, or a kernel "
                "queued before this wait has not finished.",
                name, waited, limit,
            )
            # Stalls must reach the exported metrics and the trace,
            # not just stderr: a fleet pages on bluefog.stalls, and
            # the instant event lands in the timeline next to the
            # span that hung.
            from bluefog_tpu_torch import metrics, timeline

            metrics.counter("bluefog.stalls").inc()
            timeline.timeline_record_instant(
                f"stall:{name}", "STALL"
            )
            for handler in list(_handlers):
                try:
                    handler(name, waited)
                except Exception:  # a liveness bug must not
                    # kill the monitor thread
                    logger.exception(
                        "stall handler %r raised", handler
                    )


class watch:
    """Context manager registering a named blocking wait with the monitor."""

    def __init__(self, name: str):
        self.name = name
        self.key = None

    def __enter__(self):
        global _thread
        if stall_timeout() <= 0:
            return self
        if _thread is None:
            with _pending_lock:
                if _thread is None:
                    _thread = threading.Thread(
                        target=_monitor, name="bluefog-stall-watchdog",
                        daemon=True,
                    )
                    _thread.start()
        self.key = next(_ids)
        with _pending_lock:
            _pending[self.key] = (self.name, time.monotonic(), False)
        return self

    def __exit__(self, *exc):
        if self.key is not None:
            with _pending_lock:
                _pending.pop(self.key, None)
        return False
