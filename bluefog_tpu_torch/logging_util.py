# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Logging: the ``BLUEFOG_LOG_LEVEL``-driven logger of the port, and the
small parsers behind every ``BLUEFOG_*`` knob.

Counterpart of ``bluefog_tpu/logging_util.py``: ``logger`` (named
``bluefog_tpu_torch``), :func:`set_log_level` with the reference's level
names (trace, debug, info, warn, error, fatal), ``BLUEFOG_LOG_LEVEL`` and
``BLUEFOG_LOG_HIDE_TIME`` read at import, :func:`env_int`,
:func:`env_float`, :func:`json_safe` and :func:`append_jsonl`. One
difference: :func:`warn_once` reports through ``warnings.warn`` (a
``UserWarning``), so a misconfiguration surfaces in the caller's warning
filters and in pytest; the JAX package logs it.
"""

import logging
import os
import warnings

__all__ = [
    "logger", "set_log_level", "warn_once", "json_safe",
    "append_jsonl", "env_int", "env_float", "TRACE",
]

TRACE = 5  # below logging.DEBUG: the reference's trace level
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logger = logging.getLogger("bluefog_tpu_torch")


def set_log_level(level: str) -> None:
    """Set the port's log level by reference-style name."""
    if level.lower() not in _LEVELS:
        raise ValueError(
            f"unknown log level {level!r}; expected one of {sorted(_LEVELS)}"
        )
    logger.setLevel(_LEVELS[level.lower()])


# BLUEFOG_LOG_LEVEL values already warned about: the fallback to `warn` is
# loud once per value, not once per reconfiguration
_warned_levels = set()

_warned_once = set()


def warn_once(key: str, msg: str, *args) -> None:
    """Warn with ``msg % args`` the first time ``key`` is seen; later calls
    with the same key are silent."""
    if key in _warned_once:
        return
    _warned_once.add(key)
    warnings.warn(msg % args if args else msg, stacklevel=3)


def env_int(name: str, default: int) -> int:
    """``int(os.environ[name])``; unset or empty gives ``default``, and a
    malformed value warns once and gives ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return int(default)
    try:
        return int(raw)
    except ValueError:
        warn_once(f"env_int:{name}:{raw}", f"{name}={raw!r} is not an integer; using {default}")
        return int(default)


def env_float(name: str, default: float) -> float:
    """:func:`env_int` for float knobs (timeouts, tolerances)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return float(default)
    try:
        return float(raw)
    except ValueError:
        warn_once(f"env_float:{name}:{raw}", f"{name}={raw!r} is not a number; using {default}")
        return float(default)


def json_safe(obj):
    """Replace non-finite floats with None, recursively: a bare ``NaN``
    token is invalid JSON for strict parsers."""
    import math

    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def append_jsonl(env_name: str, path: str, obj: dict) -> None:
    """Append one timestamped, non-finite-sanitized JSON line to ``path``;
    a write failure warns once per path instead of failing every sample."""
    import json
    import time

    try:
        with open(path, "a") as f:
            f.write(json.dumps(json_safe({"ts": time.time(), **obj})) + "\n")
    except OSError as e:
        warn_once(f"export:{env_name}:{path}",
                  "cannot append %s sample to %s (%s); further failures for this "
                  "path are silent", env_name, path, e)


def _configure_from_env() -> None:
    raw = os.environ.get("BLUEFOG_LOG_LEVEL")
    level = (raw or "warn").lower()
    logger.setLevel(_LEVELS.get(level, logging.WARNING))
    if not logger.handlers:
        handler = logging.StreamHandler()
        if os.environ.get("BLUEFOG_LOG_HIDE_TIME"):
            fmt = "[%(levelname)s] %(name)s: %(message)s"
        else:
            fmt = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.propagate = False
    if raw is not None and level not in _LEVELS and level not in _warned_levels:
        _warned_levels.add(level)
        logger.warning(
            "unknown BLUEFOG_LOG_LEVEL %r; falling back to 'warn' (accepted: %s)",
            raw, ", ".join(sorted(_LEVELS)),
        )


_configure_from_env()
