# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's copies of ``bluefog_tpu/logging_util.py``'s ``warn_once``
and ``env_int``: a misconfiguration or a fallback is reported once, as a
``UserWarning``, and a malformed integer knob falls back to its default
instead of raising deep inside a step."""

import os
import warnings

__all__ = ["warn_once", "env_int"]

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
