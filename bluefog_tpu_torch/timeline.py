# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Tracing: a Chrome-trace timeline of the host's phases, and the
``torch.profiler`` trace of the device's.

Counterpart of ``bluefog_tpu/timeline.py``. The host phases (a
collective's dispatch, a ``synchronize`` wait, an optimizer step, user
activities, stall instants, metric counters) go to one JSON array per
process. The writer is the native one, ``csrc/timeline_writer.cc`` (a
background thread drains a queue of records, so a record costs the
caller a lock and a push), built by ``g++`` at the timeline's first use
(:func:`bluefog_tpu_torch._build.timeline_library`, into
``build/torch_kernels/``, keyed by the source's hash) and loaded with
``ctypes``. Where the host has no ``g++`` or the build directory is not
writable, :class:`_PyWriter` writes the same records under a lock (the
watchdog thread writes its stall instants beside the training thread's
spans), as the JAX package falls back; a ``g++`` whose build fails
raises with the compiler's output. :func:`using_native_writer` says
which. ``timeline_init(path, profiler=True)`` also starts
``torch.profiler`` with the CPU and CUDA activities and writes its Chrome
trace into ``<path>.torch/`` at :func:`timeline_shutdown`: the kernels
themselves.

:func:`span` is the one span primitive with two sinks: a complete record
of the timeline when one is open, and a ``record_function`` range named
``bluefog.<name>`` while ``torch.profiler`` records, so the port's spans
(each collective's and optimizer step's ``ENQUEUE``, each wait's
``SYNCHRONIZE``, the train step's phases) sit in the profiler's trace
beside the kernels they launch, on the clock of those launches. With
neither on, a span costs two attribute reads. :func:`timeline_context`
keeps its ``B`` / ``E`` records and opens the same range.

``BLUEFOG_TIMELINE=<prefix>`` opens ``<prefix><index>.json`` at ``init``
(:func:`maybe_init_from_env`; the index is :func:`process_file_index`) and
closes it at ``shutdown`` or at exit.
"""

import contextlib
import ctypes
import math
import os
import threading
import time
from typing import Optional

import torch.autograd.profiler as _torch_profiler

__all__ = [
    "timeline_init",
    "timeline_shutdown",
    "timeline_enabled",
    "timeline_start_activity",
    "timeline_end_activity",
    "timeline_record_complete",
    "timeline_record_instant",
    "timeline_record_advisory",
    "timeline_record_counter",
    "timeline_context",
    "timeline_now_us",
    "span",
    "PHASE",
    "process_file_index",
    "maybe_init_from_env",
    "using_native_writer",
]


# str.translate table deleting the control characters (below U+0020)
_CONTROL = dict.fromkeys(range(0x20))


class _PyWriter:
    """The Python writer, with the native writer's contract and records:
    one JSON array, each record written by whoever calls, the ``,\\n``
    separator handshake under a lock so that records from two threads
    never interleave."""

    def __init__(self):
        self._f = None
        self._first = True
        self._t0 = time.perf_counter_ns()
        self._wlock = threading.Lock()

    def bf_timeline_start(self, path: bytes) -> int:
        with self._wlock:
            if self._f is not None:
                return 0
            self._f = open(path.decode(), "w")
            self._f.write("[\n")
            self._first = True
            return 1

    def bf_timeline_now_us(self) -> int:
        return (time.perf_counter_ns() - self._t0) // 1000

    def _emit(self, obj: str) -> None:
        with self._wlock:
            if self._f is None:
                return
            if not self._first:
                self._f.write(",\n")
            self._first = False
            self._f.write(obj)

    @staticmethod
    def _esc(b: bytes) -> str:
        # the native writer's Escape(): backslash and quote escaped, control
        # characters dropped (a raw newline would break the JSON string)
        return b.decode().replace("\\", "\\\\").replace('"', '\\"').translate(_CONTROL)

    def bf_timeline_record(self, name, cat, ph, pid, tid) -> None:
        ph = ph.decode()
        suffix = ', "s": "p"' if ph == "i" else ""  # an instant needs a scope
        self._emit(
            '{"name": "%s", "cat": "%s", "ph": "%s", "ts": %d, '
            '"pid": %d, "tid": %d%s}'
            % (self._esc(name), self._esc(cat), ph, self.bf_timeline_now_us(), pid, tid,
               suffix)
        )

    def bf_timeline_record_counter(self, name, cat, pid, tid, value):
        self._emit(
            '{"name": "%s", "cat": "%s", "ph": "C", "ts": %d, '
            '"pid": %d, "tid": %d, "args": {"value": %g}}'
            % (self._esc(name), self._esc(cat), self.bf_timeline_now_us(), pid, tid, value)
        )

    def bf_timeline_record_complete(self, name, cat, pid, tid, ts, dur):
        self._emit(
            '{"name": "%s", "cat": "%s", "ph": "X", "ts": %d, "dur": %d, '
            '"pid": %d, "tid": %d}'
            % (self._esc(name), self._esc(cat), ts, dur, pid, tid)
        )

    def bf_timeline_stop(self) -> None:
        with self._wlock:
            if self._f is not None:
                self._f.write("\n]\n")
                self._f.close()
                self._f = None


_writer = None  # the native library once loaded, else a _PyWriter
_writer_lock = threading.Lock()
_active = False
_profiler = None  # the running torch.profiler.profile, with its output dir
_profiler_dir: Optional[str] = None
_env_owned = False  # opened from BLUEFOG_TIMELINE by init(): closed by shutdown()


def _build_dir_writable() -> bool:
    from bluefog_tpu_torch import _build

    try:
        _build.build_dir().mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    return os.access(_build.build_dir(), os.W_OK)


def _load_native():
    """The writer: the native library (built once), or :class:`_PyWriter`
    where there is no ``g++`` or no writable build directory."""
    global _writer
    if _writer is None:
        with _writer_lock:
            if _writer is None:
                from bluefog_tpu_torch import _build

                if _build.find_cxx() is None or not _build_dir_writable():
                    _writer = _PyWriter()
                else:
                    _writer = _build.timeline_library()
    return _writer


def using_native_writer() -> bool:
    """Whether the timeline writes through the native writer."""
    return isinstance(_load_native(), ctypes.CDLL)


@contextlib.contextmanager
def python_writer():
    """Test hook: the timelines opened inside the block write through a
    :class:`_PyWriter`; the writer chosen before is restored after. Refused
    while a timeline is open."""
    global _writer
    if _active:
        raise RuntimeError("python_writer() while a timeline is open")
    saved = _writer
    _writer = _PyWriter()
    try:
        yield _writer
    finally:
        if _active:
            timeline_shutdown()
        _writer = saved


def timeline_init(file_path: str, profiler: bool = False) -> bool:
    """Start the timeline at ``file_path`` (reference ``bf.timeline_init``);
    False when one is already open. ``profiler=True`` also starts
    ``torch.profiler`` (CPU and, with a card, CUDA activities), whose
    Chrome trace goes to ``<file_path>.torch/`` at shutdown."""
    global _active, _profiler, _profiler_dir, _env_owned
    if not _load_native().bf_timeline_start(file_path.encode()):
        return False
    _active = True
    _env_owned = False  # a timeline the user opens is theirs to close
    if profiler:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _profiler_dir = file_path + ".torch"
        _profiler = torch.profiler.profile(activities=acts)
        _profiler.start()
    return True


def timeline_shutdown() -> bool:
    """Flush and close the timeline (and stop the profiler, writing its
    trace); False when none is open."""
    global _active, _profiler, _profiler_dir, _env_owned
    if not _active:
        return False
    if _profiler is not None:
        _profiler.stop()
        os.makedirs(_profiler_dir, exist_ok=True)
        _profiler.export_chrome_trace(
            os.path.join(_profiler_dir, f"trace_{process_file_index()}.json"))
        _profiler = _profiler_dir = None
    _load_native().bf_timeline_stop()
    _active = False
    _env_owned = False
    return True


def timeline_env_owned() -> bool:
    """True when the open timeline came from ``BLUEFOG_TIMELINE`` at
    ``init`` (``shutdown`` then closes it)."""
    return _active and _env_owned


def timeline_enabled() -> bool:
    return _active


def timeline_start_activity(name: str, activity: str, rank: int = 0, tid: int = 0) -> bool:
    """Open an activity span (``ph:"B"``)."""
    if not _active:
        return False
    _load_native().bf_timeline_record(name.encode(), activity.encode(), b"B", rank, tid)
    return True


def timeline_end_activity(name: str, activity: str = "", rank: int = 0, tid: int = 0) -> bool:
    """Close the most recent span of ``name`` (``ph:"E"``)."""
    if not _active:
        return False
    _load_native().bf_timeline_record(name.encode(), activity.encode(), b"E", rank, tid)
    return True


def timeline_record_complete(name: str, activity: str, start_us: int, dur_us: int,
                             rank: int = 0, tid: int = 0) -> bool:
    """One complete span (``ph:"X"``) with explicit timing."""
    if not _active:
        return False
    _load_native().bf_timeline_record_complete(name.encode(), activity.encode(), rank, tid,
                                        start_us, dur_us)
    return True


def timeline_record_instant(name: str, activity: str = "", rank: int = 0, tid: int = 0) -> bool:
    """One instant event (``ph:"i"``), e.g. a watchdog stall."""
    if not _active:
        return False
    _load_native().bf_timeline_record(name.encode(), activity.encode(), b"i", rank, tid)
    return True


def timeline_record_advisory(kind: str, detail: Optional[dict] = None, rank: int = 0) -> bool:
    """One instant for an advisory, named ``doctor:<kind> <k=v ...>``."""
    parts = "".join(
        f" {k}={v}" for k, v in sorted((detail or {}).items())
        if isinstance(v, (int, float, str, list, tuple))
    )
    return timeline_record_instant(f"doctor:{kind}{parts}", "ADVISORY", rank)


def timeline_record_counter(name: str, value: float, activity: str = "COUNTER",
                            rank: int = 0, tid: int = 0) -> bool:
    """One counter event (``ph:"C"``): ``name`` at ``value`` now. A
    non-finite value is dropped (returns False): it would make the whole
    file invalid JSON."""
    value = float(value)
    if not _active or not math.isfinite(value):
        return False
    _load_native().bf_timeline_record_counter(name.encode(), activity.encode(), rank, tid, value)
    return True


def timeline_now_us() -> int:
    return int(_load_native().bf_timeline_now_us())


PHASE = "PHASE"  # the timeline category of the train step's phase spans
_NO_SPAN = contextlib.nullcontext()


def _range(name: str):
    """The profiler range of the span ``name``: a ``torch.profiler``
    range, not a metric series."""
    return _torch_profiler.record_function(f"bluefog.{name}")


@contextlib.contextmanager
def timeline_context(name: str, activity: str, rank: int = 0):
    """Span context manager (reference ``bf.timeline_context``): a
    ``ph:"B"`` / ``ph:"E"`` pair of the timeline and, while
    ``torch.profiler`` records, the ``bluefog.<name>`` range of
    :func:`span`."""
    timeline_start_activity(name, activity, rank)
    try:
        with _range(name) if _torch_profiler._is_profiler_enabled else _NO_SPAN:
            yield
    finally:
        timeline_end_activity(name, activity, rank)


class _Span:
    """An open :func:`span`: its timeline start and its profiler range."""

    __slots__ = ("_name", "_activity", "_range", "_t0")

    def __init__(self, name: str, activity: str, profiling: bool):
        self._name, self._activity = name, activity
        self._range = _range(name) if profiling else None
        self._t0 = None

    def __enter__(self):
        if _active:
            self._t0 = timeline_now_us()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._t0 is not None and exc_type is None:
            timeline_record_complete(self._name, self._activity, self._t0,
                                     timeline_now_us() - self._t0)
        return False


def span(name: str, activity: str):
    """A span of the host's work, as a context manager::

        with span("combine", PHASE):
            ...

    With a timeline open, a complete record (``ph:"X"``) of ``name`` in
    category ``activity``, written when the block returns (a block that
    raises leaves none). While ``torch.profiler`` records (its own flag,
    read once as the span opens), also a ``record_function`` range
    ``bluefog.<name>``: a kernel in the profiler's trace then names the
    span by its launch (the runtime call with the kernel's
    ``correlation``), whatever the device clock's offset. With neither on,
    the block runs as it is, with no ``record_function`` call."""
    profiling = _torch_profiler._is_profiler_enabled
    if not (_active or profiling):
        return _NO_SPAN
    return _Span(name, activity, profiling)


def process_file_index() -> int:
    """The index in per-process artifact names (``<prefix><index>.json``,
    ``flight_<index>.json``): ``BLUEFOG_PROCESS_ID`` when set, else the
    ``torch.distributed`` rank when a process group is up, else 0."""
    env = os.environ.get("BLUEFOG_PROCESS_ID")
    if env is not None:
        try:
            return int(env.strip())
        except ValueError:
            from bluefog_tpu_torch.logging_util import logger

            logger.warning("BLUEFOG_PROCESS_ID=%r is not an integer; using the "
                           "torch.distributed rank for artifact file naming", env)
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def maybe_init_from_env() -> bool:
    """Honour ``BLUEFOG_TIMELINE=<prefix>``: open
    ``<prefix><process_file_index()>.json`` (creating its directory) and
    close it at exit if nothing closes it before."""
    import atexit

    global _env_owned
    prefix = os.environ.get("BLUEFOG_TIMELINE")
    if not prefix or _active:
        return False
    parent = os.path.dirname(prefix)
    if parent:
        try:
            os.makedirs(parent, exist_ok=True)
        except OSError:
            pass
    ok = timeline_init(prefix + f"{process_file_index()}.json")
    if ok:
        _env_owned = True
        atexit.register(timeline_shutdown)
    return ok
