# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's timeline, logging and watchdog (``tests/test_timeline.py``
for ``bluefog_tpu_torch``): activate through the API and the environment,
run ops, and parse the Chrome-trace JSON. The writer's record strings are
held to the JAX package's ``_PyWriter``'s for the same calls; the rest
are the JAX tests' own checks."""

import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch import watchdog

SIZE = 8


@pytest.fixture(autouse=True)
def context(monkeypatch):
    monkeypatch.delenv("BLUEFOG_TIMELINE", raising=False)
    monkeypatch.delenv("BLUEFOG_PROCESS_ID", raising=False)
    bft.init(device="cpu")
    yield
    if bft.timeline_enabled():
        bft.timeline_shutdown()
    bft.shutdown()


def _x():
    return bft.worker_values(lambda r: np.float32(r))


def test_timeline_records_ops(tmp_path):
    path = str(tmp_path / "trace.json")
    assert bft.timeline_init(path)
    assert bft.timeline_enabled()
    x = _x()
    with bft.timeline_context("consensus", "USER_SPAN"):
        for _ in range(3):
            x = bft.neighbor_allreduce(x)
    bft.synchronize(bft.neighbor_allreduce_nonblocking(x))
    assert bft.timeline_shutdown()
    assert not bft.timeline_enabled()
    events = json.load(open(path))
    cats = {e.get("cat") for e in events}
    assert {"ENQUEUE", "SYNCHRONIZE", "USER_SPAN"} <= cats
    spans = [e for e in events if e.get("cat") == "USER_SPAN"]
    assert {e["ph"] for e in spans} == {"B", "E"}
    assert all(isinstance(e["ts"], int) for e in events)
    assert {e["name"] for e in events if e["cat"] == "ENQUEUE"} == {"neighbor_allreduce"}


@pytest.mark.parametrize("op", ["allreduce", "allgather", "broadcast", "neighbor_allgather",
                                "pair_gossip", "barrier"])
def test_every_facade_op_is_an_enqueue_span(tmp_path, op):
    path = str(tmp_path / "ops.json")
    assert bft.timeline_init(path)
    x = _x()
    calls = {"allreduce": lambda: bft.allreduce(x), "allgather": lambda: bft.allgather(x),
             "broadcast": lambda: bft.broadcast(x, 0),
             "neighbor_allgather": lambda: bft.neighbor_allgather(x, compression="int8"),
             "pair_gossip": lambda: bft.pair_gossip(x, [(0, 1)]), "barrier": bft.barrier}
    calls[op]()
    assert bft.timeline_shutdown()
    names = {e["name"] for e in json.load(open(path)) if e["cat"] == "ENQUEUE"}
    assert names == {op}


def test_timeline_env_activation(tmp_path, monkeypatch):
    prefix = str(tmp_path / "sub" / "envtrace_")
    monkeypatch.setenv("BLUEFOG_TIMELINE", prefix)
    bft.init(device="cpu")
    assert bft.timeline_enabled() and tl.timeline_env_owned()
    bft.allreduce(_x())
    bft.shutdown()  # closes the timeline init opened
    assert not bft.timeline_enabled()
    events = json.load(open(prefix + "0.json"))
    assert any(e.get("cat") == "ENQUEUE" for e in events)


def test_user_timeline_survives_shutdown(tmp_path):
    assert bft.timeline_init(str(tmp_path / "user.json"))
    bft.shutdown()
    assert bft.timeline_enabled()  # the user's to close
    assert bft.timeline_shutdown()
    bft.init(device="cpu")


def test_timeline_counter_events_valid_chrome_trace(tmp_path, monkeypatch):
    path = str(tmp_path / "counters.json")
    assert bft.timeline_init(path)
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    x = _x()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    params = {"w": x}
    state = opt.init(params)
    opt.step(params, state, {"w": torch.zeros_like(x)})
    bft.metrics_export()
    bft.timeline_record_counter("bluefog.custom", 1.25)
    bft.timeline_record_instant("marker")
    assert bft.timeline_shutdown()
    events = json.load(open(path))
    counters = [e for e in events if e.get("ph") == "C"]
    assert all("value" in e["args"] and isinstance(e["ts"], int) for e in counters)
    names = {e["name"] for e in counters}
    assert {"bluefog.custom", "bluefog.gossip.disagreement"} <= names
    instants = [e for e in events if e.get("ph") == "i"]
    assert instants and instants[0]["s"] == "p"
    assert any(e.get("cat") == "ENQUEUE" and e["name"] == "optimizer_step" for e in events)


def test_double_init_rejected(tmp_path):
    path = str(tmp_path / "t.json")
    assert bft.timeline_init(path)
    assert not bft.timeline_init(path)
    bft.timeline_shutdown()


def test_log_level_env():
    bft.set_log_level("debug")
    assert bft.logger.level == logging.DEBUG
    bft.set_log_level("warn")
    with pytest.raises(ValueError):
        bft.set_log_level("chatty")


def test_watchdog_reports_stall(caplog):
    watchdog.set_stall_timeout(0.1)
    bft.logger.propagate = True
    try:
        with caplog.at_level("ERROR", logger="bluefog_tpu_torch"):
            with watchdog.watch("test-op"):
                time.sleep(0.4)
        assert any("Stall detected" in r.message for r in caplog.records)
    finally:
        bft.logger.propagate = False
        watchdog.set_stall_timeout(60)


def test_record_complete_returns_bool(tmp_path):
    assert tl.timeline_record_complete("x", "CAT", 0, 1) is False
    assert bft.timeline_init(str(tmp_path / "rc.json"))
    assert tl.timeline_record_complete("x", "CAT", 0, 1) is True
    assert bft.timeline_shutdown()


def test_writer_records_match_jax(tmp_path):
    """The same calls through the port's writer and the JAX package's
    Python writer give the same records (timestamps aside)."""
    from bluefog_tpu.timeline import _PyWriter as JWriter

    out = []
    for cls, name in ((tl._PyWriter, "t"), (JWriter, "j")):
        w = cls()
        path = tmp_path / f"{name}.json"
        assert w.bf_timeline_start(str(path).encode())
        w.bf_timeline_record(b'sp"an\\', b"CAT", b"B", 0, 1)
        w.bf_timeline_record(b"mark", b"STALL", b"i", 2, 0)
        w.bf_timeline_record_counter(b"ctr", b"COUNTER", 0, 0, 1.5e-7)
        w.bf_timeline_record_complete(b"op", b"ENQUEUE", 0, 0, 17, 42)
        w.bf_timeline_stop()
        out.append([{k: v for k, v in e.items() if k != "ts" or e["ph"] == "X"}
                    for e in json.load(open(path))])
    assert out[0] == out[1]


def test_pywriter_concurrent_records_stay_valid_json(tmp_path):
    w = tl._PyWriter()
    path = tmp_path / "py.json"
    assert w.bf_timeline_start(str(path).encode())

    def spam(tid):
        for _ in range(200):
            w.bf_timeline_record(b"span", b"CAT", b"B", 0, tid)
            w.bf_timeline_record_counter(b"ctr", b"CAT", 0, tid, 1.5)
            w.bf_timeline_record(b"span", b"CAT", b"E", 0, tid)

    threads = [threading.Thread(target=spam, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.bf_timeline_stop()
    assert len(json.load(open(path))) == 4 * 200 * 3


def test_counter_nonfinite_guard(tmp_path):
    path = str(tmp_path / "nonfinite.json")
    assert bft.timeline_init(path)
    assert bft.timeline_record_counter("ok", 1.0) is True
    for bad in (float("nan"), float("inf"), float("-inf")):
        assert bft.timeline_record_counter("bad", bad) is False
    assert bft.timeline_shutdown()
    counters = [e for e in json.load(open(path)) if e.get("ph") == "C"]
    assert {e["name"] for e in counters} == {"ok"}


def test_env_activation_uses_process_index(tmp_path, monkeypatch):
    assert tl.process_file_index() == 0
    monkeypatch.setenv("BLUEFOG_PROCESS_ID", "3")
    assert tl.process_file_index() == 3
    prefix = str(tmp_path / "proc_")
    monkeypatch.setenv("BLUEFOG_TIMELINE", prefix)
    assert tl.maybe_init_from_env()
    bft.allreduce(_x())
    bft.timeline_shutdown()
    assert not os.path.exists(prefix + "0.json")
    assert isinstance(json.load(open(prefix + "3.json")), list)


def test_process_index_from_torch_distributed(tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 5)
    assert tl.process_file_index() == 5
    monkeypatch.setenv("BLUEFOG_PROCESS_ID", "2")
    assert tl.process_file_index() == 2


def test_watchdog_suspend_resume_clock_restart(caplog):
    watchdog.set_stall_timeout(0.3)
    bft.logger.propagate = True
    try:
        with caplog.at_level("ERROR", logger="bluefog_tpu_torch"):
            with watchdog.watch("suspended-op"):
                bft.suspend()
                time.sleep(0.6)
                bft.resume()
                time.sleep(0.1)
            assert not any("Stall detected" in r.message for r in caplog.records)
            with watchdog.watch("post-resume-op"):
                time.sleep(0.7)
        assert any("post-resume-op" in r.message for r in caplog.records)
    finally:
        bft.logger.propagate = False
        watchdog.resume()
        bft.set_stall_timeout(60)


def test_stall_handler_exception_isolated(caplog):
    calls = []

    def bad(name, waited):
        raise RuntimeError("handler boom")

    def good(name, waited):
        calls.append(name)

    watchdog.add_stall_handler(bad)
    watchdog.add_stall_handler(good)
    watchdog.set_stall_timeout(0.1)
    bft.logger.propagate = True
    try:
        with caplog.at_level("ERROR", logger="bluefog_tpu_torch"):
            with watchdog.watch("iso-op"):
                time.sleep(0.5)
            assert "iso-op" in calls
            assert any("stall handler" in r.message for r in caplog.records)
            calls.clear()
            with watchdog.watch("iso-op-2"):
                time.sleep(0.5)
        assert "iso-op-2" in calls
    finally:
        bft.logger.propagate = False
        watchdog.remove_stall_handler(bad)
        watchdog.remove_stall_handler(good)
        watchdog.set_stall_timeout(60)


def test_watchdog_quiet_when_fast(caplog):
    watchdog.set_stall_timeout(5)
    bft.logger.propagate = True
    try:
        with caplog.at_level("ERROR", logger="bluefog_tpu_torch"):
            for _ in range(3):
                bft.synchronize(bft.allreduce_nonblocking(_x()))
        assert not caplog.records
    finally:
        bft.logger.propagate = False
        watchdog.set_stall_timeout(60)


def test_optimizer_steps_record_spans(tmp_path):
    path = str(tmp_path / "opt_trace.json")
    assert bft.timeline_init(path)
    try:
        c = np.random.RandomState(0).randn(SIZE, 3).astype(np.float32)
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
        params = {"w": torch.from_numpy(c.copy())}
        state = opt.init(params)
        opt.step(params, state, {"w": params["w"] - torch.from_numpy(c)})
        step = opt.make_train_step(lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2))
        step(params, state, torch.from_numpy(c))
        wopt = bft.DistributedWinPutOptimizer(bft.sgd(0.1), num_steps_per_communication=2)
        wstate = wopt.init(params)
        for _ in range(2):
            wopt.step(wstate, {"w": params["w"] - torch.from_numpy(c)})
        wopt.free()
        astep = bft.make_async_train_step(bft.DistributedNeighborAllreduceOptimizer(
            bft.sgd(0.1)), lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2))
        astep(params, state, torch.from_numpy(c))
        astep.engine.free()
    finally:
        assert bft.timeline_shutdown()
    names = {e.get("name") for e in json.load(open(path))}
    assert {"optimizer_step", "fused_train_step", "window_optimizer_step",
            "window_optimizer_step_local", "async_tick"} <= names, names


def test_profiler_tier(tmp_path):
    """``timeline_init(profiler=True)`` brackets the session with
    ``torch.profiler``: its Chrome trace lands beside the host JSON."""
    path = str(tmp_path / "trace.json")
    assert bft.timeline_init(path, profiler=True)
    bft.allreduce(_x())
    assert bft.timeline_shutdown()
    prof = os.path.join(path + ".torch", "trace_0.json")
    trace = json.load(open(prof))
    assert trace["traceEvents"]
    assert json.load(open(path))


# -- the native writer --------------------------------------------------------------


def _record_sequence(w, path):
    """One call of each record kind through a writer (the native library or
    a ``_PyWriter``), names with a quote, a backslash and a control
    character; returns the parsed records without ``ts`` and ``dur``."""
    assert w.bf_timeline_start(str(path).encode())
    w.bf_timeline_record(b'sp"an\\', b"CAT", b"B", 0, 1)
    w.bf_timeline_record(b"line\nbreak\ttab", b"STALL", b"i", 2, 0)
    w.bf_timeline_record_counter(b"ctr", b"COUNTER", 0, 0, 1.5e-7)
    w.bf_timeline_record_counter(b"big", b"COUNTER", 3, 4, 123456789.0)
    w.bf_timeline_record_complete(b"op", b"ENQUEUE", 0, 0, 17, 42)
    w.bf_timeline_record(b'sp"an\\', b"", b"E", 0, 1)
    w.bf_timeline_stop()
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in json.load(open(path))]


def test_native_writer_builds():
    """The C++ writer compiles and loads here, where ``g++`` exists (the
    JAX package's ``tests/test_timeline.py::test_native_writer_builds``)."""
    assert tl.using_native_writer()
    import ctypes

    assert isinstance(tl._load_native(), ctypes.CDLL)


def test_native_records_equal_python_and_jax_native(tmp_path):
    """The same calls through the port's native writer, its ``_PyWriter``
    and the JAX package's native writer give the same records."""
    import ctypes

    from bluefog_tpu import timeline as jtl
    from bluefog_tpu_torch import _build

    jlib = jtl._load_native()
    assert isinstance(jlib, ctypes.CDLL)
    native = _record_sequence(_build.timeline_library(), tmp_path / "native.json")
    python = _record_sequence(tl._PyWriter(), tmp_path / "python.json")
    jax_native = _record_sequence(jlib, tmp_path / "jax.json")
    assert native == python == jax_native
    assert native[1]["name"] == "linebreaktab" and native[0]["name"] == 'sp"an\\'
    assert [e["ph"] for e in native] == ["B", "i", "C", "C", "X", "E"]


def test_native_writer_concurrent_records_stay_valid_json(tmp_path):
    from bluefog_tpu_torch import _build

    w = _build.timeline_library()
    path = tmp_path / "native.json"
    assert w.bf_timeline_start(str(path).encode())

    def spam(tid):
        for _ in range(200):
            w.bf_timeline_record(b"span", b"CAT", b"B", 0, tid)
            w.bf_timeline_record_counter(b"ctr", b"CAT", 0, tid, 1.5)
            w.bf_timeline_record(b"span", b"CAT", b"E", 0, tid)

    threads = [threading.Thread(target=spam, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.bf_timeline_stop()
    assert len(json.load(open(path))) == 4 * 200 * 3


@pytest.mark.parametrize("writer", ["native", "python"])
def test_counter_nonfinite_guard_on_each_writer(tmp_path, writer):
    import contextlib

    hook = tl.python_writer() if writer == "python" else contextlib.nullcontext()
    path = str(tmp_path / "nonfinite.json")
    with hook:
        assert tl.using_native_writer() == (writer == "native")
        assert bft.timeline_init(path)
        assert bft.timeline_record_counter("ok", 1.0) is True
        for bad in (float("nan"), float("inf"), float("-inf")):
            assert bft.timeline_record_counter("bad", bad) is False
        assert bft.timeline_shutdown()
    counters = [e for e in json.load(open(path)) if e.get("ph") == "C"]
    assert {e["name"] for e in counters} == {"ok"}
    assert tl.using_native_writer()


def test_python_writer_hook_restores_and_refuses_an_open_timeline(tmp_path):
    assert bft.timeline_init(str(tmp_path / "open.json"))
    with pytest.raises(RuntimeError, match="open"):
        with tl.python_writer():
            pass
    assert bft.timeline_shutdown()
    with tl.python_writer():
        assert not tl.using_native_writer()
    assert tl.using_native_writer()


def test_python_writer_only_without_gxx_or_a_writable_build_dir(monkeypatch, tmp_path):
    """JAX's rule for the fallback: no ``g++``, or no writable build
    directory; a ``g++`` whose build fails raises with its output."""
    from bluefog_tpu_torch import _build

    monkeypatch.setattr(tl, "_writer", None)
    monkeypatch.setattr(_build, "find_cxx", lambda: None)
    assert not tl.using_native_writer()
    monkeypatch.setattr(tl, "_writer", None)
    monkeypatch.undo()
    monkeypatch.setattr(tl, "_writer", None)
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(_build, "build_dir", lambda: blocker / "torch_kernels")
    assert not tl.using_native_writer()
    monkeypatch.setattr(tl, "_writer", None)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "timeline_writer.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    _build.timeline_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="timeline_writer.cc"):
            tl.using_native_writer()
    finally:
        _build.timeline_library.cache_clear()
        monkeypatch.setattr(tl, "_writer", None)
