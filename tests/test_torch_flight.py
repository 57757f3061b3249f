# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's flight recorder (``tests/test_flight.py`` for
``bluefog_tpu_torch``): the ring, the events the runtime records (in the
JAX package's order for the same steps, less its ``compile`` records,
which the port does not emit), the dump's keys (JAX's), the automatic
dumps (stall, exception, SIGTERM) and the crash hooks installed and
removed with the session."""

import glob
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import flight as jflight
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import flight, watchdog
from bluefog_tpu_torch import topology as ttu

SIZE = 8


@pytest.fixture(autouse=True)
def context(monkeypatch):
    monkeypatch.delenv("BLUEFOG_FLIGHT", raising=False)
    monkeypatch.delenv("BLUEFOG_FLIGHT_DIR", raising=False)
    monkeypatch.delenv("BLUEFOG_TIMELINE", raising=False)
    bft.init(device="cpu")
    yield
    if bft.timeline_enabled():
        bft.timeline_shutdown()
    bft.shutdown()
    flight.reconfigure()


def test_ring_bounded_and_ordered():
    rec = flight.FlightRecorder(capacity=16)
    for i in range(40):
        rec.record("e", {"i": i})
    evs = rec.events()
    assert len(evs) == 16 and len(rec) == 16
    assert [e["data"]["i"] for e in evs] == list(range(24, 40))


def test_record_disabled_is_noop(monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT", "0")
    flight.reconfigure()
    assert not flight.enabled() and flight.record("x") == -1 and flight.events() == []
    monkeypatch.delenv("BLUEFOG_FLIGHT")
    flight.reconfigure()
    assert flight.enabled()


def test_capacity_knob(monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_CAPACITY", "300")
    flight.reconfigure()
    for i in range(400):
        flight.record("e", i=i)
    assert len(flight.events()) == 300
    monkeypatch.setenv("BLUEFOG_FLIGHT_CAPACITY", "10")
    assert flight.capacity() == 256


def test_concurrent_writers_never_corrupt():
    rec = flight.FlightRecorder(capacity=1024)

    def spam(tid):
        for i in range(500):
            rec.record("t", {"tid": tid, "i": i})

    threads = [threading.Thread(target=spam, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seqs = [e["seq"] for e in rec.events()]
    assert len(seqs) == 1024 and len(set(seqs)) == 1024


def _kinds(events):
    return [e["kind"] for e in events if e["kind"] != "compile"]


def test_event_kinds_follow_jax(cpu_devices, monkeypatch):
    """The same session through both packages: init, three CTA steps on
    the static plan, a fused step, explicit weights, a window put and
    update, a nonblocking op and its synchronize."""
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    try:
        c = np.random.RandomState(0).randn(SIZE, 5).astype(np.float32)
        jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1))
        jp = {"w": bf.worker_values(list(c))}
        js = jopt.init(jp)
        for _ in range(3):
            jp, js = jopt.step(jp, js, {"w": jnp.zeros_like(jp["w"])})
        jstep = jopt.make_train_step(lambda p, t: 0.5 * jnp.sum((p["w"] - t) ** 2))
        jp, js, _ = jstep(jp, js, bf.worker_values(list(c)))
        x = bf.worker_values(list(c))
        bf.neighbor_allreduce(x, self_weight=0.5,
                              src_weights=[{(r - 1) % SIZE: 0.5} for r in range(SIZE)])
        bf.win_create(x, "fwin")
        bf.win_put(name="fwin")
        bf.win_update(name="fwin")
        bf.win_free("fwin")
        bf.synchronize(bf.allreduce_nonblocking(x))

        topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
        tp = {"w": torch.from_numpy(c.copy())}
        ts = topt.init(tp)
        for _ in range(3):
            topt.step(tp, ts, {"w": torch.zeros_like(tp["w"])})
        tstep = topt.make_train_step(lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2))
        tstep(tp, ts, torch.from_numpy(c))
        x = bft.worker_values(list(c))
        bft.neighbor_allreduce(x, self_weight=0.5,
                               src_weights=[{(r - 1) % SIZE: 0.5} for r in range(SIZE)])
        bft.win_create(x, "fwin")
        bft.win_put(name="fwin")
        bft.win_update(name="fwin")
        bft.win_free("fwin")
        bft.synchronize(bft.allreduce_nonblocking(x))

        want, got = jflight.events(), flight.events()
        assert _kinds(got) == _kinds(want)
        strip = lambda evs: [e.get("data", {}) for e in evs  # noqa: E731
                             if e["kind"] in ("step_begin", "step_dispatched", "window_op",
                                              "plan_compile")]
        assert strip(got) == strip(want)
        assert [p["rounds"] for p in flight._plans] == [p["rounds"] for p in jflight._plans]
    finally:
        bf.shutdown()


def test_explicit_dump_has_jax_keys(cpu_devices, tmp_path):
    bf.init(devices=cpu_devices[:SIZE])
    try:
        jpath = bf.flight_dump(str(tmp_path / "j.json"))
    finally:
        bf.shutdown()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    params = {"w": bft.worker_values(lambda r: np.float32([r]))}
    state = opt.init(params)
    opt.step(params, state, {"w": torch.zeros_like(params["w"])})
    path = bft.flight_dump(str(tmp_path / "flight_0.json"))
    dump = json.load(open(path))
    jdump = json.load(open(jpath))
    assert set(dump) == set(jdump)
    assert set(dump["world"]) == set(jdump["world"])
    assert dump["version"] == flight.DUMP_VERSION == jflight.DUMP_VERSION
    assert dump["reason"] == "explicit" and dump["dump_history"] == ["explicit"]
    assert dump["world"]["size"] == SIZE and dump["world"]["ranks"] == list(range(SIZE))
    assert dump["clock"]["unix_ns"] > 0 and dump["clock"]["mono_us"] > 0
    plan = dump["comm_plans"][-1]
    assert plan["n_rounds"] == len(plan["rounds"]) and plan["kind"] == "worker"
    assert any(e["kind"] == "step_begin" for e in dump["events"])
    assert dump["metrics"]["bluefog.size"]["value"] == SIZE


def test_default_dump_path_and_process_index(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path / "d"))
    monkeypatch.setenv("BLUEFOG_PROCESS_ID", "4")
    path = bft.flight_dump()
    assert path == str(tmp_path / "d" / "flight_4.json")
    assert json.load(open(path))["process_index"] == 4


def test_window_and_async_events_recorded():
    x = bft.worker_values(lambda r: np.float32([r]))
    bft.win_create(x, "flight_win")
    bft.win_put(name="flight_win")
    bft.win_update(name="flight_win")
    bft.win_free("flight_win")
    ops = [e["data"]["op"] for e in flight.events() if e["kind"] == "window_op"]
    assert ops == ["put", "update"]
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    z0 = np.random.RandomState(0).randn(SIZE, 3).astype(np.float32)
    step = bft.make_async_train_step(opt, lambda p, t: torch.sum((p["w"] - t) ** 2),
                                     cadence={6: 5}, max_age=1)
    p, s = {"w": torch.from_numpy(z0)}, opt.init({"w": torch.from_numpy(z0)})
    for _ in range(6):
        p, s, _ = step(p, s, torch.from_numpy(z0))
    ticks = [e for e in flight.events() if e["kind"] == "async_tick"]
    assert [e["data"]["tick"] for e in ticks] == list(range(6))
    adv = [e for e in flight.events() if e["kind"] == "advisory"]
    assert adv and adv[0]["data"]["advisory_kind"] == "async_staleness"
    assert flight._advisories and flight._advisories[0]["slow_ranks"] == [6]
    step.engine.free()


def test_stall_triggers_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    watchdog.set_stall_timeout(0.1)
    try:
        with watchdog.watch("flight-stall-op"):
            time.sleep(0.5)
    finally:
        watchdog.set_stall_timeout(60)
    files = glob.glob(str(tmp_path / "flight_*.json"))
    assert files, "stall did not trigger a flight dump"
    dump = json.load(open(files[0]))
    assert dump["reason"].startswith("stall:flight-stall-op")
    assert any(e["kind"] == "stall" for e in dump["events"])
    assert dump["metrics"]["bluefog.stalls"]["value"] >= 1


def test_synchronize_stall_is_caught(tmp_path, monkeypatch):
    """A wait that outlives the deadline inside ``synchronize``: the
    flight records around it, a dump naming the handle."""
    from bluefog_tpu_torch.collective import ops as tops

    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    handle = bft.allreduce_nonblocking(bft.worker_values(np.float32(1)))
    result, _event, post = tops._handle_map[handle]

    class SlowEvent:
        def synchronize(self):
            time.sleep(0.5)

    tops._handle_map[handle] = (result, SlowEvent(), post)
    watchdog.set_stall_timeout(0.1)
    try:
        bft.synchronize(handle)
    finally:
        watchdog.set_stall_timeout(60)
    kinds = [e["kind"] for e in flight.events()]
    assert kinds.index("sync_begin") < kinds.index("stall") < kinds.index("sync_ready")
    dump = json.load(open(glob.glob(str(tmp_path / "flight_*.json"))[0]))
    assert dump["reason"] == f"stall:synchronize(handle {handle})"


def test_maybe_dump_noop_without_dir():
    assert flight.dump_dir() is None
    assert flight.maybe_dump("stall:x") is None


def test_crash_hooks_follow_the_session(tmp_path, monkeypatch):
    prev = sys.excepthook
    bft.shutdown()
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    bft.init(device="cpu")
    # the memory observatory's OOM hook installs after (so runs before) the
    # flight recorder's, as in the JAX package
    from bluefog_tpu_torch import memory

    assert sys.excepthook is memory._excepthook
    assert memory._prev_excepthook is flight._excepthook
    assert signal.getsignal(signal.SIGTERM) is flight._sigterm_handler
    assert flight._on_stall in watchdog._handlers
    bft.shutdown()
    assert sys.excepthook is prev
    assert signal.getsignal(signal.SIGTERM) is not flight._sigterm_handler
    assert flight._on_stall not in watchdog._handlers
    kinds = [e["kind"] for e in flight.events()]
    assert kinds[0] == "session_start" and kinds[-1] == "session_end"
    bft.init(device="cpu")


def test_excepthook_dumps_and_chains(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a))
    flight._install_crash_hooks()
    try:
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
    finally:
        flight._uninstall_crash_hooks()
    assert seen and seen[0][0] is ValueError
    dump = json.load(open(glob.glob(str(tmp_path / "flight_*.json"))[0]))
    assert dump["reason"] == "exception:ValueError"
    crash = [e for e in dump["events"] if e["kind"] == "crash"]
    assert crash and crash[0]["data"]["message"] == "boom"


def test_sigterm_dumps_and_chains(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    flight._install_crash_hooks()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if seen:
                break
            time.sleep(0.01)
    finally:
        flight._uninstall_crash_hooks()
        signal.signal(signal.SIGTERM, prev)
    assert seen == [signal.SIGTERM]
    assert json.load(open(glob.glob(str(tmp_path / "flight_*.json"))[0]))["reason"] == "sigterm"


def test_flight_on_off_bitwise(monkeypatch):
    """Recording touches no device value: the same steps with the recorder
    off give the same bits."""
    c = np.random.RandomState(2).randn(SIZE, 700).astype(np.float32)
    out = []
    for on in ("1", "0"):
        monkeypatch.setenv("BLUEFOG_FLIGHT", on)
        bft.init(device="cpu")
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int4_ef"
        p = {"w": torch.from_numpy(c.copy())}
        s = opt.init(p)
        for _ in range(3):
            opt.step(p, s, {"w": p["w"] * 0.1})
        out.append(p["w"].clone())
        assert bool(flight.events()) == (on == "1")
    assert torch.equal(out[0].view(torch.int32), out[1].view(torch.int32))
