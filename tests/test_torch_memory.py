# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's memory observatory (``bft.memory``) against the JAX package's
``bf.memory``, mirroring ``tests/test_memory.py`` (the health plane's fleet
slots are held in ``tests/test_torch_health.py``).

Tolerances. Bytes are integers: the census's owner categories, the
analytic and measured optimizer-state bytes and the reconciliation are held
EXACTLY to JAX's on the same problems. JAX files every unclassified live
array under ``other`` and the port, which has no list of live tensors, files
there the CUDA allocator's unclassified bytes (0 on the CPU), so ``other``
and the totals built on it are compared only on the port's own terms.
Trajectories with the observatory on and off are held BITWISE.
"""

import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import memory as jmemory
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import scaling as jscaling
from bluefog_tpu_torch import flight, memory, metrics, scaling
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.logging_util import env_float, env_int

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    for k in ("BLUEFOG_MEMORY", "BLUEFOG_MEMORY_INTERVAL", "BLUEFOG_MEMORY_BUDGET",
              "BLUEFOG_MEMORY_FILE", "BLUEFOG_MEMORY_DRIFT_TOL", "BLUEFOG_SHARD",
              "BLUEFOG_SHARD_GRADS", "BLUEFOG_SHARD_MASTER", "BLUEFOG_METRICS",
              "BLUEFOG_FLIGHT_DIR"):
        monkeypatch.delenv(k, raising=False)
    metrics.reset()
    jmetrics.reset()
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    memory.stop()
    jmemory.stop()
    bft.elastic.stop()
    bf.elastic.stop()
    bf.win_free()
    bf.shutdown()
    if bft.is_initialized():
        bft.shutdown()
    flight.reconfigure()
    metrics.reset()
    jmetrics.reset()


def _adam(dim=4096, order="grad", side="port"):
    """The JAX test's Adam problem: ``(opt, params, state, grads)``."""
    z0 = np.random.RandomState(0).randn(SIZE, dim).astype(np.float32)
    if side == "port":
        cls = (bft.DistributedGradientAllreduceOptimizer if order == "grad"
               else bft.DistributedNeighborAllreduceOptimizer)
        opt = cls(bft.adam(0.01))
        params = {"w": torch.from_numpy(z0.copy())}
        return opt, params, opt.init(params), {"w": torch.zeros(SIZE, dim)}
    cls = (bf.DistributedGradientAllreduceOptimizer if order == "grad"
           else bf.DistributedNeighborAllreduceOptimizer)
    opt = cls(optax.adam(0.01))
    params = {"w": bf.worker_values(lambda r: z0[r])}
    zeros = {"w": bf.worker_values(lambda r: np.zeros(dim, np.float32))}
    return opt, params, opt.init(params), zeros


def _owned(c):
    return {k: v for k, v in c.items() if k != "other"}


# -- the knobs and the byte models -----------------------------------------------------


def test_knobs_parse_as_the_jax_modules_do(monkeypatch):
    from bluefog_tpu import logging_util as jlogging_util
    from bluefog_tpu_torch import attribution, logging_util, staleness
    from bluefog_tpu import attribution as jattribution
    from bluefog_tpu import staleness as jstaleness

    monkeypatch.setenv("BLUEFOG_MEMORY_INTERVAL", "twenty")
    key = "env_int:BLUEFOG_MEMORY_INTERVAL:twenty"
    logging_util._warned_once.discard(key)
    assert memory.memory_interval() == jmemory.memory_interval() == 20
    assert key in logging_util._warned_once
    n = len(logging_util._warned_once)
    memory.memory_interval()
    assert len(logging_util._warned_once) == n
    monkeypatch.setenv("X_INT", "42")
    monkeypatch.setenv("X_FLOAT", "2.5")
    assert env_int("X_INT", 7) == jlogging_util.env_int("X_INT", 7) == 42
    assert env_float("X_FLOAT", 1.0) == jlogging_util.env_float("X_FLOAT", 1.0) == 2.5
    for k in ("BLUEFOG_DOCTOR_INTERVAL", "BLUEFOG_STALENESS_INTERVAL", "BLUEFOG_STALENESS_BOUND",
              "BLUEFOG_MEMORY_BUDGET", "BLUEFOG_MEMORY_DRIFT_TOL"):
        monkeypatch.setenv(k, "not-a-number")
    assert memory.memory_budget() == jmemory.memory_budget() == 0
    assert memory.drift_tolerance() == jmemory.drift_tolerance() == 0.10
    assert attribution.doctor_interval() == jattribution.doctor_interval() == 100
    assert staleness.staleness_interval() == jstaleness.staleness_interval() == 20
    assert staleness.staleness_bound() == jstaleness.staleness_bound() == 4
    monkeypatch.setenv("BLUEFOG_MEMORY_BUDGET", "123456")
    monkeypatch.setenv("BLUEFOG_MEMORY_DRIFT_TOL", "-1")
    assert memory.memory_budget() == jmemory.memory_budget() == 123456
    assert memory.drift_tolerance() == jmemory.drift_tolerance() == 0.10
    assert memory.CATEGORIES == jmemory.CATEGORIES


@pytest.mark.parametrize("fused", [False, True])
def test_quantized_temporaries_model_equals_jax(fused):
    for n in (0, 1, 100, 512, 4096, 70_123):
        for wire in (None, "bf16", "int8", "int8_ef", "int4", "int4_ef"):
            assert scaling.quantized_temporaries_bytes(n, wire, fused=fused) == \
                jscaling.quantized_temporaries_bytes(n, wire, fused=fused)


# -- the census and the reconciliation --------------------------------------------------


@pytest.mark.parametrize("shard", [False, True])
def test_census_owner_bytes_equal_jax(shard, monkeypatch):
    """The owner categories of the replicated and the sharded Adam problems,
    byte for byte; a storage shared by views counts once."""
    if shard:
        monkeypatch.setenv("BLUEFOG_SHARD", "1")
    dim = 1 << 15 if shard else 4096
    got, want = {}, {}
    for side, out, mod in (("port", got, memory), ("jax", want, jmemory)):
        opt, params, state, grads = _adam(dim, side=side)
        params, state = opt.step(params, state, grads)
        out["c0"] = mod.census({"params": params, "opt_state": state})
        out["c1"] = mod.census({"params": params, "opt_state": state, "grads": grads})
    assert _owned(got["c0"]) == _owned(want["c0"])
    assert _owned(got["c1"]) == _owned(want["c1"])
    assert got["c0"]["params"]["bytes"] == SIZE * dim * 4
    assert got["c1"]["grads"]["bytes"] == SIZE * dim * 4 and got["c0"]["grads"]["bytes"] == 0
    assert got["c0"]["other"] == {"bytes": 0, "arrays": 0}  # no allocator on the CPU
    flat = torch.zeros(SIZE, 64)
    views = {"params": [flat[:, :32], flat[:, 32:]], "windows": flat[:, 1:3]}
    c = memory.census(views)
    assert c["params"] == {"bytes": SIZE * 64 * 4, "arrays": 1} and c["windows"]["bytes"] == 0
    ranked = memory.ranked_census(got["c1"])
    assert [r["bytes"] for r in ranked] == sorted((r["bytes"] for r in ranked), reverse=True)


@pytest.mark.parametrize("shard", [False, True])
def test_reconciliation_is_exact_and_equals_jax(shard, monkeypatch):
    if shard:
        monkeypatch.setenv("BLUEFOG_SHARD", "1")
    dim = 1 << 15 if shard else 4096
    rows = {}
    for side, mod in (("port", memory), ("jax", jmemory)):
        obs = mod.start(interval=1)
        opt, params, state, grads = _adam(dim, side=side)
        for _ in range(3):
            params, state = opt.step(params, state, grads)
        rows[side] = [(s["measured_state_bytes"], s["analytic_state_bytes"],
                       s["reconcile_rel_err"]) for s in obs.samples]
        assert not obs.advisories
        if side == "port":
            full = scaling.optimizer_state_bytes(params, opt, shard=False)
    assert rows["port"] == rows["jax"]
    assert all(m == a and e == 0.0 for m, a, e in rows["port"])
    assert (rows["port"][0][1] < full) == shard


def test_memory_drift_fires_on_a_planted_leak_equal_jax():
    details = {}
    for side, mod, met in (("port", memory, metrics), ("jax", jmemory, jmetrics)):
        obs = mod.start(interval=1)
        opt, params, state, _grads = _adam(side=side)
        leak = (torch.zeros(SIZE, 4096) if side == "port"
                else bf.worker_values(lambda r: np.zeros(4096, np.float32)))
        ctx = bft.get_context() if side == "port" else bf.get_context()
        for step in range(mod.DRIFT_STREAK + 1):
            obs.observe(ctx, step=step, optimizer=opt, params=params,
                        opt_state=(state, leak, leak))
        drifts = [a for a in obs.advisories if a.kind == "memory_drift"]
        assert len(drifts) == 1
        details[side] = {k: v for k, v in drifts[0].to_json().items() if k != "census"}
        assert met.peek("bluefog.doctor.advisory.memory_drift").value == 1
    assert details["port"] == details["jax"]
    assert details["port"]["measured_state_bytes"] > details["port"]["analytic_state_bytes"]
    assert any(a.get("kind") == "memory_drift" for a in flight._advisories)


def test_pressure_with_the_shard_hint_and_its_cooldowns():
    obs = memory.start(interval=1)
    opt, params, state, grads = _adam(dim=1 << 15)
    params, state = opt.step(params, state, grads)
    obs.budget = max(int(obs.last_bytes_per_rank() * 0.9), 1)
    for _ in range(3):
        params, state = opt.step(params, state, grads)
    pressures = [a for a in obs.advisories if a.kind == "memory_pressure"]
    assert len(pressures) == 1
    d = pressures[0].detail
    assert d["headroom_bytes"] < 0 and d["shard_enabled"] is False and d["shard_hint"] is True
    assert d["census"][0]["category"] == "opt_state" and obs.last_headroom() < 0
    assert obs.pressure_active()
    # the cooldown runs on the sample clock: quiet samples expire it, and
    # the next episode fires at once
    obs.budget = 1 << 40
    for _ in range(memory.ADVISORY_COOLDOWN + 1):
        params, state = opt.step(params, state, grads)
    assert not obs.pressure_active()
    obs.budget = 1
    for _ in range(memory.ADVISORY_COOLDOWN):
        params, state = opt.step(params, state, grads)
    assert len([a for a in obs.advisories if a.kind == "memory_pressure"]) == 2
    assert memory.ADVISORY_COOLDOWN == jmemory.ADVISORY_COOLDOWN
    assert memory.WATERMARK_MADS == jmemory.WATERMARK_MADS


def test_autotune_decision_records_carry_memory_pressure():
    """JAX's test of the same name: the controller's flag is 'an
    un-cooled-down advisory right now', true inside the re-fire window and
    false once it expires, on the port as on JAX."""
    from bluefog_tpu import autotune as jautotune
    from bluefog_tpu_torch import autotune

    flags = {}
    for side, mem, at in (("port", memory, autotune), ("jax", jmemory, jautotune)):
        obs = mem.start(interval=1)
        seen = [at._memory_pressure()]
        obs.budget = 1
        opt, params, state, grads = _adam(side=side)
        params, state = opt.step(params, state, grads)
        seen.append(at._memory_pressure())
        obs.budget = 1 << 40  # relieved; let the cooldown run out
        for _ in range(mem.ADVISORY_COOLDOWN + 1):
            params, state = opt.step(params, state, grads)
        seen.append(at._memory_pressure())
        flags[side] = seen
    assert flags["port"] == flags["jax"] == [False, True, False]


def test_pressure_shard_hint_off_under_zero(monkeypatch):
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    obs = memory.start(interval=1, budget=1)
    opt, params, state, grads = _adam(dim=1 << 15)
    params, state = opt.step(params, state, grads)
    (adv,) = [a for a in obs.advisories if a.kind == "memory_pressure"]
    assert adv.detail["shard_enabled"] is True and adv.detail["shard_hint"] is False


# -- phases and neutrality --------------------------------------------------------------


def test_phase_scopes_and_the_checkpoint_phase(tmp_path):
    memory.stop()
    with memory.phase_scope("dispatch"):
        pass
    assert memory.active() is None
    obs = memory.start(interval=1)
    opt, params, state, grads = _adam(dim=512)
    params, state = opt.step(params, state, grads)
    assert obs.phase_peaks["dispatch"]["count"] == 1
    assert obs.phase_peaks["dispatch"]["peak_rss_bytes"] > 0
    assert "compile" not in obs.phase_peaks  # eager PyTorch compiles no program
    assert metrics.peek("bluefog.memory.phase_peak_bytes.dispatch").value > 0
    bft.checkpoint.save(str(tmp_path / "ckpt"), 1, params, state, optimizer=opt)
    assert obs.phase_peaks["checkpoint_save"]["count"] == 1
    params, state = opt.step(params, state, grads)
    assert "checkpoint_save" in obs.samples[-1]["phase_peaks"]


@pytest.mark.parametrize("order", ["grad", "na"])
def test_observatory_on_and_off_are_bitwise(order):
    ctx = bft.get_context()

    def run(on):
        if on:
            memory.start(interval=1)
        else:
            memory.stop()
        opt, params, state, grads = _adam(order=order)
        grads = {"w": torch.from_numpy(np.random.RandomState(1).randn(SIZE, 4096)
                                       .astype(np.float32))}
        keys = set(ctx.op_cache)
        for _ in range(3):
            params, state = opt.step(params, state, grads)
        assert set(ctx.op_cache) == keys
        return params["w"].clone(), state["mu"]["w"].clone()

    off, on = run(False), run(True)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(off, on))
    assert len(memory.active().samples) == 3


# -- OOM forensics --------------------------------------------------------------------


def test_is_oom_matches_the_jax_shapes_and_the_cuda_allocator():
    for exc in (MemoryError("boom"), RuntimeError("RESOURCE_EXHAUSTED: Out of memory"),
                ValueError("nope"), memory.SimulatedResourceExhausted("x")):
        assert memory._is_oom(type(exc), exc) == jmemory._is_oom(type(exc), exc)
    assert memory._is_oom(MemoryError, MemoryError("boom"))
    assert not memory._is_oom(ValueError, ValueError("nope"))
    cuda = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 TiB")
    assert isinstance(cuda, RuntimeError) and not isinstance(cuda, MemoryError)
    assert memory._is_oom(type(cuda), cuda) and memory._is_oom(torch.OutOfMemoryError, None)
    assert isinstance(memory.SimulatedResourceExhausted("x"), MemoryError)
    assert str(memory.SimulatedResourceExhausted("d")) == str(jmemory.SimulatedResourceExhausted("d"))


def test_oom_fault_dump_names_the_planted_category_equal_jax(tmp_path, monkeypatch):
    """A window far larger than the rest is planted; the ``oom`` fault's
    flight dump ranks ``windows`` first, as JAX's does, and
    ``tools/memory_report.py`` names it from the dump alone."""
    tops = {}
    for side in ("port", "jax"):
        root = tmp_path / side
        monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(root))
        big = np.zeros((SIZE, 1 << 20), np.float32)
        if side == "port":
            flight.reconfigure()
            obs = memory.start(interval=1)
            bft.win_create(torch.from_numpy(big), "planted")
            session = bft.elastic.start(policy="average")
            mod = bft
        else:
            from bluefog_tpu import flight as jflight

            jflight.reconfigure()
            obs = jmemory.start(interval=1)
            bf.win_create(bf.worker_values(lambda r: big[r]), "planted")
            session = bf.elastic.start(policy="average")
            mod = bf
        opt, params, state, grads = _adam(dim=1024, side=side)
        session.inject("oom", rank=2, step=2)
        guard = mod.elastic.guard(opt)
        with pytest.raises(MemoryError, match="RESOURCE_EXHAUSTED"):
            for _ in range(4):
                params, state = guard.step(params, state, grads)
        assert obs.oom_events == 1
        d = json.loads((root / "flight_0.json").read_text())
        assert any(h.startswith("oom:chaos") for h in d["dump_history"])
        (oom,) = [a for a in d["advisories"] if a.get("kind") == "oom"]
        tops[side] = (oom["top_category"], oom["ranked_census"][0])
        mod.elastic.stop()
    assert tops["port"] == tops["jax"]
    assert tops["port"][0] == "windows" and tops["port"][1]["bytes"] >= SIZE * 4 << 20
    assert metrics.peek("bluefog.memory.oom_events").value == 1
    assert metrics.peek("bluefog.elastic.oom_faults").value == 1
    env = dict(os.environ, PYTHONPATH=REPO)
    path = tmp_path / "port" / "flight_0.json"
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "memory_report.py"),
                          "--flight", str(path), "--json"], capture_output=True, text=True,
                         timeout=60, env=env)
    assert out.returncode == 0, out.stderr
    pm = json.loads(out.stdout)["postmortems"][0]
    assert pm["top_category"] == "windows" and pm["ranked_census"][0]["category"] == "windows"
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "memory_report.py"),
                          "--flight", str(path)], capture_output=True, text=True, timeout=60,
                         env=env)
    assert out.returncode == 0 and "windows" in out.stdout and "OOM postmortem" in out.stdout
    bft.win_free("planted")


def test_excepthook_runs_the_forensics_once(tmp_path, monkeypatch):
    """A real ``MemoryError`` and a CUDA allocator's ``OutOfMemoryError``
    through the installed hook each run the forensics (the previous hook
    still chained); the injected fault's marked raise is not counted
    twice."""
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    flight.reconfigure()
    obs = memory.start(interval=1)
    opt, params, state, grads = _adam(dim=1024)
    session = bft.elastic.start(policy="average")
    session.inject("oom", rank=1, step=0)
    with pytest.raises(MemoryError) as caught:
        bft.elastic.guard(opt).step(params, state, grads)
    assert obs.oom_events == 1
    orig = sys.excepthook
    memory._install_oom_hooks()
    try:
        prev = []
        memory._prev_excepthook = lambda *a: prev.append(a)
        sys.excepthook(type(caught.value), caught.value, None)
        assert obs.oom_events == 1 and len(prev) == 1
        sys.excepthook(MemoryError, MemoryError("RESOURCE_EXHAUSTED: oom"), None)
        cuda = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 TiB")
        sys.excepthook(type(cuda), cuda, None)
        sys.excepthook(ValueError, ValueError("not an oom"), None)
        assert obs.oom_events == 3 and len(prev) == 4
        d = json.loads((tmp_path / "flight_0.json").read_text())
        reasons = [a["reason"] for a in d["advisories"] if a.get("kind") == "oom"]
        assert reasons == ["chaos:rank=1", "exception:MemoryError",
                           "exception:OutOfMemoryError"]
    finally:
        memory._uninstall_oom_hooks()
        sys.excepthook = orig
    assert sys.excepthook is not memory._excepthook


def test_init_installs_the_hooks_beside_the_flight_recorders(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("BLUEFOG_MEMORY", "1")
    orig = sys.excepthook
    bft.init(device="cpu")
    try:
        assert memory.active() is not None and sys.excepthook is memory._excepthook
        assert memory._prev_excepthook is flight._excepthook
    finally:
        bft.shutdown()
    assert sys.excepthook is orig and memory.active() is None
    monkeypatch.delenv("BLUEFOG_MEMORY")
    bft.init(device="cpu")
    assert memory.active() is None


def test_dump_and_the_memory_report(tmp_path, monkeypatch):
    jsonl = tmp_path / "memory.jsonl"
    monkeypatch.setenv("BLUEFOG_MEMORY_FILE", str(jsonl))
    memory.start(interval=1)
    opt, params, state, grads = _adam()
    for _ in range(3):
        params, state = opt.step(params, state, grads)
    path = tmp_path / "memory_dump.json"
    assert memory.dump(str(path)) == str(path)
    d = json.loads(path.read_text())
    assert d["kind"] == "memory_dump" and d["samples"] and d["last_census_ranked"]
    assert d["last_census_ranked"][0]["category"] == "opt_state"
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["sample"] * 3
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "memory_report.py"),
                          str(path), "--jsonl", str(jsonl), "--json"], capture_output=True,
                         text=True, timeout=60, env=env)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["kind"] == "memory_report" and rep["samples"] >= 3 and rep["last_census"]
