# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's step-time doctor (``bft.doctor``) and the compiler's measured
calibration against the JAX package's ``bf.doctor`` and compiler, mirroring
``tests/test_doctor.py``.

Tolerances. The baseline tracker, the blame core, the rules and the cost
model are host arithmetic on the same float inputs: held EXACTLY equal. A
sample's structure (rounds, edges, probe payload, predictions) is held
exactly to JAX's under the same pinned calibration; its times are wall
clock and only checked for sign. Trajectories with the doctor on and off
are held BITWISE. The degraded-link test pins the cost model (alpha 2 ms,
so a probe crossing the 0.05 edge sleeps 19 x 2 ms = 38 ms more than its
peers), which keeps it steady on a loaded host.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import attribution as jattribution
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import topology as jtu
from bluefog_tpu.collective import compiler as jcompiler
from bluefog_tpu_torch import attribution, flight, metrics
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.collective.plan import plan_from_topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
STACKED = compiler.TRANSPORT_LINK_CLASS
# the pinned cost model of the probing tests: alpha 2 ms, a wire fast enough
# that the payload term is negligible
PIN = (2e-3, 1e12, 0.0)


def _pin(alpha=PIN[0], beta=PIN[1], eff=PIN[2]):
    for cls in ("ici", STACKED):
        compiler.set_calibration(alpha, beta, eff, link_class=cls)
    jcompiler.set_calibration(alpha, beta, eff)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k in ("BLUEFOG_DOCTOR", "BLUEFOG_DOCTOR_FILE", "BLUEFOG_DOCTOR_INTERVAL",
              "BLUEFOG_DOCTOR_PROBE_ELEMS", "BLUEFOG_PLAN_CALIBRATE"):
        monkeypatch.delenv(k, raising=False)
    metrics.reset()
    jmetrics.reset()
    compiler.clear_calibration()
    jcompiler.clear_calibration()
    bft.init(device="cpu")
    bft.set_topology(tu.ExponentialTwoGraph(SIZE))
    yield
    attribution.stop()
    jattribution.stop()
    bft.elastic.stop()
    bf.elastic.stop()
    if bft.is_initialized():
        bft.shutdown()
    metrics.reset()
    jmetrics.reset()
    compiler.clear_calibration()
    jcompiler.clear_calibration()


# -- the tracker, the blame core and the rules: JAX's outputs ------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_tracker_equals_jax(seed):
    rng = np.random.RandomState(seed)
    series = np.concatenate([10 + rng.randn(20), [100.0, 1.0], 50 + rng.randn(10),
                             [50.0] * 5, [50.5]])
    for alpha in (0.2, 0.5):
        tr, jtr = attribution.BaselineTracker(alpha), jattribution.BaselineTracker(alpha)
        for x in series:
            assert tr.update(x) == jtr.update(x)
        assert tr.describe() == jtr.describe()


@pytest.mark.parametrize("seed", range(4))
def test_blame_edges_equals_jax(seed):
    rng = np.random.RandomState(seed)
    perms = [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)), ((1, 0),)]
    for _ in range(50):
        n = rng.randint(1, 5)
        times = list(rng.exponential(1e-3, n) * np.where(rng.rand(n) < 0.3, 20, 1))
        preds = list(rng.exponential(1e-3, rng.randint(0, n + 1)))
        for ratio in (attribution.DEGRADE_RATIO, 1.5):
            assert attribution.blame_edges(times, preds, perms[:n], ratio) == \
                jattribution.blame_edges(times, preds, perms[:n], ratio)
    assert attribution.blame_edges([0.001, 0.001, 0.020], [0.001] * 3, perms[:3]) == [2]
    assert attribution.blame_edges([], [], []) == []


def _rule_run(mod, met, feed, anchors):
    """Both doctors on ``observe(None, step)`` with the same fed series and
    the anchor replaced by ``anchors``; the advisories without wall-clock
    fields."""
    doc = mod.start(interval=1)
    series = iter(anchors)
    doc._anchor_tflops = lambda: next(series, anchors[-1])
    for i in range(len(anchors)):
        feed(met, i)
        doc.observe(None, step=i)
    return [{k: v for k, v in a.to_json().items() if k != "step_ms"} for a in doc.advisories]


def test_recompile_storm_consensus_stall_and_ambient_drift_equal_jax():
    """The rules on synthetic series (the port never counts recompiles: the
    counter is fed by hand, as JAX's test does)."""
    jcompiler.set_calibration(*PIN)  # JAX's first sample probes unless pinned
    disagreement = (1.0, 0.9, 0.85, 0.82, 5.0, 9.0, 15.0, 24.0, 30.0, 31.0)
    anchors = [10.0, 10.1, 9.9, 10.0, 5.0, 4.9, 5.1, 5.0, 5.0, 5.0]

    def feed(met, i):
        met.gauge("bluefog.gossip.disagreement").set(disagreement[i])
        if i == 3:
            met.counter("bluefog.recompiles").inc(10)

    got = _rule_run(attribution, metrics, feed, anchors)
    want = _rule_run(jattribution, jmetrics, feed, anchors)
    assert got == want
    assert {a["kind"] for a in got} == {"recompile_storm", "consensus_stall", "ambient_drift"}
    storm = [a for a in got if a["kind"] == "recompile_storm"]
    assert storm[0]["recompiles"] == 10
    assert metrics.peek("bluefog.doctor.samples").value == len(anchors)
    assert metrics.peek("bluefog.doctor.anchor_tflops").value == 5.0


# -- the cost model and the calibration -----------------------------------------------------


@pytest.mark.parametrize("graph", ["exp2", "ring", "star"])
def test_predicted_round_costs_and_degraded_penalty_equal_jax(graph):
    _pin(3e-5, 2.5e10, 0.5)
    make = {"exp2": (tu.ExponentialTwoGraph, jtu.ExponentialTwoGraph),
            "ring": (tu.RingGraph, jtu.RingGraph), "star": (tu.StarGraph, jtu.StarGraph)}
    from bluefog_tpu.collective.plan import plan_from_topology as jplan_from_topology

    info = plan_from_topology(make[graph][0](SIZE)).compile_info
    jinfo = jplan_from_topology(make[graph][1](SIZE)).compile_info
    assert info.rounds == jinfo.rounds
    for payload in (0.0, 4096.0, 131072.0, 1.02e8):
        got = compiler.predicted_round_costs_s(info, payload)
        assert got == jcompiler.predicted_round_costs_s(jinfo, payload)
        assert compiler.predicted_round_costs_s(info, payload, link_class=STACKED) == got
        assert compiler.predicted_round_costs_s(None, payload, n_rounds=5) == \
            jcompiler.predicted_round_costs_s(None, payload, n_rounds=5)
        for factor in (0.0, 0.05, 0.25, 0.999, 1.0, 1.5):
            for cong in (1.0, 2.0):
                assert compiler.degraded_round_penalty_s(payload, factor, cong) == \
                    jcompiler.degraded_round_penalty_s(payload, factor, cong)
    assert compiler.predicted_round_costs_s(None, 1.0) == jcompiler.predicted_round_costs_s(
        None, 1.0) == ()


def test_calibrate_installs_a_measured_stacked_calibration():
    """On the CPU the probe times the stacked round with the host clock and
    installs it under the port's link class; ``ici`` and ``dcn`` (fabrics
    the port lacks) come back as their pins or JAX's class constants; an
    installed calibration is kept unless ``force``."""
    cal = compiler.calibrate(small_elems=512, large_elems=1 << 14, steps=2, windows=1)
    assert cal["link_class"] == STACKED and cal["source"] == "measured-probe"
    assert cal["alpha_s"] > 0 and 0 < cal["beta_bytes_per_s"] < float("inf")
    assert 0.0 <= cal["pipeline_eff"] <= 1.0 and cal["probe_devices"] == SIZE
    assert compiler.calibrate(small_elems=512, large_elems=1 << 14) == cal
    compiler.set_calibration(1e-3, 1e9, 0.0, link_class=STACKED)
    assert compiler.calibrate()["source"] == "manual"
    assert compiler.calibrate(force=True, small_elems=512, large_elems=1 << 13, steps=1,
                              windows=1)["source"] == "measured-probe"
    for cls in ("ici", "dcn"):
        got = compiler.calibrate(link_class=cls, force=True)
        want = jcompiler.calibration(cls)
        assert {k: got[k] for k in want} == want
    compiler.set_calibration(5e-5, 1e10, 0.0, link_class="dcn")
    assert compiler.calibrate(link_class="dcn")["source"] == "manual"
    with pytest.raises(ValueError, match="link_class"):
        compiler.calibrate(link_class="nvlink")


# -- the live sampling pass -----------------------------------------------------------------


def _mlp(layers=3, dim=64, batch=8):
    rng = np.random.RandomState(0)
    w0 = [(rng.randn(dim, dim) / np.sqrt(dim)).astype(np.float32) for _ in range(layers)]
    xs = rng.randn(SIZE, batch, dim).astype(np.float32)
    ys = rng.randn(SIZE, batch, dim).astype(np.float32)
    return w0, xs, ys


def _port_stepper(order="atc", wire=None, layers=3, dim=64):
    w0, xs, ys = _mlp(layers, dim)

    def loss_fn(p, x, y):
        h = x
        for i in range(layers):
            h = torch.tanh(h @ p[f"w{i}"])
        return ((h - y) ** 2).mean()

    cls = (bft.DistributedAdaptThenCombineOptimizer if order == "atc"
           else bft.DistributedAdaptWithCombineOptimizer)
    opt = cls(bft.sgd(0.01, momentum=0.9))
    opt.compression = wire
    step = opt.make_train_step(loss_fn)
    params = {f"w{i}": torch.from_numpy(np.stack([w0[i]] * SIZE)) for i in range(layers)}
    carry = [(params, opt.init(params))]
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)

    def run():
        p, s = carry[0]
        p, s, _loss = step(p, s, x, y)
        carry[0] = (p, s)

    return run, carry, opt


def _jax_stepper(cpu_devices, layers=3, dim=64):
    import jax.numpy as jnp
    import optax

    w0, xs, ys = _mlp(layers, dim)
    bf.init(devices=cpu_devices[:SIZE])
    bf.set_topology(jtu.ExponentialTwoGraph(SIZE))

    def loss_fn(p, x, y):
        h = x
        for i in range(layers):
            h = jnp.tanh(h @ p[f"w{i}"])
        return jnp.mean((h - y) ** 2)

    opt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.01, momentum=0.9))
    step = bf.make_train_step(opt, loss_fn)
    params = {f"w{i}": bf.worker_values(lambda r, i=i: w0[i]) for i in range(layers)}
    carry = [(params, opt.init(params))]
    x = bf.worker_values(lambda r: xs[r])
    y = bf.worker_values(lambda r: ys[r])

    def run():
        p, s = carry[0]
        p, s, _loss = step(p, s, x, y)
        carry[0] = (p, s)

    return run


def test_interval_and_per_round_probes_match_the_plan_and_jax(cpu_devices):
    """Interval 2 over 6 steps samples steps 0, 2 and 4; each sample probes
    every round of the plan (the same rounds, probe payload, wire bytes
    and predictions as JAX's under the same pinned calibration) and
    decomposes the step (alpha pinned at 20 ms, so no clean probe on a
    loaded host reaches the advisory's 3x)."""
    _pin(2e-2)
    doc = attribution.start(interval=2)
    run, _carry, _opt = _port_stepper()
    for _ in range(6):
        run()
    attribution.stop()
    jrun = _jax_stepper(cpu_devices)  # bf.init closes any doctor session
    jdoc = jattribution.start(interval=2)
    for _ in range(6):
        jrun()
    bf.shutdown()
    assert len(doc.samples) == len(jdoc.samples) == 3
    assert [s["step"] for s in doc.samples] == [s["step"] for s in jdoc.samples] == [0, 2, 4]
    perms = plan_from_topology(tu.ExponentialTwoGraph(SIZE)).perms
    for s, js in zip(doc.samples, jdoc.samples):
        assert [r["edges"] for r in s["rounds"]] == [r["edges"] for r in js["rounds"]] == \
            [[list(e) for e in p] for p in perms]
        assert [r["predicted_ms"] for r in s["rounds"]] == \
            [r["predicted_ms"] for r in js["rounds"]]
        for key in ("probe_payload_bytes", "wire_bytes_per_round", "comm_steps",
                    "steps_since_last"):
            assert s[key] == js[key], key
        assert all(r["probe_ms"] > 0 for r in s["rounds"])
        assert s["comm_wire_ms"] > 0 and s["dispatch_ms"] >= 0 and s["sync_lag_ms"] >= 0
        assert s["anchor_tflops"] > 0
        assert "advisories" not in s
    last = doc.samples[-1]
    assert last["step_ms"] > 0 and "compute_ms" in last
    assert 0.0 <= last["exposed_comm_frac"] <= 1.0
    assert metrics.peek("bluefog.doctor.samples").value == 3
    assert metrics.peek("bluefog.doctor.step_ms") is not None


@pytest.mark.parametrize("order", ["atc", "cta"])
@pytest.mark.parametrize("wire", [None, "int8"])
def test_doctor_on_and_off_are_bitwise(order, wire):
    """The doctor changes no training value, and its probes live in their
    own op-cache family."""
    _pin()
    ctx = bft.get_context()

    def trajectory(on):
        if on:
            attribution.start(interval=2)
        else:
            attribution.stop()
        run, carry, _opt = _port_stepper(order, wire)
        keys = set(ctx.op_cache)
        for _ in range(5):
            run()
        new = {k[0] for k in set(ctx.op_cache) - keys}
        p, s = carry[0]
        return [t.clone() for t in bft.optimizers.tree_leaves((p, s))], new

    off, keys_off = trajectory(False)
    on, keys_on = trajectory(True)
    for a, b in zip(off, on):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    assert keys_on - keys_off <= {"doctor_probe"} and "doctor_probe" in keys_on
    assert len(attribution.active().samples) == 3


def test_degraded_link_advisory_names_the_injected_edge(tmp_path, monkeypatch):
    """The steady version of JAX's timing test: both link classes pinned at
    alpha 2 ms, a ``degrade`` fault narrowed to the edge 2 -> 6 at factor
    0.05 adds 38 ms to every probe crossing it; every ``degraded_link``
    advisory names exactly that edge, on every surface."""
    _pin()
    jsonl = tmp_path / "doctor.jsonl"
    monkeypatch.setenv("BLUEFOG_DOCTOR_FILE", str(jsonl))
    session = bft.elastic.start(policy="average")
    session.inject("degrade", rank=2, step=0, factor=0.05, peer=6)
    doc = attribution.start(interval=2)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
    guard = bft.elastic.guard(opt)
    params = torch.from_numpy(np.stack([np.random.RandomState(r).randn(2048).astype(np.float32)
                                        for r in range(SIZE)]))
    state = opt.init(params)
    zeros = torch.zeros_like(params)
    for _ in range(5):
        params, state = guard.step(params, state, zeros)
    linked = [a for a in doc.advisories if a.kind == "degraded_link"]
    assert len(linked) == 3, [a.to_json() for a in doc.advisories]
    assert all(a.detail["edge"] == [2, 6] for a in linked)
    assert all(a.detail["ratio"] > attribution.DEGRADE_RATIO for a in linked)
    assert all(a.detail["measured_ms"] >= 20.0 + a.detail["predicted_ms"] for a in linked)
    assert not [a for a in doc.advisories if a.kind != "degraded_link"]
    assert attribution.suspect_join() == [[2, 6]]
    assert metrics.peek("bluefog.doctor.advisory.degraded_link").value == 3
    dump = flight._build_dump("test")
    table = [a for a in dump["advisories"] if a.get("kind") == "degraded_link"]
    assert table and all(a["edge"] == [2, 6] for a in table)
    assert any(e["kind"] == "advisory" and e["data"]["advisory_kind"] == "degraded_link"
               for e in dump["events"])
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert {r["kind"] for r in rows} == {"sample", "advisory"}


def test_dump_is_triaged_by_the_doctor_tool(tmp_path):
    _pin()
    session = bft.elastic.start(policy="average")
    session.inject("degrade", rank=1, step=0, factor=0.05, peer=3)
    attribution.start(interval=1)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
    guard = bft.elastic.guard(opt)
    params = torch.ones(SIZE, 1024)
    state = opt.init(params)
    for _ in range(3):
        params, state = guard.step(params, state, torch.zeros_like(params))
    path = tmp_path / "doctor_dump.json"
    assert bft.doctor.dump(str(path)) == str(path)
    d = json.loads(path.read_text())
    assert d["kind"] == "doctor_dump" and d["calibration"]["link_class"] == STACKED
    assert d["calibration"]["alpha_s"] == PIN[0]
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "doctor.py"), "--attribution", str(path),
         "--json"], capture_output=True, text=True, timeout=60, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["kind"] == "doctor_triage"
    text = " ".join(report["summary"])
    assert "degraded_link" in text and "1->3" in text


def test_knobs_and_init_follow_the_jax_module(monkeypatch):
    monkeypatch.setenv("BLUEFOG_DOCTOR_INTERVAL", "not-a-number")
    monkeypatch.setenv("BLUEFOG_DOCTOR_PROBE_ELEMS", "100")
    assert attribution.doctor_interval() == jattribution.doctor_interval() == 100
    assert attribution.probe_elems_cap() == jattribution.probe_elems_cap() == 512
    monkeypatch.setenv("BLUEFOG_DOCTOR", "1")
    assert attribution.enabled() and jattribution.enabled()
    bft.init(device="cpu")
    assert attribution.active() is not None
    assert attribution.dispatch_timer(False) is None and attribution.dispatch_timer(True) > 0
    monkeypatch.delenv("BLUEFOG_DOCTOR")
    bft.init(device="cpu")
    assert attribution.active() is None and attribution.dispatch_timer(True) is None
