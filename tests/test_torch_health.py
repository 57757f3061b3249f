# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's fleet health plane (``bft.health``) against the JAX
package's ``bf.health``: the counterparts of ``tests/test_health.py``'s 23
tests, and the staleness and memory fleet slots of ``tests/test_memory.py``
and ``tests/test_staleness.py``.

Tolerances. The fits, the projections, ``push_matrix`` and
``fleet_aggregate_np`` are the same float64 numpy code: held EXACTLY to
JAX's. The observatory's samples are host arithmetic on the same fed
series: their rates, efficiencies and projections equal JAX's, and
``mixing_degraded`` fires on the same sample naming the same edge. The
push-sum lane runs in f32 on both sides (a weighted combine and masked
min/max gathers), so its mean is held to ``1e-6`` of the largest value
against JAX's lane and against the float64 oracle, its min and max to the
f32 rounding of the values. Training with the plane on is held BITWISE to
training with it off.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import health as jhealth
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import topology as jtu
from bluefog_tpu_torch import flight, health, memory, metrics, staleness
from bluefog_tpu_torch import topology as tu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
HOST = "127.0.0.1"
SAMPLE_KEYS = ("step", "comm_steps", "topo_version", "consensus", "predicted_rate",
               "measured_rate", "mixing_efficiency", "time_to_eps_steps", "eps")


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    for k in ("BLUEFOG_HEALTH", "BLUEFOG_HEALTH_INTERVAL", "BLUEFOG_HEALTH_PORT",
              "BLUEFOG_HEALTH_FILE", "BLUEFOG_HEALTH_ROUNDS", "BLUEFOG_HEALTH_EPS",
              "BLUEFOG_METRICS", "BLUEFOG_STALENESS", "BLUEFOG_MEMORY", "BLUEFOG_DOCTOR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setattr(health, "DEFAULT_HOST", HOST)
    metrics.reset()
    jmetrics.reset()
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    health.stop()
    jhealth.stop()
    staleness.stop()
    memory.stop()
    bft.elastic.stop()
    bf.elastic.stop()
    bf.shutdown()
    if bft.is_initialized():
        bft.shutdown()
    flight.reconfigure()
    metrics.reset()
    jmetrics.reset()


def _topo(name):
    ours, theirs = {"ring": (tu.RingGraph, jtu.RingGraph),
                    "exp2": (tu.ExponentialTwoGraph, jtu.ExponentialTwoGraph)}[name]
    bf.set_topology(theirs(SIZE))
    bft.set_topology(ours(SIZE))
    return tu.mixing_matrix(ours(SIZE))


def _drive(planes, w, steps, start_step=0, x=None, lossy=None, factor=0.05):
    """``tests/test_health.py``'s eager numpy consensus, the same distances
    fed to each ``(plane, ctx)``; ``lossy=(s, d)`` replays a lossy link."""
    if x is None:
        x = np.random.RandomState(1).randn(w.shape[0], 64)
    for t in range(start_step, start_step + steps):
        y = w.T @ x
        if lossy is not None:
            s, d = lossy
            y[d] += (1.0 - factor) * w[s, d] * (x[d] - x[s])
        x = y
        dist = float(np.sqrt(((x - x.mean(0)) ** 2).sum(1)).mean())
        for plane, ctx in planes:
            plane.observe(ctx, step=t, consensus=dist)
    return x


def _pair(interval=1):
    """A port plane and a JAX plane, each active on its own context."""
    return [(health.start(interval=interval), bft.get_context()),
            (jhealth.start(interval=interval), bf.get_context())]


def _same_samples(port, jax_plane):
    assert len(port.samples) == len(jax_plane.samples)
    for a, b in zip(port.samples, jax_plane.samples):
        for k in SAMPLE_KEYS:
            assert a.get(k) == b.get(k), (k, a.get(k), b.get(k))
        assert a["spectral"] == b["spectral"]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


# -- fits, projections, push matrix -------------------------------------------------------


@pytest.mark.parametrize("rate", [0.3, 0.85, 0.99])
def test_fit_decay_rate_equals_jax(rate):
    pts = [(i, 3.0 * rate ** i) for i in range(0, 24, 3)]
    assert health.fit_decay_rate(pts) == jhealth.fit_decay_rate(pts)
    assert health.fit_decay_rate(pts) == pytest.approx(rate, abs=1e-9)
    assert health.mixing_efficiency(rate, 0.85) == jhealth.mixing_efficiency(rate, 0.85)
    noisy = [(i, d * (1 + 0.01 * np.sin(i))) for i, d in pts]
    assert health.fit_decay_rate(noisy) == jhealth.fit_decay_rate(noisy)


def test_fit_decay_rate_refuses_thin_or_flat_input():
    for pts in ([(0, 1.0), (1, 0.9)], [(i, 1e-15) for i in range(10)],
                [(i, 1.0 + 0.01 * i) for i in range(8)], [(3, 1.0)] * 6):
        assert health.fit_decay_rate(pts) == jhealth.fit_decay_rate(pts)
    rate = health.fit_decay_rate([(i, 1.0 + 0.01 * i) for i in range(8)])
    assert rate >= 1.0 and health.mixing_efficiency(rate, 0.8) == 0.0
    assert health.mixing_efficiency(0.5, 1.0) is None


def test_time_to_consensus_projection_equals_jax():
    cases = [(1.0, 0.5, 1e-6), (1e-9, 0.5, 1e-6), (1.0, 1.1, 1e-6), (None, 0.5, None),
             (3.0, 0.8, 1e-3)]
    for d, r, eps in cases:
        assert health.time_to_consensus_steps(d, r, eps) == \
            jhealth.time_to_consensus_steps(d, r, eps)
    assert health.time_to_consensus_steps(1.0, 0.5, eps=1e-6) == pytest.approx(19.93, abs=0.01)


@pytest.mark.parametrize("dead", [[], [5], [0, 3]])
def test_push_matrix_equals_jax_and_conserves_mass(dead):
    w = tu.mixing_matrix(tu.ExponentialTwoGraph(SIZE))
    w[0, 1] *= 2.0
    p = health.push_matrix(w, dead)
    assert np.array_equal(p, jhealth.push_matrix(w, dead))
    for i in range(SIZE):
        if i in dead:
            assert p[i].sum() == 0.0 and p[:, i].sum() == 0.0
        else:
            assert p[i].sum() == pytest.approx(1.0)


# -- the push-sum lane --------------------------------------------------------------------


@pytest.mark.parametrize("dead", [[], [4], [1, 6]])
@pytest.mark.parametrize("rounds", [1, 12])
def test_fleet_aggregate_matches_jax_and_oracle(dead, rounds):
    """The acceptance oracle on a weighted digraph with dead ranks: the
    numpy oracle bitwise JAX's; the port's lane within 1e-6 of the largest
    value of JAX's lane and of the oracle; min/max the live extrema."""
    g = tu.ExponentialTwoGraph(SIZE)
    w = tu.mixing_matrix(g)
    w[0, 1] *= 2.0
    bf.set_topology(jtu.ExponentialTwoGraph(SIZE))
    bft.set_topology(g)
    vals = np.random.RandomState(3).randn(SIZE, len(health.FLEET_FIELDS)) * 5.0
    ora = health.fleet_aggregate_np(w, vals, rounds=rounds, dead=dead)
    assert ora == jhealth.fleet_aggregate_np(w, vals, rounds=rounds, dead=dead)
    got = health.fleet_aggregate(bft.get_context(), vals, rounds=rounds, w=w, dead=dead)
    want = jhealth.fleet_aggregate(bf.get_context(), vals, rounds=rounds, w=w, dead=dead)
    scale = np.abs(vals).max()
    for key in ("mean", "min", "max"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got[key], ora[key], rtol=0, atol=1e-6 * scale)
    live = [j for j in range(SIZE) if j not in dead]
    assert got["live"] == live and got["rounds"] == rounds
    f32 = vals.astype(np.float32)[live]
    if rounds == 12:
        assert np.array_equal(np.float32(got["min"]), f32.min(axis=0))
        assert np.array_equal(np.float32(got["max"]), f32.max(axis=0))
        # JAX's bound at its one dead rank; two cut Exp2(8) further
        assert got["residual"] < (0.02 if len(dead) <= 1 else 0.1)
    keys = [k for k in bft.get_context().op_cache if k[0] == "health_pushsum"]
    assert len(keys) == 1 and keys[0][2:] == (rounds, len(health.FLEET_FIELDS))


def test_fleet_aggregate_without_rounds_and_dead_from_membership(monkeypatch):
    """``BLUEFOG_HEALTH_ROUNDS=0`` disables the lane (the local values come
    back); an elastic session's dead rank drops out of the live set."""
    w = _topo("exp2")
    vals = np.random.RandomState(0).rand(SIZE, 3)
    monkeypatch.setenv("BLUEFOG_HEALTH_ROUNDS", "0")
    rep = health.fleet_aggregate(bft.get_context(), vals)
    assert rep["mean"] == jhealth.fleet_aggregate(bf.get_context(), vals)["mean"]
    monkeypatch.delenv("BLUEFOG_HEALTH_ROUNDS")
    session = bft.elastic.start(policy="average")
    session.membership.mark_dead(2, "killed", 0)
    rep = health.fleet_aggregate(bft.get_context(), vals, w=w)
    assert rep["live"] == [0, 1, 3, 4, 5, 6, 7]
    assert rep["rounds"] == health._auto_rounds(7, None) == jhealth._auto_rounds(7, None)


def test_streaming_lane_tracks_changing_values_as_jax():
    """The sampled-step streaming form beside JAX's on the same changing
    summary: equal to 1e-6, tracking the mean, the extrema exact once a
    generation completes."""
    _topo("exp2")
    port = health.HealthPlane(interval=1)
    jplane = jhealth.HealthPlane(interval=1)
    vals = np.random.RandomState(0).rand(SIZE, len(health.FLEET_FIELDS))
    for t in range(40):
        if t == 20:
            vals = vals + 10.0
        rep = port._fleet_step(bft.get_context(), vals, dead=[], predicted=0.5)
        jrep = jplane._fleet_step(bf.get_context(), vals, dead=[], predicted=0.5)
        assert rep["warming"] == jrep["warming"]
        assert rep["generation_len"] == jrep["generation_len"]
        for key in ("mean", "min", "max"):
            _close(rep[key], jrep[key])
    assert not rep["warming"]
    np.testing.assert_allclose(rep["mean"], vals.mean(axis=0), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(rep["min"], vals.min(axis=0), atol=1e-5)
    np.testing.assert_allclose(rep["max"], vals.max(axis=0), atol=1e-5)


# -- the observatory and its advisory -----------------------------------------------------


def test_observatory_measures_on_contract_efficiency_as_jax():
    w = _topo("ring")
    planes = _pair()
    _drive(planes, w, steps=25)
    port, jplane = planes[0][0], planes[1][0]
    _same_samples(port, jplane)
    s = port.samples[-1]
    pred = tu.consensus_decay_rate(w)
    assert s["predicted_rate"] == pytest.approx(pred, abs=1e-9)
    assert s["measured_rate"] == pytest.approx(pred, rel=0.05)
    assert s["mixing_efficiency"] == pytest.approx(1.0, abs=0.1)
    assert s["time_to_eps_steps"] > 0
    assert metrics.peek("bluefog.health.mixing_efficiency") is not None
    assert metrics.peek("bluefog.health.samples").value == 25


def test_mixing_degraded_fires_at_jax_sample_naming_the_edge(tmp_path, monkeypatch):
    """A lossy ring edge 2 -> 3 (5 % delivery) slows mixing below the
    spectral promise: ``mixing_degraded`` fires on the same samples as JAX,
    names ``[2, 3]``, and lands on the counter, the flight side table and
    the JSONL; ``/healthz`` says warn."""
    w = _topo("ring")
    for elastic in (bft.elastic, bf.elastic):
        elastic.start(policy="average").inject("degrade", rank=2, step=0, factor=0.05, peer=3)
    (port, ctx), (jplane, jctx) = _pair()
    # JAX's plane first, on the same series, then the port's with its file
    x = _drive([(jplane, jctx)], w, steps=30)
    _drive([(jplane, jctx)], w, steps=50, start_step=30, x=x, lossy=(2, 3))
    monkeypatch.setenv("BLUEFOG_HEALTH_FILE", str(tmp_path / "health.jsonl"))
    x = _drive([(port, ctx)], w, steps=30)
    assert not port.advisories
    _drive([(port, ctx)], w, steps=50, start_step=30, x=x, lossy=(2, 3))
    advs = [a for a in port.advisories if a.kind == "mixing_degraded"]
    assert advs and [a.step for a in advs] == [a.step for a in jplane.advisories]
    assert [a.detail for a in advs] == [a.detail for a in jplane.advisories]
    assert [2, 3] in advs[0].detail["suspect_edges"]
    assert advs[0].detail["mixing_efficiency"] < advs[0].detail["baseline_efficiency"]
    assert metrics.peek("bluefog.doctor.advisory.mixing_degraded").value == len(advs)
    table = [a for a in flight._build_dump("health")["advisories"]
             if a.get("kind") == "mixing_degraded"]
    assert len(table) == len(advs) and all([2, 3] in a["suspect_edges"] for a in table)
    lines = [json.loads(line) for line in open(tmp_path / "health.jsonl")]
    assert len([r for r in lines if r.get("advisory_kind") == "mixing_degraded"]) == len(advs)
    assert any(r.get("kind") == "sample" and "mixing_efficiency" in r for r in lines)
    assert health.healthz_verdict(port)["status"] == "warn"


def test_topology_swap_restarts_the_baseline():
    w = _topo("ring")
    planes = _pair()
    _drive(planes, w, steps=25)
    w = _topo("exp2")
    _drive(planes, w, steps=20)
    port, jplane = planes[0][0], planes[1][0]
    _same_samples(port, jplane)
    assert not port.advisories
    assert port.samples[-1]["predicted_rate"] == pytest.approx(0.5, abs=1e-9)


def test_healthz_recency_uses_comm_step_marks():
    from bluefog_tpu_torch.attribution import Advisory

    plane = health.start(interval=1)
    plane.advisories.append(Advisory(kind="mixing_degraded", step=400, detail={}))
    plane.advisory_marks.append(100)
    plane._count = 100 + health.VERDICT_RECENT_SAMPLES + 1
    assert health.healthz_verdict(plane)["status"] == "ok"
    plane._count = 100 + health.VERDICT_RECENT_SAMPLES - 1
    assert health.healthz_verdict(plane)["status"] == "warn"


@pytest.mark.parametrize("kind", ["plan", "schedule", "topology"])
def test_predicted_rate_equals_the_dense_oracle(kind):
    """``predicted_rate`` of a dispatched plan, a schedule's period product
    and the topology, each equal to JAX's and to the spectral engine's
    dense oracle, cached per source."""
    from bluefog_tpu.collective import plan as jplan_mod
    from bluefog_tpu_torch.collective import plan as plan_mod
    from bluefog_tpu_torch.topology import spectral

    _topo("exp2")
    port, jplane = health.HealthPlane(interval=1), jhealth.HealthPlane(interval=1)
    if kind == "plan":
        p = plan_mod.plan_from_topology(tu.ExponentialTwoGraph(SIZE))
        jp = jplan_mod.plan_from_topology(jtu.ExponentialTwoGraph(SIZE))
        oracle = spectral.dense_slem(p.weight_matrix())
    elif kind == "schedule":
        p = plan_mod.schedule_from_dynamic(
            SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(tu.ExponentialTwoGraph(SIZE), r))
        jp = jplan_mod.schedule_from_dynamic(
            SIZE, lambda r: jtu.GetDynamicOnePeerSendRecvRanks(jtu.ExponentialTwoGraph(SIZE), r))
        mats = [q.weight_matrix() for q in p.plans]
        prod = np.eye(SIZE)
        for m in mats:
            prod = m.T @ prod
        oracle = max(spectral.dense_slem(prod), 1e-12) ** (1.0 / len(mats))
    else:
        p = jp = None
        oracle = spectral.dense_slem(tu.mixing_matrix(tu.ExponentialTwoGraph(SIZE)))
    got = port.predicted_rate(bft.get_context(), p)
    assert got == jplane.predicted_rate(bf.get_context(), jp)
    assert got[0] == pytest.approx(oracle, abs=1e-12)
    assert port.predicted_rate(bft.get_context(), p) is got


# -- serving ------------------------------------------------------------------------------


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read()


def test_healthz_fleet_metrics_endpoints():
    w = _topo("ring")
    plane = health.start(interval=1)
    _drive([(plane, bft.get_context())], w, steps=12)
    srv = health.serve(0)
    assert srv is not None and srv.host == HOST
    base = f"http://{HOST}:{srv.port}"
    v = json.loads(_get(base + "/healthz"))
    assert v["status"] == "ok" and v["dead_ranks"] == [] and v["slo_exhausted"] == []
    prom = _get(base + "/metrics").decode()
    assert "# HELP" in prom and "# TYPE" in prom and "bluefog_health_samples_total" in prom
    fleet = json.loads(_get(base + "/fleet"))
    assert fleet["kind"] == "health_dump"
    assert fleet["fleet"]["fields"] == list(health.FLEET_FIELDS) == list(jhealth.FLEET_FIELDS)
    assert fleet["healthz"]["status"] == "ok"
    assert json.loads(_get(base + "/slo"))["kind"] == "slo_dump"
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/nope")
    assert err.value.code == 404
    srv.close()


def test_healthz_critical_on_dead_rank_returns_503():
    _topo("ring")
    session = bft.elastic.start(policy="average")
    session.membership.mark_dead(5, "killed", 0)
    plane = health.start(interval=1)
    v = health.healthz_verdict(plane)
    assert v["status"] == "critical" and 5 in v["dead_ranks"]
    srv = health.serve(0)
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"http://{HOST}:{srv.port}/healthz")
    assert err.value.code == 503
    srv.close()


def test_port_conflict_is_graceful_noop():
    blocker = socket.socket()
    blocker.bind((HOST, 0))
    blocker.listen(1)
    try:
        assert health.HealthServer.maybe_start(blocker.getsockname()[1]) is None
    finally:
        blocker.close()


def test_env_port_wires_serving_through_init(monkeypatch):
    free = socket.socket()
    free.bind((HOST, 0))
    port = free.getsockname()[1]
    free.close()
    monkeypatch.setenv("BLUEFOG_HEALTH_PORT", str(port))
    monkeypatch.setenv("BLUEFOG_HEALTH", "1")
    bft.shutdown()
    bft.init(device="cpu")
    try:
        assert health.server() is not None and health.active() is not None
        assert json.loads(_get(f"http://{HOST}:{port}/healthz"))["status"] in ("ok", "warn")
    finally:
        bft.shutdown()
        assert health.server() is None and health.active() is None


def test_endpoints_survive_non_finite_gauges():
    plane = health.start(interval=1)
    plane._step_ewma_ms = float("nan")
    with plane._report_lock:
        plane.samples.append({"kind": "sample", "step": 0, "step_ms_ewma": float("nan"),
                              "consensus": float("inf"),
                              "nested": {"v": float("-inf"), "list": [float("nan")]}})
    metrics.gauge("bluefog.test.nan_gauge").set(float("nan"))
    metrics.gauge("bluefog.test.inf_gauge").set(float("inf"))
    srv = health.serve(0)
    base = f"http://{HOST}:{srv.port}"

    def strict_loads(raw):
        def reject(tok):
            raise ValueError(f"non-finite token {tok!r} in JSON")

        return json.loads(raw, parse_constant=reject)

    last = strict_loads(_get(base + "/fleet"))["samples"][-1]
    assert last["step_ms_ewma"] is None and last["consensus"] is None
    assert last["nested"] == {"v": None, "list": [None]}
    strict_loads(_get(base + "/healthz"))
    prom = _get(base + "/metrics").decode()
    for line in prom.splitlines():
        assert " nan" not in line and " inf" not in line, line
    assert "bluefog_test_nan_gauge NaN" in prom and "bluefog_test_inf_gauge +Inf" in prom
    srv.close()


def test_concurrent_scrapes_while_plane_publishes():
    w = _topo("ring")
    plane = health.start(interval=1)
    srv = health.serve(0)
    base = f"http://{HOST}:{srv.port}"
    errors, done = [], threading.Event()

    def scrape(path):
        while not done.is_set():
            try:
                raw = _get(base + path)
                if path != "/metrics":
                    json.loads(raw)
            except Exception as e:
                errors.append((path, repr(e)))
                return

    threads = [threading.Thread(target=scrape, args=(p,), daemon=True)
               for p in ("/metrics", "/fleet", "/healthz")]
    for t in threads:
        t.start()
    x = np.random.RandomState(0).randn(SIZE, 64)
    for t_step in range(30):
        x = w.T @ x
        d = float(np.sqrt(((x - x.mean(0)) ** 2).sum(1)).mean())
        metrics.gauge("bluefog.gossip.disagreement").set(d)
        plane.observe(bft.get_context(), step=t_step, consensus=d)
    done.set()
    for t in threads:
        t.join(timeout=10)
    srv.close()
    assert not errors, errors


# -- the optimizer hook -------------------------------------------------------------------


def _train(interval, steps=6, wire="int8"):
    """ATC ``sgd(0.1, 0.9)`` on ``wire`` over the weighted Exp2(8), fused
    steps of a tanh regression from the same seed; the health plane at
    ``interval`` (None: off). Returns the parameters, the state and the
    op-cache keys the steps added."""
    bft.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    if interval is None:
        health.stop()
    else:
        health.start(interval=interval)
    rng = np.random.RandomState(0)
    w0 = torch.from_numpy((rng.randn(SIZE, 32, 32) / 6.0).astype(np.float32))
    xs = torch.from_numpy(rng.randn(SIZE, 8, 32).astype(np.float32))
    ys = torch.from_numpy(rng.randn(SIZE, 8, 32).astype(np.float32))
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = wire
    step = opt.make_train_step(lambda p, x, y: torch.mean((torch.tanh(x @ p["w"]) - y) ** 2))
    params = {"w": w0.clone()}
    state = opt.init(params)
    keys = set(bft.get_context().op_cache)
    for _ in range(steps):
        params, state, _loss = step(params, state, xs, ys)
    return params, state, set(bft.get_context().op_cache) - keys


@pytest.mark.parametrize("wire", [None, "int8", "int4_ef"])
def test_optimizer_hook_is_bitwise_health_off(wire):
    """The fused step with the plane at interval 2 is bitwise the plane
    off; the only op-cache key it adds is the lane's; the samples see the
    dispatched plan's predicted rate (Exp2(8): 1/2) and every rank live."""
    off, off_state, off_keys = _train(None, wire=wire)
    on, on_state, on_keys = _train(2, wire=wire)
    assert torch.equal(on["w"].view(torch.int32), off["w"].view(torch.int32))
    for a, b in zip(on_state, off_state):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert {k[0] for k in on_keys - off_keys} == {"health_pushsum"}
    plane = health.active()
    assert len(plane.samples) == 3
    s = plane.samples[-1]
    assert s["predicted_rate"] == pytest.approx(0.5, abs=1e-6)
    assert s["spectral"]["spectral"]["engine"] == "dense"
    assert s["fleet"]["live"] == list(range(SIZE))
    assert "fleet_error" not in s


def test_two_program_step_feeds_the_plane():
    bft.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    plane = health.start(interval=1)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    params = {"w": torch.from_numpy(np.random.RandomState(0).randn(SIZE, 600).astype(np.float32))}
    state = opt.init(params)
    for _ in range(3):
        opt.step(params, state, {"w": torch.zeros(SIZE, 600)})
    assert [s["comm_steps"] for s in plane.samples] == [1, 2, 3]
    assert plane.samples[-1]["spectral"]["kind"] == "plan"


# -- the fleet slots ----------------------------------------------------------------------


def test_fleet_fields_carry_memory_slots():
    """``test_memory.py::test_fleet_fields_carry_memory_slots`` and
    ``test_serving_report_carries_memory_block`` on the port."""
    assert "mem_bytes_per_rank" in health.FLEET_FIELDS and "mem_headroom" in health.FLEET_FIELDS
    obs = memory.start(interval=1)
    obs.budget = 1 << 30
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.01))
    params = {"w": torch.from_numpy(np.random.RandomState(0).randn(SIZE, 4096).astype(np.float32))}
    state = opt.init(params)
    opt.step(params, state, {"w": torch.zeros(SIZE, 4096)})
    plane = health.HealthPlane(interval=1)
    vec = plane._local_vector(bft.get_context(), None, list(range(SIZE)))
    i_bytes = health.FLEET_FIELDS.index("mem_bytes_per_rank")
    i_head = health.FLEET_FIELDS.index("mem_headroom")
    assert vec[0, i_bytes] > 0 and vec[0, i_head] == pytest.approx((1 << 30) - vec[0, i_bytes])
    blk = plane.report()["memory"]
    assert blk["bytes_per_rank"] == int(vec[0, i_bytes]) and blk["ranked_census"]
    assert blk["oom_events"] == 0 and blk["headroom_bytes"] == int(vec[0, i_head])
    assert vec[0, health.FLEET_FIELDS.index("slo_burn")] == 0.0


def test_fleet_fields_carry_the_staleness_slot_and_age_discount():
    """With the staleness observatory on and the delayed step (age 1 from
    the second step), the ``stale_age_max`` slot reads the worst age, the
    lane's published extrema carry it once the generation seeded with it
    completes (``generation_len`` 8 samples, two generations), and the
    sample carries the age-adjusted rate of ``staleness.age_adjusted_rate``."""
    bft.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    staleness.start(interval=1)
    plane = health.start(interval=1)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    step = opt.make_train_step(lambda p, x: torch.mean((p["w"] - x) ** 2), delayed=True)
    params = {"w": torch.zeros(SIZE, 64)}
    state = opt.init(params)
    xs = torch.from_numpy(np.random.RandomState(0).randn(SIZE, 64).astype(np.float32))
    for _ in range(18):
        params, state, _loss = step(params, state, xs)
    s = plane.samples[-1]
    assert staleness.active().last_age_max() == 1.0
    i_age = health.FLEET_FIELDS.index("stale_age_max")
    assert plane._local_vector(bft.get_context(), None, list(range(SIZE)))[0, i_age] == 1.0
    assert s["fleet"]["min"][i_age] == s["fleet"]["max"][i_age] == 1.0
    assert s["age_mean"] == 1.0
    want = staleness.age_adjusted_rate(s["predicted_rate"], 1.0, s["spectral"]["self_weight"])
    assert s["age_adjusted_rate"] == round(want, 6) and want > s["predicted_rate"]


def test_report_carries_the_async_and_shard_blocks(monkeypatch):
    from bluefog_tpu_torch import async_gossip, sharding

    plane = health.start(interval=1)
    monkeypatch.setattr(async_gossip, "active", lambda: type(
        "E", (), {"summary": lambda self: {"ticks": 3}})())
    monkeypatch.setattr(sharding, "summary", lambda: {"enabled": True})
    rep = plane.report()
    assert rep["async"] == {"ticks": 3} and rep["shard"] == {"enabled": True}


# -- the report tools ---------------------------------------------------------------------


def _tool(args):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=60,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


def test_fleet_report_renders_the_port_dump(tmp_path):
    w = _topo("ring")
    plane = health.start(interval=1)
    _drive([(plane, bft.get_context())], w, steps=15)
    art = tmp_path / "health_0.json"
    assert health.dump(str(art)) == str(art)
    out = _tool([os.path.join("tools", "fleet_report.py"), str(art), "--json"])
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["kind"] == "fleet_report" and rep["overall"] == "ok"
    assert rep["processes"][0]["mixing_efficiency"] is not None
    assert 0 <= rep["worst_rank"]["rank"] < SIZE
    out = _tool([os.path.join("tools", "fleet_report.py"), str(art)])
    assert out.returncode == 0, out.stderr
    assert "worst rank" in out.stdout and "fleet aggregate" in out.stdout


def test_fleet_report_unreadable_inputs_exit_2(tmp_path):
    bad = tmp_path / "nope.json"
    bad.write_text("{}")
    out = _tool([os.path.join("tools", "fleet_report.py"), str(bad), "--json"])
    assert out.returncode == 2


def test_doctor_triage_ingests_the_port_health_artifact(tmp_path):
    """``tools/doctor.py --health`` names the worst rank and the dominant
    advisory of the port's dump after the lossy-link run."""
    w = _topo("ring")
    bft.elastic.start(policy="average").inject("degrade", rank=2, step=0, factor=0.05, peer=3)
    plane = health.start(interval=1)
    ctx = bft.get_context()
    x = _drive([(plane, ctx)], w, steps=30)
    _drive([(plane, ctx)], w, steps=50, start_step=30, x=x, lossy=(2, 3))
    art = tmp_path / "health.json"
    health.dump(str(art))
    attr = tmp_path / "doctor.json"
    attr.write_text(json.dumps({"kind": "doctor_dump", "interval": 100, "samples": [],
                                "advisories": [], "baselines": {}, "calibration": {}}))
    out = _tool([os.path.join("tools", "doctor.py"), "--attribution", str(attr),
                 "--health", str(art), "--json"])
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["health"]["worst_rank"] is not None
    assert rep["health"]["dominant_advisory"] == "mixing_degraded"
    assert "mixing_degraded" in " ".join(rep["summary"])
