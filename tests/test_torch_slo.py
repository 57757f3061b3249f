# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""``bft.slo`` against ``bluefog_tpu.slo``, case by case as
``tests/test_slo.py`` runs the JAX module, on the same seeded inputs.

The burn rates, budgets, alerts and reports are host Python in both
packages and are held bitwise to JAX's engine fed the same series. The
canary runs on the port's CPU context (the plain versions of the wire
kernels) and on JAX's 8-device CPU mesh (``BLUEFOG_WIRE_KERNELS=0``, the
composite quantizer): the verdicts, deviations included, are equal. The
port's numpy wire oracle (``collective/wire_ref.py``, its bf16 snap without
``ml_dtypes``) is held bitwise to JAX's: random blocks, an all-zero block,
ties at the bf16 rounding boundary and a subnormal absmax. The per-leg
federation rates are within 1e-12 of JAX's. The topology controller's
``slo_burn`` flag is held equal to JAX's on the same exhausted budget.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
from bluefog_tpu import fleetsim as jfs
from bluefog_tpu import slo as jslo
from bluefog_tpu.collective import wire_ref as jwire_ref
from bluefog_tpu.collective.plan import plan_from_topology as jplan_from_topology
import bluefog_tpu.topology as tu
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import fleetsim, flight, health, metrics, slo
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import kernels, wire_ref
from bluefog_tpu_torch.collective.plan import plan_from_topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
HOST = "127.0.0.1"


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    for k in ("BLUEFOG_SLO", "BLUEFOG_SLO_INTERVAL", "BLUEFOG_SLO_FILE", "BLUEFOG_SLO_CANARY",
              "BLUEFOG_HEALTH", "BLUEFOG_HEALTH_PORT", "BLUEFOG_PODS", "BLUEFOG_DCN_PERIOD",
              "BLUEFOG_METRICS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setattr(health, "DEFAULT_HOST", HOST)
    metrics.reset()
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    slo.stop()
    jslo.stop()
    health.stop()
    bft.elastic.stop()
    bf.elastic.stop()
    bf.shutdown()
    if bft.is_initialized():
        bft.shutdown()
    metrics.reset()


def _objective(mod=slo, **kw):
    base = dict(name="avail", series="test", target=0.99, comparison="ge", window=20,
                budget_frac=0.1, fast_window=3, fast_burn=5.0, slow_window=10, slow_burn=1.5)
    base.update(kw)
    return mod.Objective(**base)


def _engine(mod=slo, **kw):
    kw.setdefault("interval", 1)
    kw.setdefault("objectives", [_objective(mod)])
    kw.setdefault("canary", False)
    return mod.SLOEngine(**kw)


def _pair(**kw):
    return _engine(slo, **kw), _engine(jslo, **kw.copy())


def _feed(engines, step, values):
    for eng in engines:
        eng.observe(None, step=step, values=values)


def _same_engine(a, b):
    """The port's and JAX's engines hold the same state: reports (the
    fleet block aside), alerts and flags."""
    ra, rb = a.report(), b.report()
    ra.pop("fleet_burn", None)
    rb.pop("fleet_burn", None)
    assert ra == rb
    assert [x.to_json() for x in a.alerts] == [x.to_json() for x in b.alerts]


def _oracle(flags, window, budget_frac):
    a = np.asarray(flags, dtype=np.int64)
    burn = (a[-window:].sum() / window) / budget_frac if len(a) >= window else None
    recent = a[-window:]
    total = budget_frac * window
    spent = int(recent.sum())
    return burn, {"total": total, "spent": spent, "remaining": max(0.0, total - spent),
                  "exhausted": spent >= total and total > 0,
                  "compliance": 1.0 - spent / len(recent) if len(recent) else 1.0}


# -- the numpy wire oracle ------------------------------------------------------


def _wire_cases():
    rng = np.random.RandomState(5)
    # the low half exactly at the rounding boundary (NaNs among them)
    ties = ((rng.randint(1, 2 ** 16, 512).astype(np.uint32) << np.uint32(16))
            | np.uint32(0x8000)).view(np.float32)
    sub = (rng.randn(512) * 1e-39).astype(np.float32)
    return {"random": (rng.randn(3 * 512 + 17) * 4).astype(np.float32),
            "zero": np.zeros(512, np.float32), "ties": ties, "subnormal": sub,
            "wide": (rng.randn(4096) * 10.0 ** rng.randint(-30, 30, 4096)).astype(np.float32)}


@pytest.mark.parametrize("case", ["random", "zero", "ties", "subnormal", "wide"])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_wire_ref_is_jax_wire_ref_bitwise(case, wire):
    x = _wire_cases()[case]
    p, s, xhat = wire_ref.np_encode(x, wire)
    jp, js, jxhat = jwire_ref.np_encode(x, wire)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(s.view(np.uint32), js.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(xhat.view(np.uint32), jxhat.view(np.uint32))
    np.testing.assert_array_equal(wire_ref.np_decode(p, s, x.size, wire).view(np.uint32),
                                  jwire_ref.np_decode(jp, js, x.size, wire).view(np.uint32))


@pytest.mark.parametrize("case", ["random", "zero", "ties", "subnormal", "wide"])
def test_bf16_snap_and_canary_replay_are_jax_bitwise(case):
    x = _wire_cases()[case]
    import ml_dtypes

    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(wire_ref.bf16_round(x).view(np.uint32), want.view(np.uint32))
    c = np.resize(x, (SIZE, slo.CANARY_ELEMS)).astype(np.float32)
    for wire in (None, "bf16", "int8", "int4", "int4_ef"):
        np.testing.assert_array_equal(slo.canary_expected(c, wire).view(np.uint32),
                                      jslo.canary_expected(c, wire).view(np.uint32))


# -- burn / budget arithmetic ---------------------------------------------------


def test_burn_and_budget_match_numpy_oracle():
    rng = np.random.RandomState(7)
    series = (rng.rand(300) < 0.12).astype(int)
    eng, jeng = _pair()
    flags = []
    st = eng._state["avail"]
    for t, bad in enumerate(series):
        _feed((eng, jeng), t, {"avail": 0.0 if bad else 1.0})
        flags.append(int(bad))
        o = st.obj
        window_flags = flags[-o.window:]
        for w in (o.fast_window, o.slow_window, o.window):
            got = slo.burn_rate(list(st.flags), w, o.budget_frac)
            want, _ = _oracle(window_flags, w, o.budget_frac)
            assert got == (pytest.approx(want) if want is not None else None), (t, w)
            assert got == jslo.burn_rate(list(st.flags), w, o.budget_frac)
        got_budget = slo.budget_state(list(st.flags), o.window, o.budget_frac)
        assert got_budget == pytest.approx(_oracle(window_flags, o.window, o.budget_frac)[1])
        assert got_budget == jslo.budget_state(list(st.flags), o.window, o.budget_frac)
    _same_engine(eng, jeng)


def test_page_fires_within_documented_bound_and_aa_control_is_silent():
    obj = _objective()
    bound = slo.page_sample_bound(obj.fast_window, obj.fast_burn, obj.budget_frac)
    assert bound == jslo.page_sample_bound(obj.fast_window, obj.fast_burn, obj.budget_frac)
    assert 1 <= bound <= obj.fast_window
    eng, jeng = _pair()
    for t in range(30):
        _feed((eng, jeng), t, {"avail": 1.0})
    assert not eng.alerts
    fired_at = None
    for k in range(obj.fast_window + 1):
        _feed((eng, jeng), 30 + k, {"avail": 0.0})
        if any(a.kind == "slo_fast_burn" for a in eng.alerts):
            fired_at = k + 1
            break
    assert fired_at is not None and fired_at <= bound
    page = [a for a in eng.alerts if a.kind == "slo_fast_burn"][0]
    assert page.detail["severity"] == "page" and page.detail["objective"] == "avail"
    _same_engine(eng, jeng)
    ctrl = _engine()
    for t in range(30 + obj.fast_window + 1):
        ctrl.observe(None, step=t, values={"avail": 1.0})
    assert not ctrl.alerts and ctrl.worst_burn() == 0.0


def test_slow_ramp_caught_by_slow_window_not_fast():
    eng, jeng = _pair()
    for t in range(200):
        _feed((eng, jeng), t, {"avail": 0.0 if t % 5 == 4 else 1.0})
    kinds = {a.kind for a in eng.alerts}
    assert "slo_slow_burn" in kinds and "slo_fast_burn" not in kinds
    ticket = [a for a in eng.alerts if a.kind == "slo_slow_burn"][0]
    assert ticket.detail["severity"] == "ticket"
    assert ticket.detail["burn"] == pytest.approx(2.0)
    _same_engine(eng, jeng)


def test_none_and_non_finite_values_skip_without_budget_charge():
    eng, jeng = _pair()
    for t in range(40):
        _feed((eng, jeng), t, {"avail": 1.0})
    st = eng._state["avail"]
    before = list(st.flags)
    for t, values in ((40, {"avail": None}), (41, {"avail": float("nan")}), (42, {})):
        _feed((eng, jeng), t, values)
    assert list(st.flags) == before and st.skips == 3
    assert eng.worst_burn() == 0.0
    _same_engine(eng, jeng)


def test_register_replaces_and_resets_history():
    eng, jeng = _pair()
    for t in range(10):
        _feed((eng, jeng), t, {"avail": 0.0})
    assert eng._state["avail"].samples == 10
    eng.register(_objective(target=0.5))
    jeng.register(_objective(jslo, target=0.5))
    assert eng._state["avail"].samples == 0 and len(eng.objectives) == 1
    _same_engine(eng, jeng)


def test_sampling_interval_and_env_knobs(monkeypatch):
    eng = slo.SLOEngine(interval=4, objectives=[_objective()], canary=False)
    for t in range(12):
        eng.observe(None, step=t, values={"avail": 1.0})
    assert eng._samples == 3
    monkeypatch.setenv("BLUEFOG_SLO_INTERVAL", "nonsense")
    assert slo.slo_interval() == slo.DEFAULT_INTERVAL == jslo.DEFAULT_INTERVAL
    monkeypatch.setenv("BLUEFOG_SLO_INTERVAL", "3")
    assert slo.slo_interval() == 3 == jslo.slo_interval()
    assert not slo.enabled()
    monkeypatch.setenv("BLUEFOG_SLO", "1")
    assert slo.enabled()
    assert slo.canary_enabled()
    monkeypatch.setenv("BLUEFOG_SLO_CANARY", "0")
    assert not slo.canary_enabled()
    assert [o.to_json() for o in slo.default_objectives()] == \
        [o.to_json() for o in jslo.default_objectives()]


def test_on_init_gates_session_on_env(monkeypatch):
    assert slo.active() is None
    monkeypatch.setenv("BLUEFOG_SLO", "1")
    bft.shutdown()
    bft.init(device="cpu")
    assert slo.active() is not None
    bft.shutdown()
    assert slo.active() is None


# -- surfaces -------------------------------------------------------------------


def test_alert_emission_reaches_all_surfaces(tmp_path, monkeypatch):
    path = tmp_path / "slo.jsonl"
    monkeypatch.setenv("BLUEFOG_SLO_FILE", str(path))
    flight.reconfigure()
    eng = _engine()
    for t in range(30):
        eng.observe(None, step=t, values={"avail": 1.0})
    for t in range(30, 34):
        eng.observe(None, step=t, values={"avail": 0.0})
    assert any(a.kind == "slo_fast_burn" for a in eng.alerts)
    assert metrics.peek("bluefog.doctor.advisory.slo_fast_burn").value >= 1
    assert metrics.peek("bluefog.slo.alerts").value >= 1
    dump = json.loads(open(bft.flight_dump(str(tmp_path / "flight.json"))).read())
    assert "slo_fast_burn" in [a.get("kind") for a in dump["advisories"]]
    assert dump["slo_snapshots"] and dump["slo_snapshots"][-1]["worst_burn"] > 0
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert any(line.get("advisory_kind") == "slo_fast_burn" for line in lines)
    assert any(line.get("kind") == "sample" for line in lines)
    assert metrics.peek("bluefog.slo.burn_fast.avail").value >= 5.0
    assert metrics.peek("bluefog.slo.budget_remaining.avail") is not None
    jpath = tmp_path / "jax.jsonl"
    monkeypatch.setenv("BLUEFOG_SLO_FILE", str(jpath))
    jeng = _engine(jslo)
    for t in range(34):
        jeng.observe(None, step=t, values={"avail": 1.0 if t < 30 else 0.0})
    jlines = [json.loads(line) for line in jpath.read_text().splitlines()]
    assert [{k: v for k, v in line.items() if k != "ts"} for line in lines] == \
        [{k: v for k, v in line.items() if k != "ts"} for line in jlines]


def test_flight_reconfigure_clears_slo_side_table():
    flight.reconfigure()
    flight.note_slo(step=1, worst_burn=2.0, exhausted=[], canary_ok=True)
    assert flight._build_dump("test")["slo_snapshots"] == [
        {"step": 1, "worst_burn": 2.0, "exhausted": [], "canary_ok": True}]
    flight.reconfigure()
    assert flight._build_dump("test")["slo_snapshots"] == []


# -- /healthz escalation and /slo -------------------------------------------------


def _exhaust(eng):
    for t in range(40):
        eng.observe(None, step=t, values={"avail": 0.0})


def test_autotune_decision_record_carries_slo_burn():
    """JAX's test of the same name: the controller's decision records
    carry the worst fast-window burn, 0.0 with the engine off; equal to
    JAX's on the same spent budget."""
    from bluefog_tpu import autotune as jautotune
    from bluefog_tpu_torch import autotune

    assert autotune._slo_burn() == 0.0 == jautotune._slo_burn()
    engines = (slo.start(interval=1, objectives=[_objective()], canary=False),
               jslo.start(interval=1, objectives=[_objective(jslo)], canary=False))
    for eng in engines:
        _exhaust(eng)
    assert autotune._slo_burn() == pytest.approx(10.0)
    assert autotune._slo_burn() == jautotune._slo_burn()
    recs = [mod.DecisionRecord(seq=0, step=1, comm_steps=1, action="hold", triggers=[], blamed=[],
                               candidates=[], chosen=None, predicted={}, hysteresis={},
                               topo_version_before=0, topo_version_after=0, dry_run=False,
                               slo_burn=mod._slo_burn())
            for mod in (autotune, jautotune)]
    assert recs[0].to_json() == recs[1].to_json()
    assert recs[0].to_json()["slo_burn"] == pytest.approx(10.0)


def test_budget_exhaustion_escalates_healthz_to_critical():
    eng = slo.start(interval=1, objectives=[_objective()], canary=False)
    plane = health.start(interval=1)
    v = health.healthz_verdict(plane)
    assert v["status"] == "ok" and v["slo_exhausted"] == []
    _exhaust(eng)
    assert eng.exhausted_objectives() == ["avail"]
    v = health.healthz_verdict(plane)
    assert v["status"] == "critical" and v["slo_exhausted"] == ["avail"]
    assert any("slo budget exhausted" in r for r in v["reasons"])
    srv = health.serve(0)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://{HOST}:{srv.port}/healthz")
    assert err.value.code == 503
    assert json.loads(err.value.read())["slo_exhausted"] == ["avail"]
    srv.close()


def test_slo_endpoint_serves_report_and_404_lists_it():
    eng = slo.start(interval=1, objectives=[_objective()], canary=False)
    jeng = _engine(jslo)
    for t in range(25):
        _feed((eng, jeng), t, {"avail": 1.0 if t % 7 else 0.0})
    srv = health.serve(0)
    base = f"http://{HOST}:{srv.port}"
    rep = json.loads(urllib.request.urlopen(base + "/slo").read())
    assert rep["kind"] == "slo_dump"
    assert [o["name"] for o in rep["objectives"]] == ["avail"]
    assert rep["objectives"][0]["budget"]["spent"] >= 1
    assert rep == json.loads(json.dumps(jeng.report()))
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/nope")
    assert err.value.code == 404 and "/slo" in json.loads(err.value.read())["paths"]
    slo.stop()
    assert json.loads(urllib.request.urlopen(base + "/slo").read())["objectives"] == []
    srv.close()


def test_slo_endpoint_non_finite_guard():
    eng = slo.start(interval=1, objectives=[_objective()], canary=False)
    for t in range(5):
        eng.observe(None, step=t, values={"avail": 1.0})
    eng._state["avail"].last_value = float("nan")
    eng.samples.append({"kind": "sample", "step": 99, "worst_burn": float("inf"),
                        "objectives": {}})
    srv = health.serve(0)

    def reject(tok):
        raise ValueError(f"non-finite token {tok!r}")

    raw = urllib.request.urlopen(f"http://{HOST}:{srv.port}/slo").read()
    rep = json.loads(raw, parse_constant=reject)
    assert rep["objectives"][0]["last_value"] is None
    assert rep["samples"][-1]["worst_burn"] is None
    srv.close()


def test_concurrent_scrapes_during_sampled_publishes():
    eng = slo.start(interval=1, objectives=[_objective()], canary=False)
    srv = health.serve(0)
    base = f"http://{HOST}:{srv.port}"
    errors = []
    stop = threading.Event()

    def scrape(path):
        while not stop.is_set():
            try:
                json.loads(urllib.request.urlopen(base + path, timeout=5).read())
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    errors.append((path, repr(e)))
                    return
            except Exception as e:
                errors.append((path, repr(e)))
                return

    threads = [threading.Thread(target=scrape, args=(p,), daemon=True)
               for p in ("/slo", "/healthz")]
    for t in threads:
        t.start()
    rng = np.random.RandomState(3)
    for t_step in range(120):
        eng.observe(None, step=t_step, values={"avail": float(rng.rand() > 0.2)})
    stop.set()
    for t in threads:
        t.join(timeout=10)
    srv.close()
    assert not errors, errors


# -- fleet field ----------------------------------------------------------------


def test_fleet_field_and_health_report_carry_slo_burn():
    assert health.FLEET_FIELDS[-1] == "slo_burn"
    eng = slo.start(interval=1, objectives=[_objective()], canary=False)
    _exhaust(eng)
    assert slo.worst_burn() == pytest.approx(10.0)
    ctx = bft.get_context()
    plane = health.start(interval=1)
    i = list(health.FLEET_FIELDS).index("slo_burn")
    assert np.allclose(plane._local_vector(ctx, None, list(range(SIZE)))[:, i], 10.0)
    rep = plane.report()
    assert rep["slo"]["worst_burn"] == pytest.approx(10.0)
    assert rep["slo"]["exhausted"] == ["avail"]
    slo.stop()
    assert np.allclose(plane._local_vector(ctx, None, list(range(SIZE)))[:, i], 0.0)
    assert "slo" not in plane.report()


def test_federation_leg_resolvers_and_fleet_block_match_jax(monkeypatch):
    """The ``ici_consensus`` and ``dcn_consensus`` objectives read the
    federated fabric's per-leg rates (within 1e-12 of JAX's), ``/fleet``
    carries the fabric's block, and a flat run reads None."""
    from bluefog_tpu import health as jhealth

    assert slo._resolve_federation_leg("ici") is None
    monkeypatch.setenv("BLUEFOG_PODS", "2")
    monkeypatch.setenv("BLUEFOG_DCN_PERIOD", "2")
    rates = {}
    for leg in ("ici", "dcn"):
        got, want = slo._resolve_federation_leg(leg), jslo._resolve_federation_leg(leg)
        assert got is not None and abs(got - want) <= 1e-12
        rates[leg] = got
    # the pods alone never reach consensus; the composed window does
    assert abs(rates["ici"] - 1.0) <= 1e-12 and 0.0 < rates["dcn"] < 1.0
    rep = health.start(interval=1).report()
    jrep = jhealth.start(interval=1).report()
    jhealth.stop()
    got, want = rep["federation"], jrep["federation"]
    assert abs(got.pop("predicted_rate") - want.pop("predicted_rate")) <= 1e-12
    assert got == want


# -- canary lane ----------------------------------------------------------------


def _plans(wire=None, graph="exp2"):
    gen = {"exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
           "ring": (tu.RingGraph, ttu.RingGraph)}[graph]
    bf.set_topology(gen[0](SIZE))
    bft.set_topology(gen[1](SIZE))
    return (plan_from_topology(bft.get_context().load_topology()),
            jplan_from_topology(bf.get_context().load_topology()))


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4", "int8_ef"])
def test_canary_clean_fabric_passes_against_wire_replay(wire):
    plan, jplan = _plans(wire)
    assert plan.perms == jplan.perms
    lane = slo.CanaryLane()
    verdict = lane.probe(bft.get_context(), plan, wire)
    assert verdict["ok"], verdict
    assert verdict["rounds"] == 3
    assert verdict["wire"] == (wire or "fp32").replace("_ef", "")
    assert lane.probes == 1 and lane.failures == 0
    assert verdict == jslo.CanaryLane().probe(bf.get_context(), jplan, wire)


def test_canary_delivers_the_plain_wire_bitwise():
    """On int8/int4 the canary op is one ``encode`` and one ``decode`` a
    round, bitwise the plain versions' delivery of each sender's block."""
    plan, _ = _plans()
    ctx = bft.get_context()
    c = torch.from_numpy(slo.canary_signal(SIZE))
    src = torch.from_numpy(slo._round_sources(plan.perms, SIZE))
    for wire in ("int8", "int4"):
        got = slo._canary_program(ctx, plan.perms, wire)(c, src)
        p, s = kernels.encode_reference(c, wire)
        for r in range(len(plan.perms)):
            want = kernels.decode_reference(p, s, src[r], wire)
            assert torch.equal(got[:, r], want)
    assert ("slo_canary", plan.perms, "int4") in ctx.op_cache


def test_canary_flips_on_degrade_fault_naming_edge():
    plan, jplan = _plans()
    verdicts = []
    for mod, pkg, p in ((slo, bft, plan), (jslo, bf, jplan)):
        session = pkg.elastic.start(policy="average")
        session.inject("degrade", rank=2, step=0, factor=0.05, peer=3)
        verdicts.append(mod.CanaryLane().probe(pkg.get_context(), p, "int8"))
    verdict = verdicts[0]
    assert not verdict["ok"]
    assert verdict["edges"][0][:2] == [2, 3]
    assert verdict["max_dev"] > 100 * slo.CANARY_TOL
    assert {tuple(e[:2]) for e in verdict["edges"]} == {(2, 3)}
    assert verdict == verdicts[1]


def test_canary_advisory_and_gauges_on_failure():
    plan, _ = _plans(graph="ring")
    session = bft.elastic.start(policy="average")
    session.inject("degrade", rank=1, step=0, factor=0.1, peer=2)
    eng = slo.start(interval=1, objectives=[], canary=True)
    eng.observe(bft.get_context(), step=0, plan=plan, wire=None)
    assert metrics.peek("bluefog.slo.canary_ok").value == 0.0
    assert metrics.peek("bluefog.slo.canary_probes").value == 1
    advs = [a for a in eng.alerts if a.kind == "slo_canary_failed"]
    assert advs and advs[0].detail["edges"][0][:2] == [1, 2]


def test_optimizer_hook_runs_canary_without_touching_programs():
    """The hook on both dispatch paths: sampled steps probe, the canary
    has its own op-cache key, no other key appears, and the parameters
    are bitwise those of the engine off."""
    _plans()
    rng = np.random.RandomState(0)
    w0 = (rng.randn(16, 16) / 4.0).astype(np.float32)
    xs = torch.from_numpy(rng.randn(SIZE, 4, 16).astype(np.float32))
    ys = torch.from_numpy(rng.randn(SIZE, 4, 16).astype(np.float32))

    def loss_fn(p, x, y):
        return ((x @ p["w"] - y) ** 2).mean()

    def run(engine_on, fused):
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.01))
        opt.compression = "int8"
        params = {"w": torch.from_numpy(np.stack([w0] * SIZE))}
        state = opt.init(params)
        step = bft.make_train_step(opt, loss_fn)
        for _ in range(2):
            params, state, _ = step(params, state, xs, ys)
        keys = set(bft.get_context().op_cache)
        eng = slo.start(interval=2, canary=True) if engine_on else None
        for _ in range(6):
            if fused:
                params, state, _ = step(params, state, xs, ys)
            else:
                w = params["w"].detach().clone().requires_grad_(True)
                g = torch.stack([torch.autograd.grad(loss_fn({"w": w[j]}, xs[j], ys[j]), w)[0][j]
                                 for j in range(SIZE)])
                opt.step(params, state, {"w": g})
        slo.stop()
        added = {k[0] for k in set(bft.get_context().op_cache) - keys}
        return params["w"].numpy().copy(), eng, added

    for fused in (True, False):
        off, _, added_off = run(False, fused)
        on, eng, added = run(True, fused)
        np.testing.assert_array_equal(off.view(np.uint32), on.view(np.uint32))
        assert eng._samples == 3 and eng.canary.probes == 3 and eng.canary.last["ok"]
        assert added_off == set() and added <= {"slo_canary"}
        assert any(k[0] == "slo_canary" for k in bft.get_context().op_cache)


# -- fleetsim rehearsal -----------------------------------------------------------


def test_fleetsim_churn_storm_burn_rehearsal_n1024():
    n = 1024
    fleets = (fleetsim.VirtualFleet(n, topology="exp2", policy="receiver",
                                    plan=fleetsim.storm_plan(n, 0.10, step=10, seed=3), seed=3),
              jfs.VirtualFleet(n, topology="exp2", policy="receiver",
                               plan=jfs.storm_plan(n, 0.10, step=10, seed=3), seed=3))
    engines = []
    for mod in (slo, jslo):
        obj = mod.Objective("availability", "fleetsim live fraction", target=0.95,
                            comparison="ge", window=30, budget_frac=0.1, fast_window=4,
                            fast_burn=5.0, slow_window=15, slow_burn=1.5)
        engines.append(mod.SLOEngine(interval=1, objectives=[obj], canary=False))
    fracs = []
    for t in range(30):
        for vf, eng in zip(fleets, engines):
            vf.tick()
            eng.observe(None, step=t, values={"availability": vf._live_count / n})
        fracs.append(fleets[0]._live_count / n)
    eng = engines[0]
    obj = eng.objectives[0]
    flags = [0 if f >= 0.95 else 1 for f in fracs]
    st = eng._state["availability"]
    want_burn, _ = _oracle(flags[-obj.window:], obj.fast_window, obj.budget_frac)
    assert slo.burn_rate(list(st.flags), obj.fast_window, obj.budget_frac) == \
        pytest.approx(want_burn)
    _, want_full = _oracle(flags[-obj.window:], obj.window, obj.budget_frac)
    assert slo.budget_state(list(st.flags), obj.window, obj.budget_frac) == \
        pytest.approx(want_full)
    assert sum(flags[:10]) == 0 and all(flags[11:])
    page = [a for a in eng.alerts if a.kind == "slo_fast_burn"]
    assert page and page[0].step <= 10 + obj.fast_window
    _same_engine(eng, engines[1])


# -- tools ------------------------------------------------------------------------


def test_slo_report_tool(tmp_path):
    """``tools/slo_report.py`` (no JAX import) on the port's artifact, the
    same report as on JAX's."""
    reports = []
    for mod in (slo, jslo):
        eng = mod.start(interval=1, objectives=[_objective(mod)], canary=False)
        for t in range(40):
            eng.observe(None, step=t, values={"avail": 1.0 if t < 30 else 0.0})
        art = tmp_path / f"{mod.__name__}.json"
        mod.dump(str(art))
        outs = [subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "slo_report.py"), str(art), *flag],
            capture_output=True, text=True, timeout=60, cwd=REPO) for flag in (["--json"], [])]
        for out in outs:
            assert out.returncode == 0, out.stderr
        reports.append((json.loads(outs[0].stdout), outs[1].stdout))
    rep, text = reports[0]
    assert rep["objectives"][0]["name"] == "avail"
    assert rep["objectives"][0]["budget"]["exhausted"] is True
    assert rep["worst_alert"] == "slo_budget_exhausted" or rep["alerts"] >= 1
    assert "avail" in text and "budget" in text.lower()
    assert reports[0] == reports[1]
