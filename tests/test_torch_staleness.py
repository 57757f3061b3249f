# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's staleness observatory (``bft.staleness``) against the JAX
package's ``bf.staleness``, mirroring ``tests/test_staleness.py`` (the health
plane's fleet field is held in ``tests/test_torch_health.py``).

Tolerances. The delivered ages, the lane's self-check, the advisories and
every field of a sample are integer bookkeeping over the same steps: held
EXACTLY equal to JAX's observatory run beside the port's on the same
problem. ``lineage_exchange`` is held bitwise to JAX's inside
``shard_map``; ``age_adjusted_rate`` exactly (the same numpy roots).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import context as jctx_mod
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import scaling as jscaling
from bluefog_tpu import staleness as jstaleness
from bluefog_tpu import topology as jtu
from bluefog_tpu.collective import inner as jinner
from bluefog_tpu.collective.plan import plan_from_topology as jplan_from_topology
from bluefog_tpu_torch import flight, metrics, scaling, staleness
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective import inner
from bluefog_tpu_torch.collective.plan import plan_from_topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
GRAPHS = {"exp2": (tu.ExponentialTwoGraph, jtu.ExponentialTwoGraph),
          "ring": (tu.RingGraph, jtu.RingGraph), "star": (tu.StarGraph, jtu.StarGraph)}


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    for k in ("BLUEFOG_STALENESS", "BLUEFOG_STALENESS_INTERVAL", "BLUEFOG_STALENESS_BOUND",
              "BLUEFOG_STALENESS_FILE", "BLUEFOG_METRICS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    metrics.reset()
    jmetrics.reset()
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    staleness.stop()
    jstaleness.stop()
    bft.elastic.stop()
    bf.elastic.stop()
    bf.win_free()
    bf.shutdown()
    if bft.is_initialized():
        bft.shutdown()
    metrics.reset()
    jmetrics.reset()


def _topology(name):
    bft.set_topology(GRAPHS[name][0](SIZE))
    bf.set_topology(GRAPHS[name][1](SIZE))


def _consensus(dim=1024, seed=0):
    """The JAX test's consensus problem on both sides: ``(port step, JAX
    step)``, each a no-argument call taking one optimizer step."""
    z0 = np.random.RandomState(seed).randn(SIZE, dim).astype(np.float32)
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.01))
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.01))
    tp = torch.from_numpy(z0.copy())
    jp = {"w": bf.worker_values(lambda r: z0[r])}
    carry = {"t": (tp, topt.init(tp)), "j": (jp, jopt.init(jp))}
    tg = torch.zeros_like(tp)
    jg = {"w": bf.worker_values(lambda r: np.zeros(dim, np.float32))}

    def port(step_fn=None):
        p, s = carry["t"]
        carry["t"] = (step_fn or topt.step)(p, s, tg)

    def jax_(step_fn=None):
        p, s = carry["j"]
        carry["j"] = (step_fn or jopt.step)(p, s, jg)

    return port, jax_, topt, jopt


def _same_samples(obs, jobs, skip=()):
    assert len(obs.samples) == len(jobs.samples) > 0
    for s, js in zip(obs.samples, jobs.samples):
        assert {k: v for k, v in s.items() if k not in skip} == \
            {k: v for k, v in js.items() if k not in skip}


# -- pure helpers -----------------------------------------------------------------


def test_age_adjusted_rate_equals_jax():
    for rate in (None, 0.0, 0.3, 0.805, 0.99, 1.0, 1.2):
        for age in (None, -1, 0, 0.4, 1, 1.6, 3, 7):
            for s in (0.0, 0.25, 0.5, 1.0):
                assert staleness.age_adjusted_rate(rate, age, s) == \
                    jstaleness.age_adjusted_rate(rate, age, s)
    lam, s = 0.805, 0.5
    assert staleness.age_adjusted_rate(lam, 1, s) == pytest.approx(
        (s + np.sqrt(s * s + 4 * (lam - s))) / 2.0, abs=1e-12)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_lineage_exchange_is_bitwise_jax(graph):
    """The lane on the rounds of Exp2, the ring and the star (whose rounds
    leave receivers without a sender, which get zeros)."""
    perms = tuple(plan_from_topology(GRAPHS[graph][0](SIZE)).perms)
    assert perms == tuple(jplan_from_topology(GRAPHS[graph][1](SIZE)).perms)
    tags = np.random.RandomState(1).randint(-2**31, 2**31 - 1, (SIZE, len(perms), 3),
                                            dtype=np.int64).astype(np.int32)
    ctx = bf.get_context()
    axis = jctx_mod.WORKER_AXIS
    fn = jax.jit(jax.shard_map(
        lambda t: jnp.expand_dims(jinner.lineage_exchange(t[0], perms, axis), 0),
        mesh=ctx.mesh, in_specs=P(axis), out_specs=P(axis)))
    want = np.asarray(fn(jnp.asarray(tags)))
    src = torch.from_numpy(np.array(plan_from_topology(GRAPHS[graph][0](SIZE)).sources()))
    got = inner.lineage_exchange(torch.from_numpy(tags.transpose(1, 0, 2).copy()), src)
    assert np.array_equal(got.numpy().transpose(1, 0, 2), want)
    if graph == "star":
        assert (want == 0).all(axis=-1).any()
    empty = torch.zeros(0, SIZE, 3, dtype=torch.int32)
    assert inner.lineage_exchange(empty, torch.zeros(0, SIZE, dtype=torch.int32)).shape == \
        (0, SIZE, 3)


def test_lineage_sidecar_pricing_equals_jax():
    assert staleness.LINEAGE_TAG_BYTES == jstaleness.LINEAGE_TAG_BYTES == \
        scaling.LINEAGE_TAG_BYTES == jscaling.LINEAGE_TAG_BYTES == 12
    assert staleness.LINEAGE_FIELDS == jstaleness.LINEAGE_FIELDS
    for wire in (None, "bf16", "int8", "int4", "int8_ef", "int4_ef"):
        for lineage in (False, True):
            assert scaling.wire_payload_bytes(4096, 4, wire, lineage=lineage) == \
                jscaling.wire_payload_bytes(4096, 4, wire, lineage=lineage)
        assert scaling.wire_bytes_per_step({4: 4096}, 3, wire, lineage=True) == \
            jscaling.wire_bytes_per_step({4: 4096}, 3, wire, lineage=True)
    summary = scaling.plan_comm_summary(plan_from_topology(tu.RingGraph(SIZE)), 1 << 20)
    jsummary = jscaling.plan_comm_summary(jplan_from_topology(jtu.RingGraph(SIZE)), 1 << 20)
    assert summary["lineage_sidecar_bytes_per_round"] == \
        jsummary["lineage_sidecar_bytes_per_round"] == 12


# -- the lineage lane ---------------------------------------------------------------


def test_sync_age_zero_and_the_self_check_equal_jax():
    _topology("ring")
    port, jax_, _topt, _jopt = _consensus()
    obs, jobs = staleness.start(interval=1), jstaleness.start(interval=1)
    for _ in range(4):
        port()
        jax_()
    _same_samples(obs, jobs)
    assert all(s["surface"] == "sync" and s["age_max"] == 0.0 and s["lane_ok"]
               and s["edges"] == 2 * SIZE for s in obs.samples)
    assert obs.report()["edge_ages"] == jobs.report()["edge_ages"]
    assert metrics.peek("bluefog.staleness.age").count == 8 * SIZE
    assert metrics.peek("bluefog.staleness.age_max").value == 0.0
    assert metrics.peek("bluefog.staleness.wire_bytes").value == \
        jmetrics.peek("bluefog.staleness.wire_bytes").value > 0
    assert metrics.peek("bluefog.staleness.selfcheck_failures") is None


def test_unsampled_steps_pay_nothing_and_the_lane_has_its_own_cache_family():
    """Interval 3 over 6 steps: two samples, one ``staleness_lane`` entry
    and no other new op-cache key; trajectories bitwise observatory off."""
    _topology("ring")
    ctx = bft.get_context()

    def run(on):
        if on:
            staleness.start(interval=3)
        else:
            staleness.stop()
        port, _j, topt, _jopt = _consensus()
        keys = set(ctx.op_cache)
        for _ in range(6):
            port()
        return port, set(ctx.op_cache) - keys

    port_off, new_off = run(False)
    port_on, new_on = run(True)
    lane = {k for k in new_on if k[0] == "staleness_lane"}
    assert len(lane) == 1 and new_on - lane == new_off
    assert len(staleness.active().samples) == 2


def test_delayed_age_one_with_the_reseed_transition_equals_jax():
    """``delayed=True`` reads age 1 in the steady state; a topology swap
    reseeds the delay buffer, so one age-0 sample marks the seam."""
    _topology("ring")
    z0 = np.stack([np.random.RandomState(r).randn(600).astype(np.float32)
                   for r in range(SIZE)])
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.0))
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.0))
    tstep = topt.make_train_step(lambda p, x: ((p["w"] - x) ** 2).mean(), delayed=True)
    jstep = jopt.make_train_step(lambda p, x: ((p["w"] - x) ** 2).mean(), delayed=True)
    tp = {"w": torch.from_numpy(z0.copy())}
    jp = {"w": bf.worker_values(lambda r: z0[r])}
    ts, js = topt.init(tp), jopt.init(jp)
    tx, jx = torch.zeros(SIZE, 600), bf.worker_values(lambda r: np.zeros(600, np.float32))
    obs, jobs = staleness.start(interval=1), jstaleness.start(interval=1)
    for i in range(8):
        if i == 5:
            _topology("exp2")
        tp, ts, _ = tstep(tp, ts, tx)
        jp, js, _ = jstep(jp, js, jx)
    _same_samples(obs, jobs)
    ages = [s["age_mean"] for s in obs.samples]
    assert ages == [0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0]
    assert {s["surface"] for s in obs.samples} == {"delayed"}
    assert all(s["lane_ok"] for s in obs.samples)


def _stall_run(tmp_path, faults, steps, bound=2, jsonl=None):
    """Both observatories over guarded consensus steps under the same
    stall faults."""
    _topology("ring")
    session, jsession = bft.elastic.start(), bf.elastic.start()
    for kw in faults:
        session.inject("stall", **kw)
        jsession.inject("stall", **kw)
    obs, jobs = staleness.start(interval=1, bound=bound), jstaleness.start(interval=1,
                                                                             bound=bound)
    port, jax_, topt, jopt = _consensus(dim=600)
    tguard, jguard = bft.elastic.guard(topt), bf.elastic.guard(jopt)
    for _ in range(steps):
        port(tguard.step)
        jax_(jguard.step)
    return obs, jobs


def test_peer_narrowed_stall_breach_names_the_edge_equal_jax(tmp_path, monkeypatch):
    jsonl = tmp_path / "staleness.jsonl"
    monkeypatch.setenv("BLUEFOG_STALENESS_FILE", str(jsonl))
    obs, jobs = _stall_run(tmp_path, [dict(rank=2, step=2, steps=3, peer=3)], 8)
    _same_samples(obs, jobs)
    assert [a.to_json() for a in obs.advisories] == [a.to_json() for a in jobs.advisories]
    spikes = [s["age_max"] for s in obs.samples if s.get("max_edge") == [2, 3]]
    assert max(spikes) == 3.0
    for edge, rec in obs.report()["edge_ages"].items():
        assert rec["max"] == (3.0 if edge == "2->3" else 0.0), edge
    breaches = [a for a in obs.advisories if a.kind == "staleness_breach"]
    assert len(breaches) == 1 and breaches[0].detail["edges"] == [[2, 3]]
    assert [2, 3] in breaches[0].detail["suspect_faults"]
    assert metrics.peek("bluefog.doctor.advisory.staleness_breach").value == 1
    assert any(a.get("kind") == "staleness_breach" for a in flight._advisories)
    assert any(json.loads(line).get("kind") == "advisory"
               for line in jsonl.read_text().splitlines())


def test_second_edge_breach_not_muted_by_the_first_equal_jax(tmp_path):
    obs, jobs = _stall_run(tmp_path, [dict(rank=2, step=1, steps=8, peer=3),
                                      dict(rank=5, step=3, steps=8, peer=6)], 10)
    _same_samples(obs, jobs)
    named = [tuple(e) for a in obs.advisories for e in a.detail["edges"]]
    assert named == [tuple(e) for a in jobs.advisories for e in a.detail["edges"]]
    assert (2, 3) in named and (5, 6) in named
    assert named.count((2, 3)) <= 2 and named.count((5, 6)) <= 2


def test_elastic_repair_resets_the_edge_table_equal_jax():
    _topology("ring")
    session, jsession = bft.elastic.start(policy="average"), bf.elastic.start(policy="average")
    obs, jobs = staleness.start(interval=1), jstaleness.start(interval=1)
    port, jax_, topt, jopt = _consensus(dim=600)
    tguard, jguard = bft.elastic.guard(topt), bf.elastic.guard(jopt)
    for i in range(4):
        if i == 2:
            session.inject("kill", rank=3, step=session.step)
            jsession.inject("kill", rank=3, step=jsession.step)
        port(tguard.step)
        jax_(jguard.step)
    _same_samples(obs, jobs, skip=("topo_version",))
    assert obs.edge_ages.keys() == jobs.edge_ages.keys()
    assert all(3 not in e for e in obs.edge_ages)
    assert all(s["lane_ok"] for s in obs.samples)
    assert obs.samples[-1]["live_epoch"] == 1


# -- the window and async surfaces -----------------------------------------------------


def test_window_ages_fold_equal_jax():
    _topology("ring")
    obs, jobs = staleness.start(interval=1), jstaleness.start(interval=1)
    x = np.stack([np.full(16, float(r), np.float32) for r in range(SIZE)])
    bft.win_create(torch.from_numpy(x), "stalewin")
    bf.win_create(bf.worker_values(lambda r: x[r]), "stalewin")
    for mod in (bft, bf):
        mod.win_put(name="stalewin")
        mod.win_update(name="stalewin")
        mod.win_update(name="stalewin")
    _same_samples(obs, jobs)
    assert [s["age_max"] for s in obs.samples] == [0.0, 1.0]
    assert metrics.peek("bluefog.staleness.window_age").count > 0
    bft.win_free("stalewin")


def test_two_windows_sample_independently_equal_jax():
    _topology("ring")
    obs, jobs = staleness.start(interval=2), jstaleness.start(interval=2)
    x = np.stack([np.full(8, float(r), np.float32) for r in range(SIZE)])
    for name in ("alt_a", "alt_b"):
        bft.win_create(torch.from_numpy(x), name)
        bf.win_create(bf.worker_values(lambda r: x[r]), name)
    for _ in range(4):
        for mod in (bft, bf):
            mod.win_update(name="alt_a")
            mod.win_update(name="alt_b")
    _same_samples(obs, jobs)
    assert {s["window"] for s in obs.samples} == {"alt_a", "alt_b"}
    bft.win_free()


def test_window_optimizer_steps_fold_equal_jax():
    _topology("ring")
    obs, jobs = staleness.start(interval=1), jstaleness.start(interval=1)
    z0 = np.random.RandomState(0).randn(SIZE, 64).astype(np.float32)
    topt = bft.DistributedPushSumOptimizer(bft.sgd(0.0), window_prefix="ps")
    jopt = bf.DistributedPushSumOptimizer(optax.sgd(0.0), window_prefix="ps")
    tp, jp = {"w": torch.from_numpy(z0.copy())}, {"w": bf.worker_values(lambda r: z0[r])}
    ts, js = topt.init(tp), jopt.init(jp)
    for _ in range(3):
        tp, ts = topt.step(ts, {"w": torch.zeros(SIZE, 64)})
        jp, js = jopt.step(js, {"w": jnp.zeros((SIZE, 64), jnp.float32)})
    _same_samples(obs, jobs)
    assert len(obs.samples) == 3 and {s["surface"] for s in obs.samples} == {"window"}
    topt.free()


def test_async_fold_equals_jax_and_the_engine_gate():
    """The async engine's window on ``surface="async"``, a slow rank at
    cadence 4: the samples equal JAX's tick by tick, and each tick's
    folded ages are the ones the gate reads at the next tick."""
    bft.set_topology(tu.RingGraph(SIZE, connect_style=1))
    bf.set_topology(jtu.RingGraph(SIZE, connect_style=1))
    z0 = np.random.RandomState(3).randn(SIZE, 3).astype(np.float32)
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.0))
    tstep = bft.make_async_train_step(
        topt, lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2), cadence={0: 4})
    jstep = bf.make_async_train_step(
        jopt, lambda p, t: 0.5 * jnp.sum((p["w"] - t) ** 2), cadence={0: 4})
    tp, jp = {"w": torch.from_numpy(z0.copy())}, {"w": jnp.asarray(z0)}
    ts, js = topt.init(tp), jopt.init(jp)
    gate_ages = []
    eng = tstep.engine
    gate = eng._gate

    def spy(ctx, win, participating, ages):
        gate_ages.append({(int(s), int(r)): int(ages[r, k])
                          for r, srcs in enumerate(win.in_neighbors)
                          for k, s in enumerate(srcs)})
        return gate(ctx, win, participating, ages)

    eng._gate = spy
    obs, jobs = staleness.start(interval=1), jstaleness.start(interval=1)
    for _ in range(7):
        tp, ts, _ = tstep(tp, ts, torch.from_numpy(z0))
        jp, js, _ = jstep(jp, js, jnp.asarray(z0))
    # the engines name their windows from per-package counters
    _same_samples(obs, jobs, skip=("window",))
    assert {s["window"] for s in obs.samples} == {eng._name}
    samples = [s for s in obs.samples if s["surface"] == "async"]
    assert len(samples) == 7 and max(s["age_max"] for s in samples) >= 2
    for s, ages in zip(samples, gate_ages[1:]):
        assert s["age_max"] == max(ages.values())
        assert s["age_mean"] == round(float(np.mean(list(ages.values()))), 4)
    assert obs.last_age_max() >= 1
    eng.free()


# -- the dump and the report --------------------------------------------------------


def test_dump_and_the_staleness_report(tmp_path, monkeypatch):
    jsonl = tmp_path / "staleness.jsonl"
    monkeypatch.setenv("BLUEFOG_STALENESS_FILE", str(jsonl))
    obs, jobs = _stall_run(tmp_path, [dict(rank=2, step=1, steps=3, peer=3)], 6)
    path = tmp_path / "staleness_dump.json"
    assert bft.staleness.dump(str(path)) == str(path)
    d = json.loads(path.read_text())
    jd = jobs.report()
    assert {k: v for k, v in d.items() if k != "samples"} == \
        {k: v for k, v in json.loads(json.dumps(jd)).items() if k != "samples"}
    assert d["edge_ages"]["2->3"]["max"] == 3.0
    env = dict(os.environ, PYTHONPATH=REPO)
    for args in ([str(path)], ["--jsonl", str(jsonl)]):
        out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "staleness_report.py"),
                              *args, "--json"], capture_output=True, text=True, env=env,
                             timeout=60)
        assert out.returncode == 0, out.stderr
        rep = json.loads(out.stdout)
        assert rep["kind"] == "staleness_report" and rep["breaches"]
        assert rep["breaches"][0]["edges"] == [[2, 3]]
    assert rep["lane_selfcheck_failures"] == 0 or rep["lane_selfcheck_failures"] is None


def test_knobs_and_init_follow_the_jax_module(monkeypatch):
    for k in ("BLUEFOG_STALENESS_INTERVAL", "BLUEFOG_STALENESS_BOUND"):
        monkeypatch.setenv(k, "not-a-number")
    assert staleness.staleness_interval() == jstaleness.staleness_interval() == 20
    assert staleness.staleness_bound() == jstaleness.staleness_bound() == 4
    monkeypatch.setenv("BLUEFOG_STALENESS", "1")
    bft.init(device="cpu")
    assert staleness.active() is not None
    monkeypatch.delenv("BLUEFOG_STALENESS")
    bft.init(device="cpu")
    assert staleness.active() is None
