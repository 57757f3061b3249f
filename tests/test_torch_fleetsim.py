# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""``bft.fleetsim`` against ``bluefog_tpu.fleetsim``, case by case as
``tests/test_fleetsim.py`` runs the JAX module, on the same seeded inputs.

The simulator is host numpy in both packages, so the repaired matrices,
summaries, events and aggregates are held bitwise to JAX's (the port's
``mesh``/``star``/``rrd`` edge dicts come from its generator matrices, in
the row-major order and with the weights of JAX's networkx dicts, checked
first), and the repair algebra also to the port's dense ``repaired_matrix``
within 1e-12, as the JAX tests hold theirs. Timings (``event_ms``,
``decision_ms``) are the only fields left out of the comparisons.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bluefog_tpu import fleetsim as jfs
from bluefog_tpu import health as jhealth
from bluefog_tpu.elastic.faults import Fault as JFault
from bluefog_tpu.elastic.faults import FaultPlan as JFaultPlan
from bluefog_tpu_torch import fleetsim, health
from bluefog_tpu_torch.elastic.faults import Fault, FaultPlan
from bluefog_tpu_torch.elastic.repair import repaired_matrix

ORACLE_TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = ("event_ms", "decision_ms", "worst_event_ms", "last_decision_ms")


def _dense(edges, n):
    w = np.zeros((n, n))
    for (i, j), v in edges.items():
        w[i, j] = v
    return w


def _untimed(obj):
    """``obj`` with the measured times dropped, recursively."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in TIMED}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _summaries_equal(a, b):
    assert _untimed(a.summary()) == _untimed(b.summary())
    assert _untimed(a.events) == _untimed(b.events)
    np.testing.assert_array_equal(a.topo.to_dense(), b.topo.to_dense())


@pytest.mark.parametrize("kind", ["mesh", "star", "rrd"])
@pytest.mark.parametrize("n", [4, 5, 8, 16])
def test_dense_generator_edges_are_jax_networkx_dicts(kind, n):
    """The port reads ``mesh``/``star``/``rrd`` from its matrices: the same
    keys, weights and dict order as JAX's networkx edge dicts."""
    got = fleetsim.base_edges(n, kind, seed=3)
    want = jfs.base_edges(n, kind, seed=3)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("kind", ["ring", "exp2", "mesh", "star", "rrd"])
@pytest.mark.parametrize("policy", ["average", "receiver", "push_sum"])
@pytest.mark.parametrize("seed", [0, 1])
def test_repair_algebra_matches_dense_oracle(kind, policy, seed):
    rng = np.random.RandomState(seed)
    for n in (4, 8, 16):
        edges = fleetsim.base_edges(n, kind, seed=3)
        w = _dense(edges, n)
        k = int(rng.randint(1, max(2, n // 2)))
        dead = sorted(rng.choice(n, size=k, replace=False).tolist())
        live = [r for r in range(n) if r not in dead]
        degr = {int(live[0]): 0.5} if seed == 1 else {}
        ft = fleetsim.FleetTopology(n, edges, policy)
        jt = jfs.FleetTopology(n, jfs.base_edges(n, kind, seed=3), policy)
        ft.kill(dead)
        jt.kill(dead)
        for r, f in degr.items():
            ft.degrade(r, f)
            jt.degrade(r, f)
        want = repaired_matrix(w, live, policy=policy, degraded=degr)
        got = ft.to_dense()
        np.testing.assert_allclose(got, want, atol=ORACLE_TOL)
        np.testing.assert_array_equal(got, jt.to_dense())
        for j in live:
            self_w, nbrs = ft.recv_weights(j)
            assert (self_w, nbrs) == jt.recv_weights(j)
            assert abs(self_w - want[j, j]) <= ORACLE_TOL
            for i in range(n):
                if i != j:
                    assert abs(nbrs.get(i, 0.0) - want[i, j]) <= ORACLE_TOL


def test_incremental_kills_match_batch_kill():
    n = 24
    edges = fleetsim.base_edges(n, "exp2")
    dead = [3, 7, 11, 20]
    live = [r for r in range(n) if r not in dead]
    for policy in ("average", "receiver", "push_sum"):
        batch = fleetsim.FleetTopology(n, edges, policy)
        batch.kill(dead)
        incr = fleetsim.FleetTopology(n, edges, policy)
        for r in dead:
            incr.kill([r])
        np.testing.assert_allclose(incr.to_dense(), batch.to_dense(), atol=0)
        want = repaired_matrix(_dense(edges, n), live, policy=policy)
        np.testing.assert_allclose(batch.to_dense(), want, atol=ORACLE_TOL)
        jt = jfs.FleetTopology(n, jfs.base_edges(n, "exp2"), policy)
        jt.kill(dead)
        np.testing.assert_array_equal(batch.to_dense(), jt.to_dense())


def test_revive_restores_base_weights():
    n = 16
    ft = fleetsim.FleetTopology(n, fleetsim.base_edges(n, "ring"), "receiver")
    base = ft.to_dense()
    ft.kill([2, 9])
    ft.revive(2)
    ft.revive(9)
    np.testing.assert_allclose(ft.to_dense(), base, atol=0)
    np.testing.assert_array_equal(base, jfs.FleetTopology(n, jfs.base_edges(n, "ring"),
                                                          "receiver").to_dense())


def test_average_policy_partition_unions_ring():
    n = 8
    edges = fleetsim.base_edges(n, "star")
    ft = fleetsim.FleetTopology(n, edges, "average")
    ft.kill([0])
    jt = jfs.FleetTopology(n, jfs.base_edges(n, "star"), "average")
    jt.kill([0])
    w = ft.to_dense()
    jw = jt.to_dense()
    assert ft.partitioned and jt.partitioned
    want = repaired_matrix(_dense(edges, n), ft.live_ranks(), policy="average")
    np.testing.assert_allclose(w, want, atol=ORACLE_TOL)
    np.testing.assert_array_equal(w, jw)
    rate, spec = ft.decay_info()
    jrate, jspec = jt.decay_info()
    assert rate is not None and 0.0 < rate < 1.0 and spec["converged"]
    assert abs(rate - jrate) <= ORACLE_TOL and spec["engine"] == jspec["engine"]


def test_churn_storm_n1024_zero_stale_dispatches():
    n = 1024
    plan = fleetsim.storm_plan(n, 0.10, step=5, seed=1)
    jplan = jfs.storm_plan(n, 0.10, step=5, seed=1)
    assert [(f.kind, f.rank, f.step) for f in plan.faults] == \
        [(f.kind, f.rank, f.step) for f in jplan.faults]
    killed = len(plan.faults)
    vf = fleetsim.VirtualFleet(n, topology="exp2", policy="receiver", plan=plan,
                               audit_edges=True, seed=1)
    jf = jfs.VirtualFleet(n, topology="exp2", policy="receiver", plan=jplan,
                          audit_edges=True, seed=1)
    vf.run(12)
    jf.run(12)
    s = vf.summary()
    assert s["stale_dispatches"] == 0
    assert s["live"] == n - killed == 922
    assert s["repairs"] == 1
    assert s["dead"] == killed
    assert "fleet_churn" in [a["kind"] for a in s["advisories"]]
    assert s["cache_misses"] == 2
    assert s["cache_hits"] == 12 - 2
    _summaries_equal(vf, jf)
    assert vf.live_token() == jf.live_token()


def test_cascading_repairs_each_event_recompiles():
    n, kills = 256, 10
    vf = fleetsim.VirtualFleet(n, topology="exp2", policy="receiver",
                               plan=fleetsim.cascade_plan(n, kills, 2, stride=1, seed=4),
                               audit_edges=True, seed=4)
    jf = jfs.VirtualFleet(n, topology="exp2", policy="receiver",
                          plan=jfs.cascade_plan(n, kills, 2, stride=1, seed=4),
                          audit_edges=True, seed=4)
    vf.run(kills + 5)
    jf.run(kills + 5)
    s = vf.summary()
    assert s["stale_dispatches"] == 0
    assert s["repairs"] == s["topo_version"] == kills
    assert s["cache_misses"] == kills + 1
    assert s["live"] == n - kills
    assert s["epoch"] == kills
    _summaries_equal(vf, jf)


def test_region_loss_repairs_and_aggregates():
    n = 128
    vf = fleetsim.VirtualFleet(n, topology="exp2", policy="receiver",
                               plan=fleetsim.region_plan(n, 0, 32, step=3), audit_edges=True)
    jf = jfs.VirtualFleet(n, topology="exp2", policy="receiver",
                          plan=jfs.region_plan(n, 0, 32, step=3), audit_edges=True)
    vf.run(8)
    jf.run(8)
    s = vf.summary()
    assert s["stale_dispatches"] == 0 and s["live"] == 96
    _summaries_equal(vf, jf)
    vals = np.zeros((n, 1))
    vals[:, 0] = np.arange(n, dtype=np.float64)
    rep = vf.aggregate(vals, rounds=40)
    assert rep["mean"][0] == pytest.approx(np.mean(np.arange(32, 128)), rel=1e-6)
    assert rep["residual"] < 1e-4
    assert rep == jf.aggregate(vals, rounds=40)


def test_rejoin_after_storm():
    n = 64
    vf = fleetsim.VirtualFleet(n, topology="ring", policy="receiver")
    jf = jfs.VirtualFleet(n, topology="ring", policy="receiver")
    for f in (vf, jf):
        f.run(2)
    base = vf.topo.to_dense()
    for f in (vf, jf):
        assert f.kill(5, step=2)
        f._repair([5], 2)
    assert 5 not in vf.topo.live_ranks()
    for f in (vf, jf):
        assert f.rejoin(5)
        f.run(2)
    assert vf.summary()["stale_dispatches"] == 0
    assert 5 in vf.topo.live_ranks()
    np.testing.assert_allclose(vf.topo.to_dense(), base, atol=0)
    _summaries_equal(vf, jf)


def test_live_token_changes_on_every_transition():
    vf = fleetsim.VirtualFleet(32, topology="ring")
    jf = jfs.VirtualFleet(32, topology="ring")
    t0 = vf.live_token()
    assert t0 == jf.live_token()
    vf.kill(3, step=0)
    jf.kill(3, step=0)
    t1 = vf.live_token()
    assert t1 != t0 and t1 == jf.live_token()
    vf.rejoin(3)
    jf.rejoin(3)
    t2 = vf.live_token()
    assert t2 != t0 and t2 != t1 and t2 == jf.live_token()
    assert t2[1] == t0[1] and t2[2] == t0[2]


def test_aggregate_matches_health_oracle():
    rng = np.random.RandomState(11)
    for kind in ("ring", "exp2"):
        n = 24
        vf = fleetsim.VirtualFleet(n, topology=kind, policy="receiver")
        jf = jfs.VirtualFleet(n, topology=kind, policy="receiver")
        dead = [1, 13]
        for f in (vf, jf):
            for r in dead:
                f.kill(r, step=0)
            f._repair(dead, 0)
        vals = rng.randn(n, 3)
        got = vf.aggregate(vals, rounds=6)
        want = health.fleet_aggregate_np(vf.topo.to_dense(), vals, 6, dead=dead)
        for key in ("mean", "min", "max"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-9)
        assert got["residual"] == pytest.approx(want["residual"], abs=1e-9)
        assert got["live"] == want["live"]
        assert got == jf.aggregate(vals, rounds=6)
        assert want == jhealth.fleet_aggregate_np(jf.topo.to_dense(), vals, 6, dead=dead)


def test_decision_probe_uses_sparse_engine_at_scale():
    n = 512
    vf = fleetsim.VirtualFleet(n, topology="exp2", policy="receiver",
                               plan=fleetsim.storm_plan(n, 0.05, step=1, seed=2),
                               audit_edges=False, seed=2)
    jf = jfs.VirtualFleet(n, topology="exp2", policy="receiver",
                          plan=jfs.storm_plan(n, 0.05, step=1, seed=2), audit_edges=False, seed=2)
    vf.run(4)
    jf.run(4)
    row = vf.decision_probe()
    jrow = jf.decision_probe()
    assert row["chosen"] in row["candidates"] and row["chosen"] == jrow["chosen"]
    assert row["decision_ms"] > 0.0
    for name, cand in row["candidates"].items():
        assert cand["spectral"]["engine"] == "sparse", (name, cand)
        assert 0.0 < cand["rate"] <= 1.0
        want = jrow["candidates"][name]
        assert abs(cand["rate"] - want["rate"]) <= ORACLE_TOL, name
        assert cand["rounds"] == want["rounds"]
    assert row["candidates"]["current"]["rate"] < row["candidates"]["ring"]["rate"]


def test_fleetsim_jsonl_dump(tmp_path, monkeypatch):
    path = tmp_path / "fleet.jsonl"
    monkeypatch.setenv(fleetsim.FLEETSIM_FILE_ENV, str(path))
    vf = fleetsim.VirtualFleet(64, topology="exp2", plan=fleetsim.storm_plan(64, 0.1, 2, 0),
                               audit_edges=True)
    vf.run(5)
    vf.decision_probe()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert {"fleetsim_repair", "fleetsim_advisory", "fleetsim_decision"} <= \
        {r["metric"] for r in rows}
    jpath = tmp_path / "jax.jsonl"
    monkeypatch.setenv(jfs.FLEETSIM_FILE_ENV, str(jpath))
    jf = jfs.VirtualFleet(64, topology="exp2", plan=jfs.storm_plan(64, 0.1, 2, 0),
                          audit_edges=True)
    jf.run(5)
    jrows = [json.loads(line) for line in jpath.read_text().splitlines()]
    assert _untimed(rows[:len(jrows)]) == _untimed(jrows)


def test_fleetsim_report_tool_reads_dump(tmp_path, monkeypatch):
    """``tools/fleetsim_report.py`` (no JAX import) rebuilds the storm
    timeline from the port's dump, as from JAX's."""
    reports = []
    for mod in (fleetsim, jfs):
        path = tmp_path / f"{mod.__name__}.jsonl"
        monkeypatch.setenv(mod.FLEETSIM_FILE_ENV, str(path))
        mod.VirtualFleet(64, topology="exp2", plan=mod.storm_plan(64, 0.1, step=2, seed=0),
                         audit_edges=True).run(5)
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "fleetsim_report.py"), "--dump",
             str(path), "--json"], capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        reports.append(json.loads(proc.stdout))
    report = reports[0]
    assert report["repairs"] and report["repairs"][0]["step"] == 2
    assert report["verdict"]["repair_events"] == 1
    assert _untimed(report) == _untimed(reports[1])


def test_fault_kinds_other_than_kill_become_suspect_advisories():
    vf = fleetsim.VirtualFleet(16, topology="ring", plan=FaultPlan(
        [Fault(kind="stall", rank=3, step=1, seconds=1.0)]))
    jf = jfs.VirtualFleet(16, topology="ring", plan=JFaultPlan(
        [JFault(kind="stall", rank=3, step=1, seconds=1.0)]))
    vf.run(3)
    jf.run(3)
    assert "fleet_suspect" in [a.kind for a in vf.advisories]
    assert vf.summary()["live"] == 16
    assert [a.to_json() for a in vf.advisories] == [a.to_json() for a in jf.advisories]


def test_degrade_fault_triggers_repair():
    n = 16
    vf = fleetsim.VirtualFleet(n, topology="ring", policy="receiver", audit_edges=True,
                               plan=FaultPlan([Fault(kind="degrade", rank=2, step=1,
                                                     factor=0.5)]))
    jf = jfs.VirtualFleet(n, topology="ring", policy="receiver", audit_edges=True,
                          plan=JFaultPlan([JFault(kind="degrade", rank=2, step=1, factor=0.5)]))
    vf.run(4)
    jf.run(4)
    s = vf.summary()
    assert s["stale_dispatches"] == 0 and s["repairs"] == 1
    want = repaired_matrix(_dense(fleetsim.base_edges(n, "ring"), n), list(range(n)),
                           policy="receiver", degraded={2: 0.5})
    np.testing.assert_allclose(vf.topo.to_dense(), want, atol=ORACLE_TOL)
    _summaries_equal(vf, jf)


@pytest.mark.parametrize("kind", ["ring", "exp2"])
def test_per_event_cost_does_not_scale_with_fleet_size(kind):
    touched = {}
    for n in (128, 1024):
        ft = fleetsim.FleetTopology(n, fleetsim.base_edges(n, kind), "receiver")
        touched[n] = ft.kill([n // 2])
        jt = jfs.FleetTopology(n, jfs.base_edges(n, kind), "receiver")
        assert touched[n] == jt.kill([n // 2])
    if kind == "ring":
        assert touched[128] == touched[1024]
    else:
        assert touched[1024] <= touched[128] + 8
