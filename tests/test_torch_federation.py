# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""``bft.federation`` against ``bluefog_tpu.federation``, case by case as
``tests/test_federation.py`` runs the JAX module, on the same inputs.

Host tier: layouts, gateways, the per-level edge dicts, the wire summary,
plans (perms, weights, ``link_class``) and the federated fleet are held
bitwise to JAX's; spectral rates within 1e-12. The compiler's ``link_class``
keys: every flat plan keeps its key and its cache hits and misses, the
``"dcn"`` class compiles its own entry.

Device tier (the port on the CPU, JAX on its 8-device CPU mesh with
``BLUEFOG_WIRE_KERNELS=0``): the federated optimizer on an ``[8, 1500]``
parameter, period 2, fp32/int8/int4/int4_ef over 4 steps, within the
tolerance of ``tests/test_torch_gossip.py`` (1e-6 of the largest value);
the key shapes, the flat pin, the per-leg counters equal JAX's, the EF
fallback, ``make_train_step`` bitwise ``step``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

import bluefog_tpu as bf
from bluefog_tpu import federation as jfed
from bluefog_tpu import fleetsim as jfs
from bluefog_tpu import logging_util as jlog
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu.elastic.faults import Fault as JFault
from bluefog_tpu.elastic.faults import FaultPlan as JFaultPlan
from bluefog_tpu.topology import placement as jplacement
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import federation as fed
from bluefog_tpu_torch import fleetsim, logging_util, metrics
from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.collective import ops as col_ops
from bluefog_tpu_torch.collective import plan as plan_mod
from bluefog_tpu_torch.elastic.faults import Fault, FaultPlan
from bluefog_tpu_torch.topology import placement

SIZE = 8
RATE_TOL = 1e-12
ENV = ("BLUEFOG_PODS", "BLUEFOG_DCN_PERIOD", "BLUEFOG_DCN_WIRE", "BLUEFOG_TORUS_DIMS",
       "BLUEFOG_METRICS", "BLUEFOG_PLAN_METHOD")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    fed.clear_fabric_cache()
    jfed.clear_fabric_cache()
    yield
    fed.clear_fabric_cache()
    jfed.clear_fabric_cache()


def _same_layout(spec, size):
    got, want = fed.parse_pods(spec, size), jfed.parse_pods(spec, size)
    assert (got.size, got.bounds, got.spec) == (want.size, want.bounds, want.spec)
    assert got.to_json() == want.to_json()
    return got


def _same_plan(got, want):
    assert got.perms == want.perms
    assert got.self_weights == want.self_weights
    assert [r.recv_weights for r in got.rounds] == [r.recv_weights for r in want.rounds]
    assert got.compile_info.link_class == want.compile_info.link_class


# -- pod spec parsing ---------------------------------------------------------


def test_parse_pods_count():
    layout = _same_layout("2", 16)
    assert layout.n_pods == 2
    assert list(layout.ranks(0)) == list(range(8))
    assert list(layout.ranks(1)) == list(range(8, 16))


def test_parse_pods_shape():
    layout = _same_layout("4x16", 64)
    assert layout.n_pods == 4
    assert [layout.pod_of(r) for r in (0, 17, 63)] == [0, 1, 3]


def test_parse_pods_ranges():
    layout = _same_layout("0-3,4-11,12-15", 16)
    assert layout.n_pods == 3 and len(layout.ranks(1)) == 8


@pytest.mark.parametrize("spec", ["3", "2x9", "1", "0-7", "0-8,8-15", "0-6,8-15",
                                  "8-15,0-7", "bogus", ""])
def test_parse_pods_rejects(spec):
    for mod in (fed, jfed):
        with pytest.raises(ValueError):
            mod.parse_pods(spec, 16)


def test_layout_from_env(monkeypatch):
    assert fed.layout_from_env(16) is None
    monkeypatch.setenv(fed.PODS_ENV, "2x8")
    layout = fed.layout_from_env(16)
    assert layout is not None and layout.bounds == jfed.layout_from_env(16).bounds


def test_dcn_wire_ef_falls_back(monkeypatch):
    monkeypatch.setenv(fed.DCN_WIRE_ENV, "int4_ef")
    logging_util._warned_once.discard("dcn-wire-ef")
    assert fed.dcn_wire() == jfed.dcn_wire() == "int4"
    assert "dcn-wire-ef" in logging_util._warned_once


def test_dcn_wire_exact(monkeypatch):
    monkeypatch.setenv(fed.DCN_WIRE_ENV, "exact")
    assert fed.dcn_wire() is None and jfed.dcn_wire() is None
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "0")
    for mod in (fed, jfed):
        with pytest.raises(ValueError):
            mod.dcn_period()


# -- gateways -----------------------------------------------------------------


def test_gateways_lowest_live_rank():
    layout = _same_layout("4x16", 64)
    assert list(layout.gateways()) == [0, 16, 32, 48]
    live = [r for r in range(64) if r not in (0, 1, 16)]
    assert list(fed.elect_gateways(layout, live)) == [2, 17, 32, 48] == \
        list(jfed.elect_gateways(jfed.parse_pods("4x16", 64), live))


def test_gateways_dead_pod_is_none():
    layout = _same_layout("4x16", 64)
    live = [r for r in range(64) if not 16 <= r < 32]
    assert list(layout.gateways(live)) == [0, None, 32, 48]


# -- per-level matrices -------------------------------------------------------


def _columns_sum_to_one(n, edges):
    col = np.zeros(n)
    for (_i, j), v in edges.items():
        col[j] += v
    np.testing.assert_allclose(col, 1.0, atol=1e-12)


def test_intra_edges_block_diagonal_normalized():
    layout = _same_layout("2x8", 16)
    edges = fed.intra_edges(layout, kind="exp2")
    _columns_sum_to_one(16, edges)
    for (i, j) in edges:
        assert layout.pod_of(i) == layout.pod_of(j), (i, j)
    jl = jfed.parse_pods("2x8", 16)
    assert list(edges.items()) == list(jfed.intra_edges(jl, kind="exp2").items())
    assert list(fed.federated_union_edges(layout).items()) == \
        list(jfed.federated_union_edges(jl).items())


def test_inter_edges_gateways_only_normalized():
    layout = _same_layout("4x16", 64)
    edges = fed.inter_edges(layout)
    _columns_sum_to_one(64, edges)
    gws = set(layout.gateways())
    for (i, j) in edges:
        if i != j:
            assert i in gws and j in gws, (i, j)
        elif j not in gws:
            assert edges[(i, j)] == 1.0
    assert list(edges.items()) == list(jfed.inter_edges(jfed.parse_pods("4x16", 64)).items())


# -- spectral composition -----------------------------------------------------


def test_composed_rate_matches_measured():
    layout = _same_layout("2x8", 16)
    jl = jfed.parse_pods("2x8", 16)
    period = 4
    predicted, info = fed.composed_rate(layout, period)
    jpredicted, jinfo = jfed.composed_rate(jl, period)
    assert info["dcn_period"] == period and info["engine"] == jinfo["engine"]
    assert abs(predicted - jpredicted) <= RATE_TOL
    seq = [(16, fed.intra_edges(layout))] * period + [(16, fed.inter_edges(layout))]
    measured = fed.simulate_consensus(seq, steps=64, comm_steps_per_cycle=period)
    assert abs(predicted - measured) <= 0.02, (predicted, measured)
    assert measured == jfed.simulate_consensus(seq, steps=64, comm_steps_per_cycle=period)


def _same_choice(got, want):
    assert (got["period"], got["met"], got["target_rate"]) == \
        (want["period"], want["met"], want["target_rate"])
    assert abs(got["predicted_rate"] - want["predicted_rate"]) <= RATE_TOL
    assert [r["period"] for r in got["table"]] == [r["period"] for r in want["table"]]
    for a, b in zip(got["table"], want["table"]):
        assert abs(a["rate"] - b["rate"]) <= 1e-8 and a["engine"] == b["engine"]


def test_choose_dcn_period_meets_target():
    out = fed.choose_dcn_period(_same_layout("2x8", 16), target_rate=0.98)
    assert out["met"] is True and out["predicted_rate"] <= 0.98
    assert not [row for row in out["table"]
                if row["period"] > out["period"] and row["rate"] <= 0.98], out["table"]
    _same_choice(out, jfed.choose_dcn_period(jfed.parse_pods("2x8", 16), target_rate=0.98))


def test_choose_dcn_period_unmeetable_discloses():
    out = fed.choose_dcn_period(_same_layout("2x8", 16), target_rate=0.5)
    assert out["met"] is False and out["period"] == 1
    _same_choice(out, jfed.choose_dcn_period(jfed.parse_pods("2x8", 16), target_rate=0.5))


# -- wire accounting ----------------------------------------------------------


@pytest.mark.parametrize("ici_wire", [None, "int8"])
def test_wire_summary_per_edge_dcn_accounting(ici_wire):
    layout = _same_layout("2x8", 16)
    ws = fed.wire_summary(layout, 1 << 16, itemsize=4, ici_wire=ici_wire,
                          dcn_wire_tier="int4", period=8)
    assert ws["dcn_wire_bytes_per_step"] == pytest.approx(ws["dcn_wire_bytes_per_event"] / 8)
    assert ws["flat_cross_pod_edges"] > 0
    assert ws["dcn_cut_ratio"] >= 8.0
    assert ws == jfed.wire_summary(jfed.parse_pods("2x8", 16), 1 << 16, itemsize=4,
                                   ici_wire=ici_wire, dcn_wire_tier="int4", period=8)


# -- plan lowering / link classes ---------------------------------------------


def test_intra_plan_link_class_ici():
    plan = fed.intra_plan(_same_layout("2x8", 16))
    assert plan.compile_info.link_class == "ici"
    _same_plan(plan, jfed.intra_plan(jfed.parse_pods("2x8", 16)))


def test_inter_plan_link_class_dcn():
    layout = _same_layout("2x8", 16)
    plan = fed.inter_plan(layout)
    assert plan.compile_info.link_class == "dcn"
    _same_plan(plan, jfed.inter_plan(jfed.parse_pods("2x8", 16)))
    live = [r for r in range(16) if r != 8]
    _same_plan(fed.inter_plan(layout, live), jfed.inter_plan(jfed.parse_pods("2x8", 16), live))


def test_link_class_keys_keep_flat_plans_and_compile_dcn_apart():
    """``"ici"`` keeps the pre-federation key (the same cached object, one
    miss then hits, as before); ``"dcn"`` compiles its own entry with its
    own miss, and a second ``"dcn"`` call hits it, as in JAX."""
    from bluefog_tpu.collective import compiler as jcompiler

    edges = [(i, (i + d) % 12) for i in range(12) for d in (1, 2, 4)]

    def counts():
        snap = metrics.snapshot()
        return tuple(snap.get(f"bluefog.plan_cache.{k}", {}).get("value", 0.0)
                     for k in ("hits", "misses"))

    compiler.clear_compile_cache()
    h0, m0 = counts()
    flat = compiler.compile_edges(edges, 12)
    assert counts() == (h0, m0 + 1)
    assert compiler.compile_edges(edges, 12, link_class="ici") is flat
    assert counts() == (h0 + 1, m0 + 1)
    assert flat.link_class == "ici" and len(compiler._COMPILE_CACHE) == 1
    key = next(iter(compiler._COMPILE_CACHE))
    assert len(key) == 5  # (canonical edges, size, method, payload, dims)
    dcn = compiler.compile_edges(edges, 12, link_class="dcn")
    assert dcn is not flat and dcn.link_class == "dcn" and dcn.perms == flat.perms
    assert counts() == (h0 + 1, m0 + 2)
    assert compiler.compile_edges(edges, 12, link_class="dcn") is dcn
    assert counts() == (h0 + 2, m0 + 2)
    assert sorted(len(k) for k in compiler._COMPILE_CACHE) == [5, 6]
    assert dcn.perms == jcompiler.compile_edges(edges, 12, link_class="dcn").perms
    w = np.zeros((12, 12))
    for i, j in edges:
        w[i, j] = 0.25
    np.fill_diagonal(w, 0.25)
    assert plan_mod.plan_from_matrix(w).compile_info is flat
    with pytest.raises(ValueError):
        compiler.compile_edges(edges, 12, link_class="tcp")


# -- fabric lifecycle ---------------------------------------------------------


def test_get_fabric_disabled_is_none():
    assert fed.enabled() is False and fed.get_fabric(16) is None


def test_get_fabric_env_signature_cache(monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2x8")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "4")
    fab = fed.get_fabric(16)
    assert fab is not None and fab.period == 4
    assert fed.get_fabric(16) is fab
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "8")
    fab2 = fed.get_fabric(16)
    assert fab2 is not fab and fab2.period == 8
    jfab = jfed.get_fabric(16)
    _same_plan(fab2.intra, jfab.intra)
    _same_plan(fab2.inter, jfab.inter)
    assert (fab2.period, fab2.wire, fab2.kind) == (jfab.period, jfab.wire, jfab.kind)


def test_fabric_dcn_step_cadence(monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "4")
    fab = fed.get_fabric(16)
    assert [fab.dcn_step(c) for c in range(6)] == [True, False, False, False, True, False]
    assert [fab.dcn_step(c) for c in range(6)] == [jfed.get_fabric(16).dcn_step(c)
                                                   for c in range(6)]


def test_fabric_to_json(monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2x8")
    doc = fed.get_fabric(16).to_json()
    want = jfed.get_fabric(16).to_json()
    assert doc["layout"]["n_pods"] == 2 and doc["gateways"] == [0, 8]
    assert 0.0 < doc["predicted_rate"] < 1.0
    assert abs(doc.pop("predicted_rate") - want.pop("predicted_rate")) <= RATE_TOL
    assert doc == want


# -- placement route/congestion under multi-pod layouts -----------------------


def test_gateway_routes_never_relay_through_foreign_pod():
    layout = _same_layout("4x16", 64)
    gws = layout.gateways()
    for s, d in zip(gws, gws[1:] + gws[:1]):
        chain = placement.route_ranks(s, d, 64)
        assert chain == jplacement.route_ranks(s, d, 64)
        for m in chain:
            assert layout.pod_of(m) in {layout.pod_of(s), layout.pod_of(d)}, (s, d, m)


def test_inter_ring_congestion_one():
    gws = _same_layout("4x16", 64).gateways()
    perm = list(zip(gws, gws[1:] + gws[:1]))
    assert placement.perm_congestion(perm, 64) == 1 == jplacement.perm_congestion(perm, 64)


def test_intra_routes_stay_in_pod():
    layout = _same_layout("4x16", 64)
    for (i, j) in fed.intra_edges(layout, kind="exp2"):
        if i != j:
            for m in placement.route_ranks(i, j, 64):
                assert layout.pod_of(m) == layout.pod_of(i), (i, j, m)


def test_pods_misaligned_with_torus_warns(monkeypatch):
    monkeypatch.setenv("BLUEFOG_TORUS_DIMS", "4,4")
    key = "pods-torus-misaligned-16"
    logging_util._warned_once.discard(key)
    jlog._warned_once.discard(key)
    fed.parse_pods("0-5,6-15", 16)
    jfed.parse_pods("0-5,6-15", 16)
    assert key in logging_util._warned_once and key in jlog._warned_once


def test_torus_dims_product_mismatch_warns_and_undeclares(monkeypatch):
    monkeypatch.setenv("BLUEFOG_TORUS_DIMS", "4,8")
    key = "torus-dims-mismatch-16"
    logging_util._warned_once.discard(key)
    assert placement.declared_torus_dims(16) is None
    assert key in logging_util._warned_once
    n = len(logging_util._warned_once)
    assert placement.declared_torus_dims(16) is None
    assert len(logging_util._warned_once) == n
    assert jplacement.declared_torus_dims(16) is None


def test_torus_dims_matching_product_accepted(monkeypatch):
    monkeypatch.setenv("BLUEFOG_TORUS_DIMS", "4,4")
    assert placement.declared_torus_dims(16) == (4, 4) == jplacement.declared_torus_dims(16)


# -- loss classification / federated fleetsim ---------------------------------


def test_classify_loss_classes():
    layout = _same_layout("4x16", 64)
    jl = jfed.parse_pods("4x16", 64)
    cases = [([], None), ([3], None), (list(range(16, 32)), "layout"),
             (list(range(8, 16)), None), (list(range(0, 64, 9)), None)]
    got = [fleetsim.classify_loss(r, 64, layout if lay else None) for r, lay in cases]
    assert got == [jfs.classify_loss(r, 64, jl if lay else None) for r, lay in cases]
    assert [g["loss_class"] for g in got] == ["none", "churn", "pod_loss", "region_loss",
                                              "storm"]
    assert got[2]["pods_lost"] == [1] and got[3]["region"] == [8, 15]


def _fleet_pair(spec, size, plan, jplan):
    ff = fed.FederatedFleet(fed.parse_pods(spec, size), plan=plan, audit_edges=True, seed=0)
    jf = jfed.FederatedFleet(jfed.parse_pods(spec, size), plan=jplan, audit_edges=True, seed=0)
    return ff, jf


def _untimed(events):
    return [{k: v for k, v in e.items() if k != "event_ms"} for e in events]


def test_federated_fleet_pod_loss_one_event():
    ff, jf = _fleet_pair("4x16", 64, fleetsim.region_plan(64, 16, 32, step=3),
                         jfs.region_plan(64, 16, 32, step=3))
    ff.run(8)
    jf.run(8)
    s = ff.summary()
    assert s["repairs"] == 1 and s["stale_dispatches"] == 0 and s["live"] == 48
    repairs = [e for e in ff.fleet.events if e["metric"] == "fleetsim_repair"]
    assert len(repairs) == 1
    assert repairs[0]["loss_class"] == "pod_loss" and repairs[0]["pods_lost"] == [1]
    assert repairs[0]["gateway_change"] is True
    assert s["federation"]["gateways"] == [0, 32, 48]
    assert _untimed(ff.fleet.events) == _untimed(jf.fleet.events)
    np.testing.assert_array_equal(ff.fleet.topo.to_dense(), jf.fleet.topo.to_dense())


def test_federated_fleet_gateway_kill_reelects():
    ff, jf = _fleet_pair("4x16", 64, FaultPlan([Fault(kind="kill", rank=16, step=2)]),
                         JFaultPlan([JFault(kind="kill", rank=16, step=2)]))
    ff.run(5)
    jf.run(5)
    s = ff.summary()
    assert s["stale_dispatches"] == 0
    assert s["federation"]["gateways"] == [0, 17, 32, 48] == jf.summary()["federation"][
        "gateways"]
    np.testing.assert_array_equal(ff.fleet.topo.to_dense(), jf.fleet.topo.to_dense())


# -- optimizer dispatch (the port on the CPU, JAX on its CPU mesh) ------------


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield bft.get_context()
    bf.shutdown()
    bft.shutdown()


def _params(fill):
    return {"w": torch.stack([torch.full((16,), float(fill(r))) for r in range(SIZE)])}


def test_flat_key_bitwise_pin(contexts):
    """``BLUEFOG_PODS`` unset: the plain ``("na", ...)`` key, the flat
    plan's bits, no federation marker."""
    ctx = contexts
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    d = opt._resolve_dispatch(ctx, _params(lambda r: r), True)
    plan = col_ops._resolve_plan(ctx, None, None, None, True)
    assert d.key == ("na", plan.perms, 1, plan.compile_info.inject)
    assert "fed" not in d.key and plan.compile_info.link_class == "ici"
    assert not any(k[0] == "fed" for k in [d.key])


def test_fed_key_shapes(contexts, monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "4")
    ctx = contexts
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    params = _params(lambda r: r)
    d = opt._resolve_dispatch(ctx, params, True)
    fab = fed.get_fabric(SIZE)
    assert d.key[:3] == ("fed", "dcn", None) and d.key[6] == "int4" and len(d.key) == 10
    assert d.key[3] == fab.intra.perms and d.key[7] == fab.inter.perms
    assert d.key[4] == d.key[8] == 1
    opt._comm_count = 1
    d2 = opt._resolve_dispatch(ctx, params, True)
    assert d2.key[:3] == ("fed", "ici", None) and len(d2.key) == 6
    assert opt._last_plan is fab.intra and opt._last_plan.compile_info.link_class == "ici"
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.05))
    jkey = jopt._gossip_key_and_fn(bf.get_context())[0]
    assert jkey[:3] == d.key[:3] and jkey[3] == d.key[3] and jkey[6:8] == d.key[6:8]


def _fed_run(wire, steps=4, make_step=False):
    rng = np.random.RandomState(0)
    x = (rng.randn(SIZE, 1500) * 5).astype(np.float32)
    gs = [rng.randn(SIZE, 1500).astype(np.float32) for _ in range(steps)]
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
    jopt.compression = wire
    jp = {"w": bf.worker_values(list(x))}
    js = jopt.init(jp)
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    topt.compression = wire
    tp = {"w": torch.from_numpy(x.copy())}
    ts = topt.init(tp)
    keys = []
    for k in range(steps):
        jp, js = jopt.step(jp, js, {"w": jnp.asarray(gs[k])})
        keys.append(topt._resolve_dispatch(bft.get_context(), tp, True).key[:2])
        topt.step(tp, ts, {"w": torch.from_numpy(gs[k])})
    return tp["w"].numpy(), np.asarray(jp["w"]), keys


@pytest.mark.parametrize("wire", [None, "int8", "int4", "int4_ef"])
def test_fed_optimizer_matches_jax(contexts, monkeypatch, wire):
    """ATC sgd(0.1) under ``BLUEFOG_PODS=2``, ``BLUEFOG_DCN_PERIOD=2``
    (DCN wire int4) against JAX over 4 steps: DCN, ICI, DCN, ICI."""
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "2")
    got, want, keys = _fed_run(wire)
    assert keys == [("fed", "dcn"), ("fed", "ici")] * 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_fed_fallback_tier_is_bitwise_its_base(contexts, monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "2")
    a, _, _ = _fed_run("int4")
    b, _, _ = _fed_run("int4_ef")
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("wire", [None, "int8"])
def test_fed_train_step_is_bitwise_step(contexts, monkeypatch, wire):
    """``make_train_step`` runs the same federated combine as ``step``."""
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "2")
    rng = np.random.RandomState(3)
    x = rng.randn(SIZE, 600).astype(np.float32)
    t = rng.randn(SIZE, 600).astype(np.float32)
    outs = []
    for fused in (False, True):
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
        opt.compression = wire
        p = {"w": torch.from_numpy(x.copy())}
        s = opt.init(p)
        loss = lambda q, tt: ((q["w"] - tt) ** 2).sum()  # noqa: E731
        step = opt.make_train_step(loss)
        for _ in range(3):
            if fused:
                step(p, s, torch.from_numpy(t))
            else:
                w = p["w"].detach().clone().requires_grad_(True)
                g = torch.autograd.grad(((w - torch.from_numpy(t)) ** 2).sum(), w)[0]
                opt.step(p, s, {"w": g})
        outs.append(p["w"].detach().numpy().copy())
    np.testing.assert_array_equal(outs[0].view(np.uint32), outs[1].view(np.uint32))


def test_fed_dispatch_preserves_mean_and_mixes(contexts, monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "2")
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    params = _params(lambda r: r)
    state = opt.init(params)
    step = bft.make_train_step(opt, lambda p, b: (p["w"] ** 2).sum() * 0.0)
    w0 = params["w"].numpy().copy()
    spread0 = float(w0.mean(1).max() - w0.mean(1).min())
    batch = torch.zeros(SIZE, 1)
    for _ in range(12):
        params, state, _loss = step(params, state, batch)
    w = params["w"].numpy()
    assert np.isclose(float(w.mean()), (SIZE - 1) / 2.0, atol=1e-4)
    assert float(w.mean(1).max() - w.mean(1).min()) < 0.35 * spread0
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.05))
    jp = {"w": bf.worker_values(lambda r: jnp.full((16,), float(r)))}
    js = jopt.init(jp)
    jstep = bf.make_train_step(jopt, lambda p, b: jnp.sum(p["w"] ** 2) * 0.0)
    for _ in range(12):
        jp, js, _ = jstep(jp, js, None)
    np.testing.assert_allclose(w, np.asarray(jp["w"]), rtol=0, atol=1e-6 * (SIZE - 1))


def test_fed_counters_reconcile(contexts, monkeypatch):
    """The per-leg counters, the total, and both equal to JAX's over the
    same 8 steps at period 4 (2 DCN events)."""
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "4")
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    names = ("bluefog.federation.ici_wire_bytes", "bluefog.federation.dcn_wire_bytes",
             "bluefog.wire_bytes")
    deltas = []
    for mod, run in ((metrics, "port"), (jmetrics, "jax")):
        base = mod.snapshot()
        if run == "port":
            opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
            params = {"w": torch.stack([torch.full((64,), float(r)) for r in range(SIZE)])}
            state = opt.init(params)
            step = bft.make_train_step(opt, lambda p, b: (p["w"] ** 2).sum() * 0.0)
            for _ in range(8):
                params, state, _ = step(params, state, torch.zeros(SIZE, 1))
        else:
            opt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.05))
            params = {"w": bf.worker_values(lambda r: jnp.full((64,), float(r)))}
            state = opt.init(params)
            step = bf.make_train_step(opt, lambda p, b: jnp.sum(p["w"] ** 2) * 0.0)
            for _ in range(8):
                params, state, _ = step(params, state, None)
        snap = mod.snapshot()
        deltas.append([snap.get(n, {}).get("value", 0.0) - base.get(n, {}).get("value", 0.0)
                       for n in names])
    ici, dcn, total = deltas[0]
    assert ici > 0 and dcn > 0 and total == ici + dcn and dcn < ici
    assert deltas[0] == deltas[1]
    layout = fed.get_fabric(SIZE).layout
    ws = fed.wire_summary(layout, 64, period=4)
    assert ici == 8 * ws["ici_wire_bytes_per_step"]


def test_fed_ef_wire_falls_back_memoryless(contexts, monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2")
    logging_util._warned_once.discard("fed-ef-wire")
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    opt.compression = "int8_ef"
    d = opt._resolve_dispatch(contexts, _params(lambda r: 0.0), True)
    assert d.key[2] == "int8" and d.ef is False
    assert "fed-ef-wire" in logging_util._warned_once
    assert opt._ef is None or opt._ef == []


def test_flat_run_after_fed_env_removed(contexts, monkeypatch):
    monkeypatch.setenv(fed.PODS_ENV, "2")
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    params = _params(lambda r: r)
    assert opt._resolve_dispatch(contexts, params, True).key[0] == "fed"
    monkeypatch.delenv(fed.PODS_ENV)
    assert opt._resolve_dispatch(contexts, params, True).key[0] == "na"


def test_fed_delayed_mix_matches_jax(contexts, monkeypatch):
    """``delayed=True`` under federation: the stale mix runs the two-level
    combine on the buffered payload with the intra leg's self weight on the
    fresh value, as JAX's ``_self_weight_fn`` gives it (fp32, 4 steps)."""
    monkeypatch.setenv(fed.PODS_ENV, "2")
    monkeypatch.setenv(fed.DCN_PERIOD_ENV, "2")
    monkeypatch.setenv(fed.DCN_WIRE_ENV, "exact")
    rng = np.random.RandomState(7)
    x = rng.randn(SIZE, 512).astype(np.float32)
    t = rng.randn(SIZE, 512).astype(np.float32)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
    jp = {"w": bf.worker_values(list(x))}
    js = jopt.init(jp)
    jstep = bf.make_train_step(jopt, lambda p, y: jnp.sum((p["w"] - y) ** 2), delayed=True)
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    tp = {"w": torch.from_numpy(x.copy())}
    ts = topt.init(tp)
    tstep = bft.make_train_step(topt, lambda p, y: ((p["w"] - y) ** 2).sum(), delayed=True)
    for _ in range(4):
        jp, js, _ = jstep(jp, js, bf.worker_values(list(t)))
        tstep(tp, ts, torch.from_numpy(t))
    want = np.asarray(jp["w"])
    np.testing.assert_allclose(tp["w"].detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
