# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's elastic gossip (``bft.elastic``) against the JAX package's
``bf.elastic``, mirroring ``tests/test_elastic.py``: the fault grammar, the
membership, the repaired matrices and schedules (bitwise JAX's), the
live-token plan key, the session's checks, stalls and suspects, and the
kill trajectories held to the numpy survivor oracle and to JAX's own run.

Tolerances. The port's exact combine is ``y = s * x`` then ``y = y + w_r *
x_{src_r}`` round after round, and its SGD update ``p + (-lr) * g``, each a
separate rounding on the CPU, so the fp32 trajectories are held BITWISE to
the numpy replay (which the JAX package matches only up to an FMA
calibration and a few ulps after the repair). Against JAX's trajectory the
fp32 runs are held to 1e-5 absolute (JAX's own oracle envelope); the int8
runs to the survivor-consensus contract JAX's test pins, and to JAX's
trajectory within 2e-2 absolute (the JAX test's consensus tolerance: XLA
contracts some accumulates into FMAs the port does not, which can move a
value across an int8 rounding boundary).
"""

import time

import numpy as np
import networkx as nx
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import topology as jtu
from bluefog_tpu.collective.plan import schedule_from_dynamic as jschedule_from_dynamic
from bluefog_tpu.elastic import repair as jrepair
from bluefog_tpu_torch import metrics, watchdog
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch import windows as win_mod
from bluefog_tpu_torch.collective.plan import schedule_from_dynamic
from bluefog_tpu_torch.elastic import (
    FAULT_PLAN_ENV,
    Fault,
    FaultPlan,
    Membership,
    RankState,
    consensus_restore,
    parse_fault_plan,
    repair_schedule,
    repaired_matrix,
    repaired_topology,
    survivor_consensus,
)
from bluefog_tpu_torch.elastic import repair as trepair

SIZE = 8


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.delenv(FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv("BLUEFOG_LIVENESS_TIMEOUT", raising=False)
    metrics.reset()
    jmetrics.reset()
    yield
    bft.elastic.stop()
    bf.elastic.stop()
    if bft.is_initialized():
        bft.shutdown()
    metrics.reset()
    jmetrics.reset()


def _tinit(topology=None):
    bft.init(device="cpu")
    if topology is not None:
        bft.set_topology(topology(SIZE))
    return bft.get_context()


def _jinit(cpu_devices, topology=None):
    bf.init(devices=cpu_devices[:SIZE])
    if topology is not None:
        bf.set_topology(topology(SIZE))
    return bf.get_context()


def _fields(f):
    return (f.kind, f.rank, f.step, f.seconds, f.factor, f.peer, f.hold_steps)


# -- the fault grammar, a copy of the JAX one ------------------------------------

PLANS = [
    "kill:rank=3,step=5; stall:rank=2,step=10,seconds=120 ;degrade:rank=1,step=4,factor=0.25;",
    "slow:rank=5,step=0,factor=10; slow:rank=2,step=4,factor=3,steps=6",
    "stall:rank=2,step=10,steps=6,peer=3; degrade:rank=1,step=4,factor=0.5,peer=0",
    "oom:rank=3,step=12",
    "",
]


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_grammar_roundtrip_equals_jax(text):
    from bluefog_tpu.elastic import parse_fault_plan as jparse

    got = parse_fault_plan(text)
    want = jparse(text)
    assert [_fields(f) for f in got.faults] == [_fields(f) for f in want.faults]
    for step in range(13):
        assert [_fields(f) for f in got.due(step)] == [_fields(f) for f in want.due(step)]


def test_fault_plan_grammar_fields():
    plan = parse_fault_plan(PLANS[0])
    assert [f.kind for f in plan.faults] == ["degrade", "kill", "stall"]
    assert (plan.due(5)[0].rank, plan.due(5)[0].step) == (3, 5)
    assert plan.due(10)[0].seconds == 120.0
    assert plan.due(4)[0].factor == 0.25
    assert parse_fault_plan("").faults == () and parse_fault_plan(None).faults == ()
    bounded = parse_fault_plan(PLANS[1]).due(4)[0]
    assert (bounded.rank, bounded.factor, bounded.hold_steps) == (2, 3.0, 6)


@pytest.mark.parametrize("bad", [
    "explode:rank=1,step=2",
    "kill:rank=1",
    "kill:step=1",
    "kill:rank=1,step=2,blast=3",
    "kill:rank=1 step=2",
    "degrade:rank=1,step=2,factor=0",
    "degrade:rank=1,step=2,factor=1.5",
    "stall:rank=1,step=2,seconds=-1",
    "kill:rank=1,step=-3",
    "slow:rank=1,step=0,factor=0.5",
    "slow:rank=1,step=0,factor=2,peer=3",
    "slow:rank=1,step=0,factor=2,seconds=5",
    "oom:rank=1,step=0,factor=2",
    "kill:rank=1,step=0,steps=3",
])
def test_fault_plan_grammar_rejects_as_jax(bad):
    from bluefog_tpu.elastic import parse_fault_plan as jparse

    with pytest.raises(ValueError):
        jparse(bad)
    with pytest.raises(ValueError):
        parse_fault_plan(bad)


def test_fault_plan_env_and_validate(monkeypatch):
    monkeypatch.setenv(FAULT_PLAN_ENV, "kill:rank=9,step=0")
    plan = FaultPlan.from_env()
    assert len(plan) == 1 and FAULT_PLAN_ENV == "BLUEFOG_FAULT_PLAN"
    with pytest.raises(ValueError):
        plan.validate(world_size=8)
    plan.validate(world_size=16)
    with pytest.raises(ValueError):
        Fault(kind="kill", rank=0, step=-1)


# -- membership -------------------------------------------------------------------


def test_membership_transitions_and_epoch():
    m = Membership(4)
    assert m.live_ranks() == (0, 1, 2, 3)
    e0 = m.epoch
    assert m.mark_suspect(2, "deadline", step=7)
    assert m.state(2) is RankState.SUSPECT and m.is_live(2)
    assert m.mark_dead(2, "killed", step=8)
    assert not m.mark_dead(2)
    assert m.live_ranks() == (0, 1, 3) and m.dead_ranks() == (2,)
    assert not m.mark_suspect(2)
    assert m.revive(2, step=20)
    assert m.live_ranks() == (0, 1, 2, 3) and m.epoch > e0
    t0 = m.token()
    m.mark_dead(0)
    assert m.token() != t0
    with pytest.raises(ValueError):
        m.mark_dead(17)
    with pytest.raises(ValueError):
        m.mark_degraded(1, 0.0)
    assert m.mark_degraded(1, 0.5) and m.degraded() == {1: 0.5}
    assert not m.mark_degraded(1, 0.5)


def test_membership_epochs_and_history_equal_jax():
    from bluefog_tpu.elastic import Membership as JMembership

    ops = [("mark_suspect", 2, "deadline", 1), ("mark_dead", 2, "killed", 2),
           ("mark_dead", 2, "killed", 3), ("mark_degraded", 5, 0.5, 3),
           ("mark_dead", 5, "killed", 4), ("mark_suspect", 5, "late", 5),
           ("revive", 2, 6), ("mark_degraded", 1, 0.25, 7), ("revive", 5, 8)]
    got, want = Membership(SIZE), JMembership(SIZE)
    for op in ops:
        a = getattr(got, op[0])(*op[1:])
        b = getattr(want, op[0])(*op[1:])
        assert a == b, op
        assert got.token() == want.token() and got.epoch == want.epoch
    assert got.history == want.history
    assert got.degraded() == want.degraded()
    assert [got.state(r).value for r in range(SIZE)] == [want.state(r).value
                                                          for r in range(SIZE)]


# -- repaired matrices and topologies, bitwise JAX's ----------------------------------

GENERATORS = {
    "exponential": (tu.ExponentialGraph, jtu.ExponentialGraph),
    "exp2": (tu.ExponentialTwoGraph, jtu.ExponentialTwoGraph),
    "symexp": (tu.SymmetricExponentialGraph, jtu.SymmetricExponentialGraph),
    "mesh": (tu.MeshGrid2DGraph, jtu.MeshGrid2DGraph),
    "star": (tu.StarGraph, jtu.StarGraph),
    "ring": (tu.RingGraph, jtu.RingGraph),
    "ring1": (lambda n: tu.RingGraph(n, connect_style=1),
              lambda n: jtu.RingGraph(n, connect_style=1)),
    "full": (tu.FullyConnectedGraph, jtu.FullyConnectedGraph),
}


def _same_bits(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.uint64), b.view(np.uint64))


@pytest.mark.parametrize("policy", ["average", "receiver", "push_sum"])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_repaired_topology_bitwise_jax_every_single_rank_loss(name, policy):
    """Every generator, every single dead rank: the port's repaired matrix
    is bitwise ``nx.to_numpy_array`` of JAX's repaired graph (the zero
    entries ``from_numpy_array`` drops and the node order included), and
    keeps the stochasticity its policy promises."""
    tgen, jgen = GENERATORS[name]
    w_t, g_j = tgen(SIZE), jgen(SIZE)
    assert _same_bits(w_t, nx.to_numpy_array(g_j))
    for dead in range(SIZE):
        live = [r for r in range(SIZE) if r != dead]
        got = repaired_topology(w_t, live, policy=policy)
        want = nx.to_numpy_array(jrepair.repaired_topology(g_j, live, policy=policy))
        assert _same_bits(got, want), (name, policy, dead)
        assert _same_bits(repaired_matrix(w_t, live, policy), jrepair.repaired_matrix(
            nx.to_numpy_array(g_j), live, policy))
        assert got[dead, dead] == 1.0 and np.count_nonzero(got[dead]) == 1
        assert np.count_nonzero(got[:, dead]) == 1
        if policy in ("average", "receiver"):
            np.testing.assert_allclose(trepair.receiver_sums(got, live), 1.0, atol=1e-12)
        if policy in ("average", "push_sum"):
            np.testing.assert_allclose(trepair.sender_sums(got, live), 1.0, atol=1e-12)


@pytest.mark.parametrize("policy", ["average", "receiver", "push_sum"])
@pytest.mark.parametrize("dead", [(0, 1), (2, 6), (1, 3, 5, 7), (0, 2, 4, 5, 6, 7)])
def test_repaired_matrix_multi_loss_and_degrade_bitwise_jax(dead, policy):
    """Several dead ranks at once, with and without a degraded rank."""
    for tgen, jgen in GENERATORS.values():
        w_t, w_j = tgen(SIZE), nx.to_numpy_array(jgen(SIZE))
        live = [r for r in range(SIZE) if r not in dead]
        for degraded in (None, {live[0]: 0.25}, {live[-1]: 0.5, dead[0]: 0.3}):
            got = repaired_matrix(w_t, live, policy, degraded)
            assert _same_bits(got, jrepair.repaired_matrix(w_j, live, policy, degraded))


def test_star_centre_death_falls_back_to_the_survivor_ring():
    w = tu.StarGraph(SIZE, center_rank=0)
    live = list(range(1, SIZE))
    got = repaired_matrix(w, live, "average")
    assert _same_bits(got, jrepair.repaired_matrix(
        nx.to_numpy_array(jtu.StarGraph(SIZE, center_rank=0)), live, "average"))
    assert trepair._survivor_components(got, live) == 1
    # without the fallback the survivors would be SIZE - 1 components
    adj = (w + w.T != 0).astype(float)
    np.fill_diagonal(adj, 0)
    assert trepair._survivor_components(adj, live) == SIZE - 1
    assert nx.is_connected(nx.from_numpy_array(got[np.ix_(live, live)]))
    np.testing.assert_allclose(trepair.receiver_sums(got, live), 1.0)
    np.testing.assert_allclose(trepair.sender_sums(got, live), 1.0)


def test_degrade_scales_edges_and_keeps_stochasticity():
    w = tu.RingGraph(SIZE)
    live = list(range(SIZE))
    healthy = repaired_matrix(w, live, "average")
    degraded = repaired_matrix(w, live, "average", degraded={2: 0.25})
    for j in (1, 3):
        assert degraded[2, j] == pytest.approx(healthy[2, j] * 0.25)
        assert degraded[j, 2] == pytest.approx(healthy[j, 2] * 0.25)
    np.testing.assert_allclose(trepair.receiver_sums(degraded, live), 1.0)
    np.testing.assert_allclose(trepair.sender_sums(degraded, live), 1.0)
    np.testing.assert_allclose(degraded, degraded.T)


@pytest.mark.parametrize("name", ["ring", "exp2", "mesh", "star"])
def test_average_repair_fixed_point_is_survivor_mean(name):
    w = GENERATORS[name][0](SIZE)
    x = np.random.RandomState(0).randn(SIZE, 3)
    for dead in (0, 3, SIZE - 1):
        live = [r for r in range(SIZE) if r != dead]
        w2 = repaired_matrix(w, live, "average")
        y = x.copy()
        for _ in range(300):
            y = w2.T @ y
        for r in live:
            np.testing.assert_allclose(y[r], survivor_consensus(x, live), atol=1e-9)
        np.testing.assert_allclose(y[dead], x[dead])


def test_repair_rejects_bad_inputs():
    w = tu.RingGraph(4)
    for live, policy in (([], "average"), ([0, 9], "average"), ([0, 1], "nonsense")):
        with pytest.raises(ValueError):
            repaired_matrix(w, live, policy)
    assert repaired_matrix(w, [2], "average")[2, 2] == 1.0


# -- dynamic one-peer schedules ----------------------------------------------------------


@pytest.mark.parametrize("name", ["exp2", "exponential", "ring1"])
@pytest.mark.parametrize("dead", [0, 5])
def test_repair_schedule_one_peer_equals_jax(name, dead):
    """The repaired one-peer schedule keeps its period, skips the dead
    rank, stays receiver-stochastic, and every plan equals JAX's."""
    tgen, jgen = GENERATORS[name]
    w_t, g_j = tgen(SIZE), jgen(SIZE)
    sched = schedule_from_dynamic(SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(w_t, r))
    jsched = jschedule_from_dynamic(
        SIZE, lambda r: jtu.GetDynamicOnePeerSendRecvRanks(g_j, r))
    live = [r for r in range(SIZE) if r != dead]
    rep = repair_schedule(sched, live, policy="receiver")
    jrep = jrepair.repair_schedule(jsched, live, policy="receiver")
    assert rep.period == sched.period == jrep.period
    for p_old, p, jp in zip(sched.plans, rep.plans, jrep.plans):
        assert p.perms == tuple(tuple(tuple(e) for e in perm) for perm in jp.perms)
        assert p.self_weights == jp.self_weights
        assert [r.recv_weights for r in p.rounds] == [r.recv_weights for r in jp.rounds]
        edges = {(s, d) for perm in p.perms for s, d in perm}
        assert all(dead not in e for e in edges)
        assert edges == {(s, d) for perm in p_old.perms for s, d in perm if dead not in (s, d)}
        np.testing.assert_allclose(trepair.receiver_sums(p.weight_matrix(), live), 1.0,
                                   atol=1e-12)


# -- the live token in the plan key ---------------------------------------------------


def test_static_plan_key_carries_the_live_token():
    ctx = _tinit(tu.ExponentialTwoGraph)
    assert ctx.live_token() is None
    p1 = ctx.static_plan()
    assert ctx.static_plan() is p1 and ctx.plan_keys[-1][-1] is None
    session = bft.elastic.start()
    tok = ctx.live_token()
    assert tok == (0, tuple(range(SIZE)))
    p2 = ctx.static_plan()
    assert p2 is not p1 and ctx.plan_keys[-1][-1] == tok
    session.membership.mark_dead(3, "test")
    assert ctx.live_token() != tok
    p3 = ctx.static_plan()
    assert p3 is not p2 and ctx.plan_keys[-1][-1] == (1, (0, 1, 2, 4, 5, 6, 7))
    bft.elastic.stop()
    assert ctx.live_token() is None and ctx.elastic_membership is None
    assert ctx.static_plan() is not p3


def test_flight_notes_plans_with_the_live_token():
    from bluefog_tpu_torch import flight

    ctx = _tinit(tu.RingGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=0)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    session.before_dispatch(opt)
    ctx.static_plan()
    plans = flight._build_dump("test")["comm_plans"]
    assert plans[-1]["live"] == {"epoch": 1, "ranks": [0, 1, 3, 4, 5, 6, 7]}
    assert all(2 not in e for rnd in plans[-1]["rounds"] for e in rnd)


# -- session mechanics --------------------------------------------------------------------


def test_session_exclusive_and_inject_validation():
    _tinit()
    session = bft.elastic.start()
    assert bft.elastic.active_session() is session
    with pytest.raises(RuntimeError):
        bft.elastic.start()
    with pytest.raises(ValueError):
        session.inject("kill", rank=99, step=0)
    with pytest.raises(ValueError):
        session.inject("degrade", rank=1, step=0, factor=0.5, peer=SIZE)
    with pytest.raises(ValueError):
        bft.elastic.inject("explode", rank=0, step=0)
    with pytest.raises(ValueError):
        session.inject("slow", rank=0, step=0, factor=0.5)
    bft.elastic.stop()
    bft.elastic.stop()
    assert bft.elastic.active_session() is None
    for call in (lambda: bft.elastic.inject("kill", rank=0, step=0),
                 lambda: bft.elastic.guard(object())):
        with pytest.raises(RuntimeError):
            call()
    with pytest.raises(ValueError):
        bft.elastic.start(policy="nonsense")


def test_init_and_shutdown_close_the_session():
    ctx = _tinit()
    session = bft.elastic.start()
    assert ctx.elastic_membership is session.membership
    bft.init(device="cpu")
    assert bft.elastic.active_session() is None
    assert ctx.elastic_membership is None
    bft.elastic.start()
    bft.shutdown()
    assert bft.elastic.active_session() is None


def _oom_run(guard_step, params, state, grads, steps=4):
    """Guarded steps until the injected ``oom`` raises; returns the step
    index it raised at and the exception."""
    for i in range(steps):
        try:
            params, state = guard_step(params, state, grads)
        except MemoryError as e:
            return i, e
    return None, None


def _oom_postmortem(root):
    import json

    with open(root / "flight_0.json") as f:
        d = json.load(f)
    return d, [a for a in d["advisories"] if a.get("kind") == "oom"]


def test_oom_from_inject_raises_at_its_step_with_the_postmortem(tmp_path, monkeypatch,
                                                                 cpu_devices):
    """``inject("oom", ...)`` raises ``SimulatedResourceExhausted`` at its
    step, before the dispatch, and leaves the JAX package's postmortem: one
    ``bluefog.elastic.oom_faults``, one ``bluefog.memory.oom_events``, the
    flight dump ``oom:chaos:rank=2`` whose ``oom`` advisory carries the
    ranked census (the same keys and top category as JAX's on the same
    problem)."""
    from bluefog_tpu import flight as jflight
    from bluefog_tpu import memory as jmemory
    from bluefog_tpu_torch import flight, memory

    runs = {}
    for side in ("port", "jax"):
        root = tmp_path / side
        monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(root))
        w0 = np.random.RandomState(0).randn(SIZE, 1024).astype(np.float32)
        if side == "port":
            _tinit(tu.RingGraph)
            flight.reconfigure()
            memory.start(interval=1)
            session = bft.elastic.start(policy="average")
            session.inject("oom", rank=2, step=2)
            opt = bft.DistributedNeighborAllreduceOptimizer(bft.adam(0.01))
            params = torch.from_numpy(w0.copy())
            step, exc = _oom_run(bft.elastic.guard(opt).step, params, opt.init(params),
                                 torch.zeros_like(params))
            events = memory.active().oom_events
            ctrs = (metrics.peek("bluefog.elastic.oom_faults").value,
                    metrics.peek("bluefog.memory.oom_events").value)
            assert isinstance(exc, memory.SimulatedResourceExhausted)
            assert session.step == 2 and not session.repairs  # raised before the dispatch
        else:
            import optax

            _jinit(cpu_devices, jtu.RingGraph)
            jflight.reconfigure()
            jmemory.start(interval=1)
            session = bf.elastic.start(policy="average")
            session.inject("oom", rank=2, step=2)
            opt = bf.DistributedNeighborAllreduceOptimizer(optax.adam(0.01))
            params = {"w": bf.worker_values(lambda r: w0[r])}
            zeros = {"w": bf.worker_values(lambda r: np.zeros(1024, np.float32))}
            step, exc = _oom_run(bf.elastic.guard(opt).step, params, opt.init(params), zeros)
            events = jmemory.active().oom_events
            ctrs = (jmetrics.peek("bluefog.elastic.oom_faults").value,
                    jmetrics.peek("bluefog.memory.oom_events").value)
            assert isinstance(exc, jmemory.SimulatedResourceExhausted)
            jmemory.stop()
            bf.elastic.stop()
            bf.shutdown()
        assert step == 2 and "RESOURCE_EXHAUSTED" in str(exc)
        assert exc._bf_oom_forensics_done and events == 1 and ctrs == (1, 1)
        runs[side] = _oom_postmortem(root)
    (dump, advs), (jdump, jadvs) = runs["port"], runs["jax"]
    assert any(h.startswith("oom:chaos:rank=2") for h in dump["dump_history"])
    assert len(advs) == len(jadvs) == 1
    assert set(advs[0]) == set(jadvs[0])
    # JAX files every unclassified live array under "other"; on the CPU
    # the port has no allocator to read, so its "other" is 0: the owner
    # categories agree byte for byte, opt_state first
    owned = [(r["category"], r["bytes"]) for r in jadvs[0]["ranked_census"]
             if r["category"] != "other"]
    assert [(r["category"], r["bytes"]) for r in advs[0]["ranked_census"]] == owned
    assert advs[0]["top_category"] == owned[0][0] == "opt_state"
    assert advs[0]["step"] == jadvs[0]["step"] == 1
    memory.stop()


def test_oom_from_the_plan_env_raises_at_its_step_with_the_postmortem(tmp_path, monkeypatch):
    """A ``BLUEFOG_FAULT_PLAN`` holding ``oom`` starts a session and raises
    at the fault's step: the kill before it is repaired as usual, the oom
    is consumed (the next step proceeds), and the dump names the oom."""
    from bluefog_tpu_torch import flight, memory

    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    _tinit(tu.RingGraph)
    flight.reconfigure()
    monkeypatch.setenv(FAULT_PLAN_ENV, "kill:rank=1,step=1; oom:rank=3,step=3")
    session = bft.elastic.start()
    assert [f.kind for f in session.plan.faults] == ["kill", "oom"]
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    params = torch.from_numpy(np.random.RandomState(0).randn(SIZE, 512).astype(np.float32))
    state = opt.init(params)
    step, exc = _oom_run(bft.elastic.guard(opt).step, params, state, torch.zeros_like(params))
    assert step == 3 and isinstance(exc, memory.SimulatedResourceExhausted)
    assert len(session.repairs) == 1 and session.stale_dispatches == 0
    assert metrics.peek("bluefog.elastic.oom_faults").value == 1
    bft.elastic.guard(opt).step(params, state, torch.zeros_like(params))  # consumed
    dump, advs = _oom_postmortem(tmp_path)
    assert len(advs) == 1 and advs[0]["reason"] == "chaos:rank=3"
    assert {"kind": "oom", "rank": 3, "step": 3, "seconds": 0.0, "factor": 1.0} in dump["faults"]


def test_plan_from_env_is_replayed(monkeypatch):
    _tinit(tu.RingGraph)
    monkeypatch.setenv(FAULT_PLAN_ENV, "kill:rank=5,step=1")
    session = bft.elastic.start()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    session.before_dispatch(opt)
    assert session.repairs == []
    session.before_dispatch(opt)
    assert [r.detected for r in session.repairs] == [(5,)]
    assert session.repairs[0].step == 1


def test_simulated_compute_dilation_window_equals_jax(cpu_devices):
    def run(pkg):
        session = pkg.elastic.start()
        session.inject("slow", rank=3, step=2, factor=10)
        session.inject("slow", rank=1, step=4, factor=4, steps=3)
        session.inject("degrade", rank=2, step=1, factor=0.5, peer=6)
        session.inject("stall", rank=4, step=3, seconds=0.0, steps=2)
        seen = []
        for _ in range(10):
            seen.append((dict(session.simulated_compute_dilation()),
                         dict(session.simulated_wire_factors()),
                         dict(session.simulated_stale_steps())))
            session.before_dispatch(None)
        assert session.repairs == []
        pkg.elastic.stop()
        return seen

    _tinit()
    _jinit(cpu_devices)
    got, want = run(bft), run(bf)
    assert got == want
    assert got[2][0] == {3: 10.0} and got[7][0] == {3: 10.0}
    assert got[3][2] == {4: 1} and got[4][2] == {4: 2} and got[5][2] == {}
    assert metrics.snapshot()["bluefog.elastic.slow_faults"]["value"] == 2
    bf.shutdown()


def test_transient_stall_does_not_repair_but_deadline_stall_does():
    _tinit(tu.RingGraph)
    session = bft.elastic.start(liveness_timeout_s=60.0)
    session.inject("stall", rank=1, step=0, seconds=5)
    session.inject("stall", rank=2, step=2, seconds=60)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    session.before_dispatch(opt)
    assert session.repairs == [] and session.membership.dead_ranks() == ()
    assert metrics.snapshot()["bluefog.elastic.stalls"]["value"] == 1
    session.before_dispatch(opt)
    session.before_dispatch(opt)
    assert session.membership.dead_ranks() == (2,) and len(session.repairs) == 1
    reason = session.membership.reason(2)[0]
    assert "stalled" in reason and "deadline" in reason


def test_liveness_timeout_env_defaults_to_the_watchdog(monkeypatch):
    from bluefog_tpu_torch.elastic import liveness_timeout

    assert liveness_timeout() == watchdog.stall_timeout()
    monkeypatch.setenv("BLUEFOG_LIVENESS_TIMEOUT", "7.5")
    assert liveness_timeout() == 7.5


def test_watchdog_stall_files_suspects(tmp_path, monkeypatch):
    """A blocking wait past the liveness deadline files SUSPECT verdicts
    for the ranks of the last dispatch, counts them and dumps."""
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    _tinit()
    session = bft.elastic.start(liveness_timeout_s=0.3)
    old = watchdog.stall_timeout()
    watchdog.set_stall_timeout(0.3)
    try:
        with watchdog.watch("combine dispatch (test)"):
            time.sleep(1.2)
    finally:
        watchdog.set_stall_timeout(old)
    assert all(session.membership.state(r) is RankState.SUSPECT for r in range(SIZE))
    assert metrics.snapshot()["bluefog.elastic.suspects"]["value"] == SIZE
    assert session.membership.live_ranks() == tuple(range(SIZE))
    import json

    dump = json.load(open(tmp_path / "flight_0.json"))
    assert dump["reason"].startswith("verdict:suspect:")
    assert dump["membership"]["live"] == list(range(SIZE))


# -- kill trajectories ---------------------------------------------------------------


def _np_combine(v, plan):
    self_w, recv_w = plan.weight_operands()
    y = v * self_w[:, None]
    for r, rnd in enumerate(plan.rounds):
        recv = np.zeros_like(v)
        for s, d in rnd.perm:
            recv[d] = v[s]
        y = y + recv * recv_w[r][:, None]
    return y


def _kill_data(seed=42, steps=24, dim=1536):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(SIZE, dim).astype(np.float32)
    return x0, [rng.randn(SIZE, dim).astype(np.float32) for _ in range(steps)]


def _port_kill_run(order, x0, grads, lr=0.05, kill=(3, 5), compression=None, fused=False):
    ctx = _tinit(tu.ExponentialTwoGraph)
    base_plan = ctx.static_plan()
    session = bft.elastic.start(policy="average")
    session.inject("kill", rank=kill[0], step=kill[1])
    factory = (bft.DistributedAdaptThenCombineOptimizer if order == "atc"
               else bft.DistributedAdaptWithCombineOptimizer)
    opt = factory(bft.sgd(lr))
    opt.compression = compression
    guard = bft.elastic.guard(opt)
    params = {"w": torch.from_numpy(x0.copy())}
    state = opt.init(params)
    traj = []
    for g in grads:
        params, state = guard.step(params, state, {"w": torch.from_numpy(g)})
        traj.append(params["w"].numpy().copy())
    return dict(session=session, traj=traj, base_plan=base_plan,
                repaired_plan=ctx.static_plan(), live=session.membership.live_ranks())


def _jax_kill_run(cpu_devices, order, x0, grads, lr=0.05, kill=(3, 5), compression=None):
    import optax

    _jinit(cpu_devices, jtu.ExponentialTwoGraph)
    session = bf.elastic.start(policy="average")
    session.inject("kill", rank=kill[0], step=kill[1])
    factory = (bf.DistributedAdaptThenCombineOptimizer if order == "atc"
               else bf.DistributedAdaptWithCombineOptimizer)
    opt = factory(optax.sgd(lr))
    if compression:
        opt.compression = compression
    guard = bf.elastic.guard(opt)
    params = {"w": bf.worker_values(lambda r: x0[r])}
    state = opt.init(params)
    traj = []
    for g in grads:
        params, state = guard.step(params, state, {"w": bf.worker_values(lambda r: g[r])})
        traj.append(np.asarray(params["w"]).copy())
    rec = session.repairs[0]
    bf.elastic.stop()
    bf.shutdown()
    return traj, rec


@pytest.mark.parametrize("order", ["atc", "cta"])
def test_kill_fp32_bitwise_survivor_oracle_and_jax(order, cpu_devices, monkeypatch):
    """Detected at its first would-be dispatch and repaired before it; the
    whole trajectory bitwise the numpy replay that switches plans at the
    repair step; the dead slot frozen out of the mixing; JAX's trajectory
    within 1e-5 and its repair record equal."""
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    x0, grads = _kill_data()
    run = _port_kill_run(order, x0, grads)
    session = run["session"]
    rec = session.repairs[0]
    assert [r.detected for r in session.repairs] == [(3,)]
    assert rec.step == 5 and rec.steps_to_detect == {3: 0} and rec.steps_to_repair == 0
    assert session.stale_dispatches == 0
    assert run["live"] == (0, 1, 2, 4, 5, 6, 7)
    lr = np.float32(0.05)
    x = x0.copy()
    oracle = []
    for t, g in enumerate(grads):
        plan = run["base_plan"] if t < 5 else run["repaired_plan"]
        if order == "atc":
            x = _np_combine(x + (-lr) * g, plan)
        else:
            x = _np_combine(x, plan) + (-lr) * g
        oracle.append(x.copy())
    for t, (d, o) in enumerate(zip(run["traj"], oracle)):
        assert np.array_equal(d.view(np.uint32), o.view(np.uint32)), f"step {t}"
    live = list(run["live"])
    final = run["traj"][-1]
    np.testing.assert_allclose(final[live].mean(0), survivor_consensus(oracle[-1], live),
                               atol=1e-5)
    xd = run["traj"][4][3]
    for g in grads[5:]:
        xd = xd + (-lr) * g[3]
    np.testing.assert_array_equal(final[3], xd)
    snap = metrics.snapshot()
    assert snap["bluefog.elastic.repairs"]["value"] == 1
    assert snap["bluefog.elastic.dead_ranks"]["value"] == 1
    assert snap["bluefog.elastic.faults"]["value"] == 1
    assert snap["bluefog.elastic.last_detect_steps"]["value"] == 0
    bft.shutdown()
    jtraj, jrec = _jax_kill_run(cpu_devices, order, x0, grads)
    assert (jrec.step, jrec.detected, jrec.live, jrec.policy, jrec.epoch) == (
        rec.step, rec.detected, rec.live, rec.policy, rec.epoch)
    for t, (d, j) in enumerate(zip(run["traj"], jtraj)):
        np.testing.assert_allclose(d, j, rtol=0, atol=1e-5, err_msg=f"step {t}")


@pytest.mark.parametrize("order", ["atc", "cta"])
def test_kill_int8_converges_to_survivor_consensus(order, cpu_devices, monkeypatch):
    """The int8 wire: the survivors contract to the quantization floor
    and their mean follows the survivor mean plus the gradient drift, as
    JAX's test pins; JAX's trajectory within 2e-2."""
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    kill_step, grad_steps, steps = 5, 10, 60
    rng = np.random.RandomState(7)
    x0 = rng.randn(SIZE, 1536).astype(np.float32)
    grads = [rng.randn(SIZE, 1536).astype(np.float32) * 0.1 if t < grad_steps
             else np.zeros((SIZE, 1536), np.float32) for t in range(steps)]
    run = _port_kill_run(order, x0, grads, compression="int8")
    session = run["session"]
    assert session.stale_dispatches == 0 and len(session.repairs) == 1
    live = list(run["live"])
    assert 3 not in live
    at_repair = run["traj"][kill_step - 1]
    final = run["traj"][-1]
    spread0 = np.abs(at_repair[live] - at_repair[live].mean(0)).max()
    spread = np.abs(final[live] - final[live].mean(0)).max()
    assert spread < 0.05 and spread < spread0 / 5, (spread, spread0)
    mean = survivor_consensus(at_repair, live)
    for t in range(kill_step, grad_steps):
        mean = mean - 0.05 * grads[t][live].mean(0)
    np.testing.assert_allclose(final[live].mean(0), mean, atol=2e-2)
    bft.shutdown()
    jtraj, _ = _jax_kill_run(cpu_devices, order, x0, grads, compression="int8")
    for t, (d, j) in enumerate(zip(run["traj"], jtraj)):
        np.testing.assert_allclose(d, j, rtol=0, atol=2e-2, err_msg=f"step {t}")


def test_kill_chunked_plan_bitwise_unchunked(monkeypatch):
    """A chunked combine repairs under the live-token key with no stale
    dispatch, and the trajectory through the repair is bitwise the
    unchunked one."""
    x0, grads = _kill_data(seed=7, steps=10)

    def run(chunks):
        monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", str(chunks))
        out = _port_kill_run("atc", x0, grads, kill=(3, 4))
        assert out["session"].stale_dispatches == 0 and len(out["session"].repairs) == 1
        keys = list(bft.get_context().plan_keys)
        assert keys[-1][-1] is not None and keys[-1][-1][1] == (0, 1, 2, 4, 5, 6, 7)
        bft.elastic.stop()
        bft.shutdown()
        return out["traj"]

    for a, b in zip(run(2), run(1)):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_kill_fused_train_step_repairs(cpu_devices):
    """The fused train step runs the same liveness and repair path; the
    survivors reach the shared target, as in JAX's run."""
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(11)
    x0 = rng.randn(SIZE, 32).astype(np.float32)
    target = rng.randn(32).astype(np.float32)

    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=6, step=3)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    guard = bft.elastic.guard(opt)
    params = {"w": torch.from_numpy(x0.copy())}
    state = opt.init(params)
    batch = torch.from_numpy(np.broadcast_to(target, (SIZE, 32)).copy())
    step = guard.make_train_step(lambda p, y: torch.sum((p["w"] - y) ** 2))
    for _ in range(30):
        params, state, _loss = step(params, state, batch)
    assert len(session.repairs) == 1 and session.repairs[0].detected == (6,)
    assert session.stale_dispatches == 0
    live = list(session.membership.live_ranks())
    got = params["w"].numpy()
    np.testing.assert_allclose(got[live], np.tile(target, (len(live), 1)), atol=1e-2)

    _jinit(cpu_devices, jtu.ExponentialTwoGraph)
    js = bf.elastic.start()
    js.inject("kill", rank=6, step=3)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
    jstep = bf.elastic.guard(jopt).make_train_step(lambda p, y: jnp.sum((p["w"] - y) ** 2))
    jp = {"w": bf.worker_values(lambda r: x0[r])}
    jst = jopt.init(jp)
    jb = bf.worker_values(lambda r: target)
    for _ in range(30):
        jp, jst, _ = jstep(jp, jst, jb)
    np.testing.assert_allclose(got, np.asarray(jp["w"]), rtol=0, atol=1e-5)
    bf.elastic.stop()
    bf.shutdown()


def test_kill_pushsum_mass_corrected_consensus(cpu_devices):
    """Push-sum: the repaired split conserves the survivors' x and p mass
    from the repair on, and every survivor's x / p converges to
    ``sum(x_live) / sum(p_live)`` at the repair; the installed weights and
    the estimates equal JAX's."""
    import optax

    kill_step, steps = 4, 60
    x0 = np.random.RandomState(3).randn(SIZE, 64).astype(np.float32)
    ctx = _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=kill_step)
    opt = bft.DistributedPushSumOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    state = opt.init({"w": torch.from_numpy(x0.copy())})
    grads = {"w": torch.zeros(SIZE, 64)}
    totals, at_repair = [], None
    for t in range(steps):
        win = win_mod._get_win(ctx, opt._name)
        if t == kill_step:
            at_repair = (win.value.numpy().copy(), win.p.numpy().copy())
        guard.step(state, grads)
        if t >= kill_step:
            live = list(session.membership.live_ranks())
            win = win_mod._get_win(ctx, opt._name)
            totals.append((win.value.numpy()[live].sum(0), win.p.numpy()[live].sum()))
    assert session.repairs[0].policy == "push_sum" and session.stale_dispatches == 0
    live = list(session.membership.live_ranks())
    assert live == [r for r in range(SIZE) if r != 2]
    for x_tot, p_tot in totals[1:]:
        np.testing.assert_allclose(x_tot, totals[0][0], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(p_tot, totals[0][1], rtol=1e-6)
    target = at_repair[0][live].sum(0) / at_repair[1][live].sum()
    est = opt.params()["w"].numpy()
    for r in live:
        np.testing.assert_allclose(est[r], target, atol=1e-4)
    assert all(2 not in d for d in opt.dst_weights)

    _jinit(cpu_devices, jtu.ExponentialTwoGraph)
    js = bf.elastic.start()
    js.inject("kill", rank=2, step=kill_step)
    jopt = bf.DistributedPushSumOptimizer(optax.sgd(0.0))
    jguard = bf.elastic.guard(jopt)
    jst = jopt.init({"w": bf.worker_values(lambda r: x0[r])})
    jg = {"w": bf.worker_values(lambda r: np.zeros(64, np.float32))}
    for _ in range(steps):
        _, jst = jguard.step(jst, jg)
    assert opt.dst_weights == jopt.dst_weights and opt.self_weight == jopt.self_weight
    np.testing.assert_allclose(est, np.asarray(jopt.params()["w"]), rtol=0, atol=1e-5)
    jopt.free()
    bf.elastic.stop()
    bf.shutdown()
    opt.free()


def test_winput_repair_prunes_the_put_wire(cpu_devices):
    """Win-put: the receiver policy (no added edges), no sender pushes to
    the dead rank, the installed weights and the values equal JAX's."""
    import optax

    x0 = np.random.RandomState(1).randn(SIZE, 8).astype(np.float32)
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=3, step=2)
    opt = bft.DistributedWinPutOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    state = opt.init({"w": torch.from_numpy(x0.copy())})
    for _ in range(6):
        _, state = guard.step(state, {"w": torch.zeros(SIZE, 8)})
    assert session.repairs[0].policy == "receiver" and session.stale_dispatches == 0
    assert all(3 not in d for d in opt.dst_weights)
    got = opt.params()["w"].numpy()

    _jinit(cpu_devices, jtu.ExponentialTwoGraph)
    js = bf.elastic.start()
    js.inject("kill", rank=3, step=2)
    jopt = bf.DistributedWinPutOptimizer(optax.sgd(0.0))
    jguard = bf.elastic.guard(jopt)
    jst = jopt.init({"w": bf.worker_values(lambda r: x0[r])})
    for _ in range(6):
        _, jst = jguard.step(jst, {"w": bf.worker_values(lambda r: np.zeros(8, np.float32))})
    assert opt.dst_weights == jopt.dst_weights
    np.testing.assert_allclose(got, np.asarray(jopt.params()["w"]), rtol=0, atol=1e-6)
    jopt.free()
    opt.free()
    bf.elastic.stop()
    bf.shutdown()


def test_pullget_repair_installs_live_src_weights():
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=5, step=1)
    opt = bft.DistributedPullGetOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    state = opt.init({"w": torch.randn(SIZE, 8)})
    for _ in range(3):
        _, state = guard.step(state, {"w": torch.zeros(SIZE, 8)})
    assert session.repairs[0].policy == "receiver" and session.stale_dispatches == 0
    assert all(5 not in s for s in opt.src_weights) and opt.src_weights[5] == {}
    opt.free()


# -- rejoin, user topology, simultaneous kills, EF --------------------------------------


def test_consensus_restore_on_tensors():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    tree = {"w": x, "b": {"c": x.to(torch.bfloat16)}}
    out = consensus_restore(tree, rank=1, live=(0, 2, 3))
    np.testing.assert_allclose(out["w"][1].numpy(), x[[0, 2, 3]].mean(0).numpy())
    assert torch.equal(out["w"][[0, 2, 3]], x[[0, 2, 3]]) and torch.equal(x[1], torch.arange(6.) + 6)
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"][1], x[[0, 2, 3]].mean(0).to(torch.bfloat16))
    flat = consensus_restore(x, rank=3, live=range(4))
    assert torch.equal(flat[3], x[:3].mean(0))
    with pytest.raises(ValueError):
        consensus_restore(tree, rank=1, live=(1,))


def test_rejoin_restores_edges_and_consensus():
    ctx = _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=4, step=2)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    params = {"w": torch.from_numpy(np.random.RandomState(5).randn(SIZE, 16).astype(np.float32))}
    state = opt.init(params)
    grads = {"w": torch.zeros(SIZE, 16)}
    for _ in range(6):
        params, state = guard.step(params, state, grads)
    assert session.membership.dead_ranks() == (4,)
    assert not any(4 in e for e in tu.edges(ctx.load_topology()))
    params = session.rejoin(4, params=params, optimizer=opt)
    assert session.membership.dead_ranks() == ()
    assert np.array_equal(ctx.load_topology(), tu.ExponentialTwoGraph(SIZE)) is False
    assert any(4 in e for e in tu.edges(ctx.load_topology()))
    np.testing.assert_allclose(ctx.load_topology(), repaired_topology(
        tu.ExponentialTwoGraph(SIZE), range(SIZE), "average"))
    survivors = [r for r in range(SIZE) if r != 4]
    np.testing.assert_allclose(params["w"][4].numpy(),
                               params["w"][survivors].mean(0).numpy(), atol=1e-6)
    for _ in range(3):
        params, state = guard.step(params, state, grads)
    assert session.stale_dispatches == 0
    assert metrics.snapshot()["bluefog.elastic.rejoins"]["value"] == 1
    assert session.rejoin(4, params=params) is params  # already live


def test_pushsum_rejoin_reinstalls_sender_weights():
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=1)
    opt = bft.DistributedPushSumOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    state = opt.init({"w": torch.arange(SIZE, dtype=torch.float32)[:, None].repeat(1, 8)})
    for _ in range(3):
        _, state = guard.step(state, {"w": torch.zeros(SIZE, 8)})
    assert all(2 not in d for d in opt.dst_weights)
    session.rejoin(2, optimizer=opt)
    assert any(2 in d for d in opt.dst_weights)
    for _ in range(3):
        _, state = guard.step(state, {"w": torch.zeros(SIZE, 8)})
    assert session.stale_dispatches == 0
    assert len(session.membership.live_ranks()) == SIZE
    opt.free()


def test_user_set_topology_mid_session_becomes_repair_base():
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    params = {"w": torch.arange(SIZE, dtype=torch.float32)[:, None].repeat(1, 4)}
    state = opt.init(params)
    grads = {"w": torch.zeros(SIZE, 4)}
    params, state = guard.step(params, state, grads)
    bft.set_topology(tu.RingGraph(SIZE))
    session.inject("kill", rank=4, step=session.step)
    for _ in range(2):
        params, state = guard.step(params, state, grads)
    live_edges = {tuple(sorted(e)) for e in tu.edges(bft.load_topology())}
    assert not (live_edges & {(0, 2), (1, 3)}), live_edges
    assert np.array_equal(bft.load_topology(), repaired_topology(
        tu.RingGraph(SIZE), [r for r in range(SIZE) if r != 4], "average"))


def test_simultaneous_kills_all_detected_in_one_repair():
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=3)
    session.inject("kill", rank=6, step=3)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    params = {"w": torch.zeros(SIZE, 4)}
    state = opt.init(params)
    for _ in range(6):
        params, state = guard.step(params, state, {"w": torch.zeros(SIZE, 4)})
    assert len(session.repairs) == 1
    assert session.repairs[0].detected == (2, 6)
    assert session.repairs[0].steps_to_detect == {2: 0, 6: 0}
    assert session._unrepaired == {} and session.stale_dispatches == 0


@pytest.mark.parametrize("wire", ["int8_ef", "int4_ef"])
def test_kill_ef_copies_rebuild_when_the_edge_set_changes(wire):
    """The CHOCO copies are zeroed exactly when the repair changes the
    plan's rounds (and kept across steps that do not), and the EF
    recursion re-converges far below the memoryless floor."""
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start(policy="average")
    session.inject("kill", rank=3, step=5)
    opt = bft.DistributedAdaptWithCombineOptimizer(bft.sgd(0.0))
    opt.compression = wire
    guard = bft.elastic.guard(opt)
    x0 = np.random.RandomState(17).randn(SIZE, 1024).astype(np.float32) * 4.0
    params = {"w": torch.from_numpy(x0)}
    state = opt.init(params)
    zero = {"w": torch.zeros(SIZE, 1024)}
    sigs, efs = [], []
    for _ in range(60):
        params, state = guard.step(params, state, zero)
        sigs.append(opt._ef_sig)
        efs.append(opt._ef)
    assert all(s == sigs[0] for s in sigs[:5]) and all(e is efs[0] for e in efs[:5])
    assert sigs[5] != sigs[4] and efs[5] is not efs[4]
    assert all(e is efs[5] for e in efs[5:])
    assert 3 not in {s for perm in sigs[5][1] for e in perm for s in e}
    live = sorted(session.membership.live_ranks())
    w = params["w"].numpy()[live]
    assert np.abs(w - w.mean(0)).max() < 1e-2, wire


def test_dynamic_schedule_optimizer_repairs_its_schedule():
    """A one-peer dynamic optimizer gets its schedule repaired: the
    period is kept and no round of any step touches the dead rank."""
    _tinit(tu.ExponentialTwoGraph)
    sched = schedule_from_dynamic(
        SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(tu.ExponentialTwoGraph(SIZE), r))
    session = bft.elastic.start()
    session.inject("kill", rank=5, step=2)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    opt.schedule = sched
    guard = bft.elastic.guard(opt)
    params = {"w": torch.randn(SIZE, 16)}
    state = opt.init(params)
    for _ in range(8):
        params, state = guard.step(params, state, {"w": torch.randn(SIZE, 16)})
    assert len(session.repairs) == 1 and session.stale_dispatches == 0
    assert opt.schedule.period == sched.period
    assert opt.schedule == repair_schedule(sched, session.membership.live_ranks())
    assert all(5 not in e for p in opt.schedule.plans for perm in p.perms for e in perm)


def test_degrade_fault_reweights_edges_and_counts():
    _tinit(tu.RingGraph)
    session = bft.elastic.start()
    session.inject("degrade", rank=2, step=1, factor=0.25)
    session.inject("degrade", rank=5, step=1, factor=0.5, peer=6)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    for _ in range(3):
        session.before_dispatch(opt)
    assert len(session.repairs) == 1 and session.repairs[0].dead == ()
    assert np.array_equal(bft.load_topology(), repaired_topology(
        tu.RingGraph(SIZE), range(SIZE), "average", {2: 0.25}))
    assert session.simulated_wire_factors() == {2: 0.25, (5, 6): 0.5}
    assert metrics.snapshot()["bluefog.elastic.faults"]["value"] == 2


def test_metrics_and_flight_records_match_the_session(tmp_path, monkeypatch):
    """The ``bluefog.elastic.*`` series follow the session's records, and
    the kill's flight dump carries the membership and faults blocks."""
    import json

    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=4, step=1)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    for _ in range(3):
        session.before_dispatch(opt)
    dump = json.load(open(tmp_path / "flight_0.json"))
    assert dump["reason"] == "verdict:dead:rank=4"
    assert dump["membership"]["dead"] == [4] and dump["membership"]["epoch"] == 1
    assert dump["membership"]["history"] == [[4, "dead", "killed", 1]]
    assert dump["faults"] == [{"kind": "kill", "rank": 4, "step": 1, "seconds": 0.0,
                               "factor": 1.0}]
    session.rejoin(4, optimizer=opt)
    snap = metrics.snapshot()
    rec = session.repairs[-1]
    assert snap["bluefog.elastic.repairs"]["value"] == len(session.repairs) == 1
    assert snap["bluefog.elastic.epoch"]["value"] == rec.epoch
    assert snap["bluefog.elastic.dead_ranks"]["value"] == 0
    assert snap["bluefog.elastic.rejoins"]["value"] == 1
    assert snap["bluefog.elastic.repair_ms"]["count"] == 1
    kinds = [e["kind"] for e in bft.flight.events()]
    assert {"membership", "fault", "repair"} <= set(kinds)


def test_adopt_topology_becomes_the_base():
    _tinit(tu.ExponentialTwoGraph)
    session = bft.elastic.start()
    session.inject("kill", rank=1, step=0)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    session.before_dispatch(opt)
    session.adopt_topology(tu.RingGraph(SIZE), opt)
    live = [r for r in range(SIZE) if r != 1]
    assert np.array_equal(bft.load_topology(), repaired_topology(tu.RingGraph(SIZE), live))
    session.rejoin(1, optimizer=opt)
    assert np.array_equal(bft.load_topology(), repaired_topology(tu.RingGraph(SIZE),
                                                                 range(SIZE)))
    assert metrics.snapshot()["bluefog.elastic.migrations"]["value"] == 1
