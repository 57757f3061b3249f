# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's scaling stats (``tests/test_scaling.py`` and the compiled
round counts of ``tests/test_plan_compiler.py`` for ``bluefog_tpu_torch``).

``hlo_collective_stats`` is the JAX package's regex reader: held equal to
it on the texts of the JAX tests and on the optimized HLO of a JAX combine
compiled here. ``gossip_comm_stats`` counts the transfers one eager combine made
(a gather along the worker axis is one ``collective-permute``): its dicts
must equal those the JAX function reads from the compiled program, for
every plan of the JAX tests, with the ``include_plan`` summaries equal key
by key; a combine that skips a round must change the count.
``weak_scaling_times`` keeps JAX's row form. The 2 x 4 process case is in
``tests/test_torch_trace_tools.py``, which shares its processes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import bluefog_tpu.topology as jtopo
from bluefog_tpu import scaling as jscaling
from bluefog_tpu.collective import inner as jinner, plan as jplan
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import scaling, topology as ttopo
from bluefog_tpu_torch.collective import inner, plan as tplan

SIZE = 8
D = 4096  # payload elements per worker, as tests/test_scaling.py

HLO_TEXTS = {
    "async_start": """
  %cp = (f32[100]{0}, f32[100]{0}) collective-permute-start(%x), source_target_pairs={{0,1}}
  %cpd = f32[100]{0} collective-permute-done(%cp)
  %ar = bf16[32]{0} all-reduce-start(%y), to_apply=%add
  %ard = bf16[32]{0} all-reduce-done(%ar)
""",
    "tuple_shapes": """
  %cp = (f32[100]{0}, f32[100]{0}, u32[], u32[]) collective-permute-start(%x), source_target_pairs={{0,1}}
  %cpd = f32[100]{0} collective-permute-done(%cp)
  %var = (f32[10]{0}, bf16[20]{0}) all-reduce(%a, %b), to_apply=%add
""",
    "variadic_start": """
  %ar = (f32[1000]{0}, f32[1000]{0}) all-reduce-start(%a, %b), to_apply=%add
  %ard = (f32[1000]{0}, f32[1000]{0}) all-reduce-done(%ar)
""",
    "unknown_dtype": "  %cp = f4e2m1[64]{0} collective-permute(%x)\n",
}


@pytest.fixture(autouse=True)
def context():
    bft.init(device="cpu")
    yield
    bft.shutdown()


def _one_peer(lib, topo_mod, n, step=0):
    sched = lib.schedule_from_dynamic(
        n, lambda r: topo_mod.GetDynamicOnePeerSendRecvRanks(topo_mod.ExponentialGraph(n), r))
    return sched.plans[step % sched.period]


# (name, JAX plan, port plan): every plan of tests/test_scaling.py:37-80 and
# tests/test_plan_compiler.py:162-205
PLAN_CASES = (
    [(f"one_peer_{n}", lambda n=n: _one_peer(jplan, jtopo, n),
      lambda n=n: _one_peer(tplan, ttopo, n)) for n in (2, 4, 8)]
    + [(f"exp2_{n}", lambda n=n: jplan.plan_from_topology(jtopo.ExponentialTwoGraph(n),
                                                          weighted=True),
        lambda n=n: tplan.plan_from_topology(ttopo.ExponentialTwoGraph(n), weighted=True))
       for n in (4, 8)]
    + [("exp2_8_uniform", lambda: jplan.plan_from_topology(jtopo.ExponentialTwoGraph(8)),
        lambda: tplan.plan_from_topology(ttopo.ExponentialTwoGraph(8)))]
    + [(name, lambda j=j: jplan.plan_from_topology(j(), weighted=True),
        lambda t=t: tplan.plan_from_topology(t(), weighted=True))
       for name, j, t in (
           ("star", lambda: jtopo.StarGraph(SIZE), lambda: ttopo.StarGraph(SIZE)),
           ("mesh2d", lambda: jtopo.MeshGrid2DGraph(SIZE), lambda: ttopo.MeshGrid2DGraph(SIZE)),
           ("random_d2", lambda: jtopo.RandomRegularDigraph(SIZE, 2, seed=3),
            lambda: ttopo.RandomRegularDigraph(SIZE, 2, seed=3)))]
    + [("random_d2_offset",
        lambda: jplan.plan_from_topology(jtopo.RandomRegularDigraph(SIZE, 2, seed=3),
                                         weighted=True, method="offset"),
        lambda: tplan.plan_from_topology(ttopo.RandomRegularDigraph(SIZE, 2, seed=3),
                                         weighted=True, method="offset"))]
)


@pytest.mark.parametrize("name", sorted(HLO_TEXTS))
def test_hlo_collective_stats_equal_jax(name):
    text = HLO_TEXTS[name]
    assert scaling.hlo_collective_stats(text) == jscaling.hlo_collective_stats(text)


def test_hlo_collective_stats_equal_jax_on_a_compiled_combine(cpu_devices):
    """The optimized HLO of one JAX ppermute combine over Exp2(8), compiled
    here: the port's reader finds what JAX's finds, one permute a round."""
    plan = jplan.plan_from_topology(jtopo.ExponentialTwoGraph(SIZE))
    mesh = Mesh(np.array(cpu_devices[:SIZE]), ("workers",))
    fn = jax.jit(jax.shard_map(lambda t: jinner.neighbor_allreduce(t, plan, "workers"),
                               mesh=mesh, in_specs=P("workers"), out_specs=P("workers")))
    x = jax.device_put(jnp.zeros((SIZE, 256), jnp.float32), NamedSharding(mesh, P("workers")))
    text = fn.lower(x).compile().as_text()
    got = scaling.hlo_collective_stats(text)
    assert got == jscaling.hlo_collective_stats(text)
    assert got["collective-permute"]["count"] == len(plan.rounds)


@pytest.mark.parametrize("name", [c[0] for c in PLAN_CASES])
def test_gossip_comm_stats_equal_jax(name, cpu_devices):
    _, jmake, tmake = next(c for c in PLAN_CASES if c[0] == name)
    jp, tp = jmake(), tmake()
    want = jscaling.gossip_comm_stats(jp, D)
    assert scaling.gossip_comm_stats(tp, D) == want
    assert want["collective-permute"]["count"] == len(jp.rounds)


@pytest.mark.parametrize("name", ["one_peer_8", "exp2_8", "random_d2", "random_d2_offset"])
def test_gossip_comm_stats_plan_summary_equal_jax(name, cpu_devices):
    _, jmake, tmake = next(c for c in PLAN_CASES if c[0] == name)
    want = jscaling.gossip_comm_stats(jmake(), 256, include_plan=True)
    got = scaling.gossip_comm_stats(tmake(), 256, include_plan=True)
    assert set(got) == set(want)
    for key in want["plan"]:
        assert got["plan"][key] == want["plan"][key], key
    assert {k: v for k, v in got.items() if k != "plan"} == {
        k: v for k, v in want.items() if k != "plan"}


def test_gossip_comm_stats_allreduce_mode_equal_jax(cpu_devices):
    jp = jplan.plan_from_topology(jtopo.ExponentialTwoGraph(SIZE))
    tp = tplan.plan_from_topology(ttopo.ExponentialTwoGraph(SIZE))
    want = jscaling.gossip_comm_stats(jp, D, mode="allreduce")
    assert scaling.gossip_comm_stats(tp, D, mode="allreduce") == want
    assert want["all-reduce"] == {"count": 1, "bytes": D * 4}


def test_gossip_comm_stats_bf16_payload_bytes():
    """A bf16 payload ships two bytes an element a round."""
    tp = tplan.plan_from_topology(ttopo.ExponentialTwoGraph(SIZE))
    got = scaling.gossip_comm_stats(tp, D, dtype=torch.bfloat16)
    assert got == {"collective-permute": {"count": 3, "bytes": 3 * D * 2}}


def test_gossip_comm_stats_unknown_mode_raises_like_jax(cpu_devices):
    jp = jplan.plan_from_topology(jtopo.ExponentialTwoGraph(SIZE))
    tp = tplan.plan_from_topology(ttopo.ExponentialTwoGraph(SIZE))
    with pytest.raises(ValueError, match="unknown mode"):
        jscaling.gossip_comm_stats(jp, D, mode="gather")
    with pytest.raises(ValueError, match="unknown mode"):
        scaling.gossip_comm_stats(tp, D, mode="gather")


def test_gossip_comm_stats_counts_the_transfers_the_combine_made(monkeypatch):
    """A planted plan whose combine skips its last round: the plan still
    has three rounds, the count drops to two, so the count is read from
    the gathers the combine ran."""
    tp = tplan.plan_from_topology(ttopo.ExponentialTwoGraph(SIZE))
    full = scaling.gossip_comm_stats(tp, D)
    operands = inner.plan_operands

    def skip_last(plan, device):
        src, self_w, recv_w = operands(plan, device)
        return src[:-1], self_w, recv_w[:-1]

    monkeypatch.setattr(inner, "plan_operands", skip_last)
    planted = scaling.gossip_comm_stats(tp, D)
    assert len(tp.rounds) == 3
    assert full["collective-permute"]["count"] == 3
    assert planted == {"collective-permute": {"count": 2, "bytes": 2 * D * 4}}


def test_record_transfers_logs_the_chunked_combine():
    """The chunked combine's wavefront: one transfer per (round, chunk),
    each one worker's chunk."""
    tp = tplan.plan_from_topology(ttopo.ExponentialTwoGraph(SIZE))
    x = torch.zeros(SIZE, 2048)
    with inner.record_transfers() as log:
        inner.neighbor_allreduce(x, tp, chunks=4)
    assert [k for k, _ in log] == ["gather"] * (3 * 4)
    assert sum(b for _, b in log) == 3 * 2048 * 4


def test_weak_scaling_times_rows_like_jax():
    """The harness (tests/test_scaling.py's weak-scaling case on stacked
    workers): JAX's keys, the sizes asked, positive times, the first
    efficiency 1."""
    def make_step(n):
        plan = (_one_peer(tplan, ttopo, n) if n > 1
                else tplan.plan_from_topology(ttopo.FullyConnectedGraph(1)))
        x = torch.ones(n, 8, 64)
        w = torch.ones(64, 64)
        return (lambda x, w: inner.neighbor_allreduce(torch.tanh(x @ w), plan)), (x, w)

    rows = scaling.weak_scaling_times(make_step, ns=(1, 2, 4), steps=3, warmup=1)
    assert [set(r) for r in rows] == [{"n", "ms_per_step", "efficiency"}] * 3
    assert [r["n"] for r in rows] == [1, 2, 4]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["ms_per_step"] > 0 and r["efficiency"] > 0 for r in rows)


@pytest.mark.parametrize("dims", [None, "2,4"])
def test_relay_plan_stats_and_summary_equal_jax(dims, monkeypatch, cpu_devices):
    """A short-cut (relay) plan, on the virtual ring and on a declared 2 x 4
    torus: the permutes JAX's relay combine compiles to (one a round), and
    the summary's route, link class, congestion and costs, key by key."""
    if dims:
        monkeypatch.setenv("BLUEFOG_TORUS_DIMS", dims)
    jp = jplan.plan_from_topology(jtopo.ExponentialGraph(SIZE), method="shortcut")
    tp = tplan.plan_from_topology(ttopo.ExponentialGraph(SIZE), method="shortcut")
    assert tp.relay and jp.compile_info.route == "shortcut"
    want = jscaling.gossip_comm_stats(jp, 256, include_plan=True)
    got = scaling.gossip_comm_stats(tp, 256, include_plan=True)
    assert got.pop("plan") == want.pop("plan")
    assert got == want
    for wire in (None, "int8", "int4"):
        assert scaling.plan_comm_summary(tp, 1 << 20, wire=wire) == jscaling.plan_comm_summary(
            jp, 1 << 20, wire=wire)
