# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's dynamic one-peer schedules (``bluefog_tpu_torch.topology.dynamic``)
and their lowering (``collective.plan.schedule_from_dynamic``) against the
JAX package's.

The JAX generators take ``networkx`` graphs; the port takes the same
graphs' weight matrices (``nx.to_numpy_array``). Yields, period matrices,
period edges, perms, self weights and receive weights must be identical
(not close).
"""

import itertools

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import topology as tu
from bluefog_tpu.collective import plan as jplan
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import plan as tplan

SIZES = [4, 8, 16]
GRAPHS = {
    "exp2": tu.ExponentialTwoGraph,
    "exponential": tu.ExponentialGraph,
    "ring": tu.RingGraph,
    "star": tu.StarGraph,
}


def _take(it, n):
    return list(itertools.islice(it, n))


def _period(make, size):
    return jplan.schedule_from_dynamic(size, make).period


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_one_peer_yields_identical(graph, size):
    g = GRAPHS[graph](size)
    w = nx.to_numpy_array(g)
    period = _period(lambda r: tu.GetDynamicOnePeerSendRecvRanks(g, r), size)
    for r in range(size):
        want = _take(tu.GetDynamicOnePeerSendRecvRanks(g, r), 2 * period)
        assert _take(ttu.GetDynamicOnePeerSendRecvRanks(w, r), 2 * period) == want


def _machine_cases():
    for size in SIZES:
        for local in (2, 4):
            if size > local:
                yield size, local


@pytest.mark.parametrize("size,local", list(_machine_cases()))
def test_exp2_machine_yields_identical(size, local):
    """Every rank's yields (machine ids); the period is that of the
    machine-level schedule (machine ``m`` as its rank ``m * local``)."""
    make_j = lambda r: tu.GetExp2DynamicSendRecvMachineRanks(size, local, r, r % local)
    make_t = lambda r: ttu.GetExp2DynamicSendRecvMachineRanks(size, local, r, r % local)
    period = _period(lambda m: make_j(m * local), size // local)
    for r in range(size):
        assert _take(make_t(r), 2 * period) == _take(make_j(r), 2 * period)


INNER_OUTER = {
    "ring": (tu.GetInnerOuterRingDynamicSendRecvRanks,
             ttu.GetInnerOuterRingDynamicSendRecvRanks),
    "expo2": (tu.GetInnerOuterExpo2DynamicSendRecvRanks,
              ttu.GetInnerOuterExpo2DynamicSendRecvRanks),
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("local", [2, 4])
@pytest.mark.parametrize("kind", sorted(INNER_OUTER))
def test_inner_outer_yields_identical(kind, size, local):
    """Where the JAX generator refuses the layout (2 workers a machine, or
    one machine for Exp2), the port refuses it with the same exception."""
    jgen, tgen = INNER_OUTER[kind]
    try:
        want = [_take(jgen(size, local, r), 1) for r in range(size)]
    except Exception as e:  # noqa: BLE001 -- the reference's own refusal
        with pytest.raises(type(e)):
            [_take(tgen(size, local, r), 1) for r in range(size)]
        return
    period = _period(lambda r: jgen(size, local, r), size)
    for r in range(size):
        assert _take(tgen(size, local, r), 2 * period) == _take(jgen(size, local, r), 2 * period)
    assert want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_period_matrices_and_edges_identical(graph, size):
    g = GRAPHS[graph](size)
    w = nx.to_numpy_array(g)
    jm, tm = tu.one_peer_period_matrices(g), ttu.one_peer_period_matrices(w)
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a, b)
    assert ttu.one_peer_period_edges(w) == tu.one_peer_period_edges(g)
    # the two views of the port agree with each other
    for m, (n, edges) in zip(tm, ttu.one_peer_period_edges(w)):
        dense = np.zeros((n, n))
        for (i, j), wt in edges.items():
            dense[i, j] = wt
        np.testing.assert_array_equal(dense, m)


# name -> (JAX make_iterator, port make_iterator, ranks): 8 workers, or the
# 4 machines of 8 workers in pairs for the machine-level schedule
SCHEDULES = {
    "one-peer exp2": (
        lambda r: tu.GetDynamicOnePeerSendRecvRanks(tu.ExponentialTwoGraph(8), r),
        lambda r: ttu.GetDynamicOnePeerSendRecvRanks(ttu.ExponentialTwoGraph(8), r), 8),
    "one-peer star": (
        lambda r: tu.GetDynamicOnePeerSendRecvRanks(tu.StarGraph(8), r),
        lambda r: ttu.GetDynamicOnePeerSendRecvRanks(ttu.StarGraph(8), r), 8),
    "machine exp2": (
        lambda m: tu.GetExp2DynamicSendRecvMachineRanks(8, 2, 2 * m, 0),
        lambda m: ttu.GetExp2DynamicSendRecvMachineRanks(8, 2, 2 * m, 0), 4),
    "inner-outer expo2": (
        lambda r: tu.GetInnerOuterExpo2DynamicSendRecvRanks(8, 4, r),
        lambda r: ttu.GetInnerOuterExpo2DynamicSendRecvRanks(8, 4, r), 8),
}


@pytest.mark.parametrize("uniform,self_weight", [(True, None), (False, None), (False, 0.3)])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_from_dynamic_identical(name, uniform, self_weight):
    make_j, make_t, size = SCHEDULES[name]
    js = jplan.schedule_from_dynamic(size, make_j, uniform=uniform, self_weight=self_weight)
    ts = tplan.schedule_from_dynamic(size, make_t, uniform=uniform, self_weight=self_weight)
    assert (ts.period, ts.size, ts.max_in_degree) == (js.period, js.size, js.max_in_degree)
    for jp, tp in zip(js.plans, ts.plans):
        assert tp.perms == jp.perms
        assert tp.self_weights == jp.self_weights
        assert [r.recv_weights for r in tp.rounds] == [r.recv_weights for r in jp.rounds]
        np.testing.assert_array_equal(tp.weight_matrix(), jp.weight_matrix())
    # the stacked operands hold each step's plan, padded with empty rounds
    src, self_w, recv_w = ts.stacked_operands
    for t, tp in enumerate(ts.plans):
        n = len(tp.rounds)
        np.testing.assert_array_equal(src[t, :n], tp.sources())
        assert (src[t, n:] == -1).all() and (recv_w[t, n:] == 0).all()
        np.testing.assert_array_equal(self_w[t], tp.weight_operands()[0])
        np.testing.assert_array_equal(recv_w[t, :n], tp.weight_operands()[1])


def test_send_recv_symmetry_check_matches_jax():
    good_src, good_dst = [{1: 1.0}, {0: 1.0}], [{1: 1.0}, {0: 1.0}]
    tplan.check_send_recv_symmetry(good_src, good_dst)
    bad_dst = [{1: 1.0}, {}]
    with pytest.raises(ValueError) as jerr:
        jplan.check_send_recv_symmetry(good_src, bad_dst)
    with pytest.raises(ValueError) as terr:
        tplan.check_send_recv_symmetry(good_src, bad_dst)
    assert str(terr.value) == str(jerr.value)


def test_detect_period_matches_jax():
    for steps in ([1, 2, 1, 2, 1, 2], [1, 1, 1, 1], [1, 2, 3, 4], [1, 2, 3, 1, 2, 3, 1]):
        assert tplan._detect_period(steps) == jplan._detect_period(steps)
