# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's topologies and comm plans against the JAX package's.

Generator matrices, compiled rounds, per-round receive weights, self
weights and neighbor queries must be identical (not close) for every
generator the slice ports, weighted and uniform, at 4 and 8 workers.
"""

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import topology as tu
from bluefog_tpu.collective import compiler as jcompiler, plan as jplan
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import compiler as tcompiler, plan as tplan

GENERATORS = {
    "exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
    "exponential": (tu.ExponentialGraph, ttu.ExponentialGraph),
    "ring": (tu.RingGraph, ttu.RingGraph),
    "star": (tu.StarGraph, ttu.StarGraph),
    "full": (tu.FullyConnectedGraph, ttu.FullyConnectedGraph),
}


@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matrices_identical(name, size):
    jgen, tgen = GENERATORS[name]
    jg, tm = jgen(size), tgen(size)
    np.testing.assert_array_equal(nx.to_numpy_array(jg), tm)
    assert sorted((i, j) for i, j in jg.edges() if i != j) == ttu.edges(tm)
    for rank in range(size):
        assert tu.GetRecvWeights(jg, rank) == ttu.GetRecvWeights(tm, rank)
        assert tu.GetSendWeights(jg, rank) == ttu.GetSendWeights(tm, rank)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_plans_identical(name, size, weighted):
    jgen, tgen = GENERATORS[name]
    jp = jplan.plan_from_topology(jgen(size), weighted=weighted)
    tp = tplan.plan_from_topology(tgen(size), weighted=weighted)
    assert tp.perms == jp.perms
    assert tp.self_weights == jp.self_weights
    assert [r.recv_weights for r in tp.rounds] == [r.recv_weights for r in jp.rounds]
    for a, b in zip(tp.weight_operands(), jp.weight_operands()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp.weight_matrix(), jp.weight_matrix())
    assert tp.in_neighbors == jp.in_neighbors
    assert tp.compile_info.method == jp.compile_info.method
    # the gather form of the rounds names each round's sender exactly
    src = tp.sources()
    for r, perm in enumerate(jp.perms):
        for s, d in perm:
            assert src[r, d] == s
        assert (src[r] >= 0).sum() == len(perm)


@pytest.mark.parametrize("method", ["offset", "coloring", "auto"])
def test_compile_edges_irregular_identical(method):
    """An irregular edge set, where the coloring beats the offset
    grouping, compiles to the same rounds."""
    rng = np.random.RandomState(0)
    edges = sorted({(int(i), int(j)) for i, j in rng.randint(0, 12, (30, 2)) if i != j})
    je = jcompiler.compile_edges(edges, 12, method=method)
    te = tcompiler.compile_edges(edges, 12, method=method)
    assert te.perms == je.perms
    assert (te.method, te.rounds, te.offset_rounds, te.lower_bound) == (
        je.method, je.rounds, je.offset_rounds, je.lower_bound
    )


def test_context_neighbor_queries_match(cpu_devices):
    import bluefog_tpu as bf

    bf.init(devices=cpu_devices[:8])
    try:
        ctx = bft.init(device="cpu")
        for gen in ("exp2", "ring", "star"):
            jgen, tgen = GENERATORS[gen]
            bf.set_topology(jgen(8))
            bft.set_topology(tgen(8))
            assert bft.in_neighbor_ranks() == bf.in_neighbor_ranks()
            assert bft.out_neighbor_ranks() == bf.out_neighbor_ranks()
        assert ctx.size == bft.size() == 8
        np.testing.assert_array_equal(bft.load_topology(), ttu.StarGraph(8))
    finally:
        bf.shutdown()
        bft.shutdown()


WIRES = [None, "bf16", "int8", "int8_ef", "int4", "int4_ef"]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_round_sources_and_destinations_equal_jax(name, size, weighted):
    jgen, tgen = GENERATORS[name]
    jp = jplan.plan_from_topology(jgen(size), weighted=weighted)
    tp = tplan.plan_from_topology(tgen(size), weighted=weighted)
    assert [r.sources for r in tp.rounds] == [r.sources for r in jp.rounds]
    assert [r.destinations for r in tp.rounds] == [r.destinations for r in jp.rounds]
    assert all(isinstance(r.sources, tuple) and isinstance(r.destinations, tuple)
               for r in tp.rounds)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_wire_bytes_equal_jax(name, size, wire):
    """Every wire tier, whole and ragged 512-element blocks, f32 and bf16
    payloads, the default itemsize."""
    jgen, tgen = GENERATORS[name]
    jp = jplan.plan_from_topology(jgen(size))
    tp = tplan.plan_from_topology(tgen(size))
    for n_elems in (0, 1, 512, 70_123, 25_557_032):
        for itemsize in (4, 2):
            assert tp.wire_bytes(n_elems, itemsize, wire=wire) == jp.wire_bytes(
                n_elems, itemsize, wire=wire)
        assert tp.wire_bytes(n_elems, wire=wire) == jp.wire_bytes(n_elems, wire=wire)
