# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's remaining topology generators, comparisons and inference
against the JAX package's: the same arguments give the same weight matrix,
entry for entry (exact equality, no tolerance), and the same answers."""

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import topology as tu
from bluefog_tpu.topology import infer as jinfer
from bluefog_tpu_torch import topology as ttu


def _matrix(graph, size):
    return nx.to_numpy_array(graph, nodelist=range(size))


SIZES = list(range(1, 18))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("base", [2, 3, 4])
def test_symmetric_exponential_matches_jax(size, base):
    np.testing.assert_array_equal(ttu.SymmetricExponentialGraph(size, base),
                                  _matrix(tu.SymmetricExponentialGraph(size, base), size))


@pytest.mark.parametrize("size", SIZES)
def test_mesh_grid_matches_jax(size):
    np.testing.assert_array_equal(ttu.MeshGrid2DGraph(size),
                                  _matrix(tu.MeshGrid2DGraph(size), size))


@pytest.mark.parametrize("shape", [(1, 6), (2, 3), (3, 2), (4, 4), (2, 8)])
def test_mesh_grid_explicit_shape_matches_jax(shape):
    size = shape[0] * shape[1]
    np.testing.assert_array_equal(ttu.MeshGrid2DGraph(size, shape),
                                  _matrix(tu.MeshGrid2DGraph(size, shape), size))


def test_mesh_grid_refuses_a_shape_that_does_not_cover_size():
    with pytest.raises(ValueError, match="covers"):
        ttu.MeshGrid2DGraph(6, (2, 2))
    with pytest.raises(AssertionError):
        tu.MeshGrid2DGraph(6, (2, 2))


# (size, degree): sparse ones take rejection sampling, dense ones (degree
# close to size) the colouring fallback after 1000 rejected draws
RRD_CASES = [(2, 1), (5, 2), (8, 3), (12, 2), (16, 4), (17, 3), (6, 4), (7, 5), (8, 6),
             (9, 7), (10, 8)]


@pytest.mark.parametrize("size,degree", RRD_CASES)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_regular_digraph_matches_jax(size, degree, seed):
    got = ttu.RandomRegularDigraph(size, degree, seed)
    np.testing.assert_array_equal(got, _matrix(tu.RandomRegularDigraph(size, degree, seed), size))
    nz = got != 0
    assert (nz.sum(0) == degree + 1).all() and (nz.sum(1) == degree + 1).all()


def test_random_regular_digraph_dense_fallback_is_taken():
    """(8, 6) exhausts the 1000 rejection draws for its last derangement
    on seed 0, so the colouring fallback decides the result (and still
    matches the JAX package, above)."""
    rng = np.random.RandomState(0)
    taken, fell_back = set(), False
    for _ in range(6):
        for _attempt in range(1000):
            perm = rng.permutation(8)
            if (perm == np.arange(8)).any() or any((i, int(perm[i])) in taken for i in range(8)):
                continue
            break
        else:
            fell_back = True
            break
        taken.update((i, int(perm[i])) for i in range(8))
    assert fell_back


def test_random_regular_digraph_refuses_bad_degree():
    for size, degree in ((4, 0), (4, 4), (1, 1)):
        with pytest.raises(ValueError):
            ttu.RandomRegularDigraph(size, degree)


GRAPHS = {
    "exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
    "exp": (tu.ExponentialGraph, ttu.ExponentialGraph),
    "symexp": (tu.SymmetricExponentialGraph, ttu.SymmetricExponentialGraph),
    "mesh": (tu.MeshGrid2DGraph, ttu.MeshGrid2DGraph),
    "star": (tu.StarGraph, ttu.StarGraph),
    "ring": (tu.RingGraph, ttu.RingGraph),
    "full": (tu.FullyConnectedGraph, ttu.FullyConnectedGraph),
    "rrd": (lambda n: tu.RandomRegularDigraph(n, 2, 3), lambda n: ttu.RandomRegularDigraph(n, 2, 3)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("size", [3, 5, 8, 12, 16])
def test_is_regular_graph_matches_jax(name, size):
    jgen, tgen = GRAPHS[name]
    assert ttu.IsRegularGraph(tgen(size)) == tu.IsRegularGraph(jgen(size))


@pytest.mark.parametrize("a,b", [("exp2", "exp2"), ("exp2", "exp"), ("ring", "ring"),
                                 ("ring", "star"), ("mesh", "mesh"), ("symexp", "exp")])
@pytest.mark.parametrize("size", [4, 8, 9])
def test_is_topology_equivalent_matches_jax(a, b, size):
    (ja, ta), (jb, tb) = GRAPHS[a], GRAPHS[b]
    assert ttu.IsTopologyEquivalent(ta(size), tb(size)) == \
        tu.IsTopologyEquivalent(ja(size), jb(size))


def test_is_topology_equivalent_weights_and_none():
    w = ttu.RingGraph(6)
    other = w.copy()
    other[0, 1] = 0.25
    assert ttu.IsTopologyEquivalent(w, w.copy())
    assert not ttu.IsTopologyEquivalent(w, other)
    assert not ttu.IsTopologyEquivalent(w, None)
    assert not ttu.IsTopologyEquivalent(w, ttu.RingGraph(7))
    jw = tu.RingGraph(6)
    jo = nx.from_numpy_array(other, create_using=nx.DiGraph)
    assert tu.IsTopologyEquivalent(jw, jo) == ttu.IsTopologyEquivalent(w, other)


def _dynamic_lists(size, step):
    """Every rank's (send, recv) lists at one step of the one-peer schedule
    over the exponential graph."""
    gens = [ttu.GetDynamicOnePeerSendRecvRanks(ttu.ExponentialGraph(size), r)
            for r in range(size)]
    for _ in range(step):
        for g in gens:
            next(g)
    pairs = [next(g) for g in gens]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("size", [2, 5, 8, 13])
@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("matrix", [False, True])
def test_infer_matches_jax(size, step, matrix):
    send, recv = _dynamic_lists(size, step)
    for tfn, jfn, lists in (
        (ttu.InferSourceFromDestinationRanks, jinfer.InferSourceFromDestinationRanks, send),
        (ttu.InferDestinationFromSourceRanks, jinfer.InferDestinationFromSourceRanks, recv),
    ):
        got = tfn(lists, construct_adjacency_matrix=matrix)
        want = jfn(lists, construct_adjacency_matrix=matrix)
        if matrix:
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got == want
        for r in range(size):
            assert tfn(lists, rank=r) == jfn(lists, rank=r)


def test_infer_inverts_the_dynamic_schedule():
    send, recv = _dynamic_lists(8, 1)
    assert ttu.InferSourceFromDestinationRanks(send) == [sorted(r) for r in recv]


@pytest.mark.parametrize("bad", [[[1], [1]], [[0, 0], []], [[5], [0]], [[-1], [0]]])
def test_infer_refuses_what_jax_refuses(bad):
    with pytest.raises(AssertionError):
        jinfer.InferSourceFromDestinationRanks(bad)
    with pytest.raises(AssertionError):
        ttu.InferSourceFromDestinationRanks(bad)


def test_infer_refuses_a_flat_list():
    with pytest.raises(ValueError, match="per-rank"):
        ttu.InferDestinationFromSourceRanks([1, 2])
    with pytest.raises(ValueError, match="size"):
        ttu.InferDestinationFromSourceRanks([[1], [0]], size=3)
