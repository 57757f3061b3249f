# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's spectral engine (``bluefog_tpu_torch.topology.spectral`` and
the spectral functions of ``topology``) against the JAX package's.

Tolerances. Both engines are the same numpy code on the same float64
matrices, so every SLEM, decay rate and info dict is held EXACTLY equal to
JAX's (bitwise floats, equal dicts), for every generator, for repaired
live subsets and for the one-peer period products. The sparse engine is
held to the dense oracle to ``1e-9`` (JAX's ``AGREE_TOL``).
"""

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import logging_util as jlogging
from bluefog_tpu import topology as jtu
from bluefog_tpu.elastic.repair import repaired_matrix as jrepaired_matrix
from bluefog_tpu.topology import spectral as jspectral
from bluefog_tpu_torch import logging_util
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.elastic.repair import repaired_matrix
from bluefog_tpu_torch.topology import spectral

AGREE_TOL = 1e-9

GENERATORS = {
    "ring": (tu.RingGraph, jtu.RingGraph),
    "exp2": (tu.ExponentialTwoGraph, jtu.ExponentialTwoGraph),
    "exp": (tu.ExponentialGraph, jtu.ExponentialGraph),
    "symexp": (tu.SymmetricExponentialGraph, jtu.SymmetricExponentialGraph),
    "mesh": (tu.MeshGrid2DGraph, jtu.MeshGrid2DGraph),
    "star": (tu.StarGraph, jtu.StarGraph),
    "full": (tu.FullyConnectedGraph, jtu.FullyConnectedGraph),
}


def _pair(gen, size):
    """The port's matrix and JAX's ``nx.to_numpy_array`` of its graph."""
    ours, theirs = GENERATORS[gen]
    return tu.mixing_matrix(ours(size)), jtu.mixing_matrix(theirs(size))


def _same(a, b):
    """Bitwise-equal floats and equal info dicts."""
    (ra, ia), (rb, ib) = a, b
    assert np.float64(ra).tobytes() == np.float64(rb).tobytes(), (ra, rb)
    assert ia == ib, (ia, ib)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("size", [4, 8, 16, 96])
def test_slem_and_decay_bitwise_jax(gen, size):
    """``mixing_matrix`` equals JAX's array; SLEM, gap and decay rate with
    their info dicts equal JAX's on the dense path (``size <= 64``) and on
    the sparse one (96)."""
    w, jw = _pair(gen, size)
    assert w.dtype == np.float64 and np.array_equal(w, jw)
    _same(tu.second_largest_eigenvalue_modulus_info(w),
          jtu.second_largest_eigenvalue_modulus_info(jw))
    _same(tu.consensus_decay_rate_info(w), jtu.consensus_decay_rate_info(jw))
    assert tu.spectral_gap(w) == jtu.spectral_gap(jw)
    assert tu.consensus_decay_rate(w) == jtu.consensus_decay_rate(jw)
    info = tu.second_largest_eigenvalue_modulus_info(w)[1]
    assert info["engine"] == ("dense" if size <= 64 else "sparse")


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("size", [8, 12, 24, 48])
def test_sparse_matches_dense(gen, size):
    """The deflated Arnoldi engine forced below the dense threshold agrees
    with the dense oracle, and both equal JAX's."""
    w, jw = _pair(gen, size)
    em = spectral.edges_from_dense(w)
    rho, info = spectral._sparse_slem([em])
    jrho, jinfo = jspectral._sparse_slem([jspectral.edges_from_dense(jw)])
    assert info["engine"] == "sparse" and (rho, info) == (jrho, jinfo)
    dense = spectral.dense_slem(w)
    assert dense == jspectral.dense_slem(jw)
    assert abs(rho - dense) <= AGREE_TOL, (gen, size, rho, dense)


@pytest.mark.parametrize("gen", ["ring", "exp2", "mesh", "star"])
@pytest.mark.parametrize("policy", ["average", "receiver", "push_sum"])
@pytest.mark.parametrize("seed", [0, 1])
def test_repaired_live_subsets_bitwise_jax(gen, policy, seed):
    """The elastic repair's matrices restricted to random live subsets, as
    dense arrays and as live edge dicts: the port's numbers are JAX's, and
    sparse agrees with dense."""
    rng = np.random.RandomState(seed)
    for size in (8, 16, 32):
        w, jw = _pair(gen, size)
        k = int(rng.randint(1, size // 2))
        dead = set(rng.choice(size, size=k, replace=False).tolist())
        live = [r for r in range(size) if r not in dead]
        fixed = repaired_matrix(w, live, policy=policy)
        jfixed = jrepaired_matrix(jw, live, policy=policy)
        sub, jsub = fixed[np.ix_(live, live)], jfixed[np.ix_(live, live)]
        _same(tu.consensus_decay_rate_info(sub), jtu.consensus_decay_rate_info(jsub))
        rho, _info = spectral._sparse_slem([spectral.edges_from_dense(sub)])
        assert abs(rho - spectral.dense_slem(sub)) <= AGREE_TOL
        edges = {(i, j): v for (i, j), v in np.ndenumerate(fixed) if v != 0.0}
        n, sub_edges = tu.live_submatrix_edges(edges, live)
        assert (n, sub_edges) == jtu.live_submatrix_edges(edges, live)
        _same(tu.second_largest_eigenvalue_modulus_info((n, sub_edges)),
              jtu.second_largest_eigenvalue_modulus_info((n, sub_edges)))


@pytest.mark.parametrize("gen", ["ring", "exp2"])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_period_product_bitwise_jax(gen, size):
    """A one-peer schedule's period product: the port's rate equals JAX's
    on the matrices and on the edge form, dense and sparse agree, and the
    period mixes faster a step than its first matrix alone."""
    ours, theirs = GENERATORS[gen]
    mats = tu.one_peer_period_matrices(ours(size))
    jmats = jtu.one_peer_period_matrices(theirs(size))
    assert all(np.array_equal(a, b) for a, b in zip(mats, jmats))
    _same(tu.consensus_decay_rate_info(mats), jtu.consensus_decay_rate_info(jmats))
    edges = tu.one_peer_period_edges(ours(size))
    _same(tu.consensus_decay_rate_info(edges), jtu.consensus_decay_rate_info(edges))
    sparse, _info = spectral._sparse_slem([spectral.edges_from_dense(m) for m in mats])
    prod = np.eye(size)
    for m in mats:
        prod = m.T @ prod
    assert abs(sparse - spectral.dense_slem(prod)) <= AGREE_TOL
    if gen == "exp2" and size == 8:
        assert tu.consensus_decay_rate(mats) < tu.consensus_decay_rate(mats[0])


def test_known_values_and_ordering():
    """Ring(8)'s 1/3 + 2/3 cos(2 pi / 8), Exp2(8)'s 1/2, fully connected 0,
    and Exp2 mixing faster than the ring (JAX's ``test_slem_known_values``)."""
    ring = tu.mixing_matrix(tu.RingGraph(8))
    exp2 = tu.mixing_matrix(tu.ExponentialTwoGraph(8))
    full = tu.mixing_matrix(tu.FullyConnectedGraph(8))
    assert tu.second_largest_eigenvalue_modulus(ring) == pytest.approx(
        1.0 / 3.0 + 2.0 / 3.0 * np.cos(2 * np.pi / 8), abs=1e-9)
    assert tu.second_largest_eigenvalue_modulus(exp2) == pytest.approx(0.5, abs=1e-9)
    assert tu.second_largest_eigenvalue_modulus(full) < 1e-9
    assert tu.spectral_gap(full) == pytest.approx(1.0, abs=1e-9)
    assert tu.consensus_decay_rate(exp2) < tu.consensus_decay_rate(ring)


@pytest.mark.parametrize("case", ["disconnected", "periodic"])
def test_slem_one_when_nothing_is_promised(case):
    """Two disconnected rings and a pure cyclic permutation (a periodic
    chain) keep a second modulus-1 root: SLEM 1 on both engines, as in
    JAX."""
    if case == "disconnected":
        w = np.zeros((8, 8))
        for ring in ([0, 1, 2, 3], [4, 5, 6, 7]):
            for k, i in enumerate(ring):
                w[i, i] = 0.5
                w[i, ring[(k + 1) % len(ring)]] = 0.5
    else:
        w = np.zeros((6, 6))
        for i in range(6):
            w[i, (i + 1) % 6] = 1.0
    assert tu.second_largest_eigenvalue_modulus(w) == pytest.approx(1.0)
    assert tu.second_largest_eigenvalue_modulus(w) == jtu.second_largest_eigenvalue_modulus(w)
    rho, _info = spectral._sparse_slem([spectral.edges_from_dense(w)])
    assert rho == pytest.approx(1.0, abs=AGREE_TOL)


def test_routing_obeys_dense_max(monkeypatch):
    monkeypatch.setenv(spectral.DENSE_MAX_ENV, "8")
    _rho, info = tu.second_largest_eigenvalue_modulus_info(tu.mixing_matrix(tu.RingGraph(16)))
    assert info["engine"] == "sparse"
    _rho, info = tu.second_largest_eigenvalue_modulus_info(tu.mixing_matrix(tu.RingGraph(6)))
    assert info["engine"] == "dense" and info["reason"] == "below_dense_max"
    assert tu.spectral_dense_max() == 8
    monkeypatch.setenv(spectral.DENSE_MAX_ENV, "junk")
    assert tu.spectral_dense_max() == spectral.DENSE_MAX_DEFAULT


def test_dense_forced_warns_once_at_scale(monkeypatch):
    """``BLUEFOG_SPECTRAL_DENSE_MAX=0`` forces the dense path; past N = 256
    the port's ``warn_once`` raises one ``UserWarning`` naming the knob."""
    monkeypatch.setenv(spectral.DENSE_MAX_ENV, "0")
    monkeypatch.setattr(logging_util, "_warned_once", set())
    monkeypatch.setattr(jlogging, "_warned_once", set())
    w = tu.mixing_matrix(tu.RingGraph(300))
    with pytest.warns(UserWarning, match=spectral.DENSE_MAX_ENV) as rec:
        rate, info = tu.second_largest_eigenvalue_modulus_info(w)
    assert len([r for r in rec if spectral.DENSE_MAX_ENV in str(r.message)]) == 1
    assert info["engine"] == "dense" and info["reason"] == "forced"
    _same((rate, info), jtu.second_largest_eigenvalue_modulus_info(w))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tu.second_largest_eigenvalue_modulus_info(w)  # silent the second time


def test_non_stochastic_falls_back_to_dense():
    w = np.abs(np.random.RandomState(3).randn(70, 70))
    got = spectral.slem_info(w)
    assert got[1]["engine"] == "dense" and got[1]["reason"] == "not_stochastic"
    _same(got, jspectral.slem_info(w))


def test_edge_matrix_matches_jax():
    w = tu.mixing_matrix(tu.MeshGrid2DGraph(12))
    em = spectral.edges_from_dense(w)
    jem = jspectral.edges_from_dense(w)
    x = np.random.RandomState(0).randn(12)
    assert np.array_equal(em.apply_transpose(x), jem.apply_transpose(x))
    np.testing.assert_allclose(em.apply_transpose(x), w.T @ x, atol=1e-12)
    assert np.array_equal(em.to_dense(), w) and em.nnz == int(np.count_nonzero(w))
    e2 = spectral.EdgeMatrix(3, {(0, 1): 0.5, (1, 2): 0.0, (2, 0): 0.25})
    assert e2.nnz == 2
    assert np.array_equal(e2.col_sums(), [0.25, 0.5, 0.0])
    assert np.array_equal(e2.row_sums(), [0.5, 0.0, 0.25])
    g = nx.from_numpy_array(w, create_using=nx.DiGraph)
    assert np.array_equal(jtu.mixing_matrix(g), tu.mixing_matrix(w))
