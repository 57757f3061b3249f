# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Eager ``neighbor_allreduce`` of the port against ``bf.neighbor_allreduce``
on the JAX package's 8-device CPU mesh, same numpy inputs."""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as ttu

SIZE = 8


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    # one monolithic combine per call on the JAX side (its chunk chooser
    # could otherwise pipeline the transfers; chunked == monolithic there,
    # bitwise, but the monolithic path is the one the port mirrors)
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    # the JAX composite wire: bitwise its Pallas kernels (pinned by the
    # JAX package's tests), and it runs wherever shard_map does
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.shutdown()
    bft.shutdown()


def _inputs(seed=0, shape=(SIZE, 3000)):
    return (np.random.RandomState(seed).randn(*shape) * 5.0).astype(np.float32)


def _both(x, compression):
    want = np.asarray(bf.neighbor_allreduce(bf.worker_values(list(x)),
                                            compression=compression))
    got = bft.neighbor_allreduce(bft.worker_values(list(x)),
                                 compression=compression).numpy()
    return got, want


TOPOLOGIES = {
    "exponential": (tu.ExponentialGraph, ttu.ExponentialGraph, False),
    "exp2_weighted": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph, True),
    "ring": (tu.RingGraph, ttu.RingGraph, False),
    "star": (tu.StarGraph, ttu.StarGraph, True),
}


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_exact_matches_jax(topo):
    jgen, tgen, weighted = TOPOLOGIES[topo]
    bf.set_topology(jgen(SIZE), is_weighted=weighted)
    bft.set_topology(tgen(SIZE), is_weighted=weighted)
    got, want = _both(_inputs(), None)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_matches_jax(wire, topo):
    """The two differ only where XLA:CPU contracts the accumulate ``y +
    (x_hat_r - x_hat_self) * w`` into an FMA and the port (like its CUDA
    kernel, built with -fmad=false) does not: at most one ulp of the
    round's product and one of the partial sum per round, bounded here by
    ``2 * rounds`` ulps of four times the row's largest magnitude (every
    product and partial sum is below that). Where the product is exact
    the FMA rounds as the separate add does, so the results are bitwise
    equal: int4 differences carry at most 5 significant bits, and a
    dyadic weight with few bits (1/4, 1/8, 7/8) keeps the product exact;
    the ring's 1/3 does not."""
    jgen, tgen, weighted = TOPOLOGIES[topo]
    bf.set_topology(jgen(SIZE), is_weighted=weighted)
    bft.set_topology(tgen(SIZE), is_weighted=weighted)
    x = _inputs(seed=1)
    got, want = _both(x, wire)
    plan = bft.get_context().static_plan()
    recv_w = plan.weight_operands()[1]
    if wire == "int4" and np.all((recv_w * 256) % 1 == 0):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        return
    rounds = len(plan.rounds)
    atol = 2 * rounds * np.spacing(4 * np.abs(x).max(axis=1, keepdims=True))
    assert (np.abs(got - want) <= atol).all()


def test_consensus_is_fixed_point_and_mean_kept():
    """Identical rows stay identical (the difference form), and repeated
    int8 gossip on a doubly stochastic graph contracts the spread while
    keeping the worker mean."""
    c = np.tile(_inputs(seed=2)[:1], (SIZE, 1))
    out = bft.neighbor_allreduce(torch.from_numpy(c), compression="int8").numpy()
    np.testing.assert_array_equal(out, c)
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE), is_weighted=True)
    x = torch.from_numpy(_inputs(seed=3, shape=(SIZE, 4096)))
    mean0 = x.mean(0)
    spread0 = (x - mean0).abs().max()
    for _ in range(20):
        x = bft.neighbor_allreduce(x, compression="int8")
    assert (x - x.mean(0)).abs().max() < spread0 / 100
    assert (x.mean(0) - mean0).abs().max() < 1e-4 * mean0.abs().max()


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        bft.neighbor_allreduce(torch.zeros(SIZE, 4), compression="fp4")
    with pytest.raises(ValueError):
        bft.neighbor_allreduce(torch.zeros(SIZE - 1, 4))
    with pytest.raises(ValueError):
        bft.neighbor_allreduce(torch.zeros(SIZE, 4, dtype=torch.float64),
                               compression="int8")
