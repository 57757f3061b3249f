# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Knobs the JAX package reads and the port must not ignore:
``BLUEFOG_PLAN_METHOD``, ``BLUEFOG_NODES_PER_MACHINE`` and
``BLUEFOG_PODS`` (a declared federation runs: the optimizers' combine is
the two-level one of ``bft.federation``), each against the JAX package on
its 8-device CPU mesh.

Tolerances: rounds and receive weights are compared exactly; the int8
facade combine, one ATC int8 optimizer step and the hierarchical results
within ``1e-6 * max|want|`` (the port's other tests hold them so: XLA:CPU
may contract a product and a sum into one rounding, which the port rounds
twice; a quantized value moved across a rounding boundary would show as a
whole quantum, far above that).
"""

import networkx as nx
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
from bluefog_tpu.collective import ops as jops
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import compiler

SIZE = 8


def _digraph(seed=3):
    """A receiver-normalized weighted digraph whose offset grouping needs
    more rounds than its coloring: two in-edges a rank at scattered
    offsets."""
    rng = np.random.RandomState(seed)
    w = np.zeros((SIZE, SIZE))
    for j in range(SIZE):
        srcs = rng.choice([i for i in range(SIZE) if i != j], 2, replace=False)
        w[srcs, j] = rng.uniform(0.1, 0.3, 2)
        w[j, j] = 1.0 - w[:, j].sum()
    return w


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    yield cpu_devices
    bf.shutdown()
    bft.shutdown()


def _rounds(plan):
    return [(tuple(r.perm), tuple(np.round(r.recv_weights, 12))) for r in plan.rounds]


def test_the_digraph_tells_the_methods_apart():
    w = _digraph()
    edges = list(zip(*np.nonzero(w - np.diag(np.diag(w)))))
    offset = compiler.compile_edges(edges, SIZE, method="offset")
    coloring = compiler.compile_edges(edges, SIZE, method="coloring")
    assert offset.rounds > coloring.rounds == compiler.compile_edges(edges, SIZE).rounds


@pytest.mark.parametrize("method", ["offset", "coloring"])
def test_plan_method_gives_jax_rounds_and_combines(contexts, monkeypatch, method):
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", method)
    w = _digraph()
    bf.init(devices=contexts[:SIZE])
    bft.init(device="cpu")
    bf.set_topology(nx.from_numpy_array(w, create_using=nx.DiGraph), is_weighted=True)
    bft.set_topology(w, is_weighted=True)
    jplan = jops._static_plan(bf.get_context())
    tplan = bft.get_context().static_plan()
    assert _rounds(tplan) == _rounds(jplan)
    edges = list(zip(*np.nonzero(w - np.diag(np.diag(w)))))
    assert len(tplan.rounds) == compiler.compile_edges(edges, SIZE, method=method).rounds
    x = np.random.RandomState(0).randn(SIZE, 1500).astype(np.float32)
    got = bft.neighbor_allreduce(bft.worker_values(list(x)), compression="int8")
    want = bf.neighbor_allreduce(bf.worker_values(list(x)), compression="int8")
    _close(got.numpy(), want)
    # one ATC int8 step on the same gradients
    g = np.random.RandomState(1).randn(SIZE, 1500).astype(np.float32)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1, momentum=0.9))
    jopt.compression = "int8"
    jp = {"w": bf.worker_values(list(x))}
    jp, _ = jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(g)})
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    topt.compression = "int8"
    tp = {"w": torch.from_numpy(x.copy())}
    topt.step(tp, topt.init(tp), {"w": torch.from_numpy(g)})
    _close(tp["w"].numpy(), jp["w"])


def test_forced_plan_method_pins_one_chunk(contexts, monkeypatch):
    monkeypatch.delenv("BLUEFOG_PLAN_CHUNKS")
    bft.init(device="cpu")
    plan = bft.get_context().static_plan()
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    payload = (1 << 28, 1 << 26)
    monkeypatch.setattr(compiler, "TRANSPORT_LINK_CLASS", "ici")  # JAX's chooser
    assert opt._plan_chunks(plan, payload, opt.compression) > 1
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "offset")
    assert opt._plan_chunks(plan, payload, opt.compression) == 1


def test_plan_method_reaches_the_window_exchange(contexts, monkeypatch):
    w = _digraph()
    bft.init(device="cpu")
    bft.set_topology(w, is_weighted=True)
    x = bft.worker_values(list(np.eye(SIZE, dtype=np.float32)))
    lowered = {}
    for method in ("offset", "coloring"):
        monkeypatch.setenv("BLUEFOG_PLAN_METHOD", method)
        bft.win_create(x, "faults_win")
        bft.win_put(name="faults_win")
        lowered[method] = [k for k in bft.get_context().op_cache if k[0] == "win_lowering"]
        bft.win_free("faults_win")
    assert {k[-1] for k in lowered["coloring"]} == {"offset", "coloring"}


def _fed_step_matches_jax(wire, seed=4):
    """One ATC step on ``wire`` with the context's federation: the port's
    parameters within ``1e-6 * max|want|`` of JAX's, the dispatch key the
    federated one."""
    x = np.random.RandomState(seed).randn(SIZE, 1500).astype(np.float32)
    g = np.random.RandomState(seed + 1).randn(SIZE, 1500).astype(np.float32)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
    jopt.compression = wire
    jp = {"w": bf.worker_values(list(x))}
    jp, _ = jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(g)})
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    topt.compression = wire
    tp = {"w": torch.from_numpy(x.copy())}
    assert topt._resolve_dispatch(bft.get_context(), tp, True).key[:2] == ("fed", "dcn")
    topt.step(tp, topt.init(tp), {"w": torch.from_numpy(g)})
    _close(tp["w"].numpy(), jp["w"])


def test_shortcut_is_refused_naming_the_roadmap_item(contexts, monkeypatch):
    """``BLUEFOG_PLAN_METHOD=shortcut`` lowers to the relay family (ROADMAP
    A13b is ported: the facade's combine equals JAX's relay within 1e-6 of
    the largest value, the compiler's rounds JAX's). A federation declared
    under it (``BLUEFOG_PODS``, refused until ROADMAP A12b) now runs: its
    legs compile direct plans, as JAX's do, and an ATC int8 step equals
    JAX's. The name is the one the test had while the port refused both."""
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "shortcut")
    w = _digraph()
    bf.init(devices=contexts[:SIZE])
    bft.init(device="cpu")
    bf.set_topology(nx.from_numpy_array(w, create_using=nx.DiGraph), is_weighted=True)
    bft.set_topology(w, is_weighted=True)
    assert _rounds(bft.get_context().static_plan()) == _rounds(jops._static_plan(bf.get_context()))
    x = np.random.RandomState(0).randn(SIZE, 1500).astype(np.float32)
    got = bft.neighbor_allreduce(bft.worker_values(list(x)))
    _close(got.numpy(), bf.neighbor_allreduce(bf.worker_values(list(x))))
    assert compiler.compile_edges([(0, 1)], 2, method="shortcut").route == "shortcut"
    monkeypatch.setenv("BLUEFOG_PODS", "2")
    bf.init(devices=contexts[:SIZE])
    bft.init(device="cpu")
    _fed_step_matches_jax("int8")


def test_nodes_per_machine_from_the_environment_matches_jax(contexts, monkeypatch):
    monkeypatch.setenv("BLUEFOG_NODES_PER_MACHINE", "2")
    bf.init(devices=contexts[:SIZE])
    bft.init(device="cpu")
    assert bft.local_size() == bf.local_size() == 2
    assert bft.machine_size() == bf.machine_size() == SIZE // 2
    bf.set_machine_topology(tu.RingGraph(SIZE // 2))
    bft.set_machine_topology(ttu.RingGraph(SIZE // 2))
    x = np.random.RandomState(2).randn(SIZE, 300).astype(np.float32)
    _close(bft.hierarchical_neighbor_allreduce(bft.worker_values(list(x))).numpy(),
           bf.hierarchical_neighbor_allreduce(bf.worker_values(list(x))))
    g = np.random.RandomState(3).randn(SIZE, 300).astype(np.float32)
    jopt = bf.DistributedHierarchicalNeighborAllreduceOptimizer(optax.sgd(0.1))
    jp = {"w": bf.worker_values(list(x))}
    jp, _ = jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(g)})
    topt = bft.DistributedHierarchicalNeighborAllreduceOptimizer(bft.sgd(0.1))
    tp = {"w": torch.from_numpy(x.copy())}
    topt.step(tp, topt.init(tp), {"w": torch.from_numpy(g)})
    _close(tp["w"].numpy(), jp["w"])


def test_nodes_per_machine_must_divide_the_workers(contexts, monkeypatch):
    monkeypatch.setenv("BLUEFOG_NODES_PER_MACHINE", "3")
    with pytest.raises(ValueError, match="must divide the worker count"):
        bft.init(device="cpu")
    # an explicit argument wins over the environment, as in JAX
    assert bft.init(device="cpu", nodes_per_machine=4).local_size == 4


def test_a_declared_federation_is_refused_at_init(contexts, monkeypatch):
    """A declared federation is no longer refused (ROADMAP A12b): ``init``
    runs, a 2 x 4 fabric's first (DCN) step equals JAX's on fp32 and int4;
    a blank spec is flat; a spec that does not split the workers raises
    JAX's ``ValueError`` at the first dispatch, never a silent flat run.
    The name is the one the test had while the port refused the spec."""
    monkeypatch.setenv("BLUEFOG_PODS", "2")
    bf.init(devices=contexts[:SIZE])
    assert bft.init(device="cpu").size == SIZE
    for wire in (None, "int4"):
        _fed_step_matches_jax(wire)
    monkeypatch.setenv("BLUEFOG_PODS", " ")
    assert bft.init(device="cpu").size == SIZE
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    params = {"w": torch.zeros(SIZE, 512)}
    assert opt._resolve_dispatch(bft.get_context(), params, True).key[0] == "na"
    monkeypatch.setenv("BLUEFOG_PODS", "3")
    with pytest.raises(ValueError, match="equal pods"):
        opt._resolve_dispatch(bft.get_context(), params, True)
