# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The bf16 combine wire of the port (``compression="bf16"``) against the
JAX package on the 8-device CPU mesh (4 machines x 2), same numpy inputs:
the facade's ``neighbor_allreduce`` on Exp2(8), the ring and one-peer
dynamic weights; the hierarchical optimizers' bf16 machine leg; three ATC
and CTA steps of the gossip optimizers; and the quantized combine of bf16
and f16 payloads (which the port once refused) on every wire.

Tolerances: the facade's bf16 combine is one rounding to bf16, then per
round ``(recv - x_hat) * w`` in f32 and one add, the same operations in the
same order as JAX: bitwise where the weights are powers of two, else within
1e-6 of the largest value (XLA:CPU contracts the add into an FMA). The
optimizer steps are held to 1e-6 of the
largest parameter, as ``test_torch_optimizer_family`` holds the other
wires: XLA:CPU may contract the momentum update into an FMA, which the port
rounds as two operations. bf16 and f16 payloads are held to one unit in
the last place of their dtype on each element's largest operand (2**-7
relative for bf16, 2**-10 for f16): XLA:CPU keeps a fused elementwise chain
in f32 where PyTorch rounds each operation to the payload dtype. Misuse
raises JAX's error text.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as ttu

import test_torch_optimizer_family as tof

SIZE = 8
LOCAL = 2


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE], nodes_per_machine=LOCAL)
    bft.init(device="cpu", nodes_per_machine=LOCAL)
    yield
    bf.shutdown()
    bft.shutdown()


def _inputs(seed=0, shape=(SIZE, 1000)):
    return (np.random.RandomState(seed).randn(*shape) * 5.0).astype(np.float32)


TOPOLOGIES = {
    "exp2": (lambda: tu.ExponentialTwoGraph(SIZE), lambda: ttu.ExponentialTwoGraph(SIZE)),
    "ring": (lambda: tu.RingGraph(SIZE), lambda: ttu.RingGraph(SIZE)),
}


def _close(got, want):
    """Within 1e-6 of the largest value: XLA:CPU contracts ``y + d * w``
    into an FMA, which the port rounds as two operations."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("weighted", [False, True])
def test_facade_bf16_matches_jax(topo, weighted):
    """Bitwise where every weight is a power of two (Exp2(8): 1/4, so
    ``d * w`` is exact and an FMA rounds as the two operations do), else
    :func:`_close` (the ring's 1/3)."""
    jgen, tgen = TOPOLOGIES[topo]
    bf.set_topology(jgen(), is_weighted=weighted)
    bft.set_topology(tgen(), is_weighted=weighted)
    x = _inputs(1)
    got = bft.neighbor_allreduce(bft.worker_values(list(x)), compression="bf16")
    want = np.asarray(bf.neighbor_allreduce(bf.worker_values(list(x)), compression="bf16"))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    if topo == "exp2":
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("step", [0, 1, 2])
def test_facade_bf16_one_peer_dynamic_weights_matches_jax(step):
    """One-peer weights are 1/2: bitwise."""
    self_w, src_w, dst_w = tof._one_peer(step)
    x = _inputs(7 + step, (SIZE, 1500))
    kw = dict(self_weight=self_w, src_weights=src_w, dst_weights=dst_w, compression="bf16")
    got = bft.neighbor_allreduce(bft.worker_values(list(x)), **kw).numpy()
    want = np.asarray(bf.neighbor_allreduce(bf.worker_values(list(x)), **kw))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_facade_bf16_nonblocking_and_consensus():
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    x = bft.worker_values(list(_inputs(2)))
    handle = bft.neighbor_allreduce_nonblocking(x, compression="bf16")
    assert torch.equal(bft.synchronize(handle), bft.neighbor_allreduce(x, compression="bf16"))
    # exact consensus is a fixed point of the difference form
    same = torch.ones(SIZE, 700) * 1.2345678
    assert torch.equal(bft.neighbor_allreduce(same, compression="bf16"), same)


@pytest.mark.parametrize("wire", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_facade_low_precision_payloads_match_jax(wire, dtype):
    """bf16 and f16 payloads combine in their own dtype on every wire (the
    port refused them before): one ulp of the payload dtype."""
    bf.set_topology(tu.ExponentialTwoGraph(SIZE))
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    x32 = _inputs(3, (SIZE, 1100))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    jx = bf.worker_values(list(jnp.asarray(x32).astype(getattr(jnp, dtype))))
    got = bft.neighbor_allreduce(tx, compression=wire)
    want = np.asarray(bf.neighbor_allreduce(jx, compression=wire)).astype(np.float32)
    assert got.dtype == tx.dtype
    ulp = 2.0 ** (-7 if dtype == "bfloat16" else -10)
    bound = np.maximum(np.abs(want), np.abs(x32).max(axis=0, keepdims=True)) * ulp
    assert (np.abs(got.float().numpy() - want) <= bound).all()


def test_facade_refuses_what_jax_refuses():
    x = _inputs()
    for bad in ("bf16_ef", "fp8"):
        with pytest.raises(ValueError) as jerr:
            bf.neighbor_allreduce(bf.worker_values(list(x)), compression=bad)
        with pytest.raises(ValueError) as terr:
            bft.neighbor_allreduce(bft.worker_values(list(x)), compression=bad)
        assert str(terr.value) == str(jerr.value)
    bf.set_topology(tu.ExponentialTwoGraph(SIZE))
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    src = [{s: 0.9 for s in bft.in_neighbor_ranks(r)} for r in range(SIZE)]
    with pytest.raises(ValueError) as jerr:
        bf.neighbor_allreduce(bf.worker_values(list(x)), self_weight=0.9, src_weights=src,
                              compression="bf16")
    with pytest.raises(ValueError, match="normalized") as terr:
        bft.neighbor_allreduce(bft.worker_values(list(x)), self_weight=0.9, src_weights=src,
                               compression="bf16")
    assert str(terr.value) == str(jerr.value)


# -- the gossip optimizers --------------------------------------------------------------


def _opt_pair(name):
    jopt, topt = tof._pair(name)
    jopt.compression = topt.compression = "bf16"
    return jopt, topt


@pytest.fixture
def exp2_weighted():
    bf.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE), is_weighted=True)
    bf.set_machine_topology(tu.RingGraph(SIZE // LOCAL))
    bft.set_machine_topology(ttu.RingGraph(SIZE // LOCAL))


@pytest.mark.parametrize("name", ["atc", "neighbor", "awc", "hierarchical"])
def test_optimizer_bf16_steps_match_jax(exp2_weighted, name):
    """Three ATC / CTA steps, and the hierarchical path's bf16 machine
    leg, against JAX's ``opt.step`` on the same gradients."""
    jopt, topt = _opt_pair(name)
    tof._run_steps(jopt, topt, steps=3)


def test_hierarchical_bf16_machine_leg_is_the_combine(exp2_weighted):
    """At lr 0 a step is the hierarchical combine alone: the machine sums
    on the bf16 wire, divided by the machine size (:func:`_close`: the
    machine ring's weights are 1/3)."""
    jopt = bf.DistributedHierarchicalNeighborAllreduceOptimizer(optax.sgd(0.0))
    topt = bft.DistributedHierarchicalNeighborAllreduceOptimizer(bft.sgd(0.0))
    jopt.compression = topt.compression = "bf16"
    x = _inputs(5, (SIZE, 900))
    jp, tp = {"w": bf.worker_values(list(x))}, {"w": torch.from_numpy(x.copy())}
    jp, _ = jopt.step(jp, jopt.init(jp), {"w": jnp.zeros_like(jp["w"])})
    tp, _ = topt.step(tp, topt.init(tp), {"w": torch.zeros_like(tp["w"])})
    _close(tp["w"].numpy(), np.asarray(jp["w"]))
    assert not np.array_equal(tp["w"].numpy(), x)


def test_optimizer_low_precision_leaf_matches_jax(exp2_weighted):
    """A tree with a bf16 leaf beside f32 ones: the bf16 group combines in
    bf16 on the int8 wire, as JAX's does."""
    jopt, topt = tof._pair("atc", momentum=None)
    jopt.compression = topt.compression = "int8"
    rng = np.random.RandomState(9)
    w, b = (rng.randn(SIZE, 600) * 2).astype(np.float32), rng.randn(SIZE, 40).astype(np.float32)
    gw, gb = rng.randn(SIZE, 600).astype(np.float32), rng.randn(SIZE, 40).astype(np.float32)
    jp = {"w": bf.worker_values(list(w)),
          "b": bf.worker_values(list(jnp.asarray(b).astype(jnp.bfloat16)))}
    tp = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b).to(torch.bfloat16)}
    jg = {"w": jnp.asarray(gw), "b": jnp.asarray(gb).astype(jnp.bfloat16)}
    tg = {"w": torch.from_numpy(gw), "b": torch.from_numpy(gb).to(torch.bfloat16)}
    jp, _ = jopt.step(jp, jopt.init(jp), jg)
    tp, _ = topt.step(tp, topt.init(tp), tg)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=0,
                               atol=1e-6 * np.abs(w).max())
    want_b = np.asarray(jp["b"]).astype(np.float32)
    assert tp["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["b"].float().numpy(), want_b, rtol=0,
                               atol=2.0 ** -7 * np.abs(b).max() * 2)


@pytest.mark.parametrize("name,match", [
    ("allreduce", "only supported"),
    ("grad-allreduce", "only supported"),
])
def test_optimizer_bf16_refusals_match_jax(name, match):
    jopt, topt = _opt_pair(name)
    rng = np.random.RandomState(0)
    p, g = tof._tree(rng), tof._tree(rng)
    with pytest.raises(ValueError, match=match) as jerr:
        jopt.step(tof._jx(p), jopt.init(tof._jx(p)), tof._jx(g))
    with pytest.raises(ValueError, match=match) as terr:
        topt.step(tof._tx(p), topt.init(tof._tx(p)), tof._tx(g))
    assert str(terr.value) == str(jerr.value)


def test_optimizer_bf16_refused_on_a_schedule_and_unknown_tiers_match_jax():
    jopt, topt = _opt_pair("neighbor")
    jopt.schedule = tof.jschedule(SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(
        tu.ExponentialGraph(SIZE), r))
    topt.schedule = tof.tschedule(SIZE, lambda r: ttu.GetDynamicOnePeerSendRecvRanks(
        ttu.ExponentialGraph(SIZE), r))
    rng = np.random.RandomState(0)
    p, g = tof._tree(rng), tof._tree(rng)
    for bad in ("bf16", "fp8"):
        jopt.compression = topt.compression = bad
        with pytest.raises(ValueError) as jerr:
            jopt.step(tof._jx(p), jopt.init(tof._jx(p)), tof._jx(g))
        with pytest.raises(ValueError) as terr:
            topt.step(tof._tx(p), topt.init(tof._tx(p)), tof._tx(g))
        assert str(terr.value) == str(jerr.value)


def test_make_train_step_bf16_matches_two_program_step(exp2_weighted):
    """The fused step on the bf16 wire is the two-program step, bitwise."""
    c = torch.from_numpy(_inputs(6, (SIZE, 300)))
    x0 = torch.from_numpy(_inputs(7, (SIZE, 300)))

    def loss_fn(p, t):
        return 0.5 * torch.sum((p["w"] - t) ** 2)

    fused = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    two = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    fused.compression = two.compression = "bf16"
    pf, pt = {"w": x0.clone()}, {"w": x0.clone()}
    sf, st = fused.init(pf), two.init(pt)
    step = fused.make_train_step(loss_fn)
    for _ in range(3):
        pf, sf, _ = step(pf, sf, c)
        two.step(pt, st, {"w": pt["w"] - c})
    assert torch.equal(pf["w"], pt["w"])
