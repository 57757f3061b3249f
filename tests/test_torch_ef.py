# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's error-feedback gossip (``int8_ef`` / ``int4_ef``, CHOCO
copies) against the JAX package's, same numpy inputs.

The JAX side runs its composite wire (``BLUEFOG_WIRE_KERNELS=0``): this
jax's ``shard_map`` refuses the Pallas kernels' outputs inside a compiled
program, and the JAX package's own tests pin the composite to the
kernels. Tolerances, where a result is not bitwise:

- the copies ``h + q * s``: bitwise for int4 (a nibble times a bf16
  scale is exact in f32); for int8 XLA:CPU may contract the add into an
  FMA, which the port (and its CUDA kernels, built with -fmad=false)
  rounds as two operations: one ulp of the product and one of the sum;
- the accumulate ``y + (hat_r - xhat_self) * w`` may contract in both
  tiers: one ulp of each round's product and partial sum;
- trajectories amplify ulps (a value one ulp off can land on the other
  side of a rounding boundary of the quantizer a step later), so they
  are held as ``test_torch_train`` holds the int8 wire: losses at rtol
  1e-4 over three steps, re-synchronised after each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
from bluefog_tpu.collective import inner as jinner, plan as jplan
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import interop, topology as ttu
from bluefog_tpu_torch.collective import inner as tinner
from bluefog_tpu_torch.collective.plan import plan_from_topology
from bluefog_tpu_torch.models import StackedModel

import test_torch_resnet as tr
import test_torch_train as tt

SIZE = 8
AXIS = "workers"
WIRES = ["int8", "int4"]


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.shutdown()
    bft.shutdown()


def _ulp_bound(*terms):
    return sum(np.spacing(np.abs(t)) for t in terms)


def _jax_ef_combine(x, e_self, e_recv, perms, recv_w, wire):
    """One call of the JAX CHOCO combine on the 8-device CPU mesh."""
    mesh = jax.make_mesh((SIZE,), (AXIS,))

    def body(t, es, er):
        y, (es2, er2) = jinner.weighted_combine_quantized_ef_operands(
            t[0], (es[0], er[0]), perms, jnp.asarray(recv_w), AXIS, wire=wire,
        )
        return y[None], es2[None], er2[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS),) * 3,
                               out_specs=(P(AXIS),) * 3))
    return [np.asarray(o) for o in fn(x, e_self, e_recv)]


@pytest.mark.parametrize("topo", ["exp2", "star"])
@pytest.mark.parametrize("wire", WIRES)
def test_ef_combine_matches_jax(contexts, wire, topo):
    """One call from the same random copies: output and both copies."""
    jgen, tgen = {"exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
                  "star": (tu.StarGraph, ttu.StarGraph)}[topo]
    jp = jplan.plan_from_topology(jgen(SIZE), weighted=True)
    tp = plan_from_topology(tgen(SIZE), weighted=True)
    assert jp.perms == tp.perms
    src, _self_w, recv_w = tinner.plan_operands(tp, "cpu")
    n_rounds = src.shape[0]
    rng = np.random.RandomState(20)
    n = 1500  # not a whole number of blocks
    x = (rng.randn(SIZE, n) * 3).astype(np.float32)
    e_self = (x + rng.randn(SIZE, n) * 0.1).astype(np.float32)
    e_recv = np.stack([e_self[np.maximum(src[r].numpy(), 0)] for r in range(n_rounds)], 1)
    y_j, es_j, er_j = _jax_ef_combine(x, e_self, e_recv, jp.perms, recv_w.numpy(), wire)

    state = interop.ef_state_from_jax([(e_self, e_recv)])[0]
    y = tinner.weighted_combine_quantized_ef_operands(
        torch.from_numpy(x), state, src, recv_w, wire=wire)
    (es_t, er_t), = interop.ef_state_to_jax([state], [n])
    if wire == "int4":
        np.testing.assert_array_equal(es_t.view(np.uint32), es_j.view(np.uint32))
        np.testing.assert_array_equal(er_t.view(np.uint32), er_j.view(np.uint32))
    else:
        dhat = es_t - e_self  # each copy's one integration step
        assert (np.abs(es_t - es_j) <= _ulp_bound(dhat, es_t)).all()
        assert (np.abs(er_t - er_j) <= _ulp_bound(er_t - e_recv, er_t)).all()
    # per round: the two sides' copies (within the bounds above, zero for
    # int4) times the weight, then one ulp of the product and of the sum
    bound = np.zeros_like(x)
    partial = x.copy()
    for r in range(n_rounds):
        w = recv_w[r].numpy()[:, None]
        term = (er_t[:, r] - es_t) * w
        partial = partial + term
        copies = np.abs(er_t[:, r] - er_j[:, r]) + np.abs(es_t - es_j)
        bound += 2 * copies * w + _ulp_bound(term, partial)
    assert (np.abs(y.numpy() - y_j) <= bound).all()


SHAPES = tt.SHAPES


@pytest.mark.parametrize("compression", ["int8_ef", "int4_ef"])
@pytest.mark.parametrize("order", ["atc", "cta"])
def test_ef_optimizer_trajectories_match(contexts, order, compression):
    """Three steps on a multi-leaf tree whose wire blocks span leaf
    boundaries, fed identical gradients: parameters and the copies
    within 1e-6 of the largest parameter (the FMA ulps above; a value
    across a rounding boundary would show as a whole quantum of the
    difference, far above that)."""
    rng = np.random.RandomState(21)
    params0 = tt._tree(rng, SHAPES, 2.0)
    grads = [tt._tree(rng, SHAPES, 1.0) for _ in range(3)]
    jopt, topt = tt._optimizers(order)
    jopt.compression = topt.compression = compression
    jp = tt._map(lambda a: bf.worker_values(list(a)), params0)
    js = jopt.init(jp)
    tp = tt._map(lambda a: torch.from_numpy(a.copy()), params0)
    ts = topt.init(tp)
    scale = np.abs(tt._flat_worker_rows(params0)).max()
    n = tt._flat_worker_rows(params0).shape[1]
    for step in range(3):
        jp, js = jopt.step(jp, js, tt._map(lambda a: bf.worker_values(list(a)), grads[step]))
        tp, ts = topt.step(tp, ts, tt._map(torch.from_numpy, grads[step]))
        np.testing.assert_allclose(tt._flat_worker_rows(tp), tt._flat_worker_rows(jp),
                                   rtol=0, atol=1e-6 * scale, err_msg=f"step {step}")
        (es_t, er_t), = interop.ef_state_to_jax(topt._ef, [n])
        (es_j, er_j), = jopt._ef
        np.testing.assert_allclose(es_t, np.asarray(es_j), rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(er_t, np.asarray(er_j), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("compression", ["int8_ef", "int4_ef"])
@pytest.mark.parametrize("order", ["atc", "cta"])
def test_ef_resnet_training_steps_match(contexts, order, compression):
    """Three training steps of the small ResNet on 8 workers against the
    JAX optimizer, each from the same state (the port's parameters,
    momentum, batch statistics and copies set to the JAX side's after
    every step). Losses within rtol 1e-4; parameters within one quantum
    of the largest block scale, the copies likewise."""
    params, stats = tr.carried_variables(seed=6)
    rng = np.random.RandomState(7)
    image = 32
    images = rng.randn(SIZE, 4, image, image, 3).astype(np.float32)
    labels = rng.randint(0, tr.CLASSES, (SIZE, 4)).astype(np.int32)
    stack = lambda a: np.broadcast_to(a, (SIZE,) + a.shape).copy()
    jparams = tt._map(lambda a: bf.worker_values(list(stack(a))), params)
    jstats = tt._map(stack, stats)
    jopt, topt = tt._optimizers(order)
    jopt.compression = topt.compression = compression
    jstate = jopt.init(jparams)
    loss_grad = tt._jax_loss_and_grad()

    sm = StackedModel(tr.port_model(), SIZE, "cpu")
    sm.load_buffers(interop.batch_stats_from_flax(stats))
    tparams = sm.pack(interop.params_from_flax(params)).repeat(SIZE, 1).contiguous()
    tstate = topt.init(tparams)
    timages, tlabels = torch.from_numpy(images), torch.from_numpy(labels).long()
    n = sm.n_params
    levels = 7 if compression == "int4_ef" else 127
    for step in range(3):
        jloss, jstats, jgrads = loss_grad(jparams, jstats, images, labels)
        jparams, jstate = jopt.step(
            jparams, jstate, tt._map(lambda a: bf.worker_values(list(a)), jgrads))
        tloss, tgrads = sm.loss_and_grad(tparams, timages, tlabels)
        tparams, tstate = topt.step(tparams, tstate, tgrads)

        np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-4, err_msg=f"step {step}")
        want = tt._rows(jparams)
        assert np.abs(tparams[:, :n].numpy() - want).max() <= np.abs(want).max() / levels
        (es_j, er_j), = jopt._ef
        (es_t, er_t), = interop.ef_state_to_jax(topt._ef, [n])
        assert np.abs(es_t - np.asarray(es_j)).max() <= np.abs(es_j).max() / levels
        assert np.abs(er_t - np.asarray(er_j)).max() <= np.abs(er_j).max() / levels

        tparams[:, :n] = torch.from_numpy(want)
        tstate[:, :n] = torch.from_numpy(tt._rows(jstate))
        topt._ef = interop.ef_state_from_jax(jopt._ef)
        sm.load_buffers({k: torch.from_numpy(np.asarray(v)) for k, v in
                         interop.flatten_tree(jstats).items()})


@pytest.mark.parametrize("graph", ["exp", "exp2"])
@pytest.mark.parametrize("compression", ["int8_ef", "int4_ef"])
def test_copy_identity_after_ten_steps(compression, graph):
    """The invariant the tiers rest on: after any number of steps every
    receiver's copy of its round-``r`` source equals that source's own
    copy bit for bit, ``xhat_recv[r][j] == xhat_self[src[r, j]]``."""
    bft.init(device="cpu")
    try:
        if graph == "exp2":
            bft.set_topology(ttu.ExponentialTwoGraph(SIZE), is_weighted=True)
        rng = np.random.RandomState(22)
        params = {"a": torch.from_numpy(rng.randn(SIZE, 700).astype(np.float32)),
                  "b": torch.from_numpy(rng.randn(SIZE, 33, 20).astype(np.float32))}
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05, momentum=0.9))
        opt.compression = compression
        state = opt.init(params)
        for _ in range(10):
            grads = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
                     for k, v in params.items()}
            opt.step(params, state, grads)
        src = bft.get_context().static_plan().sources()
        (xhat_self, xhat_recv), = opt._ef
        assert xhat_self.abs().max() > 0
        for r in range(src.shape[0]):
            for j in range(SIZE):
                assert torch.equal(xhat_recv[r][j].view(torch.int32),
                                   xhat_self[src[r, j]].view(torch.int32)), (r, j)
    finally:
        bft.shutdown()


def test_ef_state_resets_on_topology_change():
    """A new edge set changes every round's source, so the copies are
    rebuilt (zeroed), and the gossip still reaches the exact mean."""
    bft.init(device="cpu")
    try:
        c = np.random.RandomState(9).randn(SIZE, 16).astype(np.float32)
        zero = {"w": torch.zeros(SIZE, 16)}
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
        opt.compression = "int8_ef"
        params = {"w": torch.from_numpy(c.copy())}
        state = opt.init(params)
        for _ in range(10):
            opt.step(params, state, zero)
        ef_before = opt._ef
        assert len(ef_before[0][1]) == 3  # Exp(8): 3 rounds
        bft.set_topology(ttu.RingGraph(SIZE))
        opt.step(params, state, zero)
        assert opt._ef is not ef_before and len(opt._ef[0][1]) == 2
        for _ in range(59):
            opt.step(params, state, zero)
        np.testing.assert_allclose(params["w"].numpy(), np.tile(c.mean(0), (SIZE, 1)), atol=5e-3)
        opt.compression = "int4_ef"  # a new tier starts from zeroed copies too
        ef_ring = opt._ef
        opt.step(params, state, zero)
        assert opt._ef is not ef_ring
    finally:
        bft.shutdown()


def test_ef_converges_below_plain_int4_floor():
    """What the memory buys: 60 rounds at lr = 0 on the default Exp(8)
    graph, int4_ef against the memoryless int4 wire: the worker mean is
    kept and the spread falls far below int4's noise floor (the chip
    smoke run gates the ratio at 100x)."""
    bft.init(device="cpu")
    try:
        x0 = torch.from_numpy(np.random.RandomState(23).randn(SIZE, 4096).astype(np.float32))
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
        opt.compression = "int4_ef"
        p = {"w": x0.clone()}
        state = opt.init(p)
        plain = x0.clone()
        for _ in range(60):
            opt.step(p, state, {"w": torch.zeros_like(x0)})
            plain = bft.neighbor_allreduce(plain, compression="int4")
        spread = lambda t: float((t - t.mean(0)).abs().max())
        assert spread(p["w"]) * 100 <= spread(plain)
        assert float((p["w"].mean(0) - x0.mean(0)).abs().max()) <= 1e-5 * float(x0.abs().max())
    finally:
        bft.shutdown()


def test_ef_combine_refuses_what_does_not_apply():
    src = torch.tensor([[1, 0]], dtype=torch.int32)
    w = torch.full((1, 2), 0.5)
    state = tinner.ef_state_zeros(2, 512, 1, "cpu")
    x = torch.zeros(2, 512)
    with pytest.raises(ValueError):
        tinner.weighted_combine_quantized_ef_operands(x.double(), state, src, w)
    with pytest.raises(ValueError):
        tinner.weighted_combine_quantized_ef_operands(torch.zeros(2, 600), state, src, w)
    with pytest.raises(ValueError):
        tinner.weighted_combine_quantized_ef_operands(x, state, src, w, wire="int8_ef")


def test_interop_ef_round_trip():
    rng = np.random.RandomState(24)
    jax_state = [(rng.randn(SIZE, 700).astype(np.float32),
                  rng.randn(SIZE, 3, 700).astype(np.float32))]
    port = interop.ef_state_from_jax(jax_state)
    assert port[0][0].shape == (SIZE, 1024) and port[0][1].shape == (3, SIZE, 1024)
    assert not port[0][0][:, 700:].any() and not port[0][1][:, :, 700:].any()
    torch.testing.assert_close(port[0][1][2][:, :700], torch.from_numpy(jax_state[0][1][:, 2]))
    back, = interop.ef_state_to_jax(port, [700])
    np.testing.assert_array_equal(back[0], jax_state[0][0])
    np.testing.assert_array_equal(back[1], jax_state[0][1])
