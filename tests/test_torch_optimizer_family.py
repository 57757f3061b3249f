# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's gossip-optimizer family and ``make_train_step`` against the
JAX package's on the 8-device CPU mesh (4 machines x 2), same numpy inputs.

References and tolerances, case by case:

- ``opt.step`` trajectories (every factory x its wires, K = 3, schedules,
  per-step weights, the hierarchical path): JAX's ``opt.step`` fed the same
  gradients, 1e-6 of the largest parameter per step (XLA:CPU may contract
  the momentum update or the combine's accumulate into an FMA, which the
  port rounds as two operations; a quantized value moved across a rounding
  boundary would show as a whole quantum, far above that).
- ``make_train_step`` at fp32 and int8 on the static topology: JAX's
  ``make_train_step`` on the same quadratic loss, whose gradient
  ``w - c`` is one correctly rounded subtraction in both; same tolerance.
- ``make_train_step`` at int4, with a dynamic ``schedule``, and delayed
  int8: JAX's fused step fails its own bitwise and convergence tests on
  this jax for these, so they are held to JAX's two-program path
  (``jax.grad`` then ``opt.step``), same tolerance; delayed int8 is also
  run to convergence on JAX's ``quad_setup`` problem.
- fused against two-program in the port: bitwise, on the quadratic loss,
  a small ResNet (batch statistics per worker) and a small TransformerLM.
- ``adam`` against ``optax.adam``: 1e-6 relative.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
from bluefog_tpu.collective.plan import schedule_from_dynamic as jschedule
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective.plan import schedule_from_dynamic as tschedule
from bluefog_tpu_torch.models import StackedModel, TransformerLM, next_token_loss, resnet
from bluefog_tpu_torch.models import ResNet50

SIZE = 8
LOCAL = 2
STEPS = 3


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    # the JAX composite wire: JAX's optimizer with the Pallas wire inside
    # shard_map fails on this jax; the composite is bitwise the kernels
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE], nodes_per_machine=LOCAL)
    bft.init(device="cpu", nodes_per_machine=LOCAL)
    bf.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE), is_weighted=True)
    bf.set_machine_topology(tu.RingGraph(SIZE // LOCAL))
    bft.set_machine_topology(ttu.RingGraph(SIZE // LOCAL))
    yield
    bf.shutdown()
    bft.shutdown()


SHAPES = {"w": (333,), "a": {"kernel": (30, 40), "bias": (7,)}}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.randn(SIZE, *shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _jx(tree):
    return _map(lambda a: bf.worker_values(list(a)), tree)


def _tx(tree):
    return _map(lambda a: torch.from_numpy(np.array(a)), tree)


def _rows(tree):
    leaves = jax.tree_util.tree_leaves(_map(np.asarray, tree))
    return np.concatenate([np.asarray(leaf).reshape(SIZE, -1) for leaf in leaves], axis=1)


def _assert_close(got_tree, want_tree, scale, msg=""):
    np.testing.assert_allclose(_rows(got_tree), _rows(want_tree), rtol=0, atol=1e-6 * scale,
                               err_msg=msg)


def _jax_factory(name):
    return {
        "grad-allreduce": bf.DistributedGradientAllreduceOptimizer,
        "allreduce": bf.DistributedAllreduceOptimizer,
        "neighbor": bf.DistributedNeighborAllreduceOptimizer,
        "hierarchical": bf.DistributedHierarchicalNeighborAllreduceOptimizer,
        "atc": bf.DistributedAdaptThenCombineOptimizer,
        "awc": bf.DistributedAdaptWithCombineOptimizer,
    }[name]


def _torch_factory(name):
    return {
        "grad-allreduce": bft.DistributedGradientAllreduceOptimizer,
        "allreduce": bft.DistributedAllreduceOptimizer,
        "neighbor": bft.DistributedNeighborAllreduceOptimizer,
        "hierarchical": bft.DistributedHierarchicalNeighborAllreduceOptimizer,
        "atc": bft.DistributedAdaptThenCombineOptimizer,
        "awc": bft.DistributedAdaptWithCombineOptimizer,
    }[name]


def _pair(name, k=1, momentum=0.9):
    return (_jax_factory(name)(optax.sgd(0.1, momentum=momentum), num_steps_per_communication=k),
            _torch_factory(name)(bft.sgd(0.1, momentum=momentum),
                                 num_steps_per_communication=k))


# every factory with the wires it takes
CASES = [
    ("grad-allreduce", None), ("allreduce", None),
    ("neighbor", None), ("neighbor", "int8"), ("neighbor", "int4_ef"),
    ("atc", None), ("atc", "int8"), ("atc", "int4_ef"),
    ("awc", None), ("awc", "int4"), ("awc", "int8_ef"),
    ("hierarchical", None), ("hierarchical", "int8"), ("hierarchical", "int4"),
]


def _run_steps(jopt, topt, steps=STEPS, seed=0, configure=None):
    rng = np.random.RandomState(seed)
    params0 = _tree(rng, scale=2.0)
    grads = [_tree(rng) for _ in range(steps)]
    jp, tp = _jx(params0), _tx(params0)
    js, ts = jopt.init(jp), topt.init(tp)
    scale = np.abs(_rows(params0)).max()
    for step in range(steps):
        if configure is not None:
            configure(jopt, topt, step)
        jp, js = jopt.step(jp, js, _jx(grads[step]))
        tp, ts = topt.step(tp, ts, _tx(grads[step]))
        _assert_close(tp, jp, scale, f"step {step}")
    return tp, jp


@pytest.mark.parametrize("name,compression", CASES)
def test_step_trajectories_match_jax(name, compression):
    jopt, topt = _pair(name)
    jopt.compression = topt.compression = compression
    _run_steps(jopt, topt)


@pytest.mark.parametrize("name,compression", [("grad-allreduce", None), ("neighbor", "int8"),
                                              ("atc", "int4_ef"), ("hierarchical", None)])
def test_communication_every_third_step_matches_jax(name, compression):
    """K = 3: two local (or, for "grad", accumulating) calls, then one that
    communicates, twice over."""
    jopt, topt = _pair(name, k=3)
    jopt.compression = topt.compression = compression
    _run_steps(jopt, topt, steps=6)
    assert topt._comm_count == 2 and topt._step_count == 6


def test_grad_order_accumulates_between_communications():
    _j, topt = _pair("grad-allreduce", k=2, momentum=None)
    p = {"w": torch.zeros(SIZE, 3)}
    s = topt.init(p)
    g = torch.arange(SIZE * 3, dtype=torch.float32).reshape(SIZE, 3)
    topt.step(p, s, {"w": g.clone()})
    assert torch.equal(p["w"], torch.zeros(SIZE, 3))
    topt.step(p, s, {"w": g.clone()})
    want = -0.1 * (2 * g).mean(0, keepdim=True).expand(SIZE, 3)
    np.testing.assert_allclose(p["w"].numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["neighbor", "atc"])
def test_dynamic_schedule_matches_jax(name):
    jopt, topt = _pair(name)
    jopt.schedule = jschedule(SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(
        tu.ExponentialGraph(SIZE), r))
    topt.schedule = tschedule(SIZE, lambda r: ttu.GetDynamicOnePeerSendRecvRanks(
        ttu.ExponentialGraph(SIZE), r))
    _run_steps(jopt, topt, steps=4)


def test_machine_schedule_matches_jax():
    jopt, topt = _pair("hierarchical")
    machines = SIZE // LOCAL
    jopt.schedule = jschedule(machines, lambda m: tu.GetExp2DynamicSendRecvMachineRanks(
        SIZE, LOCAL, m * LOCAL, 0))
    topt.schedule = tschedule(machines, lambda m: ttu.GetExp2DynamicSendRecvMachineRanks(
        SIZE, LOCAL, m * LOCAL, 0))
    _run_steps(jopt, topt, steps=4)


def _one_peer(step):
    gens = [ttu.GetDynamicOnePeerSendRecvRanks(ttu.ExponentialGraph(SIZE), r)
            for r in range(SIZE)]
    for _ in range(step):
        for g in gens:
            next(g)
    pairs = [next(g) for g in gens]
    return ([1.0 / (len(recv) + 1) for _s, recv in pairs],
            [{i: 1.0 / (len(recv) + 1) for i in recv} for _s, recv in pairs],
            [list(send) for send, _r in pairs])


@pytest.mark.parametrize("compression", [None, "int8"])
def test_per_step_weights_match_jax(compression):
    """The reference idiom: reassign ``self_weight``/``src_weights``/
    ``dst_weights`` before every step (one-peer dynamic weights)."""
    jopt, topt = _pair("atc")
    jopt.compression = topt.compression = compression

    def configure(j, t, step):
        sw, src, dst = _one_peer(step)
        for opt in (j, t):
            opt.self_weight, opt.src_weights, opt.dst_weights = sw, src, dst

    _run_steps(jopt, topt, steps=4, configure=configure)


def test_explicit_machine_weights_match_jax():
    jopt, topt = _pair("hierarchical")
    machines = SIZE // LOCAL
    nbr = [{(m + 1) % machines: 0.25, (m - 1) % machines: 0.25} for m in range(machines)]
    send = [[(m + 1) % machines, (m - 1) % machines] for m in range(machines)]
    for opt in (jopt, topt):
        opt.neighbor_machine_weights, opt.send_neighbor_machines = nbr, send
    _run_steps(jopt, topt)


REFUSALS = [
    ("allreduce", "int8", "only supported"),
    ("grad-allreduce", "int4", "only supported"),
    ("hierarchical", "int8_ef", "error feedback"),
    ("allreduce", "int4_ef", "error feedback"),
    ("neighbor", "bf16_ef", "compression"),
]


@pytest.mark.parametrize("name,compression,match", REFUSALS)
def test_refusals_match_jax(name, compression, match):
    jopt, topt = _pair(name)
    jopt.compression = topt.compression = compression
    rng = np.random.RandomState(0)
    p, g = _tree(rng), _tree(rng)
    with pytest.raises(ValueError, match=match):
        jopt.step(_jx(p), jopt.init(_jx(p)), _jx(g))
    with pytest.raises(ValueError, match=match):
        topt.step(_tx(p), topt.init(_tx(p)), _tx(g))


def test_ef_refused_on_a_schedule_and_bad_k():
    _j, topt = _pair("neighbor")
    topt.compression = "int8_ef"
    topt.schedule = tschedule(SIZE, lambda r: ttu.GetDynamicOnePeerSendRecvRanks(
        ttu.ExponentialGraph(SIZE), r))
    p = _tx(_tree(np.random.RandomState(0)))
    with pytest.raises(ValueError, match="error feedback"):
        topt.step(p, topt.init(p), p)
    _j, topt = _pair("atc", k=0)
    with pytest.raises(ValueError, match="num_steps_per_communication"):
        topt.step(p, topt.init(p), p)
    with pytest.raises(ValueError, match="allreduce"):
        bft.optimizers._GossipOptimizer(bft.sgd(0.1), bft.CommunicationType.neighbor_allreduce,
                                        "grad")
    with pytest.raises(TypeError):
        bft.optimizers._GossipOptimizer(bft.sgd(0.1), "allreduce", "cta")


def test_schedule_refused_outside_neighbor_paths():
    _j, topt = _pair("allreduce")
    topt.schedule = tschedule(SIZE, lambda r: ttu.GetDynamicOnePeerSendRecvRanks(
        ttu.ExponentialGraph(SIZE), r))
    p = _tx(_tree(np.random.RandomState(0)))
    with pytest.raises(ValueError, match="schedule"):
        topt.step(p, topt.init(p), p)


# -- adam ------------------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9)])
def test_adam_matches_optax(kw):
    rng = np.random.RandomState(1)
    p0 = _tree(rng)
    tx_j, tx_t = optax.adam(0.01, **kw), bft.adam(0.01, **kw)
    jp = _map(jnp.asarray, p0)
    js = jax.vmap(tx_j.init)(jp)
    tp = _tx(p0)
    ts = tx_t.init(tp)
    upd = jax.jit(jax.vmap(tx_j.update))
    for _ in range(5):
        g = _tree(rng)
        u, js = upd(_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tx_t.apply_(tp, ts, _tx(g))
        np.testing.assert_allclose(_rows(tp), _rows(jp), rtol=1e-6, atol=1e-7)
    assert ts["count"].tolist() == [5] * SIZE


def test_adam_inside_the_gradient_allreduce_matches_jax():
    jopt = bf.DistributedGradientAllreduceOptimizer(optax.adam(0.01))
    topt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.01))
    _run_steps(jopt, topt, steps=4)


def test_sgd_schedule_matches_optax():
    rng = np.random.RandomState(2)
    p0, sched = _tree(rng), lambda c: 0.3 * 0.5 ** (c / 10)
    tx_j = optax.sgd(optax.exponential_decay(0.3, 10, 0.5), momentum=0.9)
    tx_t = bft.sgd(sched, momentum=0.9)
    jp, tp = _map(jnp.asarray, p0), _tx(p0)
    js, ts = jax.vmap(tx_j.init)(jp), tx_t.init(tp)
    upd = jax.jit(jax.vmap(tx_j.update))
    for _ in range(4):
        g = _tree(rng)
        u, js = upd(_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tx_t.apply_(tp, ts, _tx(g))
        np.testing.assert_allclose(_rows(tp), _rows(jp), rtol=1e-6, atol=1e-6)


# -- make_train_step --------------------------------------------------------------------------


def _quad_losses():
    """The same per-worker quadratic loss in both frameworks: the gradient
    ``p - c`` is one correctly rounded subtraction in each."""

    def jloss(p, c):
        return 0.5 * sum(jnp.sum((a - b) ** 2) for a, b in
                         zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(c)))

    def tloss(p, c):
        return 0.5 * sum(torch.sum((a - b) ** 2) for a, b in
                         zip(bft.optimizers.tree_leaves(p), bft.optimizers.tree_leaves(c)))

    return jloss, tloss


def _jax_two_program_step(jopt, jloss):
    grad = jax.jit(jax.vmap(jax.grad(jloss)))

    def step(p, s, c):
        return jopt.step(p, s, grad(p, c)) + (None,)

    return step


FUSED_VS_JAX = [
    # (factory, compression, reference): "fused" = JAX's make_train_step,
    # "two-program" = JAX's opt.step after jax.grad
    ("atc", None, "fused"), ("neighbor", None, "fused"), ("atc", "int8", "fused"),
    ("neighbor", "int8", "fused"), ("grad-allreduce", None, "fused"),
    ("allreduce", None, "fused"), ("atc", "int4", "two-program"),
    ("neighbor", "int8_ef", "two-program"), ("hierarchical", "int8", "two-program"),
]


@pytest.mark.parametrize("name,compression,reference", FUSED_VS_JAX)
def test_make_train_step_matches_jax(name, compression, reference):
    jopt, topt = _pair(name)
    jopt.compression = topt.compression = compression
    jloss, tloss = _quad_losses()
    rng = np.random.RandomState(3)
    p0, c = _tree(rng, scale=2.0), _tree(rng)
    jstep = (jopt.make_train_step(jloss) if reference == "fused"
             else _jax_two_program_step(jopt, jloss))
    tstep = topt.make_train_step(tloss)
    jp, tp = _jx(p0), _tx(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    scale = np.abs(_rows(p0)).max()
    for step in range(STEPS):
        jp, js, jl = jstep(jp, js, _jx(c))
        tp, ts, tl = tstep(tp, ts, _tx(c))
        _assert_close(tp, jp, scale, f"step {step}")
        if jl is not None:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_make_train_step_dynamic_schedule_matches_jax_two_program():
    jopt, topt = _pair("atc")
    jopt.schedule = jschedule(SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(
        tu.ExponentialGraph(SIZE), r))
    topt.schedule = tschedule(SIZE, lambda r: ttu.GetDynamicOnePeerSendRecvRanks(
        ttu.ExponentialGraph(SIZE), r))
    jloss, tloss = _quad_losses()
    rng = np.random.RandomState(4)
    p0, c = _tree(rng, scale=2.0), _tree(rng)
    jstep, tstep = _jax_two_program_step(jopt, jloss), topt.make_train_step(tloss)
    jp, tp = _jx(p0), _tx(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        jp, js, _ = jstep(jp, js, _jx(c))
        tp, ts, _ = tstep(tp, ts, _tx(c))
        _assert_close(tp, jp, np.abs(_rows(p0)).max(), f"step {step}")


def _bitwise(a_tree, b_tree):
    for a, b in zip(bft.optimizers.tree_leaves(a_tree), bft.optimizers.tree_leaves(b_tree)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


FUSED_CASES = CASES + [("atc", "int8_ef"), ("neighbor", "int4")]


@pytest.mark.parametrize("name,compression", FUSED_CASES)
@pytest.mark.parametrize("k", [1, 3])
def test_fused_equals_two_program_bitwise(name, compression, k):
    """The port's ``make_train_step`` against its own ``opt.step`` after
    the same per-worker gradients, every bit, K = 1 and K = 3."""
    _loss, tloss = _quad_losses()
    rng = np.random.RandomState(5)
    p0, c = _tree(rng, scale=2.0), _tree(rng)
    fused, two = (_torch_factory(name)(bft.sgd(0.1, momentum=0.9),
                                       num_steps_per_communication=k) for _ in range(2))
    fused.compression = two.compression = compression
    tstep = fused.make_train_step(tloss)
    pf, p2 = _tx(p0), _tx(p0)
    sf, s2 = fused.init(pf), two.init(p2)
    ct = _tx(c)
    for _ in range(2 * k + 1):
        pf, sf, loss = tstep(pf, sf, ct)
        # the quadratic loss's gradient, p - c, as autograd computes it
        grads = bft.optimizers._tree_unflatten(p2, [a - b for a, b in zip(
            bft.optimizers.tree_leaves(p2), bft.optimizers.tree_leaves(ct))])
        two.step(p2, s2, grads)
        _bitwise(pf, p2)
        assert loss.shape == (SIZE,)


def test_has_aux_returns_stacked_aux():
    _loss, tloss = _quad_losses()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    step = opt.make_train_step(lambda p, c: (tloss(p, c), {"n": p["w"].sum()}), has_aux=True)
    p = _tx(_tree(np.random.RandomState(6)))
    p, _s, (loss, aux) = step(p, opt.init(p), _tx(_tree(np.random.RandomState(7))))
    assert loss.shape == (SIZE,) and aux["n"].shape == (SIZE,)


# -- delayed ----------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["neighbor", "atc"])
def test_delayed_fp32_matches_jax(name):
    jopt, topt = _pair(name, momentum=None)
    jloss, tloss = _quad_losses()
    rng = np.random.RandomState(8)
    p0, c = _tree(rng, scale=2.0), _tree(rng)
    jstep = jopt.make_train_step(jloss, delayed=True)
    tstep = topt.make_train_step(tloss, delayed=True)
    jp, tp = _jx(p0), _tx(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        jp, js, _ = jstep(jp, js, _jx(c))
        tp, ts, _ = tstep(tp, ts, _tx(c))
        _assert_close(tp, jp, np.abs(_rows(p0)).max(), f"step {step}")


def test_delayed_matches_the_stale_mix_oracle():
    """``mix_k = s * p_k + N^T p_{k-1}``, ``p_{k+1} = mix_k - lr (p_k - c)``
    (CTA, the buffer seeded at ``p_0``)."""
    rng = np.random.RandomState(0)
    c = rng.randn(SIZE, 4).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.2))
    step = opt.make_train_step(lambda p, cv: 0.5 * torch.sum((p["w"] - cv) ** 2), delayed=True)
    w = bft.get_context().static_plan().weight_matrix()
    s_diag, n_part = np.diag(w).copy(), w - np.diag(np.diag(w))
    p = {"w": torch.from_numpy(c.copy())}
    st = opt.init(p)
    x = c.astype(np.float64).copy()
    buf = x.copy()
    for _ in range(5):
        p, st, _ = step(p, st, torch.from_numpy(c))
        mix = s_diag[:, None] * x + n_part.T @ buf
        buf, x = x, mix - 0.2 * (x - c)
    np.testing.assert_allclose(p["w"].numpy(), x, rtol=1e-5, atol=1e-6)


def test_delayed_int8_matches_jax_two_program_replay():
    """Delayed int8 against a replay of the stale mix through JAX's
    quantized combine (the JAX fused delayed int8 step fails its own
    convergence test on this jax): ``C`` is JAX's ``neighbor_allreduce``
    on the int8 wire of the buffer, the self weight ``1 - sum(recv_w)``."""
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    opt.compression = "int8"
    rng = np.random.RandomState(9)
    p0, c = rng.randn(SIZE, 1200).astype(np.float32) * 2, rng.randn(SIZE, 1200).astype(np.float32)
    step = opt.make_train_step(lambda p, cv: 0.5 * torch.sum((p - cv) ** 2), delayed=True)
    p = torch.from_numpy(p0.copy())
    s = opt.init(p)
    plan = bft.get_context().static_plan()
    sw = 1.0 - plan.weight_operands()[1].sum(0)
    x, buf = p0.copy(), p0.copy()
    for k in range(4):
        p, s, _ = step(p, s, torch.from_numpy(c))
        x = (x - np.float32(0.1) * (x - c)).astype(np.float32)  # ATC: update first
        comb = np.asarray(bf.neighbor_allreduce(bf.worker_values(list(buf)), compression="int8"))
        mixed = comb + sw[:, None].astype(np.float32) * (x - buf)
        buf, x = x, mixed
        np.testing.assert_allclose(p.numpy(), x, rtol=0, atol=1e-6 * np.abs(p0).max(),
                                   err_msg=f"step {k}")


@pytest.mark.parametrize("order", ["neighbor", "atc"])
def test_delayed_int8_converges_on_the_quad_problem(order):
    """JAX's ``quad_setup`` problem (``test_overlap.py``) with the same
    decaying learning rate: the global loss falls below 5% of its start."""
    rng = np.random.RandomState(0)
    c = rng.randn(SIZE, 4).astype(np.float32)
    opt = _torch_factory(order)(bft.sgd(lambda n: 0.3 * 0.5 ** (n / 10)))
    opt.compression = "int8"
    step = opt.make_train_step(lambda p, cv: 0.5 * torch.sum((p["w"] - cv) ** 2), delayed=True)
    p = {"w": torch.from_numpy(c.copy())}
    s = opt.init(p)

    def global_loss(w):
        return float(np.mean(0.5 * np.sum((w - c.mean(0)) ** 2, -1)))

    start = global_loss(p["w"].numpy())
    for _ in range(80):
        p, s, _ = step(p, s, torch.from_numpy(c))
    assert global_loss(p["w"].numpy()) < 0.05 * start


def test_delayed_refusals_match_jax():
    _jloss, tloss = _quad_losses()
    p = _tx(_tree(np.random.RandomState(0)))
    with pytest.raises(ValueError, match="delayed"):
        bft.DistributedGradientAllreduceOptimizer(bft.sgd(0.1)).make_train_step(
            tloss, delayed=True)
    with pytest.raises(ValueError, match="delayed"):
        bf.DistributedGradientAllreduceOptimizer(optax.sgd(0.1)).make_train_step(
            lambda q: 0.0, delayed=True)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    opt.compression = "int8_ef"
    with pytest.raises(ValueError, match="int8_ef"):
        opt.make_train_step(tloss, delayed=True)(p, opt.init(p), p)
    opt = bft.DistributedHierarchicalNeighborAllreduceOptimizer(bft.sgd(0.1))
    with pytest.raises(ValueError, match="hierarchical"):
        opt.make_train_step(tloss, delayed=True)(p, opt.init(p), p)


def test_bft_make_train_step_is_the_method():
    _jloss, tloss = _quad_losses()
    p0 = _tree(np.random.RandomState(1))
    a, b = (bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1)) for _ in range(2))
    pa, pb = _tx(p0), _tx(p0)
    sa, sb = a.init(pa), b.init(pb)
    bft.make_train_step(a, tloss)(pa, sa, pa)
    b.make_train_step(tloss)(pb, sb, pb)
    _bitwise(pa, pb)


# -- models through make_train_step ---------------------------------------------------------


def _model_fused_vs_two_program(sm, inputs, targets, loss_fn, steps=2, compression="int8"):
    """``steps`` fused steps, then the same steps through
    ``loss_and_grad`` + ``opt.step`` from the same parameters and batch
    statistics: every bit of the parameters, losses and statistics."""
    params0 = sm.replicate()
    params0 += 0.01 * torch.randn(params0.shape, generator=torch.Generator().manual_seed(0))
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    results = []
    for fused in (True, False):
        sm.load_buffers(stats0)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = compression
        p = params0.clone()
        s = opt.init(p)
        step = opt.make_train_step(loss_fn)
        losses = []
        for _ in range(steps):
            if fused:
                p, s, loss = step(p, s, inputs, targets, torch.arange(SIZE))
            else:
                loss, g = sm.loss_and_grad(p, inputs, targets)
                opt.step(p, s, g)
            losses.append(loss.clone())
        results.append((p, torch.stack(losses), {k: v.clone() for k, v in sm.buffers.items()}))
    (pf, lf, bf_), (p2, l2, b2) = results
    assert torch.equal(pf.view(torch.int32), p2.view(torch.int32))
    assert torch.equal(lf, l2)
    for k in bf_:
        assert torch.equal(bf_[k], b2[k])
    assert torch.isfinite(pf).all()


def test_resnet_worker_loss_through_make_train_step():
    model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                           stage_sizes=[1, 1, 1, 1]), 0)
    sm = StackedModel(model, SIZE, "cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    _model_fused_vs_two_program(sm, images, labels, sm.worker_loss)


def test_transformer_worker_loss_through_make_train_step():
    from bluefog_tpu_torch.models import transformer

    model = transformer.init_flax_like(TransformerLM(vocab=64, dim=32, heads=4, layers=2,
                                                     max_len=16), 0)
    sm = StackedModel(model, SIZE, "cpu", loss=next_token_loss)
    tokens = torch.randint(0, 64, (SIZE, 2, 16), generator=torch.Generator().manual_seed(2))
    _model_fused_vs_two_program(sm, tokens, tokens,
                                lambda row, x, y, _w: sm.worker_loss(row, x, y),
                                compression="int4_ef")


def test_worker_loss_needs_the_worker_with_batch_statistics():
    model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                           stage_sizes=[1, 1, 1, 1]), 0)
    sm = StackedModel(model, SIZE, "cpu")
    with pytest.raises(ValueError, match="worker"):
        sm.worker_loss(sm.replicate()[0], torch.zeros(1, 32, 32, 3), torch.zeros(1).long())
