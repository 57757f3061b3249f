# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The dry run's pieces and the dry run itself (``bluefog_tpu_torch.dryrun``)
against the JAX package on its 8-device CPU mesh, same numpy inputs.

- ``neighbor_allreduce_step`` on the one-peer Exp2 schedule at step indices
  0..5, and the hierarchical combines (static machine plan, its operands,
  the machine-level dynamic schedule) on the ``(machines 4, local 2)``
  mesh: f32, to 1e-6 of the inputs' scale (each side adds the same
  products in the same order; only the last bit may differ).
- ``MLP`` and ``MnistCNN``: forward and every parameter's gradient against
  flax from the same flax parameters (``interop.params_from_flax``), f32,
  rtol 1e-5 (atol 1e-5 of the largest entry).
- The closing test: the same initial parameters, batches, labels and step
  index through a copy of ``__graft_entry__._dryrun_body``'s ``train_step``
  under ``shard_map`` and through :class:`bluefog_tpu_torch.dryrun.DryRun`,
  three consecutive steps; parameters, momentum, metric and the ring
  attention that the metric takes times 0 to 1e-5 relative (f32 matmuls of
  12 x 16 x 10 in another order on each side).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu import topology as tu
from bluefog_tpu.collective import inner as jinner, plan as jplan
from bluefog_tpu.models import MLP as JMLP, MnistCNN as JMnistCNN
from bluefog_tpu.ops import ring_attention_block
from bluefog_tpu_torch import interop, topology as ttu
from bluefog_tpu_torch.collective import inner as tinner, plan as tplan
from bluefog_tpu_torch.dryrun import DryRun
from bluefog_tpu_torch.models import MLP, MnistCNN

SIZE = 8
AXES = ("machines", "local")


def _mesh2d(cpu_devices):
    return Mesh(np.array(cpu_devices[:SIZE]).reshape(4, 2), AXES)


def _run_mesh(mesh, body, *args, replicated=()):
    """``body`` per worker under ``shard_map``; args whose index is in
    ``replicated`` are passed whole."""
    spec = P(AXES if len(mesh.axis_names) == 2 else mesh.axis_names[0])
    in_specs = tuple(P() if i in replicated else spec for i in range(len(args)))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=spec))
    return np.asarray(fn(*args))


def _close(got, want, scale_tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale_tol * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("graph", ["exp2", "exponential"])
def test_neighbor_allreduce_step_matches_jax(cpu_devices, graph):
    jg = {"exp2": tu.ExponentialTwoGraph, "exponential": tu.ExponentialGraph}[graph](SIZE)
    tg = {"exp2": ttu.ExponentialTwoGraph, "exponential": ttu.ExponentialGraph}[graph](SIZE)
    js = jplan.schedule_from_dynamic(SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(jg, r))
    ts = tplan.schedule_from_dynamic(SIZE, lambda r: ttu.GetDynamicOnePeerSendRecvRanks(tg, r))
    mesh = Mesh(np.array(cpu_devices[:SIZE]), ("w",))
    x = np.random.RandomState(3).randn(SIZE, 37).astype(np.float32)
    body = lambda xb, st: jinner.neighbor_allreduce_step(xb[0], st[0], js, "w")[None]
    for step in range(6):
        want = _run_mesh(mesh, body, x, np.array([step], np.int32), replicated=(1,))
        got = tinner.neighbor_allreduce_step(torch.from_numpy(x), torch.tensor([step]), ts)
        _close(got.numpy(), want, 1e-6)
        # a plain int step and the step's own plan give the same result
        np.testing.assert_array_equal(
            tinner.neighbor_allreduce_step(torch.from_numpy(x), step, ts).numpy(), got.numpy())


def test_hierarchical_combines_match_jax(cpu_devices):
    mesh = _mesh2d(cpu_devices)
    jmp = jplan.plan_from_topology(tu.RingGraph(4), weighted=True)
    tmp = tplan.plan_from_topology(ttu.RingGraph(4), weighted=True)
    x = np.random.RandomState(4).randn(SIZE, 3, 5).astype(np.float32)
    tx = torch.from_numpy(x)
    want = _run_mesh(mesh, lambda xb: jinner.hierarchical_neighbor_allreduce(
        xb[0], jmp, "machines", "local")[None], x)
    _close(tinner.hierarchical_neighbor_allreduce(tx, tmp, 2).numpy(), want, 1e-6)
    # the same with the weights as operands
    self_w, recv_w = jmp.weight_operands()
    want_ops = _run_mesh(mesh, lambda xb: jinner.hierarchical_neighbor_allreduce_operands(
        xb[0], jmp.perms, jnp.asarray(self_w), jnp.asarray(recv_w), "machines", "local")[None],
        x)
    src, tself, trecv = tinner.plan_operands(tmp, "cpu")
    got_ops = tinner.hierarchical_neighbor_allreduce_operands(tx, src, tself, trecv, 2)
    _close(got_ops.numpy(), want_ops, 1e-6)
    # the machine-level one-peer Exp2 schedule at steps 0..3
    jms = jplan.schedule_from_dynamic(
        4, lambda m: tu.GetExp2DynamicSendRecvMachineRanks(SIZE, 2, 2 * m, 0))
    tms = tplan.schedule_from_dynamic(
        4, lambda m: ttu.GetExp2DynamicSendRecvMachineRanks(SIZE, 2, 2 * m, 0))
    body = lambda xb, st: jinner.hierarchical_neighbor_allreduce_step(
        xb[0], st[0], jms, "machines", "local")[None]
    for step in range(4):
        want_s = _run_mesh(mesh, body, x, np.array([step], np.int32), replicated=(1,))
        got_s = tinner.hierarchical_neighbor_allreduce_step(tx, torch.tensor(step), tms, 2)
        _close(got_s.numpy(), want_s, 1e-6)
    with pytest.raises(ValueError):
        tinner.hierarchical_neighbor_allreduce(tx[:7], tmp, 2)


def _torch_module(module, flax_params):
    module.load_state_dict(interop.params_from_flax(flax_params))
    return module


def _grads_close(module, jgrads):
    want = interop.params_from_flax(jgrads)
    for name, p in module.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("features", [(16, 10), (64, 32, 10)])
def test_mlp_forward_and_gradients_match_flax(features):
    rng = np.random.RandomState(5)
    x = rng.randn(6, 3, 4).astype(np.float32)
    w = rng.randn(6, features[-1]).astype(np.float32)
    jm = JMLP(features=features)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    loss = lambda p: (jm.apply({"params": p}, jnp.asarray(x)) * w).sum()
    jout = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    jgrads = jax.grad(loss)(params)
    tm = _torch_module(MLP(12, features), params)
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-6)
    _grads_close(tm, jgrads)


def test_mnist_cnn_forward_and_gradients_match_flax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 16).astype(np.float32)
    w = rng.randn(2, 10).astype(np.float32)
    jm = JMnistCNN(num_classes=10)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    loss = lambda p: (jm.apply({"params": p}, jnp.asarray(x)) * w).sum()
    jout = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    jgrads = jax.grad(loss)(params)
    tm = _torch_module(MnistCNN(num_classes=10, image=16), params)
    assert {n for n, _ in tm.named_parameters()} == set(interop.flatten_tree(params))
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-5)
    _grads_close(tm, jgrads)


def _jax_dryrun(cpu_devices, params, opt_state, batches, labels, steps):
    """A copy of ``__graft_entry__._dryrun_body``'s ``train_step`` under
    ``shard_map``, run for step indices ``0 .. steps - 1``; returns the
    parameters, optimizer state, metric and ring attention (which the body
    adds to the metric times 0; the copy returns it too) after each step."""
    n_devices = SIZE
    mesh = _mesh2d(cpu_devices)
    g = tu.ExponentialTwoGraph(n_devices)
    schedule = jplan.schedule_from_dynamic(
        n_devices, lambda r: tu.GetDynamicOnePeerSendRecvRanks(g, r))
    machine_plan = jplan.plan_from_topology(tu.RingGraph(4), weighted=True)
    model = JMLP(features=(16, 10))
    tx = optax.sgd(0.05, momentum=0.9)

    def train_step(params, opt_state, batch, labels, step):
        p = jax.tree_util.tree_map(lambda t: t[0], params)
        s = jax.tree_util.tree_map(lambda t: t[0], opt_state)
        x, y = batch[0], labels[0]

        def loss_fn(p):
            logits = model.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        p = jax.tree_util.tree_map(
            lambda t: jinner.neighbor_allreduce_step(t, step[0], schedule, AXES), p)
        metric = jinner.hierarchical_neighbor_allreduce(
            loss.reshape(1), machine_plan, "machines", "local")
        qkv = jnp.tanh(x[:1, :8]).reshape(1, 2, 2, 2)
        attn = ring_attention_block(qkv, qkv, qkv, AXES, causal=True)
        metric = metric + 0.0 * attn.sum()
        restack = functools.partial(jnp.expand_dims, axis=0)
        return (jax.tree_util.tree_map(restack, p), jax.tree_util.tree_map(restack, s),
                metric.reshape(1), restack(attn))

    spec = P(AXES)
    fn = jax.jit(jax.shard_map(train_step, mesh=mesh,
                               in_specs=(spec, spec, spec, spec, P()),
                               out_specs=(spec, spec, spec, spec)))
    out = []
    for i in range(steps):
        params, opt_state, metric, attn = fn(params, opt_state, batches, labels,
                                             jnp.array([i], jnp.int32))
        out.append((params, opt_state, np.asarray(metric), np.asarray(attn)))
    return out


def _unpack(sm, buffer):
    """``[size, width]`` packed rows -> ``{name: [size, *jax shape]}``."""
    b = buffer.detach().numpy()
    return {s.name: b[:, s.offset:s.offset + s.numel].reshape((b.shape[0],) + s.jax_shape)
            for s in sm.slots}


def test_dryrun_three_steps_match_jax(cpu_devices):
    run = DryRun(SIZE, device="cpu")
    model, tx = JMLP(features=(16, 10)), optax.sgd(0.05, momentum=0.9)
    sample = jnp.zeros((4, 12))
    per_worker = [model.init(jax.random.PRNGKey(r), sample) for r in range(SIZE)]
    params = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *per_worker)
    opt_state = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                       *[tx.init(p) for p in per_worker])
    rng = np.random.RandomState(0)
    batches = rng.randn(SIZE, 4, 12).astype(np.float32)
    labels = rng.randint(0, 10, size=(SIZE, 4))
    np.testing.assert_array_equal(run.batches.numpy(), batches)
    np.testing.assert_array_equal(run.labels.numpy(), labels)
    want = _jax_dryrun(cpu_devices, params, opt_state, batches, labels, 3)

    tparams = torch.stack([run.model.pack(interop.params_from_flax(p["params"]))
                           for p in per_worker])
    state = run.tx.init(tparams)
    for i, (jp, js, jmetric, jattn) in enumerate(want):
        tparams, state, metric, attn = run.step(tparams, state, torch.tensor([i]))
        assert metric.shape == (SIZE, 1) and attn.shape == jattn.shape == (SIZE, 1, 2, 2, 2)
        np.testing.assert_allclose(metric.numpy()[:, 0], jmetric, rtol=1e-5, atol=0)
        np.testing.assert_allclose(attn.numpy(), jattn, rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {i} ring attention")
        jflat = interop.flatten_tree(jax.device_get(jp)["params"])
        jtrace = interop.flatten_tree(jax.device_get(js[0].trace)["params"])
        got_p, got_t = _unpack(run.model, tparams), _unpack(run.model, state)
        for name in jflat:
            for got, ref in ((got_p[name], jflat[name]), (got_t[name], jtrace[name])):
                np.testing.assert_allclose(got, ref, rtol=1e-5,
                                           atol=1e-5 * float(np.abs(ref).max()),
                                           err_msg=f"step {i} {name}")
