# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's gossip optimizers and training step against the JAX
package's, on the 8-device CPU mesh, same numpy inputs.

- Optimizer parity: ``DistributedAdaptThenCombineOptimizer`` (ATC) and
  ``DistributedNeighborAllreduceOptimizer`` (CTA) over ``sgd(0.1, 0.9)``
  with ``compression`` None, int8 and int4, fed identical gradients for
  three steps, on a tree whose leaves are ordered differently from their
  insertion order and whose 512-element wire blocks span leaf boundaries.
  Tolerance 1e-6 relative to the largest parameter: XLA:CPU may contract
  the momentum update ``g + 0.9 * trace`` and the accumulate of the
  combine into FMAs, which the port (and its CUDA kernels, built with
  -fmad=false) round as separate operations; a quantized value that lands
  on the other side of a rounding boundary would show as a whole quantum,
  far above that, so the wire bits agree.
- End to end: three steps of the small ResNet of ``test_torch_resnet``
  on 8 workers, the JAX weights carried over. Losses within rtol 1e-4;
  parameters within one int8 quantum (the largest block scale) per step,
  since float32 gradients that differ in the last bits can move a
  quantized value by one step.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import interop
from bluefog_tpu_torch.models import StackedModel

import test_torch_resnet as tr

SIZE = 8
STEPS = 3


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    # the JAX composite wire: this jax's shard_map refuses the Pallas
    # kernels' outputs inside a compiled step (no ``vma`` on their
    # shapes), and the composite is pinned bitwise to the kernels by the
    # JAX package's own tests
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.shutdown()
    bft.shutdown()


SHAPES = {
    "w": (333,),
    "a": {"kernel": (30, 40), "bias": (7,)},
    "Bn": {"scale": (16,)},
}


def _tree(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.randn(SIZE, *shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat_worker_rows(tree):
    """``[SIZE, n]`` in ``jax.tree_util`` leaf order."""
    leaves = jax.tree_util.tree_leaves(_map(np.asarray, tree))
    return np.concatenate([leaf.reshape(SIZE, -1) for leaf in leaves], axis=1)


def _optimizers(order):
    if order == "atc":
        return (bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1, momentum=0.9)),
                bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9)))
    return (bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1, momentum=0.9)),
            bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9)))


@pytest.mark.parametrize("compression", [None, "int8", "int4"])
@pytest.mark.parametrize("order", ["atc", "cta"])
def test_optimizer_trajectories_match(contexts, order, compression):
    rng = np.random.RandomState(0)
    params0 = _tree(rng, SHAPES, 2.0)
    grads = [_tree(rng, SHAPES, 1.0) for _ in range(STEPS)]
    jopt, topt = _optimizers(order)
    jopt.compression = topt.compression = compression

    jp = _map(lambda a: bf.worker_values(list(a)), params0)
    js = jopt.init(jp)
    tp = _map(lambda a: torch.from_numpy(a.copy()), params0)
    ts = topt.init(tp)
    scale = np.abs(_flat_worker_rows(params0)).max()
    for step in range(STEPS):
        jp, js = jopt.step(jp, js, _map(lambda a: bf.worker_values(list(a)), grads[step]))
        tp, ts = topt.step(tp, ts, _map(torch.from_numpy, grads[step]))
        got, want = _flat_worker_rows(tp), _flat_worker_rows(jp)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"step {step}")


def test_optimizer_rejects_unknown_compression(contexts):
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    opt.compression = "bf16_ef"
    p = {"w": torch.zeros(SIZE, 4)}
    with pytest.raises(ValueError):
        opt.step(p, opt.init(p), {"w": torch.zeros(SIZE, 4)})


def _jax_loss_and_grad():
    """Per-worker loss, new batch statistics and gradient of the flax
    model, computed in float64 and handed back as float32 numpy."""
    with jax.enable_x64(True):
        model = tr.JResNet(stage_sizes=tr.STAGES, block_cls=tr.JBottleneck,
                           num_classes=tr.CLASSES, num_filters=tr.FILTERS,
                           dtype=jnp.float64)

        def loss_grad(p, s, x, y):
            def loss_fn(p):
                logits, mutated = model.apply(
                    {"params": p, "batch_stats": s}, x, train=True,
                    mutable=["batch_stats"],
                )
                loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
                return loss, mutated["batch_stats"]

            (loss, new_s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            return loss, new_s, g

        fn = jax.jit(jax.vmap(loss_grad))

    def run(p, s, x, y):
        with jax.enable_x64(True):
            f64 = lambda t: _map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
            out = fn(f64(p), f64(s), jnp.asarray(x, jnp.float64), jnp.asarray(y))
            return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)

    return run


def _rows(tree):
    """Per-worker flat rows of a worker-stacked tree, in leaf order."""
    return _flat_worker_rows(tree) if isinstance(tree, dict) else np.concatenate(
        [np.asarray(leaf).reshape(SIZE, -1) for leaf in jax.tree_util.tree_leaves(tree)],
        axis=1,
    )


@pytest.mark.parametrize("order,compression", [("atc", "int8")])
def test_resnet_training_steps_match(contexts, order, compression):
    """Three training steps of 8 workers, each checked from the same
    state: after every step the port's parameters, momentum and batch
    statistics are set to the JAX side's. Unsynchronised, the two drift
    apart: this small network under sgd(0.1, 0.9) amplifies a one-quantum
    difference in one weight twentyfold per step. The JAX gradient is
    taken in float64 (see ``test_torch_resnet``)."""
    params, stats = tr.carried_variables(seed=4)
    rng = np.random.RandomState(5)
    image = 32
    images = rng.randn(SIZE, 4, image, image, 3).astype(np.float32)
    labels = rng.randint(0, tr.CLASSES, (SIZE, 4)).astype(np.int32)

    stack = lambda a: np.broadcast_to(a, (SIZE,) + a.shape).copy()
    jparams = _map(lambda a: bf.worker_values(list(stack(a))), params)
    jstats = _map(stack, stats)
    jopt, topt = _optimizers(order)
    jopt.compression = topt.compression = compression
    jstate = jopt.init(jparams)
    loss_grad = _jax_loss_and_grad()

    sm = StackedModel(tr.port_model(), SIZE, "cpu")
    sm.load_buffers(interop.batch_stats_from_flax(stats))
    tparams = sm.pack(interop.params_from_flax(params)).repeat(SIZE, 1).contiguous()
    tstate = topt.init(tparams)
    timages, tlabels = torch.from_numpy(images), torch.from_numpy(labels).long()
    n = sm.n_params

    for step in range(STEPS):
        jloss, jstats, jgrads = loss_grad(jparams, jstats, images, labels)
        jparams, jstate = jopt.step(
            jparams, jstate, _map(lambda a: bf.worker_values(list(a)), jgrads)
        )
        tloss, tgrads = sm.loss_and_grad(tparams, timages, tlabels)
        tparams, tstate = topt.step(tparams, tstate, tgrads)

        np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-4, err_msg=f"step {step}")
        want = _rows(jparams)
        diff = np.abs(tparams[:, :n].numpy() - want)
        quantum = np.abs(want).max() / 127
        assert diff.max() <= quantum, f"step {step}"
        # a quantized value one step off is rare (about 1e-4 of them, in
        # blocks of small scale): the wire bits agree elsewhere
        assert (diff > 1e-4).mean() < 1e-3, f"step {step}"
        for name, buf in sm.buffers.items():
            mod, leaf = name.rsplit(".", 1)
            want_stat = jstats
            for key in mod.split("."):
                want_stat = want_stat[key]
            np.testing.assert_allclose(buf.numpy(), want_stat[leaf], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} step {step}")

        tparams[:, :n] = torch.from_numpy(want)
        tstate[:, :n] = torch.from_numpy(_rows(jstate))
        sm.load_buffers({k: torch.from_numpy(np.asarray(v)) for k, v in
                         interop.flatten_tree(jstats).items()})
