# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's ResNet (``bluefog_tpu_torch.models``) against the flax model
of the JAX package, with the JAX model's weights carried over by
``bluefog_tpu_torch.interop``.

A small BottleneckBlock ResNet (one block per stage, 8 filters, 64x64
images, so the last stage still normalises over 2x2 pixels) with float32
compute: the point is the algorithm (asymmetric ``SAME`` padding, flax
BatchNorm, parameter order and layouts), not bf16 rounding. Tolerances:
rtol 1e-4 / atol 1e-5 for logits and gradients, which run through other
convolution algorithms (f32 sums in another order), and 1e-5 for the
BatchNorm statistics.

The training-step reference is the flax model in float64: XLA:CPU's own
float32 gradient of the stem (``conv_init``, ``bn_init``) is off from the
float64 one by up to 2e-3 at this size, while the port's float32 gradient
is within 4e-6 of it, so the float32 JAX gradient is no yardstick there.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

from bluefog_tpu.models import resnet as jresnet
from bluefog_tpu.models.resnet import BottleneckBlock as JBottleneck
from bluefog_tpu.models.resnet import ResNet as JResNet
from bluefog_tpu_torch import interop
from bluefog_tpu_torch.models import BasicBlock, BottleneckBlock, ResNet, ResNet50, StackedModel
from bluefog_tpu_torch.models.resnet import same_padding

STAGES = [1, 1, 1, 1]
FILTERS = 8
CLASSES = 10
IMAGE = 64
BATCH = 8


BLOCKS = {"bottleneck": (JBottleneck, BottleneckBlock),
          "basic": (jresnet.BasicBlock, BasicBlock)}


def jax_model(block="bottleneck"):
    return JResNet(stage_sizes=STAGES, block_cls=BLOCKS[block][0],
                   num_classes=CLASSES, num_filters=FILTERS, dtype=jnp.float32)


def port_model(block="bottleneck"):
    return ResNet(stage_sizes=STAGES, block_cls=BLOCKS[block][1],
                  num_classes=CLASSES, num_filters=FILTERS, dtype=torch.float32)


def carried_variables(seed=0, block="bottleneck"):
    """flax variables with every BatchNorm scale, bias and statistic
    randomised, so no branch is zeroed out (the flax init zeroes the last
    scale of each block) and the running statistics matter in eval."""
    init = jax.jit(functools.partial(jax_model(block).init, train=True))
    variables = init(jax.random.PRNGKey(seed), jnp.ones((1, IMAGE, IMAGE, 3)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    def jitter(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = jitter(v)
            elif k == "scale" or k == "var":
                out[k] = (1.0 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return jitter(params), jitter(stats)


def images_labels(seed=1, n=BATCH):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, IMAGE, IMAGE, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, n).astype(np.int32)
    return x, y


def stacked(params, stats, size=1, block="bottleneck"):
    sm = StackedModel(port_model(block), size, "cpu")
    row = sm.pack(interop.params_from_flax(params))
    sm.load_buffers(interop.batch_stats_from_flax(stats))
    return sm, row.unsqueeze(0).repeat(size, 1).contiguous()


def close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "size,kernel,stride,want",
    [(224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)), (7, 1, 1, (0, 0))],
)
def test_same_padding_is_xla_rule(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want


def test_parameter_names_and_order_match_flax():
    """The flat buffer lays leaves out in ``jax.tree_util`` order: the
    port's slots, walked in order, are the flax leaves of the same path
    and JAX shape, so packing equals ``ravel_pytree``."""
    params, stats = carried_variables()
    sm, row = stacked(params, stats)
    jleaves = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [".".join(k.key for k in path) for path, _ in jleaves]
    assert [s.name for s in sm.slots] == names
    assert [s.jax_shape for s in sm.slots] == [leaf.shape for _, leaf in jleaves]
    flat, _ = ravel_pytree(params)
    assert sm.n_params == flat.size and sm.width % 512 == 0
    np.testing.assert_array_equal(row[0, :sm.n_params].numpy(), np.asarray(flat))
    assert not row[0, sm.n_params:].any()


def test_resnet50_layout_matches_flax():
    """At full width: ResNet50's parameter names, order and JAX shapes
    are those of the flax ResNet50 (25 557 032 parameters at 1000
    classes), so its flat buffer is the JAX optimizer's packed payload."""
    shapes = jax.eval_shape(
        functools.partial(jresnet.ResNet50(num_classes=1000).init, train=True),
        jax.random.PRNGKey(0), jnp.ones((1, 224, 224, 3)),
    )["params"]
    jleaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    with torch.device("meta"):
        model = ResNet50(num_classes=1000)
    sm = StackedModel(model, 1, "meta")
    assert [s.name for s in sm.slots] == [".".join(k.key for k in p) for p, _ in jleaves]
    assert [s.jax_shape for s in sm.slots] == [leaf.shape for _, leaf in jleaves]
    assert sm.n_params == 25_557_032 and sm.width == 25_557_504


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_eval_logits_match(block):
    params, stats = carried_variables(block=block)
    x, _ = images_labels()
    want = jax_model(block).apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=False)
    sm, row = stacked(params, stats, block=block)
    got = sm.forward(row, torch.from_numpy(x)[None], train=False)[0]
    close(got.numpy(), want)


def test_train_logits_grads_and_batch_stats_match():
    """One training forward and backward: the loss, its gradient (in the
    flat JAX layout) and the updated BatchNorm statistics."""
    params, stats = carried_variables(seed=2)
    x, y = images_labels(seed=3)
    with jax.enable_x64(True):
        model = JResNet(stage_sizes=STAGES, block_cls=JBottleneck,
                        num_classes=CLASSES, num_filters=FILTERS,
                        dtype=jnp.float64)
        f64 = lambda tree: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree
        )

        def loss_fn(p):
            logits, mutated = model.apply(
                {"params": p, "batch_stats": f64(stats)},
                jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"],
            )
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(y)
            ).mean()
            return loss, mutated["batch_stats"]

        (loss, new_stats), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True)
        )(f64(params))
        gflat = np.asarray(ravel_pytree(grads)[0])
        new_stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), new_stats
        )
    sm, row = stacked(params, stats)
    losses, g = sm.loss_and_grad(row, torch.from_numpy(x)[None],
                                 torch.from_numpy(y).long()[None])
    close(losses[0].item(), float(loss))
    close(g[0, :sm.n_params].numpy(), gflat)
    assert not g[0, sm.n_params:].any()
    want_stats = interop.batch_stats_from_flax(new_stats)
    for name, buf in sm.buffers.items():
        np.testing.assert_allclose(buf[0].numpy(), want_stats[name].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_interop_layouts():
    """HWIO -> OIHW for convs, ``[in, out]`` -> ``[out, in]`` for dense."""
    params, _ = carried_variables()
    t = interop.params_from_flax(params)
    k = params["conv_init"]["kernel"]
    np.testing.assert_array_equal(t["conv_init.kernel"].numpy(), k.transpose(3, 2, 0, 1))
    d = params["Dense_0"]["kernel"]
    np.testing.assert_array_equal(t["Dense_0.kernel"].numpy(), d.T)
    np.testing.assert_array_equal(t["Dense_0.bias"].numpy(), params["Dense_0"]["bias"])
