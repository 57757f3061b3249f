# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's TransformerLM (``bluefog_tpu_torch.models``) against the flax
model of the JAX package, with the JAX weights carried over by
``bluefog_tpu_torch.interop``; and three gossip training steps of 8
workers against the JAX optimizer on the 8-device CPU mesh.

The small model (vocab 64, dim 32, 4 heads, 2 layers) runs in float32:
the point is the algorithm (flax LayerNorm, tanh gelu, bias-free
attention projections, the f32 head, parameter order and layouts), not
bf16 rounding. The JAX side attends through its Pallas flash kernels in
the interpreter (``attend=``, ``interpret=True``); the port through its
flash kernels' plain versions. Tolerances: rtol 1e-4 / atol 1e-5 for
logits, loss and gradients (f32 sums in another order); the training
steps as ``test_torch_train`` holds the int8 wire: losses rtol 1e-4,
parameters within one int8 quantum per step, re-synchronised after each.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import bluefog_tpu as bf
from bluefog_tpu.models.transformer import TransformerLM as JTransformerLM
from bluefog_tpu.ops.flash import flash_attention as jflash_attention
from bluefog_tpu_torch import interop
from bluefog_tpu_torch.models import StackedModel, TransformerLM, next_token_loss
from bluefog_tpu_torch.models import stacked as stacked_mod

import test_torch_resnet as tr
import test_torch_train as tt

SMALL = dict(vocab=64, dim=32, heads=4, layers=2)
SIZE = 8


def _jattend(q, k, v):
    return jflash_attention(q, k, v, causal=True, interpret=True)


def jax_model(max_len, remat=False, attend=_jattend):
    return JTransformerLM(max_len=max_len, attend=attend, remat=remat, **SMALL)


def carried_params(seed, max_len):
    """flax params with every bias, LayerNorm scale and bias randomised, so
    no term is an identity or a zero."""
    tokens = jnp.zeros((1, max_len), jnp.int32)
    params = jax.tree_util.tree_map(
        np.asarray, jax_model(max_len).init(jax.random.PRNGKey(seed), tokens)["params"])
    rng = np.random.RandomState(seed)

    def jitter(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = jitter(v)
            elif k == "scale":
                out[k] = (1.0 + 0.3 * rng.rand(*v.shape)).astype(np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return jitter(params)


def _jax_loss_fn(model, tokens):
    def loss_fn(p):
        logits = model.apply({"params": p}, tokens)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tokens[:, 1:]).mean()
        return loss, logits
    return loss_fn


def _port(max_len, params, remat=False, size=1):
    sm = StackedModel(TransformerLM(max_len=max_len, remat=remat, **SMALL), size, "cpu",
                      loss=next_token_loss)
    row = sm.pack(interop.params_from_flax(params))
    return sm, row.unsqueeze(0).repeat(size, 1).contiguous()


def test_packed_row_is_ravel_pytree_order():
    """The transformer's flat buffer lays leaves out in ``jax.tree_util``
    order with the JAX shapes: the embedding and the position table as they
    are (not transposed), dense kernels ``[in, out]``."""
    params = carried_params(0, 16)
    sm, row = _port(16, params)
    jleaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [s.name for s in sm.slots] == [".".join(k.key for k in p) for p, _ in jleaves]
    assert [s.jax_shape for s in sm.slots] == [leaf.shape for _, leaf in jleaves]
    layouts = {s.name: s.layout for s in sm.slots}
    assert layouts["Embed_0.embedding"] == layouts["pos"] == stacked_mod.SAME
    assert layouts["Block_0.Dense_0.kernel"] == stacked_mod.DENSE
    flat, _ = ravel_pytree(params)
    np.testing.assert_array_equal(row[0, :sm.n_params].numpy(), np.asarray(flat))
    torch_params = interop.params_from_flax(params)
    np.testing.assert_array_equal(torch_params["Embed_0.embedding"].numpy(),
                                  params["Embed_0"]["embedding"])
    np.testing.assert_array_equal(torch_params["pos"].numpy(), params["pos"])


def _rank_rule(a):
    """The layout rule the port used before it chose per parameter: every
    4-D leaf HWIO -> OIHW, every 2-D leaf transposed."""
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else (a.T if a.ndim == 2 else a)


def test_resnet_row_and_params_unchanged_by_per_parameter_layout():
    """ResNet has no 2-D leaf but dense kernels, so the per-parameter rule
    gives it the same packed row and the same tensors, position for
    position, as the rank rule did."""
    params, stats = tr.carried_variables(seed=1)
    flat = interop.flatten_tree(params)
    torch_params = interop.params_from_flax(params)
    assert set(torch_params) == set(flat)
    for name, a in flat.items():
        np.testing.assert_array_equal(torch_params[name].numpy(), _rank_rule(a))
    sm, row = tr.stacked(params, stats)
    rank = {4: stacked_mod.CONV, 2: stacked_mod.DENSE}
    assert [s.layout for s in sm.slots] == [rank.get(len(s.shape), stacked_mod.SAME)
                                            for s in sm.slots]
    # under the rank rule the row held every flax leaf as it is, in leaf
    # order: ravel_pytree
    np.testing.assert_array_equal(row[0, :sm.n_params].numpy(),
                                  np.asarray(ravel_pytree(params)[0]))


@pytest.mark.parametrize("t,remat", [(16, False), (16, True), (13, False)],
                         ids=["t16", "t16-remat", "t13-ragged"])
def test_logits_loss_and_gradients_match_flax(t, remat):
    """One forward and backward of the f32 model: logits, the next-token
    loss and every parameter's gradient (in the flat JAX layout), with
    remat and at a ragged sequence length (max_len 16)."""
    params = carried_params(2, 16)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, SMALL["vocab"], (2, t)).astype(np.int32)
    model = jax_model(16, remat=remat)
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(model, jnp.asarray(tokens)), has_aux=True))(params)
    sm, row = _port(16, params, remat=remat)
    ttok = torch.from_numpy(tokens).long()[None]
    got_logits = sm.forward(row, ttok)[0]
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=1e-4, atol=1e-5)
    losses, g = sm.loss_and_grad(row, ttok, ttok)
    np.testing.assert_allclose(losses[0].item(), float(loss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g[0, :sm.n_params].numpy(), np.asarray(ravel_pytree(grads)[0]),
                               rtol=1e-4, atol=1e-5)
    assert not g[0, sm.n_params:].any()


def test_pos_offset_is_checked_and_shifts_positions():
    params = carried_params(4, 16)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, SMALL["vocab"], (1, 8)).astype(np.int32)
    want = jax_model(16).apply({"params": params}, jnp.asarray(tokens), pos_offset=5)
    model = TransformerLM(max_len=16, **SMALL)
    model.load_state_dict(interop.params_from_flax(params))
    got = model(torch.from_numpy(tokens).long(), pos_offset=5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        model(torch.from_numpy(tokens).long(), pos_offset=9)


def test_injected_attend_is_used():
    calls = []

    def attend(q, k, v):
        calls.append(q.shape)
        return v  # not attention: the output shows it was called
    model = TransformerLM(max_len=8, attend=attend, **SMALL)
    model(torch.zeros(1, 8, dtype=torch.long))
    assert calls == [(1, 8, 4, 8)] * SMALL["layers"]


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    # the JAX composite wire: see test_torch_train
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    import bluefog_tpu_torch as bft

    bft.init(device="cpu")
    yield
    bf.shutdown()
    bft.shutdown()


def test_atc_int8_training_steps_match(contexts):
    """Three ATC int8 steps of 8 workers under sgd(0.01, 0.9), each from
    the same state: after every step the port's parameters and momentum
    are set to the JAX side's. The JAX side trains the model with its
    default attention (dense on the CPU)."""
    params = carried_params(6, 16)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, SMALL["vocab"], (SIZE, 2, 16)).astype(np.int32)
    model = JTransformerLM(max_len=16, **SMALL)

    def loss_grad(p, toks):
        loss, _ = _jax_loss_fn(model, toks)(p)
        return loss

    grad_fn = jax.jit(jax.vmap(jax.value_and_grad(loss_grad)))
    stack = lambda a: np.broadcast_to(a, (SIZE,) + a.shape).copy()
    jparams = tt._map(lambda a: bf.worker_values(list(stack(a))), params)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.01, momentum=0.9))
    import bluefog_tpu_torch as bft

    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.01, momentum=0.9))
    jopt.compression = topt.compression = "int8"
    jstate = jopt.init(jparams)
    sm, tparams = _port(16, params, size=SIZE)
    tstate = topt.init(tparams)
    ttok = torch.from_numpy(tokens).long()
    n = sm.n_params
    for step in range(3):
        host = tt._map(np.asarray, jparams)
        jloss, jgrads = grad_fn(host, jnp.asarray(tokens))
        jparams, jstate = jopt.step(
            jparams, jstate, tt._map(lambda a: bf.worker_values(list(np.asarray(a))), jgrads))
        tloss, tgrads = sm.loss_and_grad(tparams, ttok, ttok)
        tparams, tstate = topt.step(tparams, tstate, tgrads)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4,
                                   err_msg=f"step {step}")
        want = tt._rows(jparams)
        quantum = np.abs(want).max() / 127
        assert np.abs(tparams[:, :n].numpy() - want).max() <= quantum, f"step {step}"
        tparams[:, :n] = torch.from_numpy(want)
        tstate[:, :n] = torch.from_numpy(tt._rows(jstate))
