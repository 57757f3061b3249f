# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Long-context training through ring attention
(``bluefog_tpu_torch.models.long_context``) against ``examples/long_context.py``'s
sequence-parallel step on the JAX package's 8-device CPU mesh, and against
the same model run dense on the whole sequence.

The example's tiny model: vocab 32, dim 32, 4 heads, 2 layers, 8 workers x
16 tokens, batch 4, the periodic token stream. The same flax parameters
go into both packages (``interop.params_from_flax``). f32: the loss to
rtol 1e-5, every parameter's gradient to rtol 1e-5 with atol 1e-5 of its
largest entry (entries near zero carry float noise in proportion to the
scale).

The JAX example's sequence-parallel gradient is ``size`` times the
gradient of its loss on this jax: the transpose of the ``psum`` inside
``sp_global_loss`` already sums the workers' cotangents, and the step's
explicit ``psum`` of the gradients sums them again (the example's
comment expects an identity transpose; its optimizer, adam, does not see a
constant factor). The port's gradient is the loss's own; it is held to
the JAX dense gradient of the same loss, and to the JAX example's divided
by ``size``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.models.transformer import TransformerLM as JTransformerLM
from bluefog_tpu.ops import ring_attention_block
from bluefog_tpu_torch import interop
from bluefog_tpu_torch.models import TransformerLM
from bluefog_tpu_torch.models.long_context import ring_attend, shard_sequence, sp_global_loss

SIZE, BATCH, BLOCK, VOCAB = 8, 4, 16, 32
TOTAL = SIZE * BLOCK
CONFIG = dict(vocab=VOCAB, dim=32, heads=4, layers=2, max_len=TOTAL)


def _stream():
    """The example's periodic stream: tokens and next-token targets
    ``[batch, total]`` (a block's last target is the next block's first
    token)."""
    rng = np.random.RandomState(0)
    period = BLOCK + 3
    base = rng.randint(0, VOCAB, size=period)
    stream = np.tile(base, (BATCH, TOTAL // period + 2))[:, :TOTAL + 1]
    return stream[:, :-1], stream[:, 1:]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_reference():
    """Parameters, the sequence-parallel loss and (psum-combined) gradients
    of the example's step without its optimizer update, and the gradient of
    the dense model's mean loss on the whole sequence."""
    tokens, targets = _stream()
    make = lambda attend=None: JTransformerLM(**CONFIG, attend=attend)
    params = make().init(jax.random.PRNGKey(0), jnp.asarray(tokens[:, :BLOCK]))
    mesh = Mesh(np.array(jax.devices("cpu")[:SIZE]), ("seq",))
    ring = lambda q, k, v: ring_attention_block(q, k, v, "seq", causal=True)

    def sp_global_loss_j(p, tok, tgt, my):
        logits = make(ring).apply(p, tok, pos_offset=my * BLOCK)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return jax.lax.psum(losses.sum(), "seq") / (BATCH * TOTAL)

    def step(p, tok, tgt):
        my = jax.lax.axis_index("seq")
        loss, grads = jax.value_and_grad(lambda q: sp_global_loss_j(q, tok[0], tgt[0], my))(p)
        return jax.tree_util.tree_map(lambda g: jax.lax.psum(g, "seq"), grads), loss

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P("seq"), P("seq")),
                               out_specs=(P(), P())))
    shard = lambda a: shard_sequence(torch.from_numpy(a), SIZE).numpy()
    grads, loss = fn(params, shard(tokens), shard(targets))
    dense = lambda p: optax.softmax_cross_entropy_with_integer_labels(
        make().apply(p, jnp.asarray(tokens)), jnp.asarray(targets)).mean()
    dense_grads = jax.grad(dense)(params)
    return (params["params"], float(loss), jax.device_get(grads)["params"],
            jax.device_get(dense_grads)["params"])


def _port_model(params, attend=None):
    model = TransformerLM(**CONFIG, attend=attend)
    model.load_state_dict(interop.params_from_flax(params))
    return model


def test_sequence_parallel_loss_and_gradients_match_jax(jax_reference):
    params, jloss, jgrads, jdense = jax_reference
    tokens, targets = _stream()
    model = _port_model(params, ring_attend(SIZE))
    tok = shard_sequence(torch.from_numpy(tokens), SIZE)
    tgt = shard_sequence(torch.from_numpy(targets), SIZE)
    loss = sp_global_loss(model, tok, tgt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    want_sp, want_dense = interop.params_from_flax(jgrads), interop.params_from_flax(jdense)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_dense[name].numpy(), name)
        _close(p.grad.numpy(), want_sp[name].numpy() / SIZE, name)


def test_sequence_parallel_equals_the_dense_model(jax_reference):
    """The same parameters run dense on the whole sequence (the port's
    causal flash attention, one 128-token row per sequence): the mean
    next-token loss and its gradients equal the sequence-parallel ones."""
    params, jloss, _, _ = jax_reference
    tokens, targets = _stream()
    sp = _port_model(params, ring_attend(SIZE))
    dense = _port_model(params)
    loss_sp = sp_global_loss(sp, shard_sequence(torch.from_numpy(tokens), SIZE),
                             shard_sequence(torch.from_numpy(targets), SIZE))
    logits = dense(torch.from_numpy(tokens))
    loss_dense = torch.nn.functional.cross_entropy(logits.reshape(-1, VOCAB),
                                                   torch.from_numpy(targets).reshape(-1))
    loss_sp.backward()
    loss_dense.backward()
    np.testing.assert_allclose(loss_sp.item(), loss_dense.item(), rtol=1e-5)
    np.testing.assert_allclose(loss_dense.item(), jloss, rtol=1e-5)
    grads_dense = dict(dense.named_parameters())
    for name, p in sp.named_parameters():
        _close(p.grad.numpy(), grads_dense[name].grad.numpy(), name)


def test_per_row_positions_and_their_limit():
    """A per-row ``pos_offset`` embeds each row at its own global
    positions (row ``i`` equals the int-offset call at its offset); a
    position at ``max_len`` raises."""
    model = TransformerLM(**CONFIG)
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    tok = torch.randint(0, VOCAB, (3, BLOCK))
    offsets = torch.tensor([0, 16, 112])
    with torch.no_grad():
        got = model(tok, pos_offset=offsets)
        for i, off in enumerate(offsets.tolist()):
            np.testing.assert_allclose(got[i:i + 1].numpy(), model(tok[i:i + 1], off).numpy(),
                                       rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="max_len"):
            model(tok, pos_offset=torch.tensor([0, 16, 113]))
        with pytest.raises(ValueError):
            model(tok, pos_offset=torch.tensor([0, 16]))
