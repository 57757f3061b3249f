# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's sequence-parallel attention (``ring_attention``,
``ulysses_attention``, ``_merge_blocks``) against the JAX package's
``ring_attention_block`` / ``ulysses_attention_block`` under ``shard_map``
on the 8-device CPU mesh, same numpy inputs.

On the CPU the port runs the flash kernels' plain versions; the JAX blocks
run their dense path. f32: forward and the gradients of q, k and v to
rtol 1e-5 (atol 1e-5 of the largest entry: entries that are zero
analytically carry float noise in proportion to the scale). bf16: every
entry within 3e-2 of the output's largest entry, about 3x the largest
difference measured over these cases (9.5e-3): the JAX dense path forms
the scores in bf16 and keeps P in f32, the port's plain versions take f32
scores and round P to bf16 before P.V, as the kernels do, so each side
rounds in other places (each lies within 1.4e-2 of the f32 result).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.ops import attention as jattn
from bluefog_tpu_torch.ops import attention as tattn
from bluefog_tpu_torch.ops import ring_attention, ulysses_attention

SIZE = 8
BF16_TOL = 3e-2


def _inputs(seed, b, t, h, h_kv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(SIZE, b, t, h, d).astype(np.float32)
    k = rng.randn(SIZE, b, t, h_kv, d).astype(np.float32)
    v = rng.randn(SIZE, b, t, h_kv, d).astype(np.float32)
    w = rng.randn(SIZE, b, t, h, d).astype(np.float32)
    return q, k, v, w


def _jax(block_fn, cpu_devices, q, k, v, w, causal, dtype):
    """Output and gradients of ``sum(out * w)`` of ``block_fn`` on the mesh."""
    mesh = Mesh(np.array(cpu_devices[:SIZE]), ("w",))
    fn = jax.shard_map(
        lambda qb, kb, vb: block_fn(qb[0], kb[0], vb[0], "w", causal=causal)[None],
        mesh=mesh, in_specs=(P("w"),) * 3, out_specs=P("w"))
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    loss = lambda *a: (fn(*a).astype(jnp.float32) * w).sum()
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out,) + tuple(grads)]


def _port(fn, q, k, v, w, causal, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = fn(tq, tk, tv, causal=causal)
    assert out.dtype == dtype and out.shape == tq.shape
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [x.detach().float().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


def _check(got, want, dtype):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()),
                                       err_msg=name)
        else:
            err = float(np.abs(a - b).max() / np.abs(b).max())
            assert err <= BF16_TOL, (name, err)


DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h_kv", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(cpu_devices, causal, h_kv, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, w = _inputs(10 + h_kv, 2, 6, 4, h_kv, 8)
    want = _jax(jattn.ring_attention_block, cpu_devices, q, k, v, w, causal, jdt)
    got = _port(ring_attention, q, k, v, w, causal, tdt)
    _check(got, want, tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h_kv", [8, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(cpu_devices, causal, h_kv, dtype):
    """8 heads over 8 workers; grouped-query K/V stays compact at 8 KV heads
    and is expanded at 2 (not divisible by the mesh)."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, w = _inputs(20 + h_kv, 1, 5, 8, h_kv, 8)
    want = _jax(jattn.ulysses_attention_block, cpu_devices, q, k, v, w, causal, jdt)
    got = _port(ulysses_attention, q, k, v, w, causal, tdt)
    _check(got, want, tdt)


def test_ring_and_ulysses_equal_dense_attention_of_the_whole_sequence():
    q, k, v, _w = _inputs(30, 2, 7, 8, 4, 16)
    full = lambda x: torch.from_numpy(x).permute(1, 0, 2, 3, 4).reshape(2, SIZE * 7, -1, 16)
    for causal in (False, True):
        want = tattn.reference_attention(full(q), full(k), full(v), causal=causal)
        for fn in (ring_attention, ulysses_attention):
            got = fn(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
            got = got.permute(1, 0, 2, 3, 4).reshape(want.shape)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_merge_blocks_matches_jax_including_empty_blocks():
    """Finite with finite, one side -inf (an excluded block), both -inf (a
    row with no key): out and lse as the JAX merge gives them."""
    rng = np.random.RandomState(7)
    b, t, h, d = 2, 5, 3, 4
    out_a, out_b = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.randn(b, h, t).astype(np.float32) * 3 for _ in range(2))
    lse_a[0, 0, :2] = -np.inf
    lse_b[0, 1, 1:3] = -np.inf
    lse_a[1, 2, 4] = lse_b[1, 2, 4] = -np.inf
    want_out, want_lse = jattn._merge_blocks(*(jnp.asarray(x) for x in (out_a, lse_a, out_b, lse_b)))
    got_out, got_lse = tattn._merge_blocks(*(torch.from_numpy(x) for x in (out_a, lse_a, out_b, lse_b)))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.isneginf(got_lse.numpy()), np.isneginf(np.asarray(want_lse)))
    finite = np.isfinite(np.asarray(want_lse))
    np.testing.assert_allclose(got_lse.numpy()[finite], np.asarray(want_lse)[finite], rtol=1e-6)
    assert np.all(got_out.numpy()[1, 4, 2] == 0.0)


def test_refusals_match_jax(cpu_devices):
    """Ulysses refuses heads not divisible by the mesh and an invalid
    grouped-query group at entry, as the JAX block does; both facades
    refuse tensors that are not worker-stacked blocks of one sequence."""
    mesh = Mesh(np.array(cpu_devices[:SIZE]), ("w",))
    for h, h_kv in ((4, 4), (8, 3)):
        q, k, v, _w = _inputs(40, 1, 4, h, h_kv, 8)
        fn = jax.shard_map(
            lambda qb, kb, vb: jattn.ulysses_attention_block(qb[0], kb[0], vb[0], "w")[None],
            mesh=mesh, in_specs=(P("w"),) * 3, out_specs=P("w"))
        with pytest.raises(ValueError) as jerr:
            fn(*(jnp.asarray(x) for x in (q, k, v)))
        with pytest.raises(ValueError) as terr:
            ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)))
        assert str(terr.value) == str(jerr.value)
    z = torch.zeros(SIZE, 1, 4, 2, 8)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError):
            fn(z[0], z[0], z[0])
        with pytest.raises(ValueError):
            fn(z, z[:, :, :3], z[:, :, :3])
