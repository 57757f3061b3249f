# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's flash attention (``bluefog_tpu_torch.ops``) against the JAX
package's, same numpy inputs.

On the CPU the port's ``flash_attention`` / ``flash_attention_with_lse``
run the plain versions of its kernels (``flash_fwd_reference``,
``flash_bwd_dkv_reference``, ``flash_bwd_dq_reference``) under its
``torch.autograd.Function``; the JAX side runs its Pallas kernels in the
interpreter (``interpret=True``), as ``tests/test_flash.py`` does. Both in
float32. Tolerances are test_flash.py's: rtol 2e-5 / atol 2e-6 for the
forward (atol 2e-5 for lse), rtol 2e-4 / atol 1e-4 for gradients (entries
that are zero analytically, e.g. causal row 0, carry ~1e-5 of float
noise).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu.ops import flash as jflash
from bluefog_tpu.ops.attention import reference_attention as jreference
from bluefog_tpu_torch.ops import flash

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=2e-4, atol=1e-4)


def _inputs(seed, b, t, h, d, h_kv=None, tk=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, tk or t, h_kv or h, d).astype(np.float32)
    v = rng.randn(b, tk or t, h_kv or h, d).astype(np.float32)
    return q, k, v


def _port_grads(fn, q, k, v, loss):
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_(True) for x in (q, k, v))
    out = fn(tq, tk, tv)
    loss(out).backward()
    res = out if isinstance(out, tuple) else (out,)
    return [r.detach().numpy() for r in res], [x.grad.numpy() for x in (tq, tk, tv)]


def _jax_grads(fn, q, k, v, loss):
    res = fn(*(jnp.asarray(x) for x in (q, k, v)))
    grads = jax.grad(lambda *a: loss(fn(*a)), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    res = res if isinstance(res, tuple) else (res,)
    return [np.asarray(r) for r in res], [np.asarray(g) for g in grads]


def _sq(out):
    return (out ** 2).sum()


def _sq_and_lse(res):
    out, lse = res
    # a nonzero lse cotangent: 0.3 * (1 - tanh(lse)^2)
    tanh = torch.tanh if isinstance(lse, torch.Tensor) else jnp.tanh
    return (out ** 2).sum() + (tanh(lse) * 0.3).sum()


def _close_all(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, err_msg=f"{what} #{i}", **tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(100, 128), (130, 96), (257, 64), (384, 64)])
def test_forward_and_gradients_match_jax_kernels(causal, t, d):
    """Ragged and whole-tile sequence lengths, head_dim 64/96/128."""
    q, k, v = _inputs(t + d, 1, t, 2, d)
    port = lambda q, k, v: flash.flash_attention(q, k, v, causal=causal)
    jx = lambda q, k, v: jflash.flash_attention(q, k, v, causal=causal, interpret=True)
    (out,), grads = _port_grads(port, q, k, v, _sq)
    (jout,), jgrads = _jax_grads(jx, q, k, v, _sq)
    np.testing.assert_allclose(out, jout, **FWD)
    _close_all(grads, jgrads, GRAD, f"dq/dk/dv t={t} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,h_kv", [(4, 2), (4, 1)])
def test_gqa_matches_jax_kernels(causal, h, h_kv):
    """Grouped-query K/V stays compact: dK/dV have K/V's head count and
    sum their query group's gradients."""
    q, k, v = _inputs(13, 2, 200, h, 32, h_kv=h_kv)
    port = lambda q, k, v: flash.flash_attention(q, k, v, causal=causal)
    jx = lambda q, k, v: jflash.flash_attention(q, k, v, causal=causal, interpret=True)
    (out,), grads = _port_grads(port, q, k, v, _sq)
    (jout,), jgrads = _jax_grads(jx, q, k, v, _sq)
    np.testing.assert_allclose(out, jout, **FWD)
    assert grads[1].shape == k.shape and grads[2].shape == v.shape
    _close_all(grads, jgrads, GRAD, f"gqa {h}/{h_kv}")


def test_scale_override_matches_jax():
    q, k, v = _inputs(3, 2, 128, 2, 64)
    port = lambda q, k, v: flash.flash_attention(q, k, v, scale=0.5)
    jx = lambda q, k, v: jflash.flash_attention(q, k, v, scale=0.5, interpret=True)
    (out,), grads = _port_grads(port, q, k, v, _sq)
    (jout,), jgrads = _jax_grads(jx, q, k, v, _sq)
    np.testing.assert_allclose(out, jout, **FWD)
    _close_all(grads, jgrads, GRAD, "scale 0.5")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h_kv", [2, 1])
def test_with_lse_matches_jax_including_lse_gradient(causal, h_kv):
    """Both outputs (f32 out, lse [b, h, t]) and the joint gradient
    through a loss of out AND lse (a nonzero lse cotangent), ragged T."""
    q, k, v = _inputs(11, 1, 200, 2, 64, h_kv=h_kv)
    port = lambda q, k, v: flash.flash_attention_with_lse(q, k, v, causal=causal)
    jx = lambda q, k, v: jflash.flash_attention_with_lse(q, k, v, causal=causal,
                                                         interpret=True)
    (out, lse), grads = _port_grads(port, q, k, v, _sq_and_lse)
    (jout, jlse), jgrads = _jax_grads(jx, q, k, v, _sq_and_lse)
    assert out.dtype == np.float32 and lse.shape == (1, 2, 200)
    np.testing.assert_allclose(out, jout, **FWD)
    np.testing.assert_allclose(lse, jlse, rtol=2e-5, atol=2e-5)
    _close_all(grads, jgrads, GRAD, f"with_lse causal={causal} h_kv={h_kv}")


def test_rows_with_no_valid_key():
    """Causal attention of 12 queries over 4 keys (a cross shape, so the
    dense path, which is the plain version of the forward kernel with its
    guards): the first 8 query rows see no key, and give out = 0 and lse =
    -inf with zero gradient, as the JAX package's guards give."""
    q, k, v = _inputs(17, 1, 12, 2, 16, tk=4)
    port = lambda q, k, v: flash.flash_attention_with_lse(q, k, v, causal=True)
    jx = lambda q, k, v: jflash.flash_attention_with_lse(q, k, v, causal=True,
                                                         interpret=True)
    loss = lambda res: (res[0] ** 2).sum()
    (out, lse), grads = _port_grads(port, q, k, v, loss)
    (jout, jlse), jgrads = _jax_grads(jx, q, k, v, loss)
    assert not flash.flash_attention_supported(torch.zeros(1, 12, 2, 16), torch.zeros(1, 4, 2, 16))
    assert np.all(out[:, :8] == 0.0) and np.all(np.isneginf(lse[:, :, :8]))
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(jlse))
    np.testing.assert_allclose(out, jout, **FWD)
    np.testing.assert_allclose(lse[np.isfinite(lse)], jlse[np.isfinite(jlse)], rtol=2e-5, atol=2e-5)
    assert np.all(grads[0][:, :8] == 0.0)
    _close_all(grads, jgrads, GRAD, "no valid key")


def test_cross_attention_and_mismatched_heads_take_the_dense_path():
    """Cross-attention shapes (another sequence length) and K/V head
    counts that differ go to the dense reference by shape, as in JAX."""
    q, k, v = _inputs(5, 1, 64, 4, 32, tk=128)
    got = flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    want = jreference(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    q = torch.zeros(1, 128, 4, 32)
    k = torch.zeros(1, 128, 2, 32)
    assert not flash.flash_attention_supported(q, k, torch.zeros(1, 128, 4, 32))
    assert flash.flash_attention_supported(q, k, k)
    assert flash.flash_attention_supported(torch.zeros(1, 4097, 2, 96))
    for shapes in [((1, 100, 2, 128),), ((1, 256, 2, 128), (1, 512, 2, 128))]:
        jargs = [jnp.zeros(s) for s in shapes]
        targs = [torch.zeros(s) for s in shapes]
        assert flash.flash_attention_supported(*targs) == jflash.flash_attention_supported(*jargs)


def test_head_dim_above_128_and_bad_blocks_are_refused():
    """head_dim above 128 is computed (the plain versions on the CPU take
    any head_dim; the CUDA kernels stop at ``MAX_HEAD_DIM``, 256, and refuse
    more by name); bad block sizes are refused."""
    z = torch.randn(1, 16, 2, 136)
    out = flash.flash_attention(z, z, z, causal=True)
    want = flash.reference_attention(z, z, z, causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert flash.MAX_HEAD_DIM == 256 and flash.SM90_MAX_HEAD_DIM == 128
    with pytest.raises(ValueError, match="limit of 256"):
        flash._check_kernel_head_dim(264)
    flash._check_kernel_head_dim(256)
    z = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError):
        flash.flash_attention(z, z, z, block_q=0)
    out = flash.flash_attention(z, z, z, block_q=64, block_k=128)  # accepted, unused
    assert out.shape == z.shape


# head_dim above 128 (the JAX package has no bound): f32 at 1e-5, forward,
# lse and all three gradients against the Pallas kernels in the interpreter.
# A gradient is held at rtol 1e-5 with atol 1e-5 of its largest entry:
# entries that are zero analytically (causal dQ of query 0) carry float
# noise in proportion to the gradient's scale, on both sides.
WIDE = dict(rtol=1e-5, atol=1e-5)


def _close_scaled(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=f"{what} #{i}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 256])
def test_head_dim_160_and_256_match_jax_kernels(causal, d):
    q, k, v = _inputs(d + int(causal), 1, 40, 2, d)
    port = lambda q, k, v: flash.flash_attention(q, k, v, causal=causal)
    jx = lambda q, k, v: jflash.flash_attention(q, k, v, causal=causal, interpret=True)
    (out,), grads = _port_grads(port, q, k, v, _sq)
    (jout,), jgrads = _jax_grads(jx, q, k, v, _sq)
    np.testing.assert_allclose(out, jout, **WIDE)
    _close_scaled(grads, jgrads, f"dq/dk/dv d={d} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,h_kv", [(160, 2), (256, 2), (160, 1)])
def test_head_dim_160_and_256_with_lse_match_jax_kernels(causal, d, h_kv):
    """The lse form (f32 out and lse, a nonzero lse cotangent) at head_dim
    160 and 256, and one grouped-query case (2 query heads on 1 KV head)."""
    q, k, v = _inputs(d + h_kv, 1, 40, 2, d, h_kv=h_kv)
    port = lambda q, k, v: flash.flash_attention_with_lse(q, k, v, causal=causal)
    jx = lambda q, k, v: jflash.flash_attention_with_lse(q, k, v, causal=causal,
                                                         interpret=True)
    (out, lse), grads = _port_grads(port, q, k, v, _sq_and_lse)
    (jout, jlse), jgrads = _jax_grads(jx, q, k, v, _sq_and_lse)
    np.testing.assert_allclose(out, jout, **WIDE)
    np.testing.assert_allclose(lse, jlse, **WIDE)
    assert grads[1].shape == k.shape
    _close_scaled(grads, jgrads, f"with_lse d={d} h_kv={h_kv} causal={causal}")
