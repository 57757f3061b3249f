# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The ResNets' BatchNorm (``bluefog_tpu_torch/ops/batchnorm.py``) on the
CPU: the plain path through ``BatchNorm.forward(x, residual, relu)`` is bit
for bit the composite the model computed before the residual add and the
ReLU were fused into it, and the backward's formula (the CUDA kernels'
oracle) is autograd of that composite. The kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu_torch.models import resnet
from bluefog_tpu_torch.ops import batchnorm as bn

C = 12


def composite(module, x, residual=None, relu=False):
    """``resnet.BatchNorm.forward`` as it was, then the block's ``+
    residual`` and ``F.relu``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if module.training:
        mu = xf.mean(dim=(0, 2, 3))
        mu2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        with torch.no_grad():
            m = module.momentum
            module.mean.copy_(m * module.mean + (1 - m) * mu)
            module.var.copy_(m * module.var + (1 - m) * var)
    else:
        mu, var = module.mean, module.var
    mul = torch.rsqrt(var + module.epsilon) * module.scale
    y = (xf - mu[:, None, None]) * mul[:, None, None] + module.bias[:, None, None]
    y = y.to(module.dtype)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


def _module(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    m = resnet.BatchNorm(C, dtype)
    with torch.no_grad():
        m.scale.copy_(torch.randn(C, generator=gen))
        m.bias.copy_(torch.randn(C, generator=gen))
        m.mean.copy_(torch.randn(C, generator=gen))
        m.var.copy_(torch.rand(C, generator=gen) + 0.5)
    return m


def _activation(dtype, seed, shape=(4, C, 5, 6), offset=0.5, spread=2.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * spread + offset
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _run(module, fn, x, residual, dy):
    """Output, running statistics and gradients of ``fn`` on fresh leaves."""
    x = x.clone().requires_grad_(True)
    leaves = [x, module.scale, module.bias]
    if residual is not None:
        residual = residual.clone().requires_grad_(True)
        leaves.append(residual)
    y = fn(x, residual)
    grads = torch.autograd.grad(y, leaves, dy) if y.requires_grad else ()
    return [y.detach(), module.mean.clone(), module.var.clone(), *grads]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["no_res", "res"])
def test_plain_path_is_bitwise_the_composite(training, dtype, relu, with_residual):
    """Output, running mean and var, and the gradients with respect to x,
    scale, bias and the residual, bit for bit."""
    x = _activation(dtype, 1)
    residual = _activation(dtype, 2) if with_residual else None
    dy = _activation(dtype, 3, offset=0.0, spread=1.0)
    outs = []
    for fn in ("module", "composite"):
        m = _module(dtype)
        m.train(training)
        if fn == "module":
            call = lambda x, r: m(x, residual=r, relu=relu)  # noqa: E731
        else:
            call = lambda x, r: composite(m, x, r, relu)  # noqa: E731
        outs.append(_run(m, call, x, residual, dy))
    got, want = outs
    assert len(got) == len(want) == (7 if with_residual else 6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def _clamped_channel(dtype, m_elems, seed=0):
    """Values of one channel whose fast variance ``E[x^2] - E[x]^2`` comes
    out below 0 in ``dtype`` (a large mean over a tiny spread), found by
    trying seeds."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(200):
        v = 1e6 + 1e-3 * torch.randn(m_elems, generator=gen, dtype=torch.float64)
        v = v.to(dtype)
        raw = (v * v).mean() - v.mean() * v.mean()
        if raw < 0 and v.std() > 0:
            return v
    raise AssertionError("no clamped channel found")


def _f64_case(seed, clamp):
    """An f64 activation whose channel 0 has a clipped variance (if
    ``clamp``) and channel 1 a bias so negative the ReLU masks all of it."""
    x = _activation(torch.float64, seed)
    if clamp:
        n, _c, h, w = x.shape
        x[:, 0] = _clamped_channel(torch.float64, n * h * w, seed).view(n, h, w)
    x = x.contiguous(memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(seed + 7)
    scale = torch.randn(C, generator=gen, dtype=torch.float64)
    bias = torch.randn(C, generator=gen, dtype=torch.float64)
    bias[1] = -1e6
    return x, scale, bias


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["no_res", "res"])
def test_backward_formula_is_autograd_of_the_composite_in_f64(training, relu, with_residual):
    """``batch_norm_backward_reference`` against autograd of the composite,
    both in float64: a channel with a clipped variance (its variance term
    dropped, as ``torch.clamp``'s gradient drops it) and, with the ReLU, a
    channel masked whole."""
    x, scale, bias = _f64_case(11, clamp=training)
    residual = _activation(torch.float64, 12) if with_residual else None
    dy = _activation(torch.float64, 13, offset=0.0, spread=1.0)
    mean = torch.randn(C, dtype=torch.float64)
    var = torch.rand(C, dtype=torch.float64) + 0.5
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    res_leaf = residual.clone().requires_grad_(True) if with_residual else None
    y = bn.batch_norm_reference(leaves[0], leaves[1], leaves[2], mean.clone(), var.clone(),
                                training, residual=res_leaf, relu=relu)
    want = torch.autograd.grad(y, leaves + ([res_leaf] if with_residual else []), dy)
    if training:
        stats = bn.batch_norm_stats_reference(x)
        assert stats[2, 0] == 0 and (stats[2, 1:] == 1).all()
    else:
        stats = torch.stack([mean, 1.0 / torch.sqrt(var + 1e-5), torch.zeros_like(mean)])
    if relu:
        assert (y[:, 1] == 0).all()
    dx, dscale, dbias, g = bn.batch_norm_backward_reference(
        dy, x, y.detach() if relu else None, stats, scale, batch_stats=training)
    got = [dx, dscale, dbias] + ([g] if with_residual else [])
    for name, a, b in zip(("dx", "dscale", "dbias", "dres"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9 * float(b.abs().max()) + 1e-12,
                                   msg=name)
    if relu:
        assert (dx[:, 1] == 0).all() and dscale[1] == 0 and dbias[1] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_formula_matches_autograd_in_working_precision(dtype):
    """The same formula in the activation's own precision (f32 arithmetic)
    stays within a few f32 roundings of f64 autograd: the oracle the
    kernels are held to is itself sound."""
    x64, scale, bias = _f64_case(21, clamp=False)
    x = x64.to(dtype).contiguous(memory_format=torch.channels_last)
    dy = _activation(dtype, 23, offset=0.0, spread=1.0)
    leaves = [x.to(torch.float64).requires_grad_(True), scale.clone().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    y = bn.batch_norm_reference(leaves[0], leaves[1], leaves[2], torch.zeros(C, dtype=torch.float64),
                                torch.ones(C, dtype=torch.float64), True, relu=True)
    want = torch.autograd.grad(y, leaves, dy.to(torch.float64))
    y_low = y.detach().to(dtype)
    got = bn.batch_norm_backward_reference(dy, x, y_low, bn.batch_norm_stats_reference(x),
                                           scale.float())
    # dx rounds to the activation's dtype; the sums are f32
    ulp = 2.0 ** (-8 if dtype == torch.bfloat16 else -23)
    for a, b in zip(got[:3], want):
        tol = 4 * ulp * float(b.abs().max()) + 1e-4 * float(b.abs().max()) * (
            dtype == torch.bfloat16)
        torch.testing.assert_close(a.to(torch.float64), b, rtol=0, atol=tol)


def test_apply_reference_is_the_reference_given_its_statistics():
    """``batch_norm_apply_reference`` on the reference's own statistics in
    eval form reproduces the eval composite bit for bit (both take
    ``mul = rstd * scale`` with one rounding each)."""
    x = _activation(torch.bfloat16, 31)
    m = _module(torch.bfloat16)
    m.eval()
    stats = torch.stack([m.mean, torch.rsqrt(m.var + m.epsilon), torch.ones(C)])
    residual = _activation(torch.bfloat16, 32)
    with torch.no_grad():
        want = composite(m, x, residual, True)
        got = bn.batch_norm_apply_reference(x, stats, m.scale, m.bias, residual, True)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_summation_order_bounds_hold_the_plain_f32_sums(dtype):
    """The bounds the kernels are held to hold the plain version's own f32
    statistics and sums against the exact f64 ones: another summation order
    stays inside them, a mean or sum moved by 1e-3 of its magnitude does not."""
    x = _activation(dtype, 51, shape=(8, C, 30, 30), offset=3.0)
    ref = bn.batch_norm_stats_reference(x)
    d_mean, _, d_rstd = bn.batch_norm_stats_bounds(x, ref)
    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    rstd = 1 / torch.sqrt(((xd * xd).mean(dim=(0, 2, 3)) - mean ** 2).clamp(min=0) + 1e-5)
    assert ((ref[0].double() - mean).abs() <= d_mean).all()
    assert ((ref[1].double() - rstd).abs() <= d_rstd).all()
    assert not ((ref[0].double() * (1 + 1e-3) - mean).abs() <= d_mean).all()
    terms = _activation(torch.float32, 52, shape=(8, C, 30, 30)) * xd.float()
    bound = bn.batch_norm_sum_bound(terms)
    exact = terms.double().sum(dim=(0, 2, 3))
    assert ((terms.sum(dim=(0, 2, 3)).double() - exact).abs() <= bound).all()
    moved = exact + 1e-3 * terms.double().abs().sum(dim=(0, 2, 3))
    assert not ((moved - exact).abs() <= bound).any()


def test_cpu_takes_the_plain_version_and_other_devices_raise():
    """A CPU tensor takes the plain version and counts no launch; any
    other device is refused rather than computed elsewhere."""
    bn.reset_launch_counts()
    m = _module(torch.bfloat16)
    x = _activation(torch.bfloat16, 41)
    m(x, relu=True).sum()
    assert bn.launch_counts() == dict.fromkeys(bn.KERNELS, 0)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn.batch_norm(meta, m.scale.to("meta"), m.bias.to("meta"), m.mean.to("meta"),
                      m.var.to("meta"), True)


@pytest.mark.parametrize("m, c, vec", [(256 * 112 * 112, 64, 8), (256 * 7 * 7, 2048, 8),
                                       (256 * 56 * 56, 256, 4), (7, 13, 1), (1, 8, 8)])
def test_grid_keeps_partials_small_and_the_card_busy(monkeypatch, m, c, vec):
    """Blocks along the rows: at most a few an SM over all column chunks,
    at least one; a reducing block walks at least its minimum of rows
    (a pass of its threads at least) unless the rows run out; the choice
    depends on the shape and the card alone."""
    bn._grid.cache_clear()
    monkeypatch.setattr(bn, "_sm_count", lambda index: 132)
    try:
        reduce, elementwise = bn._grid(m, c, vec, 0)
        groups = c // vec
        chunks = -(-groups // bn._THREADS)
        rows_per_pass = bn._THREADS // min(groups, bn._THREADS)
        for g in (reduce, elementwise):
            assert 1 <= g <= max(1, 132 * bn._BLOCKS_PER_SM // chunks)
        least = max(rows_per_pass, bn._MIN_REDUCE_ROWS)
        assert reduce == 1 or m > (reduce - 1) * least
        assert bn._grid(m, c, vec, 0) == (reduce, elementwise)
    finally:
        bn._grid.cache_clear()
