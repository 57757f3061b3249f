# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's ring reduce-scatter (``inner.reduce_scatter``, the ZeRO-2
gradient leg) against the numpy oracle of ``tests/test_reduce_scatter.py``
and against the JAX package's ``reduce_scatter`` on the 8-device CPU mesh,
the same numpy inputs through both.

Tolerances: the oracles' own (``atol 1e-5``, sum mode ``1e-4``, the
quantized envelopes); against JAX, bitwise on the exact, bf16 and int4
ring tiers (the own-first fixed order; the quantizers equal bit for bit),
and within ``JAX_TOL`` of the largest value on the int8 tiers and the
fast path: XLA:CPU contracts the int8 dequantize ``q * s`` into the add
that follows (and into the residual's subtract) as an FMA, where the port
rounds the product first; an int4 product is exact, so int4 is bitwise;
``psum_scatter`` and ``torch.sum`` may add the 8 rows in another order.
The JAX side runs its composite wire (``BLUEFOG_WIRE_KERNELS=0``).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from bluefog_tpu.collective import compiler as jcompiler
from bluefog_tpu.collective import inner as jinner
from bluefog_tpu_torch.collective import compiler, inner

SIZE = 8
AXIS = "workers"
SLOT = 512
JAX_TOL = 1e-6  # of the largest value: an FMA's last bit, or another sum order


def assert_jax_equal(got, want, wire):
    if wire in ("int8", "int8_ef"):
        assert np.abs(got - want).max() <= JAX_TOL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(autouse=True)
def composite_wire(monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.delenv("BLUEFOG_PLAN_CHUNKS", raising=False)


def run_spmd(fn, *arrays, out_specs=P(AXIS)):
    mesh = jax.make_mesh((SIZE,), (AXIS,))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=tuple(P(AXIS) for _ in arrays),
                                 out_specs=out_specs))(*arrays)


def rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def full_live_index():
    return tuple(range(SIZE))


def live_index_for(live):
    pos = {r: j for j, r in enumerate(sorted(live))}
    return tuple(pos.get(r, 0) for r in range(SIZE))


def scatter_oracle(x, live_index, slot):
    """Worker r's slot is the mean over ALL rows of the slot at its owner
    position."""
    mean = x.mean(axis=0)
    return np.stack([mean[live_index[r] * slot:(live_index[r] + 1) * slot]
                     for r in range(SIZE)])


def port(x, lidx, slot=SLOT, **kw):
    out = inner.reduce_scatter(torch.from_numpy(x), lidx, slot, **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def jax_rs(x, lidx, slot=SLOT, ef=None, **kw):
    if ef is None:
        return np.asarray(run_spmd(
            lambda t: jinner.reduce_scatter(t[0], AXIS, lidx, slot, **kw)[None], x))
    y, e = run_spmd(
        lambda t, et: tuple(a[None] for a in jinner.reduce_scatter(
            t[0], AXIS, lidx, slot, ef=et[0], **kw)),
        x, ef, out_specs=(P(AXIS), P(AXIS)))
    return np.asarray(y), np.asarray(e)


# -- the numpy oracle ------------------------------------------------------------------


@pytest.mark.parametrize("chunks", [1, 2])
def test_ring_matches_numpy_oracle_full_live(chunks):
    x = rand((SIZE, SIZE * SLOT), seed=1)
    lidx = full_live_index()
    y = port(x, lidx, chunks=chunks, fast=False)
    np.testing.assert_allclose(y, scatter_oracle(x, lidx, SLOT), rtol=0, atol=1e-5)


def test_ring_matches_numpy_oracle_live_subset():
    live = (0, 2, 5, 7)
    lidx = live_index_for(live)
    x = rand((SIZE, len(live) * SLOT), seed=2)
    y = port(x, lidx, fast=False)
    oracle = scatter_oracle(x, lidx, SLOT)
    for r in live:
        np.testing.assert_allclose(y[r], oracle[r], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(y, jax_rs(x, lidx, fast=False))


def test_sum_mode_skips_normalization():
    x = rand((SIZE, SIZE * SLOT), seed=3)
    lidx = full_live_index()
    y = port(x, lidx, average=False, fast=False)
    np.testing.assert_allclose(y, scatter_oracle(x, lidx, SLOT) * SIZE, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(y, jax_rs(x, lidx, average=False, fast=False))


def test_fast_path_matches_ring_and_jax():
    x = rand((SIZE, SIZE * SLOT), seed=4)
    lidx = full_live_index()
    fast, ring = port(x, lidx, fast=True), port(x, lidx, fast=False)
    assert np.abs(fast - ring).max() <= 1e-6
    jfast = jax_rs(x, lidx, fast=True)
    assert np.abs(fast - jfast).max() <= 1e-6 * np.abs(jfast).max()


@pytest.mark.parametrize("width", [SIZE * SLOT, SIZE * SLOT - 100, 7 * SLOT, 5 * SLOT + 3,
                                   SLOT - 1])
@pytest.mark.parametrize("average", [True, False])
def test_fast_path_on_an_unpadded_payload_equals_the_padded(width, average):
    """The one-sum form reads an unpadded ``[N, m]`` payload (the ZeRO-2
    gradient, no padded copy of it): bitwise the allreduce's owned slots,
    zeros past the payload, and within ``JAX_TOL`` of the padded
    payload's (``torch.sum`` may vectorise another width differently)."""
    x = torch.from_numpy(rand((SIZE, width), seed=9))
    padded = torch.nn.functional.pad(x, (0, SIZE * SLOT - width))
    lidx = full_live_index()
    want = inner.reduce_scatter(padded, lidx, SLOT, average=average, fast=True)
    got = inner._reduce_scatter(x, lidx, SLOT, average, None, 1, None, None, fast=True)
    assert torch.equal(got.reshape(-1)[:width], inner.allreduce(x, average=average)[0])
    assert not got.reshape(-1)[width:].any()
    assert float((got - want).abs().max()) <= JAX_TOL * float(want.abs().max())
    # and the unpadded ring equals the padded ring bitwise
    assert torch.equal(inner._reduce_scatter(x, lidx, SLOT, average, None, 1, None, None),
                       inner.reduce_scatter(padded, lidx, SLOT, average=average, fast=False))


def test_scatter_concat_equals_allreduce():
    x = rand((SIZE, SIZE * SLOT), seed=5)
    y = port(x, full_live_index(), fast=False)
    full = inner.allreduce(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y.reshape(-1), full[0], rtol=0, atol=1e-5)


# -- chunked == monolithic, and equal to JAX --------------------------------------------


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
def test_chunked_equals_monolithic_and_jax_bitwise(wire):
    x = rand((SIZE, SIZE * SLOT * 3), seed=6)
    lidx = full_live_index()
    mono = port(x, lidx, slot=3 * SLOT, wire=wire, fast=False)
    chunked = port(x, lidx, slot=3 * SLOT, wire=wire, chunks=4, fast=False)
    np.testing.assert_array_equal(mono, chunked)
    assert_jax_equal(mono, jax_rs(x, lidx, slot=3 * SLOT, wire=wire, fast=False), wire)


@pytest.mark.parametrize("wire", ["int8_ef", "int4_ef"])
def test_chunked_equals_monolithic_and_jax_bitwise_ef(wire):
    x = rand((SIZE, SIZE * SLOT * 2), seed=7)
    e0 = rand((SIZE, SIZE * SLOT * 2), seed=8) * 0.1
    lidx = full_live_index()
    y1, e1 = port(x, lidx, slot=2 * SLOT, wire=wire, ef=torch.from_numpy(e0), fast=False)
    y4, e4 = port(x, lidx, slot=2 * SLOT, wire=wire, ef=torch.from_numpy(e0), chunks=4,
                  fast=False)
    np.testing.assert_array_equal(y1, y4)
    np.testing.assert_array_equal(e1, e4)
    jy, je = jax_rs(x, lidx, slot=2 * SLOT, wire=wire, ef=e0, fast=False)
    assert_jax_equal(y1, jy, wire)
    assert_jax_equal(e1, je, wire)


def test_live_subset_quantized_tiers_equal_jax():
    live = (1, 2, 4, 6, 7)
    lidx = live_index_for(live)
    x = rand((SIZE, len(live) * SLOT), seed=13)
    for wire in ("bf16", "int8", "int4"):
        assert_jax_equal(port(x, lidx, wire=wire, fast=False),
                         jax_rs(x, lidx, wire=wire, fast=False), wire)


# -- quantized envelopes and the residual ------------------------------------------------


@pytest.mark.parametrize("wire,tol", [("bf16", 2e-2), ("int8", 2e-2), ("int4", 2e-1)])
def test_quantized_tier_envelope(wire, tol):
    x = rand((SIZE, SIZE * SLOT), seed=9)
    lidx = full_live_index()
    y = port(x, lidx, wire=wire, fast=False)
    assert np.abs(y - scatter_oracle(x, lidx, SLOT)).max() <= tol


def test_ef_residual_telescopes():
    x = rand((SIZE, SIZE * SLOT), seed=10)
    lidx = full_live_index()
    exact = scatter_oracle(x, lidx, SLOT)
    e = torch.zeros(SIZE, SIZE * SLOT)
    y1, e1 = port(x, lidx, wire="int4_ef", ef=e, fast=False)
    assert np.abs(e1).sum() > 0
    y2, _ = port(x, lidx, wire="int4_ef", ef=torch.from_numpy(e1), fast=False)
    assert np.abs((y1 + y2) / 2 - exact).max() < np.abs(y1 - exact).max()


def test_ef_dead_destination_residual_untouched():
    dead = 7
    lidx = full_live_index()
    lmask = tuple(0.0 if r == dead else 1.0 for r in range(SIZE))
    x = rand((SIZE, SIZE * SLOT), seed=11)
    e0 = rand((SIZE, SIZE * SLOT), seed=12) * 0.1
    _y, e1 = port(x, lidx, wire="int8_ef", ef=torch.from_numpy(e0), live_mask=lmask, fast=False)
    dead_sl = slice(dead * SLOT, (dead + 1) * SLOT)
    for r in range(SIZE):
        if r == dead:
            continue
        assert np.array_equal(e1[r, dead_sl], e0[r, dead_sl]), r
        live_to = (r + 1) % SIZE
        if live_to == dead:
            live_to = (r + 2) % SIZE
        sl = slice(live_to * SLOT, (live_to + 1) * SLOT)
        assert not np.array_equal(e1[r, sl], e0[r, sl]), r
    _jy, je = jax_rs(x, lidx, wire="int8_ef", ef=e0, live_mask=lmask, fast=False)
    assert_jax_equal(e1, je, "int8_ef")


# -- refusals --------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,width,match", [
    (dict(wire="int8_ef"), SIZE * SLOT, "needs the per-slot residual"),
    (dict(), SIZE * SLOT + SIZE, "not a multiple of slot"),
    (dict(wire="fp8"), SIZE * SLOT, "reduce_scatter wire"),
    (dict(live_mask=(1.0,) * 3), SIZE * SLOT, "live_mask"),
    (dict(wire="int4_ef", ef=torch.zeros(SIZE, SLOT)), SIZE * SLOT, "residual has"),
])
def test_refusals(kwargs, width, match):
    with pytest.raises(ValueError, match=match):
        inner.reduce_scatter(torch.zeros(SIZE, width), full_live_index(), SLOT,
                             fast=False, **kwargs)


# -- the compiler's reduce-scatter family --------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 5, 8])
def test_compile_reduce_scatter_equals_jax(size):
    # both memoize per size at the first call's payload: start from fresh caches
    compiler.clear_compile_cache()
    jcompiler.clear_compile_cache()
    info, jinfo = compiler.compile_reduce_scatter(size), jcompiler.compile_reduce_scatter(size)
    assert info.perms == jinfo.perms and info.rounds == jinfo.rounds == size - 1
    assert info.congestion == jinfo.congestion
    assert info.predicted_cost_s == pytest.approx(jinfo.predicted_cost_s, rel=1e-12)
    assert compiler.compile_reduce_scatter(size) is info
    compiler.clear_compile_cache()
    assert compiler.compile_reduce_scatter(size) is not info
    with pytest.raises(ValueError, match="positive mesh"):
        compiler.compile_reduce_scatter(0)


@pytest.mark.parametrize("payload,elems", [(2048.0, 512), (64 * 1024 * 1024.0, 16 << 20),
                                           (1e6, 250_000), (94.4e6, 23_609_344)])
def test_reduce_scatter_chunks_equals_jax(payload, elems, monkeypatch):
    assert compiler.reduce_scatter_chunks(SIZE, payload, n_elems=elems) == \
        jcompiler.reduce_scatter_chunks(SIZE, payload, n_elems=elems)
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "3")
    assert compiler.reduce_scatter_chunks(SIZE, payload, n_elems=elems) == \
        jcompiler.reduce_scatter_chunks(SIZE, payload, n_elems=elems)
