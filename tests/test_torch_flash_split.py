# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The lse form's backward on the ``sm90`` route, on the CPU: the f32
cotangent split into two bf16 halves, and the kernels' arithmetic.

``flash.split_cotangent`` gives ``hi = bf16(dO)`` and ``lo = bf16(dO -
hi)``; the ``sm90`` dK/dV and dQ kernels then form every product with dO as
a sum of bf16 products with f32 sums: ``dP = hi V^T + lo V^T`` and ``dV =
P_hi^T hi + P_hi^T lo + P_lo^T hi`` (``P_hi = bf16(P)``, ``P_lo = bf16(P -
P_hi)``), dS rounded to bf16 as on the bf16 route; the autograd backward
hands them ``delta = rowsum((hi + lo) O)``, the delta of the cotangent they
see. A CUDA kernel cannot run here, so a test-local composite of exactly
those products (bf16 values, whose products are exact; summed here in f64,
so that what remains is the split's own error) stands in for it and is held
to the plain versions, which keep P and dO in f32 (the contract of
``bluefog_tpu/ops/flash.py``'s ``_bwd_call``), to 1e-4 of each row's norm
before the outputs' rounding to bf16; and, with that rounding, to the JAX
package's Pallas backward in ``interpret=True``. The split cases of
``chip_smoke.py``'s flash-parity, whose cotangents make the low-half
chains visible at bf16 outputs, are checked here to do so.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu.ops import flash as jflash
from bluefog_tpu_torch.ops import flash
from bluefog_tpu_torch.ops.attention import _expand_kv

import chip_smoke

# the composite against the f32 plain versions, before output rounding: each
# row's error within 1e-4 of its norm, the norm floored at 1e-2 of the rows'
# root-mean-square norm. The split's error is 2^-17 of dO, 1.0e-5 to 1.3e-5
# of the RMS row norm in every row here; an early causal query's dQ can be
# 1.5e-3 of the RMS (its lse cotangent drawn small), and carries the same
# absolute error
COMPOSITE_TOL = 1e-4
COMPOSITE_FLOOR = 1e-2
BF16_TOL = chip_smoke.FLASH_ROW_TOL[torch.bfloat16]


def _operands(seed, b, t, h, h_kv, d, dlse=True):
    """bf16 q, k, v and an f32 cotangent and lse cotangent, from numpy."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, t, n, d).astype(np.float32)).to(torch.bfloat16)
               for n in (h, h_kv, h_kv))
    do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, h, t).astype(np.float32)) if dlse else None
    return q, k, v, do, g


def _backward_args(q, k, v, do, dlse, causal, split_delta=False):
    """The backward's operands after the plain forward; ``delta`` from dO,
    or with ``split_delta`` from ``hi + lo`` (what the autograd backward
    hands the split kernels)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash.flash_fwd_reference(q, k, v, causal, scale, torch.float32)
    if split_delta:
        hi, lo = flash.split_cotangent_reference(do)
        delta = flash.attention_delta(out, hi.float() + lo.float())
    else:
        delta = flash.attention_delta(out, do)
    return (q, k, v, do, lse, delta, dlse, causal, scale)


def composite(q, k, v, do, lse, delta, dlse, causal, scale, chains=("hi.hi", "hi.lo", "lo.hi"),
              dp_lo=True, round_ds=True):
    """The ``sm90`` backward's arithmetic on a split cotangent before the
    outputs' rounding: ``(dK, dV, dQ)`` f32, from the kernels' f32 P and
    the products of bf16 values, summed in f64. ``chains`` names the dV
    products (``P half . dO half``), ``dp_lo`` whether dP takes ``lo
    V^T``; ``round_ds`` rounds dS to bf16 (the kernels do)."""
    f64 = torch.float64
    p, _ds = flash._recompute(q, k, v, do, lse, delta, dlse, causal, scale)
    hi, lo = flash.split_cotangent_reference(do)
    vv = _expand_kv(q, v).to(f64)
    dp = torch.einsum("bqhd,bkhd->bhqk", hi.to(f64), vv)
    if dp_lo:
        dp = dp + torch.einsum("bqhd,bkhd->bhqk", lo.to(f64), vv)
    c = dp - delta.to(f64)[..., None]
    if dlse is not None:
        c = c + dlse.to(f64)[..., None]
    ds = p.to(f64) * c * scale
    if round_ds:
        ds = ds.to(torch.bfloat16).to(f64)
    p_hi = p.to(torch.bfloat16)
    halves = {"hi": (p_hi.to(f64), hi.to(f64)),
              "lo": ((p - p_hi.float()).to(torch.bfloat16).to(f64), lo.to(f64))}
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", halves[a][0], halves[b][1])
             for a, b in (c.split(".") for c in chains))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f64))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand_kv(q, k).to(f64))
    h_kv = k.shape[2]
    return tuple(x.float() for x in (flash._group_sum(dk, h_kv), flash._group_sum(dv, h_kv), dq))


# -- the split --------------------------------------------------------------


def _cotangents():
    """f32 cotangents: random, with edge values (zeros of both signs,
    subnormals, bf16 ties, bf16's largest and past it), a strided view and
    an expanded one."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(2, 40, 4, 16) * 3).astype(np.float32))
    edge = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                         3.389e38, -3.4e38, 1e-3, -7.5e5])
    x.view(-1)[:edge.numel()] = edge
    wide = torch.from_numpy(rng.randn(2, 40, 4, 40).astype(np.float32))[..., 3:39]
    expanded = torch.from_numpy(rng.randn(40, 4, 16).astype(np.float32)).expand(2, 40, 4, 16)
    return {"contiguous": x, "strided": wide, "expanded": expanded}


@pytest.mark.parametrize("layout", ["contiguous", "strided", "expanded"])
def test_split_reference_is_its_definition(layout):
    """``hi == dO.bfloat16()`` bitwise, and ``hi + lo`` is dO to 2^-16 of
    each entry (2^-17 by construction, where bf16 does not overflow), or to
    half of bf16's smallest subnormal step, 2^-134, where lo is subnormal."""
    do = _cotangents()[layout]
    hi, lo = flash.split_cotangent_reference(do)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.is_contiguous() and lo.is_contiguous() and hi.shape == do.shape
    assert torch.equal(hi.view(torch.int16), do.to(torch.bfloat16).contiguous().view(torch.int16))
    finite = torch.isfinite(hi)
    err = (hi.float() + lo.float() - do)[finite].abs()
    bound = torch.clamp_min(2.0 ** -16 * do[finite].abs(), 2.0 ** -134)
    assert bool((err <= bound).all()), float((err / bound).max())
    # past bf16's largest value the high half is inf and the low half -inf
    assert torch.equal(~finite, do.abs() > 3.3961e38)


def test_split_cotangent_takes_the_plain_version_on_the_cpu():
    flash.reset_launch_counts()
    for do in _cotangents().values():
        hi, lo = flash.split_cotangent(do)
        rhi, rlo = flash.split_cotangent_reference(do)
        assert torch.equal(hi.view(torch.int16), rhi.view(torch.int16))
        assert torch.equal(lo.view(torch.int16), rlo.view(torch.int16))
    assert flash.split_launch_count() == 0


@pytest.mark.parametrize("bad", ["bf16", "last axis", "rank"])
def test_split_cotangent_refuses_what_the_kernel_does_not_take(bad):
    do = torch.zeros(1, 8, 2, 16)
    do = {"bf16": do.to(torch.bfloat16), "last axis": do.transpose(2, 3),
          "rank": do[0]}[bad]
    with pytest.raises(ValueError):
        flash.split_cotangent(do)


# -- the kernels' arithmetic ------------------------------------------------

SHAPES = [  # (b, t, h, h_kv, d, causal)
    (1, 96, 4, 4, 64, False),
    (2, 70, 4, 2, 64, True),
    (1, 64, 2, 1, 128, True),
    (1, 50, 2, 2, 96, False),
]


def _ids(c):
    return f"b{c[0]}-t{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-{'causal' if c[5] else 'full'}"


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_composite_dv_matches_plain_version_before_rounding(shape):
    """dV of the three bf16 chains against ``flash_bwd_dkv_reference``
    (P and dO in f32), within 1e-4 of each row's norm. The reference runs on
    f32 copies of K and V, so it returns dV unrounded; its dK keeps dS
    rounded to bf16 (q stays bf16)."""
    b, t, h, h_kv, d, causal = shape
    q, k, v, do, dlse = _operands(31, b, t, h, h_kv, d)
    args = _backward_args(q, k, v, do, dlse, causal)
    _rdk, rdv = flash.flash_bwd_dkv_reference(q, k.float(), v.float(), *args[3:])
    _dk, dv, _dq = composite(*_backward_args(q, k, v, do, dlse, causal, split_delta=True))
    assert rdv.dtype == torch.float32
    err = chip_smoke.row_err(dv, rdv, COMPOSITE_FLOOR)
    assert err <= COMPOSITE_TOL, err


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_composite_dk_dq_match_plain_versions_before_rounding(shape):
    """dK and dQ of the two dP chains, with the split's delta, against the
    plain versions (delta from dO) within 1e-4 of each row's norm. dS is
    held unrounded on both sides (the plain versions on f32 copies of q, k,
    v; the composite with ``round_ds`` off): where the f32 dP differs in
    its last bits, bf16's rounding of dS flips by a whole bf16 step on
    about 1e-3 of the entries, which is the bf16 route's own error, not the
    split's. With delta from dO instead, the first causal rows, whose ``dP
    - delta`` cancels, miss by up to 1.5e-3 of their norm."""
    b, t, h, h_kv, d, causal = shape
    q, k, v, do, dlse = _operands(32, b, t, h, h_kv, d)
    args = _backward_args(q, k, v, do, dlse, causal)
    f32 = [x.float() for x in (q, k, v)]
    rdk, _rdv = flash.flash_bwd_dkv_reference(*f32, *args[3:])
    rdq = flash.flash_bwd_dq_reference(*f32, *args[3:])
    dk, _dv, dq = composite(*_backward_args(q, k, v, do, dlse, causal, split_delta=True),
                            round_ds=False)
    for name, got, want in (("dk", dk, rdk), ("dq", dq, rdq)):
        err = chip_smoke.row_err(got, want, COMPOSITE_FLOOR)
        assert err <= COMPOSITE_TOL, (name, err)


@pytest.mark.parametrize("dropped", ["hi.lo", "lo.hi", "dp_lo"])
def test_each_chain_is_needed(dropped):
    """Without any one of the low-half chains, the composite misses the f32
    plain versions by more than 1e-4 of a row: the ``P_lo^T hi`` chain,
    about 2^-9 of dV and so below the outputs' bf16 rounding on the card,
    is held here."""
    q, k, v, do, dlse = _operands(33, 1, 96, 4, 2, 64)
    args = _backward_args(q, k, v, do, dlse, False)
    f32 = [x.float() for x in (q, k, v)]
    if dropped == "dp_lo":
        rdq = flash.flash_bwd_dq_reference(*f32, *args[3:])
        _dk, _dv, dq = composite(*_backward_args(q, k, v, do, dlse, False, split_delta=True),
                                 dp_lo=False, round_ds=False)
        err = chip_smoke.row_err(dq, rdq, COMPOSITE_FLOOR)
    else:
        _rdk, rdv = flash.flash_bwd_dkv_reference(q, k.float(), v.float(), *args[3:])
        chains = tuple(c for c in ("hi.hi", "hi.lo", "lo.hi") if c != dropped)
        _dk, dv, _dq = composite(*args, chains=chains)
        err = chip_smoke.row_err(dv, rdv, COMPOSITE_FLOOR)
    assert err > 10 * COMPOSITE_TOL, err


@pytest.mark.parametrize("causal", [False, True])
def test_composite_matches_jax_lse_backward(causal):
    """The composite, its outputs rounded to bf16, against the JAX
    package's Pallas backward of ``flash_attention_with_lse`` in
    ``interpret=True`` on the same bf16 q, k, v and f32 cotangents (out and
    lse), every row within ``FLASH_ROW_TOL``: the two round P, dS and the
    outputs at other places."""
    b, t, h, h_kv, d = 1, 80, 4, 2, 64
    q, k, v, do, dlse = _operands(34, b, t, h, h_kv, d)
    args = _backward_args(q, k, v, do, dlse, causal, split_delta=True)
    dk, dv, dq = (x.to(torch.bfloat16) for x in composite(*args))
    jq, jk, jv = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16) for x in (q, k, v))
    _res, vjp = jax.vjp(lambda *a: jflash.flash_attention_with_lse(*a, causal=causal,
                                                                   interpret=True), jq, jk, jv)
    jdq, jdk, jdv = (torch.from_numpy(np.array(g.astype(jnp.float32)))
                     for g in vjp((jnp.asarray(do.numpy()), jnp.asarray(dlse.numpy()))))
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert chip_smoke.row_err(got, want) <= BF16_TOL[name], (name,
                                                                 chip_smoke.row_err(got, want))


def test_autograd_backward_splits_once_and_takes_the_split_delta(monkeypatch):
    """On the card, ``flash_attention_with_lse``'s backward splits its f32
    cotangent once, hands both kernels the same halves on ``sm90``, and a
    delta from ``hi + lo`` (run here with the device check answering
    "cuda" and the kernels recording their operands)."""
    seen = {}

    def kernel(name):
        def run(q, k, v, do, lse, delta, dlse, causal, scale, route, halves=None):
            seen[name] = (delta, route, halves)
            shape = (q.shape,) if name == "dq" else (k.shape, v.shape)
            outs = tuple(torch.zeros(s, dtype=q.dtype) for s in shape)
            return outs[0] if name == "dq" else outs
        return run

    splits = []
    real_split = flash.split_cotangent
    monkeypatch.setattr(flash, "_dispatch_device", lambda *tensors: "cuda")
    monkeypatch.setattr(flash, "_dkv_kernel", kernel("dkv"))
    monkeypatch.setattr(flash, "_dq_kernel", kernel("dq"))
    monkeypatch.setattr(flash, "split_cotangent",
                        lambda do: splits.append(do) or flash.split_cotangent_reference(do))
    q, k, v, do, dlse = _operands(35, 1, 40, 4, 2, 64)
    scale = 1.0 / math.sqrt(64)
    out, lse = flash.flash_fwd_reference(q, k, v, True, scale, torch.float32)
    ctx = type("Ctx", (), {"saved_tensors": (q, k, v, out, lse), "causal": True,
                           "scale": scale})()
    flash._backward(ctx, do, dlse)
    assert len(splits) == 1 and real_split is not flash.split_cotangent
    (d1, r1, h1), (d2, r2, h2) = seen["dkv"], seen["dq"]
    assert r1 == r2 == "sm90" and h1 is h2 and d1 is d2
    hi, lo = flash.split_cotangent_reference(do)
    assert torch.equal(h1[0], hi) and torch.equal(h1[1], lo)
    assert torch.equal(d1, flash.attention_delta(out, hi.float() + lo.float()))


# -- chip_smoke.py's split cases ---------------------------------------------


@pytest.mark.parametrize("name,d", [("split-dv", 64), ("split-dp", 128)])
def test_split_cases_cancel_the_high_halves(name, d):
    """The pairs' high halves cancel exactly, each cotangent is the exact
    sum of its halves, and the pair's ``e`` stays below 2^-11 of
    ``bf16(x)``."""
    q, k, v, do, dlse = chip_smoke.split_operands(torch.device("cpu"), name, 1, 60, 4, 2, d)
    assert dlse is None and do.dtype == torch.float32
    hi, lo = (x.float() for x in flash.split_cotangent_reference(do))
    assert torch.equal(hi + lo, do)
    if name == "split-dv":
        assert torch.equal(q[:, 0::2], q[:, 1::2])
        a, b = (slice(None), slice(0, None, 2)), (slice(None), slice(1, None, 2))
    else:
        assert torch.equal(v[..., 0::2], v[..., 1::2])
        a, b = (Ellipsis, slice(0, None, 2)), (Ellipsis, slice(1, None, 2))
    assert torch.equal(hi[a], -hi[b])
    assert bool(((do[a] + do[b]) - lo[a] <= 2.0 ** -11 * hi[a].abs()).all())


@pytest.mark.parametrize("name,d,dropped,caught", [
    ("split-dv", 64, None, None), ("split-dv", 64, "hi.lo", "dv"),
    ("split-dp", 128, None, None), ("split-dp", 128, "dp_lo", "dq"),
    ("split-dp", 128, "dp_lo", "dk"),
])
def test_split_cases_see_the_low_half_chains(name, d, dropped, caught):
    """The composite with bf16 outputs passes each split case's held
    outputs within ``FLASH_ROW_TOL``; without the chain the case is built
    for (a planted fault of chip_smoke.py), the output it names is off by
    O(1)."""
    q, k, v, do, dlse = chip_smoke.split_operands(torch.device("cpu"), name, 1, 200, 4, 2, d)
    args = _backward_args(q, k, v, do, dlse, False)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    kw = {"hi.lo": dict(chains=("hi.hi", "lo.hi")), "dp_lo": dict(dp_lo=False)}.get(dropped, {})
    dk, dv, dq = (x.to(torch.bfloat16) for x in composite(*args, **kw))
    errs = {"dq": chip_smoke.row_err(dq, rdq), "dk": chip_smoke.row_err(dk, rdk),
            "dv": chip_smoke.row_err(dv, rdv)}
    if dropped is None:
        held = [n for n in chip_smoke.SPLIT_HELD[name] if n != "out"]
        assert all(errs[n] <= BF16_TOL[n] for n in held), errs
    else:
        assert errs[caught] > 0.5, errs
