# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's CUDA kernels on the card, against their plain versions.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, ``tests/conftest.py`` (which imports JAX) is left
out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import inner, kernels
from bluefog_tpu_torch.collective.plan import plan_from_topology
from bluefog_tpu_torch.ops import batchnorm as bn_ops

SIZE = 8
WIRES = ["int8", "int4"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def ragged_input(device, seed=5, n=3000):
    """``[8, n]`` (n % 512 != 0) with an all-zero block and a block of
    +-tiny multiples, whose scale is subnormal, in every row."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(SIZE, n) * 5.0).astype(np.float32)
    x[:, :512] = 0.0
    tiny = np.finfo(np.float32).tiny
    x[:, 512:1024] = tiny * rng.choice([-1.0, 1.0], (SIZE, 512)) * rng.randint(1, 9, (SIZE, 512))
    return torch.from_numpy(x).to(device)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_kernels_bitwise_equal_plain_versions(cuda, wire):
    """Both kernels against their plain versions on the same inputs,
    bitwise, over a full-permutation plan and a partial one (the star);
    each wrapper counts exactly its own launches."""
    acc = kernels.pad_blocks(ragged_input(cuda)).contiguous()
    before = kernels.launch_counts()
    payload, scales = kernels.encode(acc, wire)
    ref_p, ref_s = kernels.encode_reference(acc, wire)
    assert torch.equal(payload, ref_p)
    assert torch.equal(_bits(scales), _bits(ref_s))
    for graph in (topo.ExponentialTwoGraph(SIZE), topo.StarGraph(SIZE)):
        src, _self_w, recv_w = inner.plan_operands(plan_from_topology(graph), cuda)
        got = kernels.decode_accumulate(acc.clone(), payload, scales, src, recv_w, wire)
        ref = kernels.decode_accumulate_reference(acc.clone(), payload, scales, src,
                                                  recv_w, wire)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref))
    after = kernels.launch_counts()
    assert after["encode"] == before["encode"] + 1
    assert after["decode_accumulate"] == before["decode_accumulate"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_neighbor_allreduce_on_card_equals_cpu(cuda, wire):
    """The eager gossip on the card (kernels) equals the same call on the
    CPU (plain versions) bit for bit."""
    x = ragged_input(cuda, seed=6)
    try:
        bft.init(device="cuda")
        got = bft.neighbor_allreduce(x, compression=wire).cpu()
        bft.init(device="cpu")
        want = bft.neighbor_allreduce(x.cpu(), compression=wire)
    finally:
        bft.shutdown()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_wrappers_refuse_bad_cuda_operands(cuda):
    x = torch.zeros(SIZE, 1024, device=cuda)
    with pytest.raises(ValueError):
        kernels.encode(x.double(), "int8")
    with pytest.raises(ValueError):
        kernels.encode(torch.zeros(512, SIZE, device=cuda).t(), "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_new_kernels_bitwise_equal_plain_versions(cuda, wire):
    """encode_diff (payload, scales and the updated copy), decode_add and
    decode against their plain versions, bitwise, over Exp2 and the star
    (whose partial permutations give src = -1); each wrapper counts
    exactly its own launches."""
    x = kernels.pad_blocks(ragged_input(cuda, seed=7)).contiguous()
    h0 = kernels.pad_blocks(ragged_input(cuda, seed=8) * 0.5).contiguous()
    before = kernels.launch_counts()
    h, h_ref = h0.clone(), h0.clone()
    p, s = kernels.encode_diff(x, h, wire)
    rp, rs = kernels.encode_diff_reference(x, h_ref, wire)
    torch.cuda.synchronize()
    assert torch.equal(p, rp) and torch.equal(_bits(s), _bits(rs))
    assert torch.equal(_bits(h), _bits(h_ref))
    own = kernels.decode(p, s, None, wire)
    assert torch.equal(_bits(own), _bits(kernels.decode_reference(p, s, None, wire)))
    n_rounds = 0
    for graph in (topo.ExponentialTwoGraph(SIZE), topo.StarGraph(SIZE)):
        src, _self_w, _recv_w = inner.plan_operands(plan_from_topology(graph), cuda)
        for r in range(src.shape[0]):
            n_rounds += 1
            got = kernels.decode_add(h0.clone(), p, s, src[r], wire)
            ref = kernels.decode_add_reference(h0.clone(), p, s, src[r], wire)
            dec = kernels.decode(p, s, src[r], wire)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(ref))
            assert torch.equal(_bits(dec), _bits(kernels.decode_reference(p, s, src[r], wire)))
    after = kernels.launch_counts()
    assert after["encode_diff"] == before["encode_diff"] + 1
    assert after["decode_add"] == before["decode_add"] + n_rounds
    assert after["decode"] == before["decode"] + 1 + n_rounds


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_ef_and_pushsum_on_card_equal_cpu(cuda, wire, monkeypatch):
    """Three int*_ef gossip steps and three push-sum steps on the
    quantized window wire: the card (kernels) equals the CPU (plain
    versions) bit for bit."""
    monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", wire)
    x = ragged_input(cuda, seed=9)
    results = {}
    try:
        for dev in ("cuda", "cpu"):
            bft.init(device=dev)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
            opt.compression = f"{wire}_ef"
            params = {"w": x.to(dev).clone()}
            state = opt.init(params)
            for _ in range(3):
                opt.step(params, state, {"w": params["w"] * 0.01})
            ps = bft.DistributedPushSumOptimizer(bft.sgd(0.1))
            pstate = ps.init({"w": x.to(dev).clone()})
            for _ in range(3):
                est = ps.params()
                est, pstate = ps.step(pstate, {"w": est["w"] * 0.01})
            results[dev] = (params["w"].cpu(), opt._ef[0][1].cpu(), est["w"].cpu())
            ps.free()
    finally:
        bft.shutdown()
    for got, want in zip(results["cuda"], results["cpu"]):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n_workers,n_chunks,src", [(3, 7, [2, -1, 0]), (8, 5, None),
                                                   (5, 13, [4, 3, -1, 1, 0])])
def test_decode_tail_bitwise_equals_plain_version(cuda, wire, n_workers, n_chunks, src):
    """decode on block counts (21, 40, 65) that are no multiple of the four
    blocks a warp takes or the 32 a CTA takes, with missing senders (-1):
    bitwise equal to its plain version."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.randn(n_workers, n_chunks * 512) * 3.0).astype(np.float32))
    x[:, :512] = 0.0
    p, s = kernels.encode(x.to(cuda), wire)
    src_r = None if src is None else torch.tensor(src, dtype=torch.int32, device=cuda)
    got = kernels.decode(p, s, src_r, wire)
    want = kernels.decode_reference(p, s, src_r, wire)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_new_wrappers_refuse_bad_cuda_operands(cuda):
    x = torch.zeros(SIZE, 1024, device=cuda)
    p, s = kernels.encode(x, "int8")
    src = torch.arange(SIZE, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # h on another device
        kernels.encode_diff(x, torch.zeros(SIZE, 1024), "int8")
    with pytest.raises(ValueError):  # dtype
        kernels.encode_diff(x, x.double(), "int8")
    with pytest.raises(ValueError):  # not 16-byte aligned
        kernels.encode_diff(x, torch.zeros(SIZE * 1024 + 1, device=cuda)[1:].view(SIZE, 1024),
                            "int8")
    with pytest.raises(ValueError):  # shape
        kernels.decode_add(torch.zeros(SIZE, 512, device=cuda), p, s, src, "int8")
    with pytest.raises(ValueError):  # src out of range
        kernels.decode_add(x.clone(), p, s, src + 1, "int8")
    with pytest.raises(ValueError):
        kernels.decode(p, s, src - 2, "int8")
    with pytest.raises(ValueError):  # src dtype
        kernels.decode(p, s, src.long(), "int8")
    with pytest.raises(ValueError):  # scales of the other wire
        kernels.decode(p, s.to(torch.bfloat16), None, "int8")


# -- flash attention (B6-B8) ----------------------------------------------------

# (b, t, h, h_kv, d, causal, dtype, with_lse, offset): bf16 causal and not, a
# ragged T with GQA, head_dim 96 and 128, rows off 16 bytes (head_dim 36, and
# operands shifted by one element in their buffer: the bf16 route's scalar
# loads), f32, and the lse form (f32 out, so an f32 cotangent beside bf16
# q/k/v) with a nonzero lse cotangent
FLASH_CASES = [
    (2, 256, 4, 4, 64, True, torch.bfloat16, False, 0),
    (1, 300, 4, 2, 64, False, torch.bfloat16, False, 0),
    (1, 200, 2, 2, 96, True, torch.bfloat16, False, 0),
    (1, 130, 2, 1, 128, True, torch.bfloat16, False, 0),
    (1, 150, 4, 2, 36, True, torch.bfloat16, False, 0),
    (1, 150, 4, 2, 64, True, torch.bfloat16, False, 1),
    (1, 100, 2, 2, 64, True, torch.float32, False, 0),
    (1, 150, 4, 2, 64, True, torch.bfloat16, True, 0),
]

# Each output row (a query's out or dQ, a key's dK or dV) is held to its own
# norm, with chip_smoke.py's limits (about 3x the largest value measured on
# an H100): bf16 inputs, where each side rounds its outputs to bf16 and the
# kernels round P at a running row maximum; f32, where sums run in another
# order. The lse is held absolutely. The f32 cases above head_dim 128 here
# (T <= 100) keep the f32 limit; chip_smoke.py's d160f32 case (T 1000) has
# its own, ``FLASH_ROW_TOL_F32_WIDE``.
_ROW_TOL = {
    torch.bfloat16: {"out": 1.6e-2, "dq": 1.6e-2, "dk": 2.2e-2, "dv": 1.2e-2},
    torch.float32: {"out": 2e-6, "dq": 2e-6, "dk": 2e-6, "dv": 2e-6},
}
_LSE_TOL = 6e-6


def _row_err(got, want, floor=1e-3):
    """Largest ``||got - want|| / ||want||`` over the rows (the last axis),
    each row's norm floored at ``floor`` times the rows' root-mean-square
    norm (causal dQ of the first query cancels to rounding noise); an
    all-zero ``want`` must be matched exactly."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    denom = norm.clamp_min(floor * float(norm.square().mean().sqrt()))
    return float(torch.where(denom > 0, diff / denom,
                             torch.where(diff > 0, float("inf"), 0.0)).max())


def _operands(rng, cuda, dtype, offset, *shapes):
    """Tensors of ``shapes`` from ``rng``, each ``offset`` elements into its
    own buffer on the card."""
    out = []
    for shape in shapes:
        n = int(np.prod(shape))
        flat = torch.from_numpy(rng.randn(offset + n).astype(np.float32)).to(cuda, dtype)
        out.append(flat[offset:].view(*shape))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"t{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                         f"{'causal' if c[5] else 'full'}-{str(c[6])[6:]}{'-lse' if c[7] else ''}"
                         f"{'-offset' if c[8] else ''}")
def test_flash_kernels_match_plain_versions(cuda, case):
    """flash_fwd, flash_bwd_dkv and flash_bwd_dq against their plain
    versions on the same inputs, every output row within ``_ROW_TOL`` of
    its own norm. Each wrapper counts one launch."""
    from bluefog_tpu_torch.ops import flash

    b, t, h, h_kv, d, causal, dtype, with_lse, offset = case
    rng = np.random.RandomState(21)
    q, k, v = _operands(rng, cuda, dtype, offset, (b, t, h, d), (b, t, h_kv, d), (b, t, h_kv, d))
    scale = 1.0 / np.sqrt(d)
    out_dtype = torch.float32 if with_lse else dtype
    tol = _ROW_TOL[dtype]
    before = flash.launch_counts()
    out, lse = flash.flash_fwd(q, k, v, causal, scale, out_dtype)
    rout, rlse = flash.flash_fwd_reference(q, k, v, causal, scale, out_dtype)
    assert out.dtype == out_dtype and _row_err(out, rout) <= tol["out"]
    assert float((lse - rlse).abs().max()) <= _LSE_TOL
    do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(cuda, out_dtype)
    dlse = torch.from_numpy(rng.randn(b, h, t).astype(np.float32)).to(cuda) if with_lse else None
    delta = flash.attention_delta(rout, do)
    args = (q, k, v, do, rlse, delta, dlse, causal, scale)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq = flash.flash_bwd_dq(*args)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert _row_err(got, want) <= tol[name], (name, _row_err(got, want))
    after = flash.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


@pytest.mark.cuda
def test_flash_attention_gradients_on_card_match_cpu(cuda):
    """The autograd path end to end: bf16 causal attention on the card
    (kernels) against the same call on the CPU (plain versions), every
    row within ``_ROW_TOL`` of its norm."""
    from bluefog_tpu_torch.ops import flash_attention

    rng = np.random.RandomState(22)
    base = [torch.from_numpy(rng.randn(2, 200, 4, 64).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]
    w = torch.from_numpy(rng.randn(2, 200, 4, 64).astype(np.float32))
    results = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (x.to(dev).requires_grad_(True) for x in base)
        out = flash_attention(q, k, v, causal=True)
        (out.float() * w.to(dev)).sum().backward()
        results[dev.type] = [x.detach().cpu() for x in (out, q.grad, k.grad, v.grad)]
    tol = _ROW_TOL[torch.bfloat16]
    for name, got, want in zip(("out", "dq", "dk", "dv"), results["cuda"], results["cpu"]):
        assert _row_err(got, want) <= tol[name], (name, _row_err(got, want))


@pytest.mark.cuda
def test_flash_wrappers_refuse_bad_cuda_operands(cuda):
    from bluefog_tpu_torch.ops import flash

    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # mixed dtypes
        flash.flash_fwd(q, q.float(), q, True, 0.125)
    with pytest.raises(ValueError, match="limit of 256"):  # head_dim above 256
        z = torch.zeros(1, 64, 2, 264, device=cuda, dtype=torch.bfloat16)
        flash.flash_fwd(z, z, z, True, 0.125)
    with pytest.raises(ValueError):  # last axis not contiguous
        flash.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, True, 0.125)
    with pytest.raises(ValueError):  # operands on two devices
        flash.flash_fwd(q, q.cpu(), q, True, 0.125)


# (b, t, h, h_kv, d, causal, dtype, with_lse, routes): head_dim above 128.
# bf16 takes the mma route (DP 256, one 128-column half of the outputs a
# block); f32 operands, and the lse form's f32 cotangent beside bf16 q/k/v
# that sm90 does not take, take simt (SD 256).
WIDE_CASES = [
    (1, 150, 4, 4, 160, True, torch.bfloat16, False, ("mma", "mma", "mma")),
    (1, 150, 4, 2, 256, False, torch.bfloat16, False, ("mma", "mma", "mma")),
    (2, 100, 2, 2, 256, True, torch.bfloat16, False, ("mma", "mma", "mma")),
    (1, 100, 2, 1, 160, True, torch.float32, False, ("simt", "simt", "simt")),
    (1, 100, 2, 2, 256, False, torch.float32, False, ("simt", "simt", "simt")),
    (1, 150, 4, 2, 160, True, torch.bfloat16, True, ("mma", "simt", "simt")),
    (1, 130, 2, 2, 256, False, torch.bfloat16, True, ("mma", "simt", "simt")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: f"t{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                         f"{'causal' if c[5] else 'full'}-{str(c[6])[6:]}{'-lse' if c[7] else ''}")
def test_head_dims_above_128_match_plain_versions(cuda, case):
    """head_dim 160 and 256 take a hand-written kernel on the route the
    case names; every output row within ``_ROW_TOL`` of its norm, the lse
    within ``_LSE_TOL``."""
    from bluefog_tpu_torch.ops import flash

    b, t, h, h_kv, d, causal, dtype, with_lse, routes = case
    rng = np.random.RandomState(25)
    q, k, v = _operands(rng, cuda, dtype, 0, (b, t, h, d), (b, t, h_kv, d), (b, t, h_kv, d))
    scale = 1.0 / np.sqrt(d)
    out_dtype = torch.float32 if with_lse else dtype
    tol = _ROW_TOL[dtype]
    before = flash.route_counts()
    out, lse = flash.flash_fwd(q, k, v, causal, scale, out_dtype)
    rout, rlse = flash.flash_fwd_reference(q, k, v, causal, scale, out_dtype)
    do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(cuda, out_dtype)
    dlse = torch.from_numpy(rng.randn(b, h, t).astype(np.float32)).to(cuda) if with_lse else None
    delta = flash.attention_delta(rout, do)
    args = (q, k, v, do, rlse, delta, dlse, causal, scale)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq = flash.flash_bwd_dq(*args)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    after = flash.route_counts()
    took = tuple(next(r for r in flash.ROUTES if after[n][r] > before[n][r])
                 for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    assert took == routes
    assert float((lse - rlse).abs().max()) <= _LSE_TOL
    for name, got, want in (("out", out, rout), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert _row_err(got, want) <= tol[name], (name, _row_err(got, want))


# (b, t, h, h_kv, d, causal): the wgmma/TMA route's edges. T 1, 127, 129 and
# 200 against its 128-row tiles (and the dK/dV kernel's 64-row Q tiles), a
# causal T below one tile, grouped-query 16/4 at T 1000, head_dim 96 (TMA
# zero-fills the columns 96..127) and 128 (two 64-column panels)
SM90_CASES = [
    (1, 1, 2, 2, 64, True),
    (2, 127, 2, 2, 64, True),
    (1, 129, 4, 2, 64, True),
    (1, 200, 2, 2, 64, False),
    (2, 50, 4, 4, 64, True),
    (1, 1000, 16, 4, 64, True),
    (1, 300, 4, 4, 96, True),
    (1, 300, 4, 2, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_CASES, ids=lambda c: f"t{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                         f"{'causal' if c[5] else 'full'}")
def test_sm90_route_matches_plain_versions(cuda, case):
    """q, k and v split from one fused bf16 projection (as the transformer
    gives them) take the sm90 route for all three kernels; every output row
    within ``_ROW_TOL`` of its norm, the lse within ``_LSE_TOL``."""
    from bluefog_tpu_torch.ops import flash
    from chip_smoke import with_poisoned_tail

    b, t, h, h_kv, d, causal = case
    rng = np.random.RandomState(23)
    width = (h + 2 * h_kv) * d
    qkv = torch.from_numpy(rng.randn(b, t, width).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (x.reshape(b, t, -1, d) for x in qkv.split([h * d, h_kv * d, h_kv * d], -1))
    do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(cuda, torch.bfloat16)
    scale = 1.0 / np.sqrt(d)
    tol = _ROW_TOL[torch.bfloat16]
    before = flash.route_counts()
    out, lse = flash.flash_fwd(q, k, v, causal, scale)
    rout, rlse = flash.flash_fwd_reference(q, k, v, causal, scale)
    # the per-row vectors before poisoned tails: a read past t of the last
    # head meets a huge negative lse or a NaN delta and gives NaN
    delta = with_poisoned_tail(flash.attention_delta(rout, do), float("nan"))
    args = (q, k, v, do, with_poisoned_tail(rlse, -1e30), delta, None, causal, scale)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq = flash.flash_bwd_dq(*args)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    after = flash.route_counts()
    took = {k: [r for r in flash.ROUTES if after[k][r] > before[k][r]] for k in after}
    assert took == {"flash_fwd": ["sm90"], "flash_bwd_dkv": ["sm90"], "flash_bwd_dq": ["sm90"]}
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rlse))
    assert float((lse - rlse).abs().max()) <= _LSE_TOL
    for name, got, want in (("out", out, rout), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if t == 1 and name in ("dq", "dk"):
            # one key: P = 1 and dP = delta, so dS, dQ and dK are 0 in exact
            # arithmetic and every row is rounding noise
            assert float(got.float().abs().max()) <= 1e-5, name
            continue
        assert _row_err(got, want) <= tol[name], (name, _row_err(got, want))


# (b, t, h, h_kv, d, causal, with_dlse): the sm90 dQ kernel's edges. Ragged T
# against its 128-row Q tiles and 128- (d 64) or 64-key (d 128) K tiles,
# head_dim 96 (TMA zero-fills columns 96..127) and 128, grouped-query K/V,
# a non-causal case, and a nonzero lse cotangent beside a bf16 cotangent
SM90_DQ_CASES = [
    (1, 1000, 4, 4, 64, True, False),
    (2, 300, 4, 4, 96, True, False),
    (1, 259, 4, 2, 128, True, False),
    (1, 1000, 16, 4, 64, True, False),
    (1, 333, 4, 2, 64, False, False),
    (1, 200, 4, 4, 128, False, True),
    (1, 517, 4, 4, 64, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_DQ_CASES, ids=lambda c: f"t{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                         f"{'causal' if c[5] else 'full'}{'-dlse' if c[6] else ''}")
def test_sm90_dq_matches_plain_version(cuda, case):
    """flash_bwd_dq on the sm90 route against flash_bwd_dq_reference, every
    row within ``_ROW_TOL``, with lse, delta and dlse in front of poisoned
    tails (a read past t of the last head meets a huge negative lse or NaN)."""
    from bluefog_tpu_torch.ops import flash
    from chip_smoke import with_poisoned_tail

    b, t, h, h_kv, d, causal, with_dlse = case
    rng = np.random.RandomState(24)
    width = (h + 2 * h_kv) * d
    qkv = torch.from_numpy(rng.randn(b, t, width).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (x.reshape(b, t, -1, d) for x in qkv.split([h * d, h_kv * d, h_kv * d], -1))
    do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(cuda, torch.bfloat16)
    dlse = (with_poisoned_tail(torch.from_numpy(rng.randn(b, h, t).astype(np.float32)).to(cuda),
                               float("nan")) if with_dlse else None)
    scale = 1.0 / np.sqrt(d)
    rout, rlse = flash.flash_fwd_reference(q, k, v, causal, scale)
    delta = with_poisoned_tail(flash.attention_delta(rout, do), float("nan"))
    args = (q, k, v, do, with_poisoned_tail(rlse, -1e30), delta, dlse, causal, scale)
    before = flash.route_counts()["flash_bwd_dq"]
    dq = flash.flash_bwd_dq(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    after = flash.route_counts()["flash_bwd_dq"]
    assert {r: after[r] - before[r] for r in flash.ROUTES} == {"sm90": 1, "mma": 0, "simt": 0}
    assert dq.dtype == q.dtype and dq.shape == q.shape and dq.is_contiguous()
    assert _row_err(dq, rdq) <= _ROW_TOL[torch.bfloat16]["dq"], _row_err(dq, rdq)


# (b, t, h, h_kv, d, causal): the lse form (f32 out and cotangent, a nonzero
# lse cotangent) on the sm90 route, the cotangent split into two bf16
# halves: T 1 and 127 against the 64- and 128-row tiles, a causal T below
# one tile, grouped-query 16/4 at T 1000, head_dim 96 and 128
SM90_LSE_CASES = [
    (1, 1, 2, 2, 64, True),
    (2, 127, 2, 2, 64, True),
    (2, 50, 4, 4, 64, True),
    (1, 1000, 16, 4, 64, True),
    (1, 300, 4, 4, 96, True),
    (1, 300, 4, 2, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_LSE_CASES, ids=lambda c: f"t{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                         f"{'causal' if c[5] else 'full'}")
def test_sm90_lse_form_matches_plain_versions(cuda, case):
    """bf16 q/k/v from one fused projection with an f32 cotangent: dK/dV and
    dQ on ``sm90`` after one split each (a direct call splits for itself),
    every row within ``_ROW_TOL`` of the plain versions (f32 P and dO), with
    lse, delta and dlse in front of poisoned tails."""
    from bluefog_tpu_torch.ops import flash
    from chip_smoke import with_poisoned_tail

    b, t, h, h_kv, d, causal = case
    rng = np.random.RandomState(27)
    width = (h + 2 * h_kv) * d
    qkv = torch.from_numpy(rng.randn(b, t, width).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (x.reshape(b, t, -1, d) for x in qkv.split([h * d, h_kv * d, h_kv * d], -1))
    do = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(cuda)
    dlse = with_poisoned_tail(torch.from_numpy(rng.randn(b, h, t).astype(np.float32)).to(cuda),
                              float("nan"))
    scale = 1.0 / np.sqrt(d)
    rout, rlse = flash.flash_fwd_reference(q, k, v, causal, scale, torch.float32)
    delta = with_poisoned_tail(flash.attention_delta(rout, do), float("nan"))
    args = (q, k, v, do, with_poisoned_tail(rlse, -1e30), delta, dlse, causal, scale)
    before, splits = flash.route_counts(), flash.split_launch_count()
    dk, dv = flash.flash_bwd_dkv(*args)
    dq = flash.flash_bwd_dq(*args)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    after = flash.route_counts()
    assert {n: {r: after[n][r] - before[n][r] for r in flash.ROUTES}
            for n in ("flash_bwd_dkv", "flash_bwd_dq")} == {
        "flash_bwd_dkv": {"sm90": 1, "mma": 0, "simt": 0},
        "flash_bwd_dq": {"sm90": 1, "mma": 0, "simt": 0}}
    assert flash.split_launch_count() - splits == 2
    tol = _ROW_TOL[torch.bfloat16]
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        # (at T 1, dS = P dlse scale: the lse cotangent keeps dQ and dK away
        # from the cancellation of dP - delta)
        assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, name
        assert _row_err(got, want) <= tol[name], (name, _row_err(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "wide", "offset", "expanded"])
def test_split_cotangent_bitwise_equals_plain_version(cuda, layout):
    """The f32 cotangent's two bf16 halves, on a contiguous tensor with edge
    values (zeros of both signs, subnormals, bf16 ties, values that round to
    bf16's largest and past it), a view of a wider buffer (the vector
    path), a view one element off 16 bytes at head_dim 36 and an expanded
    view (the scalar path): bitwise, contiguous, one launch each."""
    from bluefog_tpu_torch.ops import flash
    from chip_smoke import check_split, split_inputs

    inputs = dict(zip(["contiguous", "wide", "offset", "expanded"],
                      split_inputs(cuda, b=2, t=96, h=4, d=64)))
    do = inputs[layout]
    assert do.is_contiguous() == (layout == "contiguous")
    before = flash.split_launch_count()
    assert check_split(do) == 0.0
    assert flash.split_launch_count() - before == 1


# -- the sequence-parallel layers and the dry run ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_card_matches_cpu(cuda, causal):
    """Ring attention over 4 workers (bf16, grouped-query 4/2, head_dim 64)
    on the card against the same call on the CPU (the plain versions):
    out and the gradients of q, k and v, every row within ``_ROW_TOL``.
    Each round launches all three kernels on ``sm90`` (bf16 q/k/v, f32 out)
    and splits the round's f32 cotangent once for both backward kernels."""
    from bluefog_tpu_torch.ops import flash, ring_attention

    rng = np.random.RandomState(26)
    n, b, t, d = 4, 2, 100, 64
    base = [torch.from_numpy(rng.randn(n, b, t, h, d).astype(np.float32)).to(torch.bfloat16)
            for h in (4, 2, 2)]
    w = torch.from_numpy(rng.randn(n, b, t, 4, d).astype(np.float32))
    results = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (x.to(dev).requires_grad_(True) for x in base)
        before, splits = flash.route_counts(), flash.split_launch_count()
        out = ring_attention(q, k, v, causal=causal)
        (out.float() * w.to(dev)).sum().backward()
        after = flash.route_counts()
        results[dev.type] = [x.detach().float().cpu() for x in (out, q.grad, k.grad, v.grad)]
        if dev.type == "cuda":
            took = {kname: {r: after[kname][r] - before[kname][r] for r in flash.ROUTES}
                    for kname in after}
            assert took == {"flash_fwd": {"sm90": n, "mma": 0, "simt": 0},
                            "flash_bwd_dkv": {"sm90": n, "mma": 0, "simt": 0},
                            "flash_bwd_dq": {"sm90": n, "mma": 0, "simt": 0}}
            assert flash.split_launch_count() - splits == n
    tol = _ROW_TOL[torch.bfloat16]
    for name, got, want in zip(("out", "dq", "dk", "dv"), results["cuda"], results["cpu"]):
        assert _row_err(got, want) <= tol[name], (name, _row_err(got, want))


@pytest.mark.cuda
def test_dryrun_on_card_equals_cpu(cuda):
    """Three dry-run steps (step indices 0, 1, 2: one period of the
    one-peer Exp2 schedule) on the card and on the CPU from the same
    seeded parameters: parameters, momentum and metric to 1e-5 relative;
    each step's ring attention (the card's on ``simt``) row by row within
    ``_ROW_TOL``."""
    from bluefog_tpu_torch.dryrun import DryRun

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        run = DryRun(8, device=dev)
        params = run.init_params()
        state = run.tx.init(params)
        metrics, attns = [], []
        for i in range(3):
            params, state, metric, attn = run.step(params, state, torch.tensor([i], device=dev))
            metrics.append(metric)
            attns.append(attn)
        runs[dev.type] = [x.cpu() for x in (params, state, torch.cat(metrics, 1))]
        runs[dev.type + "_attn"] = [a.cpu() for a in attns]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    for got, want in zip(runs["cuda_attn"], runs["cpu_attn"]):
        assert _row_err(got, want) <= _ROW_TOL[torch.float32]["out"], _row_err(got, want)


def _facade_context(dev):
    bft.init(size=SIZE, device=dev, nodes_per_machine=2)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_machine_topology(topo.RingGraph(SIZE // 2))


def _facade_ops():
    """``name -> (call, bitwise)``: the copies and the quantized wires are
    bitwise equal across devices, the sums within 1e-6 of the largest
    value (another summation order)."""
    gens = [topo.GetDynamicOnePeerSendRecvRanks(topo.ExponentialGraph(SIZE), r)
            for r in range(SIZE)]
    pairs = [next(g) for g in gens]
    dyn = dict(self_weight=[1.0 / (len(r) + 1) for _s, r in pairs],
               src_weights=[{i: 1.0 / (len(r) + 1) for i in r} for _s, r in pairs],
               dst_weights=[list(s) for s, _r in pairs])
    gather = lambda wire: lambda x: torch.stack(  # noqa: E731
        bft.neighbor_allgather(x, compression=wire))
    return {
        "allreduce": (bft.allreduce, False),
        "allgather": (bft.allgather, True),
        "broadcast": (lambda x: bft.broadcast(x, 5), True),
        "neighbor_allreduce dynamic": (lambda x: bft.neighbor_allreduce(x, **dyn), False),
        "neighbor_allreduce dynamic int4": (
            lambda x: bft.neighbor_allreduce(x, compression="int4", **dyn), True),
        "neighbor_allgather": (gather(None), True),
        "neighbor_allgather bf16": (gather("bf16"), True),
        "neighbor_allgather int8": (gather("int8"), True),
        "neighbor_allgather int4": (gather("int4"), True),
        "hierarchical": (bft.hierarchical_neighbor_allreduce, False),
        "pair_gossip": (lambda x: bft.pair_gossip(x, [(0, 3), (5, 6)]), False),
        "allreduce nonblocking": (lambda x: bft.synchronize(bft.allreduce_nonblocking(x)), False),
        "neighbor_allgather int8 nonblocking": (
            lambda x: torch.stack(bft.synchronize(
                bft.neighbor_allgather_nonblocking(x, compression="int8"))), True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(_facade_ops()))
def test_facade_on_card_matches_cpu(cuda, op):
    """Each facade op on the card against the same call on the CPU (the
    plain versions), on a ragged width; the int8/int4 wires launch their
    kernels."""
    call, bitwise = _facade_ops()[op]
    x = ragged_input(torch.device("cpu"), seed=21)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        _facade_context(dev)
        before = kernels.launch_counts()
        outs[dev.type] = call(x.to(dev)).cpu()
        if dev.type == "cuda" and ("int8" in op or "int4" in op):
            after = kernels.launch_counts()
            assert after["encode"] > before["encode"]
    got, want = outs["cuda"], outs["cpu"]
    assert got.shape == want.shape and got.dtype == want.dtype
    if bitwise:
        assert torch.equal(_bits(got), _bits(want))
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_neighbor_allgather_quantized_on_card_is_bitwise_the_cpu(cuda, wire):
    """int8/int4 ``neighbor_allgather`` on the ragged star graph: the
    card's ``encode`` and ``decode`` kernels give the CPU's bits."""
    x = ragged_input(torch.device("cpu"), seed=22)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        bft.init(size=SIZE, device=dev)
        bft.set_topology(topo.StarGraph(SIZE))
        outs[dev.type] = [t.cpu() for t in bft.neighbor_allgather(x.to(dev), compression=wire)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("compression", [None, "int8"])
def test_make_train_step_on_card_matches_cpu(cuda, compression):
    """Two fused steps of a small f32 ResNet through ``make_train_step`` on
    the card (TF32 off) and on the CPU from the same parameters: losses to
    1e-4, parameters within 1e-4 of the largest (convolutions sum in
    another order on the card), or with the int8 wire within one quantum
    (the largest value / 127) a step, since a value that lands on the
    other side of a rounding boundary moves by a whole quantum. 8 images
    of 64x64 a worker: with 2 of 32x32 the last stages' BatchNorm
    normalizes over 2 values, and the card's gradient differs from the
    CPU's by 1e-3 of its norm already at the first step."""
    from bluefog_tpu_torch.models import ResNet50, StackedModel, resnet

    outs = {}
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(SIZE, 8, 64, 64, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 8), generator=gen)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in (cuda, torch.device("cpu")):
            bft.init(size=SIZE, device=dev)
            model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                                   stage_sizes=[1, 1, 1, 1],
                                                   dtype=torch.float32), 0)
            sm = StackedModel(model, SIZE, dev)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
            opt.compression = compression
            params = sm.replicate()
            state = opt.init(params)
            step = opt.make_train_step(sm.worker_loss)
            for _ in range(2):
                params, state, loss = step(params, state, images.to(dev), labels.to(dev),
                                           torch.arange(SIZE))
            outs[dev.type] = (params.cpu(), loss.cpu())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (pg, lg), (pw, lw) = outs["cuda"], outs["cpu"]
    assert torch.isfinite(pg).all()
    torch.testing.assert_close(lg, lw, rtol=1e-4, atol=1e-4)
    scale = float(pw.abs().max())
    tol = 1e-4 * scale if compression is None else 2 * scale / 127
    torch.testing.assert_close(pg, pw, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bf16"] + WIRES)
def test_neighbor_allreduce_wire_on_card_is_bitwise_the_cpu(cuda, wire):
    """The combine wires, bf16 included, on the weighted Exp2 graph: the
    card gives the CPU's bits (bf16: a rounding, then per round one
    subtract, one multiply, one add, each its own kernel)."""
    x = ragged_input(torch.device("cpu"), seed=23)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        _facade_context(dev)
        outs[dev.type] = bft.neighbor_allreduce(x.to(dev), compression=wire).cpu()
    assert torch.equal(_bits(outs["cuda"]), _bits(outs["cpu"]))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp32", "bf16"] + WIRES)
def test_async_ticks_on_card_match_cpu(cuda, wire):
    """Twelve ticks of ``make_async_train_step`` on the ring with rank 6 at
    one tenth of the cadence (the gate drops its edge from tick 6) on the
    card and on the CPU: estimates within 1e-6 of the largest value (the
    same elementwise operations on both), the same counters and
    advisories; on the int8/int4 wires ``encode`` once and ``decode``
    twice a tick."""
    rng = np.random.RandomState(0)
    z0 = rng.randn(SIZE, 3000).astype(np.float32)
    targets = z0 + rng.randn(SIZE, 3000).astype(np.float32)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        bft.init(size=SIZE, device=dev)
        bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05, momentum=0.9))
        params = {"w": torch.from_numpy(z0).to(dev)}
        state = opt.init(params)
        step = bft.make_async_train_step(
            opt, lambda p, t: 0.5 * torch.mean((p["w"] - t) ** 2), cadence={6: 10},
            max_age=4, wire=wire)
        before = kernels.launch_counts()
        for _ in range(12):
            params, state, loss = step(params, state, torch.from_numpy(targets).to(dev))
        after = kernels.launch_counts()
        if dev.type == "cuda" and wire in WIRES:
            assert after["encode"] - before["encode"] == 12
            assert after["decode"] - before["decode"] == 24
        outs[dev.type] = (params["w"].cpu(), loss.cpu(), step.engine.summary(),
                          [a.to_json() for a in step.engine.advisories])
    (pg, lg, sg, ag), (pw, lw, sw, aw) = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(pg, pw, rtol=0, atol=1e-6 * float(pw.abs().max()))
    torch.testing.assert_close(lg, lw, rtol=1e-6, atol=0)
    assert sg == sw and ag == aw and sg["stale_drops"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("chunks", [1, 3])
def test_reduce_scatter_on_card_is_bitwise_the_cpu(cuda, wire, chunks):
    """The ZeRO-2 scatter's int8/int4 tiers on the card give the CPU's
    bits: one ``encode`` and one ``decode`` a round (7 rounds of 8
    workers), the adds in f32 on both."""
    rng = np.random.RandomState(31)
    slot = 3 * 512
    x = torch.from_numpy((rng.randn(SIZE, SIZE * slot) * 3).astype(np.float32))
    lidx = tuple(range(SIZE))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        before = kernels.launch_counts()
        outs[dev.type] = inner.reduce_scatter(x.to(dev), lidx, slot, wire=wire, chunks=chunks,
                                              fast=False).cpu()
        after = kernels.launch_counts()
        if dev.type == "cuda":
            assert after["encode"] - before["encode"] == SIZE - 1
            assert after["decode"] - before["decode"] == SIZE - 1
    assert torch.equal(_bits(outs["cuda"]), _bits(outs["cpu"]))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [SIZE * 1536, SIZE * 1536 - 700, 5 * 1536 + 3])
def test_one_sum_scatter_on_an_unpadded_payload_on_card(cuda, width):
    """The ZeRO-2 fp32 scatter's one-sum form reads the unpadded gradient
    on the card: bitwise the allreduce's owned slots (the bits ZeRO-2
    shares with the replicated path), and within 1e-6 of the largest value
    of the padded payload's and of the CPU's (``torch.sum`` may add the 8
    rows in another order for another width or device)."""
    rng = np.random.RandomState(34)
    slot = 1536
    x = torch.from_numpy(rng.randn(SIZE, width).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, SIZE * slot - width))
    lidx = tuple(range(SIZE))
    got = inner._reduce_scatter(x.to(cuda), lidx, slot, True, None, 1, None, None, fast=True)
    mean = inner.allreduce(x.to(cuda))[0]
    assert torch.equal(_bits(got.reshape(-1)[:width].cpu()), _bits(mean.cpu()))
    want = inner.reduce_scatter(padded.to(cuda), lidx, slot, fast=True)
    assert float((got - want).abs().max()) <= 1e-6 * float(x.abs().max())
    cpu = inner._reduce_scatter(x, lidx, slot, True, None, 1, None, None, fast=True)
    assert float((got.cpu() - cpu).abs().max()) <= 1e-6 * float(x.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "int4_ef"])
def test_bucketed_combine_on_card_is_bitwise_monolithic(cuda, wire, monkeypatch):
    """Three ATC steps on the card with 8 KiB buckets and 3 chunks against
    the monolithic combine (``BLUEFOG_OVERLAP=0``) on the card: the same
    bits; the bucketed run launches the wire kernels once a bucket."""
    rng = np.random.RandomState(32)
    x0 = torch.from_numpy(rng.randn(SIZE, 9000).astype(np.float32)).to(cuda)
    outs, launches = {}, {}
    for name, env in (("mono", {"BLUEFOG_OVERLAP": "0"}),
                      ("bucketed", {"BLUEFOG_BUCKET_BYTES": "8192", "BLUEFOG_PLAN_CHUNKS": "3"})):
        for k in ("BLUEFOG_OVERLAP", "BLUEFOG_BUCKET_BYTES", "BLUEFOG_PLAN_CHUNKS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        bft.init(size=SIZE, device=cuda)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        params = {"w": x0.clone()}
        state = opt.init(params)
        before = kernels.launch_counts()
        for _ in range(3):
            opt.step(params, state, {"w": params["w"] * 0.5})
        after = kernels.launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        outs[name] = params["w"].cpu()
    assert torch.equal(_bits(outs["bucketed"]), _bits(outs["mono"]))
    first = "encode" if wire == "int8" else "encode_diff"
    assert launches["mono"][first] == 3 and launches["bucketed"][first] == 3 * 5


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_zero2_step_on_card_matches_cpu(cuda, wire, monkeypatch):
    """Four ZeRO-2 Adam steps with the scatter on the int8/int4 wire, on the
    card and on the CPU from the same inputs: parameters within 1e-6 of
    the largest value (the scatter is bitwise; Adam's power and square
    root may round differently on the card), ``encode`` and ``decode``
    launched on every step."""
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1")
    rng = np.random.RandomState(33)
    c = torch.from_numpy(rng.randn(SIZE, 4099).astype(np.float32))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        bft.init(size=SIZE, device=dev)
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
        opt.compression = wire
        params = {"w": torch.zeros(SIZE, 4099, device=dev)}
        state = opt.init(params)
        for _ in range(4):
            before = kernels.launch_counts()
            opt.step(params, state, {"w": params["w"] - c.to(dev)})
            after = kernels.launch_counts()
            if dev.type == "cuda":
                assert after["encode"] > before["encode"] and after["decode"] > before["decode"]
        outs[dev.type] = params["w"].cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0,
                               atol=1e-6 * float(outs["cpu"].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "int4_ef"])
def test_metrics_probe_on_card_matches_cpu(cuda, wire, monkeypatch):
    """``BLUEFOG_METRICS=1`` at interval 1 on the card: the parameters
    bitwise those of metrics off and of the same steps on the CPU, the
    probe's output bitwise the first columns of the ATC combine, and the
    gauges (folded from the pinned copy after its event) within 1e-6
    relative of the CPU's."""
    from bluefog_tpu_torch import metrics

    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    # the probe covers the zero block, the +-tiny block and a normal one
    monkeypatch.setenv("BLUEFOG_METRICS_SAMPLE_ELEMS", "2048")
    x = ragged_input("cpu", seed=8)
    results = []
    for device, on in ((cuda, False), (cuda, True), (torch.device("cpu"), True)):
        monkeypatch.setenv("BLUEFOG_METRICS", "1" if on else "0")
        metrics.reset()
        bft.init(device=device)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        p = {"w": x.clone().to(device)}
        s = opt.init(p)
        for _ in range(3):
            opt.step(p, s, {"w": p["w"] * 0.1})
        metrics.flush()
        if on:
            sub, y, _scale, _ef = opt._last_probe[0]
            assert torch.equal(_bits(y), _bits(p["w"][:, :y.shape[1]].contiguous()))
        gauges = {k: v["value"] for k, v in metrics.snapshot().items()
                  if k.startswith("bluefog.gossip.")}
        results.append((p["w"].cpu(), gauges))
    bft.shutdown()
    off, card, cpu = results
    assert torch.equal(_bits(off[0]), _bits(card[0])) and torch.equal(_bits(card[0]), _bits(cpu[0]))
    assert set(card[1]) == set(cpu[1]) and "bluefog.gossip.quant_err" in card[1]
    for k, v in cpu[1].items():
        assert abs(card[1][k] - v) <= 1e-6 * abs(v), (k, card[1][k], v)


@pytest.mark.cuda
def test_synchronize_behind_a_late_kernel_is_a_stall(cuda, tmp_path, monkeypatch):
    """A ``synchronize`` waiting behind ``torch.cuda._sleep`` past the
    watchdog's deadline counts one stall and leaves a flight dump."""
    import json
    import time

    from bluefog_tpu_torch import metrics, watchdog

    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path))
    bft.init(device=cuda)
    before = metrics.counter("bluefog.stalls").value
    watchdog.set_stall_timeout(0.2)
    try:
        torch.cuda._sleep(int(2e9))
        handle = bft.allreduce_nonblocking(torch.ones(SIZE, 64, device=cuda))
        bft.synchronize(handle)
        time.sleep(0.3)  # the watchdog's poll
    finally:
        watchdog.set_stall_timeout(60)
        bft.shutdown()
    assert metrics.counter("bluefog.stalls").value == before + 1
    dump = json.load(open(tmp_path / "flight_0.json"))
    assert dump["reason"] == f"stall:synchronize(handle {handle})"


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "int4_ef"])
def test_elastic_kill_on_card_is_bitwise_its_twin(cuda, wire):
    """A rank killed under the elastic guard on the card: the parameters
    after every step bitwise those of a twin run without a session that
    installs the repaired topology by hand before the kill step, and the
    wire kernels launched on every step."""
    from bluefog_tpu_torch.elastic import repaired_topology

    x0 = torch.from_numpy(np.random.RandomState(3).randn(SIZE, 4096).astype(np.float32))
    grads = [torch.from_numpy(np.random.RandomState(10 + t).randn(SIZE, 4096)
                              .astype(np.float32)).to(cuda) for t in range(6)]
    names = ("encode", "decode_accumulate") if wire == "int8" else ("encode_diff", "decode_add")

    def run(session_on):
        bft.init(device=cuda)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        if session_on:
            session = bft.elastic.start(policy="average")
            session.inject("kill", rank=4, step=2)
            step = bft.elastic.guard(opt).step
        else:
            step = opt.step
        params = {"w": x0.to(cuda)}
        state = opt.init(params)
        out = []
        for t, g in enumerate(grads):
            if not session_on and t == 2:
                live = [r for r in range(SIZE) if r != 4]
                bft.set_topology(repaired_topology(topo.ExponentialTwoGraph(SIZE), live),
                                 is_weighted=True)
            before = kernels.launch_counts()
            params, state = step(params, state, {"w": g})
            after = kernels.launch_counts()
            assert all(after[k] > before[k] for k in names), (t, before, after)
            out.append(params["w"].cpu())
        if session_on:
            assert len(session.repairs) == 1 and session.stale_dispatches == 0
            bft.elastic.stop()
        bft.shutdown()
        return out

    for t, (a, b) in enumerate(zip(run(True), run(False))):
        assert torch.equal(_bits(a), _bits(b)), t


@pytest.mark.cuda
def test_calibration_beta_is_bounded_by_the_memory_rate(cuda):
    """The measured probe of the stacked transport on the card: a round of
    the ``[8, elems]`` gather reads and writes all eight rows, so ``beta x
    2 x 8`` (the bytes HBM moves a second) is at most the H100 SXM's 3.35e12
    B/s; a reading above it timed nothing."""
    from bluefog_tpu_torch.collective import compiler

    bft.init(size=SIZE, device=cuda)
    try:
        cal = compiler.calibrate(link_class=compiler.TRANSPORT_LINK_CLASS, force=True)
        assert cal["source"] == "measured-probe" and cal["alpha_s"] > 0
        assert 0 < cal["beta_bytes_per_s"] * 2 * SIZE <= 3.35e12, cal
        assert 0.0 <= cal["pipeline_eff"] <= 1.0
    finally:
        compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
        bft.shutdown()


@pytest.mark.cuda
def test_memory_census_reconciles_with_the_allocator(cuda):
    """On the card ``other`` is the allocator's allocated bytes less the
    classified ones, so the census total equals ``allocated_bytes.all.current``
    as the sample read it (the step's temporaries are freed after it), and the
    Adam state reconciles exactly."""
    from bluefog_tpu_torch import memory

    bft.init(size=SIZE, device=cuda)
    try:
        obs = memory.start(interval=1)
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.01))
        params = {"w": torch.randn(SIZE, 1 << 16, device=cuda)}
        state = opt.init(params)
        params, state = opt.step(params, state, {"w": torch.zeros_like(params["w"])})
        s = obs.samples[-1]
        classified = sum(r["bytes"] for c, r in s["census"].items() if c != "other")
        assert s["live_bytes_total"] == s["device_bytes_in_use"] >= classified
        assert memory.device_bytes_in_use(bft.get_context()) == \
            torch.cuda.memory_stats(cuda)["allocated_bytes.all.current"]
        assert s["measured_state_bytes"] == s["analytic_state_bytes"]
        assert s["census"]["params"]["bytes"] == SIZE * (1 << 16) * 4
    finally:
        memory.stop()
        bft.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_relay_combine_on_encode_and_decode_accumulate_is_bitwise_plain(cuda, wire):
    """The relay int8/int4 combine on the card (Exp2(8) under the short-cut
    family: 7 relay rounds; the star: origins that feed two receivers in one
    round, so a round's source row is no permutation) launches one
    ``encode`` and one ``decode_accumulate`` and equals the same call on the
    plain versions bit for bit."""
    x = kernels.pad_blocks(ragged_input(cuda, seed=9)).contiguous()
    for graph, rounds in ((topo.ExponentialTwoGraph(SIZE), 7), (topo.StarGraph(SIZE), 8)):
        plan = plan_from_topology(graph, method="shortcut")
        assert plan.relay and len(plan.rounds) == rounds
        src, _self_w, recv_w = inner.plan_operands(plan, cuda)
        before = kernels.launch_counts()
        got = inner.weighted_combine_quantized_operands(x.clone(), src, recv_w, wire=wire,
                                                        inplace=True)
        after = kernels.launch_counts()
        want = inner.weighted_combine_quantized_operands(x.cpu(), src.cpu(), recv_w.cpu(),
                                                         wire=wire)
        assert torch.equal(_bits(got.cpu()), _bits(want))
        assert after["encode"] == before["encode"] + 1
        assert after["decode_accumulate"] == before["decode_accumulate"] + 1
    assert any(len(set(row.tolist()) - {-1}) < int((row >= 0).sum()) for row in src.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_relay_allgather_on_decode_is_bitwise_plain_and_direct(cuda, wire):
    """The relay ``neighbor_allgather`` on the card (``encode`` once,
    ``decode`` per neighbour slot) equals the plain versions and the direct
    plan's gather bit for bit."""
    graph = topo.ExponentialTwoGraph(SIZE)
    relay = plan_from_topology(graph, method="shortcut")
    direct = plan_from_topology(graph)
    x = ragged_input(cuda, seed=10)
    before = kernels.launch_counts()
    got, mask = inner.neighbor_allgather(x, relay, wire=wire)
    after = kernels.launch_counts()
    want, _ = inner.neighbor_allgather(x.cpu(), relay, wire=wire)
    same, _ = inner.neighbor_allgather(x, direct, wire=wire)
    assert torch.equal(_bits(got.cpu()), _bits(want)) and torch.equal(_bits(got), _bits(same))
    assert after["decode"] == before["decode"] + relay.max_in_degree
    assert mask.all()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_federated_combine_on_the_card_is_bitwise_plain(cuda, wire, monkeypatch):
    """The federated ATC step (``BLUEFOG_PODS=2``, period 2, DCN wire int4)
    on the card: a DCN step launches two ``encode`` and two
    ``decode_accumulate`` (one each a leg), an ICI-only step one each, and
    the parameters equal the same steps on the CPU's plain versions bit for
    bit."""
    monkeypatch.setenv("BLUEFOG_PODS", "2")
    monkeypatch.setenv("BLUEFOG_DCN_PERIOD", "2")
    x = kernels.pad_blocks(ragged_input(cuda, seed=11)).contiguous()
    g = kernels.pad_blocks(ragged_input(cuda, seed=12)).contiguous()
    out, launches = {}, []
    try:
        for dev in ("cuda", "cpu"):
            bft.init(device=dev)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = wire
            params = {"w": x.to(dev).clone()}
            state = opt.init(params)
            for _ in range(2):
                before = kernels.launch_counts()
                opt.step(params, state, {"w": g.to(dev)})
                after = kernels.launch_counts()
                launches.append((after["encode"] - before["encode"],
                                 after["decode_accumulate"] - before["decode_accumulate"]))
            out[dev] = params["w"].cpu()
    finally:
        bft.shutdown()
    assert launches[:2] == [(2, 2), (1, 1)] and launches[2:] == [(0, 0), (0, 0)]
    assert torch.equal(_bits(out["cuda"]), _bits(out["cpu"]))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
def test_slo_canary_on_the_card_equals_the_host_replay(cuda, wire):
    """The canary on the card (int8/int4: one ``encode`` and one ``decode``
    a round) delivers the plain versions' blocks bit for bit, so its verdict
    against ``wire_ref`` is the CPU's: ok on every edge of Exp2(8), with the
    same deviation."""
    from bluefog_tpu_torch import slo

    verdicts = {}
    try:
        for dev in ("cuda", "cpu"):
            bft.init(device=dev)
            bft.set_topology(topo.ExponentialTwoGraph(SIZE))
            plan = plan_from_topology(bft.get_context().load_topology())
            before = kernels.launch_counts()
            verdicts[dev] = slo.CanaryLane().probe(bft.get_context(), plan, wire)
            after = kernels.launch_counts()
            if dev == "cuda" and wire in WIRES:
                assert after["encode"] - before["encode"] == 1
                assert after["decode"] - before["decode"] == len(plan.rounds)
    finally:
        bft.shutdown()
    assert verdicts["cuda"]["ok"] and verdicts["cuda"] == verdicts["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("wire,tiers", [("int8", ""), ("int8", "int4_ef")],
                         ids=["int8", "to-int4_ef"])
def test_combine_after_a_controller_swap_is_bitwise_plain(cuda, wire, tiers, monkeypatch):
    """A persistent degraded-link trigger makes the topology controller
    migrate the ATC run off the ring (with ``BLUEFOG_AUTOTUNE_WIRE=int4_ef``
    onto a candidate carrying ``int4_ef``); the step after the swap on the
    card equals the same steps on the CPU's plain versions bit for bit, and
    launches what the new plan implies: int8 one ``encode`` and one
    ``decode_accumulate`` (in place, whole blocks), int4_ef one
    ``encode_diff`` and a ``decode_add`` a round."""
    from bluefog_tpu_torch import autotune

    monkeypatch.setenv("BLUEFOG_AUTOTUNE_WIRE", tiers)
    trig = [{"kind": "degraded_link", "source": "doctor", "edge": [2, 3], "ratio": 20.0}]
    x = kernels.pad_blocks(ragged_input(cuda, seed=13)).contiguous()
    g = kernels.pad_blocks(ragged_input(cuda, seed=14)).contiguous()
    out, chosen, launches = {}, {}, {}
    try:
        for dev in ("cuda", "cpu"):
            bft.init(device=dev, topology_fn=topo.RingGraph)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = wire
            params = {"w": x.to(dev).clone()}
            state = opt.init(params)
            opt.step(params, state, {"w": g.to(dev)})
            tuner = autotune.TopologyAutotuner(interval=1, cooldown=4)
            for t in range(2):
                tuner.observe(bft.get_context(), step=t, optimizer=opt, step_s=0.01,
                              triggers=trig)
            assert tuner.swaps == 1
            chosen[dev] = (tuner.decisions[-1].chosen, opt.compression)
            before = kernels.launch_counts()
            opt.step(params, state, {"w": g.to(dev)})
            after = kernels.launch_counts()
            launches[dev] = {k: after[k] - before[k] for k in after}
            out[dev] = params["w"].cpu()
            rounds = len(bft.get_context().static_plan().rounds)
    finally:
        bft.shutdown()
    assert chosen["cuda"] == chosen["cpu"]
    if tiers:
        assert chosen["cuda"][1] == "int4_ef"
        assert launches["cuda"]["encode_diff"] == 1
        assert launches["cuda"]["decode_add"] == rounds
    else:
        assert launches["cuda"]["encode"] == 1 and launches["cuda"]["decode_accumulate"] == 1
    assert torch.equal(_bits(out["cuda"]), _bits(out["cpu"]))


STAGED_WORKER = """
import os, sys
import numpy as np
import torch
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import inner, kernels
ctx = bft.init(size=8, device="cuda")
assert ctx.process_count == 2 and ctx.backend == "gloo" and ctx.staged, (ctx.backend, ctx.staged)
x = bft.worker_values(list(np.load(sys.argv[1])))
bft.set_topology(topo.ExponentialTwoGraph(8), is_weighted=True)
out = {"exact": bft.neighbor_allreduce(x)}
for wire in ("int8", "int4"):
    out[wire] = bft.neighbor_allreduce(x, compression=wire)
src, _sw, recv_w = inner.plan_operands(ctx.static_plan(), ctx.device)
for wire in ("int8", "int4"):
    state = inner.ef_state_zeros(ctx.n_local, x.shape[1], src.shape[0], ctx.device)
    z = x.clone()
    for _ in range(3):
        z = inner.weighted_combine_quantized_ef_operands(z, state, src, recv_w, wire=wire)
    out[wire + "_ef"] = z
out["allreduce"] = bft.allreduce(x)
out = {k: v.cpu() for k, v in out.items()}
out["launches"] = kernels.launch_counts()
out["rows"] = list(ctx.rows)
torch.save(out, os.path.join(sys.argv[2], f"staged_{ctx.process_index}.pt"))
bft.shutdown()
"""


@pytest.mark.cuda
def test_two_processes_sharing_the_card_equal_the_stacked_rows(cuda, tmp_path):
    """Two processes of four workers on one card (gloo, the CUDA rows staged
    through pinned host memory), started by ``bfrun-torch``: the exact,
    int8, int4, int8_ef and int4_ef combines and the allreduce on each
    process's rows equal the same rows of the stacked run on the card bit
    for bit, and each process launches ``encode``, ``decode_accumulate``,
    ``encode_diff`` and ``decode_add`` on payloads received from the other."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xs = ragged_input("cpu", seed=21).numpy()
    np.save(tmp_path / "x.npy", xs)
    script = tmp_path / "worker.py"
    script.write_text(STAGED_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", "8", "-H",
         "localhost:4,localhost:4", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         "2", str(script), str(tmp_path / "x.npy"), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    ctx = bft.init(size=8, device=cuda)
    try:
        x = bft.worker_values(list(xs))
        bft.set_topology(topo.ExponentialTwoGraph(8), is_weighted=True)
        want = {"exact": bft.neighbor_allreduce(x)}
        for wire in WIRES:
            want[wire] = bft.neighbor_allreduce(x, compression=wire)
        src, _sw, recv_w = inner.plan_operands(ctx.static_plan(), ctx.device)
        for wire in WIRES:
            state = inner.ef_state_zeros(8, x.shape[1], src.shape[0], ctx.device)
            z = x.clone()
            for _ in range(3):
                z = inner.weighted_combine_quantized_ef_operands(z, state, src, recv_w, wire=wire)
            want[wire + "_ef"] = z
        want["allreduce"] = bft.allreduce(x)
    finally:
        bft.shutdown()
    for p in range(2):
        got = torch.load(tmp_path / f"staged_{p}.pt", weights_only=False)
        assert got["rows"] == list(range(4 * p, 4 * p + 4))
        for key, ref in want.items():
            assert torch.equal(_bits(got[key]), _bits(ref.cpu()[4 * p:4 * p + 4])), (p, key)
        for k in ("encode", "decode_accumulate", "encode_diff", "decode_add"):
            assert got["launches"][k] > 0, (p, got["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_decode_of_an_extended_payload_is_bitwise_plain(cuda, wire):
    """The ``decode`` kernel with ``src [N]`` over ``P > N`` payload rows
    (the transport's extended payload: 4 local rows, then 5 received),
    senders anywhere in ``[-1, P)``, bitwise its plain version."""
    x = ragged_input(cuda, seed=31)
    x = torch.cat([x, x[:1] * 0.5])  # P = 9 payload rows
    p, s = kernels.encode(kernels.pad_blocks(x).contiguous(), wire)
    src = torch.tensor([8, -1, 0, 5], dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()["decode"]
    got = kernels.decode(p, s, src, wire)
    assert kernels.launch_counts()["decode"] == before + 1
    want = kernels.decode_reference(p.cpu(), s.cpu(), src.cpu(), wire)
    assert got.shape == (4, p.shape[1] * kernels.CHUNK)
    assert torch.equal(_bits(got.cpu()), _bits(want))


WINDOW_WORKER = """
import os, sys
import numpy as np
import torch
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import kernels
os.environ["BLUEFOG_WINDOW_WIRE"] = "int8"
ctx = bft.init(size=8, device="cuda")
assert ctx.process_count == 2 and ctx.backend == "gloo" and ctx.staged, (ctx.backend, ctx.staged)
xs = np.load(sys.argv[1])
bft.set_topology(topo.ExponentialTwoGraph(8))
bft.win_create(bft.worker_values(list(xs)), "w")
bft.turn_on_win_ops_with_associated_p()
bft.win_accumulate(bft.worker_values(list(xs * 0.5)), "w", self_weight=0.5)
bft.win_put(name="w")
win = ctx.windows["w"]
out = {f: getattr(win, f).cpu() for f in ("value", "buffers", "versions", "p", "p_buffers")}
out["launches"] = kernels.launch_counts()
out["rows"] = list(ctx.rows)
torch.save(out, os.path.join(sys.argv[2], f"window_{ctx.process_index}.pt"))
bft.shutdown()
"""


@pytest.mark.cuda
def test_two_processes_window_exchange_equals_the_stacked_rows(cuda, tmp_path):
    """Two processes of four workers sharing the card (gloo, staged): a
    ``win_accumulate`` and a ``win_put`` on the int8 window wire with the p
    lane on leave each process's lanes bitwise the same rows of the stacked
    run on the card, and each process launches ``encode`` and ``decode``
    (on payload rows received from the other)."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xs = ragged_input("cpu", seed=23).numpy()
    np.save(tmp_path / "x.npy", xs)
    script = tmp_path / "worker.py"
    script.write_text(WINDOW_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", "8", "-H",
         "localhost:4,localhost:4", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         "2", str(script), str(tmp_path / "x.npy"), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    os.environ["BLUEFOG_WINDOW_WIRE"] = "int8"
    ctx = bft.init(size=8, device=cuda)
    try:
        bft.set_topology(topo.ExponentialTwoGraph(8))
        bft.win_create(bft.worker_values(list(xs)), "w")
        bft.turn_on_win_ops_with_associated_p()
        bft.win_accumulate(bft.worker_values(list(xs * 0.5)), "w", self_weight=0.5)
        bft.win_put(name="w")
        win = ctx.windows["w"]
        want = {f: getattr(win, f).cpu() for f in ("value", "buffers", "versions", "p",
                                                    "p_buffers")}
    finally:
        del os.environ["BLUEFOG_WINDOW_WIRE"]
        bft.shutdown()
    for p in range(2):
        got = torch.load(tmp_path / f"window_{p}.pt", weights_only=False)
        assert got["rows"] == list(range(4 * p, 4 * p + 4))
        for key, ref in want.items():
            assert torch.equal(_bits(got[key]), _bits(ref[4 * p:4 * p + 4])), (p, key)
        for k in ("encode", "decode"):
            assert got["launches"][k] > 0, (p, got["launches"])


TOPOLOGY_WORKER = """
import os, sys
import numpy as np
import torch
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import kernels, transport
ctx = bft.init(size=8, device="cuda")
assert ctx.process_count == 2 and ctx.backend == "gloo" and ctx.staged, (ctx.backend, ctx.staged)
xs = np.load(sys.argv[1])
x = bft.worker_values(list(xs))
out = {"rows": list(ctx.rows)}
os.environ["BLUEFOG_PLAN_METHOD"] = "shortcut"
bft.set_topology(topo.ExponentialTwoGraph(8), is_weighted=True)
assert ctx.static_plan().relay
kernels.reset_launch_counts()
transport.reset_stats()
out["relay"] = bft.neighbor_allreduce(x, compression="int8").cpu()
out["relay:bytes"] = transport.stats()["bytes"]
out["relay:launches"] = kernels.launch_counts()
del os.environ["BLUEFOG_PLAN_METHOD"]
os.environ.update(BLUEFOG_PODS="2", BLUEFOG_DCN_PERIOD="2")
kernels.reset_launch_counts()
opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
opt.compression = "int8"
p = {"w": x.clone()}
opt.step(p, opt.init(p), {"w": x * 0.25})
out["fed"] = p["w"].cpu()
out["fed:launches"] = kernels.launch_counts()
torch.save(out, os.path.join(sys.argv[2], f"topology_{ctx.process_index}.pt"))
bft.shutdown()
"""


@pytest.mark.cuda
def test_two_processes_relay_and_federation_equal_the_stacked_rows(cuda, tmp_path):
    """Two processes of four workers sharing the card (gloo, staged): a
    relay int8 combine (``BLUEFOG_PLAN_METHOD=shortcut`` on Exp2(8),
    forwarded hop by hop) and a federated DCN step (``BLUEFOG_PODS=2``, ATC
    int8, the int4 DCN wire) leave each process's rows bitwise the same rows
    of the stacked run on the card; each process launches ``encode`` and
    ``decode_accumulate`` in both."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xs = ragged_input("cpu", seed=29).numpy()
    np.save(tmp_path / "x.npy", xs)
    script = tmp_path / "worker.py"
    script.write_text(TOPOLOGY_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", "8", "-H",
         "localhost:4,localhost:4", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         "2", str(script), str(tmp_path / "x.npy"), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    ctx = bft.init(size=8, device=cuda)
    try:
        x = bft.worker_values(list(xs))
        os.environ["BLUEFOG_PLAN_METHOD"] = "shortcut"
        try:
            bft.set_topology(topo.ExponentialTwoGraph(8), is_weighted=True)
            want = {"relay": bft.neighbor_allreduce(x, compression="int8").cpu()}
        finally:
            del os.environ["BLUEFOG_PLAN_METHOD"]
        os.environ.update(BLUEFOG_PODS="2", BLUEFOG_DCN_PERIOD="2")
        try:
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = "int8"
            p = {"w": x.clone()}
            opt.step(p, opt.init(p), {"w": x * 0.25})
            want["fed"] = p["w"].cpu()
        finally:
            del os.environ["BLUEFOG_PODS"], os.environ["BLUEFOG_DCN_PERIOD"]
    finally:
        bft.shutdown()
    for p in range(2):
        got = torch.load(tmp_path / f"topology_{p}.pt", weights_only=False)
        assert got["rows"] == list(range(4 * p, 4 * p + 4))
        for key, ref in want.items():
            assert torch.equal(_bits(got[key]), _bits(ref[4 * p:4 * p + 4])), (p, key)
            for k in ("encode", "decode_accumulate"):
                assert got[f"{key}:launches"][k] > 0, (p, key, got[f"{key}:launches"])
        assert got["relay:bytes"] > 0, p


FLEET_ENV = {"BLUEFOG_METRICS": "1", "BLUEFOG_METRICS_INTERVAL": "1",
             "BLUEFOG_DOCTOR": "1", "BLUEFOG_DOCTOR_INTERVAL": "1",
             "BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
             "BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1",
             "BLUEFOG_HEALTH": "1", "BLUEFOG_HEALTH_INTERVAL": "1",
             "BLUEFOG_SLO": "1", "BLUEFOG_SLO_INTERVAL": "1"}
FLEET_GAUGES = ("bluefog.gossip.disagreement", "bluefog.gossip.param_norm",
                "bluefog.gossip.grad_norm", "bluefog.gossip.quant_err",
                "bluefog.staleness.age_max", "bluefog.slo.canary_max_dev")

FLEET_WORKER = """
import os, sys
import torch
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import metrics, memory
from bluefog_tpu_torch.collective import compiler, kernels
from bluefog_tpu_torch.models import ResNet50, StackedModel, resnet
torch.backends.cudnn.deterministic = True
os.environ.update({env!r})
ctx = bft.init(size=8)
compiler.set_calibration(1.0, 1e12, 0.0, link_class=compiler.TRANSPORT_LINK_CLASS)
rows = list(ctx.rows)
model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8, stage_sizes=[1, 1, 1, 1]),
                              0)
sm = StackedModel(model, len(rows), "cuda")
gen = torch.Generator().manual_seed(0)
images = torch.randn(8, 2, 32, 32, 3, generator=gen)[rows].cuda()
labels = torch.randint(0, 10, (8, 2), generator=gen)[rows].cuda()
opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
opt.compression = "int8"
params = sm.replicate()
state = opt.init(params)
before = kernels.launch_counts()
for _ in range(2):
    _, grads = sm.loss_and_grad(params, images, labels)
    opt.step(params, state, grads)
metrics.flush()
after = kernels.launch_counts()
out = {{"rows": rows, "params": params.cpu(),
        "launches": {{k: after[k] - before[k] for k in after}},
        "gauges": {{n: metrics.peek(n).value for n in {gauges!r}}},
        "census": {{c: r["bytes"] for c, r in memory.active().last_census.items()
                    if c != "other"}}}}
torch.save(out, os.path.join(sys.argv[1], f"fleet_{{ctx.process_index}}.pt"))
opt.free()
bft.shutdown()
"""


@pytest.mark.cuda
def test_two_processes_run_the_fleet_samplers_as_the_stacked_run(cuda, tmp_path):
    """Two processes of four workers sharing the card (gloo, staged) run
    ATC int8 on the tiny ResNet with the metrics probe, the doctor, the
    staleness lane, the memory observatory, the health plane and the SLO
    canary at interval 1: each process's rows and the gauges (the gathered
    probe's fold, the ages, the canary's deviation) and the census's byte
    counts are the stacked run's on the card, bitwise; each process launches
    ``encode`` and ``decode_accumulate`` (the combine and the probe) and
    ``decode`` (the canary's)."""
    import os
    import socket
    import subprocess
    import sys

    from bluefog_tpu_torch import memory, metrics
    from bluefog_tpu_torch.collective import compiler
    from bluefog_tpu_torch.models import ResNet50, StackedModel, resnet

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(FLEET_WORKER.format(env=FLEET_ENV, gauges=FLEET_GAUGES))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", "8", "-H",
         "localhost:4,localhost:4", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         "2", str(script), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    old = {k: os.environ.get(k) for k in FLEET_ENV}
    os.environ.update(FLEET_ENV)
    try:
        bft.init(size=8, device=cuda)
        compiler.set_calibration(1.0, 1e12, 0.0, link_class=compiler.TRANSPORT_LINK_CLASS)
        model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                               stage_sizes=[1, 1, 1, 1]), 0)
        sm = StackedModel(model, 8, "cuda")
        gen = torch.Generator().manual_seed(0)
        images = torch.randn(8, 2, 32, 32, 3, generator=gen).to(cuda)
        labels = torch.randint(0, 10, (8, 2), generator=gen).to(cuda)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int8"
        params = sm.replicate()
        state = opt.init(params)
        for _ in range(2):
            _, grads = sm.loss_and_grad(params, images, labels)
            opt.step(params, state, grads)
        metrics.flush()
        want = params.cpu()
        gauges = {n: metrics.peek(n).value for n in FLEET_GAUGES}
        census = {c: r["bytes"] for c, r in memory.active().last_census.items() if c != "other"}
        opt.free()
    finally:
        bft.shutdown()
        compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
        torch.backends.cudnn.deterministic = deterministic
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for p in range(2):
        got = torch.load(tmp_path / f"fleet_{p}.pt", weights_only=False)
        assert got["rows"] == list(range(4 * p, 4 * p + 4))
        assert torch.equal(_bits(got["params"]), _bits(want[4 * p:4 * p + 4])), p
        assert got["gauges"] == gauges, (p, got["gauges"], gauges)
        assert got["census"] == census, (p, got["census"], census)
        for k in ("encode", "decode_accumulate", "decode"):
            assert got["launches"][k] > 0, (p, got["launches"])


@pytest.mark.cuda
def test_weak_scaling_of_the_int8_train_step_launches_and_matches_plain(cuda):
    """Phase 11k (b) at a small depth: ``scaling.weak_scaling_times`` over
    ATC int8 ``make_train_step`` of the tiny ResNet at 1, 2 and 4 workers on
    the card; each step launches one ``encode`` and one
    ``decode_accumulate``, and at n >= 2 the first step's combine is bitwise
    the plain versions' on a CPU copy of its input (the phase's gates)."""
    from chip_smoke import build_trainer, sc_weak_scaling

    bft.init(device="cuda")
    try:
        sm, images, labels = build_trainer(cuda, stage_sizes=[1, 1, 1, 1], num_filters=8,
                                           batch=2, image=32, num_classes=10)
        counts, rows = sc_weak_scaling(cuda, sm, images, labels, ns=(1, 2, 4), steps=2,
                                       warmup=1)
    finally:
        bft.shutdown()
    assert [r["n"] for r in rows] == [1, 2, 4] and rows[0]["efficiency"] == 1.0
    assert counts["encode"] == counts["decode_accumulate"] == 3 * 3


@pytest.mark.cuda
def test_frontend_int8_neighbor_allreduce_on_the_card(cuda):
    """The torch frontend's int8 ``neighbor_allreduce`` on the card: its
    forward is bitwise the facade's and launches one ``encode`` and one
    ``decode_accumulate``; its backward launches no wire kernel and is
    bitwise the exact combine over the transposed weights."""
    import bluefog_tpu_torch.torch as bftt
    from bluefog_tpu_torch.collective.plan import plan_from_matrix

    try:
        bft.init(device="cuda")
        x = ragged_input(cuda, seed=7).requires_grad_(True)
        g = ragged_input(cuda, seed=8)
        c0 = kernels.launch_counts()
        y = bftt.neighbor_allreduce(x, compression="int8")
        torch.cuda.synchronize()
        c1 = kernels.launch_counts()
        y.backward(g)
        torch.cuda.synchronize()
        c2 = kernels.launch_counts()
        ref = bft.neighbor_allreduce(x.detach(), compression="int8")
        w = bft.get_context().static_plan().weight_matrix()
        adjoint = inner.neighbor_allreduce(g, plan_from_matrix(w.T))
        torch.cuda.synchronize()
    finally:
        bft.shutdown()
    assert torch.equal(_bits(y.detach()), _bits(ref))
    assert torch.equal(_bits(x.grad), _bits(adjoint))
    assert {k: c1[k] - c0[k] for k in c0} == {
        "encode": 1, "encode_diff": 0, "decode": 0, "decode_add": 0, "decode_accumulate": 1}
    assert c2 == c1


# -- BatchNorm kernels (ops/batchnorm.py, csrc/batchnorm_kernels.cu) -----------

# every BatchNorm input shape [C, H, W] of the ResNet50 at 224x224 (53 layers)
RESNET50_BN_SHAPES = [(64, 112, 112), (64, 56, 56), (256, 56, 56), (128, 56, 56),
                      (128, 28, 28), (512, 28, 28), (256, 28, 28), (256, 14, 14),
                      (1024, 14, 14), (512, 14, 14), (512, 7, 7), (2048, 7, 7)]
# batch 256 at every ResNet50 shape; C = 8, the narrowest 16-byte bf16 row;
# C = 13, no 16-byte access in either dtype
BN_CASES = ([(256,) + s for s in RESNET50_BN_SHAPES]
            + [(64, 8, 28, 28), (16, 13, 15, 9)])


def _bn_operands(device, n, c, h, w, dtype, seed=0, offset_elems=0):
    """x and a residual ``[n, c, h, w]`` channels-last in ``dtype`` (x with a
    per-channel offset and spread), the output's gradient, f32 scale and
    bias, and running statistics as rows of a stacked ``[3, c]`` buffer.
    ``offset_elems`` starts every activation that many elements into its
    buffer (off 16 bytes: the one-element path)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def act(shift, spread):
        base = torch.randn(n * h * w * c + offset_elems, generator=gen, device=device)
        t = base[offset_elems:].view(n, h, w, c) * spread + shift
        out = torch.empty(n * h * w * c + offset_elems, dtype=dtype, device=device)
        view = out[offset_elems:].view(n, h, w, c)
        view.copy_(t)
        return view.permute(0, 3, 1, 2)

    shift = torch.randn(c, generator=gen, device=device)
    spread = torch.rand(c, generator=gen, device=device) * 2 + 0.25
    x, res, dy = act(shift, spread), act(0.0, 1.0), act(0.0, 1.0)
    scale = torch.randn(c, generator=gen, device=device)
    bias = torch.randn(c, generator=gen, device=device) * 0.5
    mean = torch.randn(3, c, generator=gen, device=device)
    var = torch.rand(3, c, generator=gen, device=device) + 0.5
    return x, res, dy, scale, bias, mean, var


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", BN_CASES, ids=lambda s: "x".join(map(str, s)))
def test_batchnorm_kernels_match_plain_versions(cuda, shape, dtype):
    """The forward and backward kernels at every ResNet50 BatchNorm shape
    (batch 256), C = 8 and C = 13, with the residual and the ReLU fused:

    - statistics within the summation-order bounds of
      ``batch_norm_stats_bounds``;
    - ``apply`` bit for bit the plain normalization on the kernel's own
      statistics (one rounding an operation on both; so the output is
      within one rounding of the activation dtype, one ulp either way, of
      the composite's);
    - the running mean in the stacked buffer's row bit for bit ``0.9 *
      running + 0.1 * mean``, the variance within the sums' bound, the
      other rows untouched;
    - the backward's sums (dbias, dscale) within 2e-5 of the sum of their
      terms' magnitudes (another summation order), and dx and the
      residual's gradient bit for bit the plain formula given those sums;
    - two calls the same bits (no atomics)."""
    x, res, dy, scale, bias, mean, var = _bn_operands(cuda, *shape, dtype)
    mean0, var0 = mean.clone(), var.clone()
    y, stats = bn_ops.batch_norm_fwd(x, scale, bias, res, mean[1], var[1], True, 0.9, 1e-5,
                                     True)
    ref = bn_ops.batch_norm_stats_reference(x)
    d_mean, d_var, d_rstd = bn_ops.batch_norm_stats_bounds(x, ref)
    assert ((stats[0].double() - ref[0].double()).abs() <= d_mean).all()
    assert ((stats[1].double() - ref[1].double()).abs() <= d_rstd).all()
    assert torch.equal(stats[2], ref[2])
    want = bn_ops.batch_norm_apply_reference(x, stats, scale, bias, res, True)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(mean[1]), _bits(0.9 * mean0[1] + (1 - 0.9) * stats[0]))
    plain_var = torch.clamp((x.float() ** 2).mean(dim=(0, 2, 3)) - ref[0] ** 2, min=0)
    assert ((var[1].double() - (0.9 * var0[1] + 0.1 * plain_var).double()).abs()
            <= 0.1 * d_var + 1e-6).all()
    for rows in (mean, var):
        assert torch.equal(rows[0], (mean0 if rows is mean else var0)[0])
        assert torch.equal(rows[2], (mean0 if rows is mean else var0)[2])
    y2, stats2 = bn_ops.batch_norm_fwd(x, scale, bias, res, mean0[1].clone(), var0[1].clone(),
                                       True, 0.9, 1e-5, True)
    assert torch.equal(_bits(stats2), _bits(stats)) and torch.equal(_bits(y2), _bits(y))

    dx, dscale, dbias, g = bn_ops.batch_norm_bwd(dy, x, y, stats, scale, True, True)
    pdx, pdscale, pdbias, pg = bn_ops.batch_norm_backward_reference(dy, x, y, stats, scale)
    gf = torch.where(y > 0, dy.double(), 0.0)
    xhat = (x.double() - stats[0].double()[:, None, None]) * stats[1].double()[:, None, None]
    for got, plain, terms in ((dbias, pdbias, gf), (dscale, pdscale, gf * xhat)):
        bound = bn_ops.batch_norm_sum_bound(terms)
        assert ((got.double() - plain.double()).abs() <= bound).all()
    sdx, _, _, sg = bn_ops.batch_norm_backward_reference(dy, x, y, stats, scale,
                                                         sums=(dbias, dscale))
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(dx), _bits(sdx)) and torch.equal(_bits(g), _bits(sg))
    assert torch.equal(_bits(g), _bits(pg))
    again = bn_ops.batch_norm_bwd(dy, x, y, stats, scale, True, True)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(again, (dx, dscale, dbias, g)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["no_res", "res"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
def test_batchnorm_kernels_fusions_and_eval_match_plain_versions(cuda, dtype, relu,
                                                                 with_residual, offset):
    """Every fusion (residual, ReLU, both, neither), on 16-byte aligned
    activations and one element off them (the one-element path), in
    training and eval mode: outputs and dx bit for bit the plain versions
    on the kernels' own statistics and sums (eval: the running
    statistics, no batch terms in dx)."""
    x, res, dy, scale, bias, mean, var = _bn_operands(cuda, 8, 64, 14, 14, dtype, seed=1,
                                                      offset_elems=offset)
    res = res if with_residual else None
    for training in (True, False):
        y, stats = bn_ops.batch_norm_fwd(x, scale, bias, res, mean[0], var[0], training, 0.9,
                                         1e-5, relu)
        want = bn_ops.batch_norm_apply_reference(x, stats, scale, bias, res, relu)
        assert torch.equal(_bits(y), _bits(want)), training
        dx, dscale, dbias, g = bn_ops.batch_norm_bwd(dy, x, y if relu else None, stats, scale,
                                                     training, with_residual)
        sdx, _, _, sg = bn_ops.batch_norm_backward_reference(
            dy, x, y if relu else None, stats, scale, batch_stats=training,
            sums=(dbias, dscale))
        assert torch.equal(_bits(dx), _bits(sdx)), training
        assert (g is None) == (not with_residual)
        if with_residual:
            assert torch.equal(_bits(g), _bits(sg))


@pytest.mark.cuda
def test_batchnorm_module_on_card_saves_no_f32_activation_and_matches_cpu(cuda):
    """``resnet.BatchNorm`` on a bf16 channels-last activation through
    autograd: what it saves is x, its output and per-channel vectors
    (nothing f32 the size of an activation), the running statistics land
    in the stacked buffer's row, and output and gradients stay within the
    composite's on the CPU (one bf16 rounding either way; the sums in
    another order)."""
    from bluefog_tpu_torch.models import resnet

    x, res, dy, scale, bias, mean, var = _bn_operands(cuda, 16, 256, 14, 14, torch.bfloat16,
                                                      seed=2)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        m = resnet.BatchNorm(256, torch.bfloat16).to(dev)
        with torch.no_grad():
            m.scale.copy_(scale)
            m.bias.copy_(bias)
        rows_mean, rows_var = mean.clone().to(dev), var.clone().to(dev)
        m.mean, m.var = rows_mean[1], rows_var[1]
        leaves = [x.to(dev).detach().requires_grad_(True),
                  res.to(dev).detach().requires_grad_(True)]
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            y = m(leaves[0], residual=leaves[1], relu=True)
        grads = torch.autograd.grad(y, leaves + [m.scale, m.bias], dy.to(dev))
        outs[dev.type] = [t.detach().cpu() for t in [y, *grads, rows_mean, rows_var]]
        if dev.type == "cuda":
            assert all(t.dtype != torch.float32 or t.numel() <= 3 * 256 for t in saved), \
                [(t.dtype, tuple(t.shape)) for t in saved]
            assert sum(t.numel() == x.numel() for t in saved) == 2
    got, want = outs["cuda"], outs["cpu"]
    for name, a, b in zip(("y", "dx", "dres", "dscale", "dbias", "mean", "var"), got, want):
        scale_ = float(b.abs().max())
        tol = 2 ** -7 * scale_ if a.dtype == torch.bfloat16 else 1e-4 * scale_
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol, msg=name)


@pytest.mark.cuda
def test_batchnorm_wrapper_refuses_bad_cuda_operands(cuda):
    """An NCHW-contiguous activation, an f16 one or a residual of another
    dtype raise; nothing falls back."""
    x, res, dy, scale, bias, mean, var = _bn_operands(cuda, 2, 16, 4, 4, torch.bfloat16)
    args = (scale, bias, mean[0], var[0], True)
    with pytest.raises(ValueError, match="channels-last"):
        bn_ops.batch_norm(x.contiguous(), *args)
    with pytest.raises(ValueError, match="channels-last"):
        bn_ops.batch_norm(x, *args, residual=res.contiguous())
    with pytest.raises(ValueError, match="bf16 or f32"):
        bn_ops.batch_norm(x.half(), *args)
    with pytest.raises(ValueError, match="residual"):
        bn_ops.batch_norm(x, *args, residual=res.float())
    with pytest.raises(ValueError, match="running_mean"):
        bn_ops.batch_norm(x, scale, bias, mean[0].double(), var[0], True)


@pytest.mark.cuda
def test_resnet50_worker_step_launches_each_batchnorm_kernel_53_times(cuda):
    """One ResNet50 worker's forward and backward (bf16, 2 images of 64x64)
    launches each forward kernel and each backward kernel once for each of
    its 53 BatchNorms; eval mode launches ``apply`` alone."""
    from bluefog_tpu_torch.models import ResNet50, resnet

    model = resnet.init_flax_like(ResNet50(num_classes=10), 0).to(cuda)
    images = torch.randn(2, 64, 64, 3, device=cuda)
    bn_ops.reset_launch_counts()
    loss = model(images).float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert bn_ops.launch_counts() == dict.fromkeys(bn_ops.KERNELS, 53)
    bn_ops.reset_launch_counts()
    model.eval()
    with torch.no_grad():
        model(images)
    assert bn_ops.launch_counts() == {**dict.fromkeys(bn_ops.KERNELS, 0), "apply": 53}
