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
