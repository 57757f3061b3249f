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
