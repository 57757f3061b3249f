# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The flash kernels' route rule (``ops/flash.py::_route``) and the build's
source hashing, on the CPU.

The rule is a plain function of dtypes, head_dim, pointers, strides and the
scale, so it is tested here on CPU tensors laid out as the card would get
them: q, k and v split from one fused projection as the transformer splits
them take ``sm90`` (wgmma fed by TMA), with a bf16 cotangent or an f32 one
(the lse form's, split into two bf16 halves); rows off 16 bytes, head_dim
36 or a non-positive scale take ``mma`` with a bf16 cotangent and
``simt`` with an f32 one; f32 operands take ``simt``. dK/dV and dQ of one
backward always take the same route.
"""

import pytest
import torch

from bluefog_tpu_torch import _build
from bluefog_tpu_torch.ops import flash


def _fused(b, t, h, h_kv, d, dtype=torch.bfloat16, offset=0):
    """q, k, v as strided views of one ``[b, t, (h + 2 h_kv) d]`` buffer,
    ``offset`` elements into it (``models/transformer.py``'s split)."""
    width = (h + 2 * h_kv) * d
    flat = torch.zeros(offset + b * t * width, dtype=dtype)
    qkv = flat[offset:].view(b, t, width)
    return tuple(x.reshape(b, t, -1, d) for x in qkv.split([h * d, h_kv * d, h_kv * d], -1))


@pytest.mark.parametrize("h,h_kv,d", [(16, 16, 64), (16, 4, 64), (4, 4, 96), (2, 1, 128),
                                      (4, 2, 72), (2, 2, 8)])
def test_fused_projection_views_take_sm90(h, h_kv, d):
    q, k, v = _fused(2, 40, h, h_kv, d)
    assert not q.is_contiguous()
    assert flash._route(q, k, v, scale=d ** -0.5) == "sm90"
    assert flash._route(q, k, v, torch.zeros_like(q), d ** -0.5) == "sm90"


def test_the_transformer_shape_takes_sm90():
    """b 2, T 4096, 16 heads of 64: 6144-byte rows, 128-byte heads."""
    q, k, v = _fused(2, 4096, 16, 16, 64)
    assert q.stride() == (4096 * 3072, 3072, 64, 1)
    assert flash._route(q, k, v, scale=0.125) == "sm90"


@pytest.mark.parametrize("why,case", [
    ("head_dim 36", dict(d=36)),
    ("head_dim 100", dict(d=100)),
    ("head_dim 160", dict(d=160)),
    ("head_dim 256", dict(d=256)),
    ("offset of one element", dict(d=64, offset=1)),
    ("offset of four elements", dict(d=64, offset=4)),
])
def test_rows_tma_cannot_address_take_mma(why, case):
    q, k, v = _fused(1, 30, 4, 2, **case)
    assert flash._route(q, k, v, scale=0.1) == "mma", why
    assert flash._route(q, k, v, torch.zeros_like(q), 0.1) == "mma", why


def test_an_unaligned_cotangent_takes_mma():
    q, k, v = _fused(1, 30, 4, 2, 64)
    do = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)[1:].view(q.shape)
    assert flash._route(q, k, v, scale=0.1) == "sm90"
    assert flash._route(q, k, v, do, 0.1) == "mma"


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_a_scale_that_is_not_positive_takes_mma(scale):
    q, k, v = _fused(1, 30, 4, 2, 64)
    assert flash._route(q, k, v, scale=scale) == "mma"


def test_f32_operands_or_cotangent_take_simt():
    """f32 q/k/v take ``simt`` whatever the cotangent; beside bf16 q/k/v
    that ``sm90`` takes, an f32 cotangent takes ``sm90`` as two bf16
    halves, and ``simt`` only where ``sm90`` does not take the operands."""
    q, k, v = _fused(1, 30, 4, 2, 64, dtype=torch.float32)
    assert flash._route(q, k, v, scale=0.1) == "simt"
    assert flash._route(q, k, v, torch.zeros(q.shape), 0.1) == "simt"
    q, k, v = _fused(1, 30, 4, 2, 64)
    assert flash._route(q, k, v, torch.zeros(q.shape), 0.1) == "sm90"
    q, k, v = _fused(1, 30, 4, 2, 64, offset=1)
    assert flash._route(q, k, v, torch.zeros(q.shape), 0.1) == "simt"


@pytest.mark.parametrize("why,shape,offset,do_layout", [
    ("fused views, 16 heads of 64", (2, 40, 16, 16, 64), 0, "contiguous"),
    ("the ring block's T and heads", (2, 1024, 16, 16, 64), 0, "contiguous"),
    ("grouped-query 16/4, head_dim 128", (1, 40, 16, 4, 128), 0, "contiguous"),
    ("head_dim 72", (1, 40, 4, 2, 72), 0, "contiguous"),
    ("a cotangent one element off 16 bytes", (1, 30, 4, 2, 64), 0, "offset"),
    ("an expanded cotangent", (1, 30, 4, 2, 64), 0, "expanded"),
])
def test_an_f32_cotangent_beside_aligned_bf16_operands_takes_sm90(why, shape, offset, do_layout):
    """The halves are fresh and contiguous, so the f32 cotangent's own
    alignment and strides do not matter."""
    q, k, v = _fused(*shape, offset=offset)
    if do_layout == "offset":
        do = torch.zeros(1 + q.numel())[1:].view(q.shape)
    elif do_layout == "expanded":
        do = torch.zeros(q.shape[1:]).expand(q.shape)
    else:
        do = torch.zeros(q.shape)
    assert flash._route(q, k, v, do, shape[-1] ** -0.5) == "sm90", why


@pytest.mark.parametrize("why,case,scale", [
    ("rows one element off 16 bytes", dict(d=64, offset=1), 0.125),
    ("head_dim 36", dict(d=36), 0.125),
    ("head_dim 160", dict(d=160), 0.125),
    ("head_dim 256", dict(d=256), 0.125),
    ("scale 0", dict(d=64), 0.0),
])
def test_an_f32_cotangent_beside_bf16_operands_sm90_refuses_takes_simt(why, case, scale):
    q, k, v = _fused(1, 30, 4, 2, **case)
    assert flash._route(q, k, v, torch.zeros(q.shape), scale) == "simt", why


def _backward_routes(monkeypatch, q, k, v, do, scale):
    """The routes :func:`flash.flash_bwd_dkv` and :func:`flash.flash_bwd_dq`
    hand their kernels for these operands, as on the card (the device check
    answers "cuda"; the kernels record their route instead of launching)."""
    taken = {}
    monkeypatch.setattr(flash, "_dispatch_device", lambda *tensors: "cuda")
    monkeypatch.setattr(flash, "_dkv_kernel", lambda *args: taken.setdefault("dkv", args[-1]))
    monkeypatch.setattr(flash, "_dq_kernel", lambda *args: taken.setdefault("dq", args[-1]))
    b, t, h, _d = q.shape
    vec = torch.zeros(b, h, t)
    flash.flash_bwd_dkv(q, k, v, do, vec, vec, None, True, scale)
    flash.flash_bwd_dq(q, k, v, do, vec, vec, None, True, scale)
    return taken["dkv"], taken["dq"]


@pytest.mark.parametrize("why,shape,expect", [
    ("fused views, 16 heads of 64", (2, 40, 16, 16, 64), "sm90"),
    ("fused views, grouped-query 16/4", (2, 40, 16, 4, 64), "sm90"),
    ("fused views, head_dim 96", (1, 40, 4, 4, 96), "sm90"),
    ("fused views, head_dim 128", (1, 40, 2, 1, 128), "sm90"),
    ("the transformer's shape", (2, 4096, 16, 16, 64), "sm90"),
    ("head_dim 36", (1, 30, 4, 2, 36), "mma"),
])
def test_dq_takes_the_route_of_dkv(monkeypatch, why, shape, expect):
    q, k, v = _fused(*shape)
    do = torch.zeros(q.shape, dtype=q.dtype)
    assert _backward_routes(monkeypatch, q, k, v, do, shape[-1] ** -0.5) == (expect, expect), why


def test_dq_of_an_operand_one_element_off_takes_mma(monkeypatch):
    q, k, v = _fused(1, 30, 4, 2, 64, offset=1)
    do = torch.zeros(q.shape, dtype=q.dtype)
    assert _backward_routes(monkeypatch, q, k, v, do, 0.125) == ("mma", "mma")


def test_dq_of_an_unaligned_cotangent_takes_mma(monkeypatch):
    q, k, v = _fused(1, 30, 4, 2, 64)
    do = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)[1:].view(q.shape)
    assert _backward_routes(monkeypatch, q, k, v, do, 0.125) == ("mma", "mma")


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_dq_with_a_scale_that_is_not_positive_takes_mma(monkeypatch, scale):
    q, k, v = _fused(1, 30, 4, 2, 64)
    do = torch.zeros(q.shape, dtype=q.dtype)
    assert _backward_routes(monkeypatch, q, k, v, do, scale) == ("mma", "mma")


def test_dq_of_an_f32_cotangent_or_f32_operands_takes_simt(monkeypatch):
    """dQ takes dK/dV's route with an f32 cotangent too: ``sm90`` beside
    aligned bf16 q/k/v, ``simt`` beside f32 q/k/v, bf16 rows off 16 bytes
    or head_dim above 128."""
    q, k, v = _fused(1, 30, 4, 2, 64)
    assert _backward_routes(monkeypatch, q, k, v, torch.zeros(q.shape), 0.125) == ("sm90",
                                                                                  "sm90")
    q, k, v = _fused(1, 30, 4, 2, 64, dtype=torch.float32)
    assert _backward_routes(monkeypatch, q, k, v, torch.zeros(q.shape), 0.125) == ("simt",
                                                                                  "simt")
    q, k, v = _fused(1, 30, 4, 2, 64, offset=1)
    assert _backward_routes(monkeypatch, q, k, v, torch.zeros(q.shape), 0.125) == ("simt",
                                                                                  "simt")
    q, k, v = _fused(1, 30, 2, 2, 160)
    assert _backward_routes(monkeypatch, q, k, v, torch.zeros(q.shape), 0.125) == ("simt",
                                                                                  "simt")


def test_zero_strides_take_mma():
    """An expanded operand (stride 0) has no tensor map."""
    q, k, v = _fused(1, 30, 4, 4, 64)
    k0 = k[:, :, :1].expand(k.shape)
    assert k0.stride(2) == 0
    assert flash._route(q, k0, v, scale=0.1) == "mma"


def test_route_counts_stay_zero_on_the_cpu():
    """CPU tensors take the plain versions: no launch on any route, and
    :func:`launch_counts` keeps exactly its three keys."""
    flash.reset_launch_counts()
    q = torch.randn(1, 24, 2, 8, requires_grad=True)
    flash.flash_attention(q, q, q, causal=True).sum().backward()
    out, lse = flash.flash_attention_with_lse(q, q, q, causal=True)
    (out.sum() + lse.sum()).backward()
    assert flash.route_counts() == {k: dict.fromkeys(flash.ROUTES, 0)
                                    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    assert flash.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def _fake_csrc(tmp_path, monkeypatch, header_text):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "flash_sm90.cu").write_text('#include <cuda.h>\n#include "flash_args.cuh"\nint x;\n')
    (csrc / "flash_args.cuh").write_text('#include "inner.cuh"\nstruct A { int a; };\n')
    (csrc / "inner.cuh").write_text(header_text)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    return csrc / "flash_sm90.cu"


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited header under ``csrc/`` (directly or through another
    header) names another library, so it rebuilds; system headers are not
    read."""
    source = _fake_csrc(tmp_path, monkeypatch, "// one\n")
    assert [p.name for p in _build.local_headers(source)] == ["flash_args.cuh", "inner.cuh"]
    first = _build._library_path(source)
    assert _build._library_path(source) == first
    (source.parent / "inner.cuh").write_text("// two\n")
    second = _build._library_path(source)
    assert second != first and second.parent == first.parent
    (source.parent / "flash_args.cuh").write_text('#include "inner.cuh"\nstruct A { int b; };\n')
    assert _build._library_path(source) not in (first, second)


def test_every_source_has_its_flags_and_the_sm90_source_exists():
    for name in ("wire_kernels", "flash_kernels", "flash_sm90", "batchnorm_kernels"):
        assert (_build._CSRC / f"{name}.cu").is_file()
        assert _build.flags(name)[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    headers = [p.name for p in _build.local_headers(_build._CSRC / "flash_sm90.cu")]
    assert headers == ["flash_args.cuh"]


def test_sm90_source_is_wgmma_fed_by_tma_and_calls_no_library():
    """The redesigned kernels issue wgmma from shared memory and registers,
    bring tiles by TMA onto mbarriers under warp specialisation, and no CUDA
    source includes cuBLAS, cuDNN or CUTLASS."""
    text = (_build._CSRC / "flash_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "setmaxnreg.dec", "setmaxnreg.inc", "__grid_constant__",
                   "cudaGetDriverEntryPoint", "CU_TENSOR_MAP_SWIZZLE_128B",
                   "int bf_flash_fwd_sm90(", "int bf_flash_bwd_dkv_sm90(",
                   "int bf_flash_bwd_dq_sm90("):
        assert needle in text, needle
    for source in sorted(_build._CSRC.glob("*.cu*")):
        for line in source.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not any(lib in line.lower() for lib in ("cublas", "cudnn", "cutlass")), line


def test_chip_smoke_routes_and_planted_faults_match_the_sources():
    """Every flash-parity case names its expected routes, and every planted
    fault's text occurs exactly once in the source it mutates."""
    import chip_smoke

    assert {c[0] for c in chip_smoke.FLASH_CASES} == set(chip_smoke.FLASH_ROUTES)
    for fwd, dkv, dq in chip_smoke.FLASH_ROUTES.values():
        assert {fwd, dkv, dq} <= set(flash.ROUTES) and dq == dkv
    text = (_build._CSRC / "flash_sm90.cu").read_text()
    names = {c[0] for c in chip_smoke.FLASH_CASES}
    for name, old, new, cases in chip_smoke.PLANTED_FAULTS:
        assert text.count(old) == 1 and old != new, name
        assert set(cases) <= names, name


def test_poisoned_tail_keeps_the_values_and_poisons_past_the_end():
    import chip_smoke

    x = torch.arange(6.0).view(2, 3)
    y = chip_smoke.with_poisoned_tail(x, float("nan"), n=4)
    assert torch.equal(y, x) and y.is_contiguous()
    past = torch.as_strided(y, (4,), (1,), y.storage_offset() + x.numel())
    assert torch.isnan(past).all()
