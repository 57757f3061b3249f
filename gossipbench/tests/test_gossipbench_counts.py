"""The benchmark's own counts against hand counts: parameters, model
FLOPs, the wire's bytes, attention, and the trace arithmetic."""

import math

import pytest
import torch

from gossipbench import harness
from gossipbench.families import gpt2, resnet
from gossipbench.lib import counts, trace, weights
from gossipbench.reference import wire


def _cfg(name):
    bench = harness.benchmark()
    return harness.config(bench, name)


def test_resnet50_parameters_and_macs():
    cfg = _cfg("resnet50")
    assert weights.count(resnet.reference.param_table(cfg)) == 25_557_032 == cfg["n_params"]
    # He et al. Table 1 at 224x224, stride on the 3x3 (v1.5), stage by stage
    stem = 112 * 112 * 64 * 3 * 49
    stages, size, inp, total = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)], 56, 64, 0
    for blocks, f, stride in stages:
        for b in range(blocks):
            s = stride if b == 0 else 1
            out = size // s
            total += size * size * f * inp + out * out * f * f * 9 + out * out * 4 * f * f
            if b == 0:
                total += out * out * 4 * f * inp
            size, inp = out, 4 * f
    hand = stem + total + 2048 * 1000
    assert resnet.macs(cfg) == hand
    assert round(hand / 1e9, 2) == 4.09
    assert resnet.step_flops(cfg, {"workers": 8, "batch": 256}) == 6 * hand * 2048


def test_gpt2_medium_parameters_and_flops():
    cfg = _cfg("gpt2-medium")
    assert weights.count(gpt2.reference.param_table(cfg)) == 406_238_289 == cfg["n_params"]
    d, layers, v = 1024, 24, 50257
    assert gpt2.matmul_params(cfg) == layers * 12 * d * d + d * v == 353_453_056
    t, tokens = 1024, 8 * 16 * 1024
    hand = 6 * 353_453_056 * tokens + 3 * 4 * d * (t * (t + 1) // 2) * layers * 8 * 16
    assert gpt2.step_flops(cfg, {"workers": 8, "batch": 16, "seq": t}) == hand
    assert gpt2.attention_calls(cfg, {"workers": 8, "batch": 16, "seq": t}) == [
        (8 * 24, 16, 1024, 16, 64)]


def test_int8_combine_bytes_exp2_8():
    n, w, rounds = 8, 25_557_504, 3
    assert [o for o in wire.exponential_sources(n)] == [
        [(j - k) % 8 for j in range(8)] for k in (1, 2, 4)]
    rows, payload, scales = 4 * n * w, n * w, 4 * n * w // 512
    encode = rows + payload + scales
    accumulate = rows + payload + scales + rounds * n * (4 + 4) + rows
    assert counts.combine_bytes("int8", n, w, rounds) == encode + accumulate
    assert counts.combine_bytes("int8", n, w, rounds) == 2_865_635_328  # 2.87 GB: 0.855 ms at 3.35 TB/s
    assert counts.wire_bytes("int4", 1024) == 512 + 2 * 2
    with pytest.raises(ValueError):
        counts.wire_bytes("int8_ef", 512)


def test_attention_counts():
    b, t, h, d = 2, 8, 3, 4
    pairs = sum(range(1, t + 1))
    assert counts.attention_flops(b, t, h, d) == 6 * 2 * d * pairs * b * h
    tile = b * t * h * d * 2
    assert counts.attention_bytes(b, t, h, d) == 12 * tile + 2 * 4 * b * h * t
    assert (counts.BF16_FLOPS, counts.HBM_BYTES) == (989e12, 3.35e12)  # H100 SXM


@pytest.mark.parametrize("name, bare", [
    ("void (anonymous namespace)::encode_kernel<false>(float const*, signed char*, void*, long long)",
     "encode_kernel"),
    ("void flash_fwd_sm90<64>(CUtensorMap, CUtensorMap)", "flash_fwd_sm90"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)",
     "vectorized_elementwise_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
])
def test_kernel_symbol(name, bare):
    assert trace.symbol(name) == (name if bare is None else bare)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}


def test_summarize_unions_device_time_and_names_gaps():
    events = [
        _ev("user_annotation", "gossipbench.step", 0, 100),
        _ev("user_annotation", "gossipbench.train_step", 0, 60),
        _ev("user_annotation", "gossipbench.sync", 60, 40),
        _ev("cpu_op", "aten::conv2d", 38, 10),
        _ev("kernel", "void encode_kernel<false>(float const*)", 10, 20),
        _ev("kernel", "gemm", 20, 15),  # overlaps the first: counted once
        _ev("gpu_memcpy", "Memcpy HtoD", 50, 10),
        _ev("kernel", "gemm", 90, 30),  # past the window's end: cut at 100
    ]
    s = trace.summarize(events)
    assert s.steps == 1 and math.isclose(s.window_s, 100e-6)
    assert math.isclose(s.busy_s, (25 + 10 + 10) * 1e-6)
    assert math.isclose(s.kernel_s["encode_kernel"], 20e-6)
    assert math.isclose(s.kernel_s["gemm"], 25e-6)
    assert s.idle_gaps[0] == ("sync", pytest.approx(30e-6))
    assert ("train_step/aten::conv2d", pytest.approx(15e-6)) in s.idle_gaps
    assert s.idle_gaps[-1] == ("train_step", pytest.approx(10e-6))


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": float(ts),
            "dur": 5.0, "args": {"correlation": corr}}


def _on_device(name, ts, dur, corr):
    return {**_ev("kernel", name, ts, dur), "args": {"correlation": corr}}


def test_summarize_takes_device_work_by_its_launch():
    """The device's clock may stand off the host's: work launched in the
    steps counts whole, even where its device time reads past the last
    span's end; work launched before the first span counts not at all."""
    events = [
        _ev("user_annotation", "gossipbench.step", 100, 100),
        _launch(1, 90), _on_device("gemm", 105, 10, 1),  # launched before the steps
        _launch(2, 120), _on_device("gemm", 130, 20, 2),
        _launch(3, 150), _on_device("void encode_kernel<false>(float const*)", 190, 30, 3),
        _on_device("decode_kernel", 195, 10, 4),  # no launch in the trace: cut at 200
    ]
    s = trace.summarize(events)
    assert math.isclose(s.kernel_s["gemm"], 20e-6)
    assert math.isclose(s.kernel_s["encode_kernel"], 30e-6)
    assert math.isclose(s.kernel_s["decode_kernel"], 5e-6)
    assert math.isclose(s.busy_s, (20 + 30) * 1e-6)


def test_kernel_groups_are_disjoint():
    groups = trace.kernel_groups(harness.HERE)
    assert {"wire", "flash"} <= set(groups)
    seen = set()
    for symbols in groups.values():
        assert not symbols & seen
        seen |= symbols


def test_weights_are_drawn_from_the_seed():
    table = [weights.Param("a", (64, 64), std=0.5), weights.Param("b", (3,), mean=1.0),
             weights.Param("c", (4096,), std=2.0, mean=-1.0)]
    one, two = weights.draw(table, 2**31 + 11, "cpu"), weights.draw(table, 2**31 + 11, "cpu")
    assert torch.equal(one, two)
    assert not torch.equal(one, weights.draw(table, 2**31 + 12, "cpu"))
    v = weights.views(table, one)
    assert torch.equal(v["b"], torch.ones(3))
    assert abs(float(v["a"].std()) - 0.5) < 0.03 and abs(float(v["c"].mean()) + 1.0) < 0.1
    assert weights.sub_seed(1, "x") != weights.sub_seed(1, "y") < 2**63


@pytest.mark.parametrize("compression, topology, launches, priced", [
    ("int8", "ExponentialGraph", {"encode": 1.0, "decode_accumulate": 1.0}, True),
    ("int4", "ExponentialGraph", {"encode": 1.0, "decode_accumulate": 1.0}, True),
    ("int4_ef", "ExponentialGraph", {"encode_diff": 1.0, "decode_add": 3.0}, False),
    ("int8", "ExponentialGraph", {"encode": 1.0, "decode": 1.0}, False),  # push-sum
    ("int8", "RingGraph", {"encode": 1.0, "decode_accumulate": 1.0}, False),
])
def test_wire_roofline_prices_only_a_plain_combine(compression, topology, launches, priced):
    from types import SimpleNamespace

    n, w = 8, 25_557_504
    rounds = len(wire.exponential_sources(n)) if topology == "ExponentialGraph" else None
    least = 1e-3  # seconds of wire kernels a step
    summary = trace.Summary(steps=2, window_s=1.0, busy_s=0.5,
                            kernel_s={"encode_kernel": least, "decode_accumulate_kernel": least},
                            device_ops=[], idle_gaps=[])
    ctx = SimpleNamespace(trace=summary, mix={"compression": compression, "workers": n},
                          width=w, rounds=rounds, wire_launches=launches)
    value = harness.reader("wire_roofline").read(ctx)
    if not priced:
        assert value is None
        return
    bytes_ = counts.combine_bytes(compression, n, w, rounds)
    assert value == pytest.approx(100.0 * bytes_ / counts.HBM_BYTES * 2 / (2 * least))
