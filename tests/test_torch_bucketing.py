# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's bucketed and chunked wire: ``bucket_bounds``,
``chunk_bounds`` and the chunk chooser equal to the JAX package's on a
grid; the chunked exact, bf16, int8/int4 and error-feedback combines
bitwise the monolithic ones; the optimizers' bucketed gossip
(``BLUEFOG_BUCKET_BYTES``) bitwise the monolithic gossip on every wire;
and the error-feedback tiers, bucketed and not, bitwise against a numpy
CHOCO recursion on ``bluefog_tpu/collective/wire_ref.py``'s wire format
(JAX's own bucketed-EF test does not run on this jax).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from bluefog_tpu.collective import compiler as jcompiler
from bluefog_tpu.collective import inner as jinner
from bluefog_tpu.collective import wire_ref
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective import compiler, inner, kernels
from bluefog_tpu_torch.collective.plan import plan_from_topology

SIZE = 8
WIRES = [None, "bf16", "int8", "int4", "int8_ef", "int4_ef"]


@pytest.fixture(autouse=True)
def context(monkeypatch):
    for env in ("BLUEFOG_OVERLAP", "BLUEFOG_BUCKET_BYTES", "BLUEFOG_PLAN_CHUNKS",
                "BLUEFOG_PLAN_CALIBRATE"):
        monkeypatch.delenv(env, raising=False)
    compiler.clear_calibration()
    jcompiler.clear_calibration()
    bft.init(device="cpu")
    yield
    bft.shutdown()
    # the reduce-scatter structures are priced at their first call's payload
    compiler.clear_compile_cache()
    compiler.clear_calibration()


# -- the grid helpers and the chooser, equal to JAX's --------------------------------------

SIZES = [0, 1, 511, 512, 513, 4095, 4096, 100_000, 1 << 20, 25_557_504]


@pytest.mark.parametrize("n", SIZES)
def test_bucket_and_chunk_bounds_equal_jax(n):
    for itemsize in (2, 4):
        for cap in (0, 1, 700, 2048, 4 << 20, 16 << 20):
            assert inner.bucket_bounds(n, itemsize, cap) == jinner.bucket_bounds(n, itemsize, cap)
    for chunks in (0, 1, 2, 3, 4, 7, 64):
        assert inner.chunk_bounds(n, chunks) == jinner.chunk_bounds(n, chunks)
        b = inner.chunk_bounds(n, chunks)
        assert inner._chunk_group_bounds(b) == jinner._chunk_group_bounds(b)
    for r, c in ((1, 1), (3, 4), (7, 2), (2, 8)):
        assert list(inner._wavefront(r, c)) == list(jinner._wavefront(r, c))


def test_bucket_cap_env_equals_jax(monkeypatch):
    assert inner.bucket_bytes_cap() == jinner.bucket_bytes_cap() == 4 << 20
    monkeypatch.setenv("BLUEFOG_BUCKET_BYTES", "65536")
    assert inner.bucket_bytes_cap() == jinner.bucket_bytes_cap() == 65536
    monkeypatch.setenv("BLUEFOG_OVERLAP", "0")
    assert inner.bucket_bytes_cap() == jinner.bucket_bytes_cap() == 0


@pytest.mark.parametrize("payload", [512.0, 4096.0, 1e5, 1.06e6, 4.2e6, 1e8])
@pytest.mark.parametrize("rounds", [1, 2, 3, 7])
def test_choose_chunks_equals_jax(payload, rounds, monkeypatch):
    elems = int(payload) // 4
    assert compiler.choose_chunks(rounds, payload, n_elems=elems) == \
        jcompiler.choose_chunks(rounds, payload, n_elems=elems)
    assert compiler.pipelined_cost_s(payload, 4, (1.0,) * rounds) == pytest.approx(
        jcompiler.pipelined_cost_s(payload, 4, (1.0,) * rounds), rel=1e-12)
    compiler.set_calibration(5e-6, 2e10, 0.5)
    jcompiler.set_calibration(5e-6, 2e10, 0.5)
    assert compiler.chunk_option(payload, (1.0,) * rounds, elems) == pytest.approx(
        jcompiler.chunk_option(payload, (1.0,) * rounds, elems), rel=1e-12)
    assert compiler.calibration()["source"] == "manual"
    compiler.clear_calibration()
    jcompiler.clear_calibration()
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "5")
    assert compiler.choose_chunks(rounds, payload, n_elems=elems) == \
        jcompiler.choose_chunks(rounds, payload, n_elems=elems)


@pytest.mark.parametrize("payload", [512.0, 1.06e6, 1e8])
@pytest.mark.parametrize("rounds", [1, 3, 7])
def test_transport_prices_one_chunk_and_one_bucket(payload, rounds, monkeypatch):
    """The port's stacked transport has no wire to overlap: its link class
    gives one chunk where the ICI class may give more, and its bucket cap
    is one bucket; ``BLUEFOG_PLAN_CHUNKS`` and ``BLUEFOG_BUCKET_BYTES``
    still ask for more."""
    elems = int(payload) // 4
    stacked = compiler.TRANSPORT_LINK_CLASS
    assert stacked in compiler.LINK_CLASSES
    assert compiler.choose_chunks(rounds, payload, n_elems=elems, link_class=stacked) == 1
    assert compiler.reduce_scatter_chunks(SIZE, payload, n_elems=elems,
                                          link_class=stacked) == 1
    assert compiler.chunk_option(payload, (1.0,) * rounds, elems, link_class=stacked)[1] == \
        pytest.approx(rounds * compiler.ROUND_ALPHA_S)
    assert inner.transport_bucket_cap() == 0
    monkeypatch.setenv("BLUEFOG_BUCKET_BYTES", "65536")
    assert inner.transport_bucket_cap() == 65536
    monkeypatch.setenv("BLUEFOG_OVERLAP", "0")
    assert inner.transport_bucket_cap() == 0
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "4")
    assert compiler.choose_chunks(rounds, payload, n_elems=elems, link_class=stacked) == \
        min(4, max(1, elems // 512))


def test_chooser_refusals(monkeypatch):
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "zero")
    with pytest.raises(ValueError, match="positive int"):
        compiler.choose_chunks(3, 1e6)
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "0")
    with pytest.raises(ValueError, match="positive int"):
        compiler.choose_chunks(3, 1e6)
    monkeypatch.delenv("BLUEFOG_PLAN_CHUNKS")
    monkeypatch.setenv("BLUEFOG_PLAN_CALIBRATE", "1")
    # the chooser now prices the stacked transport with the measured probe
    stacked = compiler.TRANSPORT_LINK_CLASS
    assert compiler.choose_chunks(3, 1e6, link_class=stacked) >= 1
    cal = compiler.calibration(stacked)
    assert cal["source"] == "measured-probe" and cal["alpha_s"] > 0
    assert 0 < cal["beta_bytes_per_s"] < float("inf")
    assert compiler.calibration("ici")["source"] == "class-constants"
    with pytest.raises(ValueError, match="link_class"):
        compiler.calibration("nvlink")


@pytest.mark.parametrize("payload", [512.0, 1.06e6, 1e8])
@pytest.mark.parametrize("rounds", [1, 3, 7])
def test_measured_zero_pipeline_eff_gives_one_chunk(payload, rounds):
    """One stream runs the chunks of a wavefront one after another: a
    measured ``pipeline_eff`` of 0, with a finite measured beta, still
    gives one chunk (each extra chunk only adds its launches)."""
    stacked = compiler.TRANSPORT_LINK_CLASS
    compiler.set_calibration(2e-5, 1.5e11, 0.0, source="measured-probe", link_class=stacked)
    elems = int(payload) // 4
    assert compiler.choose_chunks(rounds, payload, n_elems=elems, link_class=stacked) == 1
    assert compiler.reduce_scatter_chunks(SIZE, payload, n_elems=elems,
                                          link_class=stacked) == 1


# -- chunked combines == monolithic ------------------------------------------------------


def _plan_operands(graph="exp2"):
    """Exp2's rounds are full permutations; the star's leave receivers
    without a sender (-1), which the chunked gathers must zero or skip."""
    topo = tu.ExponentialTwoGraph(SIZE) if graph == "exp2" else tu.StarGraph(SIZE)
    return inner.plan_operands(plan_from_topology(topo), "cpu")


GRAPHS = ["exp2", "star"]


def _x(n=3000, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(SIZE, n).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_chunked_exact_combine_bitwise(chunks, graph):
    src, self_w, recv_w = _plan_operands(graph)
    x = _x()
    assert torch.equal(inner.weighted_combine_operands(x, src, self_w, recv_w, chunks=chunks),
                       inner.weighted_combine_operands(x, src, self_w, recv_w))


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("wire", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_quantized_combine_bitwise(wire, dtype, graph):
    src, _self_w, recv_w = _plan_operands(graph)
    x = _x(dtype=dtype)
    mono = inner.weighted_combine_quantized_operands(x, src, recv_w, wire=wire)
    for chunks in (2, 5):
        got = inner.weighted_combine_quantized_operands(x.clone(), src, recv_w, wire=wire,
                                                        chunks=chunks)
        assert torch.equal(got, mono), chunks
    aligned = _x(n=4096)
    mono = inner.weighted_combine_quantized_operands(aligned.clone(), src, recv_w, wire=wire,
                                                     inplace=True)
    got = aligned.clone()
    inner.weighted_combine_quantized_operands(got, src, recv_w, wire=wire, inplace=True,
                                              chunks=3)
    assert torch.equal(got, mono) or wire == "bf16"


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_chunked_ef_combine_bitwise(wire, graph):
    src, _self_w, recv_w = _plan_operands(graph)
    x = _x()
    states = [inner.ef_state_zeros(SIZE, x.shape[1], src.shape[0], "cpu") for _ in range(2)]
    for step in range(3):
        xs = [x + 0.1 * step, x + 0.1 * step]
        a = inner.weighted_combine_quantized_ef_operands(xs[0], states[0], src, recv_w, wire=wire)
        b = inner.weighted_combine_quantized_ef_operands(xs[1], states[1], src, recv_w, wire=wire,
                                                         chunks=4)
        assert torch.equal(a, b)
        assert torch.equal(states[0][0], states[1][0]) and torch.equal(states[0][1], states[1][1])


# -- the optimizers' bucketed gossip == monolithic ------------------------------------------


def _gossip_run(wire, cap, monkeypatch, steps=3, chunks=None, order="atc"):
    if cap is None:
        monkeypatch.setenv("BLUEFOG_OVERLAP", "0")
    else:
        monkeypatch.delenv("BLUEFOG_OVERLAP", raising=False)
        monkeypatch.setenv("BLUEFOG_BUCKET_BYTES", str(cap))
    if chunks is None:
        monkeypatch.delenv("BLUEFOG_PLAN_CHUNKS", raising=False)
    else:
        monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", str(chunks))
    rng = np.random.RandomState(3)
    params = {"a": torch.from_numpy(rng.randn(SIZE, 2500).astype(np.float32)),
              "b": torch.from_numpy(rng.randn(SIZE, 37, 29).astype(np.float32)),
              "c": torch.from_numpy(rng.randn(SIZE, 300).astype(np.float32))}
    if wire is None or not wire.endswith("_ef"):  # the port's EF wire takes f32 only
        params["c"] = params["c"].to(torch.bfloat16)
    target = {k: v.clone() * 0.5 for k, v in params.items()}
    make = (bft.DistributedAdaptThenCombineOptimizer if order == "atc"
            else bft.DistributedNeighborAllreduceOptimizer)
    opt = make(bft.sgd(0.1, momentum=0.9))
    opt.compression = wire
    state = opt.init(params)
    for _ in range(steps):
        opt.step(params, state, {k: params[k] - target[k] for k in params})
    return params, opt


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "fp32")
@pytest.mark.parametrize("order", ["atc", "cta"])
def test_bucketed_optimizer_gossip_bitwise_monolithic(wire, order, monkeypatch):
    mono, mopt = _gossip_run(wire, None, monkeypatch, order=order)
    for cap, chunks in ((2048, None), (4096, 3), (4 << 20, 2)):
        got, opt = _gossip_run(wire, cap, monkeypatch, chunks=chunks, order=order)
        for k in mono:
            assert torch.equal(got[k], mono[k]), (cap, chunks, k)
        if wire is not None and wire.endswith("_ef"):
            for (ms, mr), (gs, gr) in zip(mopt._ef, opt._ef):
                assert torch.equal(ms, gs) and torch.equal(mr, gr)


def test_bucketed_fused_and_delayed_steps_bitwise(monkeypatch):
    """The fused step and the delayed (stale-mix) step bucket the same way."""
    def run(cap, delayed):
        monkeypatch.setenv("BLUEFOG_BUCKET_BYTES", str(cap))
        x = _x(n=5000, seed=4)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
        opt.compression = "int8"
        params = {"w": x.clone()}
        state = opt.init(params)
        step = opt.make_train_step(lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2),
                                   delayed=delayed)
        for _ in range(3):
            params, state, _ = step(params, state, x * 0.3)
        return params["w"]

    for delayed in (False, True):
        assert torch.equal(run(2048, delayed), run(1 << 30, delayed))


def test_wire_payload_and_plan_chunks_equal_jax(monkeypatch):
    import bluefog_tpu as bf
    import jax
    import optax

    from bluefog_tpu import topology as jtu

    params = {"a": torch.zeros(SIZE, 3_000_000), "b": torch.zeros(SIZE, 1000)}
    bf.init(devices=jax.devices("cpu")[:SIZE])
    try:
        bf.set_topology(jtu.ExponentialTwoGraph(SIZE))
        bft.set_topology(tu.ExponentialTwoGraph(SIZE))
        jparams = {"a": jax.ShapeDtypeStruct((SIZE, 3_000_000), np.float32),
                   "b": jax.ShapeDtypeStruct((SIZE, 1000), np.float32)}
        from bluefog_tpu.collective import ops as jops

        for wire in (None, "bf16", "int8", "int4_ef"):
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
            opt.compression = jopt.compression = wire
            plan = bft.get_context().static_plan()
            jplan = jops._resolve_plan(bf.get_context(), None, None, None, True)
            assert plan.perms == jplan.perms
            # the stacked transport: one bucket, one chunk
            payload = opt._wire_payload(params)
            assert payload == (3_001_000 * 4, 3_001_000)
            assert opt._plan_chunks(plan, payload, opt.compression) == 1
            # JAX's default cap asked for, and the ICI link priced: JAX's
            # bucket and chunk count
            monkeypatch.setenv("BLUEFOG_BUCKET_BYTES", str(4 << 20))
            monkeypatch.setattr(compiler, "TRANSPORT_LINK_CLASS", "ici")
            payload = opt._wire_payload(params)
            assert payload == jopt._wire_payload(jparams)
            assert opt._plan_chunks(plan, payload, opt.compression) == \
                jopt._plan_chunks(jplan, payload)
            monkeypatch.delenv("BLUEFOG_BUCKET_BYTES")
            monkeypatch.setattr(compiler, "TRANSPORT_LINK_CLASS", "stacked")
    finally:
        bf.shutdown()


# -- the error-feedback tiers against wire_ref ---------------------------------------------


def _np_encode(x_row, wire):
    """``wire_ref``'s wire format with the programs' scale rule (the
    divide as a multiply by the f32 reciprocal, ``kernels.RECIP_*``)."""
    blocks = np.pad(x_row, (0, -x_row.size % 512)).reshape(-1, 512)
    amax = np.maximum(np.abs(blocks).max(1), np.finfo(np.float32).tiny)
    if wire == "int4":
        s = (amax * np.float32(kernels.RECIP_7)).astype(ml_dtypes.bfloat16)
        q = np.clip(np.round(blocks / s.astype(np.float32)[:, None]), -7, 7).astype(np.int8)
        return wire_ref.np_pack_nibbles(q), s
    s = amax * np.float32(kernels.RECIP_127)
    return np.clip(np.round(blocks / s[:, None]), -127, 127).astype(np.int8), s


def _np_ef_gossip(x, xs, xr, src, w, wire):
    """One CHOCO combine in numpy on ``wire_ref``'s decoder."""
    n = x.shape[1]
    d = xs.shape[1]
    deq = []
    for j in range(SIZE):
        p, s = _np_encode(np.pad(x[j], (0, d - n)) - xs[j], wire)
        deq.append(wire_ref.np_decode(p, s, d, wire))
    deq = np.stack(deq)
    xs = xs + deq
    y = np.pad(x, ((0, 0), (0, d - n))).copy()
    for r in range(src.shape[0]):
        got = np.where(src[r][:, None] >= 0, deq[np.clip(src[r], 0, None)], np.float32(0))
        xr[r] = xr[r] + got
        y = y + (xr[r] - xs) * w[r][:, None]
    return y[:, :n], xs, xr


@pytest.mark.parametrize("wire", ["int8_ef", "int4_ef"])
@pytest.mark.parametrize("cap", [None, 2048])
def test_ef_tiers_against_wire_ref(wire, cap, monkeypatch):
    if cap is None:
        monkeypatch.setenv("BLUEFOG_OVERLAP", "0")
    else:
        monkeypatch.setenv("BLUEFOG_BUCKET_BYTES", str(cap))
    bft.set_topology(tu.ExponentialTwoGraph(SIZE))
    src, _self_w, recv_w = (t.numpy() for t in _plan_operands())
    x0 = np.random.RandomState(9).randn(SIZE, 2000).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    opt.compression = wire
    params = {"w": torch.from_numpy(x0.copy())}
    state = opt.init(params)
    d = -(-2000 // 512) * 512
    x, xs, xr = x0.copy(), np.zeros((SIZE, d), np.float32), np.zeros((3, SIZE, d), np.float32)
    for step in range(4):
        opt.step(params, state, {"w": torch.zeros(SIZE, 2000)})
        x, xs, xr = _np_ef_gossip(x, xs, xr, src, recv_w, wire[:4])
        np.testing.assert_array_equal(params["w"].numpy(), x, err_msg=f"step {step}")
        (es, er), = opt._ef
        np.testing.assert_array_equal(es.numpy(), xs)
        np.testing.assert_array_equal(er.numpy(), xr)
