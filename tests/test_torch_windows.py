# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's window ops (``bluefog_tpu_torch.windows``) against the JAX
package's ``bluefog_tpu.windows``, same numpy inputs, under the exact,
bf16, int8 and int4 window wires (``BLUEFOG_WINDOW_WIRE``).

Each op runs on both sides from the same state (after every op the
port's lanes are set to the JAX side's through ``interop``), so one op's
last-bit differences cannot move a later quantization. Tolerance 1e-6 of
the largest magnitude: XLA:CPU may contract ``bufs + payload * w``,
``v * self_w + sent_w * (x - x_hat)`` and the update's weighted sum into
FMAs, which the port rounds as separate operations. Versions and the
decoded payloads are exact.

The JAX side runs its composite wire (``BLUEFOG_WIRE_KERNELS=0``); its
window quantizer is pinned bitwise to its Pallas kernels by its own tests.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import interop, topology as ttu
from bluefog_tpu_torch.collective import kernels as tk

SIZE = 8
N = 700  # not a whole number of 512-element blocks
WIRES = [None, "bf16", "int8", "int4"]
TOPOLOGIES = {
    "exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
    "star": (tu.StarGraph, ttu.StarGraph),
}


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.win_free()
    bf.turn_off_win_ops_with_associated_p()
    bf.shutdown()
    bft.shutdown()


def _set_wire(monkeypatch, wire):
    if wire is None:
        monkeypatch.delenv("BLUEFOG_WINDOW_WIRE", raising=False)
    else:
        monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", wire)


def _windows(name):
    return bf.get_context().windows[name], bft.get_context().windows[name]


def _compare_and_sync(name, what, scale):
    """Hold the port's lanes to the JAX side's, then copy the JAX lanes
    into the port (the next op starts from the same state)."""
    jwin, twin = _windows(name)
    want = interop.window_lanes_from_jax(jwin)
    got = interop.window_lanes_to_jax(twin)
    for lane in interop.WINDOW_LANES:
        w = want[lane].numpy()
        assert got[lane].shape == w.shape, (what, lane)
        if lane == "versions":
            np.testing.assert_array_equal(got[lane], w, err_msg=f"{what}: {lane}")
        else:
            np.testing.assert_allclose(got[lane], w, rtol=0, atol=1e-6 * scale,
                                       err_msg=f"{what}: {lane}")
    for lane, t in want.items():
        setattr(twin, lane, t)


def _ops(in_nb, out_nb, rng):
    """A sequence of window ops, each as ``(label, call)``: the call
    takes the package (``bf`` or ``bft``) and the per-worker input."""
    def part(entry_fn, frac=0.7):
        keep = rng.rand(SIZE) < frac
        keep[0] = True
        return [entry_fn(r) if keep[r] else None for r in range(SIZE)]

    share = [{d: 1.0 / (len(out_nb[r]) + 1) for d in out_nb[r]} for r in range(SIZE)]
    sw = [1.0 / (len(out_nb[r]) + 1) for r in range(SIZE)]
    pulled = [{s: float(0.2 + 0.1 * k) for k, s in enumerate(in_nb[r])} for r in range(SIZE)]
    part_acc = part(lambda r: share[r])
    part_sw = {r: sw[r] for r in range(SIZE) if part_acc[r] is not None}
    part_upd = part(lambda r: {s: 0.25 for s in in_nb[r]})
    return [
        ("put", lambda m, x: m.win_put(x, name="w")),
        ("acc", lambda m, x: m.win_accumulate(name="w", self_weight=sw, dst_weights=share)),
        ("get", lambda m, x: m.win_get(name="w", src_weights=pulled)),
        ("update", lambda m, x: m.win_update(name="w")),
        ("acc-partial", lambda m, x: m.win_accumulate(
            x, name="w", self_weight=part_sw, dst_weights=part_acc)),
        ("update-partial", lambda m, x: m.win_update(
            name="w", self_weight=0.5, neighbor_weights=part_upd)),
        ("put-weighted", lambda m, x: m.win_put(
            x, name="w", self_weight=0.75, dst_weights=share)),
        ("collect", lambda m, x: m.win_update_then_collect(name="w")),
    ]


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "exact")
def test_window_ops_match_jax(contexts, monkeypatch, wire, topo):
    _set_wire(monkeypatch, wire)
    jgen, tgen = TOPOLOGIES[topo]
    bf.set_topology(jgen(SIZE))
    bft.set_topology(tgen(SIZE))
    ctx = bft.get_context()
    assert bf.in_neighbor_ranks() == ctx.in_neighbor_ranks()
    rng = np.random.RandomState(30)
    x0 = (rng.randn(SIZE, N) * 2).astype(np.float32)
    scale = float(np.abs(x0).max()) * 4
    assert bf.win_create(bf.worker_values(list(x0)), "w")
    assert bft.win_create(torch.from_numpy(x0), "w")
    assert not bft.win_create(torch.from_numpy(x0), "w")
    assert bft.get_current_created_window_names() == ["w"]
    bf.turn_on_win_ops_with_associated_p()
    bft.turn_on_win_ops_with_associated_p()
    _compare_and_sync("w", "create", scale)
    for label, op in _ops(ctx.in_neighbor_ranks(), ctx.out_neighbor_ranks(), rng):
        x = (rng.randn(SIZE, N) * 2).astype(np.float32)
        want = op(bf, bf.worker_values(list(x)))
        got = op(bft, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * scale, err_msg=label)
        assert bft.get_win_version("w") == bf.get_win_version("w"), label
        np.testing.assert_allclose(bft.win_associated_p("w"), bf.win_associated_p("w"),
                                   rtol=1e-6, err_msg=label)
        _compare_and_sync("w", label, scale)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_window_payload_is_the_wire_decode(contexts, monkeypatch, wire):
    """A put on the quantized window wire delivers exactly the decoded
    wire payload: with weight 1 each written slot holds the sender's
    ``decode(encode(x))`` bit for bit (ring: every slot is written)."""
    _set_wire(monkeypatch, wire)
    bft.set_topology(ttu.RingGraph(SIZE))
    x = (np.random.RandomState(31).randn(SIZE, N) * 3).astype(np.float32)
    bft.win_create(torch.zeros(SIZE, N), "w", zero_init=True)
    bft.win_put(torch.from_numpy(x), name="w")
    win = bft.get_context().windows["w"]
    payload, scales = tk.encode(tk.pad_blocks(torch.from_numpy(x)), wire)
    deq = tk.unpad_blocks(tk.decode(payload, scales, None, wire), N)
    for j in range(SIZE):
        for k, s in enumerate(win.in_neighbors[j]):
            assert torch.equal(win.buffers[j, k].view(torch.int32), deq[s].view(torch.int32))


def test_p_lane_stays_off_until_turned_on(contexts):
    bft.set_topology(ttu.RingGraph(SIZE))
    bft.win_create(torch.ones(SIZE, 4), "w")
    bft.win_accumulate(name="w", self_weight=0.5)
    np.testing.assert_array_equal(bft.win_associated_p("w"), np.ones(SIZE))
    bft.turn_on_win_ops_with_associated_p()
    bft.win_accumulate(name="w", self_weight=0.5)
    assert bft.win_associated_p("w", 0) == 0.5
    bft.turn_off_win_ops_with_associated_p()
    bft.win_update_then_collect("w")
    assert bft.win_associated_p("w", 0) == 0.5


def test_nonblocking_handles_and_free(contexts):
    bft.win_create(torch.ones(SIZE, 4), "w")
    h = bft.win_put_nonblocking(name="w")
    assert bft.win_poll(h)
    assert bft.win_wait(h).shape == (SIZE, 4)
    with pytest.raises(ValueError):
        bft.win_wait(h)
    h = bft.win_get_nonblocking(name="w")
    assert torch.equal(bft.win_wait(h), bft.win_read("w"))
    assert bft.win_free("w") and not bft.win_free("w")
    with pytest.raises(ValueError):
        bft.win_read("w")


def test_window_ops_refuse_bad_input(contexts, monkeypatch):
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    bft.win_create(torch.ones(SIZE, 4), "w")
    with pytest.raises(ValueError):  # rank 3 is no in-neighbor of rank 0
        bft.win_put(name="w", dst_weights=[{3: 1.0}] + [None] * (SIZE - 1))
    with pytest.raises(ValueError):  # no buffer slot for source 2 at rank 0
        bft.win_update("w", self_weight=0.5, neighbor_weights=[{2: 0.5}] * SIZE)
    with pytest.raises(ValueError):
        bft.win_update("w", self_weight=0.5)
    with pytest.raises(ValueError):  # one rank's flat dict
        bft.win_accumulate(name="w", dst_weights={1: 0.5})
    with pytest.raises(ValueError):
        bft.win_put(torch.ones(SIZE, 5), name="w")
    bft.win_create(torch.ones(SIZE, 4, dtype=torch.int32), "ints")
    monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", "int8")
    with pytest.raises(ValueError):
        bft.win_put(name="ints")
    monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", "fp4")
    with pytest.raises(ValueError):
        bft.win_put(name="w")


def test_interop_window_lanes_round_trip(contexts):
    x = np.random.RandomState(32).randn(SIZE, 6).astype(np.float32)
    bf.win_create(bf.worker_values(list(x)), "w")
    bft.win_create(torch.from_numpy(x), "w")
    jwin, twin = _windows("w")
    lanes = interop.window_lanes_from_jax(jwin)
    assert lanes["versions"].dtype == torch.int32 and lanes["p"].dtype == torch.float32
    back = interop.window_lanes_to_jax(twin)
    for lane in interop.WINDOW_LANES:
        np.testing.assert_array_equal(back[lane], lanes[lane].numpy())
