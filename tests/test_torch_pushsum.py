# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's push-sum (``DistributedPushSumOptimizer`` and the raw window
ops it rides on) against the numpy oracles of ``test_pushsum_oracle`` and
against the JAX package's optimizer.

- Iterates: the reference recursion on a directed ring (weight-balanced,
  where it equals the accumulated-p one) and the accumulated-p recursion
  on the star, at rtol 1e-4 / atol 1e-5, the oracle file's tolerance.
- Mass: under random partial participation of ``win_accumulate`` and
  the collecting ``win_update``, total x mass (values plus buffers,
  summed in float64) stays within 1e-5 of ``sum |x|`` under the exact,
  int8 and int4 window wires: the sender keeps the residual of the
  quantized mass it ships. (The JAX side fails this property with its
  Pallas kernels in ``shard_map`` on this jax; the port is held to the
  property itself.)
- Training: push-sum on the small ResNet with the int4 window wire
  against the JAX optimizer, losses at rtol 1e-4 over three steps.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import interop, topology as ttu
from bluefog_tpu_torch.models import StackedModel

import test_torch_resnet as tr
import test_torch_train as tt
from test_pushsum_oracle import accumulated_pushsum, reference_pushsum

SIZE = 8


@pytest.fixture
def port():
    bft.init(device="cpu")
    yield
    bft.shutdown()


def sender_stochastic(topo: np.ndarray) -> np.ndarray:
    """``W[i, j]``: rank ``i``'s mass split evenly over itself and its
    out-neighbors (the optimizer's default weights)."""
    w = np.zeros_like(topo, dtype=np.float64)
    for i in range(len(topo)):
        outs = [j for j in np.nonzero(topo[i])[0] if j != i]
        w[i, i] = 1.0 / (len(outs) + 1)
        w[i, outs] = 1.0 / (len(outs) + 1)
    return w


def run_pushsum(z0, c, lr, steps):
    opt = bft.DistributedPushSumOptimizer(bft.sgd(lr))
    state = opt.init({"w": torch.from_numpy(z0.copy())})
    seq = []
    for _ in range(steps):
        est = opt.params()
        _, state = opt.step(state, {"w": est["w"] - torch.from_numpy(c)})
        seq.append(opt.params()["w"].numpy())
    opt.free()
    return np.asarray(seq)


def problem(seed):
    z0 = np.random.RandomState(seed).randn(SIZE, 3).astype(np.float32)
    return z0, z0.copy()


def test_ring_iterates_match_reference_oracle(port):
    z0, c = problem(0)
    graph = ttu.RingGraph(SIZE, connect_style=1)
    bft.set_topology(graph)
    w = sender_stochastic(graph)
    assert np.allclose(w.sum(0), 1.0)
    got = run_pushsum(z0, c, lr=0.2, steps=12)
    z = z0.copy()
    for t in range(12):
        z = reference_pushsum(z, c, 0.2, 1, w)
        np.testing.assert_allclose(got[t], z, rtol=1e-4, atol=1e-5, err_msg=f"step {t}")


def test_star_iterates_match_accumulated_oracle(port):
    """The star is not weight-balanced: the port follows the
    accumulated-p recursion (and, over many steps, the exact mean)."""
    z0, c = problem(1)
    graph = ttu.StarGraph(SIZE)
    bft.set_topology(graph)
    w = sender_stochastic(graph)
    assert not np.allclose(w.sum(0), 1.0)
    got = run_pushsum(z0, c, lr=0.1, steps=6)
    np.testing.assert_allclose(got, accumulated_pushsum(z0, c, 0.1, 6, w), rtol=1e-4, atol=1e-5)
    assert np.abs(got[1] - reference_pushsum(z0, c, 0.1, 2, w)).max() > 1e-3
    got = run_pushsum(z0, c, lr=0.0, steps=120)
    np.testing.assert_allclose(got[-1], np.tile(z0.mean(0), (SIZE, 1)), atol=1e-3)


@pytest.mark.parametrize("wire", [None, "int8", "int4"], ids=lambda w: w or "exact")
def test_interleaved_accumulate_update_conserves_mass(port, monkeypatch, wire):
    """Random partial-participation accumulates (sitting-out ranks as
    ``None`` entries) and collects: total x mass and p mass stay put."""
    if wire is not None:
        monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", wire)
    rng = np.random.RandomState(11)
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    z0 = rng.randn(SIZE, 1024).astype(np.float32)
    bft.win_create(torch.from_numpy(z0), "mass", zero_init=True)
    bft.turn_on_win_ops_with_associated_p()
    ctx = bft.get_context()
    win = ctx.windows["mass"]
    outs = ctx.out_neighbor_ranks()
    mass0 = float(np.sum(z0, dtype=np.float64))
    scale = float(np.abs(z0).sum())
    kinds = []
    for t in range(12):
        part = rng.rand(SIZE) < 0.7
        if rng.rand() < 0.6:
            dst = [{d: 1.0 / (len(outs[r]) + 1) for d in outs[r]} if part[r] else None
                   for r in range(SIZE)]
            sw = {r: 1.0 / (len(outs[r]) + 1) for r in range(SIZE) if part[r]}
            bft.win_accumulate(name="mass", self_weight=sw, dst_weights=dst)
            kinds.append("acc")
        else:
            nw = [{s: 1.0 for s in win.in_neighbors[r]} if part[r] else None
                  for r in range(SIZE)]
            bft.win_update(name="mass", self_weight=1.0, neighbor_weights=nw, reset=True)
            kinds.append("collect")
        total = win.value.double().sum() + win.buffers.double().sum()
        assert abs(float(total) - mass0) < 1e-5 * scale, (t, wire)
        p_total = win.p.double().sum() + win.p_buffers.double().sum()
        assert abs(float(p_total) - SIZE) < 1e-5, (t, wire)
    assert {"acc", "collect"} <= set(kinds)
    if wire is not None:  # the wire really quantized: buffers hold decoded values
        assert not torch.equal(win.value, torch.from_numpy(z0))


@pytest.mark.parametrize("mode", ["put", "get"])
def test_win_put_and_pull_get_optimizers_reach_consensus(port, mode):
    """The diffusion optimizers at lr = 0 contract to a consensus on
    Exp(8) (their combine is not mass-preserving, so no exact mean)."""
    x = np.random.RandomState(12).randn(SIZE, 5).astype(np.float32)
    make = {"put": bft.DistributedWinPutOptimizer,
            "get": bft.DistributedPullGetOptimizer}[mode]
    opt = make(bft.sgd(0.0), num_steps_per_communication=2)
    params = {"a": torch.from_numpy(x[:, :2].copy()), "b": torch.from_numpy(x[:, 2:].copy())}
    state = opt.init(params)
    zero = {"a": torch.zeros(SIZE, 2), "b": torch.zeros(SIZE, 3)}
    est, _ = opt.step(state, zero)  # a local step: no exchange
    np.testing.assert_array_equal(est["a"].numpy(), x[:, :2])
    for _ in range(59):
        est, state = opt.step(state, zero)
    out = np.concatenate([est["a"].numpy(), est["b"].numpy()], 1)
    assert np.abs(out - out.mean(0)).max() < 1e-4 * np.abs(x).max()
    opt.free()
    assert bft.get_current_created_window_names() == []


def test_pushsum_holds_and_releases_the_p_lane(port):
    ctx = bft.get_context()
    a = bft.DistributedPushSumOptimizer(bft.sgd(0.1))
    b = bft.DistributedPushSumOptimizer(bft.sgd(0.1))
    a.init({"w": torch.zeros(SIZE, 3)})
    b.init({"w": torch.zeros(SIZE, 3)})
    assert ctx.p_enabled() and ctx.p_refcount == 2
    a.free()
    assert ctx.p_enabled()
    b.free()
    b.free()
    assert not ctx.p_enabled() and ctx.p_refcount == 0


@pytest.fixture
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", "int4")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.win_free()
    bf.shutdown()
    bft.shutdown()


def test_pushsum_int4_window_resnet_matches_jax(contexts, monkeypatch):
    """Three push-sum steps of the small ResNet on 8 workers with the
    int4 window wire, gradients taken at ``params()``, each from the same
    state (window lanes, momentum and batch statistics set to the JAX
    side's after every step). The JAX combo window is the packed leaves
    (``n`` per worker); the port's is the model's flat buffer, padded to
    whole blocks with zeros. Losses within rtol 1e-4; p exact.

    The window value: the two gradients differ in their last bits, and
    such a difference can flip one rounding of the quantizer, which moves
    a value by at most one int4 quantum of its 512-block (the largest
    scale any sender shipped for that block). So every element is held
    to that quantum, all but 1% of them to 1e-3 of it and all but 0.1% to
    a tenth of it (measured on the CPU: 99.9% within 3.4e-3 quanta, at
    most 56 of 1 047 696 elements past 0.1); a wrong exchange weight, a
    dropped residual or a wrong slot moves most elements by far more."""
    import optax
    from bluefog_tpu_torch.collective import kernels as tkernels

    shipped = []
    encode = tkernels.encode

    def recording_encode(x, wire):
        payload, scales = encode(x, wire)
        shipped.append(scales.float())
        return payload, scales

    monkeypatch.setattr(tkernels, "encode", recording_encode)

    params, stats = tr.carried_variables(seed=8)
    rng = np.random.RandomState(9)
    images = rng.randn(SIZE, 4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, tr.CLASSES, (SIZE, 4)).astype(np.int32)
    stack = lambda a: np.broadcast_to(a, (SIZE,) + a.shape).copy()
    jopt = bf.DistributedPushSumOptimizer(optax.sgd(0.1, momentum=0.9))
    jstate = jopt.init(tt._map(lambda a: bf.worker_values(list(stack(a))), params))
    jstats = tt._map(stack, stats)
    loss_grad = tt._jax_loss_and_grad()

    sm = StackedModel(tr.port_model(), SIZE, "cpu")
    sm.load_buffers(interop.batch_stats_from_flax(stats))
    topt = bft.DistributedPushSumOptimizer(bft.sgd(0.1, momentum=0.9))
    tstate = topt.init(sm.pack(interop.params_from_flax(params)).repeat(SIZE, 1).contiguous())
    timages, tlabels = torch.from_numpy(images), torch.from_numpy(labels).long()
    n = sm.n_params

    def pad(a):
        out = np.zeros(a.shape[:-1] + (sm.width,), np.float32)
        out[..., :n] = a
        return torch.from_numpy(out)

    for step in range(3):
        jloss, jstats, jgrads = loss_grad(jopt.params(), jstats, images, labels)
        jopt.step(jstate, tt._map(lambda a: bf.worker_values(list(a)), jgrads))
        tloss, tgrads = sm.loss_and_grad(topt.params(), timages, tlabels)
        shipped.clear()
        topt.step(tstate, tgrads)
        np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-4, err_msg=f"step {step}")

        jwin = bf.get_context().windows[jopt._name]
        twin = bft.get_context().windows[topt._name]
        want = interop.window_lanes_from_jax(jwin)
        got = interop.window_lanes_to_jax(twin)
        value = want["value"].numpy()
        scales, = shipped  # one encode per exchange: [N, blocks]
        quantum = np.repeat(scales.max(0).values.numpy(), tkernels.CHUNK)[:n]
        err = np.abs(got["value"][:, :n] - value)
        assert (err <= quantum).all(), f"step {step}: {(err / quantum).max()} quanta"
        for share, tol in ((1e-2, 1e-3), (1e-3, 0.1)):
            off = int((err > tol * quantum).sum())
            assert off <= share * err.size, f"step {step}: {off} elements off by > {tol} quanta"
        assert not got["value"][:, n:].any()
        np.testing.assert_array_equal(got["p"], want["p"].numpy())
        np.testing.assert_array_equal(got["versions"], want["versions"].numpy())

        twin.value = pad(value)
        twin.buffers = pad(want["buffers"].numpy())
        twin.p, twin.p_buffers = want["p"], want["p_buffers"]
        tstate[:, :n] = torch.from_numpy(tt._rows(jstate))
        sm.load_buffers({k: torch.from_numpy(np.asarray(v)) for k, v in
                         interop.flatten_tree(jstats).items()})
    jopt.free()
    topt.free()
