# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's torch frontend (``bluefog_tpu_torch.torch``) against the JAX
package's (``bluefog_tpu.torch``) on the 8-device CPU mesh.

Part 1 runs every case of ``tests/test_torch_frontend.py`` (the JAX
frontend's own file) on both frontends. Where JAX refuses an input only
because its mesh computes in 32 bits (float64, complex128, int64 outside
int32, an int64 sum past int32, an int64 average past 2**24), the port's
case asserts numpy's exact 64-bit answer instead of the refusal. A bf16
round trip through the port's ``to_numpy`` names ``dtype=torch.bfloat16``
on the way back (numpy has no bf16; the bits travel as ``np.uint16``).

Part 2 holds the port to JAX on the same inputs, made from a numpy seed,
JAX on its composite wire (``BLUEFOG_WIRE_KERNELS=0``), one chunk a
combine. Tolerances:

- ops that only move bits (``broadcast``, ``allgather``,
  ``neighbor_allgather``), the int8/int4 payload and scale bits, and every
  integer result: bitwise;
- ``allreduce`` and ``neighbor_allreduce`` on every wire, forward and
  gradient: 1e-6 of the largest value (sums in another order; XLA:CPU
  contracts a product and a sum into one FMA, ROADMAP C note 2);
- a bf16 result, as bits (``to_numpy``'s ``np.uint16`` against JAX's
  array viewed as ``np.uint16``): bitwise on Exp2(8), whose weights are
  powers of two; on the ring (weights 1/3) a combine is within one bf16
  unit in the last place (2**-7) of the largest value (XLA:CPU keeps a
  fused bf16 chain in f32 where PyTorch rounds each operation);
- three steps of the wrapped ``torch.optim.SGD`` on a small stacked
  ResNet, each side taking its gradients from the port's ``StackedModel``
  at its own parameters: fp32 (gradient allreduce, neighbour allreduce,
  dynamic weights) within 1e-6 of the largest parameter, the combine's
  tolerance; int8 within 1e-5 (the combine's 1e-6 a step, carried through
  the next steps' gradients; a value moved across a rounding boundary of
  the wire would cost a whole quantum, about 1e-2 of its block).

Part 3 pins the four 64-bit inputs that JAX refuses to numpy's exact
answers.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu.torch as jft
from bluefog_tpu import topology as tu
from bluefog_tpu.collective import inner as jinner
from bluefog_tpu.collective import plan as jplan
import bluefog_tpu_torch as bft
import bluefog_tpu_torch.torch as tft
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import kernels
from bluefog_tpu_torch.collective import plan as tplan
from bluefog_tpu_torch.models import ResNet50, StackedModel, resnet

SIZE = 8
DIM = 4
WIRES = [None, "bf16", "int8", "int4"]


class Side:
    """One frontend with its facade, graph generators and plan module."""

    def __init__(self, name):
        self.port = name == "port"
        self.bf = bft if self.port else bf
        self.ft = tft if self.port else jft
        self.tu = ttu if self.port else tu
        self.plan = tplan if self.port else jplan


@pytest.fixture(params=["jax", "port"])
def fe(request, cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    side = Side(request.param)
    if side.port:
        bft.init(device="cpu")
    else:
        bf.init(devices=cpu_devices[:SIZE])
    yield side
    side.bf.shutdown()


def stacked(fill=None, shape=(DIM,), dtype=torch.float32):
    if fill is None:
        return torch.stack(
            [torch.full(shape, float(r)) for r in range(SIZE)]
        ).to(dtype)
    return torch.as_tensor(fill, dtype=dtype)


# -- part 1: the JAX frontend's cases on both frontends ---------------------------------


def test_allreduce_mean(fe):
    out = fe.ft.allreduce(stacked())
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out, torch.full((SIZE, DIM), (SIZE - 1) / 2.0))


def test_allreduce_sum(fe):
    out = fe.ft.allreduce(stacked(), average=False)
    torch.testing.assert_close(
        out, torch.full((SIZE, DIM), float(SIZE * (SIZE - 1) // 2))
    )


def test_broadcast(fe):
    out = fe.ft.broadcast(stacked(), root_rank=5)
    torch.testing.assert_close(out, torch.full((SIZE, DIM), 5.0))


def test_allgather(fe):
    out = fe.ft.allgather(stacked(shape=(2,)))
    assert out.shape == (SIZE, SIZE * 2)
    expected = torch.repeat_interleave(torch.arange(SIZE, dtype=torch.float32), 2)
    torch.testing.assert_close(out[3], expected)


def test_neighbor_allreduce_matches_numpy_oracle(fe):
    fe.bf.set_topology(fe.tu.RingGraph(SIZE))
    x = np.random.RandomState(0).randn(SIZE, DIM).astype(np.float32)
    out = fe.ft.neighbor_allreduce(torch.from_numpy(x.copy()))
    w = np.zeros((SIZE, SIZE))
    for j in range(SIZE):
        for i in (j - 1, j, j + 1):
            w[i % SIZE, j] = 1.0 / 3.0
    np.testing.assert_allclose(out.numpy(), w.T @ x, rtol=1e-5, atol=1e-6)


def test_neighbor_allreduce_explicit_weights(fe):
    srcs = [{(r - 1) % SIZE: 0.5} for r in range(SIZE)]
    x = stacked()
    out = fe.ft.neighbor_allreduce(x, self_weight=0.5, src_weights=srcs)
    torch.testing.assert_close(out, 0.5 * x + 0.5 * torch.roll(x, 1, dims=0))


def test_neighbor_allgather(fe):
    fe.bf.set_topology(fe.tu.RingGraph(SIZE))
    outs = fe.ft.neighbor_allgather(stacked(shape=(2,)))
    assert len(outs) == SIZE
    # ring in-neighbors of rank 3 are {2, 4}, rank-ascending
    torch.testing.assert_close(outs[3], torch.tensor([[2.0, 2.0], [4.0, 4.0]]))


def test_allreduce_gradient(fe):
    x = stacked().requires_grad_(True)
    y = fe.ft.allreduce(x)
    v = torch.randn(SIZE, DIM)
    (y * v).sum().backward()
    torch.testing.assert_close(x.grad, v.mean(0, keepdim=True).expand_as(v))


def test_broadcast_gradient(fe):
    x = stacked().requires_grad_(True)
    fe.ft.broadcast(x, root_rank=2).sum().backward()
    expected = torch.zeros(SIZE, DIM)
    expected[2] = SIZE
    torch.testing.assert_close(x.grad, expected)


def test_neighbor_allreduce_gradient_is_transposed_combine(fe):
    fe.bf.set_topology(fe.tu.ExponentialTwoGraph(SIZE))
    xnp = np.random.RandomState(1).randn(SIZE, DIM).astype(np.float32)
    vnp = np.random.RandomState(2).randn(SIZE, DIM).astype(np.float32)
    x = torch.from_numpy(xnp.copy()).requires_grad_(True)
    y = fe.ft.neighbor_allreduce(x)
    (y * torch.from_numpy(vnp)).sum().backward()
    w = fe.plan.plan_from_topology(fe.tu.ExponentialTwoGraph(SIZE),
                                   weighted=False).weight_matrix()
    np.testing.assert_allclose(x.grad.numpy(), w @ vnp, rtol=1e-5, atol=1e-6)


def test_full_jacobian_equals_weight_matrix(fe):
    """Column by column: d y_j / d x_i == W[i, j]."""
    fe.bf.set_topology(fe.tu.RingGraph(SIZE))
    w = fe.plan.plan_from_topology(fe.tu.RingGraph(SIZE), weighted=False).weight_matrix()
    jac = np.zeros((SIZE, SIZE), np.float32)
    for j in range(SIZE):
        x = torch.zeros(SIZE, 1, requires_grad=True)
        y = fe.ft.neighbor_allreduce(x)
        g = torch.zeros_like(y)
        g[j, 0] = 1.0
        (gx,) = torch.autograd.grad(y, x, g)
        jac[:, j] = gx.numpy()[:, 0]
    np.testing.assert_allclose(jac, w, rtol=1e-6, atol=1e-7)


def test_bfloat16_roundtrip_bit_exact(fe):
    x = stacked(dtype=torch.bfloat16)
    a = fe.ft.to_numpy(x)
    back = fe.ft.from_numpy(a, dtype=torch.bfloat16) if fe.port else fe.ft.from_numpy(a)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    if fe.port:  # numpy has no bf16: the bits leave as uint16
        assert a.dtype == np.uint16


def test_bfloat16_gossip_stays_bfloat16(fe):
    out = fe.ft.neighbor_allreduce(stacked(dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


def quad_problem(seed=0):
    c = np.random.RandomState(seed).randn(SIZE, DIM).astype(np.float32)
    return c, torch.nn.Parameter(torch.from_numpy(c.copy()))


def test_gradient_allreduce_optimizer_matches_centralized_sgd(fe):
    c, p = quad_problem()
    opt = fe.ft.DistributedGradientAllreduceOptimizer(torch.optim.SGD([p], lr=0.5))
    ref = torch.from_numpy(c.copy())
    for _ in range(10):
        opt.zero_grad()
        (0.5 * ((p - torch.from_numpy(c)) ** 2).sum()).backward()
        opt.step()
        # every worker follows the mean gradient
        ref = ref - 0.5 * (ref - torch.from_numpy(c)).mean(0, keepdim=True)
    torch.testing.assert_close(p.data, ref, rtol=1e-4, atol=1e-5)


def test_neighbor_allreduce_optimizer_reaches_consensus(fe):
    c, p = quad_problem(3)
    opt = fe.ft.DistributedNeighborAllreduceOptimizer(torch.optim.SGD([p], lr=0.1))
    for _ in range(60):
        opt.zero_grad()
        (0.5 * ((p - torch.from_numpy(c)) ** 2).sum()).backward()
        opt.step()
        opt.param_groups[0]["lr"] *= 0.95
    w = p.data.numpy()
    target = c.mean(0)
    assert np.abs(w - target).max() < 0.25 * np.abs(c - target).max()
    assert np.abs(w - w.mean(0)).max() < 0.2


def test_broadcast_parameters_and_validation(fe):
    params = {"a": torch.randn(SIZE, DIM), "b": torch.randn(SIZE)}
    ref = params["a"][1].clone()
    fe.ft.broadcast_parameters(params, root_rank=1)
    for r in range(SIZE):
        torch.testing.assert_close(params["a"][r], ref)
    with pytest.raises(ValueError, match="root_rank"):
        fe.ft.broadcast_parameters(params, root_rank=SIZE)
    with pytest.raises(ValueError, match="worker-stacked"):
        fe.ft.broadcast_parameters({"x": torch.randn(SIZE + 1, 2)})


def test_wrapper_rejects_unstacked_parameters(fe):
    p = torch.nn.Parameter(torch.randn(SIZE + 1, DIM))
    with pytest.raises(ValueError, match="worker-stacked"):
        fe.ft.DistributedGradientAllreduceOptimizer(torch.optim.SGD([p], lr=0.1))


def test_wrapper_is_real_torch_optimizer_with_scheduler(fe):
    c, p = quad_problem(5)
    sgd = torch.optim.SGD([p], lr=0.4)
    opt = fe.ft.DistributedGradientAllreduceOptimizer(sgd)
    assert opt is sgd and isinstance(opt, torch.optim.Optimizer)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.5)
    for _ in range(4):
        opt.zero_grad()
        (0.5 * ((p - torch.from_numpy(c)) ** 2).sum()).backward()
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(0.1)
    opt.load_state_dict(opt.state_dict())
    with pytest.raises(ValueError, match="worker-stacked"):
        opt.add_param_group({"params": [torch.nn.Parameter(torch.ones(3))]})


def test_broadcast_parameters_skips_non_tensor_dict_values(fe):
    params = {"w": torch.randn(SIZE, DIM), "meta": {"nested": "state"}, "lst": [1, 2, 3]}
    ref = params["w"][0].clone()
    fe.ft.broadcast_parameters(params, root_rank=0)
    torch.testing.assert_close(params["w"][3], ref)
    assert params["meta"] == {"nested": "state"}


def test_64bit_dtypes_rejected_not_truncated(fe):
    """JAX refuses out-of-int32 int64 and float64 (its 32-bit mesh would
    corrupt them); the port answers exactly."""
    big = torch.full((SIZE, 2), 2**40, dtype=torch.int64)
    f64 = torch.from_numpy(np.random.RandomState(0).randn(SIZE, 2))
    if not fe.port:
        with pytest.raises(TypeError, match="int32 range"):
            fe.ft.allreduce(big)
        with pytest.raises(TypeError, match="int32 range"):
            fe.ft.broadcast_parameters([big])
        assert big[0, 0].item() == 2**40
        with pytest.raises(TypeError, match="precision"):
            fe.ft.allreduce(f64)
        return
    out = fe.ft.allreduce(big)
    assert out.dtype == torch.float64 and (out == 2.0**40).all()
    fe.ft.broadcast_parameters([big])
    assert big.dtype == torch.int64 and (big == 2**40).all()
    out = fe.ft.allreduce(f64, average=False)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(f64.numpy().sum(0), (SIZE, 2)),
                               rtol=1e-15)


def test_add_param_group_failure_leaves_optimizer_clean(fe):
    c, p = quad_problem(7)
    opt = fe.ft.DistributedGradientAllreduceOptimizer(torch.optim.SGD([p], lr=0.1))
    with pytest.raises(ValueError, match="worker-stacked"):
        opt.add_param_group({"params": [torch.nn.Parameter(torch.ones(3))]})
    assert len(opt.param_groups) == 1


def test_int64_in_range_narrows_losslessly(fe):
    t = torch.full((SIZE, 2), 7, dtype=torch.int64)
    fe.ft.broadcast_parameters([t], root_rank=3)
    assert t.dtype == torch.int64 and t[0, 0].item() == 7
    big = torch.full((SIZE, 2), 2**40, dtype=torch.int64)
    if fe.port:
        assert fe.ft.allreduce(big, average=False)[0, 0].item() == SIZE * 2**40
    else:
        with pytest.raises(TypeError, match="int32 range"):
            fe.ft.allreduce(big)


def test_add_param_group_accepts_generator(fe):
    c, p = quad_problem(9)
    opt = fe.ft.DistributedGradientAllreduceOptimizer(torch.optim.SGD([p], lr=0.1))
    extra = torch.nn.Parameter(torch.randn(SIZE, 2))
    opt.add_param_group({"params": (q for q in [extra])})
    assert len(opt.param_groups) == 2
    assert len(opt.param_groups[1]["params"]) == 1


def test_int64_results_keep_dtype_and_sum_overflow_refused(fe):
    t = torch.full((SIZE, 2), 7, dtype=torch.int64)
    assert fe.ft.broadcast(t, 0).dtype == torch.int64
    assert fe.ft.allgather(t).dtype == torch.int64
    assert fe.ft.allreduce(t, average=False).dtype == torch.int64
    assert fe.ft.allreduce(t, average=False)[0, 0].item() == 7 * SIZE
    near = torch.full((SIZE, 2), 2**28, dtype=torch.int64)  # fits int32, its sum does not
    if fe.port:
        out = fe.ft.allreduce(near, average=False)
        assert out.dtype == torch.int64 and (out == SIZE * 2**28).all()
    else:
        with pytest.raises(TypeError, match="overflow"):
            fe.ft.allreduce(near, average=False)


def test_int64_average_inexact_refused(fe):
    small = torch.full((SIZE, 2), 1000, dtype=torch.int64)
    assert fe.ft.allreduce(small, average=True)[0, 0].item() == 1000.0
    big = torch.full((SIZE, 2), 2**24 + 1, dtype=torch.int64)  # in int32 range
    if fe.port:
        out = fe.ft.allreduce(big, average=True)
        assert out.dtype == torch.float64 and (out == 2.0**24 + 1).all()
    else:
        with pytest.raises(TypeError, match="float32"):
            fe.ft.allreduce(big, average=True)


def test_neighbor_optimizer_dynamic_topology_idiom(fe):
    c, p = quad_problem(11)
    opt = fe.ft.DistributedNeighborAllreduceOptimizer(torch.optim.SGD([p], lr=0.2))
    for i in range(40):
        shift = 1 + (i % 2)
        opt.self_weight = 0.5
        opt.src_weights = [{(r - shift) % SIZE: 0.5} for r in range(SIZE)]
        opt.dst_weights = [[(r + shift) % SIZE] for r in range(SIZE)]
        opt.zero_grad()
        (0.5 * ((p - torch.from_numpy(c)) ** 2).sum()).backward()
        opt.step()
        opt.param_groups[0]["lr"] *= 0.95
    w = p.data.numpy()
    assert np.abs(w - w.mean(0)).max() < 0.25
    assert np.abs(w.mean(0) - c.mean(0)).max() < 0.1


def test_neighbor_allreduce_compression(fe):
    fe.bf.set_topology(fe.tu.RingGraph(SIZE))
    x = torch.randn(SIZE, 64)
    exact = fe.ft.neighbor_allreduce(x)
    for comp, tol in (("bf16", 0.02), ("int8", 0.05)):
        out = fe.ft.neighbor_allreduce(x, compression=comp)
        assert (out - exact).abs().max().item() < tol, comp
    xg = x.clone().requires_grad_(True)
    fe.ft.neighbor_allreduce(xg, compression="int8").sum().backward()
    assert torch.isfinite(xg.grad).all()

    c, p = quad_problem(13)
    opt = fe.ft.DistributedNeighborAllreduceOptimizer(torch.optim.SGD([p], lr=0.1))
    opt.compression = "int8"
    for _ in range(40):
        opt.zero_grad()
        (0.5 * ((p - torch.from_numpy(c)) ** 2).sum()).backward()
        opt.step()
        opt.param_groups[0]["lr"] *= 0.95
    w = p.data.numpy()
    assert np.abs(w - w.mean(0)).max() < 0.25


def test_compression_validated_at_torch_boundary(fe):
    with pytest.raises(ValueError, match="compression must be"):
        fe.ft.neighbor_allreduce(torch.randn(SIZE, 4), compression="fp16")


# -- part 2: the port against JAX on the same inputs -----------------------------------


@pytest.fixture
def both(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.shutdown()
    bft.shutdown()


GRAPHS = {
    "exp": (tu.ExponentialGraph, ttu.ExponentialGraph),
    "exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
    "ring": (tu.RingGraph, ttu.RingGraph),
}


def _set_graph(name):
    jgraph, tgraph = GRAPHS[name]
    bf.set_topology(jgraph(SIZE))
    bft.set_topology(tgraph(SIZE))


def _inputs(seed, shape=(SIZE, 1500), dtype=np.float32):
    return (np.random.RandomState(seed).randn(*shape) * 5.0).astype(dtype)


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _same(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _one_peer(step):
    shift = 1 + step % 2
    return dict(self_weight=0.5,
                src_weights=[{(r - shift) % SIZE: 0.5} for r in range(SIZE)],
                dst_weights=[[(r + shift) % SIZE] for r in range(SIZE)])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("wire", WIRES)
def test_neighbor_allreduce_forward_and_gradient_match_jax(both, graph, wire):
    _set_graph(graph)
    x, v = _inputs(1), _inputs(2)
    outs, grads = [], []
    for ft in (tft, jft):
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = ft.neighbor_allreduce(xt, compression=wire)
        (y * torch.from_numpy(v)).sum().backward()
        outs.append(y.detach().numpy())
        grads.append(xt.grad.numpy())
    _close(*outs)
    _close(*grads)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("wire", WIRES)
def test_dynamic_weights_forward_and_gradient_match_jax(both, step, wire):
    x, v = _inputs(3), _inputs(4)
    outs, grads = [], []
    for ft in (tft, jft):
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = ft.neighbor_allreduce(xt, compression=wire, **_one_peer(step))
        (y * torch.from_numpy(v)).sum().backward()
        outs.append(y.detach().numpy())
        grads.append(xt.grad.numpy())
    _close(*outs)
    _close(*grads)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_wire_payload_and_scale_bits_equal_jax(both, wire, monkeypatch):
    """The payload and the scales that the forward's ``encode`` put on the
    wire are bitwise JAX's block quantizer of each worker's row."""
    seen = []
    encode = kernels.encode

    def recording(x, w):
        out = encode(x, w)
        seen.append(out)
        return out

    monkeypatch.setattr(kernels, "encode", recording)
    x = _inputs(5)
    tft.neighbor_allreduce(torch.from_numpy(x.copy()).requires_grad_(True), compression=wire)
    assert len(seen) == 1
    payload, scales = seen[0]
    quant = jinner._chunk_quantize4 if wire == "int4" else jinner._chunk_quantize
    for w in range(SIZE):
        q, s = quant(x[w])[:2]
        np.testing.assert_array_equal(payload[w].reshape(-1).numpy(), np.asarray(q).reshape(-1))
        got_s = scales[w].reshape(-1)
        if wire == "int4":
            np.testing.assert_array_equal(got_s.view(torch.int16).numpy(),
                                          np.asarray(s).view(np.int16))
        else:
            np.testing.assert_array_equal(got_s.view(torch.int32).numpy(),
                                          np.asarray(s).view(np.int32))


@pytest.mark.parametrize("average", [True, False])
def test_allreduce_forward_and_gradient_match_jax(both, average):
    x, v = _inputs(6, (SIZE, 3, 7)), _inputs(7, (SIZE, 3, 7))
    outs, grads = [], []
    for ft in (tft, jft):
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = ft.allreduce(xt, average=average)
        (y * torch.from_numpy(v)).sum().backward()
        outs.append(y.detach().numpy())
        grads.append(xt.grad.numpy())
    _close(*outs)
    _close(*grads)


@pytest.mark.parametrize("root", [0, 5])
def test_broadcast_forward_and_gradient_match_jax(both, root):
    x, v = _inputs(8, (SIZE, 9)), _inputs(9, (SIZE, 9))
    outs, grads = [], []
    for ft in (tft, jft):
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = ft.broadcast(xt, root)
        (y * torch.from_numpy(v)).sum().backward()
        outs.append(y.detach())
        grads.append(xt.grad.numpy())
    _same(*outs)
    _close(*grads)


@pytest.mark.parametrize("graph", ["exp2", "ring"])
def test_gathers_match_jax_and_are_not_differentiable(both, graph):
    _set_graph(graph)
    x = _inputs(10, (SIZE, 2, 3))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got, want = tft.allgather(xt), jft.allgather(xt)
    _same(got, want)
    assert not got.requires_grad
    got, want = tft.neighbor_allgather(xt), jft.neighbor_allgather(xt)
    assert len(got) == len(want) == SIZE
    for g, w in zip(got, want):
        _same(g, w)
        assert not g.requires_grad


@pytest.mark.parametrize("values", ["small", "int32 wide", "f32 exact"])
def test_int64_results_match_jax(both, values):
    rng = np.random.RandomState(11)
    hi = {"small": 1000, "int32 wide": 2**31 // SIZE, "f32 exact": 2**24 // SIZE}[values]
    t = torch.from_numpy(rng.randint(-hi, hi, (SIZE, 5)).astype(np.int64))
    calls = {
        "sum": lambda ft: ft.allreduce(t, average=False),
        "broadcast": lambda ft: ft.broadcast(t, 3),
        "allgather": lambda ft: ft.allgather(t),
        "neighbor_allreduce": lambda ft: ft.neighbor_allreduce(t),
        "neighbor_allreduce int8": lambda ft: ft.neighbor_allreduce(t, compression="int8"),
    }
    if values != "int32 wide":  # JAX refuses the average past 2**24
        calls["average"] = lambda ft: ft.allreduce(t, average=True)
    for name, call in calls.items():
        got, want = call(tft), call(jft)
        assert got.dtype == want.dtype, name
        if got.dtype == torch.int64:
            _same(got, want)
        else:
            assert got.dtype == torch.float32, name
            _close(got.numpy(), want.numpy())
    for got, want in zip(tft.neighbor_allgather(t), jft.neighbor_allgather(t)):
        _same(got, want)
    got, want = tft.to_numpy(t), jft.to_numpy(t)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graph", ["exp2", "ring"])
@pytest.mark.parametrize("op", ["broadcast", "allgather", "neighbor_allgather", "average",
                                "neighbor_allreduce", "neighbor_allreduce bf16"])
def test_bf16_bits_match_jax(both, op, graph):
    """bf16 results as bits: ``to_numpy``'s ``np.uint16`` against JAX's
    ``ml_dtypes.bfloat16`` viewed as ``np.uint16``: bitwise, but a combine
    on the ring within one bf16 unit of the largest value."""
    _set_graph(graph)
    t = torch.from_numpy(_inputs(12, (SIZE, 700))).to(torch.bfloat16)
    call = {
        "broadcast": lambda ft: [ft.broadcast(t, 2)],
        "allgather": lambda ft: [ft.allgather(t)],
        "neighbor_allgather": lambda ft: ft.neighbor_allgather(t),
        "average": lambda ft: [ft.allreduce(t)],
        "neighbor_allreduce": lambda ft: [ft.neighbor_allreduce(t)],
        "neighbor_allreduce bf16": lambda ft: [ft.neighbor_allreduce(t, compression="bf16")],
    }[op]
    for got, want in zip(call(tft), call(jft)):
        assert got.dtype == want.dtype == torch.bfloat16
        got_bits, want_bits = tft.to_numpy(got), jft.to_numpy(want).view(np.uint16)
        assert got_bits.dtype == np.uint16
        if graph == "exp2" or op in ("broadcast", "allgather", "neighbor_allgather"):
            np.testing.assert_array_equal(got_bits, want_bits)
        else:
            _close(got.float().numpy(), want.float().numpy(), rel=2**-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int32,
                                   torch.int64, torch.uint8, torch.bool])
def test_to_numpy_and_back_match_jax(dtype):
    t = torch.from_numpy(_inputs(13, (SIZE, 6)) * 20).to(dtype)
    got, want = tft.to_numpy(t), jft.to_numpy(t)
    if dtype == torch.bfloat16:
        want = want.view(np.uint16)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    back = tft.from_numpy(got, dtype=torch.bfloat16 if dtype == torch.bfloat16 else None)
    want = jft.from_numpy(jft.to_numpy(t))
    assert back.dtype == want.dtype
    assert torch.equal(back.view(torch.int16) if dtype == torch.bfloat16 else back,
                       want.view(torch.int16) if dtype == torch.bfloat16 else want)


# -- part 2b: the wrapped torch.optim.SGD on a small ResNet, three steps -----------------

OPT_CASES = {
    # name -> tolerance, of the largest parameter
    "grad-allreduce": 1e-6,
    "neighbor": 1e-6,
    "neighbor/int8": 1e-5,
    "dynamic": 1e-6,
}


@pytest.fixture(scope="module")
def small_resnet():
    model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                           stage_sizes=[1, 1, 1, 1]), 0)
    sm = StackedModel(model, SIZE, "cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    return sm, images, labels


def _wrapped_steps(ft, case, sm, images, labels, params0, stats0, steps=3):
    """``steps`` of the frontend ``ft``'s wrapper around
    ``torch.optim.SGD(lr=0.1, momentum=0.9)`` under ``StepLR(2, 0.5)``,
    the gradients from ``sm`` at the wrapper's own parameters."""
    sm.load_buffers(stats0)
    flat = torch.nn.Parameter(params0.clone())
    flat.grad = torch.zeros_like(flat)
    sgd = torch.optim.SGD([flat], lr=0.1, momentum=0.9)
    if case == "grad-allreduce":
        opt = ft.DistributedGradientAllreduceOptimizer(sgd)
    else:
        opt = ft.DistributedNeighborAllreduceOptimizer(sgd)
        opt.compression = "int8" if case == "neighbor/int8" else None
    assert opt is sgd
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.5)
    out = []
    for i in range(steps):
        if case == "dynamic":
            for key, value in _one_peer(i).items():
                setattr(opt, key, value)
        sm.loss_and_grad(flat.data, images, labels, flat.grad)
        opt.step()
        sched.step()
        out.append(flat.detach().clone().numpy())
    return out


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_wrapped_sgd_on_a_small_resnet_matches_jax(both, small_resnet, case):
    sm, images, labels = small_resnet
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    got = _wrapped_steps(tft, case, sm, images, labels, params0, stats0)
    want = _wrapped_steps(jft, case, sm, images, labels, params0, stats0)
    sm.load_buffers(stats0)
    scale = float(np.abs(params0.numpy()).max())
    for step, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=OPT_CASES[case] * scale,
                                   err_msg=f"{case} step {step}")


# -- part 3: the 64-bit inputs that JAX refuses, against numpy's exact answers ----------


@pytest.fixture
def port(monkeypatch):
    bft.init(device="cpu")
    yield
    bft.shutdown()


def _fine_f64(seed, shape=(SIZE, 5)):
    """float64 values that float32 cannot hold (a 2**-40 grain) and whose
    sums and halves are exact."""
    rng = np.random.RandomState(seed)
    return rng.randint(-1000, 1000, shape) + rng.randint(0, 1 << 20, shape) * 2.0**-40


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_64bit_floats_answer_exactly(port, dtype):
    x = _fine_f64(14)
    if dtype == "complex128":
        x = x + 1j * _fine_f64(15)
    t = torch.from_numpy(x)
    for average in (True, False):
        got = tft.allreduce(t, average=average).numpy()
        want = x.sum(0) / SIZE if average else x.sum(0)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, np.broadcast_to(want, x.shape))
    np.testing.assert_array_equal(tft.broadcast(t, 6).numpy(), np.broadcast_to(x[6], x.shape))
    np.testing.assert_array_equal(tft.allgather(t).numpy(),
                                  np.broadcast_to(x.reshape(-1), (SIZE, x.size)))
    y = tft.neighbor_allreduce(t, self_weight=0.5,
                               src_weights=[{(r - 1) % SIZE: 0.5} for r in range(SIZE)])
    np.testing.assert_array_equal(y.numpy(), 0.5 * x + 0.5 * np.roll(x, 1, axis=0))
    assert tft.to_numpy(t).dtype == x.dtype


def test_int64_outside_int32_answers_exactly(port):
    rng = np.random.RandomState(16)
    x = rng.randint(-(2**50), 2**50, (SIZE, 5)).astype(np.int64)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tft.allreduce(t, average=False).numpy(),
                                  np.broadcast_to(x.sum(0), x.shape))
    out = tft.allreduce(t).numpy()
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, np.broadcast_to(x.sum(0) / SIZE, x.shape))
    _same(tft.broadcast(t, 1), torch.from_numpy(np.broadcast_to(x[1], x.shape).copy()))
    _same(tft.allgather(t), torch.from_numpy(np.broadcast_to(x.reshape(-1), (SIZE, x.size)).copy()))
    in_sets = bft.get_context().in_neighbor_sets()
    for r, got in enumerate(tft.neighbor_allgather(t)):
        _same(got, torch.from_numpy(x[sorted(in_sets[r])]))
    y = tft.neighbor_allreduce(t, self_weight=0.5,
                               src_weights=[{(r - 1) % SIZE: 0.5} for r in range(SIZE)])
    assert y.dtype == torch.float64
    np.testing.assert_array_equal(y.numpy(), 0.5 * x + 0.5 * np.roll(x, 1, axis=0))
    p = t.clone()
    tft.broadcast_parameters([p], root_rank=4)
    _same(p, torch.from_numpy(np.broadcast_to(x[4], x.shape).copy()))
    assert tft.to_numpy(t).dtype == np.int64


def test_int64_sum_past_int32_answers_exactly(port):
    x = (2**28 + np.arange(SIZE * 3).reshape(SIZE, 3)).astype(np.int64)
    out = tft.allreduce(torch.from_numpy(x), average=False)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(x.sum(0), x.shape))
    assert x.sum(0).max() > 2**31 - 1


def test_int64_average_past_2_24_answers_exactly(port):
    x = (2**24 + np.arange(SIZE * 3).reshape(SIZE, 3)).astype(np.int64)
    out = tft.allreduce(torch.from_numpy(x), average=True)
    assert out.dtype == torch.float64
    want = x.mean(0)
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(want, x.shape))
    assert (np.float32(want) != want).any()  # float32 could not hold it
