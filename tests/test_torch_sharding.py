# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's weight-update sharding (``BLUEFOG_SHARD``, ZeRO-1/2),
mirroring ``tests/test_sharding.py``: the layout math (a copy, equal to
the JAX package's on its grids), the trajectory contract (ZeRO-1 bitwise
the replicated path; ZeRO-1/2 against the JAX package's trajectory on the
8-device CPU mesh, same numpy inputs, and against the numpy Adam replay),
fused == two-program, bf16 master slices, gradient accumulation, the
gossip families falling back bitwise, the refusals, measured == analytic
state bytes, and the ZeRO-2 quantized scatter tiers.

Tolerances: against the replicated path and JAX ``1e-6`` absolute (the
ring's own-first order is not ``torch.sum``'s; XLA contracts Adam's
products into FMAs), the quantized scatter tiers against JAX ``2e-5``
(the int8 dequantize's FMA moves a gradient bit, which Adam's division
amplifies), the numpy Adam replay ``1e-4`` (the reference test's own).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import sharding as jsharding
from bluefog_tpu_torch import logging_util, scaling, sharding
from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.optimizers import tree_leaves

SIZE = 8
D1, D2 = 1537, 700


@pytest.fixture(autouse=True)
def fresh_context(monkeypatch):
    for env in ("BLUEFOG_SHARD", "BLUEFOG_SHARD_MASTER", "BLUEFOG_SHARD_GRADS",
                "BLUEFOG_PLAN_CHUNKS"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bft.init(device="cpu")
    yield
    bft.shutdown()


def _shard_on(monkeypatch, master=False, grads=False):
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    monkeypatch.setenv("BLUEFOG_SHARD_MASTER", "1" if master else "0")
    monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1" if grads else "0")


# -- the layout math, equal to the JAX package's -------------------------------------


@pytest.mark.parametrize("n_live", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("d", [1, 511, 512, 513, 4096, 8191, 10000])
def test_layout_equals_jax(n_live, d):
    live = tuple(range(n_live))
    lay = sharding.build_layout([("float32", d)], live, SIZE)
    jlay = jsharding.build_layout([("float32", d)], live, SIZE)
    assert tuple(lay.groups) == tuple(jlay.groups) and lay.sig() == jlay.sig()
    assert lay.owner_map() == jlay.owner_map()
    np.testing.assert_array_equal(lay.live_index(), jlay.live_index())
    covered = []
    for row in lay.owner_map():
        covered.extend(range(row["start"], row["stop"]))
    assert covered == list(range(d))
    for elem in (0, d // 2, d - 1):
        assert lay.owner_of(0, elem) == jlay.owner_of(0, elem)


@pytest.mark.parametrize("live", [(0, 1), (0, 2, 4, 6), (1, 3, 5, 7), tuple(range(7))])
def test_layout_live_subsets_and_roundtrip(live):
    groups = [("bfloat16", 1000), ("float32", 1000), ("float32", 7000)]
    lay = sharding.build_layout(groups, live, SIZE, grads=True)
    jlay = jsharding.build_layout(groups, live, SIZE, grads=True)
    assert lay.groups == jlay.groups and lay.sig() == jlay.sig()
    assert len({g.slot for g in lay.groups}) == len(lay.groups)
    full = np.random.RandomState(0).randn(7000).astype(np.float32)
    rows = sharding.slice_rows(full, lay, 2)
    np.testing.assert_array_equal(rows, jsharding.slice_rows(full, jlay, 2))
    np.testing.assert_array_equal(sharding.gather_rows(rows, lay, 2), full)


def test_accounting_helpers_equal_jax():
    for master in (False, True):
        lay = sharding.build_layout([("float32", 262145), ("bfloat16", 3000)], range(SIZE),
                                    SIZE, master=master, grads=True)
        jlay = jsharding.build_layout([("float32", 262145), ("bfloat16", 3000)], range(SIZE),
                                      SIZE, master=master, grads=True)
        for fn in ("gather_wire_bytes", "scatter_wire_bytes", "allreduce_wire_bytes"):
            assert getattr(sharding, fn)(lay) == getattr(jsharding, fn)(jlay), fn
        for sharded in (True, False):
            assert sharding.state_bytes(lay, 2, sharded) == jsharding.state_bytes(jlay, 2, sharded)
            assert sharding.grad_bytes(lay, sharded) == jsharding.grad_bytes(jlay, sharded)
        sharding.register_active(lay, measured_state_bytes=123)
        jsharding.register_active(jlay, measured_state_bytes=123)
        assert sharding.summary() == jsharding.summary()
    sharding.clear_active()
    jsharding.clear_active()
    assert sharding.summary() is None
    with pytest.raises(ValueError, match="duplicate live ranks"):
        sharding.build_layout([("float32", 1000)], (0, 0, 1), SIZE)


# -- the trajectory contract -----------------------------------------------------------


def _targets():
    rng = np.random.RandomState(0)
    return rng.randn(SIZE, D1).astype(np.float32), rng.randn(SIZE, D2).astype(np.float32)


def _np_adam_oracle(c_mean, steps, lr=0.05, b1=0.9, b2=0.999, eps=1e-8):
    x, m, v = (np.zeros_like(c_mean) for _ in range(3))
    for t in range(1, steps + 1):
        g = x - c_mean
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x = x - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
    return x


def _run_port(steps=6, lr=0.05, compression=None):
    c1, c2 = (torch.from_numpy(c) for c in _targets())
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(lr))
    opt.compression = compression
    params = {"a": torch.zeros(SIZE, D1), "b": torch.zeros(SIZE, D2)}
    state = opt.init(params)
    for _ in range(steps):
        opt.step(params, state, {"a": params["a"] - c1, "b": params["b"] - c2})
    return opt, params, state


def _run_jax(monkeypatch, steps=6, lr=0.05, compression=None, shard=True, grads=False):
    """The JAX package's gradient-allreduce Adam on the same inputs."""
    monkeypatch.setenv("BLUEFOG_SHARD", "1" if shard else "0")
    monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1" if grads else "0")
    c1, c2 = _targets()
    bf.init(devices=jax.devices("cpu")[:SIZE])
    try:
        opt = bf.DistributedGradientAllreduceOptimizer(optax.adam(lr))
        opt.compression = compression
        params = {"a": bf.worker_values(lambda r: np.zeros(D1, np.float32)),
                  "b": bf.worker_values(lambda r: np.zeros(D2, np.float32))}
        state = opt.init(params)
        for _ in range(steps):
            params, state = opt.step(params, state, {"a": params["a"] - jnp.asarray(c1),
                                                     "b": params["b"] - jnp.asarray(c2)})
        return {k: np.asarray(v) for k, v in params.items()}
    finally:
        bf.shutdown()


def test_zero1_bitwise_replicated_and_matches_jax_and_oracle(monkeypatch):
    _, p_rep, _ = _run_port()
    _shard_on(monkeypatch)
    opt, p_sh, state = _run_port()
    assert isinstance(state, sharding.ShardedOptState)
    lay = opt._shard_layout
    assert len(lay.groups) == 1 and lay.groups[0].elems == D1 + D2 and not lay.grads
    for leaf in tree_leaves(state):
        assert leaf.shape[0] == SIZE and leaf.numel() <= SIZE * lay.groups[0].slot
    for key in ("a", "b"):
        assert torch.equal(p_sh[key], p_rep[key])
        assert torch.equal(p_sh[key], p_sh[key][:1].expand_as(p_sh[key]))
    jp = _run_jax(monkeypatch)
    for key in ("a", "b"):
        np.testing.assert_allclose(p_sh[key].numpy(), jp[key], rtol=0, atol=1e-6)
    oracle = _np_adam_oracle(_targets()[0].mean(0), 6)
    np.testing.assert_allclose(p_sh["a"][0].numpy(), oracle, rtol=0, atol=1e-4)


def test_zero2_matches_replicated_jax_and_oracle(monkeypatch):
    _, p_rep, _ = _run_port()
    _shard_on(monkeypatch, grads=True)
    opt, p_z2, state = _run_port()
    assert isinstance(state, sharding.ShardedOptState) and opt._shard_layout.grads
    assert opt._scatter_ef is None
    for key in ("a", "b"):
        assert torch.equal(p_z2[key], p_z2[key][:1].expand_as(p_z2[key]))
        # one chunk: the scatter's one sum is the allreduce's, so bitwise
        assert torch.equal(p_z2[key], p_rep[key])
    jp = _run_jax(monkeypatch, grads=True)
    for key in ("a", "b"):
        np.testing.assert_allclose(p_z2[key].numpy(), jp[key], rtol=0, atol=1e-6)
    oracle = _np_adam_oracle(_targets()[0].mean(0), 6)
    np.testing.assert_allclose(p_z2["a"][0].numpy(), oracle, rtol=0, atol=1e-4)


@pytest.mark.parametrize("wire", ["bf16", "int8", "int4", "int8_ef", "int4_ef"])
def test_zero2_quantized_scatter_tiers(monkeypatch, wire):
    """Each scatter tier within the reference's envelope of the replicated
    trajectory (0.05 for int8/int8_ef, the reference test's; the int4
    tiers 0.2, the reference's int4 envelope of one reduce-scatter), and
    equal to the JAX package's ZeRO-2 on the same wire."""
    _, p_rep, _ = _run_port()
    _shard_on(monkeypatch, grads=True)
    opt, p, _state = _run_port(compression=wire)
    env = 0.2 if wire.startswith("int4") else 0.05
    dev = max(float((p[k] - p_rep[k]).abs().max()) for k in ("a", "b"))
    assert dev < env, dev
    if wire.endswith("_ef"):
        assert opt._scatter_ef and sum(float(e.abs().sum()) for e in opt._scatter_ef) > 0
    jp = _run_jax(monkeypatch, compression=wire, grads=True)
    for key in ("a", "b"):
        np.testing.assert_allclose(p[key].numpy(), jp[key], rtol=0, atol=2e-5)


@pytest.mark.parametrize("grads", [False, True])
def test_fused_sharded_matches_two_program(monkeypatch, grads):
    _shard_on(monkeypatch, grads=grads)
    ct = torch.from_numpy(_targets()[0])

    def loss_fn(params, c):
        return 0.5 * torch.sum((params["a"] - c) ** 2)

    def make():
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
        params = {"a": torch.zeros(SIZE, D1)}
        return opt, params, opt.init(params)

    opt, params, state = make()
    for _ in range(4):
        opt.step(params, state, {"a": params["a"] - ct})
    opt2, p2, s2 = make()
    train = opt2.make_train_step(loss_fn)
    for _ in range(4):
        p2, s2, _loss = train(p2, s2, ct)
    assert torch.equal(p2["a"], params["a"])


def test_master_params_bf16(monkeypatch):
    _shard_on(monkeypatch, master=True)
    c1 = torch.from_numpy(_targets()[0])
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    params = {"a": torch.zeros(SIZE, D1, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert isinstance(state, sharding.ShardedOptState) and len(state.master) == 1
    assert state.master[0].dtype == torch.float32
    for _ in range(6):
        opt.step(params, state, {"a": params["a"] - c1.to(torch.bfloat16)})
    w = params["a"].float()
    assert torch.isfinite(w).all() and torch.equal(w, w[:1].expand_as(w))
    oracle = _np_adam_oracle(_targets()[0].mean(0), 6)
    assert np.abs(w[0].numpy() - oracle).max() < 0.1


def test_grad_accumulation_composes_with_shard(monkeypatch):
    c1, c2 = (torch.from_numpy(c) for c in _targets())

    def run():
        opt = bft.DistributedGradientAllreduceOptimizer(bft.sgd(0.1),
                                                         num_steps_per_communication=2)
        params = {"a": torch.zeros(SIZE, D1), "b": torch.zeros(SIZE, D2)}
        state = opt.init(params)
        for _ in range(4):
            opt.step(params, state, {"a": params["a"] - c1, "b": params["b"] - c2})
        return params["a"].clone()

    w_rep = run()
    _shard_on(monkeypatch)
    assert torch.equal(run(), w_rep)
    _shard_on(monkeypatch, grads=True)
    torch.testing.assert_close(run(), w_rep, rtol=0, atol=1e-6)


@pytest.mark.parametrize("compression", [None, "int8_ef"])
def test_gossip_family_falls_back_bitwise(monkeypatch, compression):
    c1 = torch.from_numpy(_targets()[0])

    def run():
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
        opt.compression = compression
        params = {"w": c1.clone()}
        state = opt.init(params)
        for _ in range(4):
            opt.step(params, state, {"w": params["w"] - c1})
        assert opt._shard_layout is None
        return params["w"]

    a = run()
    _shard_on(monkeypatch, grads=True)
    logging_util._warned_once.discard("shard-family:cta:neighbor.allreduce")
    with pytest.warns(UserWarning, match="BLUEFOG_SHARD=1 ignored"):
        b = run()
    assert torch.equal(a, b)


def test_shard_off_is_replicated():
    opt, _params, state = _run_port(steps=3)
    assert not isinstance(state, sharding.ShardedOptState) and opt._shard_layout is None


def test_sharded_state_refused_without_flag(monkeypatch):
    c1, c2 = (torch.from_numpy(c) for c in _targets())
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    params = {"a": torch.zeros(SIZE, D1), "b": torch.zeros(SIZE, D2)}
    replicated = opt.init(params)
    _shard_on(monkeypatch)
    with pytest.raises(ValueError, match="not sharded"):
        opt.step(params, replicated, {"a": params["a"] - c1, "b": params["b"] - c2})


def test_state_bytes_measured_equals_analytic(monkeypatch):
    _shard_on(monkeypatch)
    opt, params, state = _run_port(steps=1)
    measured = scaling.optimizer_state_bytes(state=state, world=SIZE)
    assert measured == scaling.optimizer_state_bytes(params, opt, shard=True)
    monkeypatch.setenv("BLUEFOG_SHARD", "0")
    opt2 = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    state2 = opt2.init(params)
    measured2 = scaling.optimizer_state_bytes(state=state2, world=SIZE)
    assert measured2 == scaling.optimizer_state_bytes(params, opt2, shard=False)
    lay = opt._shard_layout
    assert measured <= measured2 * (lay.groups[0].slot / lay.groups[0].elems) + 4096
    assert sharding.summary()["state_bytes_measured"] == measured


class GlobalNormClip:
    """A coupled inner transform: clip each worker's gradient to a global
    norm of ``max_norm``, then the inner optimizer (optax's
    ``clip_by_global_norm`` chained before it)."""

    def __init__(self, inner, max_norm=1.0):
        self.inner, self.max_norm = inner, max_norm

    def init(self, params):
        return self.inner.init(params)

    def apply_(self, params, state, grads):
        leaves = tree_leaves(grads)
        sq = sum((g.float() ** 2).reshape(g.shape[0], -1).sum(1) for g in leaves)
        scale = torch.clamp(self.max_norm / torch.sqrt(sq), max=1.0)
        from bluefog_tpu_torch.optimizers import _tree_unflatten

        clipped = [g * scale.view((-1,) + (1,) * (g.dim() - 1)).to(g.dtype) for g in leaves]
        self.inner.apply_(params, state, _tree_unflatten(grads, clipped))


class ElementClip(GlobalNormClip):
    def apply_(self, params, state, grads):
        from bluefog_tpu_torch.optimizers import _tree_unflatten

        self.inner.apply_(params, state, _tree_unflatten(
            grads, [g.clamp(-1.0, 1.0) for g in tree_leaves(grads)]))


def test_coupled_inner_transform_refused(monkeypatch):
    _shard_on(monkeypatch)
    params = {"a": torch.zeros(SIZE, D1)}
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        bft.DistributedGradientAllreduceOptimizer(GlobalNormClip(bft.adam(0.05))).init(params)
    opt = bft.DistributedGradientAllreduceOptimizer(ElementClip(bft.adam(0.05)))
    state = opt.init(params)
    opt.tx = GlobalNormClip(bft.sgd(0.1))
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        opt.step(params, state, {"a": params["a"] - torch.from_numpy(_targets()[0])})


def test_master_flip_midrun_refused(monkeypatch):
    _shard_on(monkeypatch)
    c1 = torch.from_numpy(_targets()[0])
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    params = {"a": torch.zeros(SIZE, D1)}
    state = opt.init(params)
    opt.step(params, state, {"a": params["a"] - c1})
    monkeypatch.setenv("BLUEFOG_SHARD_MASTER", "1")
    with pytest.raises(ValueError, match="SHARD_MASTER"):
        opt.step(params, state, {"a": params["a"] - c1})


def test_shard_grads_flip_keeps_the_layout(monkeypatch):
    """Flipping ``BLUEFOG_SHARD_GRADS`` between steps swaps the gradient
    leg only: the slots and the state carry on."""
    _shard_on(monkeypatch)
    c1 = torch.from_numpy(_targets()[0])
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    params = {"a": torch.zeros(SIZE, D1)}
    state = opt.init(params)
    opt.step(params, state, {"a": params["a"] - c1})
    lay = opt._shard_layout
    monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1")
    opt.step(params, state, {"a": params["a"] - c1})
    assert opt._shard_layout.grads and opt._shard_layout.groups == lay.groups
    assert opt._shard_layout.sig() == lay.sig() + ("grads",)


def test_scatter_chunks_follow_the_jax_chooser(monkeypatch):
    _shard_on(monkeypatch, grads=True)
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    lay = sharding.build_layout([("float32", 188_872_704)], range(SIZE), SIZE, grads=True)
    jlay = jsharding.build_layout([("float32", 188_872_704)], range(SIZE), SIZE, grads=True)
    bf.init(devices=jax.devices("cpu")[:SIZE])
    try:
        jopt = bf.DistributedGradientAllreduceOptimizer(optax.adam(0.05))
        for wire in (None, "int8", "int4_ef"):
            opt.compression = jopt.compression = wire
            # the stacked transport: one chunk; priced on the ICI link, JAX's
            assert opt._scatter_chunks(bft.get_context(), lay) == (1,)
            monkeypatch.setattr(compiler, "TRANSPORT_LINK_CLASS", "ici")
            assert opt._scatter_chunks(bft.get_context(), lay) == \
                jopt._scatter_chunks(bf.get_context(), jlay)
            monkeypatch.setattr(compiler, "TRANSPORT_LINK_CLASS", "stacked")
    finally:
        bf.shutdown()
