# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's asynchronous push-sum gossip (``bft.make_async_train_step``)
against the numpy oracle of ``tests/test_async.py`` (``async_oracle``) and
against the JAX package's engine on the 8-device CPU mesh, same numpy
inputs.

Tolerances:

- against the oracle: ``rtol 1e-4, atol 1e-5``, the oracle tests' own;
- against JAX, tick by tick on every wire (fp32, bf16, int8, int4 and the
  ``_ef`` aliases): the window lanes and the estimate within 1e-6 of the
  largest value, after which the port's lanes are set to JAX's so that a
  last-bit difference cannot move a later quantization; XLA:CPU contracts
  ``v * s + w * (x - x_hat)``, the fold and the momentum update into FMAs,
  which the port rounds as separate operations. The versions, the host age
  lane, the engine's counters and its advisories are exact. Every rank's
  loss within 1e-6 of the largest loss (XLA's reduction order); a rank that
  sits a tick out reports its loss at the current estimate on both sides.

The JAX side runs its composite wire (``BLUEFOG_WIRE_KERNELS=0``); its
quantizer is pinned bitwise to its Pallas kernels by its own tests. The
elastic ``slow`` fault of the JAX tests is the cadence ``{rank: factor}``
on both sides here (the engine multiplies the two).
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
from bluefog_tpu import windows as jwin_mod
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import async_gossip, interop, topology as ttu
from bluefog_tpu_torch.models import ResNet50, StackedModel, resnet

from test_async import async_oracle

SIZE = 8
DIM = 3


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    for env in ("BLUEFOG_ASYNC", "BLUEFOG_ASYNC_WIRE", "BLUEFOG_ASYNC_MAX_AGE",
                "BLUEFOG_ASYNC_STALE_POLICY"):
        monkeypatch.delenv(env, raising=False)
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    bf.set_topology(tu.RingGraph(SIZE, connect_style=1))
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    yield
    bf.win_free()
    bf.shutdown()
    bft.shutdown()


def jquad(p, target):
    return 0.5 * jnp.sum((p["w"] - target) ** 2)


def tquad(p, target):
    return 0.5 * torch.sum((p["w"] - target) ** 2)


def jmean(p, target):
    return 0.5 * jnp.mean((p["w"] - target) ** 2)


def tmean(p, target):
    return 0.5 * torch.mean((p["w"] - target) ** 2)


def sender_matrix() -> np.ndarray:
    outs = bft.out_neighbor_ranks()
    w = np.zeros((SIZE, SIZE))
    for i in range(SIZE):
        w[i, i] = 1.0 / (len(outs[i]) + 1)
        w[i, outs[i]] = 1.0 / (len(outs[i]) + 1)
    return w


def pair(lr=0.2, momentum=None, z0=None, jloss=jquad, tloss=tquad, **kwargs):
    """The JAX and the port's step on the same problem:
    ``(jstep, jp, js, tstep, tp, ts)``."""
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(lr, momentum=momentum))
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(lr, momentum=momentum))
    jp, tp = {"w": jnp.asarray(z0)}, {"w": torch.from_numpy(z0.copy())}
    return (bf.make_async_train_step(jopt, jloss, **kwargs), jp, jopt.init(jp),
            bft.make_async_train_step(topt, tloss, **kwargs), tp, topt.init(tp))


def windows(jstep, tstep):
    return (jwin_mod._get_win(bf.get_context(), jstep.engine._name),
            bft.get_context().windows[tstep.engine._name])


def assert_ticks_match(jstep, tstep, jp, tp, jl, tl, due, scale, what):
    """One tick's state on both sides, every rank's loss (``due`` or not),
    then the port's lanes set to JAX's."""
    jwin, twin = windows(jstep, tstep)
    want = interop.window_lanes_from_jax(jwin)
    got = interop.window_lanes_to_jax(twin)
    for lane in interop.WINDOW_LANES:
        if lane == "versions":
            np.testing.assert_array_equal(got[lane], want[lane].numpy(), err_msg=what)
        else:
            np.testing.assert_allclose(got[lane], want[lane].numpy(), rtol=0,
                                       atol=1e-6 * scale, err_msg=f"{what}: {lane}")
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=0,
                               atol=1e-6 * scale, err_msg=f"{what}: estimate")
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-6 * max(np.abs(jl).max(), 1e-30), err_msg=f"{what}: loss")
    assert due.any(), what
    assert twin.clock == jwin.clock, what
    np.testing.assert_array_equal(twin.slot_written, jwin.slot_written, err_msg=what)
    np.testing.assert_array_equal(twin.mass_birth, jwin.mass_birth, err_msg=what)
    for lane, t in want.items():
        setattr(twin, lane, t)


# -- the numpy oracle -------------------------------------------------------------------


def test_uniform_cadence_matches_oracle_and_jax():
    z0 = np.random.RandomState(0).randn(SIZE, DIM).astype(np.float32)
    jstep, jp, js, tstep, tp, ts = pair(lr=0.2, z0=z0)
    oracle = async_oracle(z0, z0, 0.2, 10, sender_matrix(), [1] * SIZE)
    for t in range(10):
        jp, js, jl = jstep(jp, js, jnp.asarray(z0))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(z0))
        np.testing.assert_allclose(tp["w"].numpy(), oracle[t], rtol=1e-4, atol=1e-5,
                                   err_msg=f"diverged from the async oracle at tick {t}")
        assert_ticks_match(jstep, tstep, jp, tp, jl, tl, np.ones(SIZE, bool), 4.0, f"tick {t}")


def test_decoupled_cadences_match_oracle_and_jax():
    rng = np.random.RandomState(3)
    periods = [int(p) for p in rng.randint(1, 5, SIZE)]
    cadence = {r: p for r, p in enumerate(periods) if p > 1}
    z0 = np.random.RandomState(1).randn(SIZE, DIM).astype(np.float32)
    jstep, jp, js, tstep, tp, ts = pair(lr=0.1, z0=z0, cadence=cadence)
    oracle = async_oracle(z0, z0, 0.1, 16, sender_matrix(), periods)
    for t in range(16):
        jp, js, jl = jstep(jp, js, jnp.asarray(z0))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(z0))
        np.testing.assert_allclose(tp["w"].numpy(), oracle[t], rtol=1e-4, atol=1e-5,
                                   err_msg=f"diverged at tick {t} (periods {periods})")
        due = np.array([t % p == 0 for p in periods])
        assert_ticks_match(jstep, tstep, jp, tp, jl, tl, due, 4.0, f"tick {t}")
    assert tstep.engine.summary() == jstep.engine.summary()


def jmlp(p, x, y):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def tmlp(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def test_sat_out_loss_matches_jax_on_mlp():
    """A two-layer MLP under a straggler cadence: every rank's loss, the
    sat-out ranks' at their current estimate, equals JAX's each tick."""
    rng = np.random.RandomState(5)
    shapes = {"w1": (6, 16), "b1": (16,), "w2": (16, 3), "b2": (3,)}
    z0 = {k: (rng.randn(SIZE, *v) * 0.5).astype(np.float32) for k, v in shapes.items()}
    x = rng.randn(SIZE, 10, 6).astype(np.float32)
    y = rng.randn(SIZE, 10, 3).astype(np.float32)
    cadence = {2: 3, 6: 4}
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1, momentum=0.9))
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    jp = {k: jnp.asarray(v) for k, v in z0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in z0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = bf.make_async_train_step(jopt, jmlp, cadence=cadence)
    tstep = bft.make_async_train_step(topt, tmlp, cadence=cadence)
    for t in range(6):
        jp, js, jl = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(x), torch.from_numpy(y))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-6 * np.abs(jl).max(),
                                   err_msg=f"tick {t}")
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5,
                                       err_msg=f"tick {t}: {k}")


def test_async_consensus_reaches_exact_mean():
    z0 = np.random.RandomState(0).randn(SIZE, DIM).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    params = {"w": torch.from_numpy(z0.copy())}
    state = opt.init(params)
    step = bft.make_async_train_step(opt, tquad, cadence={0: 3, 5: 2})
    for _ in range(250):
        params, state, _ = step(params, state, torch.from_numpy(z0))
    np.testing.assert_allclose(params["w"].numpy(), np.tile(z0.mean(0), (SIZE, 1)), atol=1e-3)


# -- every wire, against JAX ---------------------------------------------------------------

WIRES = [None, "bf16", "int8", "int4", "int8_ef", "int4_ef"]


@pytest.mark.parametrize("topo", ["ring", "exp2"])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "fp32")
def test_wires_match_jax_tick_by_tick(wire, topo):
    """Random cadences, sgd with momentum, a gate that drops (``max_age``
    3), 700 elements (not whole 512-element blocks): every tick on both
    sides. Exp2(8) has three slots per rank (the fold's sum over slots in
    plan order, JAX's ``tensordot``: within the tolerance)."""
    if topo == "exp2":
        bf.set_topology(tu.ExponentialTwoGraph(SIZE))
        bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    rng = np.random.RandomState(7)
    z0 = (rng.randn(SIZE, 700) * 2).astype(np.float32)
    c = z0 + rng.randn(SIZE, 700).astype(np.float32)
    periods = {r: int(p) for r, p in enumerate(rng.randint(1, 5, SIZE))}
    jstep, jp, js, tstep, tp, ts = pair(lr=0.1, momentum=0.9, z0=z0, jloss=jmean, tloss=tmean,
                                        cadence=periods, wire=wire, max_age=3)
    assert tstep.engine.wire == jstep.engine.wire
    scale = float(np.abs(z0).max()) * 4
    for t in range(10):
        jp, js, jl = jstep(jp, js, jnp.asarray(c))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(c))
        due = np.array([t % periods[r] == 0 for r in range(SIZE)])
        assert_ticks_match(jstep, tstep, jp, tp, jl, tl, due, scale, f"{wire} tick {t}")
    assert tstep.engine.summary() == jstep.engine.summary()
    assert [a.to_json() for a in tstep.engine.advisories] == \
        [a.to_json() for a in jstep.engine.advisories]


# -- async off, the switches, the knobs ----------------------------------------------------


def test_async_off_is_bitwise_synchronous_path():
    z0 = np.random.RandomState(2).randn(SIZE, DIM).astype(np.float32)
    batch = torch.from_numpy(z0)
    opt_a = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    pa = {"w": batch.clone()}
    sa = opt_a.init(pa)
    off = bft.make_async_train_step(opt_a, tquad, enabled=False)
    assert not hasattr(off, "engine")
    opt_b = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
    pb = {"w": batch.clone()}
    sb = opt_b.init(pb)
    ref = opt_b.make_train_step(tquad)
    for _ in range(6):
        pa, sa, la = off(pa, sa, batch)
        pb, sb, lb = ref(pb, sb, batch)
    assert torch.equal(pa["w"], pb["w"]) and torch.equal(la, lb)


def test_env_kill_switch(monkeypatch):
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    monkeypatch.setenv("BLUEFOG_ASYNC", "0")
    assert not hasattr(bft.make_async_train_step(opt, tquad), "engine")
    monkeypatch.setenv("BLUEFOG_ASYNC", "1")
    assert hasattr(bft.make_async_train_step(opt, tquad), "engine")


def test_optimizer_method_facade():
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    step = opt.make_async_train_step(tquad, cadence={1: 2})
    assert step.engine.cadence == {1: 2}
    assert bft.async_gossip.active() is step.engine


@pytest.mark.parametrize("kwargs", [
    dict(cadence={0: 0}), dict(policy="panic"), dict(max_age=0), dict(wire="int2"),
], ids=["cadence", "policy", "max_age", "wire"])
def test_bad_knobs_raise_jax_errors(kwargs):
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1))
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    with pytest.raises(ValueError) as jerr:
        bf.make_async_train_step(jopt, jquad, **kwargs)
    with pytest.raises(ValueError) as terr:
        bft.make_async_train_step(topt, tquad, **kwargs)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("env,value", [
    ("BLUEFOG_ASYNC_STALE_POLICY", "panic"), ("BLUEFOG_ASYNC_WIRE", "fp8"),
])
def test_bad_env_knobs_raise_jax_errors(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1))
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    with pytest.raises(ValueError) as jerr:
        bf.make_async_train_step(jopt, jquad)
    with pytest.raises(ValueError) as terr:
        bft.make_async_train_step(topt, tquad)
    assert str(terr.value) == str(jerr.value)


def test_env_knob_defaults(monkeypatch):
    assert async_gossip.async_max_age() == 8
    assert async_gossip.async_stale_policy() == "drop"
    monkeypatch.setenv("BLUEFOG_ASYNC_MAX_AGE", "3")
    monkeypatch.setenv("BLUEFOG_ASYNC_STALE_POLICY", "throttle")
    step = bft.make_async_train_step(bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1)),
                                     tquad)
    assert (step.engine.max_age, step.engine.policy) == (3, "throttle")
    monkeypatch.setenv("BLUEFOG_ASYNC_MAX_AGE", "0")
    assert async_gossip.async_max_age() == 1
    monkeypatch.setenv("BLUEFOG_ASYNC_MAX_AGE", "eight")
    with pytest.warns(UserWarning, match="BLUEFOG_ASYNC_MAX_AGE"):
        assert async_gossip.async_max_age() == 8


@pytest.mark.parametrize("requested,want", [
    ("fp32", None), ("f32", None), ("", None), ("int8_ef", "int8"), ("int4_ef", "int4"),
    ("bf16", "bf16"), ("int8", "int8"), ("INT4", "int4"),
])
def test_wire_resolution(requested, want):
    from bluefog_tpu import async_gossip as jasync

    assert async_gossip.async_wire(requested) == want == jasync.async_wire(requested)


@pytest.mark.parametrize("compression", [None, "bf16", "int8", "int4", "int8_ef", "int4_ef"])
def test_wire_defaults_to_optimizer_compression(compression, monkeypatch):
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1))
    topt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    jopt.compression = topt.compression = compression
    jeng = bf.make_async_train_step(jopt, jquad).engine
    teng = bft.make_async_train_step(topt, tquad).engine
    assert (teng.wire, teng.wire_name) == (jeng.wire, jeng.wire_name)
    # the env wins over the optimizer, the argument over both
    monkeypatch.setenv("BLUEFOG_ASYNC_WIRE", "int8")
    assert bft.make_async_train_step(topt, tquad).engine.wire == "int8"
    assert bft.make_async_train_step(topt, tquad, wire="bf16").engine.wire == "bf16"


# -- the staleness gate ----------------------------------------------------------------------


def test_drop_gate_files_advisory_naming_slow_rank():
    """Rank 2 at one tenth of the cadence: its out-edge passes the bound,
    the fold drops it (the mass stays pending) and the advisory names rank
    2, as JAX's engine files it."""
    z0 = np.random.RandomState(4).randn(SIZE, DIM).astype(np.float32)
    jstep, jp, js, tstep, tp, ts = pair(lr=0.0, z0=z0, cadence={2: 10}, max_age=4,
                                        policy="drop")
    for _ in range(12):
        jp, js, _ = jstep(jp, js, jnp.asarray(z0))
        tp, ts, _ = tstep(tp, ts, torch.from_numpy(z0))
    eng = tstep.engine
    assert eng._stale_drops > 0
    assert eng.advisories, "gate never filed an advisory"
    adv = eng.advisories[0]
    assert adv.kind == "async_staleness"
    assert 2 in adv.detail["slow_ranks"]
    assert adv.detail["surface"] == "async"
    assert adv.detail["action"] == "dropped_from_fold"
    assert all(s == 2 for s, _d in map(tuple, adv.detail["edges"]))
    assert [a.to_json() for a in eng.advisories] == \
        [a.to_json() for a in jstep.engine.advisories]
    assert eng.summary() == jstep.engine.summary()
    win = bft.get_context().windows[eng._name]
    total = float(torch.sum(win.value, dtype=torch.float64)
                  + torch.sum(win.buffers, dtype=torch.float64))
    assert abs(total - float(np.sum(z0, dtype=np.float64))) < 1e-4


def test_throttle_gate_skips_receivers():
    z0 = np.random.RandomState(5).randn(SIZE, DIM).astype(np.float32)
    jstep, jp, js, tstep, tp, ts = pair(lr=0.0, z0=z0, cadence={3: 8}, max_age=3,
                                        policy="throttle")
    for _ in range(14):
        jp, js, _ = jstep(jp, js, jnp.asarray(z0))
        tp, ts, _ = tstep(tp, ts, torch.from_numpy(z0))
    eng = tstep.engine
    assert eng._throttled > 0 and eng._stale_drops == 0
    assert eng.advisories and eng.advisories[0].detail["action"] == "throttled_receivers"
    assert eng.summary() == jstep.engine.summary()
    assert [a.to_json() for a in eng.advisories] == \
        [a.to_json() for a in jstep.engine.advisories]
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=0, atol=1e-5)


def test_lowering_is_cached_across_participation_patterns():
    """The masks and weights are operands: walking many participation
    patterns builds one lowering."""
    z0 = np.random.RandomState(0).randn(SIZE, DIM).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    params = {"w": torch.from_numpy(z0.copy())}
    state = opt.init(params)
    step = bft.make_async_train_step(opt, tquad, cadence={0: 2, 3: 3})
    cache = bft.get_context().op_cache
    params, state, _ = step(params, state, torch.from_numpy(z0))
    lowerings = sorted(k for k in cache if k[0] == "win_lowering")
    for _ in range(7):
        params, state, _ = step(params, state, torch.from_numpy(z0))
    assert sorted(k for k in cache if k[0] == "win_lowering") == lowerings
    assert len(lowerings) == 1


def test_active_engine_registry_and_shutdown():
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    step = bft.make_async_train_step(opt, tquad)
    assert async_gossip.active() is step.engine
    bft.shutdown()
    assert async_gossip.active() is None
    bft.init(device="cpu")
    step = bft.make_async_train_step(opt, tquad)
    bft.init(device="cpu")
    assert async_gossip.active() is None


def test_autotune_decision_records_carry_async_mode():
    """JAX's test of the same name: a live engine flags the controller's
    decision records, on the port as on JAX."""
    from bluefog_tpu.autotune import _async_mode as j_async_mode
    from bluefog_tpu_torch.autotune import _async_mode

    assert _async_mode() is False and j_async_mode() is False
    z0 = np.random.RandomState(0).randn(SIZE, DIM).astype(np.float32)
    pair(lr=0.0, z0=z0)
    assert _async_mode() is True and j_async_mode() is True


def test_rewindow_keeps_the_estimate():
    """A topology whose in-edges the window's slots cannot carry re-creates
    the window from the estimate ``x / p`` with ``p = 1``."""
    z0 = np.random.RandomState(8).randn(SIZE, DIM).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    params = {"w": torch.from_numpy(z0.copy())}
    state = opt.init(params)
    step = bft.make_async_train_step(opt, tquad, cadence={1: 2})
    for _ in range(3):
        params, state, _ = step(params, state, torch.from_numpy(z0))
    eng = step.engine
    est = eng.params()["w"].clone()
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    eng._ensure_window(bft.get_context(), params)
    win = bft.get_context().windows[eng._name]
    assert eng._rewindows == 1
    assert torch.equal(win.p, torch.ones(SIZE))
    assert torch.equal(win.value, est)
    params, state, _ = step(params, state, torch.from_numpy(z0))
    assert torch.isfinite(params["w"]).all()


def test_has_aux_and_tree_params():
    """``has_aux`` returns ``(loss, aux)`` stacked per worker; a tree of
    leaves of two dtypes packs into one f32 window and comes back in its
    leaves' dtypes."""
    rng = np.random.RandomState(12)
    w, b = rng.randn(SIZE, 5).astype(np.float32), rng.randn(SIZE, 2).astype(np.float32)

    def loss_fn(p, target):
        err = p["a"]["w"] - target
        loss = 0.5 * torch.sum(err ** 2) + torch.sum(p["b"].float() ** 2)
        return loss, {"err": err.abs().max()}

    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.5))
    params = {"a": {"w": torch.from_numpy(w)}, "b": torch.from_numpy(b).to(torch.bfloat16)}
    state = opt.init(params)
    step = bft.make_async_train_step(opt, loss_fn, has_aux=True, cadence={4: 2})
    for _ in range(3):
        params, state, (loss, aux) = step(params, state, torch.from_numpy(w * 0.5))
    assert params["b"].dtype == torch.bfloat16 and params["a"]["w"].dtype == torch.float32
    assert loss.shape == (SIZE,) and aux["err"].shape == (SIZE,)
    assert bft.get_context().windows[step.engine._name].value.dtype == torch.float32


# -- a model with batch statistics ------------------------------------------------------------


def test_sat_out_worker_passes_through_bitwise():
    """A tiny ResNet in a ``StackedModel`` under ``cadence={1: 3}``: on a
    tick where worker 1 is not due its window row, p, momentum row and
    BatchNorm statistics come through bit for bit, while a due worker's
    change."""
    model = resnet.init_flax_like(ResNet50(num_classes=10, stage_sizes=[1, 1, 1, 1],
                                           num_filters=8), 0)
    sm = StackedModel(model, SIZE, "cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    params = sm.replicate()
    state = opt.init(params)
    step = bft.make_async_train_step(opt, sm.worker_loss, cadence={1: 3}, buffers=sm.buffers)
    batch = (images, labels, torch.arange(SIZE))
    params, state, loss0 = step(params, state, *batch)  # tick 0: everyone is due
    win = bft.get_context().windows[step.engine._name]
    before = {"value": win.value.clone(), "p": win.p.clone(), "trace": state.clone(),
              "est": params.clone(),
              "bn": {k: v.clone() for k, v in sm.buffers.items()}}
    params, state, loss1 = step(params, state, *batch)  # tick 1: worker 1 sits out
    win = bft.get_context().windows[step.engine._name]
    assert torch.equal(win.value[1], before["value"][1])
    assert torch.equal(win.p[1], before["p"][1])
    assert torch.equal(state[1], before["trace"][1])
    assert torch.equal(params[1], before["est"][1])
    for name, buf in sm.buffers.items():
        assert torch.equal(buf[1], before["bn"][name][1]), name
    # its loss is the one at its estimate on this tick's batch (statistics
    # restored after that forward too)
    stats = {k: v.clone() for k, v in sm.buffers.items()}
    with torch.no_grad():
        want = sm.worker_loss(before["est"][1], images[1], labels[1], 1)
    sm.load_buffers(stats)
    assert loss1[1] == want
    assert not torch.equal(state[0], before["trace"][0])
    assert any(not torch.equal(buf[0], before["bn"][name][0]) for name, buf in sm.buffers.items())
    assert torch.isfinite(loss1).all()


def _tiny_resnet():
    model = resnet.init_flax_like(ResNet50(num_classes=10, stage_sizes=[1, 1, 1, 1],
                                           num_filters=8), 0)
    sm = StackedModel(model, SIZE, "cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    return sm, (images, labels, torch.arange(SIZE))


def test_sat_out_buffers_restored_through_a_wrapped_loss():
    """The rows of ``buffers=`` come back for a loss the engine cannot
    see into (a lambda around ``worker_loss``): the sat-out worker's
    BatchNorm statistics pass through bitwise, a due worker's move."""
    sm, batch = _tiny_resnet()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    params = sm.replicate()
    state = opt.init(params)
    step = bft.make_async_train_step(
        opt, lambda row, x, y, j: sm.worker_loss(row, x, y, j), cadence={2: 2},
        buffers=sm.buffers)
    params, state, _ = step(params, state, *batch)  # tick 0: everyone is due
    before = {k: v.clone() for k, v in sm.buffers.items()}
    params, state, loss = step(params, state, *batch)  # tick 1: worker 2 sits out
    for name, buf in sm.buffers.items():
        assert torch.equal(buf[2], before[name][2]), name
    assert any(not torch.equal(buf[0], before[name][0]) for name, buf in sm.buffers.items())
    assert torch.isfinite(loss).all()


def test_worker_loss_without_buffers_is_refused():
    """A bound ``worker_loss`` of a model with batch statistics must name
    them, else a sat-out rank's loss evaluation would move them; a
    ``buffers=`` that is not tensors is refused too."""
    sm, _batch = _tiny_resnet()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    with pytest.raises(ValueError, match="buffers=model.buffers"):
        bft.make_async_train_step(opt, sm.worker_loss, cadence={1: 3})
    with pytest.raises(TypeError, match="buffers must be"):
        bft.make_async_train_step(opt, sm.worker_loss, buffers=[1.0])
    # async off: the synchronous step, which updates every worker's statistics
    assert not hasattr(bft.make_async_train_step(opt, sm.worker_loss, enabled=False), "engine")
