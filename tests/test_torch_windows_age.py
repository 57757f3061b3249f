# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's host age lane of the windows (``get_win_age``,
``get_win_version(ages=True)``, ``mass=True``), ``win_mutex`` and the
``require_mutex`` arguments, against the JAX package after the same op
sequence, and the push-sum mass identities of
``tests/test_pushsum_oracle.py`` on the port.

The age lanes are integers on the host: they match JAX's exactly, after
window ops, window-optimizer steps and asynchronous ticks. The mass
identities hold the port to the property itself (total x mass, values plus
pending buffers summed in float64, within 1e-5 of ``sum |x|``; p mass
within 1e-5 of the worker count), not to JAX output: the JAX side fails
them on this jax with its Pallas wire kernels inside ``shard_map``.
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
from bluefog_tpu_torch import topology as ttu

SIZE = 8


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.delenv("BLUEFOG_WINDOW_WIRE", raising=False)
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.win_free()
    bf.turn_off_win_ops_with_associated_p()
    bf.shutdown()
    bft.shutdown()


def ranks(shape=(4,)):
    return np.stack([np.full(shape, float(r), np.float32) for r in range(SIZE)])


def both(fn):
    """``fn(package, to_worker_values)`` on the JAX side, then the port's."""
    return (fn(bf, lambda a: bf.worker_values(list(a))),
            fn(bft, lambda a: torch.from_numpy(np.array(a))))


def assert_same_ages(name, jname=None):
    """Every reading of the age lane, equal on both sides (the JAX window
    named ``jname``, default ``name``)."""
    jname = name if jname is None else jname
    for kw in (dict(), dict(mass=True)):
        assert bft.get_win_age(name, **kw) == bf.get_win_age(jname, **kw), kw
        for r in (0, SIZE - 1):
            assert bft.get_win_age(name, rank=r, **kw) == bf.get_win_age(jname, rank=r, **kw)
    assert bft.get_win_version(name, ages=True) == bf.get_win_version(jname, ages=True)
    assert bft.get_win_version(name) == bf.get_win_version(jname)


# -- test_windows.py: the age lane, win_mutex --------------------------------------------


def test_win_mutex_checks_the_window_and_holds_nothing():
    x = ranks()
    both(lambda m, wv: m.win_create(wv(x), "w"))
    with bft.win_mutex("w"):
        bft.win_put(torch.from_numpy(x), "w")
    with bft.win_mutex("w", for_self=True, ranks=[1, 2]):
        pass
    for m in (bf, bft):
        with pytest.raises(ValueError, match="'nope' does not exist"):
            with m.win_mutex("nope"):
                pass


def test_require_mutex_is_taken_everywhere():
    x = torch.from_numpy(ranks())
    bft.win_create(x, "w")
    bft.win_put(x, "w", require_mutex=True)
    bft.win_wait(bft.win_put_nonblocking(x, "w", require_mutex=True))
    bft.win_accumulate(x, "w", require_mutex=True)
    bft.win_wait(bft.win_accumulate_nonblocking(x, "w", require_mutex=True))
    bft.win_get("w", require_mutex=True)
    bft.win_wait(bft.win_get_nonblocking("w", require_mutex=True))
    bft.win_update("w", require_mutex=True)
    bft.win_update_then_collect("w", require_mutex=True)
    assert bft.get_context().windows["w"].clock == 8


def test_get_win_version_age_semantics_oracle():
    """Across put -> update cycles the version counter resets at every
    update while the age counts on from the write; equal to JAX's and to
    the oracle of ``tests/test_windows.py``."""
    x = ranks()
    both(lambda m, wv: m.win_create(wv(x), "agew"))
    in_nbrs = bft.get_context().in_neighbor_ranks()
    for r in range(SIZE):
        assert bft.get_win_age("agew", rank=r) == {s: 0 for s in in_nbrs[r]}
    expected = {r: {s: 0 for s in in_nbrs[r]} for r in range(SIZE)}

    def tick(written):
        for r in range(SIZE):
            for s in expected[r]:
                expected[r][s] = 0 if written else expected[r][s] + 1

    for _cycle in range(3):
        both(lambda m, wv: m.win_put(name="agew"))
        tick(True)
        assert bft.get_win_version("agew", ages=True) == [expected[r] for r in range(SIZE)]
        assert_same_ages("agew")
        for _ in range(2):
            both(lambda m, wv: m.win_update(name="agew"))
            tick(False)
            assert all(v == 0 for row in bft.get_win_version("agew") for v in row.values())
            assert bft.get_win_age("agew") == [expected[r] for r in range(SIZE)]
            assert_same_ages("agew")


def test_win_age_mass_lane_tracks_oldest_pending_accumulate():
    both(lambda m, wv: m.turn_on_win_ops_with_associated_p())
    x = ranks()
    both(lambda m, wv: m.win_create(wv(x), "massw", zero_init=True))
    in_nbrs = bft.get_context().in_neighbor_ranks()
    for r in range(SIZE):
        assert all(v is None for v in bft.get_win_age("massw", rank=r, mass=True).values())
    both(lambda m, wv: m.win_accumulate(name="massw"))
    for r in range(SIZE):
        assert bft.get_win_age("massw", rank=r, mass=True) == {s: 0 for s in in_nbrs[r]}
    both(lambda m, wv: m.win_accumulate(name="massw"))
    for r in range(SIZE):
        assert bft.get_win_age("massw", rank=r, mass=True) == {s: 1 for s in in_nbrs[r]}
    assert_same_ages("massw")
    both(lambda m, wv: m.win_update_then_collect("massw"))
    for r in range(SIZE):
        assert all(v is None for v in bft.get_win_age("massw", rank=r, mass=True).values())
    assert_same_ages("massw")
    bft.turn_off_win_ops_with_associated_p()


def test_partial_ops_age_lane_matches_jax():
    """Partial participation, explicit weights, get, put and a non-resetting
    update on the star: every age reading equal to JAX's after each op."""
    bf.set_topology(tu.StarGraph(SIZE))
    bft.set_topology(ttu.StarGraph(SIZE))
    x = ranks((3,))
    both(lambda m, wv: m.win_create(wv(x), "w", zero_init=True))
    outs, ins = bft.out_neighbor_ranks(), bft.in_neighbor_ranks()
    half = [{d: 0.5 for d in outs[r]} if r % 2 else None for r in range(SIZE)]
    pulled = [{s: 0.3 for s in ins[r]} if r % 3 else None for r in range(SIZE)]
    ops = [
        lambda m, wv: m.win_accumulate(name="w", dst_weights=half),
        lambda m, wv: m.win_get(name="w", src_weights=pulled),
        lambda m, wv: m.win_update(name="w", self_weight=0.5,
                                   neighbor_weights=[{s: 0.5 for s in ins[r]} if r < 4 else None
                                                     for r in range(SIZE)], reset=True),
        lambda m, wv: m.win_put(wv(x), name="w"),
        lambda m, wv: m.win_accumulate(name="w"),
        lambda m, wv: m.win_update(name="w"),
        lambda m, wv: m.win_update_then_collect(name="w"),
    ]
    for op in ops:
        both(op)
        assert_same_ages("w")


@pytest.mark.parametrize("mode", ["put", "get", "push_sum"])
@pytest.mark.parametrize("k", [1, 2])
def test_window_optimizer_age_lane_matches_jax(mode, k):
    """A window optimizer's steps (local adapts between exchanges with
    ``num_steps_per_communication=2``) age the window as JAX's fused step
    does: one local step per call."""
    bf.set_topology(tu.ExponentialTwoGraph(SIZE))
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    make = {"put": ("DistributedWinPutOptimizer"), "get": "DistributedPullGetOptimizer",
            "push_sum": "DistributedPushSumOptimizer"}[mode]
    jopt = getattr(bf, make)(optax.sgd(0.1), num_steps_per_communication=k)
    topt = getattr(bft, make)(bft.sgd(0.1), num_steps_per_communication=k)
    z0 = np.random.RandomState(3).randn(SIZE, 5).astype(np.float32)
    js = jopt.init({"w": bf.worker_values(list(z0))})
    ts = topt.init({"w": torch.from_numpy(z0.copy())})
    g = np.random.RandomState(4).randn(SIZE, 5).astype(np.float32)
    for step in range(5):
        _, js = jopt.step(js, {"w": jnp.asarray(g)})
        _, ts = topt.step(ts, {"w": torch.from_numpy(g)})
        assert bft.get_context().windows[topt._name].clock == step + 1
        assert_same_ages(topt._name, jopt._name)
    np.testing.assert_allclose(topt.params()["w"].numpy(), np.asarray(jopt.params()["w"]),
                               rtol=0, atol=1e-5)
    jopt.free()
    topt.free()


# -- test_pushsum_oracle.py: the async mass identities and ages ------------------------------


def window_mass(win):
    return (float(torch.sum(win.value, dtype=torch.float64)
                  + torch.sum(win.buffers, dtype=torch.float64)),
            float(torch.sum(win.p, dtype=torch.float64)
                  + torch.sum(win.p_buffers, dtype=torch.float64)))


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4", "int8_ef", "int4_ef"],
                         ids=lambda w: w or "fp32")
def test_async_mass_conservation_random_cadences(wire):
    """Random per-rank cadences at lr 0: the x mass and the p mass are
    invariant per tick to f32 rounding on every wire (the sender keeps the
    residual of what it ships); the age lane equals JAX's engine's."""
    rng = np.random.RandomState(7)
    bf.set_topology(tu.RingGraph(SIZE, connect_style=1))
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    z0 = rng.randn(SIZE, 1024).astype(np.float32) * 2
    periods = {r: int(p) for r, p in enumerate(rng.randint(1, 5, SIZE))}

    def loss_fn(p, target):
        return 0.5 * torch.sum((p["w"] - target) ** 2)

    def jloss(p, target):
        return 0.5 * jnp.sum((p["w"] - target) ** 2)

    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.0))
    params, jp = {"w": torch.from_numpy(z0.copy())}, {"w": jnp.asarray(z0)}
    state, js = opt.init(params), jopt.init(jp)
    step = bft.make_async_train_step(opt, loss_fn, cadence=periods, wire=wire, max_age=10 ** 6)
    jstep = bf.make_async_train_step(jopt, jloss, cadence=periods, wire=wire, max_age=10 ** 6)
    mass0 = float(np.sum(z0, dtype=np.float64))
    scale = max(abs(mass0), float(np.abs(z0).sum()))
    for t in range(20):
        params, state, _ = step(params, state, torch.from_numpy(z0))
        jp, js, _ = jstep(jp, js, jnp.asarray(z0))
        x_mass, p_mass = window_mass(bft.get_context().windows[step.engine._name])
        assert abs(x_mass - mass0) < 1e-5 * scale, f"tick {t}: wire={wire} drift"
        assert abs(p_mass - SIZE) < 1e-5
        assert bft.get_win_age(step.engine._name) == bf.get_win_age(jstep.engine._name)
        assert bft.get_win_age(step.engine._name, mass=True) == \
            bf.get_win_age(jstep.engine._name, mass=True)


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"], ids=lambda w: w or "exact")
def test_interleaved_accumulate_update_conserves_mass(wire, monkeypatch):
    """A random interleave of partial-participation ``win_accumulate``
    (column-stochastic shares) and partial-participation collecting
    ``win_update`` keeps the total mass on every window wire (the p lane
    too), and ages the window as JAX does."""
    if wire is not None:
        monkeypatch.setenv("BLUEFOG_WINDOW_WIRE", wire)
    rng = np.random.RandomState(11)
    bf.set_topology(tu.RingGraph(SIZE, connect_style=1))
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    z0 = rng.randn(SIZE, 1024).astype(np.float32)
    both(lambda m, wv: m.win_create(wv(z0), "async_prop", zero_init=True))
    both(lambda m, wv: m.turn_on_win_ops_with_associated_p())
    win = bft.get_context().windows["async_prop"]
    outs = bft.out_neighbor_ranks()
    mass0 = float(np.sum(z0, dtype=np.float64))
    scale = float(np.abs(z0).sum())
    for t in range(12):
        part = rng.rand(SIZE) < 0.7
        if rng.rand() < 0.6:
            dst = [{d: 1.0 / (len(outs[r]) + 1) for d in outs[r]} if part[r] else None
                   for r in range(SIZE)]
            sw = {r: 1.0 / (len(outs[r]) + 1) for r in range(SIZE) if part[r]}
            both(lambda m, wv: m.win_accumulate(name="async_prop", self_weight=sw,
                                                dst_weights=dst))
        else:
            nw = [{s: 1.0 for s in win.in_neighbors[r]} if part[r] else None
                  for r in range(SIZE)]
            both(lambda m, wv: m.win_update(name="async_prop", self_weight=1.0,
                                            neighbor_weights=nw, reset=True))
        x_mass, p_mass = window_mass(win)
        assert abs(x_mass - mass0) < 1e-5 * max(scale, 1.0), f"op {t}: wire={wire}"
        assert abs(p_mass - SIZE) < 1e-5
        assert_same_ages("async_prop")
    bft.turn_off_win_ops_with_associated_p()


def test_get_win_age_oracle_decoupled_cadences():
    """After T ticks the slot fed by sender s (period P_s) reports age
    ``T - (floor((T - 1) / P_s) * P_s + 1)``, on both sides."""
    rng = np.random.RandomState(13)
    bf.set_topology(tu.RingGraph(SIZE, connect_style=1))
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    z0 = rng.randn(SIZE, 3).astype(np.float32)
    periods = {r: int(p) for r, p in enumerate(rng.randint(1, 6, SIZE))}

    def loss_fn(p, target):
        return 0.5 * torch.sum((p["w"] - target) ** 2)

    def jloss(p, target):
        return 0.5 * jnp.sum((p["w"] - target) ** 2)

    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.0))
    params, jp = {"w": torch.from_numpy(z0.copy())}, {"w": jnp.asarray(z0)}
    state, js = opt.init(params), jopt.init(jp)
    step = bft.make_async_train_step(opt, loss_fn, cadence=periods, max_age=10 ** 6)
    jstep = bf.make_async_train_step(jopt, jloss, cadence=periods, max_age=10 ** 6)
    for ticks in (1, 3, 7, 12):
        while step.engine._tick < ticks:
            params, state, _ = step(params, state, torch.from_numpy(z0))
            jp, js, _ = jstep(jp, js, jnp.asarray(z0))
        ages = bft.get_win_age(step.engine._name)
        assert ages == bf.get_win_age(jstep.engine._name)
        assert bft.get_win_version(step.engine._name) == bf.get_win_version(jstep.engine._name)
        for r in range(SIZE):
            for s, age in ages[r].items():
                last_tick = ((ticks - 1) // periods[s]) * periods[s]
                assert age == ticks - (last_tick + 1), (ticks, s, r)
    assert jwin_mod._get_win(bf.get_context(), jstep.engine._name).clock == 12
