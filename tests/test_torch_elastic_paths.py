# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The elastic hooks of the port's other paths, against the JAX package:
the ZeRO-1/2 re-shard on a kill (``tests/test_sharding.py:379,416,761``),
the async engine's ``slow`` dilation and kill re-window
(``tests/test_async.py:304,324``), the checkpoint's live set
(``tests/test_checkpoint.py:326,368``) and the flight dump's ``membership``
and ``faults`` blocks.

Tolerances: the re-shard moves data, so the gathered moments are held
bitwise, and the quantized ZeRO-2 scatter at 7 live bitwise a plain ring
written out here; Adam trajectories against JAX's to 1e-6 of the largest
value (the port's Adam against optax,
``tests/test_torch_optimizer_family.py``); the async estimates against
JAX's engine to 1e-5 absolute (XLA may contract the fold's accumulate into
an FMA); the masses to 1e-5 of ``sum |x|``; after a kill the survivors'
estimates within the pre-kill estimates' elementwise range to 1e-4 on the
exact wire (JAX's bound) and to one int8 quantum of the largest estimate a
tick on the int8 wire (its rounding, see the test).
"""

import json

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import checkpoint as jckpt
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import sharding as jsharding
from bluefog_tpu import topology as jtu
from bluefog_tpu_torch import checkpoint as ckpt
from bluefog_tpu_torch import flight, metrics, sharding
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective import inner, kernels
from bluefog_tpu_torch.optimizers import tree_leaves

SIZE = 8
D1, D2 = 1537, 700  # tests/test_sharding.py's two odd leaves, one packed group


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    for env in ("BLUEFOG_SHARD", "BLUEFOG_SHARD_GRADS", "BLUEFOG_SHARD_MASTER",
                "BLUEFOG_FAULT_PLAN"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    metrics.reset()
    jmetrics.reset()
    bft.init(device="cpu")
    yield
    bft.elastic.stop()
    bf.elastic.stop()
    if bft.is_initialized():
        bft.shutdown()
    sharding.clear_active()
    metrics.reset()
    jmetrics.reset()


def _targets():
    rng = np.random.RandomState(0)
    return rng.randn(SIZE, D1).astype(np.float32), rng.randn(SIZE, D2).astype(np.float32)


def _shard_on(monkeypatch, grads=False, master=False):
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    if grads:
        monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1")
    if master:
        monkeypatch.setenv("BLUEFOG_SHARD_MASTER", "1")


def _port_kill_reshard(compression=None, steps=8, kill=(3, 4)):
    c1, _ = _targets()
    session = bft.elastic.start(policy="average")
    session.inject("kill", rank=kill[0], step=kill[1])
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    opt.compression = compression
    guard = bft.elastic.guard(opt)
    params = {"a": torch.zeros(SIZE, D1)}
    state = opt.init(params)
    lay0 = opt._shard_layout
    traj = []
    for _ in range(steps):
        params, state = guard.step(params, state, {"a": params["a"] - torch.from_numpy(c1)})
        traj.append(params["a"].numpy().copy())
    return session, opt, lay0, state, traj


@pytest.mark.parametrize("grads", [False, True], ids=["zero1", "zero2"])
def test_kill_repair_reshards_and_matches_jax(grads, monkeypatch, cpu_devices):
    """kill -> repair -> re-shard: the layout follows the live set, the
    ZeRO-2 layout keeps its gradient leg, replicas stay bit-identical, the
    summary reports the re-shard, and the trajectory is JAX's."""
    import jax.numpy as jnp
    import optax

    _shard_on(monkeypatch, grads=grads)
    session, opt, lay0, _state, traj = _port_kill_reshard()
    lay1 = opt._shard_layout
    assert lay0.live == tuple(range(SIZE))
    assert lay1.live == (0, 1, 2, 4, 5, 6, 7) and lay1.grads is grads
    assert lay1.token == bft.get_context().live_token()
    assert opt._shard_reshards == 1 and session.stale_dispatches == 0
    w = traj[-1]
    assert np.isfinite(w).all() and np.abs(w - w[0]).max() == 0.0
    summary = sharding.summary()
    assert summary["reshards"] == 1 and summary["n_live"] == 7
    assert metrics.snapshot()["bluefog.shard.reshards"]["value"] == 1
    assert "shard_reshard" in [e["kind"] for e in flight.events()]

    c1, _ = _targets()
    bf.init(devices=cpu_devices[:SIZE])
    js = bf.elastic.start(policy="average")
    js.inject("kill", rank=3, step=4)
    jopt = bf.DistributedGradientAllreduceOptimizer(optax.adam(0.02))
    jguard = bf.elastic.guard(jopt)
    jp = {"a": bf.worker_values(lambda r: np.zeros(D1, np.float32))}
    jst = jopt.init(jp)
    for t in range(len(traj)):
        jp, jst = jguard.step(jp, jst, {"a": jp["a"] - jnp.asarray(c1)})
        want = np.asarray(jp["a"])
        np.testing.assert_allclose(traj[t], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=f"step {t}")
    assert jopt._shard_layout.live == lay1.live and jopt._shard_reshards == 1
    assert [(g.dtype, g.elems, g.slot) for g in jopt._shard_layout.groups] == \
        [(g.dtype, g.elems, g.slot) for g in lay1.groups]
    bf.elastic.stop()
    bf.shutdown()


@pytest.mark.parametrize("master", [False, True])
def test_reshard_preserves_state_values(master, monkeypatch):
    """The re-shard is a pure re-layout: each slot leaf's full vector,
    gathered before under the old layout and after under the new one, is
    the same bits (JAX's ``sharding.gather_rows`` on both); step counts
    are untouched; the leaves keep their identity and device."""
    _shard_on(monkeypatch, master=master)
    c1, c2 = _targets()
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    params = {"a": torch.zeros(SIZE, D1), "b": torch.zeros(SIZE, D2)}
    state = opt.init(params)
    for _ in range(3):
        opt.step(params, state, {"a": params["a"] - torch.from_numpy(c1),
                                 "b": params["b"] - torch.from_numpy(c2)})
    ctx = bft.get_context()
    old = opt._shard_layout
    new = sharding.build_layout([(g.dtype, g.elems) for g in old.groups],
                                (0, 1, 2, 4, 5, 6, 7), SIZE, master=old.master, token=("x",))
    before = [(leaf, leaf.clone()) for leaf in tree_leaves(state)]
    opt._reshard_state(ctx, old, new, state)
    checked = 0
    for leaf, was in before:
        gi = opt._shard_slot_group(tuple(was.shape), old)
        if gi is None:
            assert torch.equal(leaf, was)
            continue
        assert tuple(leaf.shape) == (SIZE, new.groups[gi].slot)
        a = jsharding.gather_rows(was.numpy(), old, gi)
        b = jsharding.gather_rows(leaf.numpy(), new, gi)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        assert not leaf[3].any()  # the dead worker owns nothing
        checked += 1
    assert checked == (3 if master else 2)  # mu and nu (and the master slices)
    assert [leaf for leaf, _ in before] == tree_leaves(state)


def test_zero2_int8_scatter_at_seven_live_is_the_plain_ring(monkeypatch):
    """After the re-shard the ZeRO-2 int8 scatter, as the optimizer
    dispatches it, is bitwise a plain ring: every worker ships, worker
    ``j`` receives the slot of its owner position (the dead worker's
    position 0, never gathered), mean over all workers."""
    _shard_on(monkeypatch, grads=True)
    session, opt, _lay0, state, traj = _port_kill_reshard(compression="int8")
    layout = opt._shard_layout
    assert layout.live == (0, 1, 2, 4, 5, 6, 7) and opt._shard_reshards == 1
    ctx = bft.get_context()
    params = {"a": torch.from_numpy(traj[-1].copy())}
    grads = {"a": torch.from_numpy(np.random.RandomState(9).randn(SIZE, D1).astype(np.float32))}
    d = opt._resolve_dispatch(ctx, params, True)
    opt._shard_dispatch(ctx, d, params, state, True)
    got = opt._scatter_own_grads(d, grads)[0]
    slot = layout.groups[0].slot
    lidx = [int(v) for v in layout.live_index()]
    g = grads["a"]

    def owned(sender, pos):
        row = g.new_zeros(slot)
        lo, hi = pos * slot, min((pos + 1) * slot, D1)
        if hi > lo:
            row[:hi - lo] = g[sender, lo:hi]
        return row

    y = torch.stack([owned(j, lidx[j]) for j in range(SIZE)])
    for t in range(1, SIZE):
        rows = torch.stack([owned((j - t) % SIZE, lidx[j]) for j in range(SIZE)])
        payload, scales = kernels.encode_reference(kernels.pad_blocks(rows), "int8")
        y = y + kernels.unpad_blocks(kernels.dequantize(payload, scales).reshape(SIZE, -1), slot)
    y = y / torch.tensor(SIZE, dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), y.view(torch.int32))
    mean = inner.allreduce(g)[0]
    for i, r in enumerate(layout.live):
        lo, hi = i * slot, min((i + 1) * slot, D1)
        if hi > lo:
            assert (got[r, :hi - lo] - mean[lo:hi]).abs().max() <= 2e-2 * g.abs().max()


def test_master_flip_and_group_change_still_raise(monkeypatch):
    _shard_on(monkeypatch)
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    params = {"a": torch.zeros(SIZE, D1)}
    state = opt.init(params)
    opt.step(params, state, {"a": params["a"] + 1.0})
    monkeypatch.setenv("BLUEFOG_SHARD_MASTER", "1")
    with pytest.raises(ValueError, match="BLUEFOG_SHARD_MASTER changed"):
        opt.step(params, state, {"a": params["a"] + 1.0})
    monkeypatch.delenv("BLUEFOG_SHARD_MASTER")
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.05))
    state = opt.init(params)
    opt.step(params, state, {"a": params["a"] + 1.0})
    wider = {"a": torch.zeros(SIZE, D1 + 512)}
    with pytest.raises(ValueError, match="dtype groups changed"):
        opt.step(wider, state, {"a": wider["a"] + 1.0})
    assert opt._shard_reshards == 0


def test_sharded_checkpoint_after_a_kill_restores_on_seven_live(monkeypatch, tmp_path):
    """A sharded state saved after the re-shard records 7 live ranks; a
    fresh context under a fresh session adopts them and the resumed run is
    bitwise the uninterrupted one."""
    _shard_on(monkeypatch)
    c1, _ = _targets()
    session, opt, _lay0, state, traj = _port_kill_reshard(steps=6)
    params = {"a": torch.from_numpy(traj[-1].copy())}
    ckpt.save(str(tmp_path), 6, params, state, optimizer=opt)
    info = json.load(open(tmp_path / "6.graph.json"))["graph_info"]
    assert info["live_ranks"] == [0, 1, 2, 4, 5, 6, 7] and info["shard"]["n_live"] == 7
    for _ in range(2):
        opt.step(params, state, {"a": params["a"] - torch.from_numpy(c1)})
    bft.elastic.stop()
    bft.init(device="cpu")
    session2 = bft.elastic.start(policy="average")
    opt2 = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    _step, p2, s2 = ckpt.restore(str(tmp_path), optimizer=opt2)
    assert session2.membership.dead_ranks() == (3,) and len(session2.repairs) == 1
    assert opt2._shard_layout.live == (0, 1, 2, 4, 5, 6, 7)
    guard2 = bft.elastic.guard(opt2)
    for _ in range(2):
        p2, s2 = guard2.step(p2, s2, {"a": p2["a"] - torch.from_numpy(c1)})
    assert torch.equal(p2["a"].view(torch.int32), params["a"].view(torch.int32))
    assert session2.stale_dispatches == 0


# -- the async engine ------------------------------------------------------------------


def _async_step(lr=0.0, **kwargs):
    bft.set_topology(tu.RingGraph(SIZE, connect_style=1))
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(lr))
    return opt, bft.make_async_train_step(
        opt, lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2), **kwargs)


def _z(seed, dim=3):
    return np.random.RandomState(seed).randn(SIZE, dim).astype(np.float32)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_slow_fault_dilation_is_the_cadence_bitwise(wire):
    """``slow`` at factor 10 (ceil 10) gives the periods ``cadence={6:
    10}`` gives: every tick's estimate bitwise, every tick's participants
    equal."""
    z0, tg = _z(6, 1024), _z(16, 1024)

    def run(session_slow):
        if session_slow:
            session = bft.elastic.start(policy="push_sum")
            session.inject("slow", rank=6, step=0, factor=9.5)
            opt, step = _async_step(0.05, max_age=4, wire=wire)
        else:
            opt, step = _async_step(0.05, max_age=4, wire=wire, cadence={6: 10})
        params = {"w": torch.from_numpy(z0.copy())}
        state = opt.init(params)
        out = []
        for _ in range(12):
            params, state, _ = step(params, state, torch.from_numpy(tg))
            out.append((params["w"].clone(), step.engine._local_steps))
        step.engine.free()
        bft.elastic.stop()
        return out

    for (a, na), (b, nb) in zip(run(True), run(False)):
        assert na == nb and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_slow_fault_dilates_cadence_as_jax(cpu_devices):
    import jax.numpy as jnp
    import optax

    z0 = _z(6)
    session = bft.elastic.start(policy="push_sum")
    session.inject("slow", rank=1, step=0, factor=4)
    opt, step = _async_step(max_age=100)
    params = {"w": torch.from_numpy(z0)}
    state = opt.init(params)
    for _ in range(8):
        params, state, _ = step(params, state, torch.from_numpy(z0))
    assert step.engine._local_steps == 8 * SIZE - 6

    bf.init(devices=cpu_devices[:SIZE])
    bf.set_topology(jtu.RingGraph(SIZE, connect_style=1))
    js = bf.elastic.start(policy="push_sum")
    js.inject("slow", rank=1, step=0, factor=4)
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.0))
    jp = {"w": jnp.asarray(z0)}
    jst = jopt.init(jp)
    jstep = bf.make_async_train_step(
        jopt, lambda p, t: 0.5 * jnp.sum((p["w"] - t) ** 2), max_age=100)
    for _ in range(8):
        jp, jst, _ = jstep(jp, jst, jnp.asarray(z0))
    assert jstep.engine._local_steps == step.engine._local_steps
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp["w"]), rtol=0, atol=1e-5)
    bf.win_free()
    bf.elastic.stop()
    bf.shutdown()


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_kill_repairs_and_rewindows_keeping_the_mass(wire, cpu_devices):
    """A kill mid-run: one repair, one re-window, no stale dispatch, the
    dead rank never takes part again, the live p mass is 7 and the live
    value mass kept at lr 0, and the survivors' estimates stay inside the
    pre-kill estimates' elementwise range; JAX's estimates to 1e-5 (fp32)."""
    import jax.numpy as jnp
    import optax

    z0 = _z(7, 1024)
    session = bft.elastic.start(policy="push_sum")
    opt, step = _async_step(max_age=4, wire=wire)
    eng = step.engine
    params = {"w": torch.from_numpy(z0.copy())}
    state = opt.init(params)
    batch = torch.from_numpy(z0)
    for _ in range(6):
        params, state, _ = step(params, state, batch)
    before = params["w"].numpy().copy()
    session.inject("kill", rank=5, step=session.step)
    live = [r for r in range(SIZE) if r != 5]
    masses = []
    for t in range(4):
        steps0 = eng._local_steps
        params, state, _ = step(params, state, batch)
        assert eng._local_steps - steps0 == len(live)
        win = bft.get_context().windows[eng._name]
        f64 = torch.float64
        masses.append((float(torch.sum(win.value[live], dtype=f64)
                             + torch.sum(win.buffers[live], dtype=f64)),
                       float(torch.sum(win.value[live].abs(), dtype=f64)),
                       float(torch.sum(win.p[live], dtype=f64)
                             + torch.sum(win.p_buffers[live], dtype=f64))))
    assert len(session.repairs) == 1 and session.repairs[0].policy == "push_sum"
    assert session.stale_dispatches == 0 and eng._rewindows == 1
    assert metrics.snapshot()["bluefog.async.rewindows"]["value"] == 1
    assert all(5 not in d for d in eng.dst_weights) and eng.dst_weights[5] == {}
    after = params["w"].numpy()
    # JAX's test holds the exact wire to 1e-4; on the int8 wire a tick
    # moves an estimate by at most about one quantum of the largest value
    # (half in what it receives, half in the residual a sender keeps)
    slack = 1e-4 if wire == "fp32" else len(masses) * np.abs(before).max() / 127
    assert np.all(after[live].max(0) <= before.max(0) + slack)
    assert np.all(after[live].min(0) >= before.min(0) - slack)
    for x, ax, p in masses:
        assert abs(x - masses[0][0]) <= 1e-5 * ax and abs(p - len(live)) <= 1e-5
    if wire != "fp32":
        return
    bf.init(devices=cpu_devices[:SIZE])
    bf.set_topology(jtu.RingGraph(SIZE, connect_style=1))
    js = bf.elastic.start(policy="push_sum")
    jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.0))
    jp = {"w": jnp.asarray(z0)}
    jst = jopt.init(jp)
    jstep = bf.make_async_train_step(
        jopt, lambda p, t: 0.5 * jnp.sum((p["w"] - t) ** 2), max_age=4)
    for _ in range(6):
        jp, jst, _ = jstep(jp, jst, jnp.asarray(z0))
    js.inject("kill", rank=5, step=js.step)
    for _ in range(4):
        jp, jst, _ = jstep(jp, jst, jnp.asarray(z0))
    assert jstep.engine._rewindows == 1
    assert jstep.engine.dst_weights == eng.dst_weights
    np.testing.assert_allclose(after, np.asarray(jp["w"]), rtol=0, atol=1e-5)
    bf.win_free()
    bf.elastic.stop()
    bf.shutdown()


# -- checkpoint ----------------------------------------------------------------------------


def _kill_and_save(path, step=2):
    session = bft.elastic.start()
    session.inject("kill", rank=3, step=0)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    session.before_dispatch(opt)
    assert session.repairs
    params = {"w": torch.from_numpy(_z(0))}
    ckpt.save(path, step, params, {})
    bft.elastic.stop()


def test_restore_live_set_mismatch_repairs_under_elastic(tmp_path):
    _kill_and_save(str(tmp_path))
    assert json.load(open(tmp_path / "2.graph.json"))["graph_info"]["live_ranks"] == \
        [0, 1, 2, 4, 5, 6, 7]
    bft.init(device="cpu")
    session2 = bft.elastic.start()
    step, p, _s = ckpt.restore(str(tmp_path))
    assert step == 2 and session2.membership.dead_ranks() == (3,)
    assert session2.repairs and session2.repairs[0].detected == (3,)


def test_restore_live_set_mismatch_refused_without_a_session(tmp_path):
    _kill_and_save(str(tmp_path))
    bft.init(device="cpu")
    with pytest.raises(ValueError, match=r"bft\.elastic\.start\(\)"):
        ckpt.restore(str(tmp_path))


def test_restore_superset_live_set_revives_under_elastic(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.from_numpy(_z(0))}, {})
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=0)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    session.before_dispatch(opt)
    assert session.membership.dead_ranks() == (2,)
    digest_dead = ckpt.topology_digest(bft.load_topology())
    step, _p, _s = ckpt.restore(str(tmp_path))
    assert step == 1 and session.membership.dead_ranks() == ()
    assert ckpt.topology_digest(bft.load_topology()) != digest_dead


def test_graph_info_live_set_equals_jax(tmp_path, cpu_devices):
    """The sidecar after a kill and repair: the same keys and values as
    the JAX package's, digest included."""
    _kill_and_save(str(tmp_path / "port"), step=4)
    bf.init(devices=cpu_devices[:SIZE])
    js = bf.elastic.start()
    js.inject("kill", rank=3, step=0)
    import optax

    js.before_dispatch(bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1)))
    jckpt.save(str(tmp_path / "jax"), 4, {"w": bf.worker_values(lambda r: _z(0)[r])}, {})
    bf.elastic.stop()
    bf.shutdown()
    got = json.load(open(tmp_path / "port" / "4.graph.json"))["graph_info"]
    want = json.load(open(tmp_path / "jax" / "4.graph.json"))["graph_info"]
    assert got == want


# -- the flight dump --------------------------------------------------------------------


def test_flight_dump_membership_and_faults_equal_jax(tmp_path, monkeypatch, cpu_devices):
    """The same kill, degrade and rejoin in both packages: the dumps'
    ``membership`` and ``faults`` blocks are equal, and the port's dump
    has every top-level key of JAX's it has a source for."""
    import optax

    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path / "port"))
    bft.init(device="cpu")

    def scenario(pkg, opt):
        session = pkg.elastic.start()
        session.inject("kill", rank=4, step=1)
        session.inject("degrade", rank=2, step=2, factor=0.5)
        session.inject("slow", rank=6, step=0, factor=3)
        for _ in range(4):
            session.before_dispatch(opt)
        session.rejoin(4, optimizer=opt)

    scenario(bft, bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1)))
    got = json.load(open(flight.dump(str(tmp_path / "port.json"))))
    monkeypatch.setenv("BLUEFOG_FLIGHT_DIR", str(tmp_path / "jax"))
    bf.init(devices=cpu_devices[:SIZE])
    scenario(bf, bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1)))
    from bluefog_tpu import flight as jflight

    want = json.load(open(jflight.dump(str(tmp_path / "jax.json"))))
    bf.elastic.stop()
    bf.shutdown()
    assert got["membership"] == want["membership"]
    assert got["faults"] == want["faults"]
    assert set(got["membership"]) == {"epoch", "live", "dead", "history"}
    assert got["membership"]["history"][:2] == [[4, "dead", "killed", 1],
                                                [2, "degraded", "factor=0.5", 2]]
    port_fault_keys = {k for e in got["fault_events"] for k in e}
    jax_fault_keys = {k for e in want["fault_events"] for k in e}
    assert port_fault_keys == jax_fault_keys
