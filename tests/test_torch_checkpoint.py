# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's ``checkpoint`` (``bft.checkpoint``), mirroring
``tests/test_checkpoint.py`` without its elastic cases: a run saved at
step k and restored into a fresh optimizer continues bit for bit as the
uninterrupted run does (gossip with a dynamic schedule, error feedback,
window, K-step and sharded optimizers), every refusal, and the graph
sidecar and ``topology_digest`` equal to the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import checkpoint as jckpt
from bluefog_tpu import topology as jtu
from bluefog_tpu_torch import checkpoint as ckpt
from bluefog_tpu_torch import sharding
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective.plan import plan_from_weights, schedule_from_dynamic

SIZE = 8
DIM = 3


@pytest.fixture(autouse=True)
def fresh_context(monkeypatch):
    for env in ("BLUEFOG_SHARD", "BLUEFOG_SHARD_GRADS", "BLUEFOG_SHARD_MASTER"):
        monkeypatch.delenv(env, raising=False)
    bft.init(device="cpu")
    yield
    bft.shutdown()


def targets(seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(SIZE, DIM).astype(np.float32))


def grads(params, c):
    return {"w": params["w"] - c}


def fresh_params(c):
    return {"w": c.clone()}


def test_latest_step_empty(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nothing"))


def test_gossip_optimizer_resume_matches_uninterrupted(tmp_path):
    c = targets()
    sched = schedule_from_dynamic(
        SIZE, lambda r: tu.GetDynamicOnePeerSendRecvRanks(tu.ExponentialGraph(SIZE), r))

    def fresh_opt():
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.2))
        opt.schedule = sched
        return opt

    opt = fresh_opt()
    params = fresh_params(c)
    state = opt.init(params)
    for _ in range(5):
        opt.step(params, state, grads(params, c))
    ckpt.save(str(tmp_path), 5, params, state, optimizer=opt)
    for _ in range(5):
        opt.step(params, state, grads(params, c))
    opt2 = fresh_opt()
    step, p2, s2 = ckpt.restore(str(tmp_path), optimizer=opt2)
    assert step == 5 and opt2._step_count == 5 and opt2._comm_count == 5
    for _ in range(5):
        opt2.step(p2, s2, grads(p2, c))
    assert torch.equal(p2["w"], params["w"])


def test_window_optimizer_resume_restores_device_state(tmp_path):
    c = targets(1)
    bft.set_topology(tu.RingGraph(SIZE, connect_style=1))

    def run(opt, state, steps):
        for _ in range(steps):
            est = opt.params()
            _, state = opt.step(state, {"w": est["w"] - c})
        return state

    opt = bft.DistributedPushSumOptimizer(bft.sgd(0.1))
    params = fresh_params(c)
    state = opt.init(params)
    state = run(opt, state, 4)
    ckpt.save(str(tmp_path), 4, opt.params(), state, optimizer=opt)
    run(opt, state, 4)
    ref = opt.params()["w"]
    opt.free()
    opt2 = bft.DistributedPushSumOptimizer(bft.sgd(0.1))
    opt2.init(params)
    _step, _p, state2 = ckpt.restore(str(tmp_path), optimizer=opt2)
    run(opt2, state2, 4)
    got = opt2.params()["w"]
    opt2.free()
    assert torch.equal(got, ref)


def test_restore_shape_mismatch_raises(tmp_path):
    c = targets(2)
    opt = bft.DistributedWinPutOptimizer(bft.sgd(0.1))
    state = opt.init(fresh_params(c))
    ckpt.save(str(tmp_path), 1, opt.params(), state, optimizer=opt)
    opt.free()
    opt2 = bft.DistributedWinPutOptimizer(bft.sgd(0.1))
    opt2.init({"w": torch.zeros(SIZE, DIM + 2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), optimizer=opt2)
    opt2.free()


def test_latest_step_picks_max(tmp_path):
    c = targets(3)
    opt = bft.DistributedAllreduceOptimizer(bft.sgd(0.1))
    params = fresh_params(c)
    state = opt.init(params)
    for s in (1, 3, 10, 7):
        ckpt.save(str(tmp_path), s, params, state, optimizer=opt)
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert ckpt.restore(str(tmp_path))[0] == 10
    # a save over an existing step replaces it, and leaves no temporary behind
    ckpt.save(str(tmp_path), 10, params, state, optimizer=opt)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [str(s) for s in (1, 3, 7, 10)] + [f"{s}.graph.json" for s in (1, 3, 7, 10)])


def test_saving_freed_window_optimizer_refuses(tmp_path):
    opt = bft.DistributedWinPutOptimizer(bft.sgd(0.1))
    state = opt.init(fresh_params(targets(4)))
    saved = opt.params()
    opt.free()
    with pytest.raises(ValueError, match="no live window"):
        ckpt.save(str(tmp_path), 1, saved, state, optimizer=opt)


def test_restore_without_saved_optimizer_state_refuses(tmp_path):
    c = targets(5)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    params = fresh_params(c)
    state = opt.init(params)
    opt.step(params, state, grads(params, c))
    ckpt.save(str(tmp_path), 1, params, state)
    with pytest.raises(ValueError, match="step counter"):
        ckpt.restore(str(tmp_path), optimizer=opt)
    wopt = bft.DistributedWinPutOptimizer(bft.sgd(0.1))
    wstate = wopt.init(params)
    ckpt.save(str(tmp_path / "w"), 1, wopt.params(), wstate)
    wopt2 = bft.DistributedWinPutOptimizer(bft.sgd(0.1))
    wopt2.init(params)
    with pytest.raises(ValueError, match="window state"):
        ckpt.restore(str(tmp_path / "w"), optimizer=wopt2)
    wopt.free()
    wopt2.free()
    with pytest.raises(ValueError, match="has no window"):
        ckpt.restore(str(tmp_path), optimizer=bft.DistributedWinPutOptimizer(bft.sgd(0.1)))


@pytest.mark.parametrize("wire", ["int8_ef", "int4_ef"])
def test_ef_compression_state_resumes_bitwise(tmp_path, wire):
    c = targets(6)
    zero = {"w": torch.zeros(SIZE, DIM)}

    def fresh_opt():
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
        opt.compression = wire
        return opt

    opt = fresh_opt()
    params = fresh_params(c)
    state = opt.init(params)
    for _ in range(5):
        opt.step(params, state, zero)
    ckpt.save(str(tmp_path), 5, params, state, optimizer=opt)
    for _ in range(5):
        opt.step(params, state, zero)
    opt2 = fresh_opt()
    opt2.init(params)
    _step, p2, s2 = ckpt.restore(str(tmp_path), optimizer=opt2)
    installed = opt2._ef
    for _ in range(5):
        opt2.step(p2, s2, zero)
    assert opt2._ef is installed  # the signature matched: the copies were kept
    assert torch.equal(p2["w"], params["w"])


def test_ef_restore_from_other_topology_safely_rezeros(tmp_path):
    c = targets(7)
    zero = {"w": torch.zeros(SIZE, DIM)}
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    opt.compression = "int8_ef"
    params = fresh_params(c)
    state = opt.init(params)
    for _ in range(5):
        opt.step(params, state, zero)
    ckpt.save(str(tmp_path), 5, params, state, optimizer=opt)
    opt2 = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
    opt2.compression = "int8_ef"
    opt2.self_weight = 1.0 / 3.0
    opt2.src_weights = [{(r - 1) % SIZE: 1 / 3, (r + 1) % SIZE: 1 / 3} for r in range(SIZE)]
    opt2.dst_weights = [[(r - 1) % SIZE, (r + 1) % SIZE] for r in range(SIZE)]
    opt2.init(params)
    _step, p2, s2 = ckpt.restore(str(tmp_path), optimizer=opt2)
    installed = opt2._ef
    for _ in range(80):
        opt2.step(p2, s2, zero)
    assert opt2._ef is not installed
    w = p2["w"]
    torch.testing.assert_close(w, w.mean(0, keepdim=True).expand_as(w), rtol=0, atol=5e-3)


def test_num_steps_per_communication_resume_exact(tmp_path):
    c = targets(9)
    nonzero = {"w": torch.from_numpy(np.stack([np.full(DIM, 0.5 + r, np.float32)
                                               for r in range(SIZE)]))}

    def run(opt, params, state, n, path=None, save_at=None):
        for i in range(n):
            opt.step(params, state, nonzero)
            if save_at is not None and i + 1 == save_at:
                ckpt.save(str(path), i + 1, params, state, optimizer=opt)

    for name, factory in (
        ("grad", lambda: bft.DistributedGradientAllreduceOptimizer(
            bft.sgd(0.1), num_steps_per_communication=3)),
        ("neighbor", lambda: bft.DistributedNeighborAllreduceOptimizer(
            bft.sgd(0.1), num_steps_per_communication=3)),
    ):
        path = tmp_path / name
        opt = factory()
        params = fresh_params(c)
        state = opt.init(params)
        run(opt, params, state, 4, path, save_at=4)
        run(opt, params, state, 5)
        opt2 = factory()
        opt2.init(fresh_params(c))
        step, p2, s2 = ckpt.restore(str(path), optimizer=opt2)
        assert step == 4 and opt2._step_count == 4 and opt2._comm_count == 1
        run(opt2, p2, s2, 5)
        assert torch.equal(p2["w"], params["w"]), name


def test_extra_tree_round_trips_in_place(tmp_path):
    params = fresh_params(targets(10))
    buffers = {"mean": torch.randn(SIZE, 4), "count": torch.arange(SIZE)}
    ckpt.save(str(tmp_path), 1, params, {}, extra=buffers)
    live = {"mean": torch.zeros(SIZE, 4), "count": torch.zeros(SIZE, dtype=torch.long)}
    ckpt.restore(str(tmp_path), extra=live)
    assert torch.equal(live["mean"], buffers["mean"]) and torch.equal(live["count"],
                                                                       buffers["count"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), extra={"mean": torch.zeros(SIZE, 5),
                                           "count": torch.zeros(SIZE)})


# -- the graph guard -------------------------------------------------------------------


def test_checkpoint_records_topology_version_and_world_size(tmp_path):
    ckpt.save(str(tmp_path), 1, fresh_params(targets()), {})
    payload = torch.load(str(tmp_path / "1" / "state.pt"), weights_only=True)
    info = json.loads(payload["graph_info"])
    ctx = bft.get_context()
    assert info["world_size"] == SIZE
    assert info["topo_version"] == ctx.topo_version
    assert info["topo_digest"] == ckpt.topology_digest(ctx.load_topology())
    assert info["live_ranks"] == list(range(SIZE))
    with open(tmp_path / "1.graph.json") as f:
        assert json.load(f) == {"graph_info": info}


def test_sidecar_keys_equal_jax(tmp_path, cpu_devices):
    bf.init(devices=cpu_devices[:SIZE])
    try:
        jckpt.save(str(tmp_path / "jax"), 1, {"w": bf.worker_values(lambda r: np.zeros(DIM))},
                   {})
    finally:
        bf.shutdown()
    ckpt.save(str(tmp_path / "port"), 1, fresh_params(targets()), {})
    with open(tmp_path / "jax" / "1.graph.json") as f:
        jinfo = json.load(f)
    with open(tmp_path / "port" / "1.graph.json") as f:
        info = json.load(f)
    assert info.keys() == jinfo.keys()
    assert info["graph_info"].keys() == jinfo["graph_info"].keys()
    for key in ("world_size", "topo_digest", "live_ranks"):
        assert info["graph_info"][key] == jinfo["graph_info"][key], key


def test_restore_world_size_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, fresh_params(targets()), {})
    bft.init(size=4, device="cpu")
    with pytest.raises(ValueError, match="8-worker mesh.*4 workers"):
        ckpt.restore(str(tmp_path))


def test_restore_topology_mismatch_raises_clear_message(tmp_path):
    ckpt.save(str(tmp_path), 1, fresh_params(targets()), {})
    bft.set_topology(tu.RingGraph(SIZE))
    with pytest.raises(ValueError, match="set_topology"):
        ckpt.restore(str(tmp_path))
    bft.set_topology(tu.ExponentialGraph(SIZE))
    assert ckpt.restore(str(tmp_path))[0] == 1


def test_restore_prevalidates_graph_before_loading(tmp_path, monkeypatch):
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    params = fresh_params(targets())
    ckpt.save(str(tmp_path), 2, params, opt.init(params), optimizer=opt)
    assert os.path.exists(str(tmp_path / "2.graph.json"))
    bft.init(size=4, device="cpu")

    def boom(*_args, **_kwargs):
        raise AssertionError("the state was loaded before the graph check")

    monkeypatch.setattr(torch, "load", boom)
    with pytest.raises(ValueError, match="8-worker mesh"):
        ckpt.restore(str(tmp_path), optimizer=bft.DistributedNeighborAllreduceOptimizer(
            bft.sgd(0.1)))


def test_restore_without_sidecar_still_validates(tmp_path):
    ckpt.save(str(tmp_path), 1, fresh_params(targets()), {})
    os.remove(str(tmp_path / "1.graph.json"))
    bft.init(size=4, device="cpu")
    with pytest.raises(ValueError, match="8-worker mesh"):
        ckpt.restore(str(tmp_path))


def _weighted_topology():
    plan = plan_from_weights(SIZE, 0.4, [{(r - 1) % SIZE: 0.35, (r + 2) % SIZE: 0.25}
                                         for r in range(SIZE)])
    return plan.weight_matrix()


@pytest.mark.parametrize("name", ["exp2", "ring", "weighted"])
def test_topology_digest_equals_jax(name):
    import networkx as nx

    if name == "exp2":
        port, ref = tu.ExponentialTwoGraph(SIZE), jtu.ExponentialTwoGraph(SIZE)
    elif name == "ring":
        port, ref = tu.RingGraph(SIZE), jtu.RingGraph(SIZE)
    else:
        port = _weighted_topology()
        ref = nx.from_numpy_array(port, create_using=nx.DiGraph)
    assert ckpt.topology_digest(port) == jckpt.topology_digest(ref)
    assert ckpt.topology_digest(None) is None


# -- sharded state ---------------------------------------------------------------------


def _shard_grad_run(monkeypatch, steps, grads_on=False, wire=None):
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    if grads_on:
        monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1")
    c = torch.from_numpy(np.random.RandomState(11).randn(SIZE, 1500).astype(np.float32))
    opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    opt.compression = wire
    params = {"w": torch.zeros(SIZE, 1500)}
    state = opt.init(params)
    for _ in range(steps):
        opt.step(params, state, {"w": params["w"] - c})
    return opt, params, state, c


@pytest.mark.parametrize("grads_on,wire", [(False, None), (True, None), (True, "int8")])
def test_sharded_checkpoint_resume_bit_exact(tmp_path, monkeypatch, grads_on, wire):
    opt, params, state, c = _shard_grad_run(monkeypatch, 3, grads_on, wire)
    ckpt.save(str(tmp_path), 3, params, state, optimizer=opt)
    payload = torch.load(str(tmp_path / "3" / "state.pt"), weights_only=True)
    assert payload["opt_state"]["leaf_001"].shape == (1500,)  # a full vector, not slots
    for _ in range(3):
        opt.step(params, state, {"w": params["w"] - c})
    opt2 = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    opt2.compression = wire
    step, p2, s2 = ckpt.restore(str(tmp_path), optimizer=opt2)
    assert step == 3 and isinstance(s2, sharding.ShardedOptState)
    for _ in range(3):
        opt2.step(p2, s2, {"w": p2["w"] - c})
    assert torch.equal(p2["w"], params["w"])


def test_sharded_checkpoint_refusals(tmp_path, monkeypatch):
    opt, params, state, _c = _shard_grad_run(monkeypatch, 1)
    ckpt.save(str(tmp_path / "sharded"), 1, params, state, optimizer=opt)
    with pytest.raises(ValueError, match="pass optimizer="):
        ckpt.restore(str(tmp_path / "sharded"))
    monkeypatch.setenv("BLUEFOG_SHARD", "0")
    opt_off = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    with pytest.raises(ValueError, match="BLUEFOG_SHARD=1"):
        ckpt.restore(str(tmp_path / "sharded"), optimizer=opt_off)
    state_off = opt_off.init(params)
    ckpt.save(str(tmp_path / "plain"), 1, params, state_off, optimizer=opt_off)
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    opt_on = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    with pytest.raises(ValueError, match="REPLICATED"):
        ckpt.restore(str(tmp_path / "plain"), optimizer=opt_on)
    monkeypatch.setenv("BLUEFOG_SHARD_MASTER", "1")
    opt_m = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.02))
    with pytest.raises(ValueError, match="SHARD_MASTER"):
        ckpt.restore(str(tmp_path / "sharded"), optimizer=opt_m)
