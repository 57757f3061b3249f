# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's metrics (``bluefog_tpu_torch.metrics``) against the JAX
package's (``tests/test_metrics.py``), same numpy inputs through both.

References and tolerances:

- the registry, its quantiles and the Prometheus text: equal to JAX's for
  the same registry contents (the text byte for byte);
- the ``bluefog.gossip.*`` and ``bluefog.allgather.*`` gauges: JAX's
  optimizer on its 8-device CPU mesh (the composite wire,
  ``BLUEFOG_WIRE_KERNELS=0``) fed the same inputs, within 1e-6 relative;
  the consensus distance also against the numpy oracle of the JAX test;
- counters (plan-cache hits and misses, rounds and wire bytes, window ops,
  the asynchronous engine's ticks, local steps, drops and advisories):
  their deltas over the same call sequence equal JAX's exactly;
- metrics on against metrics off: the parameters and the optimizer state
  bitwise equal, for every order x wire of the JAX test, ``make_train_step``
  (delayed too) and the gradient allreduce;
- the probe's output bitwise the first columns of the full combine's.
"""

import json
import math

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu import topology as tu
from bluefog_tpu.collective import compiler as jcompiler
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import metrics, topology as ttu
from bluefog_tpu_torch.collective import compiler as tcompiler
from bluefog_tpu_torch.optimizers import tree_leaves

SIZE = 8
GOSSIP = "bluefog.gossip."


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    for env in ("BLUEFOG_METRICS", "BLUEFOG_METRICS_FILE", "BLUEFOG_METRICS_PROM",
                "BLUEFOG_METRICS_INTERVAL", "BLUEFOG_PLAN_METHOD"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    jmetrics.reset()
    metrics.reset()
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    bf.set_topology(tu.ExponentialTwoGraph(SIZE))
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))
    yield
    bf.shutdown()
    bft.shutdown()
    jmetrics.reset()
    metrics.reset()


def _rel(got, want, rtol=1e-6):
    assert math.isclose(got, want, rel_tol=rtol, abs_tol=1e-30), (got, want)


def _gauges(snap, prefix=GOSSIP):
    return {k: v["value"] for k, v in snap.items() if k.startswith(prefix)}


# -- the host registry ----------------------------------------------------------------


def _fill(m):
    m.counter("c").inc()
    m.counter("c").inc(2.5)
    m.counter("bluefog.stalls").inc()
    m.gauge("g").set(7)
    m.gauge("bluefog.gossip.disagreement").set(float("nan"))
    m.gauge("weird-name.9").set(float("inf"))
    h = m.histogram("h")
    for v in (1.0, 3.0, 2.0, 0.0, 1e-3, 250.0, 17.5):
        h.observe(v)
    m.histogram("empty")


def test_registry_matches_jax():
    _fill(metrics)
    _fill(jmetrics)
    # json spells NaN and Infinity alike on both sides
    assert json.dumps(metrics.snapshot(), sort_keys=True) == json.dumps(jmetrics.snapshot(),
                                                                        sort_keys=True)
    snap = metrics.snapshot()
    assert snap["c"] == {"type": "counter", "value": 3.5}
    assert snap["h"]["count"] == 7 and snap["h"]["min"] == 0.0 and snap["h"]["max"] == 250.0
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        assert metrics.histogram("h").quantile(q) == jmetrics.histogram("h").quantile(q)
    assert metrics.histogram("empty").quantile(0.5) is None


def test_prom_lines_equal_jax(tmp_path):
    _fill(metrics)
    _fill(jmetrics)
    assert metrics.prom_lines() == jmetrics.prom_lines()
    path = str(tmp_path / "m.prom")
    assert metrics.export_prom(path) == path
    text = open(path).read()
    assert text == "\n".join(jmetrics.prom_lines()) + "\n"
    assert "bluefog_gossip_disagreement NaN" in text and "weird_name_9 +Inf" in text


def test_registry_rejects_type_conflict():
    metrics.counter("series")
    with pytest.raises(TypeError):
        metrics.gauge("series")
    assert metrics.peek("absent") is None and "absent" not in metrics.snapshot()


def test_facade_snapshot_and_export(tmp_path):
    bft.get_context()
    metrics.counter("bluefog.wire_bytes").inc(10)
    path = str(tmp_path / "m.jsonl")
    snap = bft.metrics_export(jsonl_path=path)
    assert snap == bft.metrics_snapshot()
    line = json.loads(open(path).read())
    assert line["metrics"]["bluefog.wire_bytes"]["value"] == 10
    assert snap["bluefog.size"]["value"] == SIZE and snap["bluefog.machine_size"]["value"] == 1


def test_unknown_log_level_warns_once(monkeypatch, caplog):
    from bluefog_tpu_torch import logging_util

    monkeypatch.setenv("BLUEFOG_LOG_LEVEL", "chatty-nonsense")
    bft.logger.propagate = True
    try:
        with caplog.at_level("WARNING", logger="bluefog_tpu_torch"):
            logging_util._configure_from_env()
            logging_util._configure_from_env()
    finally:
        bft.logger.propagate = False
        monkeypatch.delenv("BLUEFOG_LOG_LEVEL")
        logging_util._configure_from_env()
    warns = [r for r in caplog.records if "BLUEFOG_LOG_LEVEL" in r.message]
    assert len(warns) == 1 and "chatty-nonsense" in warns[0].getMessage()


def test_log_helpers_match_jax(monkeypatch):
    from bluefog_tpu import logging_util as jlog
    from bluefog_tpu_torch import logging_util as tlog

    obj = {"a": [1.0, float("nan"), {"b": float("-inf")}], "c": 2}
    assert tlog.json_safe(obj) == jlog.json_safe(obj)
    monkeypatch.setenv("BLUEFOG_X_FLOAT", "2.5")
    assert tlog.env_float("BLUEFOG_X_FLOAT", 1.0) == jlog.env_float("BLUEFOG_X_FLOAT", 1.0) == 2.5
    monkeypatch.setenv("BLUEFOG_X_FLOAT", "nope")
    with pytest.warns(UserWarning, match="BLUEFOG_X_FLOAT"):
        assert tlog.env_float("BLUEFOG_X_FLOAT", 1.5) == 1.5
    bft.set_log_level("debug")
    assert bft.logger.level == 10
    bft.set_log_level("warn")
    with pytest.raises(ValueError):
        bft.set_log_level("chatty")


# -- the device tier against JAX --------------------------------------------------------


def _opt_pair(factory, jfactory_kw=None, lr=0.1, momentum=None, compression=None):
    jopt = getattr(bf, factory)(optax.sgd(lr, momentum=momentum), **(jfactory_kw or {}))
    topt = getattr(bft, factory)(bft.sgd(lr, momentum=momentum))
    jopt.compression = topt.compression = compression
    return jopt, topt


def _one_step_each(c, wire, lr=0.1, grad=None):
    jopt, topt = _opt_pair("DistributedNeighborAllreduceOptimizer", lr=lr, compression=wire)
    g = np.zeros_like(c) if grad is None else grad
    jp = {"w": bf.worker_values(list(c))}
    jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(g)})
    tp = {"w": torch.from_numpy(c.copy())}
    topt.step(tp, topt.init(tp), {"w": torch.from_numpy(g.copy())})
    jmetrics.flush()
    metrics.flush()
    return jmetrics.snapshot(), metrics.snapshot()


def test_disagreement_matches_numpy_oracle_and_jax(cpu_devices, monkeypatch):
    """The consensus distance on the JAX test's weighted 4-node digraph:
    the drained gauges equal ``rms_i ||x_i - sum_j W[j, i] x_j||``."""
    import networkx as nx

    n = 4
    w = np.zeros((n, n))
    np.fill_diagonal(w, [0.5, 0.6, 0.4, 0.7])
    w[0, 1], w[1, 2], w[2, 3], w[3, 0], w[0, 2] = 0.4, 0.35, 0.3, 0.5, 0.25
    bf.init(devices=cpu_devices[:n])
    bf.set_topology(nx.from_numpy_array(w, create_using=nx.DiGraph), is_weighted=True)
    bft.init(size=n, device="cpu")
    bft.set_topology(w, is_weighted=True)
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    x = np.random.RandomState(7).randn(n, 5).astype(np.float32)
    want, got = _one_step_each(x, None, lr=0.0)
    per_worker = np.linalg.norm(x - w.T @ x, axis=1)
    _rel(got[GOSSIP + "disagreement"]["value"], per_worker.mean(), 1e-5)
    _rel(got[GOSSIP + "disagreement.max"]["value"], per_worker.max(), 1e-5)
    _rel(got[GOSSIP + "param_norm"]["value"], np.linalg.norm(x, axis=1).mean(), 1e-5)
    jg, tg = _gauges(want), _gauges(got)
    assert set(tg) == set(jg)
    for k in jg:
        _rel(tg[k], jg[k])


@pytest.mark.parametrize("wire", ["int8", "int8_ef", "int4", "int4_ef", "bf16"])
def test_wire_gauges_match_jax(wire, monkeypatch):
    """quant_err and ef_residual (the CHOCO identity: this step's
    quantization error is the new residual) with every other gossip gauge,
    against JAX's."""
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    c = np.random.RandomState(0).randn(SIZE, 600).astype(np.float32)
    g = np.random.RandomState(1).randn(SIZE, 600).astype(np.float32)
    want, got = _one_step_each(c, wire, grad=g)
    jg, tg = _gauges(want), _gauges(got)
    assert set(tg) == set(jg) and GOSSIP + "quant_err" in tg
    for k in jg:
        _rel(tg[k], jg[k])
    assert tg[GOSSIP + "quant_err"] > 0
    if wire.endswith("_ef"):
        assert tg[GOSSIP + "quant_err"] == tg[GOSSIP + "ef_residual"]


def test_sampled_prefix_gauges_match_jax(monkeypatch):
    """A payload above ``BLUEFOG_METRICS_SAMPLE_ELEMS``: the 512-aligned
    prefix of a two-leaf group, scaled to the whole group."""
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_SAMPLE_ELEMS", "1100")
    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(SIZE, 700).astype(np.float32),
            "b": rng.randn(SIZE, 9, 100).astype(np.float32)}
    for wire in ("int4_ef", None):
        jmetrics.reset()
        metrics.reset()
        jopt, topt = _opt_pair("DistributedAdaptThenCombineOptimizer", compression=wire,
                               momentum=0.9)
        jp = {k: bf.worker_values(list(v)) for k, v in tree.items()}
        jopt.step(jp, jopt.init(jp), {k: jnp.asarray(v * 0.5) for k, v in tree.items()})
        tp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        topt.step(tp, topt.init(tp), {k: torch.from_numpy(v * 0.5) for k, v in tree.items()})
        jmetrics.flush()
        metrics.flush()
        jg, tg = _gauges(jmetrics.snapshot()), _gauges(metrics.snapshot())
        assert set(tg) == set(jg)
        for k in jg:
            _rel(tg[k], jg[k])
        sub, y, scale, _ef = topt._last_probe[0]
        assert sub.shape == (SIZE, 1024) and scale == 1600 / 1024


def test_int4_probe_matches_host_replay(monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    c = np.random.RandomState(5).randn(SIZE, 600).astype(np.float32)
    _want, got = _one_step_each(c, "int4", lr=0.0)
    per_worker = [np.sqrt(((c[w] - jmetrics._np_chunk_quantize4(c[w])) ** 2).sum())
                  for w in range(SIZE)]
    _rel(got[GOSSIP + "quant_err"]["value"], float(np.mean(per_worker)), 1e-5)


@pytest.mark.parametrize("wire", ["int8", "int4", "bf16"])
def test_allgather_wire_telemetry_matches_jax(wire, monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    x = np.random.RandomState(6).randn(SIZE, 600).astype(np.float32)
    bft.neighbor_allgather(bft.worker_values(list(x)))
    assert "bluefog.allgather.quant_err" not in metrics.snapshot()
    bf.neighbor_allgather(x, compression=wire)
    bft.neighbor_allgather(bft.worker_values(list(x)), compression=wire)
    want, got = jmetrics.snapshot(), metrics.snapshot()
    for k in ("bluefog.allgather.quant_err", "bluefog.allgather.quant_err.max"):
        _rel(got[k]["value"], want[k]["value"])
    assert got["bluefog.allgather.wire_bytes"] == want["bluefog.allgather.wire_bytes"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wire", ["int8", "int4", "bf16"])
def test_allgather_wire_counter_is_the_plan_wire_bytes(wire, dtype, monkeypatch):
    """The facade's ``bluefog.allgather.wire_bytes`` goes through
    ``CommPlan.wire_bytes``: one call adds the plan's rounds times one
    round's wire payload, as the JAX facade's counter does."""
    from bluefog_tpu_torch.scaling import wire_payload_bytes

    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    x = torch.from_numpy(np.random.RandomState(7).randn(SIZE, 600).astype(np.float32)).to(dtype)
    before = metrics.counter("bluefog.allgather.wire_bytes").value
    bft.neighbor_allgather(x, compression=wire)
    added = metrics.counter("bluefog.allgather.wire_bytes").value - before
    plan = bft.get_context().static_plan()
    assert added == plan.wire_bytes(600, x.element_size(), wire=wire)
    assert added == len(plan.rounds) * wire_payload_bytes(600, x.element_size(), wire)


# -- counters: deltas equal to JAX's --------------------------------------------------


def _counts(m, names):
    snap = m.snapshot()
    return {k: snap.get(k, {}).get("value", 0.0) for k in names}


def test_plan_cache_counts_match_jax():
    names = ("bluefog.plan_cache.hits", "bluefog.plan_cache.misses")
    jcompiler.clear_compile_cache()
    tcompiler.clear_compile_cache()
    j0, t0 = _counts(jmetrics, names), _counts(metrics, names)
    edges = tuple((i, (i + 1) % SIZE) for i in range(SIZE))
    for comp in (jcompiler, tcompiler):
        comp.compile_edges(edges, SIZE)
        comp.compile_edges(edges, SIZE)
        comp.compile_edges(edges, SIZE, method="coloring")
    for api, topo in ((bf, tu), (bft, ttu)):
        api.set_topology(topo.RingGraph(SIZE))
        x = api.worker_values(np.arange(SIZE, dtype=np.float32))
        api.neighbor_allreduce(x)
        api.neighbor_allreduce(x)
        api.neighbor_allreduce(x, self_weight=0.5,
                               src_weights=[{(r - 1) % SIZE: 0.5} for r in range(SIZE)])
        api.neighbor_allreduce(x, self_weight=0.5,
                               src_weights=[{(r - 1) % SIZE: 0.5} for r in range(SIZE)])
    j1, t1 = _counts(jmetrics, names), _counts(metrics, names)
    jd = {k: j1[k] - j0[k] for k in names}
    td = {k: t1[k] - t0[k] for k in names}
    assert td == jd and td["bluefog.plan_cache.misses"] >= 2
    tcompiler.clear_compile_cache()
    assert not tcompiler._COMPILE_CACHE


@pytest.mark.parametrize("wire", [None, "int8", "int4_ef", "bf16"])
def test_wire_bytes_and_rounds_match_jax(wire, monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "5")
    c = np.random.RandomState(0).randn(SIZE, 256).astype(np.float32)
    jopt, topt = _opt_pair("DistributedNeighborAllreduceOptimizer", compression=wire)
    jp = {"w": bf.worker_values(list(c))}
    js = jopt.init(jp)
    tp = {"w": torch.from_numpy(c.copy())}
    ts = topt.init(tp)
    for _ in range(3):
        jp, js = jopt.step(jp, js, {"w": jnp.zeros_like(jp["w"])})
        topt.step(tp, ts, {"w": torch.zeros_like(tp["w"])})
    names = ("bluefog.gossip.rounds", "bluefog.wire_bytes", "bluefog.comm_steps")
    assert _counts(metrics, names) == _counts(jmetrics, names)
    assert _counts(metrics, names)["bluefog.gossip.rounds"] == 3.0


def test_gradient_allreduce_accounting_matches_jax(monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    tree = {"w": np.random.RandomState(1).randn(SIZE, 40).astype(np.float32)}
    jopt, topt = _opt_pair("DistributedGradientAllreduceOptimizer")
    jp = {"w": bf.worker_values(list(tree["w"]))}
    jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(tree["w"])})
    tp = {"w": torch.from_numpy(tree["w"].copy())}
    topt.step(tp, topt.init(tp), {"w": torch.from_numpy(tree["w"].copy())})
    jmetrics.flush()
    metrics.flush()
    names = ("bluefog.gossip.rounds", "bluefog.wire_bytes", "bluefog.comm_steps")
    assert _counts(metrics, names) == _counts(jmetrics, names)
    jg, tg = _gauges(jmetrics.snapshot()), _gauges(metrics.snapshot())
    for k in jg:
        if k != GOSSIP + "rounds":
            _rel(tg[k], jg[k])


def test_window_op_counts_match_jax():
    x = np.random.RandomState(2).randn(SIZE, 3).astype(np.float32)
    for api in (bf, bft):
        api.win_create(api.worker_values(list(x)), "mwin")
        api.win_put(name="mwin")
        api.win_accumulate(name="mwin")
        api.win_get(name="mwin")
        api.win_update(name="mwin")
        api.win_update_then_collect(name="mwin")
        api.win_free("mwin")
    want = {k: v for k, v in jmetrics.snapshot().items() if k.startswith("bluefog.window")}
    got = {k: v for k, v in metrics.snapshot().items() if k.startswith("bluefog.window")}
    assert got == want and got["bluefog.window_ops.update"]["value"] == 2


def test_async_counters_match_jax_on_the_ring_straggler():
    bf.set_topology(tu.RingGraph(SIZE, connect_style=1))
    bft.set_topology(ttu.RingGraph(SIZE, connect_style=1))
    z0 = np.random.RandomState(0).randn(SIZE, 5).astype(np.float32)
    jopt, topt = _opt_pair("DistributedNeighborAllreduceOptimizer", lr=0.1)
    kw = dict(cadence={6: 5}, max_age=2, policy="drop")
    jstep = bf.make_async_train_step(jopt, lambda p, t: 0.5 * jnp.sum((p["w"] - t) ** 2), **kw)
    tstep = bft.make_async_train_step(topt, lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2),
                                      **kw)
    jp, tp = {"w": jnp.asarray(z0)}, {"w": torch.from_numpy(z0.copy())}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(12):
        jp, js, _ = jstep(jp, js, jnp.asarray(z0))
        tp, ts, _ = tstep(tp, ts, torch.from_numpy(z0))
    want = {k: v for k, v in jmetrics.snapshot().items()
            if k.startswith(("bluefog.async", "bluefog.doctor"))}
    got = {k: v for k, v in metrics.snapshot().items()
           if k.startswith(("bluefog.async", "bluefog.doctor"))}
    assert got == want
    summary = tstep.engine.summary()
    assert got["bluefog.async.ticks"]["value"] == summary["ticks"] == 12
    assert got["bluefog.async.local_steps"]["value"] == summary["local_steps"]
    assert got["bluefog.async.stale_drops"]["value"] == summary["stale_drops"] > 0
    assert got["bluefog.doctor.advisory.async_staleness"]["value"] == summary["advisories"]
    bf.win_free()


# -- metrics on gives the bits of metrics off ---------------------------------------------

FACTORIES = {
    "cta": "DistributedNeighborAllreduceOptimizer",
    "atc": "DistributedAdaptThenCombineOptimizer",
    "grad": "DistributedGradientAllreduceOptimizer",
}


def _run(order, wire, enabled, c, monkeypatch, fused=False, delayed=False, interval=2):
    monkeypatch.setenv("BLUEFOG_METRICS", "1" if enabled else "0")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", str(interval))
    opt = getattr(bft, FACTORIES[order])(bft.sgd(0.1, momentum=0.9))
    opt.compression = wire
    p = {"w": torch.from_numpy(c.copy()), "b": torch.from_numpy(c[:, :37] * 0.5)}
    s = opt.init(p)
    target = torch.from_numpy(c)
    if fused:
        step = opt.make_train_step(
            lambda pp, cv: 0.5 * torch.sum((pp["w"] - cv) ** 2) + torch.sum(pp["b"] ** 2),
            delayed=delayed)
        for _ in range(3):
            p, s, _loss = step(p, s, target)
    else:
        for _ in range(3):
            opt.step(p, s, {"w": p["w"] - target, "b": p["b"].clone()})
    metrics.flush()
    return tree_leaves((p, s)) + ([t for pair in opt._ef for t in pair] if opt._ef else [])


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)


@pytest.mark.parametrize("order", ["cta", "atc"])
@pytest.mark.parametrize("wire", [None, "int8", "int8_ef", "int4", "int4_ef", "bf16"])
def test_metrics_on_off_bitwise_identical(order, wire, monkeypatch):
    c = np.random.RandomState(1).randn(SIZE, 700).astype(np.float32)
    off = _run(order, wire, False, c, monkeypatch)
    on = _run(order, wire, True, c, monkeypatch, interval=1)
    _bitwise(off, on)
    assert metrics.snapshot()[GOSSIP + "disagreement"]["value"] > 0


@pytest.mark.parametrize("case", ["cta", "atc/int8", "atc/int4_ef", "grad", "delayed cta/int8",
                                  "delayed atc"])
def test_metrics_on_off_bitwise_identical_fused(case, monkeypatch):
    delayed = case.startswith("delayed ")
    order, _, wire = case.replace("delayed ", "").partition("/")
    c = np.random.RandomState(2).randn(SIZE, 300).astype(np.float32)
    off = _run(order, wire or None, False, c, monkeypatch, fused=True, delayed=delayed)
    on = _run(order, wire or None, True, c, monkeypatch, fused=True, delayed=delayed,
              interval=1)
    _bitwise(off, on)
    assert GOSSIP + "grad_norm" in metrics.snapshot()


@pytest.mark.parametrize("wire", [None, "int8", "int4", "int8_ef", "int4_ef"])
def test_probe_output_is_the_restriction_of_the_full_combine(wire, monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_SAMPLE_ELEMS", "1024")
    c = np.random.RandomState(3).randn(SIZE, 3000).astype(np.float32)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    opt.compression = wire
    p = {"w": torch.from_numpy(c.copy())}
    s = opt.init(p)
    for _ in range(2):
        ef_before = [t.clone() for pair in opt._ef for t in pair] if opt._ef else []
        opt.step(p, s, {"w": torch.from_numpy(c * 0.1)})
        sub, y, scale, _ef = opt._last_probe[0]
        assert scale == 3000 / 1024
        assert torch.equal(y.view(torch.int32), p["w"][:, :1024].contiguous().view(torch.int32))
        if ef_before:  # the probe worked on copies; the combine moved the live ones
            assert not torch.equal(ef_before[0], opt._ef[0][0])


def test_metrics_drain_interval(monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "3")
    c = np.random.RandomState(3).randn(SIZE, 8).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    p = {"w": torch.from_numpy(c.copy())}
    s = opt.init(p)
    for _ in range(2):
        opt.step(p, s, {"w": torch.zeros_like(p["w"])})
    assert GOSSIP + "disagreement" not in metrics.snapshot()
    for _ in range(4):  # steps 3..6: a sample at 3, its fold at the sample at 6
        opt.step(p, s, {"w": torch.zeros_like(p["w"])})
    snap = metrics.snapshot()
    assert snap[GOSSIP + "disagreement"]["value"] > 0
    assert snap["bluefog.comm_steps"]["value"] == 6.0


def test_jsonl_auto_export_on_drain(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    path = str(tmp_path / "auto.jsonl")
    monkeypatch.setenv("BLUEFOG_METRICS_FILE", path)
    c = np.random.RandomState(4).randn(SIZE, 8).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    p = {"w": torch.from_numpy(c.copy())}
    s = opt.init(p)
    for _ in range(3):
        opt.step(p, s, {"w": torch.zeros_like(p["w"])})
    lines = [json.loads(l) for l in open(path).read().splitlines()]
    assert len(lines) == 2 and all(GOSSIP + "disagreement" in l["metrics"] for l in lines)
    bft.metrics_export()
    assert len(open(path).read().splitlines()) == 3
    bft.shutdown()  # shutdown flushes and exports once more
    assert len(open(path).read().splitlines()) == 4


def test_shard_gauges_match_jax(monkeypatch):
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    monkeypatch.setenv("BLUEFOG_SHARD", "1")
    monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1")
    w = np.random.RandomState(5).randn(SIZE, 1300).astype(np.float32)
    jopt = bf.DistributedGradientAllreduceOptimizer(optax.adam(1e-2))
    topt = bft.DistributedGradientAllreduceOptimizer(bft.adam(1e-2))
    jp = {"w": bf.worker_values(list(w))}
    jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(w)})
    tp = {"w": torch.from_numpy(w.copy())}
    topt.step(tp, topt.init(tp), {"w": torch.from_numpy(w.copy())})
    pick = lambda m: {k: v for k, v in m.snapshot().items()  # noqa: E731
                      if k.startswith("bluefog.shard") or k in ("bluefog.wire_bytes",
                                                               "bluefog.gossip.rounds")}
    assert pick(metrics) == pick(jmetrics) and pick(metrics)["bluefog.shard.grads"]["value"] == 1


def test_watchdog_stall_counts_and_marks_timeline(tmp_path):
    import time

    from bluefog_tpu_torch import watchdog

    path = str(tmp_path / "stall_trace.json")
    assert bft.timeline_init(path)
    watchdog.set_stall_timeout(0.1)
    before = metrics.counter("bluefog.stalls").value
    try:
        with watchdog.watch("metrics-test-op"):
            time.sleep(0.5)
    finally:
        watchdog.set_stall_timeout(60)
        assert bft.timeline_shutdown()
    assert metrics.counter("bluefog.stalls").value == before + 1
    stalls = [e for e in json.load(open(path)) if e.get("ph") == "i" and e["cat"] == "STALL"]
    assert stalls and "metrics-test-op" in stalls[0]["name"]
