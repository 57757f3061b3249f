# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The fleet samplers across processes (the metrics probe, the doctor, the
staleness lineage, the memory observatory with the elastic ``oom`` fault,
the health plane, the SLO engine and the topology controller), against the
stacked single-process run, on the CPU with gloo.

The harness is ``test_torch_transport_topology.py``'s: every case of
:func:`fleet_cases` runs once in one process (all 8 rows) and once in 2
processes x 4 workers, 4 x 2 and 3 + 5 (``BLUEFOG_LOCAL_WORKERS``), all
jobs started together by a module-scoped fixture, each process under its
own timeout. Every process's rows must equal the same rows of the
one-process run bit for bit, and the samplers' outputs must be the
stacked run's in every process:

- all six samplers at interval 1 (``BLUEFOG_METRICS``, ``_DOCTOR``,
  ``_STALENESS``, ``_MEMORY``, ``_HEALTH``, ``_SLO``) over 4 ATC steps of
  the MLP on the fp32, int8 and int4_ef wires and 2 steps of the tiny
  ResNet on int8: the metrics gauges and per-worker rows, the staleness
  samples, the census, the health lane's fields, the SLO rows and the
  canary's verdict bitwise; the step time (a wall clock, the slowest
  process's) and what is computed from it (the lane's step column and its
  residual, the step-time objective) equal in the processes of a run;
- the doctor on a pinned model with an elastic ``degrade`` of the edge
  2 -> 4, which crosses processes in every layout, and the controller on at
  interval 1: ``degraded_link`` names [2, 4] in every process and the swap
  lands at the stacked run's step, the matrices bitwise;
- the controller on a fed clock: a swap and its rollback at the stacked
  run's steps, the matrices bitwise;
- the ``oom`` fault on rank 5 under int4_ef with staleness and memory: the
  forensics in every process, the ranked census the stacked one;
- the async engine with staleness and health: the ``async`` surface's ages;
- the route calibration installed under ``TRANSPORT_LINK_CLASS``, with
  positive alpha and beta, the same in every process;
- agreement: a sampler switched on in one process only raises
  ``RuntimeError`` in every process at ``bft.init``, without hanging.

One JAX anchor: the health lane's estimates and the staleness ages of a
stalled ring in 2 x 4 against the JAX package's stacked run on its 8
virtual CPU devices (``test_torch_health.py``'s tolerance; the staleness
samples exactly, as ``test_torch_staleness.py`` holds them).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.models import MLP, ResNet50, StackedModel, mlp, resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
JOB_TIMEOUT = 150
SAMPLER_STEPS = 4
SAMPLER_WIRES = ("fp32", "int8", "int4_ef")
SAMPLER_ENV = {"BLUEFOG_METRICS": "1", "BLUEFOG_METRICS_INTERVAL": "1",
               "BLUEFOG_DOCTOR": "1", "BLUEFOG_DOCTOR_INTERVAL": "1",
               "BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
               "BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1",
               "BLUEFOG_HEALTH": "1", "BLUEFOG_HEALTH_INTERVAL": "1",
               "BLUEFOG_SLO": "1", "BLUEFOG_SLO_INTERVAL": "1"}
# the doctor's pinned model without a fault: no round can pass 3 x 1 s
QUIET_PIN = (1.0, 1e12, 0.0)
# with a degrade: a healthy round must stay under 3 x 20 ms, a round across
# the degraded edge pays 380 ms more (factor 0.05)
DEGRADE_PIN = (2e-2, 1e12, 0.0)
DEGRADE = (2, 4, 0.05)  # (rank, peer, factor): crosses processes in every layout
DEGRADE_STEPS = 4  # the controller's verification would need a 5th sample
TRIG = [{"kind": "degraded_link", "source": "doctor", "edge": [2, 4], "ratio": 20.0}]
ROLLBACK_STEPS = 6
OOM_RANK, OOM_STEP = 5, 2
ASYNC_TICKS = 5
STALL = dict(rank=3, step=2, steps=3, peer=4)
ANCHOR_STEPS = 8
# the health lane's field of the step time: a wall clock
STEP_FIELD = 0
# (name, worker counts per process, nodes per machine)
CONFIGS = [("2x4", (4, 4), 4), ("4x2", (2, 2, 2, 2), 2), ("3+5", (3, 5), 1)]


def _mlp(rows):
    sm = StackedModel(mlp.init_flax_like(MLP(12, (16, 4)), 0), len(rows), "cpu")
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(SIZE, 5, 12, generator=gen)
    targets = torch.randint(0, 4, (SIZE, 5), generator=gen)
    return sm, feats[rows].contiguous(), targets[rows].contiguous()


def _tiny_resnet(rows):
    model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                           stage_sizes=[1, 1, 1, 1]), 0)
    sm = StackedModel(model, len(rows), "cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    return sm, images[rows].contiguous(), labels[rows].contiguous()


# the switches _init set, which _close unsets
_SET = []


def _init(level, env=None, pin=None):
    """A fresh context under ``env``, which stays set until :func:`_close`
    (the observatories' switches are read at init, the metrics probe's at
    every step); ``pin`` the doctor's model."""
    from bluefog_tpu_torch.collective import compiler

    os.environ.update(env or {})
    _SET.extend(env or ())
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=level)
    if pin is not None:
        compiler.set_calibration(*pin, source="test", link_class=compiler.TRANSPORT_LINK_CLASS)
    return ctx


def _close():
    from bluefog_tpu_torch.collective import compiler

    bft.elastic.stop()
    bft.shutdown()
    compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
    for k in _SET:
        os.environ.pop(k, None)
    _SET.clear()


def _no_ts(verdict):
    return {k: v for k, v in verdict.items() if k != "ts"}


def _fleet_view():
    """What the samplers report after a run, as plain values."""
    from bluefog_tpu_torch import attribution, health, memory, metrics, slo, staleness

    metrics.flush()  # the pending probe payload, folded
    view = {"gauges": {}, "worker_rows": {}}
    for name in ("disagreement", "param_norm", "grad_norm", "quant_err", "ef_residual"):
        for series in (f"bluefog.gossip.{name}", f"bluefog.gossip.{name}.max"):
            g = metrics.peek(series)
            view["gauges"][series] = None if g is None else g.value
    for name, vals in metrics.last_worker_rows().items():
        view["worker_rows"][name] = np.asarray(vals, np.float64).tolist()
    for name in ("bluefog.wire_bytes", "bluefog.comm_steps", "bluefog.staleness.age_max",
                 "bluefog.staleness.age_mean", "bluefog.health.predicted_rate",
                 "bluefog.health.measured_rate", "bluefog.health.mixing_efficiency",
                 "bluefog.memory.live_bytes"):
        g = metrics.peek(name)
        view["gauges"][name] = None if g is None else g.value
    doc = attribution.active()
    view["doctor"] = None if doc is None else {
        "advisories": [a.to_json() for a in doc.advisories],
        "rounds": [[{k: r[k] for k in ("round", "edges", "predicted_ms")}
                    for r in s.get("rounds", [])] for s in doc.samples],
        "consensus": [s.get("consensus_distance") for s in doc.samples]}
    obs = staleness.active()
    view["staleness"] = None if obs is None else {
        "samples": list(obs.samples), "advisories": [a.to_json() for a in obs.advisories],
        "edge_ages": obs.report()["edge_ages"]}
    mem = memory.active()
    view["memory"] = None if mem is None else {
        "census": {c: rec["bytes"] for c, rec in mem.last_census.items()},
        "ranked": [(r["category"], r["bytes"]) for r in memory.ranked_census()],
        "per_rank": [s["live_bytes_per_rank"] for s in mem.samples],
        "total": [s["live_bytes_total"] for s in mem.samples],
        "reconcile": [s.get("reconcile_rel_err") for s in mem.samples]}
    plane = health.active()
    if plane is None:
        view["health"] = None
    else:
        fleet = plane.fleet or {}
        keep = [i for i in range(len(health.FLEET_FIELDS)) if i != STEP_FIELD]
        view["health"] = {
            "fields": {k: [fleet[k][i] for i in keep] for k in ("mean", "min", "max")}
            if "mean" in fleet else None,
            "step_field": [fleet[k][STEP_FIELD] for k in ("mean", "min", "max")]
            if "mean" in fleet else None,
            "residual": fleet.get("residual"),
            "samples": [{k: s.get(k) for k in ("step", "comm_steps", "consensus",
                                                 "predicted_rate", "measured_rate",
                                                 "mixing_efficiency", "time_to_eps_steps")}
                        for s in plane.samples],
            "advisories": [a.to_json() for a in plane.advisories],
            "healthz": _no_ts(health.healthz_verdict(plane)),
            "async": plane.report().get("async")}
    eng = slo.active()
    view["slo"] = None if eng is None else {
        "rows": [{"step": r["step"], "canary": r.get("canary"),
                  "objectives": {n: o for n, o in r["objectives"].items()
                                 if n not in ("step_time", "mass_residual")},
                  "flags": {n: o["ok"] for n, o in r["objectives"].items()}}
                 for r in eng.samples],
        "alerts": [a.to_json() for a in eng.alerts]}
    return view


# -- the six samplers at interval 1 -------------------------------------------------------


def _samplers(out, level, rows):
    for wire in SAMPLER_WIRES:
        key = f"samplers:{wire}"
        _init(level, SAMPLER_ENV, QUIET_PIN)
        sm, feats, targets = _mlp(rows)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = None if wire == "fp32" else wire
        params = sm.replicate()
        state = opt.init(params)
        for k in range(SAMPLER_STEPS):
            _, grads = sm.loss_and_grad(params, feats, targets)
            opt.step(params, state, grads)
            out[f"{key}:{k}"] = params.clone()
        out[f"{key}:view"] = _fleet_view()
        opt.free()
        _close()
    # the tiny ResNet through the fused train step
    _init(level, SAMPLER_ENV, QUIET_PIN)
    sm, images, labels = _tiny_resnet(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int8"
    params = sm.replicate()
    state = opt.init(params)
    step = opt.make_train_step(sm.worker_loss)
    for k in range(2):
        params, state, _loss = step(params, state, images, labels, torch.arange(len(rows)))
        out[f"samplers:resnet:{k}"] = params.clone()
    out["samplers:resnet:view"] = _fleet_view()
    opt.free()
    _close()


# -- the doctor and the controller ----------------------------------------------------------


def _degrade(out, level, rows):
    """Doctor and controller at interval 1 through the optimizer's hook, an
    elastic degrade of the crossing edge 2 -> 4."""
    from bluefog_tpu_torch import attribution, autotune

    ctx = _init(level, {"BLUEFOG_DOCTOR": "1", "BLUEFOG_DOCTOR_INTERVAL": "1",
                        "BLUEFOG_AUTOTUNE": "1", "BLUEFOG_AUTOTUNE_INTERVAL": "1"},
                DEGRADE_PIN)
    session = bft.elastic.start(policy="average")
    session.inject("degrade", rank=DEGRADE[0], step=0, factor=DEGRADE[2], peer=DEGRADE[1])
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int8"
    guard = bft.elastic.guard(opt)
    params = sm.replicate()
    state = opt.init(params)
    for k in range(DEGRADE_STEPS):
        _, grads = sm.loss_and_grad(params, feats, targets)
        guard.step(params, state, grads)
        out[f"degrade:{k}"] = params.clone()
        out[f"degrade:matrix:{k}"] = torch.from_numpy(np.array(ctx.load_topology()))
    tuner = autotune.active()
    out["degrade:host"] = {
        "advisories": [(a.kind, a.step, a.detail.get("edge"))
                       for a in attribution.active().advisories],
        "decisions": [(d.action, d.step, d.chosen, d.blamed) for d in tuner.decisions],
        "stale": session.stale_dispatches}
    opt.free()
    _close()


def _rollback(out, level, rows):
    """``test_torch_autotune.py``'s rollback on a fed clock: a controller
    fed after every step with 10 ms before its swap and 50 ms after, the
    triggers ``TRIG``; no session, so the rollback restores Exp(8)."""
    from bluefog_tpu_torch import autotune

    ctx = _init(level)
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int8"
    params = sm.replicate()
    state = opt.init(params)
    tuner = autotune.TopologyAutotuner(interval=1, cooldown=4)
    for k in range(ROLLBACK_STEPS):
        _, grads = sm.loss_and_grad(params, feats, targets)
        opt.step(params, state, grads)
        tuner.observe(ctx, step=k, optimizer=opt, step_s=0.01 if tuner.swaps == 0 else 0.05,
                      triggers=list(TRIG))
        out[f"rollback:{k}"] = params.clone()
        out[f"rollback:matrix:{k}"] = torch.from_numpy(np.array(ctx.load_topology()))
    out["rollback:host"] = {
        "decisions": [(d.action, d.step, d.chosen, d.blamed) for d in tuner.decisions],
        "verdicts": [v["verdict"] for v in tuner.verifications],
        "swaps": tuner.swaps, "rollbacks": tuner.rollbacks}
    opt.free()
    _close()


# -- the oom fault ------------------------------------------------------------------------


def _oom(out, level, rows):
    from bluefog_tpu_torch import memory

    _init(level, {"BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
                  "BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1"})
    session = bft.elastic.start(policy="average")
    session.inject("oom", rank=OOM_RANK, step=OOM_STEP)
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int4_ef"
    guard = bft.elastic.guard(opt)
    params = sm.replicate()
    state = opt.init(params)
    raised = []
    for k in range(4):
        _, grads = sm.loss_and_grad(params, feats, targets)
        try:
            guard.step(params, state, grads)
        except memory.SimulatedResourceExhausted as e:
            raised.append((k, str(e)))
            out["oom:forensics"] = {"ranked": [(r["category"], r["bytes"])
                                               for r in memory.ranked_census()],
                                    "events": memory.active().oom_events}
            guard.step(params, state, grads)  # the fault is consumed: the retry runs
        out[f"oom:{k}"] = params.clone()
    out["oom:raised"] = raised
    out["oom:view"] = _fleet_view()
    opt.free()
    _close()


# -- the async surface --------------------------------------------------------------------


def _async(out, level, rows):
    from bluefog_tpu_torch import windows as win_mod

    ctx = _init(level, {"BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
                        "BLUEFOG_HEALTH": "1", "BLUEFOG_HEALTH_INTERVAL": "1"})
    bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    params = sm.replicate()
    state = opt.init(params)
    step = bft.make_async_train_step(opt, sm.worker_loss, cadence={6: 3}, max_age=1,
                                     policy="drop", wire="int8")
    for k in range(ASYNC_TICKS):
        params, state, _loss = step(params, state, feats, targets)
        out[f"async:{k}"] = params.clone()
    out["async:p"] = win_mod._get_win(ctx, step.engine._name).p.clone()
    out["async:view"] = _fleet_view()
    step.engine.free()
    _close()


# -- the route calibration and agreement --------------------------------------------------


def _calibration(out, level):
    from bluefog_tpu_torch.collective import compiler

    _init(level)
    cal = compiler.calibrate(small_elems=512, large_elems=1 << 14, steps=2, windows=1)
    out["calibration"] = {k: cal[k] for k in ("alpha_s", "beta_bytes_per_s", "pipeline_eff",
                                              "source", "link_class")}
    out["calibration"]["processes"] = cal.get("probe_processes", 1)
    out["calibration"]["installed"] = compiler.calibration(compiler.TRANSPORT_LINK_CLASS) == cal
    _close()


def _agreement(out, level, ctx):
    """``BLUEFOG_DOCTOR=1`` in process 0 only."""
    if ctx.process_count == 1:
        return
    env = {"BLUEFOG_DOCTOR": "1"} if ctx.process_index == 0 else {}
    try:
        _init(level, env)
        out["agree:one_sided"] = "no error"
    except RuntimeError as e:
        out["agree:one_sided"] = str(e)
    _close()


# -- the JAX anchor's inputs --------------------------------------------------------------


def _lane_values():
    w = topo.mixing_matrix(topo.ExponentialTwoGraph(SIZE))
    w[0, 1] *= 2.0
    from bluefog_tpu_torch import health

    return w, np.random.RandomState(3).randn(SIZE, len(health.FLEET_FIELDS)) * 5.0


def _anchor(out, level, rows):
    """The health lane (12 applications on a weighted Exp2) and the
    staleness samples of ``test_torch_staleness.py``'s consensus problem on
    the ring under a stall of the crossing edge 3 -> 4."""
    from bluefog_tpu_torch import health, staleness

    ctx = _init(level)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    w, vals = _lane_values()
    rep = health.fleet_aggregate(ctx, vals, rounds=12, w=w)
    out["anchor:lane"] = {k: rep[k] for k in ("mean", "min", "max", "residual", "live")}
    bft.set_topology(topo.RingGraph(SIZE))
    session = bft.elastic.start()
    session.inject("stall", **STALL)
    obs = staleness.start(interval=1, bound=2)
    z0 = np.random.RandomState(0).randn(SIZE, 600).astype(np.float32)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.01))
    guard = bft.elastic.guard(opt)
    p = torch.from_numpy(z0[rows].copy())
    s = opt.init(p)
    g = torch.zeros_like(p)
    for _ in range(ANCHOR_STEPS):
        p, s = guard.step(p, s, g)
    out["anchor:stall"] = {"samples": list(obs.samples),
                           "advisories": [a.to_json() for a in obs.advisories]}
    out["anchor:stall:params"] = p.clone()
    _close()


def fleet_cases(nodes_per_machine):
    """Every case on the active process level: ``{name: this process's
    rows}`` (all rows with one process) and the samplers' outputs. The
    doctor's ambient anchor, a wall-clock throughput, reads a fixed 1
    TFLOP/s here, so a busy host cannot fire ``ambient_drift`` in one run
    and not in another (the value still goes through the agreement)."""
    from bluefog_tpu_torch import attribution

    attribution.StepDoctor._anchor_tflops = lambda self: 1.0
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=nodes_per_machine)
    rows = list(ctx.rows)
    out = {"rows": torch.tensor(rows), "process_count": ctx.process_count}
    bft.shutdown()
    _samplers(out, nodes_per_machine, rows)
    _degrade(out, nodes_per_machine, rows)
    _rollback(out, nodes_per_machine, rows)
    _oom(out, nodes_per_machine, rows)
    _async(out, nodes_per_machine, rows)
    _calibration(out, nodes_per_machine)
    _anchor(out, nodes_per_machine, rows)
    _agreement(out, nodes_per_machine, ctx)
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=nodes_per_machine)
    bft.barrier()
    bft.shutdown()
    return out


WORKER = """
import os, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
import test_torch_transport_fleet as T
pid = int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
out = T.fleet_cases({level!r})
torch.save(out, os.path.join({outdir!r}, f"rows_{{pid}}.pt"))
print("MP_OK", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BLUEFOG_") and k not in ("XLA_FLAGS",)}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _start(tmp, name, counts, level):
    outdir = tmp / name
    outdir.mkdir()
    script = outdir / "worker.py"
    script.write_text(WORKER.format(tests=os.path.join(REPO, "tests"), level=level,
                                    outdir=str(outdir)))
    port = _free_port()
    procs = []
    for pid, n_local in enumerate(counts):
        extra = {} if len(counts) == 1 else dict(
            BLUEFOG_COORDINATOR=f"127.0.0.1:{port}", BLUEFOG_NUM_PROCESSES=str(len(counts)),
            BLUEFOG_PROCESS_ID=str(pid), BLUEFOG_NUM_WORKERS=str(SIZE),
            BLUEFOG_LOCAL_WORKERS=str(n_local))
        procs.append(subprocess.Popen([sys.executable, str(script)], cwd=str(outdir),
                                      env=_child_env(extra), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return outdir, procs


def _finish(name, outdir, procs):
    results = []
    deadline = time.monotonic() + JOB_TIMEOUT
    for pid, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{name}: process {pid} passed its {JOB_TIMEOUT} s timeout")
        assert p.returncode == 0 and "MP_OK" in so, f"{name} process {pid}:\n{so}\n{se[-4000:]}"
        results.append(torch.load(outdir / f"rows_{pid}.pt", weights_only=False))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ref": stacked results, config: [per-process results]}``: the
    one-process reference (machines of 4 workers) and every configuration,
    started together."""
    tmp = tmp_path_factory.mktemp("transport_fleet")
    jobs = {"ref": _start(tmp, "ref", (SIZE,), CONFIGS[0][2])}
    for name, counts, level in CONFIGS:
        jobs[name] = _start(tmp, name, counts, level)
    got = {name: _finish(name, *job) for name, job in jobs.items()}
    got["ref"] = got["ref"][0]
    return got


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _same(got, want) -> bool:
    return got.shape == want.shape and torch.equal(_bits(got), _bits(want))


def _check_rows(runs, config, base):
    """Every tensor case ``base:...`` bitwise the stacked rows."""
    ref = runs["ref"]
    keys = sorted(k for k, v in ref.items() if k.startswith(base + ":")
                  and isinstance(v, torch.Tensor) and ":matrix:" not in k)
    assert keys, base
    for p, res in enumerate(runs[config]):
        for key in keys:
            assert _same(res[key], ref[key][res["rows"]]), f"{config} process {p}: {key}"


def _configs():
    return [c[0] for c in CONFIGS]


# -- the samplers -------------------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", list(SAMPLER_WIRES) + ["resnet"])
def test_sampled_steps_bitwise_the_stacked_rows(runs, config, wire):
    """All six samplers on at interval 1: "on" is still the stacked rows,
    bit for bit, in every process."""
    _check_rows(runs, config, f"samplers:{wire}")


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", list(SAMPLER_WIRES) + ["resnet"])
@pytest.mark.parametrize("part", ["gauges", "worker_rows", "staleness", "memory"])
def test_sampler_outputs_equal_the_stacked_run(runs, config, wire, part):
    """The metrics gauges and per-worker rows (the gathered probe's fold),
    the staleness samples and the census bitwise the stacked run's in
    every process."""
    want = runs["ref"][f"samplers:{wire}:view"][part]
    assert want, part
    for p, res in enumerate(runs[config]):
        assert res[f"samplers:{wire}:view"][part] == want, (config, p, part)


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", list(SAMPLER_WIRES) + ["resnet"])
def test_metrics_probe_replays_the_wire(runs, config, wire):
    """The quantized wires publish the replay's error (and the EF tiers
    the residual), positive, as in the stacked run; fp32 neither."""
    gauges = runs[config][0][f"samplers:{wire}:view"]["gauges"]
    if wire == "fp32":
        assert gauges["bluefog.gossip.quant_err"] is None or runs["ref"][
            "samplers:fp32:view"]["gauges"]["bluefog.gossip.quant_err"] == \
            gauges["bluefog.gossip.quant_err"]
    else:
        assert gauges["bluefog.gossip.quant_err"] > 0
    if wire == "int4_ef":
        assert gauges["bluefog.gossip.ef_residual"] > 0
    assert len(runs[config][0][f"samplers:{wire}:view"]["worker_rows"][
        "bluefog.gossip.disagreement"]) == SIZE


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", list(SAMPLER_WIRES) + ["resnet"])
def test_health_lane_and_verdict_equal_the_stacked_run(runs, config, wire):
    """The lane's fields bitwise the stacked run's but the step time (a
    wall clock), which with the residual is equal in every process of a
    run; the samples, advisories and ``/healthz`` verdict the stacked
    run's."""
    want = runs["ref"][f"samplers:{wire}:view"]["health"]
    assert want["fields"] is not None and len(want["samples"]) == (
        2 if wire == "resnet" else SAMPLER_STEPS)
    views = [res[f"samplers:{wire}:view"]["health"] for res in runs[config]]
    for p, got in enumerate(views):
        for k in ("fields", "samples", "advisories", "healthz"):
            assert got[k] == want[k], (config, p, k)
        assert got["step_field"] == views[0]["step_field"], (config, p)
        assert got["residual"] == views[0]["residual"], (config, p)


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", list(SAMPLER_WIRES) + ["resnet"])
def test_slo_rows_and_canary_equal_the_stacked_run(runs, config, wire):
    """The SLO rows (objectives but the wall-clock ones, every objective's
    flag), the canary's verdict on every sample and the alerts equal the
    stacked run's in every process; the canary passes."""
    want = runs["ref"][f"samplers:{wire}:view"]["slo"]
    canaries = [r["canary"] for r in want["rows"]]
    assert canaries and all(c is not None and c["ok"] for c in canaries)
    for p, res in enumerate(runs[config]):
        assert res[f"samplers:{wire}:view"]["slo"] == want, (config, p)


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", list(SAMPLER_WIRES) + ["resnet"])
def test_doctor_samples_agree_without_a_fault(runs, config, wire):
    """No advisory on the quiet pin; the priced rounds and the consensus
    distance each sample reads equal the stacked run's."""
    want = runs["ref"][f"samplers:{wire}:view"]["doctor"]
    assert want["advisories"] == [] and all(want["rounds"])
    for p, res in enumerate(runs[config]):
        assert res[f"samplers:{wire}:view"]["doctor"] == want, (config, p)


# -- the doctor and the controller ----------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
def test_crossing_degraded_edge_named_and_swapped_as_stacked(runs, config):
    """``degraded_link`` on exactly [2, 4] (a crossing edge in every
    layout), one swap at the stacked run's step, no stale dispatch; the
    rows and the installed matrices after every step bitwise."""
    _check_rows(runs, config, "degrade")
    ref = runs["ref"]["degrade:host"]
    edges = {tuple(e) for kind, _s, e in ref["advisories"] if kind == "degraded_link"}
    assert edges == {(2, 4)}, ref["advisories"]
    assert [d[0] for d in ref["decisions"]].count("swap") == 1 and ref["stale"] == 0
    for k in range(DEGRADE_STEPS):
        want = runs["ref"][f"degrade:matrix:{k}"]
        for p, res in enumerate(runs[config]):
            assert _same(res[f"degrade:matrix:{k}"], want), (config, p, k)
    for p, res in enumerate(runs[config]):
        assert res["degrade:host"] == ref, (config, p)


@pytest.mark.parametrize("config", _configs())
def test_swap_and_rollback_at_the_stacked_steps(runs, config):
    _check_rows(runs, config, "rollback")
    ref = runs["ref"]["rollback:host"]
    assert (ref["swaps"], ref["rollbacks"]) == (1, 1) and ref["verdicts"] == ["regressed"]
    first, last = (runs["ref"][f"rollback:matrix:{k}"] for k in (0, ROLLBACK_STEPS - 1))
    assert _same(last, first)  # the rollback restored the matrix of before the swap
    assert not _same(runs["ref"]["rollback:matrix:1"], first)
    for p, res in enumerate(runs[config]):
        assert res["rollback:host"] == ref, (config, p)
        for k in range(ROLLBACK_STEPS):
            assert _same(res[f"rollback:matrix:{k}"], runs["ref"][f"rollback:matrix:{k}"]), \
                (config, p, k)


# -- the oom fault, the async surface ------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
def test_oom_forensics_in_every_process(runs, config):
    """The fault on rank 5 (another process's row but in 3 + 5) raises at
    its step in every process; the ranked census of the forensics is the
    stacked one; the rows, the ages and the census bitwise."""
    _check_rows(runs, config, "oom")
    ref = runs["ref"]
    assert [k for k, _msg in ref["oom:raised"]] == [OOM_STEP]
    assert ref["oom:forensics"]["events"] == 1 and ref["oom:forensics"]["ranked"]
    for p, res in enumerate(runs[config]):
        assert res["oom:raised"] == ref["oom:raised"], (config, p)
        assert res["oom:forensics"] == ref["oom:forensics"], (config, p)
        for part in ("staleness", "memory"):
            assert res["oom:view"][part] == ref["oom:view"][part], (config, p, part)


@pytest.mark.parametrize("config", _configs())
def test_async_surface_ages_equal_the_stacked_run(runs, config):
    _check_rows(runs, config, "async")
    want = runs["ref"]["async:view"]
    surfaces = {s["surface"] for s in want["staleness"]["samples"]}
    assert surfaces == {"async"} and max(s["age_max"] for s in want["staleness"]["samples"]) >= 1
    for p, res in enumerate(runs[config]):
        got = res["async:view"]
        assert got["staleness"] == want["staleness"], (config, p)
        assert got["health"]["async"] == want["health"]["async"], (config, p)
        assert got["health"]["healthz"] == want["health"]["healthz"], (config, p)


# -- calibration and agreement --------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
def test_route_calibration_installed_and_agreed(runs, config):
    cals = [res["calibration"] for res in runs[config]]
    for p, cal in enumerate(cals):
        assert cal["alpha_s"] > 0 and cal["beta_bytes_per_s"] > 0, (config, p, cal)
        assert cal["source"] == "measured-probe" and cal["link_class"] == "stacked"
        assert cal["installed"] and cal["processes"] == len(cals)
        assert cal == cals[0], (config, p)


@pytest.mark.parametrize("config", _configs())
def test_sampler_on_in_one_process_raises_everywhere(runs, config):
    for p, res in enumerate(runs[config]):
        msg = res["agree:one_sided"]
        assert msg.startswith("bft.init: the fleet samplers' switches: the processes "
                              "disagree"), (config, p, msg)


# -- the JAX anchor -----------------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
def test_anchor_cases_equal_the_stacked_run(runs, config):
    _check_rows(runs, config, "anchor:stall")
    for p, res in enumerate(runs[config]):
        assert res["anchor:lane"] == runs["ref"]["anchor:lane"], (config, p)
        assert res["anchor:stall"] == runs["ref"]["anchor:stall"], (config, p)


def test_lane_and_ages_in_two_processes_match_the_jax_package(runs, cpu_devices, monkeypatch):
    """The health lane in 2 x 4 within 1e-6 of the largest value of JAX's
    stacked lane, the extrema the f32 values'; the staleness samples and
    the ``staleness_breach`` advisory of the stalled crossing edge exactly
    JAX's."""
    import optax

    import bluefog_tpu as bf
    from bluefog_tpu import health as jhealth
    from bluefog_tpu import staleness as jstaleness
    from bluefog_tpu import topology as jtu

    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    w, vals = _lane_values()
    bf.init(devices=cpu_devices[:SIZE])
    try:
        bf.set_topology(jtu.ExponentialTwoGraph(SIZE))
        want = jhealth.fleet_aggregate(bf.get_context(), vals, rounds=12, w=w)
        bf.set_topology(jtu.RingGraph(SIZE))
        session = bf.elastic.start()
        session.inject("stall", **STALL)
        jobs = jstaleness.start(interval=1, bound=2)
        z0 = np.random.RandomState(0).randn(SIZE, 600).astype(np.float32)
        jopt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.01))
        guard = bf.elastic.guard(jopt)
        jp = {"w": bf.worker_values(lambda r: z0[r])}
        js = jopt.init(jp)
        jg = {"w": bf.worker_values(lambda r: np.zeros(600, np.float32))}
        for _ in range(ANCHOR_STEPS):
            jp, js = guard.step(jp, js, jg)
        jsamples = list(jobs.samples)
        jadv = [a.to_json() for a in jobs.advisories]
        jparams = np.asarray(jp["w"])
    finally:
        jstaleness.stop()
        bf.elastic.stop()
        bf.shutdown()
    scale = np.abs(vals).max()
    for res in runs["2x4"]:
        lane = res["anchor:lane"]
        for key in ("mean", "min", "max"):
            np.testing.assert_allclose(lane[key], want[key], rtol=0, atol=1e-6 * scale)
        assert lane["live"] == want["live"]
        assert res["anchor:stall"]["samples"] == jsamples
        assert res["anchor:stall"]["advisories"] == jadv
    assert any(a["edges"] == [[3, 4]] for a in jadv)
    got = np.concatenate([res["anchor:stall:params"].numpy() for res in runs["2x4"]])
    np.testing.assert_allclose(got, jparams, rtol=0, atol=1e-6 * np.abs(jparams).max())
