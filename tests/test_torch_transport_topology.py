# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Federation, relay plans and elastic sessions across processes, against
the stacked single-process run, on the CPU with gloo.

The harness is ``test_torch_transport_state.py``'s: every case of
:func:`topology_cases` runs once in one process (all 8 rows) and once in 2
processes x 4 workers, 4 x 2 and 3 + 5 (``BLUEFOG_LOCAL_WORKERS``), all
jobs started together by a module-scoped fixture, each process under its
own timeout, and each process's rows must equal the same rows of the
one-process run bit for bit:

- federation: ``BLUEFOG_PODS`` as ``2``, ``4`` and ``0-2,3-7`` (a pod per
  process in 4 x 2 and 3 + 5, pods straddling processes or several in one
  elsewhere) on the fp32, int8 and int4 DCN wires, 4 ATC steps of the MLP
  at DCN period 2; the bytes of every step (the intra plan's edges from
  local to remote rows times ``wire_payload_bytes`` of the optimizer's
  wire, plus the gateway plan's on a DCN step on the DCN wire) and the
  ``bluefog.federation.*`` counters of both kinds of step;
- relay plans (``BLUEFOG_PLAN_METHOD=shortcut``) on Exp2(8), the ring and
  Exp2 on a declared ``BLUEFOG_TORUS_DIMS=2,4``, on the exact, bf16, int8
  and int4 wires: the facade's ``neighbor_allreduce``, its bytes (the
  hops from local to remote rows times the payload), 3 ATC steps of the
  MLP and ``neighbor_allgather``; in 4 x 2 every message goes to a
  ring-adjacent process; the pure-transit NaN case; the EF refusal;
- elastic sessions: a kill on fp32, int8 and int4_ef (then a rejoin
  through ``consensus_restore`` and one more step) with each step's bytes
  (the repaired plan's crossing edges), a deadline stall, a rank-granular
  degrade, the push-sum repair, the zero2/int8 re-shard, the async
  re-window (the tiny ResNet), the kill of a federation gateway (rank 4
  under ``BLUEFOG_PODS=2`` gives way to 5; the fabric against the JAX
  package's ``repaired_matrix`` and ``inter_plan`` for the live set, the
  fp32 steps against a float64 replay), and a checkpoint with a dead
  rank: each layout's file equals the stacked one, each process restores
  the stacked run's file and takes the next step as the stacked run does,
  and this test process restores the 2 x 4 file in one process;
- agreement (several processes only): a watchdog verdict filed in one
  process is applied in all of them at the next dispatch; a fault
  injected in one process only raises the agreement ``RuntimeError`` in
  every process, without hanging.

Two JAX anchors: the federated ATC int8 run in 2 x 4 against the JAX
package's stacked federated run on its 8 virtual CPU devices
(``test_torch_federation.py``'s tolerance), and the fp32 kill trajectory
in 2 x 4 against JAX's (``test_torch_elastic.py``'s).
"""

import contextlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import federation
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import inner, transport
from bluefog_tpu_torch.models import MLP, ResNet50, StackedModel, mlp, resnet
from bluefog_tpu_torch.scaling import wire_payload_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
N_ELEMS = 1500  # not a multiple of 512: the padded paths
JOB_TIMEOUT = 140
FED_STEPS = 4
FED_PODS = ("2", "4", "0-2,3-7")
# DCN wire -> (the optimizer's intra-pod wire, BLUEFOG_DCN_WIRE)
FED_WIRES = {"fp32": (None, "exact"), "int8": ("int8", "int8"), "int4": ("int8", "int4")}
RELAY_GRAPHS = ("exp2", "ring", "torus")
RELAY_WIRES = ("fp32", "bf16", "int8", "int4")
RELAY_STEPS = 3
KILL, KILL_STEP, KILL_STEPS = 5, 2, 4
KILL_WIRES = ("fp32", "int8", "int4_ef")
# the gateway kill's wires: name -> (the optimizer's intra-pod wire, BLUEFOG_DCN_WIRE)
GATEWAY_WIRES = {"int8": ("int8", "int8"), "fp32": (None, "exact")}
GATEWAY_TOL = 1e-6  # of the largest value: a fp32 step against the float64 replay
CKPT_WAIT = 120  # seconds a process waits for the stacked run's checkpoint
ANCHOR_STEPS = 24
# (name, worker counts per process, nodes per machine)
CONFIGS = [("2x4", (4, 4), 4), ("4x2", (2, 2, 2, 2), 2), ("3+5", (3, 5), 1)]


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items() if v is not None})
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def _crossing(ctx, perms):
    """The pairs of ``perms`` (edges, or a relay plan's hops) from a local
    to a remote row, summed over the rounds."""
    rows = ctx.rows
    return sum(1 for perm in perms for s, d in perm if s in rows and d not in rows)


def _bytes_of(fn):
    transport.reset_stats()
    fn()
    return transport.stats()["bytes"]


def _sgd_steps(opt, sm, params, state, feats, targets, steps, each=None, step_fn=None):
    """``steps`` two-program steps; ``each(k, bytes)`` after step ``k``."""
    step_fn = opt.step if step_fn is None else step_fn
    for k in range(steps):
        _, grads = sm.loss_and_grad(params, feats, targets)
        sent = _bytes_of(lambda: step_fn(params, state, grads))
        if each is not None:
            each(k, sent)
    return params


# -- federation ---------------------------------------------------------------------------


def _federation(out, ctx, rows):
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    for pods in FED_PODS:
        for name, (wire, dcn) in FED_WIRES.items():
            key = f"fed:{pods}:{name}"
            with _env(BLUEFOG_PODS=pods, BLUEFOG_DCN_PERIOD="2", BLUEFOG_DCN_WIRE=dcn):
                fab = federation.get_fabric(SIZE)
                sm, feats, targets = _mlp(rows)
                opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
                opt.compression = wire
                params = sm.replicate()
                state = opt.init(params)
                ici = _crossing(ctx, fab.intra.perms) * wire_payload_bytes(sm.width, 4, wire)
                dcn_b = _crossing(ctx, fab.inter.perms) * wire_payload_bytes(sm.width, 4,
                                                                            fab.wire)
                got = []

                def each(k, sent):
                    got.append((sent, ici + (dcn_b if fab.dcn_step(k) else 0)))
                    out[f"{key}:{k}"] = params.clone()

                _sgd_steps(opt, sm, params, state, feats, targets, FED_STEPS, each)
                out[f"{key}:bytes"] = got
                out[f"{key}:gateways"] = list(fab.layout.gateways())
                opt.free()
    # the per-leg counters of an ICI-only and a DCN step's dispatch
    from bluefog_tpu_torch import metrics

    with _env(BLUEFOG_PODS="2", BLUEFOG_DCN_PERIOD="2", BLUEFOG_DCN_WIRE="int4"):
        sm, _f, _t = _mlp(rows)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
        opt.compression = "int8"
        params = sm.replicate()
        counts = []
        for comm in (0, 1):
            opt._comm_count = comm
            d = opt._resolve_dispatch(ctx, params, True)
            before = {n: metrics.counter(f"bluefog.federation.{n}").value
                      for n in ("ici_wire_bytes", "dcn_wire_bytes")}
            opt._record_comm_accounting(d, params, ctx)
            counts.append((d.key[:2], {n: metrics.counter(f"bluefog.federation.{n}").value
                                       - v for n, v in before.items()}))
        out["fed:counters"] = counts
        out["fed:wire_summary"] = federation.wire_summary(
            federation.get_fabric(SIZE).layout, sm.width, 4, "int8")


def _fed_anchor(out, rows):
    """``test_torch_federation.py::_fed_run``'s inputs: ATC sgd(0.1) on the
    int8 wire, ``BLUEFOG_PODS=2``, period 2, the int4 DCN wire."""
    rng = np.random.RandomState(0)
    x = (rng.randn(SIZE, 1500) * 5).astype(np.float32)
    gs = [rng.randn(SIZE, 1500).astype(np.float32) for _ in range(FED_STEPS)]
    with _env(BLUEFOG_PODS="2", BLUEFOG_DCN_PERIOD="2", BLUEFOG_DCN_WIRE=None):
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
        opt.compression = "int8"
        p = {"w": torch.from_numpy(x[rows].copy())}
        s = opt.init(p)
        for g in gs:
            opt.step(p, s, {"w": torch.from_numpy(g[rows].copy())})
        out["anchor:fed"] = p["w"].clone()


# -- relay plans --------------------------------------------------------------------------


def _relay_env(graph):
    return dict(BLUEFOG_PLAN_METHOD="shortcut",
                BLUEFOG_TORUS_DIMS="2,4" if graph == "torus" else None)


def _relay(out, ctx, rows):
    rng = np.random.RandomState(0)
    x = bft.worker_values(list(rng.randn(SIZE, N_ELEMS).astype(np.float32)))
    for graph in RELAY_GRAPHS:
        make = topo.RingGraph if graph == "ring" else topo.ExponentialTwoGraph
        with _env(**_relay_env(graph)):
            bft.set_topology(make(SIZE), is_weighted=True)
            plan = ctx.static_plan()
            assert plan.relay
            rt = transport.relay_route(plan)
            out[f"relay:{graph}:messages"] = {
                "peers": sorted({q for _r, q, _rows in rt.sends}),
                "hop_rows": int(sum(len(r) for _r, _q, r in rt.sends)),
                "rounds": len(plan.perms)}
            for wire in RELAY_WIRES:
                w = None if wire == "fp32" else wire
                key = f"relay:{graph}:{wire}"
                box = {}
                sent = _bytes_of(lambda: box.update(y=bft.neighbor_allreduce(x, compression=w)))
                out[key] = box["y"]
                out[f"{key}:bytes"] = (sent, _crossing(ctx, plan.perms)
                                       * wire_payload_bytes(N_ELEMS, 4, w))
                sm, feats, targets = _mlp(rows)
                opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
                opt.compression = w
                params = sm.replicate()
                out[f"{key}:steps"] = _sgd_steps(opt, sm, params, opt.init(params), feats,
                                                 targets, RELAY_STEPS)
                opt.free()
            for wire in (None, "int8"):
                vals, mask = inner.neighbor_allgather(x, plan, wire=wire)
                out[f"relay:{graph}:allgather:{wire}"] = vals
                out[f"relay:{graph}:allgather:{wire}:mask"] = mask
    with _env(**_relay_env("exp2")):
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        plan = ctx.static_plan()
        xn = np.random.RandomState(0).randn(SIZE, 64).astype(np.float32)
        xn[4, 3] = np.nan
        out["relay:nan"] = inner.weighted_combine(bft.worker_values(list(xn)), plan)
        sm, feats, targets = _mlp(rows)
        for wire in ("int8_ef", "int4_ef"):
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = wire
            params = sm.replicate()
            try:
                _sgd_steps(opt, sm, params, opt.init(params), feats, targets, 1)
                out[f"relay:refused:{wire}"] = "no error"
            except ValueError as e:
                out[f"relay:refused:{wire}"] = str(e)
            opt.free()
    # the tiny ResNet on the relay's int8 wire, through make_train_step
    with _env(**_relay_env("exp2")):
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        sm, images, labels = _tiny_resnet(rows)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int8"
        params = sm.replicate()
        state = opt.init(params)
        step = opt.make_train_step(sm.worker_loss)
        for _ in range(2):
            params, state, _loss = step(params, state, images, labels, torch.arange(len(rows)))
        out["relay:resnet:int8"] = params.clone()
        opt.free()


# -- elastic ------------------------------------------------------------------------------


def _records(session):
    return {"repairs": [(r.step, r.dead, r.detected, r.live, r.epoch, r.policy)
                        for r in session.repairs],
            "stale": session.stale_dispatches, "live": session.membership.live_ranks(),
            "epoch": session.membership.epoch}


def _kill_run(out, ctx, rows, wire, key, ckpt=None):
    """Rank ``KILL`` killed at step ``KILL_STEP`` of ``KILL_STEPS`` ATC
    steps of the MLP, then rejoined (``consensus_restore``) and one more
    step; with ``ckpt`` a checkpoint after step 3."""
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start(policy="average")
    session.inject("kill", rank=KILL, step=KILL_STEP)
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = None if wire == "fp32" else wire
    guard = bft.elastic.guard(opt)
    params = sm.replicate()
    state = opt.init(params)
    sent = []

    def each(k, nbytes):
        plan = ctx.static_plan()
        sent.append((nbytes, _crossing(ctx, plan.perms)
                     * wire_payload_bytes(sm.width, 4, opt.compression)))
        out[f"{key}:{k}"] = params.clone()
        if ckpt is not None and k == 2:
            bft.checkpoint.save(ckpt, k + 1, params, state, optimizer=opt)

    _sgd_steps(opt, sm, params, state, feats, targets, KILL_STEPS, each, guard.step)
    params = session.rejoin(KILL, params=params, optimizer=opt)
    out[f"{key}:rejoined"] = params.clone()
    _sgd_steps(opt, sm, params, state, feats, targets, 1, each, guard.step)
    out[f"{key}:bytes"] = sent
    out[f"{key}:record"] = _records(session)
    opt.free()
    bft.elastic.stop()


def _elastic(out, ctx, rows, ref_dir):
    mine = os.path.abspath("ckpt")
    for wire in KILL_WIRES:
        _kill_run(out, ctx, rows, wire, f"kill:{wire}",
                  ckpt=os.path.join(mine, "elastic") if wire == "int8" else None)
    # a stall past the liveness deadline is condemned like a kill; a
    # rank-granular degrade re-weights
    for name, fault in (("stall", dict(kind="stall", rank=3, step=1, seconds=5.0)),
                        ("degrade", dict(kind="degrade", rank=2, step=1, factor=0.5))):
        bft.set_topology(topo.ExponentialTwoGraph(SIZE))
        session = bft.elastic.start(policy="average", liveness_timeout_s=1.0)
        session.inject(**fault)
        sm, feats, targets = _mlp(rows)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int8"
        params = sm.replicate()
        out[f"{name}:params"] = _sgd_steps(opt, sm, params, opt.init(params), feats, targets,
                                           3, step_fn=bft.elastic.guard(opt).step)
        out[f"{name}:record"] = _records(session)
        out[f"{name}:matrix"] = torch.from_numpy(np.asarray(ctx.load_topology()))
        opt.free()
        bft.elastic.stop()
    _pushsum_repair(out, ctx)
    _zero_reshard(out, ctx, rows)
    _async_rewindow(out, ctx, rows)
    _gateway_kill(out, ctx, rows)
    _kill_anchor(out, ctx, rows)
    _checkpoint(out, ctx, rows, ref_dir)


def _pushsum_repair(out, ctx):
    """``test_torch_elastic.py::test_kill_pushsum_mass_corrected_consensus``
    at 8 steps: rank 2 killed at step 4 under push-sum."""
    from bluefog_tpu_torch import windows as win_mod

    x0 = np.random.RandomState(3).randn(SIZE, 64).astype(np.float32)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=4)
    opt = bft.DistributedPushSumOptimizer(bft.sgd(0.0))
    guard = bft.elastic.guard(opt)
    state = opt.init({"w": bft.worker_values(list(x0))})
    grads = {"w": torch.zeros(ctx.n_local, 64)}
    for _ in range(8):
        guard.step(state, grads)
    win = win_mod._get_win(ctx, opt._name)
    out["pushsum:value"] = win.value.clone()
    out["pushsum:p"] = win.p.clone()
    out["pushsum:estimate"] = opt.params()["w"].clone()
    out["pushsum:record"] = _records(session)
    out["pushsum:weights"] = (opt.dst_weights, opt.self_weight)
    opt.free()
    bft.elastic.stop()
    bft.turn_off_win_ops_with_associated_p()


def _zero_reshard(out, ctx, rows):
    """zero2/int8 under ``adam``: rank 6 killed at step 2 of 4, so the
    slots move between the processes."""
    from bluefog_tpu_torch.optimizers import tree_leaves

    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start()
    session.inject("kill", rank=6, step=2)
    with _env(BLUEFOG_SHARD="1", BLUEFOG_SHARD_GRADS="1"):
        sm, feats, targets = _mlp(rows)
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(1e-3))
        opt.compression = "int8"
        params = sm.replicate()
        state = opt.init(params)
        _sgd_steps(opt, sm, params, state, feats, targets, 4, step_fn=bft.elastic.guard(opt).step)
        out["zero:params"] = params.clone()
        out["zero:state"] = [leaf.clone() for leaf in tree_leaves(state)]
        out["zero:host"] = {"reshards": opt._shard_reshards, "live": opt._shard_layout.live,
                            **_records(session)}
        opt.free()
    bft.elastic.stop()


def _async_rewindow(out, ctx, rows):
    """The async engine on the ring (rank 6 at period 3), rank 2 killed at
    tick 2 of 4 on the int8 wire: a re-window."""
    from bluefog_tpu_torch import windows as win_mod

    bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
    session = bft.elastic.start()
    session.inject("kill", rank=2, step=2)
    sm, images, labels = _tiny_resnet(rows)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    params = sm.replicate()
    state = opt.init(params)
    step = bft.make_async_train_step(opt, sm.worker_loss, cadence={6: 3}, max_age=1,
                                     policy="drop", wire="int8", buffers=sm.buffers)
    for _ in range(4):
        params, state, _loss = step(params, state, images, labels, torch.arange(len(rows)))
    eng = step.engine
    win = win_mod._get_win(ctx, eng._name)
    out["async:estimate"] = params.clone()
    out["async:value"] = win.value.clone()
    out["async:p"] = win.p.clone()
    out["async:host"] = {"rewindows": eng._rewindows, "summary": eng.summary(),
                         **_records(session)}
    eng.free()
    bft.elastic.stop()


def _gateway_kill(out, ctx, rows):
    """``BLUEFOG_PODS=2`` at DCN period 1: rank 4, pod 1's gateway, killed
    at step 1 of 3; rank 5 takes its place in every process. On each wire
    of ``GATEWAY_WIRES``: each step's input and gradient, the final rows,
    each step's bytes, and the fabric the step ran (the live set, the
    gateways read from the inter plan's pairs, both legs' matrices)."""
    for name, (wire, dcn) in GATEWAY_WIRES.items():
        key = f"gateway:{name}"
        bft.set_topology(topo.ExponentialTwoGraph(SIZE))
        session = bft.elastic.start()
        session.inject("kill", rank=4, step=1)
        with _env(BLUEFOG_PODS="2", BLUEFOG_DCN_PERIOD="1", BLUEFOG_DCN_WIRE=dcn):
            sm, feats, targets = _mlp(rows)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
            opt.compression = wire
            params = sm.replicate()
            state = opt.init(params)
            step = bft.elastic.guard(opt).step
            xs, gs, fabrics, sent = [], [], [], []
            for _k in range(3):
                _, grads = sm.loss_and_grad(params, feats, targets)
                xs.append(params.clone())
                gs.append(grads.clone())
                nbytes = _bytes_of(lambda: step(params, state, grads))
                fab = federation.get_fabric(SIZE)
                fabrics.append({
                    "live": list(session.membership.live_ranks()),
                    "gateways": sorted({r for perm in fab.inter.perms for pair in perm
                                        for r in pair}),
                    "intra": fab.intra.weight_matrix().tolist(),
                    "inter": fab.inter.weight_matrix().tolist()})
                sent.append((nbytes, _crossing(ctx, fab.intra.perms)
                             * wire_payload_bytes(sm.width, 4, wire)
                             + _crossing(ctx, fab.inter.perms)
                             * wire_payload_bytes(sm.width, 4, fab.wire)))
            out[f"{key}:x"], out[f"{key}:g"] = xs, gs
            out[f"{key}:params"] = params.clone()
            out[f"{key}:host"] = {"fabrics": fabrics, **_records(session)}
            out[f"{key}:bytes"] = sent
            opt.free()
        bft.elastic.stop()


def _kill_data(seed=42, steps=ANCHOR_STEPS, dim=1536):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(SIZE, dim).astype(np.float32)
    return x0, [rng.randn(SIZE, dim).astype(np.float32) for _ in range(steps)]


def _kill_anchor(out, ctx, rows):
    """``test_torch_elastic.py::_port_kill_run``'s atc fp32 run: Exp2,
    rank 3 killed at step 5, ``sgd(0.05)``, 24 steps."""
    x0, grads = _kill_data()
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start(policy="average")
    session.inject("kill", rank=3, step=5)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
    guard = bft.elastic.guard(opt)
    params = {"w": torch.from_numpy(x0[rows].copy())}
    state = opt.init(params)
    for g in grads:
        params, state = guard.step(params, state, {"w": torch.from_numpy(g[rows].copy())})
    out["anchor:kill"] = params["w"].clone()
    out["anchor:kill:record"] = _records(session)
    opt.free()
    bft.elastic.stop()


def _restore_step(rows, path):
    """Restore the elastic int8 run's checkpoint under a fresh session (no
    faults: it adopts the saved live set) and take one step."""
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start(policy="average")
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int8"
    params = sm.replicate()
    state = opt.init(params)
    _step, params, state = bft.checkpoint.restore(path, optimizer=opt)
    live = session.membership.live_ranks()
    _sgd_steps(opt, sm, params, state, feats, targets, 1, step_fn=bft.elastic.guard(opt).step)
    opt.free()
    bft.elastic.stop()
    return params.clone(), live


def _checkpoint(out, ctx, rows, ref_dir):
    if ctx.process_count == 1:
        open(os.path.join(os.path.abspath("ckpt"), "ready"), "w").close()
    else:
        marker = os.path.join(ref_dir, "ready")
        deadline = time.monotonic() + CKPT_WAIT
        while not os.path.exists(marker):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the stacked run wrote no checkpoint to {ref_dir}")
            time.sleep(0.2)
    out["ckpt:next"], out["ckpt:live"] = _restore_step(rows, os.path.join(ref_dir, "elastic"))


# -- agreement ----------------------------------------------------------------------------


def _agreement(out, ctx, rows):
    """A watchdog verdict filed in process 0 only (one process: the same
    call), then a fault injected in process 0 only (several processes)."""
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start(liveness_timeout_s=1.0)
    sm, feats, targets = _mlp(rows)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    guard = bft.elastic.guard(opt)
    params = sm.replicate()
    state = opt.init(params)
    _sgd_steps(opt, sm, params, state, feats, targets, 1, step_fn=guard.step)
    if ctx.process_index == 0:
        session._on_stall("test wait", 5.0)
    _sgd_steps(opt, sm, params, state, feats, targets, 1, step_fn=guard.step)
    out["agree:verdict"] = {"states": [session.membership.state(r).value for r in range(SIZE)],
                            "epoch": session.membership.epoch,
                            "live": session.membership.live_ranks()}
    out["agree:verdict:params"] = params.clone()
    opt.free()
    bft.elastic.stop()
    if ctx.process_count == 1:
        return
    session = bft.elastic.start()
    if ctx.process_index == 0:
        session.inject("kill", rank=KILL, step=1)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    params = sm.replicate()
    try:
        _sgd_steps(opt, sm, params, opt.init(params), feats, targets, 3,
                   step_fn=bft.elastic.guard(opt).step)
        out["agree:one_sided"] = "no error"
    except RuntimeError as e:
        out["agree:one_sided"] = str(e)
    opt.free()
    bft.elastic.stop()


def topology_cases(nodes_per_machine, ref_dir):
    """Every case on the active process level: ``{name: this process's
    rows}`` (all rows with one process), the host-side records and the
    byte counts."""
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=nodes_per_machine)
    rows = list(ctx.rows)
    os.makedirs("ckpt", exist_ok=True)
    out = {"rows": torch.tensor(rows)}
    _federation(out, ctx, rows)
    _fed_anchor(out, rows)
    _relay(out, ctx, rows)
    _elastic(out, ctx, rows, ref_dir)
    _agreement(out, ctx, rows)  # last: a one-sided fault leaves the topologies apart
    bft.barrier()
    bft.shutdown()
    return out


WORKER = """
import os, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
import test_torch_transport_topology as T
pid = int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
out = T.topology_cases({level!r}, {ref_dir!r})
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


def _start(tmp, name, counts, level, ref_dir):
    outdir = tmp / name
    outdir.mkdir()
    script = outdir / "worker.py"
    script.write_text(WORKER.format(tests=os.path.join(REPO, "tests"), level=level,
                                    ref_dir=str(ref_dir), outdir=str(outdir)))
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
    """``{"ref": stacked results, config: [per-process results], "dirs":
    {job: its directory}}``: the one-process reference (with the machines
    of 4 workers) and every configuration, started together."""
    tmp = tmp_path_factory.mktemp("transport_topology")
    ref_dir = tmp / "ref" / "ckpt"
    jobs = {"ref": _start(tmp, "ref", (SIZE,), CONFIGS[0][2], ref_dir)}
    for name, counts, level in CONFIGS:
        jobs[name] = _start(tmp, name, counts, level, ref_dir)
    got = {name: _finish(name, *job) for name, job in jobs.items()}
    got["ref"] = got["ref"][0]
    got["dirs"] = {name: job[0] for name, job in jobs.items()}
    return got


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _same(got, want) -> bool:
    return got.shape == want.shape and torch.equal(_bits(got), _bits(want))


def _check_rows(runs, config, base, exclude=()):
    """Every tensor case ``base`` and ``base:...`` bitwise the stacked
    rows (a list of tensors: each)."""
    ref = runs["ref"]
    keys = sorted(k for k, v in ref.items() if (k == base or k.startswith(base + ":"))
                  and isinstance(v, (torch.Tensor, list)) and k not in exclude)
    keys = [k for k in keys if isinstance(ref[k], torch.Tensor)
            or all(isinstance(t, torch.Tensor) for t in ref[k])]
    assert keys, base
    for p, res in enumerate(runs[config]):
        rows = res["rows"]
        for key in keys:
            want = ref[key]
            if isinstance(want, torch.Tensor):
                assert _same(res[key], want[rows]), f"{config} process {p}: {key}"
            else:
                for i, (g, w) in enumerate(zip(res[key], want)):
                    assert _same(g, w[rows]), f"{config} process {p}: {key}[{i}]"


def _configs():
    return [c[0] for c in CONFIGS]


# -- federation ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("pods", FED_PODS)
@pytest.mark.parametrize("wire", list(FED_WIRES))
def test_federated_steps_bitwise_the_stacked_rows(runs, config, pods, wire):
    key = f"fed:{pods}:{wire}"
    _check_rows(runs, config, key)
    for p, res in enumerate(runs[config]):
        assert res[f"{key}:gateways"] == runs["ref"][f"{key}:gateways"], p


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("pods", FED_PODS)
@pytest.mark.parametrize("wire", list(FED_WIRES))
def test_federated_bytes_equal_the_leg_formula(runs, config, pods, wire):
    """Each step hands ``isend`` the intra plan's crossing edges on the
    optimizer's wire, plus on a DCN step (0 and 2) the gateway plan's on
    the DCN wire; with a pod per process an ICI-only step sends nothing."""
    key = f"fed:{pods}:{wire}:bytes"
    per_pod = (config, pods) in (("2x4", "2"), ("4x2", "4"), ("3+5", "0-2,3-7"))
    for p, res in enumerate(runs[config]):
        for k, (sent, want) in enumerate(res[key]):
            assert sent == want, (config, p, k, sent, want)
            if per_pod and k % 2:
                assert sent == 0, (config, p, k)
    assert all(sent == 0 for sent, _ in runs["ref"][key])


@pytest.mark.parametrize("config", _configs())
def test_federation_counters_keep_their_stacked_values(runs, config):
    """The ``bluefog.federation.*`` counters model the fabric's links:
    every process counts what the stacked run counts, for an ICI-only and
    a DCN step."""
    ref = runs["ref"]
    assert [k for k, _ in ref["fed:counters"]] == [("fed", "dcn"), ("fed", "ici")]
    assert ref["fed:counters"][0][1]["dcn_wire_bytes"] > 0
    for p, res in enumerate(runs[config]):
        assert res["fed:counters"] == ref["fed:counters"], p
        assert res["fed:wire_summary"] == ref["fed:wire_summary"], p


# -- relay plans --------------------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("graph", RELAY_GRAPHS)
@pytest.mark.parametrize("wire", RELAY_WIRES)
def test_relay_combines_bitwise_the_stacked_rows(runs, config, graph, wire):
    """The facade's ``neighbor_allreduce`` and 3 ATC steps of the MLP."""
    _check_rows(runs, config, f"relay:{graph}:{wire}")


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("graph", RELAY_GRAPHS)
@pytest.mark.parametrize("wire", RELAY_WIRES)
def test_relay_bytes_equal_the_crossing_hops(runs, config, graph, wire):
    for p, res in enumerate(runs[config]):
        sent, want = res[f"relay:{graph}:{wire}:bytes"]
        assert sent == want and sent > 0, (config, p, sent, want)
    assert runs["ref"][f"relay:{graph}:{wire}:bytes"][0] == 0


@pytest.mark.parametrize("graph", RELAY_GRAPHS)
def test_relay_messages_go_to_ring_adjacent_processes(runs, graph):
    """In 4 x 2 a relay combine's messages go to processes ``p +- 1 mod
    4`` only (the serpentine ring's hops; the torus's in a row of 4), and
    on Exp2(8) process 0 ships 7 hop rows a combine where the direct plan
    ships 5 edge rows."""
    for p, res in enumerate(runs["4x2"]):
        peers = res[f"relay:{graph}:messages"]["peers"]
        assert peers and set(peers) <= {(p + 1) % 4, (p - 1) % 4}, (graph, p, peers)
    if graph == "exp2":
        assert runs["4x2"][0]["relay:exp2:messages"]["hop_rows"] == 7


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("graph", RELAY_GRAPHS)
def test_relay_allgather_and_resnet_bitwise(runs, config, graph):
    _check_rows(runs, config, f"relay:{graph}:allgather")
    if graph == "exp2":
        _check_rows(runs, config, "relay:resnet:int8")


@pytest.mark.parametrize("config", _configs())
def test_relay_pure_transit_nan_bitwise(runs, config):
    """A NaN carried through a relay reaches the receivers' results in
    the transit rounds too (weight 0 still adds it), as stacked."""
    _check_rows(runs, config, "relay:nan")
    got = torch.cat([res["relay:nan"] for res in runs[config]])
    assert int(torch.isnan(got[:, 3]).sum()) == int(torch.isnan(runs["ref"]["relay:nan"][:, 3])
                                                    .sum()) > 1


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", ["int8_ef", "int4_ef"])
def test_relay_refuses_the_ef_tiers(runs, config, wire):
    msg = runs["ref"][f"relay:refused:{wire}"]
    assert "short-cut (relay)" in msg
    for res in runs[config]:
        assert res[f"relay:refused:{wire}"] == msg


# -- elastic ------------------------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", KILL_WIRES)
def test_kill_and_rejoin_bitwise_the_stacked_rows(runs, config, wire):
    """Every step's rows and the rejoined rows (the survivors' mean in the
    owner's row) bitwise; the repair at the same step in every process,
    ``stale_dispatches`` 0, the live sets equal."""
    key = f"kill:{wire}"
    _check_rows(runs, config, key)
    rec = runs["ref"][f"{key}:record"]
    assert rec["stale"] == 0 and [r[0] for r in rec["repairs"]] == [KILL_STEP]
    assert rec["live"] == tuple(range(SIZE))  # rejoined
    for p, res in enumerate(runs[config]):
        assert res[f"{key}:record"] == rec, p


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", KILL_WIRES)
def test_kill_bytes_follow_the_repaired_plan(runs, config, wire):
    for p, res in enumerate(runs[config]):
        for k, (sent, want) in enumerate(res[f"kill:{wire}:bytes"]):
            assert sent == want and sent > 0, (config, p, k, sent, want)


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("case", ["stall", "degrade"])
def test_stall_and_degrade_repairs_bitwise(runs, config, case):
    _check_rows(runs, config, f"{case}:params")
    ref = runs["ref"]
    assert len(ref[f"{case}:record"]["repairs"]) == 1
    for p, res in enumerate(runs[config]):
        assert res[f"{case}:record"] == ref[f"{case}:record"], p
        assert torch.equal(res[f"{case}:matrix"], ref[f"{case}:matrix"]), p


@pytest.mark.parametrize("config", _configs())
def test_pushsum_repair_bitwise(runs, config):
    _check_rows(runs, config, "pushsum")
    ref = runs["ref"]
    assert ref["pushsum:record"]["repairs"][0][5] == "push_sum"
    for p, res in enumerate(runs[config]):
        assert res["pushsum:record"] == ref["pushsum:record"], p
        assert res["pushsum:weights"] == ref["pushsum:weights"], p


@pytest.mark.parametrize("config", _configs())
def test_zero_reshard_after_a_kill_bitwise(runs, config):
    """zero2/int8: the sharded state after the re-shard and the steps
    after it, each process's rows of the stacked state."""
    _check_rows(runs, config, "zero")
    ref = runs["ref"]["zero:host"]
    assert ref["reshards"] == 1 and 6 not in ref["live"]
    for p, res in enumerate(runs[config]):
        assert res["zero:host"] == ref, p


@pytest.mark.parametrize("config", _configs())
def test_async_rewindow_after_a_kill_bitwise(runs, config):
    _check_rows(runs, config, "async")
    ref = runs["ref"]["async:host"]
    assert ref["rewindows"] == 1 and ref["live"] == (0, 1, 3, 4, 5, 6, 7)
    for p, res in enumerate(runs[config]):
        assert res["async:host"] == ref, p


@pytest.mark.parametrize("config", _configs())
def test_gateway_kill_reelects_in_every_process(runs, config):
    _check_rows(runs, config, "gateway")
    for name in GATEWAY_WIRES:
        ref = runs["ref"][f"gateway:{name}:host"]
        assert [f["gateways"] for f in ref["fabrics"]] == [[0, 4], [0, 5], [0, 5]], name
        assert [f["live"] for f in ref["fabrics"]] == [list(range(SIZE))] + [
            [r for r in range(SIZE) if r != 4]] * 2, name
        for p, res in enumerate(runs[config]):
            assert res[f"gateway:{name}:host"] == ref, (name, p)
            assert all(sent == want for sent, want in res[f"gateway:{name}:bytes"]), (name, p)


def _jax_fabric_matrices(live):
    """``(W_ici, W_dcn)`` float64 of ``BLUEFOG_PODS=2`` over ``SIZE`` ranks
    from the JAX package's pieces for the live set: the intra-pod matrix
    pruned by ``repaired_matrix(..., policy="receiver")`` (as it is with
    every rank live) and ``inter_plan(layout, live)``'s ring over the live
    gateways."""
    from bluefog_tpu import federation as jfed
    from bluefog_tpu.elastic import repair as jrepair

    layout = jfed.parse_pods("2", SIZE)
    w_ici = jfed._matrix_from_edges(SIZE, jfed.intra_edges(layout))
    if len(live) < SIZE:
        w_ici = jrepair.repaired_matrix(w_ici, live, policy="receiver")
    return w_ici, jfed.inter_plan(layout, live).weight_matrix()


@pytest.mark.parametrize("wire", list(GATEWAY_WIRES))
def test_gateway_kill_fabric_equals_the_jax_repair(runs, wire):
    """Each step's fabric after the gateway's kill is the JAX package's
    repair of it: the intra plan's matrix is ``repaired_matrix`` of the
    intra-pod matrix for the live set (policy ``receiver``; to the plan's
    f32 weights), the inter plan's ``inter_plan(layout, live)``'s bitwise,
    and before the kill both are JAX's ``get_fabric``'s."""
    from bluefog_tpu import federation as jfed
    from bluefog_tpu.collective import plan as jplan

    for k, fab in enumerate(runs["ref"][f"gateway:{wire}:host"]["fabrics"]):
        w_ici, w_dcn = _jax_fabric_matrices(fab["live"])
        intra, inter = np.array(fab["intra"]), np.array(fab["inter"])
        np.testing.assert_array_equal(intra, jplan.plan_from_matrix(w_ici).weight_matrix())
        np.testing.assert_allclose(intra, w_ici, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(inter, w_dcn)
        if k == 0:
            layout = jfed.parse_pods("2", SIZE)
            np.testing.assert_array_equal(intra, jfed.intra_plan(layout).weight_matrix())
            np.testing.assert_array_equal(inter, jfed.inter_plan(layout).weight_matrix())


def test_gateway_kill_trajectory_equals_the_float64_replay(runs):
    """The stacked fp32 run (exact DCN wire) across the gateway's kill,
    step by step against float64 numpy on the JAX package's matrices for
    the step's live set: ``m = g + 0.9 m``, ``y = x - 0.1 m``, ``x' = W_dcn^T
    (W_ici^T y)`` (every step a DCN step), within ``GATEWAY_TOL`` of the
    largest value."""
    ref = runs["ref"]
    xs = [x.double().numpy() for x in ref["gateway:fp32:x"]]
    gs = [g.double().numpy() for g in ref["gateway:fp32:g"]]
    outs = xs[1:] + [ref["gateway:fp32:params"].double().numpy()]
    m = np.zeros_like(xs[0])
    for k, fab in enumerate(ref["gateway:fp32:host"]["fabrics"]):
        w_ici, w_dcn = _jax_fabric_matrices(fab["live"])
        m = gs[k] + 0.9 * m
        want = w_dcn.T @ (w_ici.T @ (xs[k] - 0.1 * m))
        np.testing.assert_allclose(outs[k], want, rtol=0,
                                   atol=GATEWAY_TOL * np.abs(want).max(), err_msg=f"step {k}")


def _load_state(directory):
    return torch.load(os.path.join(directory, "state.pt"), map_location="cpu",
                      weights_only=True)


def _tree_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and _same(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("config", _configs())
def test_checkpoint_with_a_dead_rank_across_layouts(runs, config):
    """The file written after the kill is the stacked run's, sidecar (its
    live set) included; each process restores the stacked file under a
    fresh session, adopts the live set and steps bitwise as the stacked
    run does."""
    ref_dir = os.path.join(runs["dirs"]["ref"], "ckpt", "elastic")
    mine = os.path.join(runs["dirs"][config], "ckpt", "elastic")
    _tree_equal(_load_state(os.path.join(mine, "3")), _load_state(os.path.join(ref_dir, "3")))
    with open(os.path.join(mine, "3.graph.json")) as f, \
            open(os.path.join(ref_dir, "3.graph.json")) as g:
        side = f.read()
        assert side == g.read() and '"live_ranks": [0, 1, 2, 3, 4, 6, 7]' in side
    ref = runs["ref"]
    assert ref["ckpt:live"] == (0, 1, 2, 3, 4, 6, 7)
    for p, res in enumerate(runs[config]):
        assert _same(res["ckpt:next"], ref["ckpt:next"][res["rows"]]), p
        assert res["ckpt:live"] == ref["ckpt:live"], p


def test_checkpoint_of_two_processes_restores_in_one(runs):
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=CONFIGS[0][2])
    try:
        got, live = _restore_step(list(ctx.rows),
                                  os.path.join(runs["dirs"]["2x4"], "ckpt", "elastic"))
    finally:
        bft.shutdown()
    assert live == runs["ref"]["ckpt:live"]
    assert _same(got, runs["ref"]["ckpt:next"])


# -- agreement ----------------------------------------------------------------------------


@pytest.mark.parametrize("config", _configs())
def test_watchdog_verdict_of_one_process_reaches_all(runs, config):
    """Process 0's watchdog files SUSPECT verdicts; at the next dispatch
    every process holds them, as the one process does."""
    ref = runs["ref"]["agree:verdict"]
    assert ref["states"].count("suspect") == SIZE
    _check_rows(runs, config, "agree:verdict:params")
    for p, res in enumerate(runs[config]):
        assert res["agree:verdict"] == ref, p


@pytest.mark.parametrize("config", _configs())
def test_one_sided_fault_raises_in_every_process(runs, config):
    for p, res in enumerate(runs[config]):
        msg = res["agree:one_sided"]
        assert msg.startswith("elastic: the processes disagree before the dispatch of step 1"), \
            (config, p, msg)


# -- the JAX anchors ----------------------------------------------------------------------


def test_federated_run_matches_the_jax_package(runs, cpu_devices, monkeypatch):
    """``test_torch_federation.py::test_fed_optimizer_matches_jax``'s int8
    run in 2 x 4 processes against JAX's stacked run, at its tolerance."""
    import jax.numpy as jnp
    import optax

    import bluefog_tpu as bf

    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setenv("BLUEFOG_PODS", "2")
    monkeypatch.setenv("BLUEFOG_DCN_PERIOD", "2")
    rng = np.random.RandomState(0)
    x = (rng.randn(SIZE, 1500) * 5).astype(np.float32)
    gs = [rng.randn(SIZE, 1500).astype(np.float32) for _ in range(FED_STEPS)]
    bf.init(devices=cpu_devices[:SIZE])
    try:
        jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
        jopt.compression = "int8"
        jp = {"w": bf.worker_values(list(x))}
        js = jopt.init(jp)
        for g in gs:
            jp, js = jopt.step(jp, js, {"w": jnp.asarray(g)})
        want = np.asarray(jp["w"])
    finally:
        bf.shutdown()
    got = np.concatenate([res["anchor:fed"].numpy() for res in runs["2x4"]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert _same(torch.from_numpy(got), runs["ref"]["anchor:fed"])


def test_kill_fp32_matches_the_jax_package(runs, cpu_devices, monkeypatch):
    """``test_torch_elastic.py::test_kill_fp32_bitwise_survivor_oracle_and_jax``'s
    atc run in 2 x 4 processes against JAX's, at its tolerance, and its
    repair record."""
    import optax

    import bluefog_tpu as bf
    import bluefog_tpu.topology as jtu

    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    x0, grads = _kill_data()
    bf.init(devices=cpu_devices[:SIZE])
    try:
        bf.set_topology(jtu.ExponentialTwoGraph(SIZE))
        session = bf.elastic.start(policy="average")
        session.inject("kill", rank=3, step=5)
        opt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.05))
        guard = bf.elastic.guard(opt)
        params = {"w": bf.worker_values(lambda r: x0[r])}
        state = opt.init(params)
        for g in grads:
            params, state = guard.step(params, state, {"w": bf.worker_values(lambda r: g[r])})
        want = np.asarray(params["w"])
        rec = session.repairs[0]
        bf.elastic.stop()
    finally:
        bf.shutdown()
    got = np.concatenate([res["anchor:kill"].numpy() for res in runs["2x4"]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    mine = runs["2x4"][0]["anchor:kill:record"]["repairs"][0]
    assert (mine[0], mine[2], mine[3], mine[5], mine[4]) == (
        rec.step, rec.detected, rec.live, rec.policy, rec.epoch)
    assert _same(torch.from_numpy(got), runs["ref"]["anchor:kill"])
