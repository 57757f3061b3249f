# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The multi-process transport (``bluefog_tpu_torch.collective.transport``)
against the stacked single-process path, on the CPU with gloo.

The JAX package's own multi-process test is skipped on this jaxlib (it has
no multi-process CPU backend), and XLA lowers a cross-process ``ppermute``
itself, so there is no JAX run to hold the transport to. The stacked path
is already held to JAX (the other ``test_torch_*`` files), and the wire to
``collective/wire_ref.py``; so here every case of :func:`mp_cases` runs
once in one process (all 8 rows, Exp2(8)) and once in 2 processes x 4
workers, 4 processes x 2 workers and 2 processes of 3 and 5 workers
(``BLUEFOG_LOCAL_WORKERS``), and each process's rows must equal the same
rows of the one-process run bit for bit: the exact f32 and bf16 combines,
the bf16/int8/int4 wires, K rounds of int8_ef/int4_ef with their copies,
the dynamic one-peer step, hierarchical (one machine per process), the
allreduce (gathered, then reduced in the stacked order), allgather,
broadcast, pair gossip, ``neighbor_allgather``, and three
``make_train_step`` steps of a small ResNet and of the MLP. The bytes a
combine hands to ``isend`` must equal the edges from local to remote rows
times ``scaling.wire_payload_bytes``. The CTA and hierarchical legs of
``tests/test_multiprocess.py``'s worker are mirrored (loss below 0.2 x
start, the same on every process), and each path refused before the
window ops, the async engine, ZeRO, checkpoint, federation, relay plans,
elastic sessions and the fleet samplers ran across processes runs and
equals the stacked rows (``test_torch_transport_state.py``,
``test_torch_transport_topology.py`` and ``test_torch_transport_fleet.py``
hold them in depth).

Every job runs once per module (a module-scoped fixture), all of them at
once, each process under its own timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import compiler, inner, transport
from bluefog_tpu_torch.collective.plan import plan_from_topology, schedule_from_dynamic
from bluefog_tpu_torch.models import MLP, ResNet50, StackedModel, mlp, resnet
from bluefog_tpu_torch.scaling import wire_payload_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
N_ELEMS = 1500  # not a multiple of 512: the padded paths
N_ALIGNED = 1024
EF_ROUNDS = 3
TRAIN_STEPS = 3
JOB_TIMEOUT = 120
# (name, worker counts per process, nodes per machine)
CONFIGS = [("2x4", (4, 4), 4), ("4x2", (2, 2, 2, 2), 2), ("3+5", (3, 5), 1)]
# the fleet samplers' switches (and the elastic oom fault), refused until
# they ran across processes
SAMPLERS = {"doctor": "BLUEFOG_DOCTOR", "staleness": "BLUEFOG_STALENESS",
            "memory": "BLUEFOG_MEMORY", "health": "BLUEFOG_HEALTH", "slo": "BLUEFOG_SLO",
            "autotune": "BLUEFOG_AUTOTUNE", "metrics": "BLUEFOG_METRICS"}
# refused until the window ops, the async engine, ZeRO, checkpoint,
# federation, relay plans, elastic sessions and the fleet samplers ran
# across processes; each now runs and equals the stacked rows
FORMERLY_REFUSED = ("win_create", "push_sum", "win_put", "pull_get", "async", "checkpoint_save",
                    "checkpoint_restore", "reduce_scatter", "shard", "shard:dispatch",
                    "elastic", "pods", "shortcut") + tuple(SAMPLERS) + ("oom",)


def _tiny_resnet(n_local, rows):
    model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                           stage_sizes=[1, 1, 1, 1]), 0)
    sm = StackedModel(model, n_local, "cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    return sm, images[rows].contiguous(), labels[rows].contiguous()


def _train(out, name, opt, params, loss_fn, *batch):
    state = opt.init(params)
    step = opt.make_train_step(loss_fn)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, *batch)
        losses.append(loss.clone())
    out[f"train:{name}"] = params.clone() if isinstance(params, torch.Tensor) else {
        k: v.clone() for k, v in params.items()}
    out[f"train:{name}:loss"] = torch.stack(losses, dim=1)


def _formerly_refused(out, level):
    """Each path refused across processes before this slice, run: its
    result, this process's rows (the checkpoint's file: every row)."""
    x = bft.worker_values(lambda r: np.arange(1024, dtype=np.float32) * 0.01 + r)
    g = bft.worker_values(lambda r: np.linspace(-1, 1, 1024, dtype=np.float32) * (r + 1))
    got = {}
    bft.win_create(x, "fr")
    bft.win_put(name="fr")
    got["win_create"] = bft.win_update("fr", clone=True)
    bft.win_free("fr")
    for name, make in (("push_sum", bft.DistributedPushSumOptimizer),
                       ("win_put", bft.DistributedWinPutOptimizer),
                       ("pull_get", bft.DistributedPullGetOptimizer)):
        opt = make(bft.sgd(0.1))
        state = opt.init(x.clone())
        got[name], _ = opt.step(state, g)
        opt.free()
    bft.turn_off_win_ops_with_associated_p()
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
    step = bft.make_async_train_step(opt, lambda w, t: ((w - t) ** 2).sum(), cadence={3: 2})
    params, state = x.clone(), opt.init(x.clone())
    for _ in range(3):
        params, state, _loss = step(params, state, g)
    got["async"] = params
    step.engine.free()
    path = os.path.abspath(f"fr_ckpt_{level}")
    bft.checkpoint.save(path, 1, x * 2, ())
    got["checkpoint_save"] = torch.load(os.path.join(path, "1", "state.pt"),
                                        weights_only=True)["params"]
    got["checkpoint_restore"] = bft.checkpoint.restore(path, 1)[1]
    got["reduce_scatter"] = inner.reduce_scatter(x, list(range(SIZE)), 128)
    params = x.clone()
    for name, env in (("shard", {"BLUEFOG_SHARD": "1"}),
                      ("shard:dispatch", {"BLUEFOG_SHARD": "1", "BLUEFOG_SHARD_GRADS": "1"})):
        os.environ.update(env)
        try:
            if name == "shard":  # the switch set at init: no longer refused there
                bft.init(size=SIZE, device="cpu", nodes_per_machine=level)
            gopt = bft.DistributedGradientAllreduceOptimizer(bft.adam(0.1))
            params = x.clone()
            gstate = gopt.init(params)
            gopt.step(params, gstate, g.clone())
            got[name] = params
        finally:
            for k in env:
                del os.environ[k]
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    session = bft.elastic.start()
    session.inject("kill", rank=5, step=0)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    params = x.clone()
    bft.elastic.guard(opt).step(params, opt.init(params), g.clone())
    got["elastic"] = params
    bft.elastic.stop()
    for name, env in (("pods", {"BLUEFOG_PODS": "2"}),
                      ("shortcut", {"BLUEFOG_PLAN_METHOD": "shortcut"})):
        os.environ.update(env)
        try:
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = "int8"
            params = x.clone()
            opt.step(params, opt.init(params), g.clone())
            got[name] = params
        finally:
            for k in env:
                del os.environ[k]
    for name, env in SAMPLERS.items():
        # the switch set at init, at interval 1 (the doctor's model pinned)
        os.environ.update({env: "1", f"{env}_INTERVAL": "1"})
        try:
            bft.init(size=SIZE, device="cpu", nodes_per_machine=level)
            compiler.set_calibration(1.0, 1e12, 0.0, link_class=compiler.TRANSPORT_LINK_CLASS)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = "int8"
            params = x.clone()
            opt.step(params, opt.init(params), g.clone())
            got[name] = params
        finally:
            for k in (env, f"{env}_INTERVAL"):
                del os.environ[k]
            compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
    bft.init(size=SIZE, device="cpu", nodes_per_machine=level)
    session = bft.elastic.start()
    session.inject("oom", rank=1, step=0)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    params = x.clone()
    state = opt.init(params)
    try:  # the memory observatory's forensics, then the raise; the retry runs
        bft.elastic.guard(opt).step(params, state, g.clone())
    except MemoryError:
        bft.elastic.guard(opt).step(params, state, g.clone())
    got["oom"] = params
    bft.elastic.stop()
    for name, t in got.items():
        out[f"formerly_refused:{name}"] = t.clone()


def mp_cases(nodes_per_machine):
    """Every case on the active process level: ``{name: this process's
    rows}`` (all rows with one process), the transport's byte counts, the
    mirrored legs' losses and (across processes) the refusals."""
    from bluefog_tpu_torch import flight, metrics

    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=nodes_per_machine)
    rows = list(ctx.rows)
    out = {"rows": torch.tensor(rows)}
    start = [e for e in flight.events() if e["kind"] == "session_start"][-1]["data"]
    staged = metrics.peek("bluefog.transport.staged")
    out["session"] = {k: start.get(k) for k in ("process_count", "rows", "backend", "staged")}
    out["session"].update(rank=bft.rank(), local_rank=bft.local_rank(),
                          local_size=ctx.local_size, machine_size=ctx.machine_size,
                          staged_gauge=None if staged is None else staged.describe()["value"])
    rng = np.random.RandomState(0)
    xs = rng.randn(SIZE, N_ELEMS).astype(np.float32)
    xa = rng.randn(SIZE, N_ALIGNED).astype(np.float32)
    x = bft.worker_values(list(xs))
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    out["exact_fp32"] = bft.neighbor_allreduce(x)
    out["exact_bf16"] = bft.neighbor_allreduce(x.to(torch.bfloat16))
    for wire in ("bf16", "int8", "int4"):
        out[f"wire_{wire}"] = bft.neighbor_allreduce(x, compression=wire)
    out["wire_int8_bf16_payload"] = bft.neighbor_allreduce(x.to(torch.bfloat16),
                                                           compression="int8")
    plan = ctx.static_plan()
    src, self_w, recv_w = inner.plan_operands(plan, "cpu")
    for wire in ("int8", "int4"):
        y = bft.worker_values(list(xa))
        transport.reset_stats()
        inner.weighted_combine_quantized_operands(y, src, recv_w, wire=wire, inplace=True)
        out[f"inplace_{wire}"] = y
        out[f"bytes:{wire}"] = transport.stats()["bytes"]
    transport.reset_stats()
    sent = metrics.peek("bluefog.transport.bytes")
    sent = 0 if sent is None else sent.describe()["value"]
    inner.weighted_combine_operands(x, src, self_w, recv_w)
    out["bytes:fp32"] = transport.stats()["bytes"]
    counter = metrics.peek("bluefog.transport.bytes")
    out["bytes:fp32:counter"] = 0 if counter is None else counter.describe()["value"] - sent
    out["transport_events"] = [e["data"] for e in flight.events() if e["kind"] == "transport"][-1:]
    for wire in ("int8", "int4"):
        state = inner.ef_state_zeros(ctx.n_local, N_ELEMS, len(plan.perms), "cpu")
        z = x.clone()
        transport.reset_stats()
        for _ in range(EF_ROUNDS):
            z = inner.weighted_combine_quantized_ef_operands(z, state, src, recv_w, wire=wire)
        out[f"bytes:{wire}_ef"] = transport.stats()["bytes"]
        out[f"ef_{wire}"], out[f"ef_{wire}:self"], out[f"ef_{wire}:recv"] = z, *state
    sched = schedule_from_dynamic(
        SIZE, lambda r: topo.GetDynamicOnePeerSendRecvRanks(topo.ExponentialTwoGraph(SIZE), r))
    z = x
    for step in range(4):
        z = inner.neighbor_allreduce_step(z, step, sched)
        out[f"one_peer:{step}"] = z
    bft.set_machine_topology(topo.RingGraph(ctx.machine_size))
    out["hier"] = bft.hierarchical_neighbor_allreduce(x)
    out["allreduce_mean"] = bft.allreduce(x)
    out["allreduce_sum"] = bft.allreduce(x, average=False)
    out["allgather"] = bft.allgather(x[:, :7])
    out["broadcast"] = bft.broadcast(x, 5)
    out["pair_gossip"] = bft.pair_gossip(x, [(0, 5), (2, 3), (6, 7)])
    for wire in (None, "int8"):
        got = bft.neighbor_allgather(x, compression=wire)
        out[f"neighbor_allgather:{wire}"] = torch.cat([g.reshape(-1) for g in got])

    # make_train_step: a small ResNet (ATC int8, ATC int4_ef, hierarchical
    # int8) and the MLP (ATC fp32, gradient allreduce, CTA on one-peer Exp2)
    sm, images, labels = _tiny_resnet(ctx.n_local, rows)
    workers = torch.arange(ctx.n_local)
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    for name, factory, wire in (
            ("resnet atc/int8", bft.DistributedAdaptThenCombineOptimizer, "int8"),
            ("resnet atc/int4_ef", bft.DistributedAdaptThenCombineOptimizer, "int4_ef"),
            ("resnet hier/int8", bft.DistributedHierarchicalNeighborAllreduceOptimizer, "int8")):
        sm.load_buffers(stats0)
        opt = factory(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        _train(out, name, opt, sm.replicate(), sm.worker_loss, images, labels, workers)
    model = mlp.init_flax_like(MLP(12, (16, 4)), 0)
    sm = StackedModel(model, ctx.n_local, "cpu")
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(SIZE, 5, 12, generator=gen)[rows].contiguous()
    targets = torch.randint(0, 4, (SIZE, 5), generator=gen)[rows].contiguous()
    for name, factory, wire in (
            ("mlp atc", bft.DistributedAdaptThenCombineOptimizer, None),
            ("mlp grad-allreduce", bft.DistributedGradientAllreduceOptimizer, None),
            ("mlp one-peer", bft.DistributedNeighborAllreduceOptimizer, None)):
        opt = factory(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        if name == "mlp one-peer":
            opt.schedule = sched
        _train(out, name, opt, sm.replicate(), sm.worker_loss, feats, targets)

    # the CTA and hierarchical legs of tests/test_multiprocess.py's worker
    bft.set_topology(None)
    c = np.random.RandomState(0).randn(SIZE, 3).astype(np.float32)
    mean = torch.from_numpy(c.mean(0))

    def global_loss(w):
        full = bft.allgather(w)[0].reshape(SIZE, 3)
        return float(0.5 * ((full - mean) ** 2).sum(-1).mean())

    target = bft.worker_values(list(c))
    for name, factory, steps in (("cta", bft.DistributedNeighborAllreduceOptimizer, 50),
                                 ("hier", bft.DistributedHierarchicalNeighborAllreduceOptimizer,
                                  40)):
        opt = factory(bft.sgd(0.4))
        params = target.clone()
        state = opt.init(params)
        start = global_loss(params)
        for _ in range(steps):
            params, state = opt.step(params, state, params - target)
        out[f"leg:{name}"] = torch.tensor([start, global_loss(params)], dtype=torch.float64)
    if ctx.process_count > 1:
        dump = bft.flight_dump()
        with open(dump) as f:
            world = json.load(f)["world"]
        out["flight"] = {"file": os.path.basename(dump), "ranks": world["ranks"]}
    _formerly_refused(out, nodes_per_machine)
    bft.barrier()
    bft.shutdown()
    return out


WORKER = """
import os, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
import test_torch_transport as T
pid = int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
out = {{L: T.mp_cases(L) for L in {levels!r}}}
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


def _start(tmp, name, counts, levels):
    """Start one job's processes (one with no coordinator: the stacked
    reference); returns ``(outdir, [Popen])``."""
    outdir = tmp / name
    outdir.mkdir()
    script = outdir / "worker.py"
    script.write_text(WORKER.format(tests=os.path.join(REPO, "tests"), levels=levels,
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
    for pid, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=JOB_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{name}: process {pid} passed its {JOB_TIMEOUT} s timeout")
        assert p.returncode == 0 and "MP_OK" in so, f"{name} process {pid}:\n{so}\n{se[-4000:]}"
        results.append(torch.load(outdir / f"rows_{pid}.pt", weights_only=False))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ref": {L: stacked results}, config: [per-process results]}``:
    the one-process reference and every configuration, started together."""
    tmp = tmp_path_factory.mktemp("transport")
    jobs = {"ref": _start(tmp, "ref", (SIZE,), [L for _, _, L in CONFIGS])}
    for name, counts, level in CONFIGS:
        jobs[name] = _start(tmp, name, counts, [level])
    got = {name: _finish(name, *job) for name, job in jobs.items()}
    got["ref"] = got["ref"][0]
    return got


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


ROW_CASES = (["exact_fp32", "exact_bf16", "wire_bf16", "wire_int8", "wire_int4",
              "wire_int8_bf16_payload", "inplace_int8", "inplace_int4", "hier",
              "allreduce_mean", "allreduce_sum", "allgather", "broadcast", "pair_gossip"]
             + [f"ef_{w}{p}" for w in ("int8", "int4") for p in ("", ":self", ":recv")]
             + [f"one_peer:{s}" for s in range(4)])
TRAIN_CASES = ["resnet atc/int8", "resnet atc/int4_ef", "resnet hier/int8", "mlp atc",
               "mlp grad-allreduce", "mlp one-peer"]


def _config(name):
    return next(c for c in CONFIGS if c[0] == name)


@pytest.mark.parametrize("config", [c[0] for c in CONFIGS])
@pytest.mark.parametrize("case", ROW_CASES)
def test_rows_bitwise_the_stacked_rows(runs, config, case):
    _, counts, level = _config(config)
    ref = runs["ref"][level][case]
    for p, res in enumerate(runs[config]):
        rows = res[level]["rows"]
        got = res[level][case]
        want = ref[:, rows] if case.endswith(":recv") else ref[rows]
        assert got.shape == want.shape, (case, p)
        assert torch.equal(_bits(got), _bits(want)), f"{config} process {p}: {case}"


@pytest.mark.parametrize("config", [c[0] for c in CONFIGS])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_steps_bitwise_the_stacked_rows(runs, config, case):
    _, _, level = _config(config)
    ref = runs["ref"][level]
    for p, res in enumerate(runs[config]):
        rows = res[level]["rows"]
        for key in (f"train:{case}", f"train:{case}:loss"):
            assert torch.equal(_bits(res[level][key]), _bits(ref[key][rows])), \
                f"{config} process {p}: {key}"


@pytest.mark.parametrize("config", [c[0] for c in CONFIGS])
@pytest.mark.parametrize("wire", [None, "int8"])
def test_neighbor_allgather_bitwise(runs, config, wire):
    """The per-rank in-neighbour lists of each process's rows, flattened,
    equal the stacked lists of the same ranks."""
    _, _, level = _config(config)
    ref_ctx_lists = runs["ref"][level][f"neighbor_allgather:{wire}"]
    plan_deg = _in_degrees()
    per_rank = ref_ctx_lists.split([d * N_ELEMS for d in plan_deg])
    for p, res in enumerate(runs[config]):
        rows = res[level]["rows"].tolist()
        want = torch.cat([per_rank[r] for r in rows])
        assert torch.equal(_bits(res[level][f"neighbor_allgather:{wire}"]), _bits(want)), p


def _in_degrees():
    w = topo.ExponentialTwoGraph(SIZE)
    return [int(np.count_nonzero(w[:, j])) - 1 for j in range(SIZE)]


def _remote_edges(counts, p):
    """Edges ``j -> i`` of Exp2(8)'s plan, summed over its rounds, with
    ``j`` a row of process ``p`` and ``i`` a row of another process."""
    plan = plan_from_topology(topo.ExponentialTwoGraph(SIZE), weighted=True)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    mine = lambda r: bounds[p] <= r < bounds[p + 1]  # noqa: E731
    return sum(1 for rnd in plan.perms for j, i in rnd if mine(j) and not mine(i))


@pytest.mark.parametrize("config", [c[0] for c in CONFIGS])
@pytest.mark.parametrize("wire", ["fp32", "int8", "int4", "int8_ef", "int4_ef"])
def test_bytes_sent_equal_the_edge_formula(runs, config, wire):
    _, counts, level = _config(config)
    n = N_ALIGNED if wire in ("int8", "int4") else N_ELEMS
    per_row = wire_payload_bytes(n, 4, None if wire == "fp32" else wire)
    combines = EF_ROUNDS if wire.endswith("_ef") else 1
    for p, res in enumerate(runs[config]):
        want = _remote_edges(counts, p) * per_row * combines
        assert res[level][f"bytes:{wire}"] == want, (config, p)
    assert runs["ref"][level][f"bytes:{wire}"] == 0


@pytest.mark.parametrize("config", [c[0] for c in CONFIGS])
@pytest.mark.parametrize("leg", ["cta", "hier"])
def test_multiprocess_legs_converge(runs, config, leg):
    """``tests/test_multiprocess.py``'s CTA and hierarchical legs: the loss
    the same on every process and bitwise the one-process run's, and below
    0.2 x its start where one machine is one process, as in that worker
    (with the 3 + 5 split a machine is a worker: the ring of 8 machines
    mixes slower in 40 steps, on one process as on two)."""
    _, counts, level = _config(config)
    losses = [res[level][f"leg:{leg}"] for res in runs[config]]
    start, final = losses[0].tolist()
    if leg == "cta" or level == counts[0]:
        assert final < 0.2 * start
    for got in losses:
        assert torch.equal(got, losses[0])
    assert torch.equal(losses[0], runs["ref"][level][f"leg:{leg}"])


@pytest.mark.parametrize("what", FORMERLY_REFUSED)
def test_formerly_refused_paths_run(runs, what):
    """The paths refused across processes until the window ops, the async
    engine, ZeRO, checkpoint, federation (``BLUEFOG_PODS``), relay plans
    (``BLUEFOG_PLAN_METHOD=shortcut``), elastic sessions and the fleet
    samplers (each switch at interval 1, and the elastic ``oom`` fault) were
    ported now run, and each process's result equals the same rows of the
    stacked run (the checkpoint file holds every row, equal to the stacked
    file's)."""
    key = f"formerly_refused:{what}"
    for config, _, level in CONFIGS:
        ref = runs["ref"][level][key]
        for p, res in enumerate(runs[config]):
            want = ref if what == "checkpoint_save" else ref[res[level]["rows"]]
            assert torch.equal(_bits(res[level][key]), _bits(want)), (config, p, what)


def test_single_process_context_is_unchanged():
    """With one process the context holds every row and the process
    level is off: the stacked path as before."""
    ctx = bft.init(size=SIZE, device="cpu")
    try:
        assert ctx.rows == range(SIZE) and ctx.n_local == SIZE
        assert (ctx.process_count, ctx.process_index, ctx.backend, ctx.staged) == (1, 0, None,
                                                                                   False)
        src, _, _ = inner.plan_operands(ctx.static_plan(), "cpu")
        assert isinstance(src, torch.Tensor) and bft.rank() == 0
    finally:
        bft.shutdown()


def test_route_lists_match_on_both_ends():
    """What process ``p`` sends to ``q`` in a round is what ``q`` receives
    from ``p`` in that round, and no (round, peer) list is empty, on Exp2(8)
    and a relay-free random plan, for several partitions."""
    plans = [plan_from_topology(topo.ExponentialTwoGraph(SIZE), weighted=True),
             plan_from_topology(topo.RingGraph(SIZE)),
             plan_from_topology(topo.FullyConnectedGraph(SIZE))]
    for plan in plans:
        src = np.array(plan.sources())
        for counts in ((4, 4), (2, 2, 2, 2), (3, 5), (1, 7), (1,) * SIZE):
            routes = [transport.Route(src, counts, p, "cpu") for p in range(len(counts))]
            for p, rt in enumerate(routes):
                for r, q, rows in rt.sends:
                    assert rows.size
                    got = [g for (r2, p2, g, _o) in routes[q].recvs if (r2, p2) == (r, p)]
                    assert len(got) == 1
                    np.testing.assert_array_equal(got[0], rows + rt.lo)
                assert sum(1 for _ in rt.recvs) == sum(
                    1 for other in routes for (r, q, _rows) in other.sends if q == p)
                # the remapped sources read the row the stacked gather reads
                ext_rows = list(range(rt.lo, rt.hi)) + [int(j) for _r, _q, g, _o in rt.recvs
                                                        for j in g]
                local = rt.local.numpy()
                for r in range(src.shape[0]):
                    for i in range(rt.n_local):
                        want = src[r, rt.lo + i]
                        assert (local[r, i] < 0) == (want < 0)
                        if want >= 0:
                            assert ext_rows[local[r, i]] == want


@pytest.mark.parametrize("config", [c[0] for c in CONFIGS])
def test_process_level_of_each_process(runs, config):
    """Each process's context: its rows in process order, one machine per
    process by default, ``rank()`` its index and ``local_rank()`` 0 (as
    JAX's), gloo on the CPU, not staged: in the flight recorder's
    ``session_start``, the ``bluefog.transport.staged`` gauge (0) and the
    ``transport`` event of a combine, whose bytes are also the
    ``bluefog.transport.bytes`` counter's; its flight dump is
    ``flight_<process>.json`` and lists its own rows."""
    _, counts, level = _config(config)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    for p, res in enumerate(runs[config]):
        ses = res[level]["session"]
        assert ses["process_count"] == len(counts) and ses["rows"] == [bounds[p], bounds[p + 1]]
        assert (ses["backend"], ses["staged"], ses["staged_gauge"]) == ("gloo", False, 0)
        assert (ses["rank"], ses["local_rank"]) == (p, 0)
        assert (ses["local_size"], ses["machine_size"]) == (level, SIZE // level)
        assert res[level]["bytes:fp32:counter"] == res[level]["bytes:fp32"]
        (ev,) = res[level]["transport_events"]
        assert ev["bytes"] == res[level]["bytes:fp32"] and ev["staged"] is False
        # the flight recorder per process: flight_<process>.json, its own rows
        assert res[level]["flight"] == {"file": f"flight_{p}.json",
                                        "ranks": list(range(bounds[p], bounds[p + 1]))}
    ref = runs["ref"][CONFIGS[0][2]]["session"]
    assert (ref["process_count"], ref["backend"], ref["staged"]) == (1, None, False)
