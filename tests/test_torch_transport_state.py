# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The window ops, the window optimizers, the async engine, the
reduce-scatter, ZeRO-1/2 and checkpoint across processes, against the
stacked single-process run, on the CPU with gloo.

The harness is ``test_torch_transport.py``'s: every case of
:func:`state_cases` runs once in one process (all 8 rows) and once in 2
processes x 4 workers, 4 x 2 and 3 + 5 (``BLUEFOG_LOCAL_WORKERS``), all
jobs started together by a module-scoped fixture, each process under its
own timeout, and each process's rows must equal the same rows of the
one-process run bit for bit:

- ``win_put``, ``win_accumulate`` (ranks sitting out), ``win_get`` and
  ``win_update`` on the exact, bf16, int8 and int4 window wires with the p
  lane off and on: value, buffers, versions, p and p_buffers after each op,
  and the bytes an exchange hands to ``isend`` (the edges from local to
  remote rows times ``wire_payload_bytes`` of the wire, plus 4 an edge
  with the p lane);
- three steps of push-sum (the tiny ResNet on the int8 window wire, then
  an lr-0 step whose x and p mass, summed over the processes through one
  ``gather_rows``, stay put), win-put and pull-get (the MLP);
- 6 ticks of the async engine on fp32 and int8 with rank 6 at period 3:
  estimates, losses, window lanes, ages, advisories and the summary;
- ``reduce_scatter`` on the seven wires (with ``fast``), twice on the EF
  tiers, and its bytes;
- three ZeRO-1 (fp32) and ZeRO-2 (fp32, int8, int4_ef) steps of the MLP
  under ``adam``: parameters and the sharded state;
- the checkpoint: the push-sum and zero2/int8 runs' ``state.pt`` written
  across processes equals the stacked one tensor for tensor; each process
  restores the stacked run's file and takes the next step, bitwise the
  stacked run's; and this test process restores the 2 x 4 file in one
  process, bitwise the same step.

One JAX anchor: ``tests/test_multiprocess.py``'s push-sum leg at 8 workers
(``RingGraph(8, connect_style=1)``, 60 steps, ``sgd`` on
``exponential_decay(0.4, 20, 0.5)``) in 2 x 4 processes against the JAX
package's stacked run on its 8 virtual CPU devices, at
``test_torch_pushsum.py``'s tolerance.
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
from bluefog_tpu_torch.collective import compiler, inner, transport
from bluefog_tpu_torch.models import MLP, ResNet50, StackedModel, mlp, resnet
from bluefog_tpu_torch.scaling import wire_payload_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
N_ELEMS = 1500  # not a multiple of 512: the padded paths
JOB_TIMEOUT = 140
STEPS = 3
TICKS = 6
SLOW, PERIOD = 6, 3
WIN_WIRES = ("fp32", "bf16", "int8", "int4")
SCATTER_WIRES = ("none", "fp32", "bf16", "int8", "int4", "int8_ef", "int4_ef")
SCATTER_SLOT = 1536
SCATTER_M = SIZE * SCATTER_SLOT  # (ZeRO-2 below pads its last slot)
ZERO_TIERS = (("zero1/fp32", "0", None), ("zero2/fp32", "1", None), ("zero2/int8", "1", "int8"),
              ("zero2/int4_ef", "1", "int4_ef"))
ANCHOR_STEPS = 60
CKPT_WAIT = 120  # seconds a process waits for the stacked run's checkpoint
# (name, worker counts per process, nodes per machine)
CONFIGS = [("2x4", (4, 4), 4), ("4x2", (2, 2, 2, 2), 2), ("3+5", (3, 5), 1)]


def _tiny_resnet(rows):
    model = resnet.init_flax_like(ResNet50(num_classes=10, num_filters=8,
                                           stage_sizes=[1, 1, 1, 1]), 0)
    sm = StackedModel(model, len(rows), "cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(SIZE, 2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (SIZE, 2), generator=gen)
    return sm, images[rows].contiguous(), labels[rows].contiguous()


def _mlp(rows):
    sm = StackedModel(mlp.init_flax_like(MLP(64, (128, 10)), 0), len(rows), "cpu")
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(SIZE, 5, 64, generator=gen)
    targets = torch.randint(0, 10, (SIZE, 5), generator=gen)
    return sm, feats[rows].contiguous(), targets[rows].contiguous()


def _lanes(win):
    return {f: getattr(win, f).clone() for f in ("value", "buffers", "versions", "p",
                                                  "p_buffers")}


def _edges(ctx, pairs):
    """How many ``(src, dst)`` pairs run from a local to a remote row."""
    rows = ctx.rows
    return sum(1 for s, d in pairs if s in rows and d not in rows)


def _window_ops(out, ctx):
    rng = np.random.RandomState(1)
    xs = [bft.worker_values(list(rng.randn(SIZE, N_ELEMS).astype(np.float32))) for _ in range(3)]
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    outs = ctx.out_neighbor_ranks()
    ins = ctx.in_neighbor_ranks()
    part = rng.rand(SIZE) < 0.6
    put_w = [{d: 0.5 + 0.1 * k for k, d in enumerate(outs[r])} for r in range(SIZE)]
    acc_w = [{d: 1.0 / (len(outs[r]) + 1) for d in outs[r]} if part[r] else None
             for r in range(SIZE)]
    get_w = [{s: 0.25 for s in ins[r][:2]} for r in range(SIZE)]
    edges = {"put": [(s, d) for s in range(SIZE) for d in outs[s]],
             "acc": [(s, d) for s in range(SIZE) if part[s] for d in outs[s]],
             "get": [(s, r) for r in range(SIZE) for s in ins[r][:2]]}
    for wire in WIN_WIRES:
        os.environ["BLUEFOG_WINDOW_WIRE"] = wire
        for p_on in (False, True):
            key = f"win:{wire}:{'p' if p_on else 'nop'}"
            name = key.replace(":", "_")
            bft.win_create(xs[0], name)
            if p_on:
                bft.turn_on_win_ops_with_associated_p()
            win = ctx.windows[name]
            for op, call in (
                    ("put", lambda: bft.win_put(xs[1], name, self_weight=0.75,
                                                dst_weights=put_w)),
                    ("acc", lambda: bft.win_accumulate(xs[2], name, self_weight=0.5,
                                                       dst_weights=acc_w)),
                    ("get", lambda: bft.win_get(name, src_weights=get_w)),
                    ("update", lambda: bft.win_update(name))):
                transport.reset_stats()
                call()
                sent = transport.stats()["bytes"]
                for f, t in _lanes(win).items():
                    out[f"{key}:{op}:{f}"] = t
                if op != "update":
                    per = wire_payload_bytes(N_ELEMS, 4, None if wire == "fp32" else wire)
                    out[f"{key}:{op}:bytes"] = (sent, _edges(ctx, edges[op]) * (
                        per + (4 if p_on else 0)))
            out[f"{key}:version"] = bft.get_win_version(name)
            out[f"{key}:age"] = bft.get_win_age(name)
            out[f"{key}:p"] = torch.from_numpy(bft.win_associated_p(name))
            bft.win_free(name)
            bft.turn_off_win_ops_with_associated_p()
    del os.environ["BLUEFOG_WINDOW_WIRE"]


def _masses(win):
    """``(x mass, sum |x|, p mass)`` over every process, float64: one
    ``gather_rows`` of the local rows' sums."""
    f64 = torch.float64
    v, b = win.value.to(f64), win.buffers.to(f64).reshape(win.buffers.shape[0], -1)
    local = torch.stack([v.reshape(v.shape[0], -1).sum(1) + b.sum(1),
                         v.abs().reshape(v.shape[0], -1).sum(1) + b.abs().sum(1),
                         win.p.to(f64) + win.p_buffers.to(f64).sum(1)], dim=1)
    full = transport.gather_rows(local) if bft.get_context().process_count > 1 else local
    return full.sum(0)


def _window_optimizers(out, ctx, rows):
    bft.set_topology(topo.ExponentialGraph(SIZE))
    os.environ["BLUEFOG_WINDOW_WIRE"] = "int8"
    sm, images, labels = _tiny_resnet(rows)
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    opt = bft.DistributedPushSumOptimizer(bft.sgd(0.1, momentum=0.9))
    state = opt.init(sm.replicate())
    losses = []
    for _ in range(STEPS):
        loss, grads = sm.loss_and_grad(opt.params(), images, labels)
        opt.step(state, grads)
        losses.append(loss)
    out["push_sum:loss"] = torch.stack(losses, dim=1)
    out["push_sum:estimate"] = opt.params()
    for f, t in _lanes(ctx.windows[opt._name]).items():
        out[f"push_sum:{f}"] = t
    out["mass:push_sum:0"] = _masses(ctx.windows[opt._name])
    opt.tx = bft.sgd(0.0, momentum=0.9)
    _, grads = sm.loss_and_grad(opt.params(), images, labels)
    opt.step(state, grads)
    out["mass:push_sum:1"] = _masses(ctx.windows[opt._name])
    opt.free()
    del os.environ["BLUEFOG_WINDOW_WIRE"]
    sm.load_buffers(stats0)

    msm, feats, targets = _mlp(rows)
    for mode, make in (("win_put", bft.DistributedWinPutOptimizer),
                       ("pull_get", bft.DistributedPullGetOptimizer)):
        opt = make(bft.sgd(0.1, momentum=0.9))
        state = opt.init({"w": msm.replicate()})
        for _ in range(STEPS):
            _, grads = msm.loss_and_grad(opt.params()["w"], feats, targets)
            est, state = opt.step(state, {"w": grads})
        out[f"{mode}:estimate"] = est["w"]
        for f, t in _lanes(ctx.windows[opt._name]).items():
            out[f"{mode}:{f}"] = t
        opt.free()


def _async(out, ctx, rows):
    bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
    for wire in ("fp32", "int8"):
        sm, images, labels = _tiny_resnet(rows)
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
        params = sm.replicate()
        state = opt.init(params)
        step = bft.make_async_train_step(opt, sm.worker_loss, cadence={SLOW: PERIOD}, max_age=1,
                                         policy="drop", wire=wire, buffers=sm.buffers)
        workers = torch.arange(len(rows))
        losses = []
        for _ in range(TICKS):
            params, state, loss = step(params, state, images, labels, workers)
            losses.append(loss)
        eng = step.engine
        key = f"async:{wire}"
        out[f"{key}:estimate"] = params
        out[f"{key}:loss"] = torch.stack(losses, dim=1)
        out[f"{key}:momentum"] = state["trace"] if isinstance(state, dict) else state
        for f, t in _lanes(ctx.windows[eng._name]).items():
            out[f"{key}:{f}"] = t
        out[f"{key}:stats"] = {k: v.clone() for k, v in sm.buffers.items()}
        out[f"{key}:host"] = {"age": bft.get_win_age(eng._name),
                              "mass_age": bft.get_win_age(eng._name, mass=True),
                              "advisories": [a.to_json() for a in eng.advisories],
                              "summary": eng.summary()}
        eng.free()


def _scatter(out, ctx):
    rng = np.random.RandomState(5)
    x = bft.worker_values(list(rng.randn(SIZE, SCATTER_M).astype(np.float32)))
    lidx = list(range(SIZE))
    perms = compiler.compile_reduce_scatter(SIZE).perms
    crossing = _edges(ctx, [pair for perm in perms for pair in perm])
    for wire in SCATTER_WIRES:
        w = None if wire == "none" else wire
        for fast in ((False, True) if wire in ("none", "fp32") else (False,)):
            key = f"scatter:{wire}{':fast' if fast else ''}"
            transport.reset_stats()
            if wire.endswith("_ef"):
                ef = torch.zeros_like(x)
                y, ef = inner.reduce_scatter(x, lidx, SCATTER_SLOT, wire=w, ef=ef, fast=fast)
                y, ef = inner.reduce_scatter(x * 0.5, lidx, SCATTER_SLOT, wire=w, ef=ef,
                                             fast=fast)
                out[f"{key}:ef"] = ef
                calls = 2
            else:
                y = inner.reduce_scatter(x, lidx, SCATTER_SLOT, wire=w, fast=fast)
                calls = 1
            out[key] = y
            if fast:
                want = ctx.n_local * (ctx.process_count - 1) * SCATTER_M * 4
            else:
                want = calls * crossing * wire_payload_bytes(SCATTER_SLOT, 4, w)
            out[f"{key}:bytes"] = (transport.stats()["bytes"], want)


def _zero_run(sm, feats, targets, name, steps, ckpt=None):
    _, grads_on, wire = next(t for t in ZERO_TIERS if t[0] == name)
    os.environ.update(BLUEFOG_SHARD="1", BLUEFOG_SHARD_GRADS=grads_on)
    try:
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(1e-3))
        opt.compression = wire
        params = sm.replicate()
        state = opt.init(params)
        if ckpt is not None:
            _step, params, state = bft.checkpoint.restore(ckpt, optimizer=opt)
        for _ in range(steps):
            _, grads = sm.loss_and_grad(params, feats, targets)
            opt.step(params, state, grads)
        return opt, params, state
    finally:
        del os.environ["BLUEFOG_SHARD"], os.environ["BLUEFOG_SHARD_GRADS"]


def _zero(out, rows):
    sm, feats, targets = _mlp(rows)
    for name, _grads_on, _wire in ZERO_TIERS:
        opt, params, state = _zero_run(sm, feats, targets, name, STEPS)
        out[f"{name}:params"] = params
        out[f"{name}:state"] = [leaf.clone() for leaf in _leaves(state)]
        opt.free()


def _leaves(tree):
    from bluefog_tpu_torch.optimizers import tree_leaves

    return tree_leaves(tree)


def _pushsum_run(rows, steps, ckpt=None, save=None):
    """``steps`` push-sum steps of the tiny ResNet on the int8 window wire
    (from the checkpoint ``ckpt`` when given), saving to ``save`` after
    them; returns ``(estimate, window value, p)``."""
    os.environ["BLUEFOG_WINDOW_WIRE"] = "int8"
    try:
        sm, images, labels = _tiny_resnet(rows)
        opt = bft.DistributedPushSumOptimizer(bft.sgd(0.1, momentum=0.9))
        state = opt.init(sm.replicate())
        if ckpt is not None:
            _step, _params, state = bft.checkpoint.restore(ckpt, optimizer=opt, extra=sm.buffers)
        for _ in range(steps):
            _, grads = sm.loss_and_grad(opt.params(), images, labels)
            opt.step(state, grads)
        if save is not None:
            bft.checkpoint.save(save, steps, opt.params(), state, optimizer=opt,
                                extra=sm.buffers)
        win = bft.get_context().windows[opt._name]
        got = (opt.params(), win.value.clone(), win.p.clone())
        opt.free()
        return got
    finally:
        del os.environ["BLUEFOG_WINDOW_WIRE"]


def _checkpoint(out, ctx, rows, ref_dir):
    """Save after ``STEPS`` steps (push-sum int8, zero2/int8), then each
    process restores the stacked run's files (``ref_dir``) and takes one
    step."""
    bft.set_topology(topo.ExponentialGraph(SIZE))
    mine = os.path.abspath("ckpt")
    _pushsum_run(rows, STEPS, save=os.path.join(mine, "push_sum"))
    sm, feats, targets = _mlp(rows)
    opt, params, state = _zero_run(sm, feats, targets, "zero2/int8", STEPS)
    bft.checkpoint.save(os.path.join(mine, "zero2"), STEPS, params, state, optimizer=opt)
    opt.free()
    if ctx.process_count == 1:
        open(os.path.join(mine, "ready"), "w").close()
    else:
        marker = os.path.join(ref_dir, "ready")
        deadline = time.monotonic() + CKPT_WAIT
        while not os.path.exists(marker):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the stacked run wrote no checkpoint to {ref_dir}")
            time.sleep(0.2)
    out["ckpt:push_sum:next"] = _pushsum_run(rows, 1, ckpt=os.path.join(ref_dir, "push_sum"))
    _opt, params, state = _zero_run(sm, feats, targets, "zero2/int8", 1,
                                    ckpt=os.path.join(ref_dir, "zero2"))
    out["ckpt:zero2:next"] = (params, [leaf.clone() for leaf in _leaves(state)])
    _opt.free()


def _anchor(out):
    """tests/test_multiprocess.py's push-sum leg at 8 workers."""
    bft.set_topology(topo.RingGraph(SIZE, connect_style=1), is_weighted=True)
    c = np.random.RandomState(0).randn(SIZE, 3).astype(np.float32)
    target = bft.worker_values(list(c))
    lr = lambda count: 0.4 * torch.pow(torch.tensor(0.5), count.to(torch.float32) / 20)  # noqa
    opt = bft.DistributedPushSumOptimizer(bft.sgd(lr))
    state = opt.init({"w": target.clone()})
    cur = opt.params()
    for _ in range(ANCHOR_STEPS):
        cur, state = opt.step(state, {"w": cur["w"] - target})
    out["anchor"] = cur["w"].clone()
    opt.free()
    bft.turn_off_win_ops_with_associated_p()


def state_cases(nodes_per_machine, ref_dir):
    """Every case on the active process level: ``{name: this process's
    rows}`` (all rows with one process), the host-side records and the
    byte counts."""
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=nodes_per_machine)
    rows = list(ctx.rows)
    out = {"rows": torch.tensor(rows)}
    _window_ops(out, ctx)
    _window_optimizers(out, ctx, rows)
    _async(out, ctx, rows)
    _scatter(out, ctx)
    _zero(out, rows)
    _anchor(out)
    _checkpoint(out, ctx, rows, ref_dir)
    bft.barrier()
    bft.shutdown()
    return out


WORKER = """
import os, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
import test_torch_transport_state as T
pid = int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
out = T.state_cases({level!r}, {ref_dir!r})
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
    """``{"ref": stacked results, config: [per-process results], "dirs":
    {job: its directory}}``: the one-process reference (with the machines
    of 4 workers) and every configuration, started together."""
    tmp = tmp_path_factory.mktemp("transport_state")
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


def _row_keys(ref, base):
    """The tensor cases ``base`` and ``base:...``."""
    return sorted(k for k, v in ref.items()
                  if (k == base or k.startswith(base + ":")) and isinstance(v, torch.Tensor))


def _check_rows(runs, config, base):
    ref = runs["ref"]
    keys = _row_keys(ref, base)
    assert keys, base
    for p, res in enumerate(runs[config]):
        rows = res["rows"]
        for key in keys:
            assert _same(res[key], ref[key][rows]), f"{config} process {p}: {key}"


def _configs():
    return [c[0] for c in CONFIGS]


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", WIN_WIRES)
@pytest.mark.parametrize("p_lane", ["nop", "p"])
def test_window_ops_bitwise_the_stacked_rows(runs, config, wire, p_lane):
    """put, accumulate, get and update: every lane after every op, the
    versions and p of the local ranks, the global age lane."""
    key = f"win:{wire}:{p_lane}"
    _check_rows(runs, config, key)
    ref = runs["ref"]
    for p, res in enumerate(runs[config]):
        rows = res["rows"].tolist()
        assert res[f"{key}:version"] == [ref[f"{key}:version"][r] for r in rows], p
        assert res[f"{key}:age"] == ref[f"{key}:age"], p
        assert _same(res[f"{key}:p"], ref[f"{key}:p"][rows]), p


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", WIN_WIRES)
@pytest.mark.parametrize("p_lane", ["nop", "p"])
def test_window_exchange_bytes_equal_the_edge_formula(runs, config, wire, p_lane):
    key = f"win:{wire}:{p_lane}"
    for p, res in enumerate(runs[config]):
        for op in ("put", "acc", "get"):
            sent, want = res[f"{key}:{op}:bytes"]
            assert sent == want, (config, p, op, sent, want)
    for op in ("put", "acc", "get"):
        assert runs["ref"][f"{key}:{op}:bytes"][0] == 0


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("mode", ["push_sum", "win_put", "pull_get"])
def test_window_optimizers_bitwise_the_stacked_rows(runs, config, mode):
    _check_rows(runs, config, mode)


@pytest.mark.parametrize("config", _configs())
def test_pushsum_mass_across_processes(runs, config):
    """The x mass summed over the processes (one ``gather_rows``) holds to
    1e-5 of its ``sum |x|`` over an lr-0 step, and the p mass is exactly 8,
    as in the stacked run."""
    for p, res in enumerate(runs[config]):
        (x0, abs0, p0), (x1, _abs1, p1) = (res["mass:push_sum:0"].tolist(),
                                           res["mass:push_sum:1"].tolist())
        assert abs(x1 - x0) <= 1e-5 * abs0, (p, x0, x1)
        assert p0 == SIZE and p1 == SIZE, (p, p0, p1)
        assert torch.equal(res["mass:push_sum:1"], runs["ref"]["mass:push_sum:1"]), p


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_async_ticks_bitwise_the_stacked_rows(runs, config, wire):
    """Estimates, losses, momentum, window lanes and batch statistics
    bitwise; ages, advisories and the summary equal (the gate's advisory
    names the slow rank)."""
    key = f"async:{wire}"
    _check_rows(runs, config, key)
    ref = runs["ref"]
    for p, res in enumerate(runs[config]):
        rows = res["rows"]
        for name, t in ref[f"{key}:stats"].items():
            assert _same(res[f"{key}:stats"][name], t[rows]), (p, name)
        assert res[f"{key}:host"] == ref[f"{key}:host"], p
    assert any(a["slow_ranks"] == [SLOW] for a in ref[f"{key}:host"]["advisories"])


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", SCATTER_WIRES)
def test_reduce_scatter_bitwise_the_stacked_rows(runs, config, wire):
    _check_rows(runs, config, f"scatter:{wire}")


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("wire", SCATTER_WIRES)
def test_reduce_scatter_bytes_equal_the_edge_formula(runs, config, wire):
    """Every round's crossing edges times ``wire_payload_bytes`` of a slot
    (the fast form: every row to every other process)."""
    for p, res in enumerate(runs[config]):
        base = f"scatter:{wire}"
        for key in (base + ":bytes", base + ":fast:bytes"):
            if key not in res:
                continue
            sent, want = res[key]
            assert sent == want and sent > 0, (config, p, key, sent, want)


@pytest.mark.parametrize("config", _configs())
@pytest.mark.parametrize("tier", [t[0] for t in ZERO_TIERS])
def test_zero_steps_bitwise_the_stacked_rows(runs, config, tier):
    ref = runs["ref"]
    for p, res in enumerate(runs[config]):
        rows = res["rows"]
        assert _same(res[f"{tier}:params"], ref[f"{tier}:params"][rows]), p
        for i, (got, want) in enumerate(zip(res[f"{tier}:state"], ref[f"{tier}:state"])):
            assert _same(got, want[rows]), (p, i)


def _load_state(directory):
    return torch.load(os.path.join(directory, "state.pt"), map_location="cpu",
                      weights_only=True)


def _tree_equal(a, b, where="") -> None:
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
@pytest.mark.parametrize("run", ["push_sum", "zero2"])
def test_checkpoint_written_across_processes_is_the_stacked_file(runs, config, run):
    """One ``state.pt`` and sidecar, whatever the layout, tensor for tensor
    the stacked run's."""
    ref_dir = os.path.join(runs["dirs"]["ref"], "ckpt", run)
    mine = os.path.join(runs["dirs"][config], "ckpt", run)
    _tree_equal(_load_state(os.path.join(mine, str(STEPS))),
                _load_state(os.path.join(ref_dir, str(STEPS))))
    with open(os.path.join(mine, f"{STEPS}.graph.json")) as f, \
            open(os.path.join(ref_dir, f"{STEPS}.graph.json")) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("config", _configs())
def test_checkpoint_restored_across_processes_steps_as_stacked(runs, config):
    """Each process restores the one-process checkpoint and takes the next
    step: its rows equal the stacked run's after the same restore."""
    ref = runs["ref"]
    for p, res in enumerate(runs[config]):
        rows = res["rows"]
        est, value, pv = res["ckpt:push_sum:next"]
        west, wvalue, wp = ref["ckpt:push_sum:next"]
        assert _same(est, west[rows]) and _same(value, wvalue[rows]) and _same(pv, wp[rows]), p
        params, state = res["ckpt:zero2:next"]
        wparams, wstate = ref["ckpt:zero2:next"]
        assert _same(params, wparams[rows]), p
        for got, want in zip(state, wstate):
            assert _same(got, want[rows]), p


def test_checkpoint_of_two_processes_restores_in_one(runs):
    """The 2 x 4 run's checkpoints restored in this process (one process,
    8 workers): the next step bitwise the stacked run's."""
    ctx = bft.init(size=SIZE, device="cpu", nodes_per_machine=CONFIGS[0][2])
    try:
        bft.set_topology(topo.ExponentialGraph(SIZE))
        rows = list(ctx.rows)
        mine = os.path.join(runs["dirs"]["2x4"], "ckpt")
        got = _pushsum_run(rows, 1, ckpt=os.path.join(mine, "push_sum"))
        sm, feats, targets = _mlp(rows)
        opt, params, state = _zero_run(sm, feats, targets, "zero2/int8", 1,
                                       ckpt=os.path.join(mine, "zero2"))
        opt.free()
    finally:
        bft.shutdown()
    for a, b in zip(got, runs["ref"]["ckpt:push_sum:next"]):
        assert _same(a, b)
    wparams, wstate = runs["ref"]["ckpt:zero2:next"]
    assert _same(params, wparams)
    for a, b in zip(_leaves(state), wstate):
        assert _same(a, b)


def _jax_pushsum(cpu_devices):
    """tests/test_multiprocess.py's push-sum leg, stacked on 8 virtual CPU
    devices: the final estimates ``[8, 3]``."""
    import jax
    import optax

    import bluefog_tpu as bf
    import bluefog_tpu.topology as tu

    c = np.random.RandomState(0).randn(SIZE, 3).astype(np.float32)
    bf.init(devices=cpu_devices[:SIZE])
    try:
        bf.set_topology(tu.RingGraph(SIZE, connect_style=1), is_weighted=True)
        wopt = bf.DistributedPushSumOptimizer(optax.sgd(optax.exponential_decay(0.4, 20, 0.5)))
        cur = {"w": bf.worker_values(list(c))}
        wstate = wopt.init(cur)
        grad_fn = jax.jit(lambda w, tgt: w - tgt)
        target = bf.worker_values(list(c))
        for _ in range(ANCHOR_STEPS):
            cur, wstate = wopt.step(wstate, {"w": grad_fn(cur["w"], target)})
        out = np.asarray(cur["w"])
        wopt.free()
        bf.turn_off_win_ops_with_associated_p()
    finally:
        bf.shutdown()
    return c, out


def test_pushsum_leg_matches_the_jax_package(runs, cpu_devices):
    """The push-sum leg of ``tests/test_multiprocess.py`` in 2 x 4
    processes against the JAX package's stacked run: final estimates and
    loss within rtol 1e-4 / atol 1e-5, and the loss below 0.2 x its
    start, as that test asserts."""
    c, want = _jax_pushsum(cpu_devices)
    got = np.concatenate([res["anchor"].numpy() for res in runs["2x4"]])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    loss = lambda w: float(0.5 * np.mean(np.sum((w - c.mean(0)) ** 2, -1)))  # noqa: E731
    np.testing.assert_allclose(loss(got), loss(want), rtol=1e-4, atol=1e-5)
    assert loss(got) < 0.2 * loss(c)
    assert _same(runs["2x4"][0]["anchor"], runs["ref"]["anchor"][:4])
