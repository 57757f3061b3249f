# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The repo's trace tools on what the port writes (the trace-fusion tests
of ``tests/test_flight.py`` for ``bluefog_tpu_torch``).

``tools/trace_merge.py``, ``tools/metrics_report.py`` and
``tools/federation_report.py`` read the port's flight dumps, timelines,
metrics JSONL and health dump unchanged:

- stacked, the session of ``tests/test_flight.py::_run_killed_session``
  (8 workers on ``ExponentialTwoGraph(8)``, ATC ``sgd(0.05)``, an
  ``average`` elastic session killing rank 3 at step 4, the steps through
  ``bft.elastic.guard``): the facts the JAX tests hold for JAX's own
  artifacts, and the report equal to the one of a JAX run of the same
  session;
- across processes, ``bfrun-torch -H localhost:4,localhost:4`` on gloo
  with ``--flight-dir`` and ``--timeline-filename``, rank 5 killed at step
  4: two dumps and two timelines merge into 8 rank lanes and 2 host lanes,
  a postmortem naming rank 5 with the stacked run's waiters. The same
  processes compute ``scaling.gossip_comm_stats``: every process returns
  the stacked dict.

The process run starts once, in a module fixture, under
``OMP_NUM_THREADS=1``.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import flight as jflight, health as jhealth
from bluefog_tpu import topology as jtopo
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import flight, health, metrics, scaling, topology as ttopo
from bluefog_tpu_torch.collective.plan import plan_from_topology, schedule_from_dynamic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.trace_merge import merge_and_analyze  # noqa: E402

SIZE = 8
KILL_STEP = 4
MP_KILL_RANK = 5
MP_TIMEOUT = 180
PAYLOAD = 1500  # gossip_comm_stats' payload, not a multiple of 512


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for env in ("BLUEFOG_FLIGHT", "BLUEFOG_FLIGHT_DIR", "BLUEFOG_TIMELINE",
                "BLUEFOG_FLIGHT_CAPACITY", "BLUEFOG_METRICS", "BLUEFOG_METRICS_FILE",
                "BLUEFOG_METRICS_INTERVAL", "BLUEFOG_PODS", "BLUEFOG_PROCESS_ID"):
        monkeypatch.delenv(env, raising=False)
    yield
    flight.reconfigure()


def _base_plan():
    return plan_from_topology(ttopo.ExponentialTwoGraph(SIZE))


def _rounds_by_edge(plan):
    out = {}
    for ri, rnd in enumerate(plan.rounds):
        for s, d in rnd.perm:
            out.setdefault((s, d), ri)
    return out


def run_killed_session(path, kill_rank=3, kill_step=KILL_STEP, steps=8):
    """The port's session of ``tests/test_flight.py::_run_killed_session``,
    its flight dump and timeline under ``path``."""
    env = {"BLUEFOG_FLIGHT_DIR": str(path), "BLUEFOG_TIMELINE": str(path / "trace_")}
    os.environ.update(env)
    try:
        flight.reconfigure()
        bft.init(device="cpu")
        bft.set_topology(ttopo.ExponentialTwoGraph(SIZE))
        session = bft.elastic.start(policy="average")
        session.inject("kill", rank=kill_rank, step=kill_step)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
        guard = bft.elastic.guard(opt)
        params = {"w": bft.worker_values(lambda r: np.float32([r, r]))}
        state = opt.init(params)
        for _ in range(steps):
            params, state = guard.step(params, state, {"w": torch.zeros_like(params["w"])})
        bft.flight_dump()
        bft.elastic.stop()
        bft.shutdown()  # closes the env-owned timeline
    finally:
        for k in env:
            os.environ.pop(k, None)


def run_killed_session_jax(path, devices, kill_rank=3, kill_step=KILL_STEP, steps=8):
    """The JAX package's own session, as ``tests/test_flight.py`` runs it."""
    env = {"BLUEFOG_FLIGHT_DIR": str(path), "BLUEFOG_TIMELINE": str(path / "trace_")}
    os.environ.update(env)
    try:
        jflight.reconfigure()
        bf.init(devices=devices[:SIZE])
        bf.set_topology(jtopo.ExponentialTwoGraph(SIZE))
        session = bf.elastic.start(policy="average")
        session.inject("kill", rank=kill_rank, step=kill_step)
        opt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.05))
        guard = bf.elastic.guard(opt)
        params = {"w": bf.worker_values(lambda r: np.float32([r, r]))}
        state = opt.init(params)
        for _ in range(steps):
            params, state = guard.step(params, state, {"w": jnp.zeros_like(params["w"])})
        bf.flight_dump()
        bf.elastic.stop()
        bf.shutdown()
    finally:
        for k in env:
            os.environ.pop(k, None)
        jflight.reconfigure()


def _valid_json_artifacts(path):
    for f in glob.glob(str(path / "*.json")):
        with open(f) as fh:
            json.load(fh)


def _tool(args):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                                             + os.environ.get("PYTHONPATH", "")))


def _lanes(merged):
    return {(e["pid"], e["args"]["name"]) for e in merged["traceEvents"] if e.get("ph") == "M"}


def _expected_waiters(kill_rank):
    return sorted(d for (s, d) in _rounds_by_edge(_base_plan()) if s == kill_rank)


# -- stacked ------------------------------------------------------------------------


def test_merge_postmortem_and_round_counts(tmp_path):
    kill_rank = 3
    run_killed_session(tmp_path, kill_rank)
    _valid_json_artifacts(tmp_path)
    merged, report = merge_and_analyze(str(tmp_path))
    assert json.loads(json.dumps(merged))
    lanes = _lanes(merged)
    for r in range(SIZE):
        assert (r, f"rank {r}") in lanes
    assert any(n.startswith("host 0") for _p, n in lanes)
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X" and e["pid"] < SIZE]
    assert spans and all(e["dur"] >= 1 for e in spans)
    assert all(isinstance(e.get("ts"), int) for e in spans)

    base = _base_plan()
    pre = [s for s in report["per_step_rounds"] if s["step"] < KILL_STEP]
    assert pre and all(s["rounds"] == len(base.rounds) for s in pre)
    post = [s for s in report["per_step_rounds"] if s["step"] > KILL_STEP]
    assert post and all(s["rounds"] != 0 for s in post)

    pm = report["hang_postmortem"]
    assert pm is not None and pm["dead_ranks"] == [kill_rank]
    assert any(v["rank"] == kill_rank and v["state"] == "dead" for v in pm["verdicts"])
    by_edge = _rounds_by_edge(base)
    assert sorted(w["rank"] for w in pm["waiters"]) == _expected_waiters(kill_rank)
    for w in pm["waiters"]:
        assert w["waiting_on"] == kill_rank
        assert by_edge[(kill_rank, w["rank"])] == w["round"]
        assert w["edge"] == [kill_rank, w["rank"]]
    assert pm["last_completed_step"][str(kill_rank)] == KILL_STEP - 1
    assert report["steps"]
    for s in report["steps"]:
        assert set(s["per_rank_us"]) and "straggler" in s


def test_report_equals_the_jax_report(tmp_path, cpu_devices):
    """The same session through both packages: the same dead ranks,
    waiters (edge and round each) and per-step rounds."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    run_killed_session(tmp_path / "port")
    run_killed_session_jax(tmp_path / "jax", cpu_devices)
    _, got = merge_and_analyze(str(tmp_path / "port"))
    _, want = merge_and_analyze(str(tmp_path / "jax"))
    assert got["per_step_rounds"] == want["per_step_rounds"]
    for key in ("dead_ranks", "waiters", "last_completed_step"):
        assert got["hang_postmortem"][key] == want["hang_postmortem"][key], key
    assert got["ranks"] == want["ranks"] and got["plan_rounds"] == want["plan_rounds"]


def test_postmortem_survives_ring_eviction(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLIGHT_CAPACITY", "256")
    kill_rank = 3
    run_killed_session(tmp_path, kill_rank, steps=200)
    dump = json.load(open(glob.glob(str(tmp_path / "flight_*.json"))[0]))
    assert not any(e["kind"] == "fault" for e in dump["events"]), "ring did not wrap"
    assert dump["fault_events"]
    _, report = merge_and_analyze(str(tmp_path))
    pm = report["hang_postmortem"]
    assert pm["dead_ranks"] == [kill_rank]
    assert sorted(w["rank"] for w in pm["waiters"]) == _expected_waiters(kill_rank)
    assert pm["last_completed_step"][str(kill_rank)] == KILL_STEP - 1


def test_trace_merge_cli(tmp_path):
    run_killed_session(tmp_path)
    report_path = tmp_path / "report.json"
    out = _tool([os.path.join("tools", "trace_merge.py"), str(tmp_path), "--report",
                 str(report_path)])
    assert out.returncode == 0, out.stderr
    assert "hang postmortem" in out.stdout
    assert "waiting on rank 3" in out.stdout
    assert json.load(open(tmp_path / "merged_trace.json"))["traceEvents"]
    assert json.load(open(report_path))["hang_postmortem"]["dead_ranks"] == [3]
    _valid_json_artifacts(tmp_path)


def test_metrics_report_flight_mode(tmp_path):
    run_killed_session(tmp_path)
    out = _tool([os.path.join("tools", "metrics_report.py"), "--flight", str(tmp_path), "--json"])
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["dead_ranks"] == [3]
    assert report["dumps"] and report["dumps"][0]["events"] > 0


def test_metrics_report_reads_the_port_jsonl_with_quantiles(tmp_path, monkeypatch):
    """``BLUEFOG_METRICS_FILE`` of an async run (the ``bluefog.async.age``
    histogram): the report's p50/p90/p99 series are the last snapshot's
    quantiles (the counterpart of ``tests/test_metrics.py``'s synthetic
    row)."""
    path = tmp_path / "run.jsonl"
    monkeypatch.setenv("BLUEFOG_METRICS", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_INTERVAL", "1")
    monkeypatch.setenv("BLUEFOG_METRICS_FILE", str(path))
    metrics.reset()
    bft.init(device="cpu")
    try:
        x = bft.worker_values(lambda r: np.arange(64, dtype=np.float32) * 0.01 + r)
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
        step = bft.make_async_train_step(opt, lambda w, t: ((w - t) ** 2).sum(),
                                         cadence={3: 2, 6: 3})
        params, state = x.clone(), opt.init(x.clone())
        for _ in range(6):
            params, state, _loss = step(params, state, torch.zeros_like(x))
        step.engine.free()
        bft.metrics_export()
    finally:
        bft.shutdown()
        metrics.reset()
    rows = [json.loads(line) for line in open(path).read().splitlines()]
    last = rows[-1]["metrics"]["bluefog.async.age"]
    assert last["type"] == "histogram" and last["count"] > 0
    out = _tool([os.path.join("tools", "metrics_report.py"), str(path), "--json"])
    assert out.returncode == 0, out.stderr
    series = json.loads(out.stdout)["series"]
    for q in ("p50", "p90", "p99"):
        assert series[f"bluefog.async.age.{q}"]["last"] == last[q]


def _strip_times(obj):
    """A report without the fields that carry a time."""
    timed = ("ts", "time", "timestamp", "unix_ns", "wall_s", "elapsed_s")
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items() if k not in timed}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_federation_report_of_the_port_health_dump_equals_jax(tmp_path, cpu_devices,
                                                              monkeypatch):
    """``tools/federation_report.py --health`` on ``HealthPlane.dump`` of 2
    pods x 4 (its ``federation`` block): the ``--json`` report equals the
    one of the JAX package's dump of the same fleet."""
    monkeypatch.setenv("BLUEFOG_PODS", "2")
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    try:
        jhealth.start(interval=1)
        health.start(interval=1)
        jhealth.dump(str(tmp_path / "jax.json"))
        health.dump(str(tmp_path / "port.json"))
    finally:
        jhealth.stop()
        health.stop()
        bf.shutdown()
        bft.shutdown()
    reports = {}
    for name in ("port", "jax"):
        out = _tool([os.path.join("tools", "federation_report.py"), "--health",
                     str(tmp_path / f"{name}.json"), "--json"])
        assert out.returncode == 0, out.stderr
        reports[name] = _strip_times(json.loads(out.stdout))
    assert reports["port"] == reports["jax"]
    assert reports["port"]["live"]["layout"]["n_pods"] == 2
    assert reports["port"]["live"]["gateways"] == [0, 4]


# -- across processes -----------------------------------------------------------------


MP_PROGRAM = """
import json, os, sys
import numpy as np
import torch
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import scaling, topology as topo
from bluefog_tpu_torch.collective.plan import plan_from_topology, schedule_from_dynamic
ctx = bft.init(device="cpu")
bft.set_topology(topo.ExponentialTwoGraph(8))
session = bft.elastic.start(policy="average")
session.inject("kill", rank={kill_rank}, step={kill_step})
opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
guard = bft.elastic.guard(opt)
params = {{"w": bft.worker_values(lambda r: np.float32([r, r]))}}
state = opt.init(params)
for _ in range(8):
    params, state = guard.step(params, state, {{"w": torch.zeros_like(params["w"])}})
bft.flight_dump()
bft.elastic.stop()
bft.set_topology(topo.ExponentialGraph(8))
one_peer = schedule_from_dynamic(8, lambda r: topo.GetDynamicOnePeerSendRecvRanks(
    topo.ExponentialGraph(8), r)).plans[0]
stats = {{
    "exp2": scaling.gossip_comm_stats(plan_from_topology(topo.ExponentialTwoGraph(8)), {payload},
                                      include_plan=True),
    "one_peer": scaling.gossip_comm_stats(one_peer, {payload}),
    "star": scaling.gossip_comm_stats(plan_from_topology(topo.StarGraph(8), weighted=True),
                                      {payload}),
    "allreduce": scaling.gossip_comm_stats(one_peer, {payload}, mode="allreduce"),
}}
with open(os.path.join(sys.argv[1], f"stats_{{ctx.process_index}}.json"), "w") as f:
    json.dump(stats, f)
bft.shutdown()
sys.stdout.write(f"MP_OK {{ctx.process_index}}\\n")
sys.stdout.flush()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    """``bfrun-torch -np 8 -H localhost:4,localhost:4`` with ``--flight-dir``
    and ``--timeline-filename``: rank 5 killed at step 4, then the scaling
    stats. Returns the artifacts' directory."""
    root = tmp_path_factory.mktemp("mp_trace")
    out_dir = root / "artifacts"
    script = root / "prog.py"
    script.write_text(MP_PROGRAM.format(kill_rank=MP_KILL_RANK, kill_step=KILL_STEP,
                                        payload=PAYLOAD))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", str(SIZE), "-H",
         "localhost:4,localhost:4", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--num-processes", "2", "--flight-dir", str(out_dir), "--timeline-filename",
         str(out_dir / "trace_"), str(script), str(root)],
        capture_output=True, text=True, timeout=MP_TIMEOUT, env=env, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sorted(l.split()[1] for l in proc.stdout.splitlines() if l.startswith("MP_OK")) == [
        "0", "1"]
    return root


def test_two_processes_merge_into_one_trace(mp_run):
    out_dir = mp_run / "artifacts"
    names = sorted(os.path.basename(f) for f in glob.glob(str(out_dir / "*.json")))
    assert names == ["flight_0.json", "flight_1.json", "trace_0.json", "trace_1.json"]
    _valid_json_artifacts(out_dir)
    merged, report = merge_and_analyze(str(out_dir))
    lanes = _lanes(merged)
    assert sorted(p for p, n in lanes if n.startswith("rank ")) == list(range(SIZE))
    assert sorted(n for _p, n in lanes if n.startswith("host ")) == [
        "host 0 (controller)", "host 1 (controller)"]
    assert report["processes"] == 2 and report["ranks"] == list(range(SIZE))
    # before the kill every rank's step (ranks 0-3 in process 0, 4-7 in
    # process 1) ran the plan's rounds
    base = _base_plan()
    for e in merged["traceEvents"]:
        if e.get("ph") == "X" and e["pid"] < SIZE and e["args"]["step"] < KILL_STEP:
            assert e["args"]["rounds"] == len(base.rounds), e
    pre_pids = {e["pid"] for e in merged["traceEvents"]
                if e.get("ph") == "X" and e["pid"] < SIZE and e["args"]["step"] < KILL_STEP}
    assert pre_pids == set(range(SIZE))
    pm = report["hang_postmortem"]
    assert pm["dead_ranks"] == [MP_KILL_RANK]
    assert pm["last_completed_step"][str(MP_KILL_RANK)] == KILL_STEP - 1


def test_two_processes_postmortem_equals_the_stacked_run(mp_run, tmp_path):
    """The merged report of the two processes names rank 5's waiters, edge
    and round each, and every step's rounds as the stacked run with rank 5
    killed does."""
    run_killed_session(tmp_path, MP_KILL_RANK)
    _, stacked = merge_and_analyze(str(tmp_path))
    _, mp = merge_and_analyze(str(mp_run / "artifacts"))
    assert mp["hang_postmortem"]["waiters"] == stacked["hang_postmortem"]["waiters"]
    assert sorted(w["rank"] for w in mp["hang_postmortem"]["waiters"]) == _expected_waiters(
        MP_KILL_RANK)
    assert mp["per_step_rounds"] == stacked["per_step_rounds"]
    assert mp["hang_postmortem"]["dead_ranks"] == stacked["hang_postmortem"]["dead_ranks"]


def test_two_processes_trace_merge_cli_names_rank_5(mp_run):
    out = _tool([os.path.join("tools", "trace_merge.py"), str(mp_run / "artifacts"), "-o",
                 str(mp_run / "merged_cli.json")])
    assert out.returncode == 0, out.stderr
    assert "hang postmortem" in out.stdout and "waiting on rank 5" in out.stdout
    assert "merged 2 process(es), 8 rank lanes" in out.stdout
    flight_out = _tool([os.path.join("tools", "metrics_report.py"), "--flight",
                        str(mp_run / "artifacts"), "--json"])
    assert flight_out.returncode == 0, flight_out.stderr
    assert json.loads(flight_out.stdout)["dead_ranks"] == [MP_KILL_RANK]


def test_gossip_comm_stats_across_processes_equal_the_stacked_dicts(mp_run):
    """Each process of the 2 x 4 run counts the rounds of the route its
    combine posted; every process returns the stacked run's dict."""
    bft.init(device="cpu")
    try:
        one_peer = schedule_from_dynamic(SIZE, lambda r: ttopo.GetDynamicOnePeerSendRecvRanks(
            ttopo.ExponentialGraph(SIZE), r)).plans[0]
        want = {
            "exp2": scaling.gossip_comm_stats(_base_plan(), PAYLOAD, include_plan=True),
            "one_peer": scaling.gossip_comm_stats(one_peer, PAYLOAD),
            "star": scaling.gossip_comm_stats(
                plan_from_topology(ttopo.StarGraph(SIZE), weighted=True), PAYLOAD),
            "allreduce": scaling.gossip_comm_stats(one_peer, PAYLOAD, mode="allreduce"),
        }
    finally:
        bft.shutdown()
    want = json.loads(json.dumps(want))
    for p in (0, 1):
        got = json.load(open(mp_run / f"stats_{p}.json"))
        assert got == want, p
    assert want["exp2"]["collective-permute"] == {"count": 3, "bytes": 3 * PAYLOAD * 4}
