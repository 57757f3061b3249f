"""The harness finds every cell's pieces by name, ``BENCHMARK.json`` keeps
to the contract's shape, and one run makes the result line."""

import json
import re

import pytest

from gossipbench import harness
from gossipbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gossipbench"] and bench["command"][1] == "gossipbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gossipbench/") and all(NAME.match(k) for k in c["reduced"])
        assert harness.load_json(harness.ROOT / c["file"])["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"] if "workloads" in m else []) <= {w["name"] for w in bench["workloads"]}
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", tiny.cells())
def test_every_piece_is_found_by_name(name):
    bench = harness.benchmark()
    w = harness.cell(bench, name)
    cfg, m = harness.config(bench, w["config"]), harness.mix(w["traffic"])
    family = harness.family(cfg)
    for attr in ("build", "program_loss", "batches", "operands", "step_flops",
                 "attention_calls", "reference"):
        assert hasattr(family, attr), attr
    assert hasattr(harness.driver(m), "run")
    limits = harness.limits(name)
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(limits)
    for spec in harness.metrics_of(bench, "per_layer", name):
        assert callable(harness.reader(spec["name"]).read)
    assert family.reference.param_table(cfg)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell(harness.benchmark(), "no-such-cell")


@pytest.mark.parametrize("name", tiny.cells())
def test_result_line(name):
    result, lines = tiny.run(name)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_of(harness.benchmark(), "end_to_end", name)}
    assert set(result["metrics"]) == e2e
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert result["device"]["count"] == 1
    assert [line.split()[1] for line in lines] == list(result["checks"])
    json.dumps(result)


@pytest.mark.parametrize("name", tiny.cells())
def test_traced_result_line(name):
    result, _lines = tiny.run(name, trace=True)
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    per_layer = {m["name"] for m in harness.metrics_of(harness.benchmark(), "per_layer", name)}
    # no device on the CPU: the device readers find nothing and stay out
    assert set(result["metrics"]) <= per_layer and "host_ms" in result["metrics"]
    assert "mfu" not in result["metrics"] and "device_idle" not in result["metrics"]
    for part in ("device_ops", "idle_gaps"):
        assert len(result["breakdown"][part]) <= 10
