# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Every ``bluefog.*`` series the port emits is a row of the series
reference of ``docs/metrics.md``, or, for a series the JAX package has no
counterpart of (the multi-process transport's), a row of the port's own
table in ``README.md`` (between the ``torch-series-reference`` markers),
by the rules of ``tests/test_metric_names.py``: double-quoted literals,
f-string ``{...}`` segments and the docs' ``<x>`` segments as wildcards,
and a literal that others extend with a dot is a namespace, which must
have a row under it."""

import glob
import os
import re

from test_metric_names import _LITERAL_RE, _doc_patterns, _matches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bluefog_tpu_torch")
# a literal that names a ``torch.profiler`` range (the argument of
# ``record_function``) is no series: the scan leaves it out
_RANGE_RE = re.compile(r'record_function\(\s*f?"(bluefog\.[^"\n]*)"')


def _port_patterns():
    raw = set()
    for path in glob.glob(PKG + "/**/*.py", recursive=True):
        with open(path) as f:
            text = f.read()
        ranges = {m.start(1) for m in _RANGE_RE.finditer(text)}
        for m in _LITERAL_RE.finditer(text):
            if m.start(1) not in ranges:
                raw.add(re.sub(r"\{[^}]*\}", "*", m.group(1)))
    namespaces = {r for r in raw if any(o.startswith(r + ".") for o in raw if o != r)}
    return raw - namespaces, namespaces


def _port_doc_patterns():
    """The rows of the port's own series table in ``README.md``."""
    text = open(os.path.join(REPO, "README.md")).read()
    m = re.search(r"<!-- torch-series-reference:begin -->(.*?)"
                  r"<!-- torch-series-reference:end -->", text, re.S)
    assert m, "README.md lost its torch-series-reference markers"
    return {re.sub(r"<[^>]*>", "*", row.group(1))
            for row in re.finditer(r"^\|\s*`([^`]+)`", m.group(1), re.M)}


def test_port_only_series_are_the_ports_and_absent_from_jax():
    """The port's table holds only series the port emits and the JAX
    package's reference lacks."""
    code, _ = _port_patterns()
    docs = _doc_patterns()
    own = _port_doc_patterns()
    assert own == {"bluefog.transport.bytes", "bluefog.transport.staged"}
    for row in own:
        assert row in code
        assert not any(_matches(row, d) for d in docs), row


def test_every_series_the_port_emits_is_documented():
    code, namespaces = _port_patterns()
    docs = _doc_patterns() | _port_doc_patterns()
    undocumented = sorted(c for c in code if not any(_matches(c, d) for d in docs))
    assert not undocumented, (
        f"series emitted in bluefog_tpu_torch/ but missing from docs/metrics.md: {undocumented}")
    for ns in sorted(namespaces):
        assert any(d.startswith(ns + ".") for d in docs), ns


def test_the_guard_sees_the_port_series():
    code, namespaces = _port_patterns()
    assert {"bluefog.stalls", "bluefog.plan_cache.hits", "bluefog.wire_bytes",
            "bluefog.async.ticks", "bluefog.window_ops.*", "bluefog.shard.grads",
            "bluefog.doctor.advisory.*", "bluefog.allgather.quant_err"} <= code | namespaces
    assert "bluefog.gossip" in namespaces
    # the elastic series, under the JAX package's names
    assert {f"bluefog.elastic.{k}" for k in (
        "faults", "suspects", "stalls", "slow_faults", "repairs", "dead_ranks", "epoch",
        "last_detect_steps", "repair_ms", "migrations", "rejoins")} | {
        "bluefog.async.rewindows", "bluefog.shard.reshards"} <= code
    # the observatories' series, under the JAX package's names
    assert {"bluefog.doctor.step_ms", "bluefog.doctor.comm_wire_ms",
            "bluefog.doctor.anchor_tflops", "bluefog.doctor.samples",
            "bluefog.doctor.last_advisory_step", "bluefog.staleness.age",
            "bluefog.staleness.edge_age.*_*", "bluefog.staleness.age_mean",
            "bluefog.staleness.age_max", "bluefog.staleness.samples",
            "bluefog.staleness.wire_bytes", "bluefog.staleness.selfcheck_failures",
            "bluefog.staleness.window_age", "bluefog.staleness.window_age_max",
            "bluefog.staleness.window_mass_age_max", "bluefog.memory.samples",
            "bluefog.memory.live_bytes.*", "bluefog.memory.peak_bytes",
            "bluefog.memory.host_rss_bytes", "bluefog.memory.drift_bytes",
            "bluefog.memory.headroom_bytes", "bluefog.memory.oom_events",
            "bluefog.memory.phase_peak_bytes.*", "bluefog.elastic.oom_faults"} <= code
    assert "bluefog.memory.live_bytes" in namespaces
    # eager PyTorch builds no program: the port counts no recompiles (the
    # doctor's recompile_storm rule only reads the series, which stays 0)
    for path in glob.glob(PKG + "/**/*.py", recursive=True):
        with open(path) as f:
            text = f.read()
        assert not re.search(r'(counter|gauge|histogram)\(\s*"bluefog\.recompiles"', text), path
        if '"bluefog.recompiles"' in text:
            assert os.path.basename(path) == "attribution.py", path


def test_profiler_ranges_are_not_series():
    """``timeline.span``'s ``bluefog.<name>`` is a ``torch.profiler`` range:
    the scan finds it and counts it as no series."""
    with open(os.path.join(PKG, "timeline.py")) as f:
        assert [m.group(1) for m in _RANGE_RE.finditer(f.read())] == ["bluefog.{name}"]
    code, namespaces = _port_patterns()
    assert "bluefog.*" not in code and "bluefog" not in namespaces
