"""``lib/spans.py`` on synthetic Chrome traces: device work is the span's
that holds its launch (on any thread), whatever the device clock's offset;
a gap is the span's whose work ended it; the program's spans leave every
existing reading as it was. And ``phases.py`` on a cell cut to size."""

import dataclasses
import math
from types import SimpleNamespace

import pytest

from gossipbench import harness, phases
from gossipbench.lib import spans, trace
from gossipbench.tests import tiny

MS = 1000.0  # microseconds, the trace's unit


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": float(ts),
            "dur": float(dur), "tid": tid}


def _launch(corr, ts, tid=1, name="cudaLaunchKernel", dur=5.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": float(ts), "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": float(ts), "dur": float(dur),
            "args": {"correlation": corr}}


def _step_trace():
    """One step: a forward, a backward whose kernels the engine thread
    (tid 2) launches, an update and a combine inside the fused step; a
    gap of 40 us before the backward's work, 100 before the combine's."""
    return [
        _span("gossipbench.step", 0, 1000),
        _span("gossipbench.train_step", 0, 700),
        _span("gossipbench.sync", 700, 300),
        _span("bluefog.fused_train_step", 10, 680),
        _span("bluefog.forward", 20, 100),
        _span("bluefog.backward", 130, 300),
        _span("bluefog.update", 440, 50),
        _span("bluefog.combine", 500, 180),
        _launch(1, 30), _kernel("void at::native::conv_fwd(float*)", 40, 60, 1),
        _launch(2, 60), _kernel("gemm", 90, 40, 2),  # overlaps the first
        _launch(3, 140, tid=2), _kernel("gemm_bwd", 170, 200, 3),
        _launch(4, 145, tid=2, name="cudaMalloc"),
        _launch(5, 450), _kernel("sgd_kernel", 380, 30, 5),  # its start before its launch
        _launch(6, 510), _kernel("void (anonymous namespace)::encode_kernel<false>(float)",
                                 510, 50, 6),
        _launch(7, 600), _kernel("decode_accumulate_kernel", 660, 100, 7),
        _launch(8, 695), _kernel("fill", 765, 5, 8),  # launched in no program span
        _launch(9, 705, name="cudaDeviceSynchronize", dur=290),
        _op("aten::mm", 135, 20, tid=2), _op("aten::empty", 144, 3, tid=2),
        _op("aten::mm", 140, 20, tid=1),  # another thread's: not the launch's
        _op("aten::copy_", 595, 10),
    ]


def _op(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": float(ts), "dur": float(dur),
            "tid": tid}


def _shifted(events, by):
    return [{**e, "ts": e["ts"] + by} if e["cat"] == "kernel" else e for e in events]


def test_device_work_is_the_span_that_launched_it():
    s = spans.summarize(_step_trace())
    by = s.by_span
    assert math.isclose(by["forward"].device_s, 90e-6)  # 40-130, overlap counted once
    assert math.isclose(by["backward"].device_s, 200e-6)  # launched from tid 2
    assert math.isclose(by["update"].device_s, 30e-6)
    assert math.isclose(by["combine"].device_s, 150e-6)
    assert math.isclose(by[spans.OUTSIDE].device_s, 5e-6)
    assert by["fused_train_step"].device_s == 0 and by["fused_train_step"].launches == 0
    assert (by["forward"].launches, by["backward"].launches, by["combine"].launches) == (2, 1, 2)
    assert by["backward"].kernel_s == {"gemm_bwd": pytest.approx(200e-6)}
    assert set(by["combine"].kernel_s) == {"encode_kernel", "decode_accumulate_kernel"}
    assert math.isclose(by["backward"].host_s, 300e-6)
    assert math.isclose(s.phases_busy_s, (90 + 200 + 30 + 150) * 1e-6)
    assert math.isclose(s.busy_s, trace.summarize(_step_trace()).busy_s)


def test_blocking_calls_are_the_span_that_made_them():
    by = spans.summarize(_step_trace()).by_span
    # each named by the operator open on its thread (the sync is in none)
    assert by["backward"].blocking == {"cudaMalloc/aten::empty": [1, pytest.approx(5e-6)]}
    assert by[spans.OUTSIDE].blocking == {"cudaDeviceSynchronize": [1, pytest.approx(290e-6)]}
    assert by["forward"].blocking == {}


def test_a_gap_is_the_span_whose_work_ended_it():
    s = spans.summarize(_step_trace())
    idle = dict(s.idle_spans)
    assert idle["backward"] == pytest.approx(40e-6)  # 130-170
    assert idle["update"] == pytest.approx(10e-6)  # 370-380
    assert idle["combine"] == pytest.approx(200e-6)  # 410-510 and 560-660
    assert idle[spans.OUTSIDE] == pytest.approx(5e-6)  # 760-765
    assert idle[spans.EDGES] == pytest.approx((40 + 230) * 1e-6)  # 0-40, 770-1000
    assert "forward" not in idle  # its work starts the sub-window's device time
    assert s.by_span["backward"].idle_s == pytest.approx(40e-6)
    # every gap is some span's: the list sums to the window less the busy time
    assert sum(v for _k, v in s.idle_spans) == pytest.approx(s.window_s - s.busy_s)
    assert [k for k, _v in s.idle_spans] == [spans.EDGES, "combine", "backward", "update",
                                             spans.OUTSIDE]
    # each gap named by the span and the operator on the launching thread
    assert s.gaps == [("combine", pytest.approx(100e-6)),
                      ("combine/aten::copy_", pytest.approx(100e-6)),
                      ("backward/aten::mm", pytest.approx(40e-6)),
                      ("update", pytest.approx(10e-6)), ("outside", pytest.approx(5e-6))]


@pytest.mark.parametrize("shift_ms", [-10.0, 10.0])
def test_an_offset_device_clock_moves_no_span(shift_ms):
    base = spans.summarize(_step_trace())
    moved = spans.summarize(_shifted(_step_trace(), shift_ms * MS))
    for name, s in base.by_span.items():
        m = moved.by_span[name]
        assert m.launches == s.launches and m.kernel_s.keys() == s.kernel_s.keys()
        assert m.device_s == pytest.approx(s.device_s, abs=1e-12)
        assert m.idle_s == pytest.approx(s.idle_s, abs=1e-12)
    assert dict(moved.idle_spans).keys() - {spans.EDGES} == dict(base.idle_spans).keys() - {
        spans.EDGES}


def _two_steps():
    second = [{**e, "ts": e["ts"] + 1000.0} for e in _step_trace()]
    for e in second:
        if "correlation" in e.get("args", {}):
            e["args"] = {"correlation": e["args"]["correlation"] + 100}
    return _step_trace() + second


@pytest.mark.parametrize("events", [
    _step_trace(), _shifted(_step_trace(), 10 * MS), _shifted(_step_trace(), -10 * MS),
    _step_trace() + [_launch(10, -50), _kernel("gemm", 5, 30, 10)],
    _step_trace() + [_kernel("no_launch", -20, 60, 99), _kernel("late", 990, 40, 98)],
    [e for e in _step_trace() if e["cat"] == "user_annotation"], _two_steps(),
], ids=["step", "late-clock", "early-clock", "before", "no-launch", "host-only", "two"])
def test_the_sub_window_and_busy_time_are_lib_trace_s(events):
    """The span reading selects the device work as ``lib/trace.py`` does:
    the same steps, sub-window and busy time, bit for bit."""
    s, summary = spans.summarize(events), trace.summarize(events)
    assert (s.steps, s.window_s, s.busy_s) == (summary.steps, summary.window_s, summary.busy_s)


def test_work_launched_before_the_steps_is_left_out():
    events = _step_trace() + [_launch(10, -50), _kernel("gemm", 5, 30, 10)]
    assert spans.summarize(events).by_span == spans.summarize(_step_trace()).by_span


def _without_program_spans(events):
    return [e for e in events if not e["name"].startswith(spans.PREFIX)]


def _ctx(summary, cell):
    _w, cfg, mix, _lim = tiny.cell(cell)
    return SimpleNamespace(trace=summary, cfg=cfg, mix=mix, family=harness.family(cfg),
                           steps=3, window_s=1.0, host_s=[0.1], step_flops=1e9, width=512,
                           wire_launches={"encode": 1.0, "decode_accumulate": 1.0}, rounds=3)


@pytest.mark.parametrize("cell", tiny.cells())
def test_existing_readings_are_unchanged_by_program_spans(cell):
    with_spans = _step_trace() + [_kernel("flash_fwd_sm90", 100, 10, 2)]
    summary = trace.summarize(with_spans)
    plain = trace.summarize(_without_program_spans(with_spans))
    for field in dataclasses.fields(trace.Summary):
        assert getattr(summary, field.name) == getattr(plain, field.name), field.name
    for spec in harness.metrics_of(harness.benchmark(), "per_layer", cell):
        reader = harness.reader(spec["name"])
        assert reader.read(_ctx(summary, cell)) == reader.read(_ctx(plain, cell)), spec["name"]


@pytest.mark.parametrize("phase", spans.PHASES)
def test_phase_readers_give_none_without_program_spans(phase):
    s = spans.summarize(_without_program_spans(_step_trace()))
    assert spans.phase_ms(s, phase) is None
    assert spans.phase_ms(None, phase) is None
    assert set(s.by_span) == {spans.OUTSIDE}
    assert spans.phase_ms(spans.summarize(_step_trace()), phase) > 0


def test_phase_readers_give_none_without_device_work():
    host_only = [e for e in _step_trace() if e["cat"] == "user_annotation"]
    s = spans.summarize(host_only)
    assert all(spans.phase_ms(s, p) is None for p in spans.PHASES)
    assert s.idle_spans == [(spans.EDGES, pytest.approx(1000e-6))]


def test_lines_and_idle_list_are_a_step_each():
    s = spans.summarize(_two_steps())
    assert s.steps == 2
    assert spans.phase_ms(s, "backward") == pytest.approx(0.2)
    ms = dict(spans.idle_spans_ms(s))
    assert ms["backward"] == pytest.approx(0.04)
    line = next(x for x in spans.lines(s) if x.startswith("span backward:"))
    assert "device 0.200 ms" in line and "launches 1" in line
    assert "cudaMalloc/aten::empty 1 (0.005 ms)" in line


@pytest.mark.parametrize("cell", tiny.cells())
def test_phases_tool_on_a_cell_cut_to_size(tmp_path, cell):
    """The tool's set-up, profile and reading on the CPU: the program's four
    phases are in the trace with their host time; no device work, so no
    device reading."""
    import torch

    _w, cfg, mix, _lim = tiny.cell(cell)
    mix.update(check_steps=1)
    result = phases.profile_cell(cell, cfg, mix, harness.family(cfg), 2**31 + 11, 1,
                                 torch.device("cpu"), tmp_path, log=lambda *_: None)
    assert set(spans.PHASES) <= set(result["spans"])
    assert all(result["spans"][p]["host_ms"] > 0 for p in spans.PHASES)
    assert result["phases"] == {p: None for p in spans.PHASES}
    assert result["same_without_program_spans"] is True
    assert result["span_us"]["off"] > 0 and result["span_us"]["on"] > result["span_us"]["off"]
    assert len(result["traced_step_ms"]) == 1 and (tmp_path / f"{cell}.trace.json").is_file()
