# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's spans (``bluefog_tpu_torch.timeline.span``): one primitive
with two sinks, the timeline's complete records and ``torch.profiler``'s
``record_function`` ranges. The gossip family's step opens ``forward`` and
``backward`` once a worker, ``update`` and ``combine`` once a step, each
inside the step's ``ENQUEUE`` span (``fused_train_step`` or
``optimizer_step``); with neither sink on no ``record_function`` is
entered, and tracing changes no bit of the training."""

import contextlib
import json
import re

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch.collective import kernels
from bluefog_tpu_torch.models import StackedModel
from bluefog_tpu_torch.optimizers import tree_leaves

SIZE = 4
PHASES = ("forward", "backward", "update", "combine")


@pytest.fixture(autouse=True)
def context(monkeypatch):
    for env in ("BLUEFOG_TIMELINE", "BLUEFOG_METRICS", "BLUEFOG_SHARD", "BLUEFOG_ASYNC"):
        monkeypatch.delenv(env, raising=False)
    bft.init(size=SIZE, device="cpu")
    yield
    if bft.timeline_enabled():
        bft.timeline_shutdown()
    bft.shutdown()


def _model():
    torch.manual_seed(0)
    sm = StackedModel(nn.Sequential(nn.Linear(3, 5), nn.Tanh(), nn.Linear(5, 2)), SIZE, "cpu")
    g = torch.Generator().manual_seed(1)
    inputs = torch.randn(SIZE, 6, 3, generator=g)
    targets = torch.randint(0, 2, (SIZE, 6), generator=g)
    return sm, inputs, targets


def _optimizer(order: str):
    make = {"atc": bft.DistributedAdaptThenCombineOptimizer,
            "cta": bft.DistributedAdaptWithCombineOptimizer,
            "grad": bft.DistributedGradientAllreduceOptimizer}[order]
    opt = make(bft.sgd(0.1, momentum=0.9))
    if order != "grad":
        opt.compression = "int8"
    return opt


def _stepper(order: str, path: str, delayed: bool = False):
    """``(step(), params, state, opt)``: one step of the tiny model through
    the fused train step or the two-program path."""
    sm, inputs, targets = _model()
    opt = _optimizer(order)
    params = sm.replicate()
    state = opt.init(params)
    if path == "fused":
        train_step = opt.make_train_step(sm.worker_loss, delayed=delayed)

        def step():
            train_step(params, state, inputs, targets)
    else:
        grads = torch.empty_like(params)

        def step():
            sm.loss_and_grad(params, inputs, targets, grads)
            opt.step(params, state, grads)
    return step, params, state, opt


def _profiled_spans(run, tmp_path):
    """The ``bluefog.*`` ranges of ``run()`` in the profiler's Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("bluefog.")]


def _inside(child, parent) -> bool:
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def _counts(spans, parent=None):
    return {p: sum(1 for e in spans if e["name"] == f"bluefog.{p}"
                   and (parent is None or _inside(e, parent))) for p in PHASES}


@pytest.mark.parametrize("delayed", [False, True], ids=["sync", "delayed"])
@pytest.mark.parametrize("order", ["atc", "cta"])
def test_fused_step_opens_each_phase_inside_its_enqueue(tmp_path, order, delayed):
    step, *_ = _stepper(order, "fused", delayed)
    step()  # the delayed step mixes fresh on its first call
    spans = _profiled_spans(step, tmp_path)
    parents = [e for e in spans if e["name"] == "bluefog.fused_train_step"]
    assert len(parents) == 1
    expected = {"forward": SIZE, "backward": SIZE, "update": 1, "combine": 1}
    assert _counts(spans, parents[0]) == expected
    assert _counts(spans) == expected  # none outside the step


@pytest.mark.parametrize("order", ["atc", "cta"])
def test_two_program_step_opens_update_and_combine_inside_its_enqueue(tmp_path, order):
    step, *_ = _stepper(order, "two-program")
    spans = _profiled_spans(step, tmp_path)
    parents = [e for e in spans if e["name"] == "bluefog.optimizer_step"]
    assert len(parents) == 1
    assert _counts(spans, parents[0]) == {"forward": 0, "backward": 0, "update": 1,
                                          "combine": 1}
    # the model's own forward and backward, before the optimizer's step
    assert _counts(spans) == {"forward": SIZE, "backward": SIZE, "update": 1, "combine": 1}


def _phase_at_each_wire_launch(monkeypatch):
    """The innermost span open at each call of a wire kernel, in call
    order (None outside every span)."""
    open_spans, seen = [], []
    real_span = tl.span

    @contextlib.contextmanager
    def tracking(name, activity):
        with real_span(name, activity):
            open_spans.append(name)
            try:
                yield
            finally:
                open_spans.pop()

    monkeypatch.setattr(tl, "span", tracking)
    for name in kernels.launch_counts():
        def wrapped(*args, _real=getattr(kernels, name), **kwargs):
            seen.append(open_spans[-1] if open_spans else None)
            return _real(*args, **kwargs)

        monkeypatch.setattr(kernels, name, wrapped)
    return seen


@pytest.mark.parametrize("shard", ["replicated", "zero1", "zero2"])
def test_gradient_allreduce_combines_the_gradients(tmp_path, monkeypatch, shard):
    """The allreduce is the replicated step's one ``combine``; ZeRO's
    step has two, its gradient leg (the allreduce, or ZeRO-2's
    reduce-scatter on the int8 wire) and the gather of the owned slots,
    and every wire kernel runs inside one of them."""
    if shard != "replicated":
        monkeypatch.setenv("BLUEFOG_SHARD", "1")
        monkeypatch.setenv("BLUEFOG_SHARD_GRADS", "1" if shard == "zero2" else "0")
    step, _params, _state, opt = _stepper("grad", "fused")
    if shard == "zero2":
        opt.compression = "int8"
    launches = _phase_at_each_wire_launch(monkeypatch)
    spans = _profiled_spans(step, tmp_path)
    parent = next(e for e in spans if e["name"] == "bluefog.fused_train_step")
    combines = 1 if shard == "replicated" else 2
    assert _counts(spans, parent) == {"forward": SIZE, "backward": SIZE, "update": 1,
                                      "combine": combines}
    assert _counts(spans)["combine"] == combines  # none outside the step
    if shard == "zero2":
        assert launches and set(launches) == {"combine"}, launches


def test_facade_op_is_a_profiler_range(tmp_path):
    """A blocking op is its dispatch's ``ENQUEUE`` range, then its wait's
    ``SYNCHRONIZE`` range, ``bluefog.handle_<n>``."""
    x = bft.worker_values(lambda r: torch.full((3,), float(r)))
    spans = _profiled_spans(lambda: bft.neighbor_allreduce(x), tmp_path)
    names = [e["name"] for e in spans]
    assert names[0] == "bluefog.neighbor_allreduce" and len(names) == 2
    assert re.fullmatch(r"bluefog\.handle_\d+", names[1]), names


def test_a_wait_and_a_timeline_context_are_profiler_ranges(tmp_path):
    """``synchronize`` and ``timeline_context`` reach the profiler's trace
    too, and the timeline keeps their records (``X``; ``B`` / ``E``)."""
    x = bft.worker_values(lambda r: torch.full((3,), float(r)))
    path = str(tmp_path / "timeline.json")
    assert bft.timeline_init(path)

    def run():
        with bft.timeline_context("consensus", "USER_SPAN"):
            handle = bft.neighbor_allreduce_nonblocking(x)
        bft.synchronize(handle)

    spans = _profiled_spans(run, tmp_path)
    assert bft.timeline_shutdown()
    by_name = {e["name"]: e for e in spans}
    context = by_name["bluefog.consensus"]
    assert _inside(by_name["bluefog.neighbor_allreduce"], context)
    wait = [e for e in spans if re.fullmatch(r"bluefog\.handle_\d+", e["name"])]
    assert len(wait) == 1 and wait[0]["ts"] >= context["ts"] + context["dur"]
    events = json.load(open(path))
    assert {e["ph"] for e in events if e.get("cat") == "USER_SPAN"} == {"B", "E"}
    assert [e["ph"] for e in events if e.get("cat") == "SYNCHRONIZE"] == ["X"]


def test_no_record_function_with_both_sinks_off(monkeypatch, tmp_path):
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    fused, *_ = _stepper("atc", "fused")
    two, *_ = _stepper("cta", "two-program")
    for _ in range(2):
        fused()
        two()
    bft.neighbor_allreduce(bft.worker_values(lambda r: torch.ones(2)))
    assert entered == []
    assert tl.span("forward", tl.PHASE) is tl.span("combine", tl.PHASE)  # the shared no-op
    _profiled_spans(fused, tmp_path)  # the same code with the profiler on
    assert entered.count("bluefog.forward") == SIZE
    assert entered.count("bluefog.fused_train_step") == 1


def test_timeline_holds_the_same_spans(tmp_path):
    step, *_ = _stepper("atc", "fused")
    path = str(tmp_path / "timeline.json")
    assert bft.timeline_init(path)
    step()
    assert bft.timeline_shutdown()
    events = json.load(open(path))
    phases = [e for e in events if e.get("cat") == tl.PHASE]
    assert all(e["ph"] == "X" for e in phases)
    parents = [e for e in events if e.get("cat") == "ENQUEUE"
               and e["name"] == "fused_train_step"]
    assert len(parents) == 1
    counts = {p: sum(1 for e in phases if e["name"] == p and _inside(e, parents[0]))
              for p in PHASES}
    assert counts == {"forward": SIZE, "backward": SIZE, "update": 1, "combine": 1}
    assert len(phases) == 2 * SIZE + 2


def test_a_span_that_raises_leaves_no_record_and_closes_its_range(tmp_path):
    path = str(tmp_path / "timeline.json")
    assert bft.timeline_init(path)

    def run():
        with pytest.raises(ValueError):
            with tl.span("update", tl.PHASE):
                raise ValueError("planted")
        with tl.span("combine", tl.PHASE):
            pass

    update, combine = _profiled_spans(run, tmp_path)
    assert bft.timeline_shutdown()
    assert [e["name"] for e in json.load(open(path)) if e.get("cat") == tl.PHASE] == [
        "combine"]
    # the range closed as the exception left it: the next span is its sibling
    assert (update["name"], combine["name"]) == ("bluefog.update", "bluefog.combine")
    assert update["ts"] + update["dur"] <= combine["ts"]


@pytest.mark.parametrize("path", ["fused", "two-program"])
def test_tracing_changes_no_training_bit(tmp_path, path):
    def three_steps(traced: bool):
        step, params, state, opt = _stepper("atc", path)
        if traced:
            assert bft.timeline_init(str(tmp_path / f"{path}.json"))
            with profile(activities=[ProfilerActivity.CPU]):
                for _ in range(3):
                    step()
            assert bft.timeline_shutdown()
        else:
            for _ in range(3):
                step()
        return params, tree_leaves(state)

    p_off, s_off = three_steps(False)
    p_on, s_on = three_steps(True)
    assert torch.equal(p_off, p_on)
    assert len(s_off) == len(s_on) and all(torch.equal(a, b) for a, b in zip(s_off, s_on))

