"""The comparison fails the control and every fault a training cell can
have, at a size a test run holds; the same comparison passes the sound
program (test_gossipbench_reference.py)."""

import pytest
import torch

from gossipbench import harness
from gossipbench.drivers import train
from gossipbench.lib import compare
from gossipbench.reference import train as reference_train
from gossipbench.reference import wire
from gossipbench.tests import tiny


@pytest.mark.parametrize("name", tiny.cells())
@pytest.mark.parametrize("seed", [3, 4, 2**31 + 5])
def test_control_is_not_correct(name, seed):
    """The reference in the program's place with every product in float8
    e4m3, the precision below the configuration's bf16."""
    _w, cfg, m, lim = tiny.cell(name)
    family = harness.family(cfg)
    ref = train.reference_outputs(cfg, m, family, seed, tiny.CPU, m["check_steps"])
    ctl = train.reference_outputs(cfg, m, family, seed, tiny.CPU, m["check_steps"],
                                  cast=reference_train.fp8)
    correct, checks, _ = compare.compare(ctl, ref, lim)
    assert not correct, checks


def _unchanged(monkeypatch):
    from bluefog_tpu_torch import optimizers

    monkeypatch.setattr(optimizers._GossipOptimizer, "_combine_update",
                        lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from bluefog_tpu_torch.models import StackedModel

    whole = StackedModel.worker_loss

    def half(self, row, inputs, targets, worker=None):
        k = inputs.shape[0] // 2
        return whole(self, row, inputs[:k], targets[:k], worker)

    monkeypatch.setattr(StackedModel, "worker_loss", half)


def _no_exchange(monkeypatch):
    from bluefog_tpu_torch import optimizers

    monkeypatch.setattr(optimizers._GossipOptimizer, "_gossip", lambda self, d, tree: None)


def _answer(monkeypatch):
    from bluefog_tpu_torch import optimizers

    grads = optimizers._worker_grads

    def altered(*a, **k):
        losses, aux, g = grads(*a, **k)
        losses[0] = losses[0] * 1.01
        return losses, aux, g

    monkeypatch.setattr(optimizers, "_worker_grads", altered)


def _residual_grad(monkeypatch, name):
    """The weight gradient of the first block's 3x3 convolution halved, as
    the optimizer gets it (a ResNet's residual branch, whose first
    gradient is 0)."""
    from bluefog_tpu_torch import optimizers

    _w, cfg, _m, _lim = tiny.cell(name)
    slots, _width = wire.layout(harness.family(cfg).reference.param_table(cfg))
    s = next(s for s in slots if s.name == "BottleneckBlock_0.Conv_1.kernel")
    grads = optimizers._worker_grads

    def halved(*a, **k):
        losses, aux, g = grads(*a, **k)
        g[:, s.offset:s.offset + s.numel] *= 0.5
        return losses, aux, g

    monkeypatch.setattr(optimizers, "_worker_grads", halved)


FAULTS = {"state unchanged": _unchanged, "half the batch": _half_batch,
          "no exchange": _no_exchange, "an answer altered": _answer}
# faults only a model with residual branches can have
RESIDUAL_FAULTS = {"a residual gradient halved": _residual_grad}


def _cases():
    for name in tiny.cells():
        yield from ((name, f) for f in sorted(FAULTS))
        if tiny.cell(name)[1]["family"] == "resnet":
            yield from ((name, f) for f in sorted(RESIDUAL_FAULTS))


@pytest.mark.parametrize("name, fault", list(_cases()))
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    """A whole run past the look for a chip, with the timed path broken
    underneath: ``correct`` comes out false."""
    if fault in FAULTS:
        FAULTS[fault](monkeypatch)
    else:
        RESIDUAL_FAULTS[fault](monkeypatch, name)
    result, lines = tiny.run(name)
    assert result["correct"] is False, lines
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_readings_of_the_calibration_tool():
    from gossipbench import control

    _w, cfg, m, lim = tiny.cell(tiny.cells()[-1])
    family = harness.family(cfg)
    ref = train.reference_outputs(cfg, m, family, 7, tiny.CPU, m["check_steps"])
    row = control.reading("control", 7, ref, ref, lim)
    assert row["correct"] and row["loss_by_step"] == [0.0] * m["check_steps"]
    for key in ("grad_gap", "change_gap"):
        assert {row[f"{key}.{over}"] for over in ("worst", "median", "whole")} == {0.0}
    assert control.seeds("1-3,7") == [1, 2, 3, 7]


def test_planted_reference_faults_are_caught():
    _w, cfg, m, lim = tiny.cell(tiny.cells()[0])
    family = harness.family(cfg)
    ref = train.reference_outputs(cfg, m, family, 6, tiny.CPU, m["check_steps"])
    for fault in reference_train.faults(family.reference):
        bad = train.reference_outputs(cfg, m, family, 6, tiny.CPU, m["check_steps"],
                                      fault=fault)
        assert not compare.compare(bad, ref, lim)[0], fault
    with pytest.raises(ValueError):
        reference_train.follow(family.reference, cfg, m, torch.zeros(1), [], 1, fault="x")


def test_late_gradient_sees_the_residual_branches():
    """A residual convolution's gradient halved leaves the first gradient
    exactly as it was (0 through the zero BatchNorm scale) and fails the
    late gradient alone, on that leaf."""
    name = next(n for n in tiny.cells() if tiny.cell(n)[1]["family"] == "resnet")
    _w, cfg, m, lim = tiny.cell(name)
    family = harness.family(cfg)
    ref = train.reference_outputs(cfg, m, family, 6, tiny.CPU, m["check_steps"])
    silent = compare.silent_at_first(ref["grad"])
    assert "BottleneckBlock_0.Conv_1.kernel" in silent and "Dense_0.kernel" not in silent
    for fault in family.reference.FAULTS:
        bad = train.reference_outputs(cfg, m, family, 6, tiny.CPU, m["check_steps"],
                                      fault=fault)
        correct, checks, where = compare.compare(bad, ref, lim)
        assert checks["grad_gap"]["value"] == 0.0
        assert checks["late_grad_gap"]["value"] > 0.45, (fault, checks)
        assert "BottleneckBlock_0." in where["late_grad_gap"] and not correct


def test_limits_name_only_known_numbers():
    for name in tiny.cells():
        assert compare.checks_of(harness.limits(name))[:3] == list(compare.CHECKS[:3])
    with pytest.raises(ValueError):
        compare.checks_of({"loss_gap": {}, "no_such_gap": {}})
