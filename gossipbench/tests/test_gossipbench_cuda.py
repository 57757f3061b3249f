"""On a card: each cell, cut to size, through the harness on CUDA, traced,
with the port's kernels on the timed path. Run on the chip with
``python3 -m pytest gossipbench/tests -m cuda``."""

import time

import pytest
import torch

from gossipbench import harness
from gossipbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.cells())
def test_cell_on_the_card(monkeypatch, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the cut cells compute in float32: keep cuDNN and cuBLAS off TF32, as
    # the reference is, or a tiny ResNet's BatchNorm amplifies its rounding
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bench = harness.benchmark()
    w, cfg, m, lim = tiny.cell(name)
    result, lines = harness.run_cell(
        w, cfg, m, lim, harness.metrics_of(bench, "end_to_end", name),
        harness.metrics_of(bench, "per_layer", name), 2**31 + 9, 0.5, True,
        torch.device("cuda", 0), time.perf_counter(), log=lambda *_: None)
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 <= result["metrics"]["device_idle"]["value"] < 100
    assert 0 < result["metrics"]["wire_roofline"]["value"] <= 105
    names = [n for n, _ in result["breakdown"]["device_ops"]]
    assert names and len(names) <= 10
