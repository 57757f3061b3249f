"""Every cell of ``BENCHMARK.json`` cut to a size the CPU tests can hold:
the same families, mixes, drivers and comparison, smaller widths, float32
compute (at these sizes a bf16 ResNet's BatchNorm over a handful of
pixels amplifies rounding past any useful limit; at 32 pixels and 4
images even float32's rounding grows to 0.5% of the loss by the third
step on the card)."""

import torch

from gossipbench import harness

SHRINK = {
    "resnet": ({"stage_sizes": [1, 1, 1, 1], "num_filters": 8, "num_classes": 10,
                "image_size": 64}, {"batch": 8}),
    "gpt2": ({"n_embd": 32, "n_head": 4, "n_layer": 2, "n_positions": 16, "n_ctx": 16,
              "vocab_size": 64}, {"batch": 2, "seq": 16}),
}
# what the tiny float32 program reads against the reference (CPU, seeds
# 1-3: ResNet loss 1.4e-5 at most, whole gradient 1.2e-7, median change
# 2.8e-4; GPT-2 under 2e-7 on all three), with room; the ResNet's late
# gradient, worst leaf of the residual branches, reads up to 0.124 on
# seeds 1-3, 2**31 + 3 and 2**31 + 7 (8 channels a leaf: one int8 flip of
# a zero-started BatchNorm scale moves a leaf's norm by a tenth), and a
# residual convolution's weight or input gradient halved reads 0.50-0.53
LIMITS = {
    "resnet": {"loss_gap": {"limit": 2e-3, "over": "worst"},
               "grad_gap": {"limit": 1e-4, "over": "whole"},
               "change_gap": {"limit": 5e-3, "over": "median"},
               "late_grad_gap": {"limit": 0.3, "over": "worst"}},
    "gpt2": {"loss_gap": {"limit": 1e-5, "over": "worst"},
             "grad_gap": {"limit": 1e-5, "over": "worst"},
             "change_gap": {"limit": 1e-5, "over": "median"}},
}
CPU = torch.device("cpu")


def cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]


def cell(name: str):
    """``(workload entry, config, mix, limits)`` of a cell, cut to size."""
    bench = harness.benchmark()
    w = harness.cell(bench, name)
    cfg, m = harness.config(bench, w["config"]), harness.mix(w["traffic"])
    cut_cfg, cut_mix = SHRINK[cfg["family"]]
    cfg.update(cut_cfg, compute_dtype="float32")
    m.update(cut_mix)
    return w, cfg, m, LIMITS[cfg["family"]]


def run(name: str, trace: bool = False, seed: int = 2**31 + 7, seconds: float = 0.2):
    """One run of the cut cell through the harness, as ``run.py`` would
    make it past its look for a chip."""
    import time

    bench = harness.benchmark()
    w, cfg, m, lim = cell(name)
    return harness.run_cell(w, cfg, m, lim, harness.metrics_of(bench, "end_to_end", name),
                            harness.metrics_of(bench, "per_layer", name), seed, seconds,
                            trace, CPU, time.perf_counter(), log=lambda *_: None)
