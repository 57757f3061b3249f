# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Headline step times of the port's earlier chip phases, on one tree.

    python3 tools/torch_pair_timing.py <tree>

``<tree>`` is a checkout of the repository (``git archive`` of a commit
unpacked into an ignored directory such as ``build/parent``); its own
``chip_smoke.py`` and ``bluefog_tpu_torch`` are imported, so two commits
can be compared on one card in one command, run after run in turns
(parent, change, change, parent): the host's speed moves between calls,
not within one. On one H100 it prints one ``PAIR <tree> {...}`` line with
the median step seconds of ResNet50 ATC int8 (2 + 6 steps), the
TransformerLM ATC int8 (1 + 4), its gradient-allreduce Adam replicated and
ZeRO-1 (1 + 4 each) and the long-context TransformerLM (1 + 4), at the
shapes ``chip_smoke.py`` uses.
"""

import argparse
import os
import sys


def main():
    parser = argparse.ArgumentParser(
        description="Median step seconds of the port's earlier chip phases on one tree "
                    "(run on an H100, tree after tree in one command).")
    parser.add_argument("tree", help="a checkout of the repository (e.g. build/parent)")
    root = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import bluefog_tpu_torch as bft
    import chip_smoke as cs
    from bluefog_tpu_torch import _build

    if not torch.cuda.is_available():
        print("torch_pair_timing: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _build.build(["wire_kernels", "flash_kernels", "flash_sm90"])
    bft.init(size=cs.SIZE)
    out = {}
    sm, images, labels = cs.build_trainer(dev)
    trainer = cs.Trainer(dev, sm, images, labels)
    trainer.gossip("atc/int8", "atc", "int8", 2, 6)
    out["resnet atc/int8 step"] = trainer.tiers["atc/int8"]["median"][0]
    del trainer, sm, images, labels
    torch.cuda.empty_cache()
    sm, tokens, _ = cs.build_lm(dev)
    trainer = cs.Trainer(dev, sm, tokens, tokens)
    trainer.gossip("lm", "atc", "int8", 1, 4, lr=0.01)
    out["lm atc/int8 step"] = trainer.tiers["lm"]["median"][0]
    del trainer
    torch.cuda.empty_cache()
    _counts, zero = cs.phase_zero(dev, sm, tokens, tiers=cs.ZERO_TIERS[:2], timed=4)
    out["zero repl step"] = zero["repl"]["step_s"]
    out["zero1 step"] = zero["zero1"]["step_s"]
    del sm, tokens
    torch.cuda.empty_cache()
    model, tokens, targets = cs.build_long_context(dev)
    _c, _r, _n, lc = cs.phase_long_context(dev, model, tokens, targets, 1, 4)
    out["long-context step"] = lc["step_s"]
    print("PAIR", os.path.basename(root), out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
