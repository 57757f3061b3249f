#!/usr/bin/env python
# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Checkpoint and resume a decentralized run on the PyTorch port.

The port's rendition of ``examples/checkpoint_resume.py``: train with a
dynamic one-peer schedule, save at step 12, "crash", rebuild a fresh
optimizer, restore, and finish. The resumed run must equal an
uninterrupted one bit for bit, the step counter that drives the dynamic
schedule included.

    python examples/torch_checkpoint_resume.py --device cpu
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bluefog_tpu_torch as bft  # noqa: E402
from bluefog_tpu_torch import topology as tu  # noqa: E402
from bluefog_tpu_torch.collective.plan import schedule_from_dynamic  # noqa: E402

STEPS, SAVE_AT = 30, 12


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    bft.init(device=args.device)
    size = bft.size()
    dev = bft.get_context().device
    c = torch.from_numpy(np.random.RandomState(3).randn(size, 8).astype(np.float32)).to(dev)

    def fresh_opt():
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.15))
        opt.schedule = schedule_from_dynamic(
            size, lambda r: tu.GetDynamicOnePeerSendRecvRanks(tu.ExponentialGraph(size), r))
        return opt

    def grads(params):
        return {"w": params["w"] - c}

    # the uninterrupted run
    opt = fresh_opt()
    p_ref = {"w": c.clone()}
    s_ref = opt.init(p_ref)
    for _ in range(STEPS):
        opt.step(p_ref, s_ref, grads(p_ref))

    # the interrupted run: SAVE_AT steps, a checkpoint, the "crash", the rest
    opt1 = fresh_opt()
    p1 = {"w": c.clone()}
    s1 = opt1.init(p1)
    for _ in range(SAVE_AT):
        opt1.step(p1, s1, grads(p1))
    ckpt_dir = tempfile.mkdtemp(prefix="bft_ckpt_")
    bft.checkpoint.save(ckpt_dir, SAVE_AT, p1, s1, optimizer=opt1)
    del opt1, p1, s1

    opt2 = fresh_opt()
    opt2.init({"w": c.clone()})
    step, p2, s2 = bft.checkpoint.restore(ckpt_dir, optimizer=opt2)
    print(f"[resume] restored at step {step} (optimizer step counter {opt2._step_count})")
    for _ in range(STEPS - step):
        opt2.step(p2, s2, grads(p2))
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    same = torch.equal(p2["w"].view(torch.int32), p_ref["w"].view(torch.int32))
    diff = float((p2["w"] - p_ref["w"]).abs().max())
    loss = float(((p2["w"] - c.mean(0)) ** 2).mean())
    print(f"[resume] |resumed - uninterrupted| = {diff:.2e}, bitwise equal: {same}, "
          f"step counters {opt2._step_count} / {opt._step_count}, loss {loss:.9e}")
    ok = same and opt2._step_count == opt._step_count == STEPS
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
