#!/usr/bin/env python
# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Average consensus three ways on the PyTorch port: static gossip, dynamic
one-peer, windows.

The port's rendition of ``examples/average_consensus.py``: every worker
starts from a random vector and must agree on the global mean.

  1. static Exp-2 ``neighbor_allreduce``
  2. dynamic one-peer Exp-2 (per-step ``dst_weights`` / ``src_weights``)
  3. window averaging (``win_put`` + ``win_update``)

Each method prints its mse after each of the first iterations and after
the last; the run exits nonzero unless all three converge.

    python examples/torch_average_consensus.py               # on the GPU
    python examples/torch_average_consensus.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bluefog_tpu_torch as bft  # noqa: E402
from bluefog_tpu_torch import topology as tu  # noqa: E402

SHOWN = 5  # leading iterations whose mse is printed


def mse(x, target):
    return float(np.mean((x.cpu().numpy() - target) ** 2))


def report(name, trajectory):
    print(f"[{name}] mse by iteration: " + " ".join(f"{m:.9e}" for m in trajectory[:SHOWN]))
    print(f"[{name}] mse after {len(trajectory)} iters: {trajectory[-1]:.2e}")
    return trajectory[-1] < 1e-6


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=40)
    args = parser.parse_args()

    bft.init(device=args.device)
    size = bft.size()
    rng = np.random.RandomState(42)
    data = rng.randn(size, 16).astype(np.float32)
    target = data.mean(0)
    ok = True

    # 1. static gossip on the default topology, the Exp graph (on 8 workers
    #    its edges are Exp-2's)
    x = bft.worker_values(list(data))
    traj = []
    for _ in range(args.iters):
        x = bft.neighbor_allreduce(x)
        traj.append(mse(x, target))
    ok &= report("static exp2", traj)

    # 2. dynamic one-peer Exp-2
    topo = tu.ExponentialTwoGraph(size)
    gens = [tu.GetDynamicOnePeerSendRecvRanks(topo, r) for r in range(size)]
    x = bft.worker_values(list(data))
    traj = []
    for _ in range(args.iters):
        sr = [next(g) for g in gens]
        x = bft.neighbor_allreduce(
            x, self_weight=0.5,
            src_weights=[{s: 0.5 for s in rv} for _, rv in sr],
            dst_weights=[list(s) for s, _ in sr],
        )
        traj.append(mse(x, target))
    ok &= report("dynamic one-peer", traj)

    # 3. window averaging (put + update each round)
    x = bft.worker_values(list(data))
    bft.win_create(x, "consensus")
    traj = []
    for _ in range(args.iters):
        bft.win_put(None, "consensus")
        x = bft.win_update("consensus")
        traj.append(mse(x, target))
    ok &= report("window put/update", traj)
    bft.win_free()

    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
