#!/usr/bin/env python
# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Synthetic training throughput of the distributed optimizers on the
PyTorch port.

The port's rendition of ``examples/benchmark.py``: times the whole
decentralized train step (every worker's forward and backward, the inner
update and the gossip) for one model and optimizer family, through
``opt.make_train_step`` for the gossip family (a window optimizer takes
its gradients at ``opt.params()``), and prints images/s. ``--dynamic``
runs the one-peer Exp-2 schedule.

    python examples/torch_benchmark.py --model mlp --num-iters 5 --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import bluefog_tpu_torch as bft  # noqa: E402
from bluefog_tpu_torch import topology as tu  # noqa: E402
from bluefog_tpu_torch.collective.plan import schedule_from_dynamic  # noqa: E402
from bluefog_tpu_torch.models import MLP, ResNet18, ResNet50, StackedModel, mlp, resnet  # noqa: E402

OPTIMIZERS = {
    "neighbor_allreduce": bft.DistributedNeighborAllreduceOptimizer,
    "allreduce": bft.DistributedAllreduceOptimizer,
    "gradient_allreduce": bft.DistributedGradientAllreduceOptimizer,
    "atc": bft.DistributedAdaptThenCombineOptimizer,
    "win_put": bft.DistributedWinPutOptimizer,
    "push_sum": bft.DistributedPushSumOptimizer,
}
WINDOW_MODES = ("win_put", "push_sum")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--model", default="mlp", choices=["mlp", "resnet18", "resnet50"])
    parser.add_argument("--dist-optimizer", default="neighbor_allreduce",
                        choices=sorted(OPTIMIZERS))
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--num-warmup", type=int, default=2)
    parser.add_argument("--dynamic", action="store_true",
                        help="the one-peer dynamic Exp-2 schedule")
    args = parser.parse_args()

    bft.init(device=args.device)
    size = bft.size()
    dev = bft.get_context().device
    gen = torch.Generator().manual_seed(0)
    if args.model == "mlp":
        module = mlp.init_flax_like(MLP(128, features=(256, 256, 10)), seed=0)
        sample, classes = (128,), 10
    else:
        factory = ResNet18 if args.model == "resnet18" else ResNet50
        module = resnet.init_flax_like(factory(num_classes=1000), seed=0)
        sample, classes = (64, 64, 3), 1000
    sm = StackedModel(module, size, dev)
    params = sm.replicate()
    x = torch.randn((size, args.batch_size) + sample, generator=gen).to(dev)
    y = torch.randint(0, classes, (size, args.batch_size), generator=gen).to(dev)
    batch = (x, y, torch.arange(size)) if sm.buffers else (x, y)

    window_mode = args.dist_optimizer in WINDOW_MODES
    opt = OPTIMIZERS[args.dist_optimizer](bft.sgd(0.01, momentum=0.9))
    if args.dynamic:
        if window_mode:
            parser.error("--dynamic applies to the gossip optimizers only")
        topo = tu.ExponentialTwoGraph(size)
        opt.schedule = schedule_from_dynamic(
            size, lambda r: tu.GetDynamicOnePeerSendRecvRanks(topo, r))
    state = opt.init(params)

    if window_mode:
        grads = torch.empty_like(params)

        def one_step(params, state):
            sm.loss_and_grad(opt.params(), x, y, grads)
            return opt.step(state, grads)
    else:
        train_step = opt.make_train_step(sm.worker_loss)

        def one_step(params, state):
            params, state, _loss = train_step(params, state, *batch)
            return params, state

    for _ in range(args.num_warmup):
        params, state = one_step(params, state)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        params, state = one_step(params, state)
    sync(dev)
    dt = time.perf_counter() - t0
    if not torch.isfinite(params).all():
        print("FAILED: non-finite parameters")
        return 1
    total = size * args.batch_size * args.num_iters
    print(f"[{args.model} / {args.dist_optimizer}{' / dynamic' if args.dynamic else ''}] "
          f"{total / dt:.1f} imgs/sec total ({total / dt / size:.1f} per worker, "
          f"{size} workers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
