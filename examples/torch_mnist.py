#!/usr/bin/env python
# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Decentralized MNIST-style training with any distributed optimizer, on
the PyTorch port.

The port's rendition of ``examples/mnist.py``: each worker trains an MLP
on its private shard while gossiping with its neighbours. The data is a
synthetic 10-class problem (Gaussian classes, a skewed class mix per
worker), so the example needs no download. Exits nonzero unless the
training accuracy clears 90%.

    python examples/torch_mnist.py --dist-optimizer win_put --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.func import functional_call, grad, vmap  # noqa: E402

import bluefog_tpu_torch as bft  # noqa: E402
from bluefog_tpu_torch import topology as tu  # noqa: E402
from bluefog_tpu_torch.models import MLP, mlp  # noqa: E402

FEATURES = 32
CLASSES = 10
PER_WORKER = 64

OPTIMIZERS = {
    "neighbor_allreduce": bft.DistributedNeighborAllreduceOptimizer,
    "allreduce": bft.DistributedAllreduceOptimizer,
    "gradient_allreduce": bft.DistributedGradientAllreduceOptimizer,
    "atc": bft.DistributedAdaptThenCombineOptimizer,
    "hierarchical_neighbor_allreduce": bft.DistributedHierarchicalNeighborAllreduceOptimizer,
    "win_put": bft.DistributedWinPutOptimizer,
    "push_sum": bft.DistributedPushSumOptimizer,
}


def make_data(size, seed=0):
    """10 Gaussian classes; worker ``r`` sees classes ``r, r+1, ...`` more
    often (not iid)."""
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(CLASSES, FEATURES)
    X = np.zeros((size, PER_WORKER, FEATURES), np.float32)
    Y = np.zeros((size, PER_WORKER), np.int64)
    for r in range(size):
        probs = np.roll(np.linspace(2.0, 0.5, CLASSES), r)
        probs /= probs.sum()
        labels = rng.choice(CLASSES, size=PER_WORKER, p=probs)
        X[r] = centers[labels] + rng.randn(PER_WORKER, FEATURES)
        Y[r] = labels
    return X, Y


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist-optimizer", default="neighbor_allreduce", choices=sorted(OPTIMIZERS))
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--lr", type=float, default=0.1)
    args = parser.parse_args()

    bft.init(device=args.device, nodes_per_machine=4)
    if args.dist_optimizer == "hierarchical_neighbor_allreduce":
        bft.set_machine_topology(tu.RingGraph(bft.machine_size()))
    size = bft.size()
    dev = bft.get_context().device
    X, Y = make_data(size)
    Xd, Yd = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)

    model = mlp.init_flax_like(MLP(FEATURES, features=(64, CLASSES)), seed=0).to(dev)
    params = {name: t.detach()[None].repeat((size,) + (1,) * t.dim())
              for name, t in model.named_parameters()}
    params = bft.broadcast_parameters(params)

    opt = OPTIMIZERS[args.dist_optimizer](bft.sgd(args.lr, momentum=0.9))
    state = opt.init(params)
    windowed = hasattr(opt, "params")  # the window family owns the iterate

    def worker_loss(p, x, y):
        return F.cross_entropy(functional_call(model, p, (x,)), y)

    grad_fn = vmap(grad(worker_loss))

    def accuracy(p):
        logits = vmap(lambda q, x: functional_call(model, q, (x,)))(p, Xd)
        return float((logits.argmax(-1) == Yd).float().mean())

    cur = params
    for epoch in range(args.epochs):
        grads = grad_fn(cur, Xd, Yd)
        if windowed:
            cur, state = opt.step(state, grads)
        else:
            cur, state = opt.step(cur, state, grads)
        if (epoch + 1) % 40 == 0:
            print(f"epoch {epoch + 1:4d}  train acc {accuracy(cur):.3f}")

    acc = accuracy(cur)
    print(f"[{args.dist_optimizer}] final train accuracy: {acc:.3f}")
    if windowed:
        opt.free()
    ok = acc > 0.9
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
