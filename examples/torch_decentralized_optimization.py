#!/usr/bin/env python
# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Decentralized optimization methods on a least-squares problem, on the
PyTorch port.

The port's rendition of ``examples/decentralized_optimization.py``: each
worker holds a private dataset ``(X_r, y_r)``; the team minimizes
``sum_r ||X_r w - y_r||^2`` with neighbour communication only:

- diffusion          (adapt-then-combine gossip; an O(alpha) bias)
- exact_diffusion    (the psi/phi recursion; exact limit)
- gradient_tracking  (tracks the global gradient; exact limit)
- push_diging        (directed graphs through push-sum windows; exact limit)

The recursions run eagerly, one ``neighbor_allreduce`` (or window op) a
gossip. Each method prints its distance to the global solution at
iteration ``--report`` and at the end; the run exits nonzero unless every
method reaches the solution.

    python examples/torch_decentralized_optimization.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bluefog_tpu_torch as bft  # noqa: E402
from bluefog_tpu_torch import topology as tu  # noqa: E402

DIM = 8
SAMPLES = 40

# diffusion carries an O(alpha) bias by design; the others are exact
TOLS = {
    "diffusion": 0.2,
    "exact_diffusion": 1e-3,
    "gradient_tracking": 1e-3,
    "push_diging": 1e-2,
}


def make_problem(size):
    rng = np.random.RandomState(0)
    X = rng.randn(size, SAMPLES, DIM).astype(np.float32)
    w_true = rng.randn(DIM).astype(np.float32)
    y = (X @ w_true + 0.3 * rng.randn(size, SAMPLES)).astype(np.float32)
    A = np.einsum("rsd,rse->de", X, X, dtype=np.float64)
    b = np.einsum("rsd,rs->d", X, y, dtype=np.float64)
    return X, y, np.linalg.solve(A, b).astype(np.float32)


def gossip_method(kind, X, y, w_opt, maxite, report, alpha=0.2):
    """One of the gossip recursions on worker tensors ``[size, DIM]``;
    returns ``(error at iteration report, final error)``."""

    def grad(w):  # the mean loss's gradient, one per worker
        return torch.einsum("rsd,rs->rd", X, torch.einsum("rsd,rd->rs", X, w) - y) / SAMPLES

    def err(w):
        return float(torch.linalg.norm(w.mean(0) - w_opt))

    w = torch.zeros(X.shape[0], DIM, dtype=torch.float32, device=X.device)
    psi_prev, q, g_prev = w, grad(w), grad(w)
    at = None
    for k in range(maxite):
        if kind == "diffusion":
            w = bft.neighbor_allreduce(w - alpha * grad(w))
        elif kind == "exact_diffusion":
            psi = w - alpha * grad(w)
            w = bft.neighbor_allreduce(psi + w - psi_prev)
            psi_prev = psi
        else:  # gradient tracking
            w = bft.neighbor_allreduce(w) - alpha * q
            g = grad(w)
            q = bft.neighbor_allreduce(q) + g - g_prev
            g_prev = g
        if k + 1 == report:
            at = err(w)
    return at, err(w)


def push_diging(X, y, w_opt, maxite, report, alpha=0.1):
    """Push-DIGing on the directed Exp-2 graph through one push-sum window
    holding ``[u, q, v]``, so the three lanes move together."""
    from bluefog_tpu_torch import windows as win_mod

    size = X.shape[0]
    Xn, yn = X.cpu().numpy(), y.cpu().numpy()
    bft.set_topology(tu.ExponentialTwoGraph(size))
    outs = bft.out_neighbor_ranks()
    n = DIM

    def grads_np(w_stack):
        r = np.einsum("rsd,rd->rs", Xn, w_stack) - yn
        return np.einsum("rsd,rs->rd", Xn, r) / SAMPLES

    wv = np.zeros((size, 2 * n + 1), np.float32)
    g = grads_np(np.zeros((size, n), np.float32))
    wv[:, n:2 * n] = g
    wv[:, -1] = 1.0
    g_prev = g.copy()
    bft.win_create(bft.worker_values(list(wv)), "w_buff", zero_init=True)
    win_obj = win_mod._get_win(bft.get_context(), "w_buff")
    dst = [{d: 1.0 / (2 * len(outs[r])) for d in outs[r]} for r in range(size)]
    at = err = None
    for k in range(maxite):
        wv[:, :n] -= alpha * wv[:, n:2 * n]
        win_obj.value = bft.worker_values(list(wv))
        bft.win_accumulate(None, "w_buff", self_weight=0.5, dst_weights=dst)
        wv = bft.win_update_then_collect("w_buff").cpu().numpy().copy()
        x = wv[:, :n] / wv[:, -1:]
        g = grads_np(x)
        wv[:, n:2 * n] += g - g_prev
        g_prev = g
        err = float(np.linalg.norm(x.mean(0) - w_opt.cpu().numpy()))
        if k + 1 == report:
            at = err
    bft.win_free("w_buff")
    return at, err


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--method", default="all", choices=["all"] + sorted(TOLS))
    parser.add_argument("--maxite", type=int, default=400)
    parser.add_argument("--report", type=int, default=50,
                        help="the iteration whose error is printed beside the final one")
    args = parser.parse_args()

    bft.init(device=args.device)
    dev = bft.get_context().device
    Xn, yn, w_opt_n = make_problem(bft.size())
    X, y, w_opt = (torch.from_numpy(a).to(dev) for a in (Xn, yn, w_opt_n))

    names = sorted(TOLS) if args.method == "all" else [args.method]
    ok = True
    for name in names:
        bft.set_topology(tu.ExponentialTwoGraph(bft.size()), is_weighted=True)
        if name == "push_diging":
            at, err = push_diging(X, y, w_opt, args.maxite, args.report)
        else:
            at, err = gossip_method(name, X, y, w_opt, args.maxite, args.report)
        passed = err < TOLS[name]
        ok &= passed
        print(f"[{name:18s}] |w - w_opt| at iteration {args.report}: {at:.9e}; after "
              f"{args.maxite}: {err:.2e}  ({'ok' if passed else 'FAIL'}, tol {TOLS[name]:g})")
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
