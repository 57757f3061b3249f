"""The reference's first training steps: what the program's first steps
must reproduce.

:func:`follow` trains ``N`` workers from one parameter row on the
exponential graph, as the cell's mix states (adapt then combine: each
worker's gradient, momentum SGD as optax computes it, then the int8
neighbour combine), in float32 with TF32 off, one worker after another.
It returns each step's losses, each worker's first and last gradient
leaf by leaf, the largest gradient each leaf had over the steps and the
change of every leaf over the steps, as norms.

``cast`` puts every matrix product and convolution of the model in
another precision (the control: :func:`fp8`); ``fault`` plants one fault
the comparison must catch: ``"half_batch"`` (each worker's loss over half
its batch), ``"no_exchange"`` (no combine), ``"answer"`` (worker 0's
reported loss 1% off), or one of the model's own ``FAULTS`` (a wrong
gradient inside the model).
"""

import contextlib
from typing import Dict, Optional

import torch

from gossipbench.lib import weights
from gossipbench.lib.compare import slot_norms
from gossipbench.reference import wire

FAULTS = ("half_batch", "no_exchange", "answer")


def faults(model) -> tuple:
    """Every fault :func:`follow` can plant in ``model``."""
    return FAULTS + tuple(getattr(model, "FAULTS", ()))


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale per tensor (its
    largest magnitude to 448) in the forward; the gradient passes as is."""
    d = x.detach()
    scale = 448.0 / d.abs().amax().clamp(min=torch.finfo(torch.float32).tiny)
    q = (d * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - d)


@contextlib.contextmanager
def tf32_off():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def follow(model, cfg, mix, flat: torch.Tensor, batches, steps: int, cast=identity,
           fault: Optional[str] = None) -> Dict[str, object]:
    """``steps`` training steps of the mix's workers from the weights
    ``flat`` (drawn from ``model.param_table(cfg)``) on ``batches[t]``
    (worker-stacked tensors). Returns ``{"losses": [steps, N], "grad":
    {leaf: [N]}, "late_grad": {leaf: [N]}, "grad_max": {leaf: [N]},
    "change": {leaf: [N]}}`` on the host, in float64."""
    if mix["compression"] != "int8" or mix["topology"] != "ExponentialGraph":
        raise NotImplementedError("the reference combines on the int8 wire over the "
                                  "exponential graph")
    if fault is not None and fault not in faults(model):
        raise ValueError(f"unknown fault {fault!r}")
    inside = {"fault": fault} if fault in getattr(model, "FAULTS", ()) else {}
    table = model.param_table(cfg)
    slots, width = wire.layout(table)
    n, device = mix["workers"], flat.device
    src = wire.exponential_sources(n)
    lr, momentum = float(mix["lr"]), float(mix["momentum"])
    with tf32_off():
        row0 = wire.pack(slots, width, weights.views(table, flat), device)
        x = row0.repeat(n, 1)
        trace = torch.zeros_like(x)
        losses = torch.empty(steps, n, dtype=torch.float64)
        grad, grad_max, late_grad = None, {}, {}
        for t in range(steps):
            for j in range(n):
                leaves = {s.name: wire.leaf(x[j], s).clone().requires_grad_(True) for s in slots}
                batch = tuple(b[j] for b in batches[t])
                if fault == "half_batch":
                    batch = model.half_batch(batch)
                loss, grads = model.loss_and_grads(leaves, batch, cfg, cast, **inside)
                del leaves
                g = torch.zeros(width, dtype=torch.float32, device=device)
                for s, gs in zip(slots, grads):
                    wire.leaf(g, s).copy_(gs)
                del grads
                for k, v in slot_norms(g[None], slots).items():
                    top = grad_max.setdefault(k, torch.zeros(n, dtype=torch.float64))
                    top[j] = max(float(top[j]), float(v[0]))
                    late_grad.setdefault(k, torch.zeros(n, dtype=torch.float64))[j] = v[0]
                trace[j].mul_(momentum).add_(g)
                x[j].add_(trace[j] * -lr)
                losses[t, j] = float(loss) * (1.01 if fault == "answer" and j == 0 else 1.0)
                del g
            if t == 0:
                grad = slot_norms(trace, slots)
            if fault != "no_exchange":
                wire.combine_int8_(x, src)
        change = slot_norms(x, slots, minus=row0)
    return {"losses": losses, "grad": grad, "late_grad": late_grad, "grad_max": grad_max,
            "change": change}
