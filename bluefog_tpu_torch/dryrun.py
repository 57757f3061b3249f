# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The fp32 dry run of ``__graft_entry__.dryrun_multichip`` on stacked
workers.

Counterpart of ``__graft_entry__._dryrun_body``: ``size`` workers viewed as
``machines x local`` (``local`` 2 when ``size`` is even and at least 4),
each training its own ``MLP(features=(16, 10))`` on 4 x 12 inputs under
``sgd(0.05, 0.9)``, adapt-then-combine:

1. every worker's loss and gradient, then the SGD update;
2. the updated parameters gossiped on the dynamic one-peer Exp2 schedule
   (``schedule_from_dynamic`` over ``GetDynamicOnePeerSendRecvRanks``),
   the step index selecting the period's plan on the device;
3. the loss averaged hierarchically: summed over each machine, combined
   on the weighted machine ring, divided by ``local``;
4. ring attention over the worker ring on ``tanh(x[:1, :8])`` reshaped to
   ``[1, 2, 2, 2]`` per worker, causal, added to the metric times 0 (as in
   the JAX body, outside the differentiated loss: only the forward runs)
   and returned as well, so that a caller can check it.

Run on ``"cuda"`` unless ``device="cpu"`` is passed.
"""

from typing import Tuple

import numpy as np
import torch

from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import inner
from bluefog_tpu_torch.collective.plan import plan_from_topology, schedule_from_dynamic
from bluefog_tpu_torch.context import resolve_device
from bluefog_tpu_torch.models import mlp
from bluefog_tpu_torch.models.stacked import StackedModel
from bluefog_tpu_torch.ops.attention import ring_attention
from bluefog_tpu_torch.optimizers import sgd

__all__ = ["DryRun"]

FEATURES = (16, 10)
BATCH, IN_FEATURES = 4, 12


class DryRun:
    """The dry run's model, schedules, optimizer and data on ``size``
    stacked workers. :meth:`step` is one adapt-then-combine step; the
    parameters are the packed ``[size, width]`` buffer of
    :class:`~bluefog_tpu_torch.models.StackedModel` (flax leaf order)."""

    def __init__(self, size: int = 8, device=None):
        self.device = resolve_device(device)
        self.size = size
        self.local = 2 if size % 2 == 0 and size >= 4 else 1
        self.machines = size // self.local
        graph = topo.ExponentialTwoGraph(size)
        self.schedule = schedule_from_dynamic(
            size, lambda r: topo.GetDynamicOnePeerSendRecvRanks(graph, r))
        self.machine_plan = plan_from_topology(
            topo.RingGraph(self.machines) if self.machines > 1 else topo.FullyConnectedGraph(1),
            weighted=True)
        self.model = StackedModel(mlp.MLP(IN_FEATURES, FEATURES), size, self.device)
        self.tx = sgd(0.05, momentum=0.9)
        rng = np.random.RandomState(0)
        self.batches = torch.from_numpy(
            rng.randn(size, BATCH, IN_FEATURES).astype(np.float32)).to(self.device)
        self.labels = torch.from_numpy(rng.randint(0, 10, size=(size, BATCH))).to(self.device)

    def init_params(self, seed: int = 0) -> torch.Tensor:
        """``[size, width]``: worker ``r`` initialised from seed ``seed +
        r`` (:func:`bluefog_tpu_torch.models.mlp.init_flax_like`)."""
        rows = [self.model.pack(dict(mlp.init_flax_like(
            mlp.MLP(IN_FEATURES, FEATURES), seed + r).named_parameters()))
            for r in range(self.size)]
        return torch.stack(rows)

    def step(self, params: torch.Tensor, state,
             step) -> Tuple[torch.Tensor, object, torch.Tensor, torch.Tensor]:
        """One step at index ``step`` (an int or an integer tensor): returns
        ``(params, state, metric [size, 1], attn [size, 1, 2, 2, 2])``;
        ``params`` and ``state`` are updated in place by the SGD half, and
        the gossiped parameters are a new tensor."""
        losses, grads = self.model.loss_and_grad(params, self.batches, self.labels)
        with torch.no_grad():
            self.tx.apply_(params, state, grads)
            params = inner.neighbor_allreduce_step(params, step, self.schedule)
            metric = inner.hierarchical_neighbor_allreduce(
                losses.reshape(self.size, 1), self.machine_plan, self.local)
            qkv = torch.tanh(self.batches[:, :1, :8]).reshape(self.size, 1, 2, 2, 2)
            attn = ring_attention(qkv, qkv, qkv, causal=True)
            metric = metric + 0.0 * attn.sum(dim=(1, 2, 3, 4)).reshape(self.size, 1)
        return params, state, metric, attn

