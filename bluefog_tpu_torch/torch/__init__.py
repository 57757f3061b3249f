# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""bluefog_tpu_torch.torch: the ``torch.optim`` frontend of the port.

Counterpart of ``bluefog_tpu/torch/`` (upstream BlueFog's torch idiom):
collectives on worker tensors with ``torch.autograd`` adjoints, and
wrappers that turn the user's own ``torch.optim.Optimizer`` into a
distributed one::

    import bluefog_tpu_torch as bft
    import bluefog_tpu_torch.torch as bftt

    bft.init()
    flat = torch.nn.Parameter(params)  # [size, n], one row a worker
    opt = bftt.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD([flat], lr=0.1, momentum=0.9))
    opt.compression = "int8"
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.5)

The functional optimizers (``bft.sgd``, ``bft.adam`` under
``bft.Distributed*Optimizer``) stay in the package itself. Importing this
frontend binds ``bluefog_tpu_torch.torch``, so the package's own modules
never use a ``torch`` name of the package, and ``bluefog_tpu_torch``
does not import it.
"""

from bluefog_tpu_torch.torch.mpi_ops import (
    allgather,
    allreduce,
    broadcast,
    from_numpy,
    neighbor_allgather,
    neighbor_allreduce,
    to_numpy,
)
from bluefog_tpu_torch.torch.optimizers import (
    DistributedGradientAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    broadcast_parameters,
)

__all__ = [
    "allreduce",
    "allgather",
    "broadcast",
    "neighbor_allreduce",
    "neighbor_allgather",
    "to_numpy",
    "from_numpy",
    "DistributedGradientAllreduceOptimizer",
    "DistributedNeighborAllreduceOptimizer",
    "broadcast_parameters",
]
