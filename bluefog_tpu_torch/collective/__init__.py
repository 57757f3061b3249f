# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Plans, combines, wire kernels and the eager facade."""

from bluefog_tpu_torch.collective.ops import neighbor_allreduce, worker_values
from bluefog_tpu_torch.collective.plan import (
    CommPlan,
    CommRound,
    plan_from_matrix,
    plan_from_topology,
    plan_from_weights,
)

__all__ = [
    "CommPlan",
    "CommRound",
    "neighbor_allreduce",
    "plan_from_matrix",
    "plan_from_topology",
    "plan_from_weights",
    "worker_values",
]
