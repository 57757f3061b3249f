# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""bluefog_tpu_torch — the PyTorch/CUDA port of bluefog_tpu.

N virtual workers live on one GPU as the leading axis of ``[N, ...]``
tensors; a gossip round is a gather along that axis. Several processes
(started by ``bfrun-torch``, :mod:`bluefog_tpu_torch.run`) each hold a
contiguous range of those rows, and a round reaches the other processes'
rows through ``torch.distributed`` point-to-point messages
(:mod:`bluefog_tpu_torch.collective.transport`). The facade mirrors
``bluefog_tpu``'s names for the ported slice: ``init`` with the machines x
local split, the rank and topology queries (machine level included), the
collectives (``allreduce``, ``allgather``, ``broadcast``,
``neighbor_allreduce`` exact or on the bf16/int8/int4 wire with explicit
or dynamic weights, ``neighbor_allgather`` on the bf16/int8/int4 wire,
``hierarchical_neighbor_allreduce``, ``pair_gossip``, ``barrier``), each
with a ``*_nonblocking`` form and ``poll``/``synchronize``/``wait``; the
gossip optimizers (gradient and weight allreduce, CTA/ATC neighbor gossip
on the bf16/int8/int4 wires and the error-feedback tiers int8_ef/int4_ef,
hierarchical) with ``make_train_step``, ``sgd`` and ``adam``; the
asynchronous push-sum gossip ``make_async_train_step``; the
parameter broadcast/allreduce utilities; weight-update sharding
(``sharding``: ZeRO-1/2 under ``BLUEFOG_SHARD`` and
``BLUEFOG_SHARD_GRADS``), ``checkpoint`` (``save``/``restore``) and the
byte models of ``scaling``; the window ops (``win_*``, the associated-p lane, the age lane
``get_win_age``) and the window optimizers
(win-put, pull-get, push-sum), and ``ops`` (``flash_attention``,
``flash_attention_with_lse``, ``reference_attention``); the models
(ResNet, ``TransformerLM``) are in :mod:`bluefog_tpu_torch.models`. The
quantized wires and the attention run through hand-written CUDA kernels
for Hopper (``csrc/wire_kernels.cu``, ``csrc/flash_kernels.cu``). Entry
points run on ``"cuda"`` unless ``device="cpu"`` is passed.

Observability: ``logger`` and ``set_log_level`` (``BLUEFOG_LOG_LEVEL``);
the Chrome-trace ``timeline`` (``timeline_init``, ``BLUEFOG_TIMELINE``); the
stall ``watchdog`` (``set_stall_timeout``, ``suspend``, ``resume``,
``BLUEFOG_STALL_TIMEOUT``); ``metrics`` (``metrics_snapshot``,
``metrics_export``; the sampled gossip probe under ``BLUEFOG_METRICS=1``);
the ``flight`` recorder (``flight_dump``, ``BLUEFOG_FLIGHT_DIR``); the
step-time doctor ``attribution`` (alias ``doctor``, ``BLUEFOG_DOCTOR``),
the ``staleness`` lineage (``BLUEFOG_STALENESS``), the ``memory``
observatory with its OOM forensics (``BLUEFOG_MEMORY``), and the fleet
``health`` plane (the mixing observatory, the push-sum fleet lane and the
``/healthz`` endpoint; ``BLUEFOG_HEALTH``, ``BLUEFOG_HEALTH_PORT``). The
spectral engine is in ``topology`` (``second_largest_eigenvalue_modulus``,
``consensus_decay_rate``, ``mixing_matrix``), and
``BLUEFOG_PLAN_METHOD=shortcut`` lowers the plans to the relay family on
the fabric ``BLUEFOG_TORUS_DIMS`` declares. ``federation`` (``BLUEFOG_PODS``,
``BLUEFOG_DCN_PERIOD``, ``BLUEFOG_DCN_WIRE``) makes the optimizers' combine
two-level: intra-pod every step, the pods' gateways every period; ``slo``
(``BLUEFOG_SLO``) is the SLO engine with its canary lane; ``fleetsim``
simulates thousands of ranks on the host; ``autotune``
(``BLUEFOG_AUTOTUNE``) is the closed-loop topology controller that migrates
the live run through the elastic path.

Elastic gossip: ``elastic`` (``start``, ``inject``, ``guard``, ``stop``;
``BLUEFOG_FAULT_PLAN``, ``BLUEFOG_LIVENESS_TIMEOUT``): a killed or stalled
rank is pruned from the topology, the ZeRO layout re-shards, the async
engine re-windows, and a checkpoint records the live set.
"""

from bluefog_tpu_torch.version import __version__
from bluefog_tpu_torch import async_gossip, checkpoint, collective, ops, scaling, sharding, topology
from bluefog_tpu_torch import elastic, flight, metrics, timeline, watchdog
from bluefog_tpu_torch import attribution, health, memory, staleness
from bluefog_tpu_torch import autotune, federation, fleetsim, slo
from bluefog_tpu_torch import attribution as doctor  # the bft.doctor facade
from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.flight import dump as flight_dump
from bluefog_tpu_torch.logging_util import logger, set_log_level
from bluefog_tpu_torch.metrics import metrics_export
from bluefog_tpu_torch.metrics import snapshot as metrics_snapshot
from bluefog_tpu_torch.timeline import (
    timeline_context,
    timeline_enabled,
    timeline_end_activity,
    timeline_init,
    timeline_record_counter,
    timeline_record_instant,
    timeline_shutdown,
    timeline_start_activity,
)
from bluefog_tpu_torch.watchdog import resume, set_stall_timeout, suspend
from bluefog_tpu_torch.collective.ops import (
    allgather,
    allgather_nonblocking,
    allreduce,
    allreduce_nonblocking,
    barrier,
    broadcast,
    broadcast_nonblocking,
    hierarchical_neighbor_allreduce,
    hierarchical_neighbor_allreduce_nonblocking,
    neighbor_allgather,
    neighbor_allgather_nonblocking,
    neighbor_allreduce,
    neighbor_allreduce_nonblocking,
    pair_gossip,
    pair_gossip_nonblocking,
    poll,
    synchronize,
    wait,
    worker_values,
)
from bluefog_tpu_torch.context import (
    BluefogContext,
    get_context,
    init,
    is_initialized,
    shutdown,
)
from bluefog_tpu_torch.optimizers import (
    CommunicationType,
    DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer,
    DistributedAllreduceOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedPullGetOptimizer,
    DistributedPushSumOptimizer,
    DistributedWinPutOptimizer,
    adam,
    sgd,
)
from bluefog_tpu_torch.utility import (
    allreduce_parameters,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from bluefog_tpu_torch.async_gossip import make_async_train_step
from bluefog_tpu_torch.windows import (
    get_current_created_window_names,
    get_win_age,
    get_win_version,
    turn_off_win_ops_with_associated_p,
    turn_on_win_ops_with_associated_p,
    win_accumulate,
    win_accumulate_nonblocking,
    win_associated_p,
    win_create,
    win_free,
    win_get,
    win_get_nonblocking,
    win_mutex,
    win_poll,
    win_put,
    win_put_nonblocking,
    win_read,
    win_update,
    win_update_then_collect,
    win_wait,
)


def make_train_step(optimizer, loss_fn, has_aux: bool = False, delayed: bool = False):
    """``optimizer.make_train_step(loss_fn, has_aux, delayed)`` for any
    gossip-family optimizer::

        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1))
        train_step = bft.make_train_step(opt, loss_fn)
        params, opt_state, loss = train_step(params, opt_state, *batch)
    """
    return optimizer.make_train_step(loss_fn, has_aux=has_aux, delayed=delayed)


def size() -> int:
    """Number of workers."""
    return get_context().size


def local_size() -> int:
    """Workers per machine."""
    return get_context().local_size


def machine_size() -> int:
    """Number of machines in the hierarchical split."""
    return get_context().machine_size


def rank() -> int:
    """The controlling process's index (the JAX ``jax.process_index()``):
    0 with one process, which drives every worker (before :func:`init`,
    the ``torch.distributed`` rank when a group is up)."""
    from bluefog_tpu_torch import context as ctx_mod

    if ctx_mod.is_initialized():
        return get_context().process_index
    return ctx_mod._process_layout()[1]


def local_rank() -> int:
    """Process-local analogue of :func:`rank`: 0, as in the JAX package
    (one process per machine of the default split)."""
    return 0


def machine_rank(worker_rank: int) -> int:
    """Machine index of a worker rank."""
    return worker_rank // get_context().local_size


def is_homogeneous() -> bool:
    """Every machine has the same worker count (the split is a reshape)."""
    return True


def set_topology(topology_graph=None, is_weighted: bool = False) -> bool:
    """Install a topology (a weight matrix); ``None`` restores the default
    :func:`~bluefog_tpu_torch.topology.ExponentialGraph`."""
    ctx = get_context()
    if topology_graph is None:
        topology_graph = topology_util.ExponentialGraph(ctx.size)
    return ctx.set_topology(topology_graph, is_weighted)


def load_topology():
    return get_context().load_topology()


def is_topo_weighted() -> bool:
    return get_context().is_topo_weighted()


def set_machine_topology(topology_graph, is_weighted: bool = False) -> bool:
    """Install the machine-level topology of the hierarchical ops."""
    return get_context().set_machine_topology(topology_graph, is_weighted)


def load_machine_topology():
    return get_context().load_machine_topology()


def is_machine_topo_weighted() -> bool:
    return get_context().is_machine_topo_weighted()


def in_neighbor_machine_ranks(machine_rank: int = None):
    return get_context().in_neighbor_machine_ranks(machine_rank)


def out_neighbor_machine_ranks(machine_rank: int = None):
    return get_context().out_neighbor_machine_ranks(machine_rank)


def in_neighbor_ranks(rank: int = None):
    return get_context().in_neighbor_ranks(rank)


def out_neighbor_ranks(rank: int = None):
    return get_context().out_neighbor_ranks(rank)


__all__ = [
    "__version__",
    "flight",
    "flight_dump",
    "metrics",
    "metrics_snapshot",
    "metrics_export",
    "timeline",
    "timeline_init",
    "timeline_shutdown",
    "timeline_enabled",
    "timeline_start_activity",
    "timeline_end_activity",
    "timeline_record_instant",
    "timeline_record_counter",
    "timeline_context",
    "watchdog",
    "suspend",
    "resume",
    "set_stall_timeout",
    "logger",
    "set_log_level",
    "async_gossip",
    "attribution",
    "doctor",
    "staleness",
    "memory",
    "health",
    "fleetsim",
    "federation",
    "slo",
    "autotune",
    "elastic",
    "checkpoint",
    "scaling",
    "sharding",
    "ops",
    "topology",
    "topology_util",
    "collective",
    "BluefogContext",
    "init",
    "shutdown",
    "is_initialized",
    "get_context",
    "size",
    "local_size",
    "machine_size",
    "rank",
    "local_rank",
    "machine_rank",
    "is_homogeneous",
    "set_topology",
    "load_topology",
    "is_topo_weighted",
    "set_machine_topology",
    "load_machine_topology",
    "is_machine_topo_weighted",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "in_neighbor_machine_ranks",
    "out_neighbor_machine_ranks",
    "worker_values",
    "allreduce",
    "allreduce_nonblocking",
    "allgather",
    "allgather_nonblocking",
    "broadcast",
    "broadcast_nonblocking",
    "neighbor_allreduce",
    "neighbor_allreduce_nonblocking",
    "neighbor_allgather",
    "neighbor_allgather_nonblocking",
    "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_nonblocking",
    "pair_gossip",
    "pair_gossip_nonblocking",
    "poll",
    "synchronize",
    "wait",
    "barrier",
    "make_train_step",
    "make_async_train_step",
    "sgd",
    "adam",
    "CommunicationType",
    "DistributedGradientAllreduceOptimizer",
    "DistributedAllreduceOptimizer",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedHierarchicalNeighborAllreduceOptimizer",
    "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer",
    "broadcast_parameters",
    "broadcast_optimizer_state",
    "allreduce_parameters",
    "DistributedWinPutOptimizer",
    "DistributedPullGetOptimizer",
    "DistributedPushSumOptimizer",
    "win_create",
    "win_free",
    "win_read",
    "win_put",
    "win_put_nonblocking",
    "win_get",
    "win_get_nonblocking",
    "win_accumulate",
    "win_accumulate_nonblocking",
    "win_update",
    "win_update_then_collect",
    "win_wait",
    "win_poll",
    "get_win_version",
    "get_win_age",
    "win_mutex",
    "get_current_created_window_names",
    "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
    "win_associated_p",
]
