# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Runtime context: worker count, device, the active topology, the
machines x local split with its machine topology, and the window
registry.

Counterpart of ``bluefog_tpu/context.py``. A worker is one slot on the
leading axis of a ``[size, ...]`` tensor on one device (README "Worker
model"); a topology is the numpy weight matrix of
:mod:`bluefog_tpu_torch.topology`. Worker ``m * local_size + l`` is local
slot ``l`` of machine ``m`` (the JAX machine mesh, row-major); there is no
machine topology until :meth:`BluefogContext.set_machine_topology` installs
one, as in the JAX package. Entry points run on the card: with
``device=None`` the context takes ``"cuda"`` and raises when CUDA is
absent; the CPU is used only when the caller asks for it.

The windows of :mod:`bluefog_tpu_torch.windows` and the associated-p
switch live on the context, so :func:`shutdown` (and a new :func:`init`)
drops them with it.

``init`` reads the knobs the JAX context reads: ``BLUEFOG_NODES_PER_MACHINE``
(the machine split when ``nodes_per_machine`` is not given),
``BLUEFOG_TIMELINE`` (:mod:`bluefog_tpu_torch.timeline`), the flight
recorder's and the metrics' knobs, and the observatories' switches
(``BLUEFOG_DOCTOR``, ``BLUEFOG_STALENESS``, ``BLUEFOG_MEMORY``) and the SLO
engine's (``BLUEFOG_SLO``). A set ``BLUEFOG_PODS`` declares a federation,
which the optimizers' combine follows (:mod:`bluefog_tpu_torch.federation`,
with ``BLUEFOG_DCN_PERIOD`` and ``BLUEFOG_DCN_WIRE``). The plans
of the active topology follow ``BLUEFOG_PLAN_METHOD``
(:func:`bluefog_tpu_torch.collective.compiler.plan_method`) and, for the
relay family, ``BLUEFOG_TORUS_DIMS``; both are in the plans' cache keys.
The health plane (:mod:`bluefog_tpu_torch.health`, ``BLUEFOG_HEALTH``,
``BLUEFOG_HEALTH_PORT``) is opened and closed with the context.

The process level (the JAX context's ``maybe_init_distributed``,
``order_devices_for_mesh``, ``default_nodes_per_machine`` and the
``BLUEFOG_NUM_WORKERS`` check): when the launcher (:mod:`bluefog_tpu_torch.run`)
sets ``BLUEFOG_COORDINATOR``, ``BLUEFOG_NUM_PROCESSES`` and
``BLUEFOG_PROCESS_ID``, :func:`init` joins a ``torch.distributed`` process
group first. Each process then holds a contiguous range of the global
worker rows, :attr:`BluefogContext.rows` (``BLUEFOG_LOCAL_WORKERS`` of
them, by default ``size // process_count``), ordered by process index,
and every worker tensor it passes is ``[n_local, ...]``; the combines
reach the other processes' rows through
:mod:`bluefog_tpu_torch.collective.transport`. By default one machine of
the hierarchical split is one process. The backend is ``gloo`` on the
CPU; on CUDA the processes exchange their device UUIDs over the
rendezvous store, and the backend is ``nccl`` unless two of them share a
device, when it is ``gloo`` with the CUDA rows staged through pinned host
memory. With one process nothing changes: ``rows == range(size)``.
"""

import collections
import datetime
import itertools
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.collective.plan import CommPlan, plan_from_topology
from bluefog_tpu_torch.topology import ExponentialGraph, placement

__all__ = [
    "BluefogContext",
    "resolve_device",
    "maybe_init_distributed",
    "select_backend",
    "order_devices_for_mesh",
    "default_nodes_per_machine",
    "init",
    "shutdown",
    "is_initialized",
    "get_context",
    "release_associated_p",
]

_lock = threading.Lock()
_context: Optional["BluefogContext"] = None
_ctx_uid = itertools.count()
_distributed_initialized = False

# how long a process waits for its peers at the rendezvous and in the
# process group's calls
_GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises. A
    CUDA device without an index gets the current one, so it compares
    equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; bluefog_tpu_torch runs on the GPU "
                "unless device='cpu' is passed explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def select_backend(device_type: str, device_uuids: Sequence[str]) -> str:
    """The process group's backend: ``gloo`` on the CPU; on CUDA ``nccl``
    when every process has a device of its own (the UUIDs all differ),
    else ``gloo``, whose CUDA rows the transport stages through pinned host
    memory (NCCL refuses two ranks of one communicator on one device)."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if len(set(device_uuids)) == len(device_uuids) else "gloo"


def _device_uuid(device: torch.device) -> str:
    if device.type != "cuda":
        return f"{device.type}:{os.getpid()}"
    return str(torch.cuda.get_device_properties(device).uuid)


def _rendezvous(coordinator: str, world_size: int, rank: int):
    """The rendezvous store at ``host:port`` (process 0 serves it)."""
    import torch.distributed as dist

    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"BLUEFOG_COORDINATOR must be host:port, got {coordinator!r}")
    return dist.TCPStore(host, int(port), world_size, rank == 0, timeout=_GROUP_TIMEOUT)


def maybe_init_distributed(device=None) -> bool:
    """Join the process group when the launcher asked (the JAX
    ``maybe_init_distributed``): with ``BLUEFOG_COORDINATOR`` (``host:port``)
    set, ``torch.distributed.init_process_group`` over the rendezvous store
    at that address, ``world_size=BLUEFOG_NUM_PROCESSES``,
    ``rank=BLUEFOG_PROCESS_ID``, once per process. The backend is
    :func:`select_backend` of ``device`` (default ``"cuda"``) and the
    device UUIDs the processes exchange over the store; it is decided here
    and never retried on another: a failing NCCL init raises. Returns True
    when the group was joined by this call."""
    global _distributed_initialized
    coordinator = os.environ.get("BLUEFOG_COORDINATOR")
    if not coordinator or _distributed_initialized:
        return False
    import torch.distributed as dist

    world_size = int(os.environ["BLUEFOG_NUM_PROCESSES"])
    rank = int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
    dev = resolve_device(device)
    store = _rendezvous(coordinator, world_size, rank)
    store.set(f"bluefog/device/{rank}", _device_uuid(dev))
    uuids = [store.get(f"bluefog/device/{q}").decode() for q in range(world_size)]
    backend = select_backend(dev.type, uuids)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=world_size, rank=rank,
                            timeout=_GROUP_TIMEOUT)
    _distributed_initialized = True
    return True


def _process_layout():
    """``(process count, process index, backend)``: the ``torch.distributed``
    group's when one is up, else one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def order_devices_for_mesh(devices: Sequence, multi_process: bool) -> List:
    """The worker order of ``devices`` (the JAX ``order_devices_for_mesh``):
    the serpentine walk, grouped by ``process_index`` in ascending order
    when several processes run (:func:`placement.worker_device_order`)."""
    return placement.worker_device_order(devices, multi_process=multi_process)


def default_nodes_per_machine(devices: Sequence, process_count: int) -> Optional[int]:
    """The machine width when none was asked for (the JAX helper): with
    several processes one machine is one process, of process 0's worker
    count; one process has no natural split (None)."""
    if process_count > 1:
        return len([d for d in devices if d.process_index == 0])
    return None


def _worker_counts(size: int, process_count: int) -> List[int]:
    """Every process's worker count, exchanged over the group: its
    ``BLUEFOG_LOCAL_WORKERS``, by default ``size // process_count``. They
    must sum to ``size`` (the JAX ``_resolve_devices`` check)."""
    env = os.environ.get("BLUEFOG_LOCAL_WORKERS", "").strip()
    local = int(env) if env else size // process_count
    if process_count == 1:
        counts = [local if env else size]
    else:
        import torch.distributed as dist

        counts = [None] * process_count
        dist.all_gather_object(counts, local)
    total = sum(counts)
    requested = os.environ.get("BLUEFOG_NUM_WORKERS", "").strip()
    for want in ([int(requested)] if requested else []) + [size]:
        if total != want or min(counts) < 1:
            raise RuntimeError(
                f"BLUEFOG_NUM_WORKERS={want} but the {process_count}-process pod exposes "
                f"{total} workers; host slot counts must sum to -np"
            )
    return [int(c) for c in counts]


class BluefogContext:
    """Owns the worker count, the device, the process level and the
    active topology."""

    def __init__(
        self,
        topology_fn: Optional[Callable[[int], np.ndarray]] = None,
        is_weighted: bool = False,
        size: Optional[int] = None,
        device=None,
        nodes_per_machine: Optional[int] = None,
    ):
        if size is None:
            env = os.environ.get("BLUEFOG_NUM_WORKERS", "").strip()
            size = int(env) if env else 8
        if size < 1:
            raise ValueError(f"size must be positive, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)
        self.process_count, self.process_index, self.backend = _process_layout()
        # the process group's device rows go through pinned host memory when
        # gloo carries CUDA rows (processes sharing a card)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.worker_counts = tuple(_worker_counts(self.size, self.process_count))
        lo = sum(self.worker_counts[:self.process_index])
        self.rows = range(lo, lo + self.worker_counts[self.process_index])
        self.n_local = len(self.rows)
        if nodes_per_machine is None:
            env = os.environ.get("BLUEFOG_NODES_PER_MACHINE")
            if env:
                nodes_per_machine = int(env)
            elif self.process_count > 1:
                nodes_per_machine = self.worker_counts[0]
        self.local_size = int(nodes_per_machine or self.size)
        if self.local_size < 1 or self.size % self.local_size:
            raise ValueError(
                f"nodes_per_machine={self.local_size} must divide the worker "
                f"count {self.size}"
            )
        self.machine_size = self.size // self.local_size
        self._topology: Optional[np.ndarray] = None
        self._topo_weighted = False
        self.topo_version = 0
        self._plan_cache: Optional[tuple] = None
        # the keys of the static plans built, newest last (bounded): a plan
        # built under an elastic session carries the live token
        self.plan_keys: collections.deque = collections.deque(maxlen=64)
        self._neighbor_sets_cache: Optional[tuple] = None
        self._machine_topology: Optional[np.ndarray] = None
        self._machine_topo_weighted = False
        self.machine_topo_version = 0
        self._machine_plan_cache: Optional[tuple] = None
        self.uid = next(_ctx_uid)
        # name -> windows._Window
        self.windows: Dict[str, object] = {}
        # host-side lowering caches of the window ops, keyed on structure
        self.op_cache: Dict[tuple, object] = {}
        # results of the nonblocking window ops, by handle
        self.handles: Dict[int, object] = {}
        # the associated-p lane: the user switch, and the holds of the
        # live push-sum optimizers
        self.p_switch = False
        self.p_refcount = 0
        # the elastic live set (bluefog_tpu_torch.elastic): None until an
        # ElasticSession installs its Membership; the static plan's key
        # folds live_token() in, so a membership change can never dispatch
        # a stale plan
        self.elastic_membership = None
        topo_fn = topology_fn if topology_fn is not None else ExponentialGraph
        self.set_topology(topo_fn(self.size), is_weighted)

    def set_topology(self, topology: np.ndarray, is_weighted: bool = False) -> bool:
        topo = np.asarray(topology, dtype=np.float64)
        if topo.shape != (self.size, self.size):
            raise ValueError(
                f"topology is {topo.shape} but there are {self.size} workers"
            )
        if (
            self._topology is not None
            and np.array_equal(topo, self._topology)
            and is_weighted == self._topo_weighted
        ):
            return True
        self._topology = topo.copy()
        self._topology.setflags(write=False)
        self._topo_weighted = bool(is_weighted)
        self.topo_version += 1
        return True

    def load_topology(self) -> np.ndarray:
        return self._topology

    def is_topo_weighted(self) -> bool:
        return self._topo_weighted

    def set_machine_topology(self, topology: np.ndarray, is_weighted: bool = False) -> bool:
        """Install the machine-level topology of the hierarchical ops."""
        topo = np.asarray(topology, dtype=np.float64)
        if topo.shape != (self.machine_size, self.machine_size):
            raise ValueError(
                f"machine topology is {topo.shape} but there are "
                f"{self.machine_size} machines"
            )
        self._machine_topology = topo.copy()
        self._machine_topology.setflags(write=False)
        self._machine_topo_weighted = bool(is_weighted)
        self.machine_topo_version += 1
        return True

    def load_machine_topology(self) -> Optional[np.ndarray]:
        return self._machine_topology

    def is_machine_topo_weighted(self) -> bool:
        return self._machine_topo_weighted

    def machine_plan(self, method: str = "auto") -> CommPlan:
        """The plan of the machine topology under the compiler's ``method``,
        rebuilt only when either changes (a new one is noted in the flight
        recorder)."""
        if self._machine_topology is None:
            raise ValueError(
                "no machine topology set; call set_machine_topology() or pass "
                "explicit machine weights"
            )
        key = (self.machine_topo_version, method,
               placement.declared_torus_dims(self.machine_size))
        cached = self._machine_plan_cache
        if cached is None or cached[0] != key:
            from bluefog_tpu_torch import flight

            plan = plan_from_topology(
                self._machine_topology, weighted=self._machine_topo_weighted, method=method
            )
            self._machine_plan_cache = cached = (key, plan)
            flight.note_plan(plan, self.machine_topo_version, self.live_token(), kind="machine")
        return cached[1]

    def live_token(self):
        """Hashable ``(epoch, live ranks)`` of the elastic live set, or None
        when no elastic session is open (every worker lives)."""
        m = self.elastic_membership
        return None if m is None else m.token()

    def static_plan(self) -> CommPlan:
        """The plan of the active topology under ``BLUEFOG_PLAN_METHOD``
        (and ``BLUEFOG_TORUS_DIMS``, the relay family's fabric), rebuilt
        only when one of them or the elastic live set
        (:meth:`live_token`) changes: a membership change, even one that
        reinstalls an identical-looking graph, never reuses a plan built
        for the old live set. A new plan is noted in the flight recorder
        with its token and its key in :attr:`plan_keys`."""
        token = self.live_token()
        key = ("static_plan", self.topo_version, self._topo_weighted,
               compiler.plan_method(), placement.declared_torus_dims(self.size), token)
        cached = self._plan_cache
        if cached is None or cached[0] != key:
            from bluefog_tpu_torch import flight

            plan = plan_from_topology(
                self._topology, weighted=self._topo_weighted, method=key[3]
            )
            self._plan_cache = cached = (key, plan)
            self.plan_keys.append(key)
            flight.note_plan(plan, self.topo_version, token)
        return cached[1]

    def p_enabled(self) -> bool:
        """Whether window ops carry the associated-p lane: switched on by
        the user or held by a live push-sum optimizer."""
        return self.p_switch or self.p_refcount > 0

    def acquire_associated_p(self) -> int:
        """Take a hold on the p lane (each push-sum optimizer takes one,
        so freeing one cannot disable the lane under another); returns
        this context's id, for :func:`release_associated_p`."""
        self.p_refcount += 1
        return self.uid

    def in_neighbor_sets(self):
        """Per-rank frozen in-neighbour sets of the active topology, cached
        on ``topo_version`` (the explicit-weight calls validate their keys
        against them on every call)."""
        cached = self._neighbor_sets_cache
        if cached is None or cached[0] != self.topo_version:
            sets = tuple(frozenset(self.in_neighbor_ranks(r)) for r in range(self.size))
            self._neighbor_sets_cache = cached = (self.topo_version, sets)
        return cached[1]

    def in_neighbor_machine_ranks(self, machine_rank: Optional[int] = None):
        """In-neighbours of a machine in the machine topology (every
        machine's lists with ``None``); ``None`` without a machine
        topology."""
        if self._machine_topology is None:
            return None
        if machine_rank is None:
            return [self.in_neighbor_machine_ranks(m) for m in range(self.machine_size)]
        col = self._machine_topology[:, machine_rank]
        return [int(m) for m in np.nonzero(col)[0] if m != machine_rank]

    def out_neighbor_machine_ranks(self, machine_rank: Optional[int] = None):
        if self._machine_topology is None:
            return None
        if machine_rank is None:
            return [self.out_neighbor_machine_ranks(m) for m in range(self.machine_size)]
        row = self._machine_topology[machine_rank]
        return [int(m) for m in np.nonzero(row)[0] if m != machine_rank]

    def in_neighbor_ranks(self, rank: Optional[int] = None):
        if rank is None:
            return [self.in_neighbor_ranks(r) for r in range(self.size)]
        col = self._topology[:, rank]
        return [int(i) for i in np.nonzero(col)[0] if i != rank]

    def out_neighbor_ranks(self, rank: Optional[int] = None):
        if rank is None:
            return [self.out_neighbor_ranks(r) for r in range(self.size)]
        row = self._topology[rank]
        return [int(j) for j in np.nonzero(row)[0] if j != rank]


def _sampler_switches() -> tuple:
    """``(name, on, interval)`` of every fleet sampler as the environment
    sets it, which every process must hold alike."""
    from bluefog_tpu_torch import attribution, autotune, health, memory, metrics, slo, staleness

    return (("metrics", metrics.enabled(), metrics.metrics_interval()),
            ("doctor", attribution.enabled(), attribution.doctor_interval()),
            ("staleness", staleness.enabled(), staleness.staleness_interval()),
            ("memory", memory.enabled(), memory.memory_interval()),
            ("health", health.enabled(), health.health_interval()),
            ("slo", slo.enabled(), slo.slo_interval(), slo.canary_enabled()),
            ("autotune", autotune.enabled(), autotune.autotune_interval()))


def init(
    topology_fn: Optional[Callable[[int], np.ndarray]] = None,
    is_weighted: bool = False,
    size: Optional[int] = None,
    device=None,
    nodes_per_machine: Optional[int] = None,
) -> BluefogContext:
    """Install the global context (reference ``bf.init``): ``size``
    workers (default ``BLUEFOG_NUM_WORKERS``, else 8) on ``device`` (default
    ``"cuda"``), after joining the process group the launcher's
    ``BLUEFOG_COORDINATOR`` names (:func:`maybe_init_distributed`), this
    process holding its :attr:`~BluefogContext.rows`; topology
    ``topology_fn(size)`` (default :func:`ExponentialGraph`), split into
    machines of ``nodes_per_machine`` workers (default
    ``BLUEFOG_NODES_PER_MACHINE``, else one machine of all) for the
    hierarchical ops. Closes an open elastic session (it is bound to the
    old context's membership), opens the timeline of ``BLUEFOG_TIMELINE``,
    a fresh flight recorder, the observatory sessions their switches
    ask for and the health plane (``BLUEFOG_HEALTH``, its endpoint under
    ``BLUEFOG_HEALTH_PORT``), the topology controller (``BLUEFOG_AUTOTUNE``),
    the SLO engine last (``BLUEFOG_SLO``; it reads the others), and sets the
    ``bluefog.size`` and ``bluefog.machine_size`` gauges. A set ``BLUEFOG_PODS`` federates the
    optimizers' combine (:mod:`bluefog_tpu_torch.federation`). Across
    processes every process must set the samplers' switches and intervals
    alike: one ``all_gather_object`` raises ``RuntimeError`` in every
    process otherwise."""
    global _context
    from bluefog_tpu_torch import async_gossip, attribution, autotune, elastic, flight, health
    from bluefog_tpu_torch import memory, metrics, slo, staleness
    from bluefog_tpu_torch import timeline as tl

    maybe_init_distributed(device)
    elastic.stop()
    ctx = BluefogContext(topology_fn, is_weighted, size, device, nodes_per_machine)
    if ctx.process_count > 1:
        from bluefog_tpu_torch.collective import transport

        # a sampler on in one process only would leave the others waiting
        # in its first gather: refuse it in every process, before anything
        transport.agree(_sampler_switches(), "bft.init: the fleet samplers' switches", ctx)
    with _lock:
        _context = ctx
    tl.maybe_init_from_env()
    # after the timeline, so the session_start clock triple carries its clock
    flight.on_init(ctx)
    # fresh observatory sessions for a fresh context; memory's OOM hook
    # installs after the flight recorder's, so it runs first
    attribution.on_init(ctx)
    health.on_init(ctx)
    staleness.on_init(ctx)
    memory.on_init(ctx)
    autotune.on_init(ctx)
    async_gossip.on_init(ctx)
    slo.on_init(ctx)
    metrics.gauge("bluefog.size").set(ctx.size)
    metrics.gauge("bluefog.machine_size").set(ctx.machine_size)
    if ctx.backend is not None:
        from bluefog_tpu_torch.collective import transport

        transport.on_init(ctx)
    return ctx


def shutdown() -> None:
    """Drop the global context (reference ``bf.shutdown``): close the
    elastic session, the SLO engine (first, so its JSONL tail flushes while
    the tiers it reads are up), the topology controller (its ``session_end``
    line), the observatory sessions, the health plane and its endpoint, and
    the flight session, fold the pending probe payloads and run the
    env-configured exporters, then close a timeline
    ``init`` opened from ``BLUEFOG_TIMELINE`` (a timeline the user opened
    stays open)."""
    global _context
    from bluefog_tpu_torch import async_gossip, attribution, autotune, elastic, flight, health
    from bluefog_tpu_torch import memory, metrics, slo, staleness
    from bluefog_tpu_torch import timeline as tl

    elastic.stop()
    slo.on_shutdown()
    autotune.on_shutdown()
    async_gossip.on_shutdown()
    attribution.on_shutdown()
    health.on_shutdown()
    staleness.on_shutdown()
    memory.on_shutdown()
    if _context is not None:
        flight.on_shutdown()
    metrics.flush()
    metrics.auto_export()
    if tl.timeline_env_owned():
        tl.timeline_shutdown()
    with _lock:
        _context = None


def release_associated_p(ctx_uid: int) -> None:
    """Release a hold taken by :meth:`BluefogContext.acquire_associated_p`,
    only against the same context: a hold taken before a shutdown must
    not decrement a newer context's count."""
    ctx = _context
    if ctx is None or ctx.uid != ctx_uid:
        return
    ctx.p_refcount = max(ctx.p_refcount - 1, 0)


def is_initialized() -> bool:
    return _context is not None


def get_context() -> BluefogContext:
    if _context is None:
        raise RuntimeError(
            "bluefog_tpu_torch is not initialized; call init() first"
        )
    return _context
