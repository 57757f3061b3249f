# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Runtime context: worker count, device, the active topology, and the
window registry.

Counterpart of ``bluefog_tpu/context.py``. A worker is one slot on the
leading axis of a ``[size, ...]`` tensor on one device (README "Worker
model"); a topology is the numpy weight matrix of
:mod:`bluefog_tpu_torch.topology`. Entry points run on the card: with
``device=None`` the context takes ``"cuda"`` and raises when CUDA is
absent; the CPU is used only when the caller asks for it.

The windows of :mod:`bluefog_tpu_torch.windows` and the associated-p
switch live on the context, so :func:`shutdown` (and a new :func:`init`)
drops them with it.
"""

import itertools
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bluefog_tpu_torch.collective.plan import CommPlan, plan_from_topology
from bluefog_tpu_torch.topology import ExponentialGraph

__all__ = [
    "BluefogContext",
    "resolve_device",
    "init",
    "shutdown",
    "is_initialized",
    "get_context",
    "release_associated_p",
]

_lock = threading.Lock()
_context: Optional["BluefogContext"] = None
_ctx_uid = itertools.count()


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


class BluefogContext:
    """Owns the worker count, the device and the active topology."""

    def __init__(
        self,
        topology_fn: Optional[Callable[[int], np.ndarray]] = None,
        is_weighted: bool = False,
        size: int = 8,
        device=None,
    ):
        if size < 1:
            raise ValueError(f"size must be positive, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)
        self._topology: Optional[np.ndarray] = None
        self._topo_weighted = False
        self.topo_version = 0
        self._plan_cache: Optional[tuple] = None
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

    def static_plan(self) -> CommPlan:
        """The plan of the active topology, rebuilt only when it changes."""
        cached = self._plan_cache
        if cached is None or cached[0] != self.topo_version:
            plan = plan_from_topology(
                self._topology, weighted=self._topo_weighted
            )
            self._plan_cache = cached = (self.topo_version, plan)
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


def init(
    topology_fn: Optional[Callable[[int], np.ndarray]] = None,
    is_weighted: bool = False,
    size: int = 8,
    device=None,
) -> BluefogContext:
    """Install the global context (reference ``bf.init``): ``size``
    virtual workers on ``device`` (default ``"cuda"``), topology
    ``topology_fn(size)`` (default :func:`ExponentialGraph`)."""
    global _context
    ctx = BluefogContext(topology_fn, is_weighted, size, device)
    with _lock:
        _context = ctx
    return ctx


def shutdown() -> None:
    global _context
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
