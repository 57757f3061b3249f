# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's process level (``bluefog_tpu_torch.context``) against
``bluefog_tpu.context`` on the same inputs: the environment contract of
``maybe_init_distributed`` (the process group's call monkeypatched, as
``tests/test_launcher.py`` patches ``jax.distributed.initialize``), the
device order and the machine split on fake devices with a
``process_index``, the worker-count check and ``rank()`` /
``local_rank()``. The real process groups run in
``tests/test_torch_transport.py`` and ``tests/test_torch_launcher.py``.
"""

import jax
import pytest
import torch
import torch.distributed as dist

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import context as jctx
from bluefog_tpu_torch import context as ctx


class FakeDev:
    def __init__(self, process_index, ident, coords=None):
        self.process_index = process_index
        self.ident = ident
        if coords is not None:
            self.coords = coords

    def __repr__(self):
        return f"d{self.ident}@p{self.process_index}"


class FakeStore:
    def __init__(self):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value.encode() if isinstance(value, str) else value

    def get(self, key):
        return self.kv[key]


@pytest.fixture
def fake_group(monkeypatch):
    """The rendezvous store and ``init_process_group`` replaced: returns
    the recorded calls."""
    calls = {}
    store = FakeStore()

    def rendezvous(coordinator, world_size, rank):
        calls["rendezvous"] = (coordinator, world_size, rank)
        for q in range(world_size):  # the peers' devices: distinct CPUs
            store.set(f"bluefog/device/{q}", f"cpu:peer{q}")
        return store

    def init_process_group(backend, **kw):
        calls["init"] = dict(backend=backend, **kw)

    monkeypatch.setattr(ctx, "_rendezvous", rendezvous)
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(ctx, "_distributed_initialized", False)
    return calls, store


def test_maybe_init_distributed_env_contract_equal_jax(monkeypatch, fake_group):
    calls, store = fake_group
    jcalls = {}

    def fake_initialize(coordinator_address, num_processes, process_id):
        jcalls.update(addr=coordinator_address, n=num_processes, pid=process_id)

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    monkeypatch.setattr(jctx, "_distributed_initialized", False)
    monkeypatch.setenv("BLUEFOG_COORDINATOR", "h0:9781")
    monkeypatch.setenv("BLUEFOG_NUM_PROCESSES", "4")
    monkeypatch.setenv("BLUEFOG_PROCESS_ID", "3")
    assert jctx.maybe_init_distributed() is True
    assert ctx.maybe_init_distributed("cpu") is True
    assert calls["rendezvous"] == (jcalls["addr"], jcalls["n"], jcalls["pid"])
    init = calls["init"]
    assert (init["backend"], init["world_size"], init["rank"]) == ("gloo", 4, 3)
    assert init["store"] is store
    assert store.get("bluefog/device/3").decode().startswith("cpu:")
    # a second call is a no-op, as JAX's
    assert jctx.maybe_init_distributed() is False
    assert ctx.maybe_init_distributed("cpu") is False


def test_maybe_init_distributed_without_env_equal_jax(monkeypatch, fake_group):
    monkeypatch.delenv("BLUEFOG_COORDINATOR", raising=False)
    monkeypatch.setattr(jctx, "_distributed_initialized", False)
    assert jctx.maybe_init_distributed() is False
    assert ctx.maybe_init_distributed("cpu") is False
    assert fake_group[0] == {}


def test_maybe_init_distributed_defaults_process_id_like_jax(monkeypatch, fake_group):
    monkeypatch.setenv("BLUEFOG_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("BLUEFOG_NUM_PROCESSES", "1")
    monkeypatch.delenv("BLUEFOG_PROCESS_ID", raising=False)
    assert ctx.maybe_init_distributed("cpu") is True
    assert fake_group[0]["init"]["rank"] == 0


def test_cuda_without_cuda_raises_before_any_rendezvous(monkeypatch, fake_group):
    """No fallback: a CUDA process level without CUDA raises, and joins no
    group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BLUEFOG_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("BLUEFOG_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="CUDA"):
        ctx.maybe_init_distributed()
    assert fake_group[0] == {}


@pytest.mark.parametrize("device_type,uuids,want", [
    ("cpu", ["cpu:1", "cpu:2"], "gloo"),
    ("cpu", ["cpu:1", "cpu:1"], "gloo"),
    ("cuda", ["GPU-a"], "nccl"),
    ("cuda", ["GPU-a", "GPU-b", "GPU-c"], "nccl"),
    ("cuda", ["GPU-a", "GPU-a"], "gloo"),
    ("cuda", ["GPU-a", "GPU-b", "GPU-a", "GPU-c"], "gloo"),
])
def test_select_backend(device_type, uuids, want):
    """gloo on the CPU; NCCL when every process has a card of its own;
    gloo (CUDA rows staged through pinned host memory) when two share one."""
    assert ctx.select_backend(device_type, uuids) == want


@pytest.mark.parametrize("layout", [[1, 0, 1, 0], [0, 0, 0], [2, 1, 0, 2, 1, 0], [3, 3, 1, 0]])
@pytest.mark.parametrize("multi", [True, False])
def test_order_devices_for_mesh_equal_jax(layout, multi):
    devs = [FakeDev(pi, i) for i, pi in enumerate(layout)]
    got = ctx.order_devices_for_mesh(devs, multi_process=multi)
    assert got == jctx.order_devices_for_mesh(devs, multi_process=multi)
    if multi:
        assert [d.process_index for d in got] == sorted(layout)


def test_order_devices_for_mesh_with_coords_equal_jax():
    """Each process's devices walked serpentine, processes ascending."""
    coords = [(x, y) for y in range(2) for x in range(2)]
    devs = [FakeDev(p, 4 * p + i, coords=c) for p in (1, 0) for i, c in enumerate(coords)]
    for multi in (True, False):
        got = ctx.order_devices_for_mesh(devs, multi_process=multi)
        assert [d.ident for d in got] == [
            d.ident for d in jctx.order_devices_for_mesh(devs, multi_process=multi)]


@pytest.mark.parametrize("layout", [[0, 0, 0, 1, 1, 1], [0, 1], [0, 0, 1, 1, 2, 2, 3, 3], [0]])
@pytest.mark.parametrize("process_count", [1, 2, 4])
def test_default_nodes_per_machine_equal_jax(layout, process_count):
    devs = [FakeDev(pi, i) for i, pi in enumerate(layout)]
    assert ctx.default_nodes_per_machine(devs, process_count) == \
        jctx.default_nodes_per_machine(devs, process_count)


def _jax_mismatch(monkeypatch, requested, process_count, n_devices):
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDev(0, i) for i in range(n_devices)])
    monkeypatch.setattr(jax, "process_count", lambda: process_count)
    with pytest.raises(RuntimeError) as e:
        jctx._resolve_devices(requested)
    return str(e.value)


@pytest.mark.parametrize("counts,requested", [([3, 3], 8), ([4, 4, 1], 8), ([5, 3], 6)])
def test_worker_count_mismatch_raises_jax_wording(monkeypatch, counts, requested):
    """The counts exchanged at init must sum to ``BLUEFOG_NUM_WORKERS``:
    JAX's ``RuntimeError``, its devices being the port's workers."""
    want = _jax_mismatch(monkeypatch, requested, len(counts), sum(counts))

    def all_gather_object(out, obj):
        out[:] = counts

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    monkeypatch.setenv("BLUEFOG_NUM_WORKERS", str(requested))
    monkeypatch.setenv("BLUEFOG_LOCAL_WORKERS", str(counts[0]))
    with pytest.raises(RuntimeError) as got:
        ctx._worker_counts(requested, len(counts))
    assert str(got.value) == want.replace("devices", "workers")


def test_worker_counts_that_add_up(monkeypatch):
    def all_gather_object(out, obj):
        out[:] = [3, 5]

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    monkeypatch.setenv("BLUEFOG_NUM_WORKERS", "8")
    monkeypatch.setenv("BLUEFOG_LOCAL_WORKERS", "5")
    assert ctx._worker_counts(8, 2) == [3, 5]
    monkeypatch.delenv("BLUEFOG_LOCAL_WORKERS")

    def even(out, obj):  # the default: size // process_count each
        out[:] = [obj] * len(out)

    monkeypatch.setattr(dist, "all_gather_object", even)
    assert ctx._worker_counts(8, 4) == [2, 2, 2, 2]


def test_one_process_num_workers_mismatch_raises(monkeypatch):
    monkeypatch.setenv("BLUEFOG_NUM_WORKERS", "4")
    with pytest.raises(RuntimeError, match="BLUEFOG_NUM_WORKERS=4"):
        bft.init(size=8, device="cpu")
    assert not bft.is_initialized()
    c = bft.init(device="cpu")  # the size comes from BLUEFOG_NUM_WORKERS
    try:
        assert c.size == 4 and c.rows == range(4)
    finally:
        bft.shutdown()


def test_rank_and_local_rank_equal_jax(monkeypatch):
    bf.init()
    c = bft.init(device="cpu")
    try:
        assert (bft.rank(), bft.local_rank()) == (bf.rank(), bf.local_rank()) == (0, 0)
        # a process of index 2 (JAX: jax.process_index() == 2)
        monkeypatch.setattr(c, "process_index", 2)
        monkeypatch.setattr(jax, "process_index", lambda *a: 2)
        assert (bft.rank(), bft.local_rank()) == (bf.rank(), bf.local_rank()) == (2, 0)
    finally:
        bft.shutdown()
        bf.shutdown()


def test_rank_before_init_is_the_group_rank():
    assert not bft.is_initialized()
    assert bft.rank() == 0 and bft.local_rank() == 0
