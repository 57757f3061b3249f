# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's short-cut (relay) plan family against the JAX package's:
the compiler pass (``shortcut_perms``, ``_check_relay``, the dims in the
compile-cache key), the fabric model of ``topology.placement``, the relay
plans' weights and neighbour relations, every relay combine and the relay
``neighbor_allgather``, the error-feedback refusal, and the facade and the
optimizers under ``BLUEFOG_PLAN_METHOD=shortcut`` and
``BLUEFOG_TORUS_DIMS``.

Tolerances. Schedules, routes, congestion, weights and neighbours are held
EXACTLY equal to JAX's. A relay forwards verbatim, so the port replays the
transit on the host and gathers each round's origin row; that replay is
held bitwise to a numpy simulation of the transit on the actual arrays,
and the relay combines to JAX's: the f32 combine bitwise under dyadic
weights and integer payloads (JAX's exactness scheme of
``test_shortcut_combine_bitwise_dyadic``) and within ``1e-6`` of the
largest value otherwise (XLA:CPU may contract ``y + r * w`` into an FMA,
which the port rounds twice); the bf16 and int4 wires bitwise JAX's on
Exp2(8), whose weights (1/4) are powers of two, the int8 wire and the ring
(1/3) within ``1e-6`` (with its f32 block scales, XLA:CPU contracts the
dequantize ``q * s - xhat`` into one rounding; the direct int8 combine
differs from JAX's by the same ulps); the int8 and int4 relays bitwise a
numpy relay of the wire pairs on ``wire_ref``'s format. The relay
allgather is bitwise the direct plan's and JAX's. JAX runs with
``BLUEFOG_WIRE_KERNELS=0`` (its Pallas wire fails inside ``shard_map`` on
this jax; its relay branches are the composite ones anyway).
"""

import functools

import jax
import ml_dtypes
import networkx as nx
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import jax.numpy as jnp

import bluefog_tpu as bf
from bluefog_tpu import topology as jtu
from bluefog_tpu.collective import compiler as jcompiler
from bluefog_tpu.collective import inner as jinner
from bluefog_tpu.collective import plan as jplan
from bluefog_tpu.collective import wire_ref
from bluefog_tpu.topology import placement as jplacement
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import logging_util
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective import compiler, inner, kernels
from bluefog_tpu_torch.collective import plan as tplan
from bluefog_tpu_torch.topology import placement

SIZE = 8
AXIS = "w"
GRAPHS = {
    "exp2": (tu.ExponentialTwoGraph, jtu.ExponentialTwoGraph),
    "ring": (tu.RingGraph, jtu.RingGraph),
    "star": (tu.StarGraph, jtu.StarGraph),
    "regular": (lambda n: tu.RandomRegularDigraph(n, 2, seed=3),
                lambda n: jtu.RandomRegularDigraph(n, 2, seed=3)),
}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for k in ("BLUEFOG_PLAN_METHOD", "BLUEFOG_TORUS_DIMS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    yield
    compiler.clear_compile_cache()
    jcompiler.clear_compile_cache()


@pytest.fixture
def contexts(cpu_devices):
    bf.init(devices=cpu_devices[:SIZE])
    bft.init(device="cpu")
    yield
    bf.shutdown()
    bft.shutdown()


def _random_edges(rng, size):
    all_edges = [(i, j) for i in range(size) for j in range(size) if i != j]
    k = rng.randint(1, len(all_edges) + 1)
    return [all_edges[i] for i in rng.choice(len(all_edges), size=k, replace=False)]


def _dyadic_matrix(rng, size):
    """Dyadic-rational weights (k / 64): the f32 combine is exact in any
    order (JAX's ``dyadic_matrix``)."""
    w = rng.randint(-64, 65, size=(size, size)).astype(np.float64) / 64.0
    mask = rng.rand(size, size) < 0.5
    np.fill_diagonal(mask, True)
    return np.where(mask, w, 0.0)


def _run_spmd(fn, x, out_specs=P(AXIS)):
    mesh = jax.make_mesh((SIZE,), (AXIS,))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(AXIS),), out_specs=out_specs))(x)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


# -- the compiler pass and the fabric model -----------------------------------------------


@pytest.mark.parametrize("dims", [None, (2, 4), (8,), (2, 2, 2)])
@pytest.mark.parametrize("seed", range(6))
def test_shortcut_perms_equal_jax_fuzzed(dims, seed):
    """Fuzzed digraphs: the same ``(perms, inject, delivery)`` as JAX,
    exactly; every round a partial permutation of unit hops on the fabric;
    chains on consecutive rounds (``_check_relay`` passes)."""
    rng = np.random.RandomState(seed)
    for _ in range(4):
        size = SIZE if dims else int(rng.randint(3, 13))
        edges = _random_edges(rng, size)
        got = compiler.shortcut_perms(edges, size, dims)
        assert got == jcompiler.shortcut_perms(edges, size, dims)
        perms, inject, delivery = got
        assert sorted(e for e, _ in delivery) == sorted(set(edges))
        for r, perm in enumerate(perms):
            assert len({s for s, _ in perm}) == len(perm) == len({d for _, d in perm})
            for s, d in perm:
                assert placement.hop_distance(s, d, size, dims) == 1, (s, d, dims)
            assert set(inject[r]) <= {s for s, _ in perm}
        compiler._check_relay(perms, inject, delivery, compiler._canonical(edges, size), size)


def test_check_relay_refuses_a_broken_schedule():
    perms, inject, delivery = compiler.shortcut_perms([(0, 3), (3, 6), (6, 1)], SIZE)
    edges = compiler._canonical([(0, 3), (3, 6), (6, 1)], SIZE)
    wrong = tuple(((u, v), r + 1) for (u, v), r in delivery)
    with pytest.raises(AssertionError, match="does not deliver"):
        compiler._check_relay(perms, inject, wrong, edges, SIZE)
    with pytest.raises(AssertionError, match="cover"):
        compiler._check_relay(perms, inject, delivery[1:], edges, SIZE)


@pytest.mark.parametrize("dims", [None, "2,4", "2x2x2"])
@pytest.mark.parametrize("method", ["offset", "coloring", "auto", "shortcut"])
def test_compile_edges_equal_jax(monkeypatch, method, dims):
    """Every field JAX's ``CompiledEdges`` shares with the port's, on an
    irregular edge set, with and without a declared torus; ``auto`` never
    picks the relay family."""
    if dims:
        monkeypatch.setenv("BLUEFOG_TORUS_DIMS", dims)
    rng = np.random.RandomState(2)
    edges = _random_edges(rng, SIZE)
    got = compiler.compile_edges(edges, SIZE, method=method)
    want = jcompiler.compile_edges(edges, SIZE, method=method)
    for field in ("perms", "method", "rounds", "offset_rounds", "lower_bound", "route",
                  "congestion"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.route == "shortcut") == (method == "shortcut")
    if got.route == "shortcut":
        assert (got.inject, got.delivery) == (want.inject, want.delivery)
    else:
        # JAX leaves both None on a direct plan: every sender injects, and
        # every perm pair is an edge delivered in its own round
        assert want.inject is None and want.delivery is None
        assert got.inject == tuple(tuple(sorted(s for s, _ in p)) for p in got.perms)
        assert got.delivery == tuple(sorted(
            ((s, d), r) for r, p in enumerate(got.perms) for s, d in p))


def test_compile_cache_distinguishes_method_and_fabric(monkeypatch):
    """``test_plan_compiler.py::test_compile_cache_distinguishes_method_and_fabric``:
    the method and the declared dims are in the compile-cache key."""
    edges = [(0, 3), (3, 6), (6, 1), (1, 0)]
    a = compiler.compile_edges(edges, SIZE, method="coloring")
    b = compiler.compile_edges(edges, SIZE, method="shortcut")
    assert a is not b and b.route == "shortcut"
    assert compiler.compile_edges(edges, SIZE, method="shortcut") is b
    monkeypatch.setenv("BLUEFOG_TORUS_DIMS", "2,4")
    c = compiler.compile_edges(edges, SIZE, method="shortcut")
    assert c is not b and c.perms == jcompiler.compile_edges(edges, SIZE, method="shortcut").perms


@pytest.mark.parametrize("dims", [None, (4, 4), (16,), (2, 4, 2)])
def test_routes_and_congestion_equal_jax(dims):
    size = 16
    for i in range(size):
        for j in range(size):
            if i != j:
                assert placement.route_ranks(i, j, size, dims) == \
                    jplacement.route_ranks(i, j, size, dims)
                assert placement.hop_distance(i, j, size, dims) == \
                    jplacement.hop_distance(i, j, size, dims)
    for off in range(1, size):
        perm = tuple((i, (i + off) % size) for i in range(size))
        assert placement.perm_congestion(perm, size, dims) == \
            jplacement.perm_congestion(perm, size, dims)
    if dims and len(dims) > 1:
        assert placement.serpentine_positions(dims) == jplacement.serpentine_positions(dims)
        assert placement.hop_distance(0, 15, 16, dims) <= 2


class _Dev:
    def __init__(self, coords):
        self.coords = coords


@pytest.mark.parametrize("dims", [(4, 2), (4, 8), (4, 2, 2), (2, 2, 4)])
def test_serpentine_device_order_equal_jax(dims):
    """On objects with ``.coords`` (as ``tests/test_topology.py`` drives
    it): the same walk as JAX's, each step one torus hop."""
    import itertools

    devs = [_Dev(c[::-1]) for c in itertools.product(*(range(n) for n in reversed(dims)))]
    got = [d.coords for d in placement.serpentine_device_order(devs)]
    assert got == [d.coords for d in jplacement.serpentine_device_order(devs)]
    for a, b in zip(got, got[1:]):
        assert sum(min(abs(i - j), n - abs(i - j)) for i, j, n in zip(a, b, dims)) == 1
    assert [d.coords for d in tu.worker_device_order(devs)] == got


def test_worker_device_order_passes_devices_through():
    devs = [torch.device("cpu")] * 4
    assert tu.worker_device_order(devs) == devs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tu.worker_device_order()


@pytest.mark.parametrize("raw,want", [("2,4", (2, 4)), ("2x4", (2, 4)), ("8", (8,)),
                                      ("4,4", None), ("a,b", None), ("0,8", None)])
def test_declared_torus_dims_equal_jax(monkeypatch, raw, want):
    monkeypatch.setenv("BLUEFOG_TORUS_DIMS", raw)
    monkeypatch.setattr(logging_util, "_warned_once", set())
    if want is None:
        with pytest.warns(UserWarning, match="BLUEFOG_TORUS_DIMS"):
            assert placement.declared_torus_dims(SIZE) is None
    else:
        assert placement.declared_torus_dims(SIZE) == want
    assert jplacement.declared_torus_dims(SIZE) == want


# -- relay plans -------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("gen", sorted(GRAPHS))
def test_relay_plan_weights_and_neighbors_equal_jax(gen, weighted):
    """A relay plan's rounds, receive weights (on the delivery rounds),
    self weights, neighbour relations and weight matrix are JAX's; its
    weight matrix and neighbours are the direct plan's."""
    ours, theirs = GRAPHS[gen]
    tp = tplan.plan_from_topology(ours(SIZE), weighted=weighted, method="shortcut")
    jp = jplan.plan_from_topology(theirs(SIZE), weighted=weighted, method="shortcut")
    direct = tplan.plan_from_topology(ours(SIZE), weighted=weighted)
    assert tp.relay and not direct.relay
    assert tp.perms == jp.perms and tp.self_weights == jp.self_weights
    assert [r.recv_weights for r in tp.rounds] == [r.recv_weights for r in jp.rounds]
    assert tp.compile_info.inject == jp.compile_info.inject
    assert tp.compile_info.delivery == jp.compile_info.delivery
    assert tp.in_neighbors == jp.in_neighbors == direct.in_neighbors
    assert _out_neighbors(tp) == jp.out_neighbors == _out_neighbors(direct)
    assert np.array_equal(tp.weight_matrix(), jp.weight_matrix())
    assert np.array_equal(tp.weight_matrix(), direct.weight_matrix())
    for a, b in zip(tp.weight_operands(), jp.weight_operands()):
        assert np.array_equal(a, b)


def _transit_replay(x, perms, inject):
    """The relay's transit recursion on the actual rows (JAX's
    ``_chunked_exact_combine`` with ``inject``): each round's received rows,
    zeros where nothing arrives."""
    transit = np.zeros_like(x)
    out = []
    for r, perm in enumerate(perms):
        recv = np.zeros_like(x)
        for a, b in perm:
            recv[b] = x[a] if a in inject[r] else transit[a]
        out.append(recv)
        transit = recv
    return out


@pytest.mark.parametrize("dims", [None, (2, 4)])
@pytest.mark.parametrize("seed", range(5))
def test_relay_sources_replay_the_transit(dims, seed):
    """Gathering each round's origin rows (``relay_sources``, the port's
    stacked relay) delivers bit for bit what the transit recursion does."""
    rng = np.random.RandomState(seed)
    edges = _random_edges(rng, SIZE)
    perms, inject, _delivery = compiler.shortcut_perms(edges, SIZE, dims)
    x = rng.randn(SIZE, 7).astype(np.float32)
    src = compiler.relay_sources(perms, inject, SIZE)
    xt = torch.from_numpy(x)
    for r, want in enumerate(_transit_replay(x, perms, inject)):
        got = inner._gather(xt, torch.from_numpy(src[r])).numpy()
        assert np.array_equal(_bits(got), _bits(want))


# -- relay combines ----------------------------------------------------------------------


def _jax_combine(plan, x, chunks=1):
    return np.asarray(_run_spmd(functools.partial(
        jinner.weighted_combine, plan=plan, axis_name=AXIS, chunks=chunks), x))


def test_relay_combine_bitwise_dyadic():
    """JAX's ``test_shortcut_combine_bitwise_dyadic`` on the port: the
    relay combine is bitwise the offset lowering's and JAX's relay's."""
    rng = np.random.RandomState(23)
    edges = [(i, j) for i in range(SIZE) for j in range(SIZE) if i != j]
    for _ in range(5):
        w = _dyadic_matrix(rng, SIZE)
        naive = tplan.plan_from_matrix(w, edges=edges, method="offset")
        sc = tplan.plan_from_matrix(w, edges=edges, method="shortcut")
        jsc = jplan.plan_from_matrix(w, edges=edges, method="shortcut")
        x = rng.randint(-8, 9, size=(SIZE, 16)).astype(np.float32)
        got = inner.weighted_combine(torch.from_numpy(x), sc).numpy()
        assert np.array_equal(_bits(got), _bits(inner.weighted_combine(
            torch.from_numpy(x), naive).numpy()))
        assert np.array_equal(_bits(got), _bits(_jax_combine(jsc, x)))


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("gen", sorted(GRAPHS))
def test_relay_combine_f32_matches_jax(gen, chunks):
    """Arbitrary floats on weighted graphs: within 1e-6 of JAX's relay; the
    chunked relay bitwise the monolithic one."""
    ours, theirs = GRAPHS[gen]
    tp = tplan.plan_from_topology(ours(SIZE), weighted=True, method="shortcut")
    jp = jplan.plan_from_topology(theirs(SIZE), weighted=True, method="shortcut")
    x = np.random.RandomState(4).randn(SIZE, 2048 + 96).astype(np.float32)
    got = inner.weighted_combine(torch.from_numpy(x), tp, chunks=chunks).numpy()
    _close(got, _jax_combine(jp, x, chunks))
    one = inner.weighted_combine(torch.from_numpy(x), tp).numpy()
    assert np.array_equal(_bits(got), _bits(one))


def _np_encode(x_row, wire):
    """``wire_ref``'s wire format with the programs' scale rule (a multiply
    by the f32 reciprocal, ``kernels.RECIP_*``)."""
    blocks = np.pad(x_row, (0, -x_row.size % 512)).reshape(-1, 512)
    amax = np.maximum(np.abs(blocks).max(1), np.finfo(np.float32).tiny)
    if wire == "int4":
        s = (amax * np.float32(kernels.RECIP_7)).astype(ml_dtypes.bfloat16)
        q = np.clip(np.round(blocks / s.astype(np.float32)[:, None]), -7, 7).astype(np.int8)
        return wire_ref.np_pack_nibbles(q), s
    s = amax * np.float32(kernels.RECIP_127)
    return np.clip(np.round(blocks / s[:, None]), -127, 127).astype(np.int8), s


def _np_relay_quantized(x, plan, wire):
    """The relay quantized combine in numpy: every worker encodes once,
    the (payload, scales) pairs travel the transit recursion verbatim, and
    each round adds ``(deq(recv) - deq(self)) * w`` in f32."""
    n = x.shape[1]
    info = plan.compile_info
    pairs = [_np_encode(x[j], wire) for j in range(SIZE)]
    deq = np.stack([wire_ref.np_decode(p, s, n, wire) for p, s in pairs])
    # the decoded row of what arrives is the decode of the forwarded pair
    _self_w, recv_w = plan.weight_operands()
    y = x.copy()
    for r, recv in enumerate(_transit_replay(deq, info.perms, info.inject)):
        y = y + (recv - deq) * recv_w[r][:, None]
    return y


@pytest.mark.parametrize("wire", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("topo", ["exp2", "ring"])
def test_relay_wires_match_jax(contexts, monkeypatch, topo, wire):
    """The facade's quantized combine under ``BLUEFOG_PLAN_METHOD=shortcut``
    on each wire against JAX's relay: bf16 and int4 bitwise on Exp2(8),
    else within 1e-6; int8/int4 bitwise the numpy relay of the wire pairs
    on ``wire_ref``'s format."""
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "shortcut")
    ours, theirs = GRAPHS[topo]
    bf.set_topology(theirs(SIZE), is_weighted=True)
    bft.set_topology(ours(SIZE), is_weighted=True)
    plan = bft.get_context().static_plan()
    assert plan.relay and len(plan.rounds) >= plan.compile_info.offset_rounds
    assert (len(plan.rounds) > plan.compile_info.offset_rounds) == (topo == "exp2")
    x = (np.random.RandomState(1).randn(SIZE, 1500) * 5.0).astype(np.float32)
    got = bft.neighbor_allreduce(bft.worker_values(list(x)), compression=wire).numpy()
    want = np.asarray(bf.neighbor_allreduce(bf.worker_values(list(x)), compression=wire))
    if topo == "exp2" and wire != "int8":
        assert np.array_equal(_bits(got), _bits(want))
    else:
        _close(got, want)
    if wire != "bf16":
        assert np.array_equal(_bits(got), _bits(_np_relay_quantized(x, plan, wire)))


@pytest.mark.parametrize("wire", ["int8", "int4", "bf16"])
def test_relay_quantized_chunked_bitwise_and_half_payloads(wire):
    """The relay quantized combine chunked (2) is bitwise the monolithic
    one, and a bf16 payload's relay (encode + ``decode`` per round) is
    bitwise its direct twin under the dyadic scheme of the Exp2 weights."""
    tp = tplan.plan_from_topology(tu.ExponentialTwoGraph(SIZE), weighted=True,
                                  method="shortcut")
    src, _sw, recv_w = inner.plan_operands(tp, "cpu")
    x = torch.from_numpy((np.random.RandomState(2).randn(SIZE, 3000) * 3).astype(np.float32))
    one = inner.weighted_combine_quantized_operands(x, src, recv_w, wire=wire)
    two = inner.weighted_combine_quantized_operands(x, src, recv_w, wire=wire, chunks=2)
    assert torch.equal(_bits_t(one), _bits_t(two))
    xh = x.to(torch.bfloat16)
    a = inner.weighted_combine_quantized_operands(xh, src, recv_w, wire=wire)
    assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()


def _bits_t(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _out_neighbors(plan):
    """Each rank's out-neighbours, the transpose of ``in_neighbors``."""
    return tuple(tuple(j for j in range(plan.size) if i in plan.in_neighbors[j])
                 for i in range(plan.size))


def test_relay_round_of_pure_transit_adds_nan(monkeypatch):
    """A round in which a receiver only passes a value on carries weight
    0 and is still added, as JAX adds ``recv * 0``: a NaN carried through
    a relay reaches the relay's own result, the JAX relay's bits."""
    tp = tplan.plan_from_topology(tu.ExponentialTwoGraph(SIZE), weighted=True,
                                  method="shortcut")
    jp = jplan.plan_from_topology(jtu.ExponentialTwoGraph(SIZE), weighted=True,
                                  method="shortcut")
    x = np.random.RandomState(0).randn(SIZE, 64).astype(np.float32)
    x[4, 3] = np.nan
    got = inner.weighted_combine(torch.from_numpy(x), tp).numpy()
    want = _jax_combine(jp, x)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 3]).sum() > len(_out_neighbors(tp)[4]) + 1


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
@pytest.mark.parametrize("topo", ["exp2", "regular"])
def test_relay_allgather_bitwise_direct_and_jax(contexts, monkeypatch, topo, wire):
    """The relay ``neighbor_allgather`` (neighbours from the delivery
    table) is bitwise the direct plan's and JAX's relay allgather."""
    ours, theirs = GRAPHS[topo]
    bf.set_topology(theirs(SIZE), is_weighted=True)
    bft.set_topology(ours(SIZE), is_weighted=True)
    x = (np.random.RandomState(3).randn(SIZE, 700) * 2).astype(np.float32)
    direct = bft.neighbor_allgather(bft.worker_values(list(x)), compression=wire)
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "shortcut")
    assert bft.get_context().static_plan().relay
    got = bft.neighbor_allgather(bft.worker_values(list(x)), compression=wire)
    want = bf.neighbor_allgather(bf.worker_values(list(x)), compression=wire)
    for g, d, j in zip(got, direct, want):
        assert np.array_equal(_bits(g.numpy()), _bits(d.numpy()))
        assert np.array_equal(_bits(g.numpy()), _bits(np.asarray(j)))


# -- callers -----------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["int8_ef", "int4_ef"])
def test_ef_is_refused_on_a_relay_plan(contexts, monkeypatch, wire):
    """The error-feedback tiers refuse a relay plan with JAX's words."""
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "shortcut")
    g = np.random.RandomState(1).randn(SIZE, 600).astype(np.float32)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
    jopt.compression = wire
    jp = {"w": bf.worker_values(list(g))}
    with pytest.raises(ValueError) as jerr:
        jopt.step(jp, jopt.init(jp), {"w": jnp.asarray(g)})
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
    topt.compression = wire
    tp = {"w": torch.from_numpy(g.copy())}
    with pytest.raises(ValueError) as terr:
        topt.step(tp, topt.init(tp), {"w": torch.from_numpy(g)})
    assert str(terr.value) == str(jerr.value)
    assert "short-cut (relay)" in str(terr.value)


def test_facade_method_and_dims_build_their_own_plans(contexts, monkeypatch):
    """``test_plan_compiler.py::test_eager_cache_keys_unique_per_chunk_and_route``
    on the port, whose facade keeps no compiled programs: each method and
    each declared fabric gets its own static plan (a key of its own in
    ``ctx.plan_keys``), never a stale one, and the relay results are within
    1e-5 of the direct one's (JAX's bound there)."""
    g = tu.RandomRegularDigraph(SIZE, 2, seed=3)
    bft.set_topology(g)
    ctx = bft.get_context()
    x = bft.worker_values(lambda r: np.random.RandomState(r).randn(2048).astype(np.float32))
    a = bft.neighbor_allreduce(x).numpy()
    p0 = ctx.static_plan()
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "shortcut")
    c = bft.neighbor_allreduce(x).numpy()
    p1 = ctx.static_plan()
    monkeypatch.setenv("BLUEFOG_TORUS_DIMS", "2,4")
    d = bft.neighbor_allreduce(x).numpy()
    p2 = ctx.static_plan()
    keys = {k for k in ctx.plan_keys if k[0] == "static_plan"}
    assert len(keys) == 3, keys
    assert p1.relay and p2.relay and not p0.relay and p1 is not p2
    assert p1.perms != p2.perms
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a, d, rtol=1e-5, atol=1e-5)
    monkeypatch.delenv("BLUEFOG_TORUS_DIMS")
    assert ctx.static_plan() is not p2 and ctx.static_plan().perms == p1.perms


@pytest.mark.parametrize("wire", [None, "int8", "int4"])
def test_optimizer_relay_step_matches_jax(contexts, monkeypatch, wire):
    """Two ATC steps under ``BLUEFOG_PLAN_METHOD=shortcut`` on the weighted
    Exp2(8): the port's parameters within 1e-6 of JAX's, and the relay's
    injection table in the gossip key."""
    monkeypatch.setenv("BLUEFOG_PLAN_METHOD", "shortcut")
    bf.set_topology(jtu.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    rng = np.random.RandomState(5)
    x = rng.randn(SIZE, 1500).astype(np.float32)
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1, momentum=0.9))
    jopt.compression = wire
    topt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    topt.compression = wire
    jp = {"w": bf.worker_values(list(x))}
    js = jopt.init(jp)
    tp = {"w": torch.from_numpy(x.copy())}
    ts = topt.init(tp)
    for _ in range(2):
        g = rng.randn(SIZE, 1500).astype(np.float32)
        jp, js = jopt.step(jp, js, {"w": jnp.asarray(g)})
        topt.step(tp, ts, {"w": torch.from_numpy(g)})
    _close(tp["w"].numpy(), jp["w"])
    d = topt._dispatch(bft.get_context(), tp, True)
    assert d.key[-1] == topt._last_plan.compile_info.inject is not None
